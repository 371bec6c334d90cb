"""One typed, frozen, hashable configuration tree for every tuning knob
in the stack (DESIGN.md §11).

Before this module the search/kernel parameter space was ~a dozen coupled
knobs scattered as hard-coded literals and per-function kwargs: graph
build constants in ``core/graph.py`` and ``serve/retrieval.py``
(``GRAPH_BUILD_DEFAULTS``), atlas caps in ``core/device_atlas.py``
(``MEMBER_CAP`` / ``AUTO_V_CAP_MAX``), walk budgets in
``core/batched/engine.py`` (``BatchedParams``), kernel tile sizes in
``kernels/ops.py`` (``MAX_CLAUSES`` / ``V_CAP`` / ``tn`` / ``qt`` /
``nt``), DNF caps in ``core/predicate.py``, and serving bucketing in
``serve/retrieval.py``. ``FnsConfig`` is now the single origin: every one
of those modules derives its module-level constant from a default section
instance here (a CI guard — ``tools/knob_guard.py`` — fails the build if
a knob literal reappears elsewhere), and every build/serve/restore entry
point accepts one ``FnsConfig`` (with deprecation shims folding the old
kwargs in).

The tree is deliberately flat-addressable: ``flatten()`` gives the
``{"walk.beam_width": 8, ...}`` dict the autotuner mutates via
``with_knobs`` and the benchmark writes next to every measurement, and
``fingerprint()`` is a stable content hash of exactly that dict, so two
BENCH rows (or two snapshots) are comparable iff their fingerprints
match.

Shape-baked vs runtime-tunable (DESIGN.md §11): ``SHAPE_BAKED`` lists the
dotted paths whose values are burned into on-device array shapes at build
time (graph degree, atlas cluster count, value-bitmap width, slab
capacity). Changing them requires a rebuild — ``check_state_config``
raises ``ConfigMismatch`` when a restore is asked to apply a config that
disagrees with the snapshot on any of them. Everything under ``walk.``
and the kernel tile sizes are runtime-tunable: safe to change on a live
engine (at worst a re-jit, never a rebuild).

This module imports nothing from the rest of the package — it is the
root of the import graph, so even the lowest kernels can source their
constants from it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import warnings


class ConfigMismatch(ValueError):
    """A restore/rebuild was asked to apply a config that disagrees with
    the shape-baked knobs of the existing state (e.g. a snapshot built
    with graph_k=16 restored under graph_k=32): the on-device shapes
    cannot satisfy both, so fail loudly instead of reshaping garbage."""


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """α-kNN proximity-graph build knobs (Algorithm 1). All shape-baked:
    ``graph_k`` drives the adjacency row width (appended rows request
    1.5× graph_k forward edges), ``r_max`` caps over-degree hubs."""

    graph_k: int = 32
    r_max: int = 96
    alpha: float = 1.2
    build_block: int = 2048   # brute-kNN matmul block (host-side, perf only)


@dataclasses.dataclass(frozen=True)
class AtlasConfig:
    """Anchor-atlas build/pack knobs. ``n_clusters``/``v_cap`` None =
    auto-size from the corpus (sqrt(n) clusters; value bitmaps at least
    ``v_cap_min`` wide, word-rounded, ceilinged at ``auto_v_cap_max``)."""

    n_clusters: int | None = None
    v_cap: int | None = None
    v_cap_min: int = 256       # smallest value-bitmap width (was ops.V_CAP)
    auto_v_cap_max: int = 1024  # auto-sizing ceiling (was AUTO_V_CAP_MAX)
    member_cap: int = 4096      # per-cluster matched-member scan cap
    kmeans_seed: int = 0


@dataclasses.dataclass(frozen=True)
class WalkConfig:
    """Lockstep-walk budgets — the runtime-tunable heart of the space
    (identical fields to the historical ``BatchedParams``, which is now
    an alias of this class)."""

    k: int = 25
    beam_width: int = 4
    frontier_cap: int = 16
    frontier_width: int = 5     # K_f pushes per expansion
    stall_budget: int = 100
    max_hops: int = 100
    jump_budget: int = 3
    n_seeds: int = 10
    c_max: int = 5
    # minimum anchor-seed quota per live disjunct (DNF queries only): a
    # starved disjunct gets its best cluster visited + this many seeds, so
    # a dominant disjunct can't monopolize the restart budget
    disjunct_quota: int = 2


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Pallas kernel tile sizes and clause-table caps. Tile sizes are
    validated against shapes at trace time (``filter_tile`` must be a
    multiple of 32 for the bitmap pack; ``topk_nt`` likewise for the
    in-kernel word unpack); the caps bucket compiled program shapes."""

    filter_tile: int = 1024    # filter_eval corpus-tile rows (was tn=1024)
    max_clauses: int = 4       # clause-dim bucket floor (was MAX_CLAUSES)
    max_disjuncts: int = 8     # DNF compile cap (was predicate.MAX_DISJUNCTS)
    topk_qt: int = 8           # masked_cosine_topk query tile
    topk_nt: int = 512         # masked_cosine_topk corpus tile


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-layer knobs: batch bucketing, seed backend, append room,
    and the admission-queue/pipeline knobs (DESIGN.md §13)."""

    min_bucket: int = 4        # smallest padded batch bucket (was MIN_BUCKET)
    seed_backend: str = "topk"
    capacity: int | None = None  # append-slab rows; None = build-once
    # admission queue (serve/pipeline.py): the batch-former cuts a batch
    # when it holds queue_max_batch queries OR the oldest admitted query
    # has waited queue_budget_ms — whichever comes first
    queue_max_batch: int = 1024
    queue_budget_ms: float = 5.0
    # in-flight dispatch depth of the double-buffered pipeline: 2 = batch
    # N+1's pack/compile overlaps batch N's device residence
    queue_depth: int = 2


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """2D query×data mesh knobs (DESIGN.md §13). ``query_axes`` names the
    mesh axes eligible to carry query lanes, probed in order (a dedicated
    ``query`` axis wins over reusing ``model``); ``query_parallel`` off
    forces the 1D queries-replicated layout on any mesh."""

    query_parallel: bool = True
    query_axes: tuple = ("query", "model")


@dataclasses.dataclass(frozen=True)
class MaintenanceConfig:
    """Document-lifecycle + background-maintenance knobs (DESIGN.md §12).
    All runtime-tunable: none of them is burned into device shapes, so a
    live service can retune its maintenance schedule without a rebuild."""

    # ingest defers graph repair / centroid refresh / recluster checks to
    # the maintenance loop (slab writes + bit flips only on the hot path)
    defer_repair: bool = False
    # max backlog rows one maintenance step repairs (the step budget)
    repair_batch_rows: int = 256
    # compact a shard once its tombstoned fraction of written rows
    # exceeds this (and at least compact_min_rows are dead)
    compact_tombstone_frac: float = 0.25
    compact_min_rows: int = 32
    # post-compaction relink: rows whose degree fell below
    # min_degree_frac * graph_k get their neighbourhood recomputed
    min_degree_frac: float = 0.5
    # slab growth past capacity (re-shard instead of raising): per-shard
    # cap multiplier; auto_grow False restores the hard-capacity ValueError
    grow_factor: float = 2.0
    auto_grow: bool = True
    # centroid drift that makes the loop schedule a recluster check
    drift_threshold: float = 0.15
    # safety valve for run_until_idle
    max_steps_per_drain: int = 64


@dataclasses.dataclass(frozen=True)
class FnsConfig:
    """The whole stack's knob tree. Frozen and hashable: engines key
    compiled programs on it, snapshots embed its flattened form, and the
    autotuner mutates it only through ``with_knobs`` (returning a new
    instance)."""

    graph: GraphConfig = GraphConfig()
    atlas: AtlasConfig = AtlasConfig()
    walk: WalkConfig = WalkConfig()
    kernel: KernelConfig = KernelConfig()
    serve: ServeConfig = ServeConfig()
    maintenance: MaintenanceConfig = MaintenanceConfig()
    mesh: MeshConfig = MeshConfig()

    # -- flat addressing ----------------------------------------------------

    def flatten(self) -> dict:
        """Dotted-path knob dict: {"graph.graph_k": 32, ...} — the form
        the tuner searches over and BENCH rows record."""
        out: dict = {}
        for sect in dataclasses.fields(self):
            sub = getattr(self, sect.name)
            for f in dataclasses.fields(sub):
                out[f"{sect.name}.{f.name}"] = getattr(sub, f.name)
        return out

    def with_knobs(self, knobs: dict) -> "FnsConfig":
        """A new config with the given dotted-path knobs replaced:
        ``cfg.with_knobs({"walk.beam_width": 8})``. Unknown paths raise
        (a typo'd knob must never silently no-op)."""
        by_section: dict[str, dict] = {}
        sections = {f.name for f in dataclasses.fields(self)}
        for path, value in knobs.items():
            sect, _, leaf = path.partition(".")
            if sect not in sections or not leaf:
                raise KeyError(f"unknown config knob {path!r}")
            sub = getattr(self, sect)
            if leaf not in {f.name for f in dataclasses.fields(sub)}:
                raise KeyError(f"unknown config knob {path!r}")
            by_section.setdefault(sect, {})[leaf] = value
        return dataclasses.replace(self, **{
            s: dataclasses.replace(getattr(self, s), **kv)
            for s, kv in by_section.items()})

    @classmethod
    def from_flat(cls, knobs: dict) -> "FnsConfig":
        """Inverse of ``flatten()`` (tolerant of missing keys — they keep
        their defaults — so configs round-trip across releases that add
        knobs)."""
        known = cls().flatten()
        return cls().with_knobs({k: v for k, v in knobs.items()
                                 if k in known})

    def to_dict(self) -> dict:
        return {f.name: dataclasses.asdict(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "FnsConfig":
        return cls.from_flat({f"{s}.{k}": v
                              for s, kv in (d or {}).items()
                              if isinstance(kv, dict)
                              for k, v in kv.items()})

    def fingerprint(self) -> str:
        """Stable short content hash of the flattened knob dict. Two
        configs fingerprint equal iff every knob is equal, across
        processes and json round-trips."""
        canon = json.dumps(self.flatten(), sort_keys=True, default=str)
        return hashlib.sha256(canon.encode()).hexdigest()[:16]


# knobs burned into on-device array shapes at build time: a snapshot can
# only restore under a config that agrees on these (see ConfigMismatch)
SHAPE_BAKED = ("graph.graph_k", "graph.r_max", "atlas.n_clusters",
               "atlas.v_cap", "serve.capacity")


def check_state_config(cfg: "FnsConfig", *, graph_k=None, v_cap=None,
                       n_clusters=None, capacity=None,
                       where: str = "restore") -> None:
    """Compare a config's shape-baked knobs against the values recorded in
    (or derivable from) an existing engine state; raise ``ConfigMismatch``
    listing every conflict. A ``cfg`` knob of None means "auto" and
    matches anything; a state-side None means "unknown" and is skipped."""
    pairs = (("graph.graph_k", cfg.graph.graph_k, graph_k),
             ("atlas.v_cap", cfg.atlas.v_cap, v_cap),
             ("atlas.n_clusters", cfg.atlas.n_clusters, n_clusters),
             ("serve.capacity", cfg.serve.capacity, capacity))
    bad = [f"{name}: config says {want}, state has {got}"
           for name, want, got in pairs
           if want is not None and got is not None and want != got]
    if bad:
        raise ConfigMismatch(
            f"{where}: config disagrees with the snapshot's shape-baked "
            f"knobs — these are burned into on-device shapes, so restoring "
            f"under a different value needs a rebuild, not a restore. "
            + "; ".join(bad))


# -- deprecation shims -------------------------------------------------------

_WARNED: set[str] = set()


def warn_once(key: str, message: str) -> None:
    """Per-process once-only DeprecationWarning (the shim contract: old
    call sites keep working for one release, nagging exactly once)."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=3)


def coerce_config(config, legacy: dict, *, where: str,
                  defaults: dict | None = None) -> FnsConfig:
    """Fold an entry point's arguments into one ``FnsConfig``.

    ``config`` may be a full ``FnsConfig``, a bare ``WalkConfig`` (the
    historical ``BatchedParams`` positional argument — deprecated, folded
    into ``FnsConfig(walk=...)``), or None. ``legacy`` maps dotted knob
    paths to the entry point's old kwargs (None = not passed); passing any
    of them warns once and overrides the config. ``defaults`` are dotted
    knobs applied silently when NO full FnsConfig was given — the entry
    point's historical defaults where they differ from the config tree's
    (e.g. BatchedEngine's append-path graph_k=16)."""
    if isinstance(config, FnsConfig):
        cfg = config
        explicit = True
    elif isinstance(config, WalkConfig):
        warn_once(f"{where}:walk",
                  f"{where}: passing bare WalkConfig/BatchedParams is "
                  f"deprecated; pass FnsConfig(walk=...) instead")
        cfg = FnsConfig(walk=config)
        explicit = False
    elif config is None:
        cfg = FnsConfig()
        explicit = False
    else:
        raise TypeError(
            f"{where}: config must be FnsConfig, WalkConfig, or None; "
            f"got {type(config).__name__}")
    if not explicit and defaults:
        cfg = cfg.with_knobs(defaults)
    used = {k: v for k, v in legacy.items() if v is not None}
    if used:
        warn_once(f"{where}:{','.join(sorted(used))}",
                  f"{where}: knob kwargs {sorted(used)} are deprecated; "
                  f"pass them inside config=FnsConfig(...)")
        cfg = cfg.with_knobs(used)
    return cfg
