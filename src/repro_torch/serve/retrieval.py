"""Filtered retrieval as a service: the fiber-navigable index (α-kNN
graph + anchor atlas) answers metadata-filtered nearest-neighbour requests
over unit vectors, sequentially on the host (``query``) or in batches on
the device (``query_batch``), with live ingest/delete and crash-consistent
durability (DESIGN.md §4, §9, §10, §12).

The port's service differs from the reference's in one way: it takes a
``device`` (None means CUDA, and constructing it raises where there is
none) that every engine it builds or recovers receives, and that
``EncodedRetriever`` encodes on. With a ``mesh`` (``launch.mesh.Mesh``)
the device must be None: the sharded engine lives on the mesh's cells,
and whatever runs off the mesh runs on its first cell.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.atlas import AnchorAtlas
from repro_torch.core.batched.engine import (BatchedEngine, BatchedParams,
                                             _compile_query_dnf)
from repro_torch.core.batched.sharded import (ShardedEngine,
                                              build_sharded_index)
from repro_torch.core.config import (AtlasConfig, FnsConfig, GraphConfig,
                                     ServeConfig, coerce_config)
from repro_torch.core.graph import build_alpha_knn
from repro_torch.core.predicate import FilterExpr
from repro_torch.core.search import FiberIndex, SearchParams, search
from repro_torch.core.types import Dataset, FilterPredicate, Query, normalize
from repro_torch.launch.mesh import (index_axis_size, lead_device,
                                     query_axis_name, staging_device)
from repro_torch.models.transformer import (ShardEnv, Transformer, encode,
                                            on_device, place_params)

# singleton (and any sub-minimum) arrivals pad up to this bucket, so
# every small arrival runs at one of a few batch shapes (value originates
# in core/config.py; this alias keeps the reference's import working)
MIN_BUCKET = ServeConfig().min_bucket

# legacy view of the index-build knobs (now sourced from the config tree):
# build() seeds graph_build from these, and the lazy global/sharded
# builders merge them back in so a hand-constructed service (empty
# graph_build) gets the same values
_GCFG = GraphConfig()
GRAPH_BUILD_DEFAULTS = {"graph_k": _GCFG.graph_k, "r_max": _GCFG.r_max,
                        "alpha": _GCFG.alpha,
                        "n_clusters": AtlasConfig().n_clusters}

# SearchParams fields shared verbatim with the lockstep walk config —
# beam_width is deliberately excluded (40 is the sequential beam's tuning,
# 4 the lockstep default; see RetrievalService.engine)
_SHARED_WALK_FIELDS = ("k", "jump_budget", "n_seeds", "c_max",
                       "frontier_width", "stall_budget", "max_hops")


def _engine_state(eng):
    """The host InsertState behind either engine flavour (None when the
    engine was built without append capacity)."""
    return eng._istate if isinstance(eng, ShardedEngine) else eng._state


@dataclasses.dataclass
class RetrievalService:
    index: FiberIndex | None
    params: SearchParams
    # active mesh: when its "data" axis spans >1 cell (or a query axis
    # carries >1 lane), query_batch routes to the sharded engine (corpus
    # row-partitioned, DESIGN.md §7)
    mesh: object | None = None
    graph_build: dict = dataclasses.field(default_factory=dict)
    # row capacity the batched/sharded engines reserve for ``ingest``
    # (DESIGN.md §9); None = build-once service, ingest raises
    capacity: int | None = None
    # the one typed knob tree every engine this service builds consumes
    # (DESIGN.md §11); None = derive lazily from the legacy fields above
    config: FnsConfig | None = None
    # where every engine this service builds or recovers runs: None means
    # CUDA (raises where there is none), "cpu" the plain kernels; with a
    # mesh it must be None and becomes the mesh's first cell
    device: object | None = None
    _ds: Dataset | None = dataclasses.field(default=None, repr=False)
    _engine: BatchedEngine | None = dataclasses.field(default=None,
                                                      repr=False)
    _sharded: ShardedEngine | None = dataclasses.field(default=None,
                                                       repr=False)
    # crash-consistency (DESIGN.md §10): attached by enable_durability /
    # recover; when set, every ingest/delete/compact is journaled before
    # it is applied
    _store: object | None = dataclasses.field(default=None, repr=False)
    _next_seq: int = dataclasses.field(default=1, repr=False)
    # background maintenance (DESIGN.md §12), built lazily on first
    # maintenance_step — owns the deferred-repair/compaction schedule
    _mloop: object | None = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.device = lead_device(self.mesh, self.device)

    @staticmethod
    def build(ds: Dataset, *, config: FnsConfig | None = None,
              graph_k: int | None = None, r_max: int | None = None,
              alpha: float | None = None, n_clusters: int | None = None,
              params: SearchParams | None = None,
              mesh=None, capacity: int | None = None,
              device=None) -> "RetrievalService":
        """Build a service from one ``FnsConfig`` (``config=``); the loose
        build kwargs are deprecation shims folding into it. ``params``
        (sequential-path SearchParams) stays first-class: its walk-shared
        fields fold into ``config.walk`` so bench and serving measure the
        same engine — unless a full ``FnsConfig`` is given, which wins for
        the batched engines while ``params`` keeps steering the sequential
        path."""
        cfg = coerce_config(config,
                            {"graph.graph_k": graph_k,
                             "graph.r_max": r_max,
                             "graph.alpha": alpha,
                             "atlas.n_clusters": n_clusters,
                             "serve.capacity": capacity},
                            where="RetrievalService.build")
        if params is not None and not isinstance(config, FnsConfig):
            cfg = cfg.with_knobs({f"walk.{f}": getattr(params, f)
                                  for f in _SHARED_WALK_FIELDS})
        sp = params if params is not None else SearchParams(
            **{f: getattr(cfg.walk, f) for f in _SHARED_WALK_FIELDS})
        svc = RetrievalService(
            None, sp, mesh=mesh, capacity=cfg.serve.capacity, config=cfg,
            device=device, _ds=ds,
            graph_build={"graph_k": cfg.graph.graph_k,
                         "r_max": cfg.graph.r_max,
                         "alpha": cfg.graph.alpha,
                         "n_clusters": cfg.atlas.n_clusters})
        # a mesh-sharded service uses per-shard graphs/atlases only: defer
        # the global build so it isn't paid (time + an (n, R) adjacency
        # held for nothing) unless the sequential path is actually used
        if svc._mesh_shards() <= 1:
            svc._global_index()
        return svc

    def _global_index(self) -> FiberIndex:
        """The single-device index (global α-kNN graph + atlas), built on
        first use — eagerly for unmeshed services, lazily for sharded ones
        (only ``query``/``engine`` need it there)."""
        if self.index is None:
            gb, ds = self._gb(), self._ds
            graph = build_alpha_knn(ds.vectors, k=gb["graph_k"],
                                    r_max=gb["r_max"], alpha=gb["alpha"])
            atlas = AnchorAtlas.build(ds, n_clusters=gb["n_clusters"])
            self.index = FiberIndex(ds.vectors, ds.metadata, graph, atlas)
        return self.index

    def _gb(self) -> dict:
        if self.config is not None:
            return {"graph_k": self.config.graph.graph_k,
                    "r_max": self.config.graph.r_max,
                    "alpha": self.config.graph.alpha,
                    "n_clusters": self.config.atlas.n_clusters}
        return {**GRAPH_BUILD_DEFAULTS, **self.graph_build}

    def _cfg(self) -> FnsConfig:
        """The service's one FnsConfig. Hand-constructed services (direct
        dataclass construction with legacy fields) derive it once from
        graph_build / params / capacity; ``build()`` always sets it."""
        if self.config is None:
            gb = {**GRAPH_BUILD_DEFAULTS, **self.graph_build}
            self.config = FnsConfig().with_knobs({
                "graph.graph_k": gb["graph_k"],
                "graph.r_max": gb["r_max"],
                "graph.alpha": gb["alpha"],
                "atlas.n_clusters": gb["n_clusters"],
                "serve.capacity": self.capacity,
                **{f"walk.{f}": getattr(self.params, f)
                   for f in _SHARED_WALK_FIELDS}})
        return self.config

    def _corpus(self) -> tuple[np.ndarray, np.ndarray]:
        if self._ds is not None:
            return self._ds.vectors, self._ds.metadata
        return self.index.vectors, self.index.metadata

    def query(self, vector: np.ndarray, predicate: FilterPredicate,
              seed: int = 0):
        ids, sims, stats = search(self._global_index(), normalize(vector),
                                  predicate, self.params, seed=seed)
        return ids, sims, stats

    def engine(self) -> BatchedEngine:
        """Lazily-built batched engine over the same index (device-resident
        atlas; one select+walk round per restart).

        ``beam_width`` is deliberately NOT forwarded: SearchParams' default
        (40) is tuned for the sequential beam walk, while the lockstep
        engine pops one node per query per iteration and uses its own
        small-beam default (4) — forwarding would multiply every query's
        wall-clock by the widest beam in the batch. Pass an explicit
        BatchedEngine for custom lockstep beams."""
        if self._engine is None:
            self._engine = BatchedEngine(self._global_index(),
                                         config=self._cfg(),
                                         device=self.device,
                                         vocab_sizes=self._vocab_sizes())
        return self._engine

    def _vocab_sizes(self):
        """Per-field domains for FilterExpr Not/Range lowering: the
        dataset's declared vocabularies when the service was built from a
        Dataset, else derived from the index metadata by the engine."""
        return self._ds.vocab_sizes if self._ds is not None else None

    def _batched_params(self) -> BatchedParams:
        # the single walk-param origin (stale-duplication fix): serving's
        # lockstep walk knobs ARE the config tree's walk section — the same
        # object the benchmarks construct engines from
        return self._cfg().walk

    def _mesh_shards(self) -> int:
        return index_axis_size(self.mesh) if self.mesh is not None else 1

    def _mesh_parallel(self) -> bool:
        """True when the mesh warrants the sharded engine: >1 corpus shard
        on the data axis, or >1 query lane on a query axis (a data=1 2D
        mesh still wants the mesh engine for query parallelism)."""
        if self.mesh is None:
            return False
        if self._mesh_shards() > 1:
            return True
        cfg = self._cfg()
        return (cfg.mesh.query_parallel and
                query_axis_name(self.mesh, cfg.mesh.query_axes) is not None)

    def _live_engine(self):
        """The engine the batched paths route to: by mesh shape, except
        that an engine attached by snapshot restore wins — a multi-shard
        state recovered onto a meshless process serves through the sharded
        engine's reference mode, not a freshly built global engine."""
        if self._mesh_parallel():
            return self.sharded_engine()
        if self._sharded is not None:
            return self._sharded
        return self.engine()

    def sharded_engine(self) -> ShardedEngine:
        """Lazily-built sharded engine (DESIGN.md §7): the corpus is
        re-partitioned row-wise over the mesh ``data`` axis (one shard
        without a mesh) with per-shard subgraphs/atlases; the per-shard
        graph builds are each ~S² cheaper than the global one."""
        if self._sharded is None:
            vectors, metadata = self._corpus()
            stage = (staging_device(self.mesh) if self.mesh is not None
                     else self.device)
            sidx = build_sharded_index(vectors, metadata,
                                       self._mesh_shards(),
                                       config=self._cfg(), device=stage)
            self._sharded = ShardedEngine(
                sidx, self.mesh, config=self._cfg(),
                device=None if self.mesh is not None else self.device)
        return self._sharded

    def query_batch(self, vectors: np.ndarray,
                    predicates: "list[FilterPredicate | FilterExpr]", *,
                    bucket: bool = True):
        """Batched filtered retrieval: the whole batch is ONE engine
        dispatch (predicate eval + restart loop + lockstep walks), on the
        engine ``_live_engine`` names. Predicates may be conjunctive
        ``FilterPredicate``s or arbitrary ``FilterExpr`` trees (compiled to
        bounded DNF on pack; DESIGN.md §8).

        With ``bucket`` (default), the batch is padded to the next
        power-of-two — at least ``MIN_BUCKET``, so singleton arrivals
        share the smallest bucket's shape instead of running at their
        own, and rounded up to a multiple of the engine's query-lane count
        on a 2D mesh — with inert dummy queries (unit basis vector,
        ``FilterExpr.never()``: they never seed, walk, or affect the
        loop); results are sliced back to the real queries. An empty batch
        returns ``([], {})`` without touching the engine. Returns (list of
        id arrays, stats dict).

        Per-query compile failures (e.g. an expression whose DNF exceeds
        MAX_DISJUNCTS) do NOT kill the batch: the offending query is
        replaced with an inert ``never()`` (empty result) and the error
        message is recorded in ``stats["errors"]`` at that query's slot
        (None for queries that compiled; the key is present only when at
        least one query failed)."""
        formed = self._form_batch(vectors, predicates, bucket=bucket)
        if formed is None:
            return [], {}
        eng, queries, q_real, errors = formed
        ids, stats = eng.search(queries)
        return self._finish_batch(eng, ids, stats, q_real, len(queries),
                                  errors)

    def _form_batch(self, vectors, predicates, *, bucket: bool):
        """Shared batch former for ``query_batch`` and ``dispatch_batch``:
        validate, per-query predicate compile (failures isolated into the
        errors list), normalize, and bucket-pad. Returns
        (engine, queries, q_real, errors), or None for an empty batch."""
        if len(vectors) != len(predicates):
            raise ValueError(
                f"query_batch got {len(vectors)} vectors but "
                f"{len(predicates)} predicates; one predicate per query "
                f"vector is required")
        q_real = len(predicates)
        if q_real == 0:
            return None
        eng = self._live_engine()
        v_cap = eng.v_cap if hasattr(eng, "v_cap") else eng.datlas.v_cap
        errors: list[str | None] = [None] * q_real
        checked = []
        for i, p in enumerate(predicates):
            try:
                _compile_query_dnf(p, eng.vocab_sizes, v_cap)
                checked.append(p)
            except ValueError as e:
                errors[i] = str(e)
                checked.append(FilterExpr.never())
        queries = [Query(vector=v, predicate=p)
                   for v, p in zip(normalize(vectors), checked)]
        if bucket:
            lanes = getattr(eng, "q_lanes", 1)
            target = max(MIN_BUCKET, 1 << (q_real - 1).bit_length())
            # round the bucket UP to a multiple of the query-axis size so
            # a 2D-mesh dispatch needs no extra lane padding and every
            # lane walks the same block height (DESIGN.md §13)
            target = -(-target // lanes) * lanes
            if target > q_real:
                # unit basis vector, NOT zeros: a zero vector has zero
                # norm, so cosine normalization would turn it into NaNs
                # that poison the lane's all-gather top-k merge; the pad
                # stays inert through FilterExpr.never() regardless
                basis = np.zeros_like(queries[0].vector)
                basis[0] = 1.0
                dummy = Query(vector=basis, predicate=FilterExpr.never())
                queries = queries + [dummy] * (target - q_real)
        return eng, queries, q_real, errors

    def _finish_batch(self, eng, ids, stats, q_real: int, q_padded: int,
                      errors):
        """Shared result post-processing: slice ONLY the stats that carry
        a per-query leading axis back to the real queries — scalar and
        aggregate stats (the publish generation, maintenance lag) pass
        through untouched, where the old blanket ``v[:q_real]`` mangled
        them — then attach the service-level stats."""
        stats = {k: (v[:q_real]
                     if isinstance(v, np.ndarray) and v.ndim >= 1
                     and len(v) == q_padded else v)
                 for k, v in stats.items()}
        st = _engine_state(eng)
        if st is not None:
            # deferred work a result set might observe: un-repaired rows
            # plus tombstones still holding slab slots (DESIGN.md §12)
            stats["maintenance_lag"] = st.pending_rows + st.tombstones
        if any(e is not None for e in errors):
            stats["errors"] = errors
        return ids[:q_real], stats

    def dispatch_batch(self, vectors: np.ndarray,
                       predicates: "list[FilterPredicate | FilterExpr]", *,
                       bucket: bool = True):
        """First half of ``query_batch`` (the serve pipeline's staging
        stage, DESIGN.md §13): batch forming + predicate compilation +
        fenced pack + the engine's ``dispatch``, which on the card queues
        the search without a host sync, so this returns while the device
        is still searching. Returns an opaque ticket for ``collect_batch``
        (None for an empty batch)."""
        formed = self._form_batch(vectors, predicates, bucket=bucket)
        if formed is None:
            return None
        eng, queries, q_real, errors = formed
        return {"eng": eng, "token": eng.dispatch(queries),
                "q_real": q_real, "q_padded": len(queries),
                "errors": errors}

    def collect_batch(self, ticket):
        """Sync half of ``query_batch``: one host sync on the in-flight
        ticket + the same result post-processing ``query_batch`` applies.
        The ticket pins the engine and generation it was dispatched
        against, so a maintenance publish landing mid-flight cannot
        corrupt this batch's results."""
        if ticket is None:
            return [], {}
        ids, stats = ticket["eng"].collect(ticket["token"])
        return self._finish_batch(ticket["eng"], ids, stats,
                                  ticket["q_real"], ticket["q_padded"],
                                  ticket["errors"])

    def _validate_ingest(self, vectors, metadata,
                         eng) -> tuple[np.ndarray, np.ndarray]:
        """Up-front ingest validation with clean errors (mirrors the
        ``query_batch`` length check): shape/row-count/field-count/vocab
        problems fail HERE — before the batch is journaled or any slab is
        touched — never deep inside slab placement (and never poisoning
        the recovery journal with an unappliable record)."""
        vectors = np.asarray(vectors, np.float32)
        metadata = np.atleast_2d(np.asarray(metadata, np.int32))
        st = _engine_state(eng)
        if vectors.ndim != 2:
            raise ValueError(
                f"ingest vectors must be 2-D (rows, dim); got shape "
                f"{vectors.shape}")
        d = st.shards[0].vectors.shape[1]
        if vectors.shape[1] != d:
            raise ValueError(
                f"ingest vectors have dim {vectors.shape[1]}, the index "
                f"serves dim {d}")
        if vectors.shape[0] != metadata.shape[0]:
            raise ValueError(
                f"ingest got {vectors.shape[0]} vectors but "
                f"{metadata.shape[0]} metadata rows; one metadata row per "
                f"vector is required")
        f_count = st.shards[0].metadata.shape[1]
        if metadata.shape[1] != f_count:
            raise ValueError(
                f"ingest metadata has {metadata.shape[1]} fields, the "
                f"index declares {f_count}")
        if metadata.size and int(metadata.max()) >= st.v_cap:
            raise ValueError(
                f"ingest metadata code {int(metadata.max())} is outside "
                f"the declared vocab domain [0, {st.v_cap}); rebuild with "
                f"a larger v_cap to serve it")
        return vectors, metadata

    def _validate_gids(self, gids, rows: int, st) -> np.ndarray:
        """Explicit-gid ingest validation, BEFORE the journal append: a
        gid that is still live must be deleted first (id reuse is always
        explicit, never a silent second row), and the offending ids are
        named in the error."""
        gids = np.asarray(gids, np.int32).ravel()
        if gids.size != rows:
            raise ValueError(
                f"ingest got {rows} rows but {gids.size} explicit gids")
        uniq, counts = np.unique(gids, return_counts=True)
        if (counts > 1).any():
            raise ValueError(
                f"duplicate gids within one ingest batch: "
                f"{uniq[counts > 1].tolist()}")
        shard_of, _rows = st.locate_gids(gids)
        alive = gids[shard_of >= 0]
        if alive.size:
            raise ValueError(
                f"gids {alive.tolist()} are still live; delete them "
                f"before re-inserting (id reuse must be explicit)")
        return gids

    def ingest(self, vectors: np.ndarray, metadata: np.ndarray, *,
               gids: np.ndarray | None = None) -> np.ndarray:
        """Append documents to the live serving index (DESIGN.md §9):
        routed to the same engine ``query_batch`` uses, so newly ingested rows are visible to
        the very next batch without a rebuild. Requires the service to
        have been built with spare ``capacity``. Returns the new rows'
        global ids.

        With durability enabled the batch is appended to the write-ahead
        journal (CRC-framed, fsynced) BEFORE any validity bit flips — a
        crash at any point after the journal write is recoverable by
        replay, and a crash during it leaves a torn tail that recovery
        drops (the caller never got an ack)."""
        if self.capacity is None:
            raise ValueError(
                "service was built without ingest capacity; pass "
                "capacity=... to RetrievalService.build to reserve append "
                "room")
        eng = self._live_engine()
        vectors, metadata = self._validate_ingest(vectors, metadata, eng)
        if gids is not None:
            gids = self._validate_gids(gids, vectors.shape[0],
                                       _engine_state(eng))
        seq = self._next_seq
        if self._store is not None:
            self._store.journal.append(seq, vectors, metadata, gids=gids)
        out = eng.insert_batch(vectors, metadata, gids=gids)
        if self._store is not None:
            _engine_state(eng).applied_seq = seq
            self._next_seq = seq + 1
        self._sync_capacity(eng)
        return out

    def _sync_capacity(self, eng) -> None:
        """Growth past capacity re-shards in place (DESIGN.md §12); the
        engine keeps its ``serve.capacity`` knob truthful, so mirror it
        into the service fields the snapshot records."""
        if eng.cfg is not self.config:
            self.config = eng.cfg
            self.capacity = eng.cfg.serve.capacity

    # -- document lifecycle (DESIGN.md §12) ---------------------------------

    def delete(self, gids) -> int:
        """Tombstone documents by global id: journaled (when durability is
        on) BEFORE the validity bits clear, exactly like ingest, so a
        crash at any point replays to the same live set. Unknown or
        already-deleted ids raise ``ValueError`` naming them — validated
        up front, before the journal sees the record. Returns the number
        of rows deleted."""
        if self.capacity is None:
            raise ValueError(
                "service was built without ingest capacity; deletes need "
                "a capacity-slab service (RetrievalService.build(..., "
                "capacity=...))")
        eng = self._live_engine()
        st = _engine_state(eng)
        gids = np.unique(np.asarray(gids, np.int64).ravel())
        shard_of, _rows = st.locate_gids(gids)
        missing = gids[shard_of < 0]
        if missing.size:
            raise ValueError(
                f"delete of unknown or already-deleted gids: "
                f"{missing.tolist()}")
        seq = self._next_seq
        if self._store is not None:
            self._store.journal.append_delete(seq, gids)
        n = eng.delete_batch(gids)
        if self._store is not None:
            st.applied_seq = seq
            self._next_seq = seq + 1
        return n

    def compact_now(self) -> dict:
        """Force-compact every tombstoned shard right now (the foreground
        path; the maintenance loop does the same work incrementally when
        thresholds trip). Journaled before any row moves — replay
        force-compacts too, and since documents are addressed by gid, a
        replayed layout is equivalent even if slot assignments differ.
        Returns the compaction accounting."""
        from repro_torch.core.batched.lifecycle import compact_state

        eng = self._live_engine()
        st = _engine_state(eng)
        if st is None:
            raise ValueError(
                "service has no mutable engine state; build with "
                "capacity=... to enable the document lifecycle")
        journaled = self._store is not None and st.tombstones > 0
        seq = self._next_seq
        if journaled:
            self._store.journal.append_compact(seq)
        rep = compact_state(st, self._cfg().maintenance, force=True)
        if rep["shards"]:
            eng.refresh_device(rep["shards"])
        if journaled:
            st.applied_seq = seq
            self._next_seq = seq + 1
        return rep

    def maintenance_step(self, budget_rows: int | None = None) -> dict:
        """Run ONE budgeted unit of background maintenance (deferred
        graph repair, threshold compaction, drift recluster — cheapest
        stale signal first) and publish it to the device slabs. The
        serving loop calls this between query batches; with nothing
        stale it returns {"kind": "idle"} at the cost of a few host
        reads. See ``serve.maintenance.MaintenanceLoop``."""
        return self._maintenance_loop().step(budget_rows)

    def _maintenance_loop(self):
        from repro_torch.serve.maintenance import MaintenanceLoop

        eng = self._live_engine()
        if self._mloop is None or self._mloop.engine is not eng:
            def on_compact(shards, _eng=eng):
                # WAL the compaction BEFORE any row moves (same ordering
                # contract as ingest/delete)
                if self._store is not None:
                    seq = self._next_seq
                    self._store.journal.append_compact(seq)
                    _engine_state(_eng).applied_seq = seq
                    self._next_seq = seq + 1

            self._mloop = MaintenanceLoop(eng, self._cfg().maintenance,
                                          on_compact=on_compact)
        return self._mloop

    # -- durability: snapshot / restore / recover (DESIGN.md §10) ----------

    def enable_durability(self, path: str, *, keep: int = 3,
                          snapshot_now: bool = True):
        """Attach a durability root at ``path``: subsequent ``ingest``
        calls are write-ahead journaled, and ``snapshot()`` persists the
        complete engine state. With ``snapshot_now`` (default) a first
        snapshot is taken immediately, so the service is recoverable from
        the moment this returns. Returns the ``DurableStore``."""
        from repro_torch.serve.durability import DurableStore

        if self.capacity is None:
            raise ValueError(
                "durability needs an ingest-capable service; pass "
                "capacity=... to RetrievalService.build")
        self._store = DurableStore(path, keep=keep)
        st = _engine_state(self._live_engine())
        recs, _ = self._store.journal.read()
        self._next_seq = max([st.applied_seq] + [r[0] for r in recs]) + 1
        if snapshot_now:
            self.snapshot()
        return self._store

    def snapshot(self) -> int:
        """Persist the complete mutable engine state through the atomic
        checkpoint format and truncate the journal. Returns the snapshot
        step (= ``applied_seq``)."""
        if self._store is None:
            raise ValueError("no durability store attached; call "
                             "enable_durability(path) first")
        eng = self._live_engine()
        cfg = self._cfg()
        extra = {"search_params": dataclasses.asdict(self.params),
                 "graph_build": self._gb(),
                 "capacity": self.capacity,
                 # full knob provenance: restore reconstructs the exact
                 # config, and the checkpoint manifest records the
                 # fingerprint so two snapshots are comparable at a glance
                 "config": {"fingerprint": cfg.fingerprint(),
                            "knobs": cfg.flatten()},
                 "vocab_sizes": (list(eng.vocab_sizes)
                                 if eng.vocab_sizes is not None else None)}
        return self._store.snapshot(_engine_state(eng), extra)

    @classmethod
    def recover(cls, path: str, *, mesh=None,
                params: SearchParams | None = None,
                config: FnsConfig | None = None,
                replay: bool = True, device=None) -> "RetrievalService":
        """Bring a service back from its durability root: load the latest
        *readable* snapshot, reconstruct the engine for ``mesh``, or on
        ``device`` without one (zero graph/atlas rebuild; cross-mesh via
        empty-slab padding or reference mode, see ``engine_from_state``),
        replay the journal suffix
        (``seq > applied_seq``, idempotent) through the normal insert
        path, truncate any torn tail, and serve. Corrupted journal or
        snapshot bytes raise a clean error — they are never served.

        The snapshot's recorded config is reconstructed and reused; an
        explicit ``config`` overrides it and is validated against the
        state's shape-baked knobs (``ConfigMismatch`` when e.g. graph_k
        disagrees — those require a rebuild, not a restore). Snapshots
        from before the config layer (no recorded config) restore through
        the legacy fields unchanged."""
        from repro_torch.serve.durability import (DurableStore,
                                                  engine_from_state)

        store = DurableStore(path)
        state, extra, _step = store.load_latest()
        sp = params if params is not None else SearchParams(
            **extra["search_params"])
        stored = extra.get("config")
        cfg = config if config is not None else (
            FnsConfig.from_flat(stored["knobs"]) if stored else None)
        svc = cls(None, sp, mesh=mesh,
                  graph_build=dict(extra.get("graph_build") or {}),
                  capacity=extra.get("capacity"), config=cfg, device=device)
        vocab = (tuple(extra["vocab_sizes"])
                 if extra.get("vocab_sizes") else None)
        eng = engine_from_state(state, mesh=mesh, config=cfg,
                                params=(svc._batched_params()
                                        if cfg is None else None),
                                vocab_sizes=vocab,
                                device=None if mesh is not None
                                else svc.device)
        if isinstance(eng, BatchedEngine):
            svc._engine = eng
            svc.index = eng.index  # the sequential path works post-restore
        else:
            svc._sharded = eng
        svc._store = store
        recs, _ = store.journal.read()
        last = max([state.applied_seq] + [r[0] for r in recs])
        if replay:
            from repro_torch.core.batched.lifecycle import compact_state

            for rec in recs:
                if rec.seq <= state.applied_seq:
                    continue  # idempotent replay: already in the snapshot
                if rec.kind == "insert":
                    eng.insert_batch(rec.vectors, rec.metadata,
                                     gids=rec.gids)
                elif rec.kind == "delete":
                    eng.delete_batch(rec.gids)
                else:  # compact: deterministic from the replayed slabs
                    rep = compact_state(state, svc._cfg().maintenance,
                                        force=True)
                    if rep["shards"]:
                        eng.refresh_device(rep["shards"])
                state.applied_seq = rec.seq
            store.journal.repair()
        svc._next_seq = last + 1
        svc._sync_capacity(eng)
        return svc

    @classmethod
    def restore(cls, path: str, *, mesh=None,
                params: SearchParams | None = None,
                config: FnsConfig | None = None,
                device=None) -> "RetrievalService":
        """Snapshot-only restore: the service exactly as of the latest
        readable snapshot, journal suffix NOT replayed (sequence numbers
        still advance past it, so later ingests never collide)."""
        return cls.recover(path, mesh=mesh, params=params, config=config,
                           replay=False, device=device)

    def staleness(self) -> dict:
        """Ingest/staleness accounting: how much of the serving corpus is
        dynamic, how much append room is left, how often shards
        re-clustered — plus how many ingested rows the lazily-built
        sequential index (``query``) has NOT seen, since only the batched
        engines absorb inserts."""
        eng = self._sharded if self._sharded is not None else self._engine
        stats = eng.insert_stats if eng is not None else None
        if stats is None:
            n = self._corpus()[0].shape[0]
            free = self.capacity - n if self.capacity else 0
            stats = {"inserted_rows": 0, "corpus_rows": n,
                     "dynamic_fraction": 0.0,
                     "free_capacity": free,
                     "insert_batches": 0, "reclusters": 0,
                     "reverse_edge_repairs": 0,
                     # lifecycle signals (DESIGN.md §12): a build-once
                     # service has no tombstones, backlog, or growth
                     "deleted_rows": 0, "tombstoned_rows": 0,
                     "tombstone_fraction": 0.0, "free_slots": free,
                     "repair_backlog_rows": 0, "compactions": 0,
                     "slab_growths": 0, "centroid_drift": 0.0,
                     "maintenance_lag": 0}
        stats["sequential_index_stale_rows"] = (
            stats["inserted_rows"] if self.index is not None else 0)
        return stats


class EncodedRetriever:
    """LM encoder + RetrievalService: the end-to-end RAG serving path.
    Without a mesh the encoder runs where the service does
    (``service.device``), with ``params`` there or a copy of them (the
    caller's module does not move); over ``env``'s mesh it runs on the
    cells with ``params`` placed there (``place_params``), whatever the
    service's own ``mesh=``."""

    def __init__(self, cfg: ArchConfig, env: ShardEnv, params: Transformer,
                 service: RetrievalService):
        self.cfg, self.env = cfg, env
        self.params = (on_device(params, service.device) if env.mesh is None
                       else place_params(params, env))
        self.service = service

    def embed_tokens(self, tokens) -> np.ndarray:
        """(B, S) int prompts -> (B, d) unit fp32 embeddings on the host."""
        return encode(self.params, {"tokens": tokens}, self.cfg,
                      self.env).cpu().numpy()

    def retrieve(self, tokens, predicate: FilterPredicate, seed: int = 0):
        """Encode, then one sequential host query per prompt."""
        vecs = self.embed_tokens(tokens)
        return [self.service.query(v, predicate, seed=seed + i)
                for i, v in enumerate(vecs)]

    def retrieve_batch(self, tokens, predicates):
        """Encode + batched lockstep retrieval: one predicate per prompt
        row, the whole batch one ``query_batch``."""
        vecs = self.embed_tokens(tokens)
        return self.service.query_batch(vecs, list(predicates))
