"""Dynamic inserts: append with graph patching and atlas re-clustering
on a capacity slab (DESIGN.md §9).

Every live index is a *capacity slab*: vectors / adjacency / metadata /
global-id arrays sized to ``cap`` rows with a valid-row prefix, and a
packed row-validity bitmap that the search ANDs into every pass bitmap —
flipping a bit is what makes a row visible. An insert batch:

1. assigns each row to a shard balance-aware (``assign_shards_balanced``
   extends the ``shard_bounds`` invariant to a growing corpus);
2. writes vectors/metadata/global-ids into the next free slab slots and
   flips their validity bits;
3. patches the shard's α-kNN subgraph via the reverse-edge repair rule
   (``graph.patch_adjacency``: forward kNN edges + α-RNG re-selection of
   saturated reverse rows);
4. updates the shard's atlas incrementally — new rows join their nearest
   cluster, affected centroids are re-averaged, CSR/presence tables are
   re-emitted — and triggers a full per-shard re-cluster (same K) when
   any cluster's occupancy has grown past ``recluster_occupancy``× its
   count at the last (re)cluster or its centroid has drifted past
   ``recluster_drift`` in cosine distance.

All state here is HOST state (numpy); the engine owns the device tensors
and re-places them from the slab after each batch
(``emit_device_atlas(sh, v_cap, device)`` packs the atlas onto the
engine's device). ``BatchedEngine`` runs one shard; the sharded engine
(``core/batched/sharded.py``) runs S shards on one device, and ``_smoke``
drives its insert path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core.atlas import AnchorAtlas
from repro_torch.core.batched.bitmap import n_words
from repro_torch.core.device_atlas import (DeviceAtlas, resolve_device,
                                           words_to_torch)
from repro_torch.core.graph import (Graph, assign_shards_balanced,
                                    patch_adjacency)
from repro_torch.core.kmeans import kmeans
from repro_torch.core.types import normalize


@dataclasses.dataclass(frozen=True)
class InsertParams:
    """Append-path knobs (graph knobs come from the index build)."""

    recluster_occupancy: float = 2.0  # cluster grew past occ× its count at
    # the last (re)cluster
    recluster_drift: float = 0.15     # centroid moved past this cosine
    # distance since the last (re)cluster
    kmeans_iters: int = 10


@dataclasses.dataclass
class HostAtlas:
    """Host mirror of one shard's atlas, updated incrementally."""

    centroids: np.ndarray     # (K, d) f32 unit-norm, current
    assign: np.ndarray        # (cap,) i32; meaningful on valid rows only
    base_counts: np.ndarray   # (K,) i64 member counts at last (re)cluster
    base_centroids: np.ndarray  # (K, d) centroids at last (re)cluster
    reclusters: int = 0

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]


@dataclasses.dataclass
class ShardState:
    """Mutable host mirror of one shard's capacity slab.

    WRITTEN rows are always a prefix [0, n_valid) — inserts append at the
    watermark — but LIVE rows are an arbitrary subset of them once rows
    are deleted: ``live`` is the per-row liveness mask the packed search
    bitmap is emitted from (a delete is one bit clear here, nothing else).
    A written-but-dead row is a *tombstone*: its slab data stays (it still
    routes walks and carries stale atlas membership) until compaction
    recycles the slot into the free tail (``lifecycle.compact_shard``)."""

    vectors: np.ndarray      # (cap, d) f32, zero beyond n_valid
    adjacency: np.ndarray    # (cap, R) i32 shard-local, -1 padded
    metadata: np.ndarray     # (cap, F) i32, -1 beyond n_valid
    global_ids: np.ndarray   # (cap,) i32, -1 beyond n_valid
    n_valid: int
    atlas: HostAtlas
    live: np.ndarray | None = None  # (cap,) bool; None = derive prefix

    def __post_init__(self):
        if self.live is None:
            self.live = np.arange(self.cap) < self.n_valid

    @property
    def cap(self) -> int:
        return self.vectors.shape[0]

    @property
    def valid(self) -> np.ndarray:
        return self.live

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    @property
    def tombstones(self) -> int:
        """Written-but-dead rows awaiting compaction."""
        return self.n_valid - self.n_live


@dataclasses.dataclass
class InsertState:
    """Host side of a dynamic (append-able) index: one slab per shard plus
    the build knobs the append path reuses."""

    shards: list[ShardState]
    v_cap: int
    graph_k: int
    alpha: float
    seed: int
    next_gid: int
    params: InsertParams = InsertParams()
    inserted: int = 0
    batches: int = 0
    repairs: int = 0
    # highest journal sequence number whose rows are in the slabs: replay
    # after recovery applies only records with seq > applied_seq, which is
    # what makes re-running an already-applied batch a no-op (DESIGN.md §10)
    applied_seq: int = 0
    # -- lifecycle accounting (DESIGN.md §12) --------------------------------
    deleted: int = 0
    compactions: int = 0
    grown: int = 0
    # deferred graph-repair backlog: (shard, lo, hi) written-row ranges
    # whose patch_adjacency / centroid refresh the maintenance loop still
    # owes, in insert order (drained FIFO so the deferred result equals
    # the inline one). Compaction drains a shard's ranges before it
    # remaps rows, so entries never dangle.
    pending: list = dataclasses.field(default_factory=list)

    @property
    def n_valid(self) -> int:
        return sum(s.n_valid for s in self.shards)

    @property
    def n_live(self) -> int:
        return sum(s.n_live for s in self.shards)

    @property
    def tombstones(self) -> int:
        return sum(s.tombstones for s in self.shards)

    @property
    def pending_rows(self) -> int:
        return sum(hi - lo for _s, lo, hi in self.pending)

    @property
    def reclusters(self) -> int:
        return sum(s.atlas.reclusters for s in self.shards)

    def locate_gids(self, gids) -> tuple[np.ndarray, np.ndarray]:
        """Map global ids to their LIVE slab slots: -> (shard (G,) i32,
        row (G,) i64), -1/-1 where the id is unknown or tombstoned. A
        recycled slot may still hold a dead row's id until compaction, so
        only live rows count as present — which is also what makes
        explicit re-insertion of a deleted id legal."""
        gids = np.asarray(gids, np.int64).ravel()
        shard_of = np.full(gids.size, -1, np.int32)
        row_of = np.full(gids.size, -1, np.int64)
        for s, sh in enumerate(self.shards):
            g = sh.global_ids[: sh.n_valid].astype(np.int64)
            if g.size == 0:
                continue
            alive = sh.live[: sh.n_valid]
            # a re-introduced id occurs TWICE until compaction sweeps the
            # tombstoned slot: sort live occurrences first within each
            # gid group so searchsorted resolves to the live one
            order = np.lexsort((~alive, g))
            pos = np.searchsorted(g[order], gids)
            cand = order[np.minimum(pos, order.size - 1)]
            hit = (pos < order.size) & (g[cand] == gids)
            hit &= alive[cand]
            shard_of[hit] = s
            row_of[hit] = cand[hit]
        return shard_of, row_of

    def expand_vocab(self, vocab_sizes) -> tuple[int, ...] | None:
        """Widen per-field domains with any codes the inserts brought in
        (Not/Range lowering must keep covering the observed corpus)."""
        if vocab_sizes is None:
            return None
        seen = np.maximum.reduce(
            [sh.metadata[: sh.n_valid][sh.live[: sh.n_valid]].max(
                axis=0, initial=-1) for sh in self.shards])
        return tuple(max(old, int(mx) + 1)
                     for old, mx in zip(vocab_sizes, seen))

    def centroid_drift(self) -> float:
        """Max cosine drift of any shard's centroids since its last
        (re)cluster — one of the maintenance scheduling signals."""
        worst = 0.0
        for sh in self.shards:
            at = sh.atlas
            drift = 1.0 - np.einsum("kd,kd->k", at.centroids,
                                    at.base_centroids)
            worst = max(worst, float(drift.max(initial=0.0)))
        return worst

    def stats(self) -> dict:
        """Staleness/ingest accounting surfaced by the serving layer."""
        cap = sum(s.cap for s in self.shards)
        n = self.n_live
        tomb = self.tombstones
        backlog = self.pending_rows
        return {"inserted_rows": self.inserted,
                "corpus_rows": n,
                "dynamic_fraction": self.inserted / max(n, 1),
                "free_capacity": cap - self.n_valid,
                "insert_batches": self.batches,
                "reclusters": self.reclusters,
                "reverse_edge_repairs": self.repairs,
                # lifecycle signals (DESIGN.md §12)
                "deleted_rows": self.deleted,
                "tombstoned_rows": tomb,
                "tombstone_fraction": tomb / max(self.n_valid, 1),
                "free_slots": cap - self.n_valid + tomb,
                "repair_backlog_rows": backlog,
                "compactions": self.compactions,
                "slab_growths": self.grown,
                "centroid_drift": self.centroid_drift(),
                # deferred work a query might observe: un-repaired rows
                # plus tombstones still holding slab slots
                "maintenance_lag": backlog + tomb}


def make_shard_state(vectors: np.ndarray, metadata: np.ndarray,
                     global_ids: np.ndarray, adjacency: np.ndarray,
                     atlas: AnchorAtlas, cap: int) -> ShardState:
    """Wrap one shard's built arrays into a capacity slab. ``vectors`` /
    ``metadata`` / ``global_ids`` hold the n_valid real rows; ``adjacency``
    is the shard graph's padded matrix (any width)."""
    n_valid, d = vectors.shape
    f_count = metadata.shape[1]
    vec = np.zeros((cap, d), np.float32)
    vec[:n_valid] = vectors
    meta = np.full((cap, f_count), -1, np.int32)
    meta[:n_valid] = metadata
    gids = np.full(cap, -1, np.int32)
    gids[:n_valid] = global_ids
    adj = np.full((cap, adjacency.shape[1]), -1, np.int32)
    adj[:n_valid] = adjacency
    assign = np.zeros(cap, np.int32)
    assign[:n_valid] = atlas.assign
    k = atlas.n_clusters
    host = HostAtlas(
        centroids=np.asarray(atlas.centroids, np.float32).copy(),
        assign=assign,
        base_counts=np.bincount(atlas.assign, minlength=k).astype(np.int64),
        base_centroids=np.asarray(atlas.centroids, np.float32).copy())
    return ShardState(vec, adj, meta, gids, n_valid, host)


def _refresh_centroids(sh: ShardState, clusters: np.ndarray) -> None:
    """Exact re-average of the touched clusters' centroids over their
    current LIVE members (spherical mean, like the build's kmeans) —
    this is also the atlas *decrement* after deletes/compaction: a
    cluster that lost members is re-averaged over the survivors."""
    live_idx = np.nonzero(sh.live[: sh.n_valid])[0]
    a = sh.atlas.assign[live_idx]
    for c in np.unique(clusters):
        mem = live_idx[a == c]
        if mem.size:
            sh.atlas.centroids[c] = normalize(
                sh.vectors[mem].mean(axis=0))


def _recluster(sh: ShardState, iters: int, seed: int) -> None:
    """Full per-shard re-cluster with the SAME K (the stacked shard_map
    atlas shapes must not change) over the live rows only; resets the
    drift/occupancy baselines."""
    k = sh.atlas.n_clusters
    live_idx = np.nonzero(sh.live)[0]
    cen, assign = kmeans(sh.vectors[live_idx], k, iters=iters, seed=seed)
    sh.atlas.centroids = np.asarray(cen, np.float32)
    sh.atlas.assign[live_idx] = assign.astype(np.int32)
    sh.atlas.base_counts = np.bincount(assign, minlength=k).astype(np.int64)
    sh.atlas.base_centroids = sh.atlas.centroids.copy()
    sh.atlas.reclusters += 1


def _needs_recluster(sh: ShardState, p: InsertParams) -> bool:
    at = sh.atlas
    if sh.n_live < at.n_clusters:
        # kmeans clamps K to the point count: re-clustering an underfull
        # slab (e.g. an empty shard padded in by a cross-mesh restore)
        # would shrink K and break the stacked shard_map atlas shapes
        return False
    live = sh.live[: sh.n_valid]
    counts = np.bincount(at.assign[: sh.n_valid][live],
                         minlength=at.n_clusters)
    grown = counts > p.recluster_occupancy * np.maximum(at.base_counts, 1)
    drift = 1.0 - np.einsum("kd,kd->k", at.centroids, at.base_centroids)
    return bool(grown.any() or (drift > p.recluster_drift).any())


def repair_range(state: InsertState, s: int, lo: int, hi: int) -> None:
    """The deferred half of an insert: patch the shard subgraph around
    rows [lo, hi) and re-average their clusters' centroids + recluster
    check — exactly what the inline path runs, so draining the backlog
    FIFO reproduces the inline result. Called by the maintenance loop
    (and by compaction, which drains a shard's backlog before moving
    rows)."""
    sh = state.shards[s]
    p = state.params
    rep = patch_adjacency(sh.adjacency, sh.vectors, lo, hi,
                          k=state.graph_k + state.graph_k // 2,
                          alpha=state.alpha)
    state.repairs += rep["repairs"]
    _refresh_centroids(sh, sh.atlas.assign[lo:hi])
    if _needs_recluster(sh, p):
        _recluster(sh, p.kmeans_iters,
                   seed=state.seed + 1 + sh.atlas.reclusters)


def insert_rows(state: InsertState, vectors: np.ndarray,
                metadata: np.ndarray, *, gids: np.ndarray | None = None,
                defer_repair: bool = False) -> tuple[np.ndarray, list[int]]:
    """Append a batch of (vector, metadata) rows across the shards.

    Rows keep their arrival order in the global id space (ids continue
    from ``next_gid`` unless explicit ``gids`` re-introduce deleted
    documents — a gid that is still LIVE is rejected, duplicate ids must
    be explicit deletes first); shard placement is balance-aware. With
    ``defer_repair`` the hot path stops after slab writes + validity-bit
    flips + nearest-cluster assignment: graph patching, centroid
    refresh, and the recluster check are queued on ``state.pending`` for
    the maintenance loop (``repair_range``). Returns (global ids (B,)
    int32, touched shard indices)."""
    vectors = normalize(np.asarray(vectors, np.float32))
    metadata = np.atleast_2d(np.asarray(metadata, np.int32))
    if vectors.ndim != 2 or vectors.shape[0] != metadata.shape[0]:
        raise ValueError(
            f"insert batch shapes disagree: {vectors.shape} vectors vs "
            f"{metadata.shape} metadata")
    f_count = state.shards[0].metadata.shape[1]
    if metadata.shape[1] != f_count:
        raise ValueError(f"insert metadata has {metadata.shape[1]} fields, "
                         f"index has {f_count}")
    if metadata.max(initial=-1) >= state.v_cap:
        raise ValueError(
            f"insert metadata code {int(metadata.max())} out of the atlas "
            f"value range [0, {state.v_cap}); rebuild with a larger v_cap")
    b = vectors.shape[0]
    if gids is None:
        gids = (state.next_gid + np.arange(b)).astype(np.int32)
    else:
        gids = np.asarray(gids, np.int32).ravel()
        if gids.size != b:
            raise ValueError(
                f"insert got {b} rows but {gids.size} explicit gids")
        uniq, counts = np.unique(gids, return_counts=True)
        if (counts > 1).any():
            raise ValueError(
                f"duplicate gids within one insert batch: "
                f"{uniq[counts > 1].tolist()}")
        shard_of, _rows = state.locate_gids(gids)
        alive = gids[shard_of >= 0]
        if alive.size:
            raise ValueError(
                f"gids {alive.tolist()} are still live; delete them "
                f"before re-inserting (id reuse must be explicit)")
    fill = np.asarray([s.n_valid for s in state.shards])
    plan = assign_shards_balanced(fill, state.shards[0].cap, b)
    p = state.params
    touched: list[int] = []
    for s in np.unique(plan):
        sh = state.shards[s]
        rows = np.nonzero(plan == s)[0]
        lo = sh.n_valid
        hi = lo + rows.size
        sh.vectors[lo:hi] = vectors[rows]
        sh.metadata[lo:hi] = metadata[rows]
        sh.global_ids[lo:hi] = gids[rows]
        # crash window the journal exists for: slab slots written, validity
        # not yet flipped — a crash here must lose nothing after replay
        faults.fire("ingest.post-slab-write")
        # nearest-cluster assignment happens inline even when repair is
        # deferred: it is one small matmul and it is what makes the new
        # rows atlas-seedable (findable) before their graph edges exist
        new_assign = np.argmax(
            vectors[rows] @ sh.atlas.centroids.T, axis=1).astype(np.int32)
        sh.atlas.assign[lo:hi] = new_assign
        sh.n_valid = hi
        sh.live[lo:hi] = True
        if defer_repair:
            state.pending.append((int(s), int(lo), int(hi)))
            touched.append(int(s))
            continue
        # appended rows get 1.5x the build's forward-edge count: a built
        # node's neighbourhood is symmetrized over the whole corpus, while
        # an appended node receives reverse edges only opportunistically
        # (saturated rows may prune them away) — the extra forward edges
        # close the measured recall gap vs a from-scratch rebuild at broad
        # selectivities (rebuild-parity harness, tests/test_insert.py)
        rep = patch_adjacency(sh.adjacency, sh.vectors, lo, hi,
                              k=state.graph_k + state.graph_k // 2,
                              alpha=state.alpha)
        state.repairs += rep["repairs"]
        _refresh_centroids(sh, new_assign)
        if _needs_recluster(sh, p):
            _recluster(sh, p.kmeans_iters,
                       seed=state.seed + 1 + sh.atlas.reclusters)
        touched.append(int(s))
    if b:
        state.next_gid = max(state.next_gid, int(gids.max()) + 1)
    state.inserted += b
    state.batches += 1
    return gids, touched


# -- emitters: host state -> the structures the engines consume -------------

def emit_device_atlas(sh: ShardState, v_cap: int,
                      device=None) -> DeviceAtlas:
    """Pack a shard's host atlas into a DeviceAtlas on ``device`` (None
    means CUDA) with the exact ``pad_rows`` layout: LIVE rows CSR-grouped
    by cluster (ascending id within a cluster), every dead row — the
    unwritten tail AND any tombstones — appended after ``csr_offsets[K]``,
    assigned to cluster 0, so every leaf keeps its build-time shape.
    Keeping tombstones out of the member lists / presence bitmaps /
    envelopes means a deleted row can never be seeded or make a cluster
    falsely match; when liveness is a prefix this emits bit-identically to
    ``DeviceAtlas.from_atlas``. Every tensor is a copy: the host arrays
    keep changing under later inserts."""
    device = resolve_device(device)
    k = sh.atlas.n_clusters
    cap = sh.cap
    live_idx = np.nonzero(sh.live)[0].astype(np.int32)
    a_v = sh.atlas.assign[live_idx]
    order = live_idx[np.argsort(a_v, kind="stable")]
    dead = np.nonzero(~sh.live)[0].astype(np.int32)
    csr_pts = np.concatenate([order, dead])
    offsets = np.zeros(k + 1, np.int64)
    offsets[1:] = np.cumsum(np.bincount(a_v, minlength=k))
    inv_perm = np.empty(cap, np.int32)
    inv_perm[csr_pts] = np.arange(cap, dtype=np.int32)
    assign_full = np.zeros(cap, np.int32)
    assign_full[live_idx] = a_v
    f_count = sh.metadata.shape[1]
    pres = np.zeros((f_count, k, n_words(v_cap)), np.uint32)
    cmin = np.full((f_count, k), np.int32(2**31 - 1), np.int32)
    cmax = np.full((f_count, k), -1, np.int32)
    for f in range(f_count):
        codes = sh.metadata[live_idx, f]
        ok = codes >= 0
        np.minimum.at(cmin[f], a_v[ok], codes[ok])
        np.maximum.at(cmax[f], a_v[ok], codes[ok])
        # Codes at/above v_cap get no presence bit, same as the auto-v_cap
        # path of DeviceAtlas.from_atlas: value-set clauses can never name
        # them (pack_dnf lowers such In values to intervals), and interval
        # clauses prune clusters through the cmin/cmax envelope instead.
        inb = ok & (codes < v_cap)
        v = codes[inb].astype(np.uint32)
        bits = np.left_shift(np.ones_like(v), v & np.uint32(31))
        np.bitwise_or.at(pres[f], (a_v[inb], v >> np.uint32(5)), bits)

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device=device, dtype=dtype, copy=True)

    return DeviceAtlas(
        t(sh.atlas.centroids, torch.float32), t(assign_full, torch.int64),
        t(csr_pts, torch.int64), t(offsets, torch.int64),
        t(inv_perm, torch.int64), words_to_torch(pres, device),
        t(cmin, torch.int32), t(cmax, torch.int32), v_cap=v_cap)


def emit_graph(sh: ShardState) -> Graph:
    """The shard's current subgraph over valid rows, as a host ``Graph``
    (for the sequential engine / rebuild comparisons)."""
    nbrs = sh.adjacency[: sh.n_valid]
    return Graph(nbrs.copy(), (nbrs >= 0).sum(axis=1).astype(np.int32))


def emit_anchor_atlas(sh: ShardState) -> AnchorAtlas:
    """The host ``AnchorAtlas`` dict-of-dicts view of the incremental
    state (shared ``from_assignment`` pass, maintained assignment instead
    of a fresh kmeans) so the sequential search path can run on a
    dynamically grown index."""
    return AnchorAtlas.from_assignment(
        sh.atlas.centroids.copy(), sh.atlas.assign[: sh.n_valid],
        sh.metadata[: sh.n_valid])


def _smoke(device=None) -> None:
    """Insert-path smoke: build a 4-shard index with spare capacity on
    ``device`` (None means CUDA), insert a batch through the sharded
    engine in reference mode (every shard on the one device), and assert
    the new rows are findable in one search, which runs each shard's
    program once."""
    from repro_torch.core.batched.sharded import (ShardedEngine,
                                                  build_sharded_index)
    from repro_torch.core.config import FnsConfig
    from repro_torch.core.types import FilterPredicate, Query

    s = 4
    rng = np.random.default_rng(0)
    n, d = 400, 16
    vecs = normalize(rng.standard_normal((n, d)))
    meta = rng.integers(0, 5, (n, 2)).astype(np.int32)
    cfg = FnsConfig().with_knobs({"graph.graph_k": 8, "graph.r_max": 16,
                                  "serve.capacity": n + 64, "walk.k": 5,
                                  "walk.beam_width": 2})
    sidx = build_sharded_index(vecs, meta, s, config=cfg, device=device)
    eng = ShardedEngine(sidx, None, cfg, device=device)
    new_v = normalize(rng.standard_normal((16, d)))
    new_m = np.full((16, 2), 3, np.int32)
    gids = eng.insert_batch(new_v, new_m)
    queries = [Query(vector=v, predicate=FilterPredicate.make({0: [3]}))
               for v in new_v]
    d0 = eng.dispatches
    ids, _ = eng.search(queries)
    assert eng.dispatches - d0 == s, "a search must run each shard once"
    found = sum(int(g) in np.asarray(i).tolist()
                for g, i in zip(gids, ids))
    assert found == len(gids), f"only {found}/{len(gids)} inserts findable"
    print(f"insert-smoke ok: {len(gids)} rows on {s} shards, one search, "
          f"all findable")


if __name__ == "__main__":
    _smoke()
