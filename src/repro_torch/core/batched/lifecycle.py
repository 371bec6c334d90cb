"""Document lifecycle: deletes, tombstone compaction, slab growth
(DESIGN.md §12).

Every live index is an append-only capacity slab whose packed
row-validity bitmap is the single liveness source the search reads. This
module closes the loop so a serving index can live forever:

* **delete** (``delete_rows``) is a validity-bit clear on the host mirror
  — search-path-free and recompile-free. The row becomes a *tombstone*:
  its slab data stays (it keeps routing walks, which is what makes a
  bit clear recall-safe — seeds come from the atlas pass bitmaps, which
  already AND in validity, so a dead row can never be seeded or
  returned, only traversed);
* **compaction** (``compact_shard`` / ``compact_state``) recycles
  tombstoned slots into the free tail: survivors are packed to a prefix,
  every edge at a recycled slot is unlinked (the reverse-edge drop),
  rows left under-connected are relinked by the build's α-RNG rule
  (``graph.relink_rows``), and the atlas decrements — membership moves,
  lost clusters' centroids re-average over survivors, base counts drop;
* **growth** (``grow_state`` / ``ensure_capacity``) re-shards past
  capacity instead of raising: every shard's slab is enlarged in place
  (shard COUNT is pinned by the mesh axis, so growth is per-shard cap),
  and the engine re-places its tensors at the new shapes.
  ``ensure_capacity`` prefers reclaiming tombstones over growing;
* the **deferred-repair backlog** (``drain_pending``): with
  ``maintenance.defer_repair`` the ingest hot path stops after slab
  writes + bit flips + nearest-cluster assignment, and the graph
  patching / centroid refresh it owes is queued on ``state.pending``.
  Draining the FIFO runs ``repair_range`` over the exact ranges in
  insert order, which reproduces the inline result (forward candidates
  of ``patch_adjacency`` are strictly earlier rows). Compaction drains a
  shard's backlog before remapping rows, so queued ranges never dangle.

Everything here mutates HOST state (``InsertState``); the engines
re-place device arrays afterwards (``delete_batch`` costs one bitmap
re-pack, compaction/growth a refresh). Compaction is deterministic given
the slab state, so a crash mid-compaction recovers by redoing it.

``_smoke`` drives the lifecycle through the sharded engine (S shards on
one device).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch import faults
from repro_torch.core.batched.insert import (InsertState, _refresh_centroids,
                                             repair_range)
from repro_torch.core.config import MaintenanceConfig
from repro_torch.core.graph import relink_rows


def delete_rows(state: InsertState, gids) -> tuple[int, list[int]]:
    """Tombstone documents by global id: clear their validity bits on the
    host mirror (nothing else — slab data, graph edges and atlas
    membership stay until compaction). Unknown or already-deleted ids
    raise ``ValueError`` naming them, so a delete is never silently
    absorbed. Returns (rows deleted, touched shard indices)."""
    gids = np.unique(np.asarray(gids, np.int64).ravel())
    if gids.size == 0:
        return 0, []
    shard_of, row_of = state.locate_gids(gids)
    missing = gids[shard_of < 0]
    if missing.size:
        raise ValueError(
            f"delete of unknown or already-deleted gids: "
            f"{missing.tolist()}")
    touched: list[int] = []
    for s in np.unique(shard_of):
        sh = state.shards[s]
        sh.live[row_of[shard_of == s]] = False
        touched.append(int(s))
    state.deleted += int(gids.size)
    # host bits cleared; the device bitmap re-pack is the caller's publish
    faults.fire("lifecycle.post-tombstone")
    return int(gids.size), touched


def drain_pending(state: InsertState, *, shard: int | None = None,
                  budget_rows: int | None = None) -> int:
    """Run deferred graph repair from the front of the backlog FIFO:
    each entry is an inserted (shard, lo, hi) range whose
    ``patch_adjacency`` + centroid refresh the hot path skipped. Ranges
    are split to honor ``budget_rows`` exactly (the remainder is
    re-queued in place, so order — and therefore inline equivalence — is
    preserved). ``shard`` restricts draining to one shard (compaction
    uses this). Returns rows repaired."""
    done = 0
    keep: list[tuple[int, int, int]] = []
    for s, lo, hi in state.pending:
        if shard is not None and s != shard:
            keep.append((s, lo, hi))
            continue
        if budget_rows is not None and done >= budget_rows:
            keep.append((s, lo, hi))
            continue
        take = hi - lo
        if budget_rows is not None:
            take = min(take, budget_rows - done)
        repair_range(state, s, lo, lo + take)
        done += take
        if lo + take < hi:
            keep.append((s, lo + take, hi))
    state.pending = keep
    return done


def compact_shard(state: InsertState, s: int,
                  mcfg: MaintenanceConfig | None = None) -> dict:
    """Recycle one shard's tombstoned slots into the free tail, in place.

    Invariants (DESIGN.md §12): the shard's deferred-repair backlog is
    drained FIRST (queued ranges must not dangle across the remap);
    survivors keep their relative order (the packed prefix is the live
    subsequence, so CSR emission and rebuild comparisons stay stable);
    every adjacency entry that pointed at a recycled slot is unlinked
    and rows whose degree fell below ``min_degree_frac * graph_k`` are
    relinked over the survivors; the atlas decrements exactly — moved
    assignments, base counts reduced by the per-cluster dead counts,
    lost clusters' centroids re-averaged over the remaining members.
    Returns {"reclaimed", "relinked", "edges_added", "repairs"}."""
    mcfg = mcfg or MaintenanceConfig()
    sh = state.shards[s]
    if sh.tombstones == 0:
        return {"reclaimed": 0, "relinked": 0, "edges_added": 0,
                "repairs": 0}
    drain_pending(state, shard=s)
    # survivors chosen, remap not yet applied: the torn-compaction moment
    faults.fire("maintenance.mid-compact")
    n_valid = sh.n_valid
    live = sh.live[:n_valid]
    live_idx = np.nonzero(live)[0]
    n_live = live_idx.size
    reclaimed = n_valid - n_live
    new_of_old = np.full(n_valid, -1, np.int64)
    new_of_old[live_idx] = np.arange(n_live)
    # pack the slab: survivors down to a prefix, recycled tail zeroed out
    sh.vectors[:n_live] = sh.vectors[live_idx]
    sh.vectors[n_live:n_valid] = 0.0
    sh.metadata[:n_live] = sh.metadata[live_idx]
    sh.metadata[n_live:n_valid] = -1
    sh.global_ids[:n_live] = sh.global_ids[live_idx]
    sh.global_ids[n_live:n_valid] = -1
    # graph: remap surviving edges, unlink dead targets (-1), left-pack
    # each row so -1 padding stays a suffix (the walk kernels assume it)
    adj = sh.adjacency[live_idx]
    ok = adj >= 0
    mapped = np.full_like(adj, -1)
    mapped[ok] = new_of_old[adj[ok]]
    order = np.argsort(mapped < 0, axis=1, kind="stable")
    sh.adjacency[:n_live] = np.take_along_axis(mapped, order, axis=1)
    sh.adjacency[n_live:n_valid] = -1
    # atlas decrement: move assignments with their rows, drop the dead
    # members from the last-(re)cluster baseline so the occupancy trigger
    # keeps measuring growth against a true count
    assign = sh.atlas.assign
    lost = np.bincount(assign[:n_valid][~live],
                       minlength=sh.atlas.n_clusters).astype(np.int64)
    assign[:n_live] = assign[:n_valid][live_idx]
    assign[n_live:n_valid] = 0
    sh.atlas.base_counts = np.maximum(sh.atlas.base_counts - lost, 0)
    sh.live[:n_live] = True
    sh.live[n_live:] = False
    sh.n_valid = n_live
    _refresh_centroids(sh, np.nonzero(lost)[0])
    # relink rows the unlinking left under-connected
    deg = (sh.adjacency[:n_live] >= 0).sum(axis=1)
    weak = np.nonzero(deg < max(1, int(mcfg.min_degree_frac
                                       * state.graph_k)))[0]
    rep = relink_rows(sh.adjacency, sh.vectors, weak, n_live,
                      k=state.graph_k + state.graph_k // 2,
                      alpha=state.alpha)
    state.repairs += rep["repairs"]
    state.compactions += 1
    return {"reclaimed": reclaimed, "relinked": rep["relinked"],
            "edges_added": rep["edges_added"], "repairs": rep["repairs"]}


def compact_state(state: InsertState, mcfg: MaintenanceConfig | None = None,
                  *, force: bool = False) -> dict:
    """Compact every shard past the tombstone threshold (``force``
    compacts any shard with tombstones at all — the ``compact_now`` /
    capacity-pressure path). Returns summed per-shard accounting plus
    the touched shard list (for the device refresh)."""
    mcfg = mcfg or MaintenanceConfig()
    out = {"reclaimed": 0, "relinked": 0, "edges_added": 0, "repairs": 0,
           "shards": []}
    for s, sh in enumerate(state.shards):
        t = sh.tombstones
        if t == 0:
            continue
        if not force and not (t >= mcfg.compact_min_rows
                              and t / max(sh.n_valid, 1)
                              >= mcfg.compact_tombstone_frac):
            continue
        rep = compact_shard(state, s, mcfg)
        for key in ("reclaimed", "relinked", "edges_added", "repairs"):
            out[key] += rep[key]
        out["shards"].append(s)
    return out


def grow_state(state: InsertState, new_cap: int) -> None:
    """Enlarge every shard's capacity slab to ``new_cap`` rows in place.
    The shard COUNT is pinned by the mesh data axis, so re-sharding past
    capacity means a bigger per-shard slab: the new tail is unwritten
    (zero vectors, -1 padding, dead bits), every engine invariant —
    prefix watermark, CSR dead-tail, packed bitmap — carries over, and
    the jitted search programs simply retrace on the new shapes."""
    old = state.shards[0].cap
    if new_cap <= old:
        return
    pad = new_cap - old
    for sh in state.shards:
        d = sh.vectors.shape[1]
        sh.vectors = np.concatenate(
            [sh.vectors, np.zeros((pad, d), np.float32)])
        sh.adjacency = np.concatenate(
            [sh.adjacency,
             np.full((pad, sh.adjacency.shape[1]), -1, np.int32)])
        sh.metadata = np.concatenate(
            [sh.metadata,
             np.full((pad, sh.metadata.shape[1]), -1, np.int32)])
        sh.global_ids = np.concatenate(
            [sh.global_ids, np.full(pad, -1, np.int32)])
        sh.live = np.concatenate([sh.live, np.zeros(pad, bool)])
        sh.atlas.assign = np.concatenate(
            [sh.atlas.assign, np.zeros(pad, np.int32)])
    state.grown += 1


def ensure_capacity(state: InsertState, n_new: int,
                    mcfg: MaintenanceConfig | None = None) -> dict:
    """Make room for ``n_new`` appended rows before the slab writes run:
    first by compacting tombstones back into the free tail, then — when
    the index has genuinely outgrown its slabs — by growing every shard
    to ``max(cap * grow_factor, cap + ceil(need / S))``. With
    ``auto_grow`` off, growth raises the pre-lifecycle capacity error
    instead. Returns {"compacted", "grown", "new_cap"} so the engine
    knows whether a full device refresh is due."""
    mcfg = mcfg or MaintenanceConfig()
    cap = state.shards[0].cap
    n_shards = len(state.shards)
    out = {"compacted": False, "grown": False, "new_cap": cap}
    free = n_shards * cap - state.n_valid
    if free >= n_new:
        return out
    if state.tombstones:
        compact_state(state, mcfg, force=True)
        out["compacted"] = True
        free = n_shards * cap - state.n_valid
        if free >= n_new:
            return out
    if not mcfg.auto_grow:
        raise ValueError(
            f"insert of {n_new} rows exceeds free capacity {free} "
            f"(per-shard cap {cap}); rebuild with a larger capacity")
    new_cap = max(int(math.ceil(cap * mcfg.grow_factor)),
                  cap + int(math.ceil((n_new - free) / n_shards)))
    grow_state(state, new_cap)
    out["grown"] = True
    out["new_cap"] = new_cap
    return out


def _smoke(device=None) -> None:
    """Lifecycle smoke on ``device`` (None means CUDA): insert into a
    4-shard index through the sharded engine in reference mode, delete
    half, verify the tombstoned rows vanish from results while the
    survivors stay findable, compact, verify again on the recycled slab,
    re-insert onto the free tail — every search one run of each shard's
    program."""
    from repro_torch.core.batched.sharded import (ShardedEngine,
                                                  build_sharded_index)
    from repro_torch.core.config import FnsConfig
    from repro_torch.core.types import FilterPredicate, Query, normalize

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
    new_v = normalize(rng.standard_normal((32, d)))
    new_m = np.full((32, 2), 3, np.int32)
    gids = eng.insert_batch(new_v, new_m)
    dead, alive = gids[::2], gids[1::2]
    eng.delete_batch(dead)
    queries = [Query(vector=v, predicate=FilterPredicate.make({0: [3]}))
               for v in new_v]

    def check(tag):
        d0 = eng.dispatches
        ids, _ = eng.search(queries)
        assert eng.dispatches - d0 == s, \
            f"{tag}: a search must run each shard once"
        flat = {int(g) for i in ids for g in np.asarray(i).tolist()}
        ghosts = [int(g) for g in dead if int(g) in flat]
        assert not ghosts, f"{tag}: deleted gids {ghosts} still returned"
        found = sum(int(g) in flat for g in alive)
        assert found == alive.size, \
            f"{tag}: only {found}/{alive.size} live inserts findable"

    check("post-delete")
    st = eng.state
    assert st.tombstones == dead.size
    rep = compact_state(st, force=True)
    assert st.tombstones == 0 and rep["reclaimed"] == dead.size
    eng.refresh_device()
    check("post-compaction")
    # recycled slots are genuinely reusable: re-insert onto the free tail
    gids2 = eng.insert_batch(new_v[:8], new_m[:8])
    alive = np.concatenate([alive, gids2])
    check("post-recycle")
    print(f"lifecycle-smoke ok: {dead.size} deleted, "
          f"{rep['reclaimed']} slots reclaimed ({rep['relinked']} rows "
          f"relinked) on {s} shards, live rows findable throughout")


if __name__ == "__main__":
    _smoke()
