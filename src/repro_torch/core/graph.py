"""α-kNN proximity graph construction (paper Algorithm 1).

Three stages: directed kNN (cosine) → symmetrization → *selective* α-RNG
pruning of over-degree hubs only. Nodes with |N| ≤ R_max are untouched, so
typical-node local connectivity is preserved while pathological hubs (which
symmetrization can inflate ~500×) are capped with directionally-diverse edges.

Also exposes ``knn_graph`` building blocks reused by HNSW and ground truth.
"""
from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np


@dataclasses.dataclass
class Graph:
    """Adjacency in padded-matrix form: (n, R_pad) int32, -1 padded."""

    neighbors: np.ndarray  # (n, R_pad) int32, -1 = none
    degrees: np.ndarray    # (n,) int32

    @property
    def n(self) -> int:
        return self.neighbors.shape[0]

    @property
    def r_pad(self) -> int:
        return self.neighbors.shape[1]

    def neighbor_list(self, i: int) -> np.ndarray:
        return self.neighbors[i, : self.degrees[i]]

    @property
    def n_edges(self) -> int:
        return int(self.degrees.sum())

    def memory_bytes(self) -> int:
        return self.neighbors.nbytes


def _top_k_select(g: np.ndarray, k: int, idx: np.ndarray,
                  sims: np.ndarray | None) -> None:
    """Each row's k largest entries of ``g``, in descending order, into
    ``idx`` (and their values into ``sims``), by a partition of the whole
    row: the reference's ranking, ties included."""
    part = np.argpartition(-g, k - 1, axis=1)[:, :k]
    vals = np.take_along_axis(g, part, axis=1)
    order = np.argsort(-vals, axis=1)
    idx[:] = np.take_along_axis(part, order, axis=1)
    if sims is not None:
        sims[:] = np.take_along_axis(vals, order, axis=1)


TOPK_GROUPS = 4   # group maxima a line per entry kept, for the threshold


def _flat_nonzero(mask: np.ndarray) -> np.ndarray:
    """``np.flatnonzero`` of a sparse contiguous mask, read 8 bytes a
    word: only the words that hold a True are looked into."""
    flat = mask.reshape(-1)
    if flat.size % 8:
        return np.flatnonzero(flat)
    words = np.flatnonzero(flat.view(np.uint64))
    w, k = np.nonzero(flat.reshape(-1, 8)[words])
    return words[w] * 8 + k


def _best(g: np.ndarray, kk: int, axis: int = 1,
          floor: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Each row's (``axis`` 1) or column's (``axis`` 0) kk largest entries
    of ``g`` at or above its ``floor``, in descending order, as (values,
    their column or row ids); -inf and -1 past the last. Tied entries come
    in any order. The kk-th largest of a line's group maxima bounds its
    kk-th largest entry from below, so only the few entries at or above
    it (and the floor) are sorted."""
    lines, n = g.shape if axis == 1 else g.shape[::-1]
    c = max(1, n // (TOPK_GROUPS * kk))
    m = n // c
    if m <= kk:
        x = np.ascontiguousarray(g if axis == 1 else g.T)
        order = np.argsort(-x, axis=1, kind="stable")[:, :kk]
        vals = np.take_along_axis(x, order, axis=1)
        if floor is not None:
            low = vals < floor[:, None]
            vals, order = np.where(low, -np.inf, vals), np.where(low, -1, order)
        pad = kk - vals.shape[1]
        return (np.pad(vals, ((0, 0), (0, pad)), constant_values=-np.inf),
                np.pad(order, ((0, 0), (0, pad)), constant_values=-1))
    # m disjoint groups, group j the entries j, j + m, j + 2m, ...
    if axis == 1:
        gmax = g[:, :m * c].reshape(lines, c, m).max(axis=1)
        tail = g[:, m * c:].max(axis=1, keepdims=True) if m * c < n else None
    else:
        gmax = g[:m * c].reshape(c, m, lines).max(axis=0).T
        tail = g[m * c:].max(axis=0)[:, None] if m * c < n else None
    if tail is not None:
        gmax = np.concatenate([gmax, tail], axis=1)
    t = np.partition(gmax, gmax.shape[1] - kk, axis=1)[:, gmax.shape[1] - kk]
    if floor is not None:
        t = np.maximum(t, floor)
    r, e = np.divmod(_flat_nonzero(g >= (t[:, None] if axis == 1
                                           else t[None, :])), g.shape[1])
    got = g[r, e]
    ll, ee = (r, e) if axis == 1 else (e, r)
    if axis == 0:   # entries by line: a radix sort where the ids allow
        order = np.argsort(ll.astype(np.uint16) if lines <= 1 << 16 else ll,
                           kind="stable")
        ll, ee, got = ll[order], ee[order], got[order]
    counts = np.bincount(ll, minlength=lines)
    pos = np.arange(ll.size) - (np.cumsum(counts) - counts)[ll]
    vals = np.full((lines, max(int(counts.max(initial=0)), kk)), -np.inf,
                   dtype=g.dtype)
    ids = np.full(vals.shape, -1, dtype=np.int64)
    vals[ll, pos] = got
    ids[ll, pos] = ee
    return _keep(vals, ids, kk)


def _keep(vals: np.ndarray, cols: np.ndarray,
          kk: int) -> tuple[np.ndarray, np.ndarray]:
    """The kk largest of each row of ``vals`` (with their ``cols``),
    descending."""
    order = np.argsort(-vals, axis=1, kind="stable")[:, :kk]
    return (np.take_along_axis(vals, order, axis=1),
            np.take_along_axis(cols, order, axis=1))


def brute_knn(vectors: np.ndarray, k: int, block: int = 2048,
              return_sims: bool = False):
    """Exact cosine kNN via blocked matmul; excludes self.

    The output is the reference's (``repro.core.graph.brute_knn``: each
    block of ``block`` rows times every row, each row ranked by
    ``_top_k_select``), bit for bit, at about half its products. The Gram
    matrix is symmetric and BLAS gives an entry the same bits whichever
    of its two rows is on the left and however many columns the product
    has, so a block is multiplied only with the rows from its own on: its
    rows see those columns, and the later rows see this block's columns
    as the product's columns, whose best k + 1 each are carried to them.
    Each row keeps its k + 1 best entries as they come. Where those are
    distinct the row has one answer, the reference's; a row with a tie
    among them is ranked by ``_top_k_select`` on its whole product, as
    the reference ranks it. The ranking runs in slices on a thread a
    core (numpy releases the interpreter; each line's result is its own,
    so the output does not depend on the slicing) while the next block's
    product runs."""
    n = vectors.shape[0]
    kk = k + 1
    vt = vectors.T.copy()
    best_v = np.full((n, kk), -np.inf, dtype=np.float32)
    best_i = np.full((n, kk), -1, dtype=np.int64)
    carry_v, carry_i = best_v.copy(), best_i.copy()   # columns left of a row
    workers = os.cpu_count() or 1

    def rank(part, axis, s, lo, hi, dst_v, dst_i):
        """The best kk of ``part``'s lines (rows lo..hi of the output;
        ids from column s on) merged with those carried, into dst."""
        v, i = _best(part, kk, axis, floor=carry_v[lo:hi, -1])
        dst_v[lo:hi], dst_i[lo:hi] = _keep(
            np.concatenate([carry_v[lo:hi], v], axis=1),
            np.concatenate([carry_i[lo:hi], np.where(i >= 0, i + s, -1)],
                           axis=1), kk)

    jobs = []
    with ThreadPoolExecutor(workers) as pool:
        for s in range(0, n, block):
            e = min(s + block, n)
            # this block's product runs while the last block is ranked
            g = vectors[s:e] @ vt[:, s:]               # (b, n - s)
            g[np.arange(e - s), np.arange(e - s)] = -np.inf
            for j in jobs:
                j.result()
            # its rows over columns s..n; its columns e..n, later rows'
            step = -(-(e - s) // workers)
            jobs = [pool.submit(rank, g[r:r + step], 1, s, s + r,
                                min(s + r + step, e), best_v, best_i)
                    for r in range(0, e - s, step)]
            cstep = max(-(-(n - e) // workers), 1)
            jobs += [pool.submit(rank, g[:, c - s:c - s + cstep], 0, s, c,
                                 min(c + cstep, n), carry_v, carry_i)
                     for c in range(e, n, cstep)]
        for j in jobs:
            j.result()
    idx = best_i[:, :k].astype(np.int32)
    sims = best_v[:, :k].copy()
    redo = np.flatnonzero((best_v[:, 1:] == best_v[:, :-1]).any(axis=1))
    if n > 1 and n % block == 1:
        # the reference's last block is one row, which numpy multiplies
        # as a matrix-vector product, summing in another order
        redo = redo[redo != n - 1]
        g = vectors[n - 1:] @ vt
        g[0, n - 1] = -np.inf
        _top_k_select(g, k, idx[n - 1:], sims[n - 1:])
    for c in range(0, redo.size, block):
        rows = redo[c:c + block]
        # two rows at least: BLAS gives an entry of any product of two
        # rows or more the bits of the reference's block product
        g = vectors[np.append(rows, (rows[0] + 1) % n)] @ vt
        g = g[:rows.size]
        g[np.arange(rows.size), rows] = -np.inf
        t_idx, t_sims = idx[rows], sims[rows]
        _top_k_select(g, k, t_idx, t_sims)
        idx[rows], sims[rows] = t_idx, t_sims
    return (idx, sims) if return_sims else idx


def _symmetrize(knn: np.ndarray) -> list[np.ndarray]:
    """Stage 2: add reverse edges; returns per-node neighbor arrays."""
    n, k = knn.shape
    src = np.repeat(np.arange(n, dtype=np.int32), k)
    dst = knn.reshape(-1)
    # undirected edge set via canonical ordering
    a = np.minimum(src, dst)
    b = np.maximum(src, dst)
    uniq = np.unique(a.astype(np.int64) * n + b)
    ua = (uniq // n).astype(np.int32)
    ub = (uniq % n).astype(np.int32)
    both_src = np.concatenate([ua, ub])
    both_dst = np.concatenate([ub, ua])
    order = np.argsort(both_src, kind="stable")
    both_src, both_dst = both_src[order], both_dst[order]
    counts = np.bincount(both_src, minlength=n)
    splits = np.cumsum(counts)[:-1]
    return np.split(both_dst, splits)


def _alpha_rng_prune(i: int, nbrs: np.ndarray, vectors: np.ndarray,
                     r_max: int, alpha: float) -> np.ndarray:
    """Stage 3 inner loop: α-RNG selection in distance order (cosine dist)."""
    vi = vectors[i]
    vn = vectors[nbrs]
    d_i = 1.0 - vn @ vi                           # d(i, p) for all candidates
    order = np.argsort(d_i)
    nbrs, vn, d_i = nbrs[order], vn[order], d_i[order]
    kept: list[int] = []
    kept_vecs = np.empty((r_max, vectors.shape[1]), dtype=vectors.dtype)
    for j in range(nbrs.size):
        if not kept:
            ok = True
        else:
            # d(q, p) for q in kept (cosine distance between neighbors)
            d_qp = 1.0 - kept_vecs[: len(kept)] @ vn[j]
            ok = bool(np.all(d_i[j] < alpha * d_qp))
        if ok:
            kept_vecs[len(kept)] = vn[j]
            kept.append(j)
            if len(kept) >= r_max:
                break
    return nbrs[np.asarray(kept, dtype=np.int64)]


def build_alpha_knn(vectors: np.ndarray, k: int = 32, r_max: int = 128,
                    alpha: float = 1.2, block: int = 2048, *,
                    config=None, times: dict | None = None) -> Graph:
    """Full Algorithm 1. ``r_max`` caps only over-degree nodes.

    ``config`` (a ``GraphConfig`` or full ``FnsConfig``) supplies every
    knob when given; the loose kwargs remain for direct callers (this is
    a leaf builder — the engines thread their ``FnsConfig`` through).
    ``times``, where given, receives each stage's seconds (``knn_s``,
    ``symmetrize_s``, ``prune_s``) and the rows pruned (``pruned``)."""
    if config is not None:
        g = getattr(config, "graph", config)
        k, r_max, alpha, block = g.graph_k, g.r_max, g.alpha, g.build_block
    t0 = time.perf_counter()
    knn = brute_knn(vectors, k, block=block)                 # Stage 1
    t1 = time.perf_counter()
    adj = _symmetrize(knn)                                   # Stage 2
    t2 = time.perf_counter()
    pruned = 0
    for i in range(len(adj)):                                # Stage 3
        if adj[i].size > r_max:
            adj[i] = _alpha_rng_prune(i, adj[i], vectors, r_max, alpha)
            pruned += 1
    if times is not None:
        times.update(knn_s=t1 - t0, symmetrize_s=t2 - t1,
                     prune_s=time.perf_counter() - t2, pruned=pruned)
    r_pad = max(a.size for a in adj)
    n = len(adj)
    neighbors = np.full((n, r_pad), -1, dtype=np.int32)
    degrees = np.empty(n, dtype=np.int32)
    for i, a in enumerate(adj):
        neighbors[i, : a.size] = a
        degrees[i] = a.size
    return Graph(neighbors, degrees)


def shard_bounds(n: int, n_shards: int) -> list[tuple[int, int]]:
    """Balanced contiguous row partition of an n-row corpus into
    ``n_shards`` blocks (the mesh ``data``-axis layout): sizes differ by at
    most 1 (the first n % S shards carry the extra row), so no shard is
    ever empty and ceil(n/S) remains the maximum — the common padded row
    count the sharded index build uses. A fixed-stride ceil(n/S) split
    would leave trailing shards empty whenever (S-1)*ceil(n/S) >= n."""
    if not 1 <= n_shards <= n:
        raise ValueError(f"need 1 <= n_shards <= n, got {n_shards} for n={n}")
    q, r = divmod(n, n_shards)
    bounds, lo = [], 0
    for s in range(n_shards):
        hi = lo + q + (1 if s < r else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def build_shard_graphs(vectors: np.ndarray, n_shards: int, *, k: int = 32,
                       r_max: int = 128, alpha: float = 1.2,
                       block: int = 2048) -> tuple[list[Graph],
                                                   list[tuple[int, int]]]:
    """Shard-local Algorithm 1: one independent α-kNN graph per contiguous
    row block, built over that shard's vectors only (edges never cross
    shards, so adjacency stays shard-local int32 and the per-shard walk
    needs no remote gathers). Returns (graphs, bounds); neighbor ids are
    LOCAL to each shard — ``bounds[s][0] + local`` recovers the global id."""
    bounds = shard_bounds(vectors.shape[0], n_shards)
    graphs = []
    for lo, hi in bounds:
        n_s = hi - lo
        graphs.append(build_alpha_knn(vectors[lo:hi], k=min(k, n_s - 1),
                                      r_max=r_max, alpha=alpha, block=block))
    return graphs, bounds


def assign_shards_balanced(fill: np.ndarray, cap: int,
                           n_new: int) -> np.ndarray:
    """Balance-aware shard assignment for ``n_new`` appended rows: each row
    goes to the least-filled shard with free capacity (ties break on the
    lowest shard id, so placement is deterministic). This extends the
    ``shard_bounds`` balance invariant — valid-row counts differ by at most
    1 across shards whenever capacity allows — to a corpus that grows after
    the build. Returns (n_new,) int32 shard ids; raises when the mesh is
    out of capacity."""
    fill = np.asarray(fill, np.int64).copy()
    free = int((cap - fill).sum())
    if free < n_new:
        raise ValueError(
            f"insert of {n_new} rows exceeds free capacity {free} "
            f"(per-shard cap {cap}); rebuild with a larger capacity")
    out = np.empty(n_new, np.int32)
    for i in range(n_new):
        open_s = np.nonzero(fill < cap)[0]
        s = open_s[np.argmin(fill[open_s])]
        out[i] = s
        fill[s] += 1
    return out


def _request_reverse(adjacency: np.ndarray, vectors: np.ndarray, x: int,
                     y: int, alpha: float) -> tuple[int, int]:
    """Ask row ``y`` to carry the reverse edge (y -> x): appended into a
    free slot when one exists, else y's neighbourhood is re-selected by
    the build's α-RNG rule over {neighbours of y} ∪ {x}. Returns
    (edges_added, repairs) — the accounting both the append path and the
    compaction relink share."""
    r_width = adjacency.shape[1]
    row = adjacency[y]
    deg = int((row >= 0).sum())
    if x in row[:deg]:
        return 0, 0
    if deg < r_width:
        row[deg] = x
        return 1, 0
    cand = np.concatenate([row[:deg], [x]]).astype(np.int32)
    kept = _alpha_rng_prune(int(y), cand, vectors, r_width, alpha)
    row[: kept.size] = kept
    row[kept.size:] = -1
    return int(np.isin(x, kept)), 1


def relink_rows(adjacency: np.ndarray, vectors: np.ndarray,
                rows: np.ndarray, n_total: int, *, k: int = 32,
                alpha: float = 1.2) -> dict:
    """Rebuild the neighbourhoods of specific ``rows`` in place — the
    compaction repair rule (DESIGN.md §12). Compacting a slab drops every
    edge that pointed at a recycled slot; rows left under-connected get
    fresh forward kNN edges over the surviving rows [0, n_total) (existing
    edges are kept and deduplicated, the union α-RNG-pruned when it
    overflows the row width), and each new forward edge requests its
    reverse via the same rule the append path uses. Returns
    {"relinked", "edges_added", "repairs"}."""
    r_width = adjacency.shape[1]
    rows = np.asarray(rows, np.int64)
    if rows.size == 0 or n_total <= 1:
        return {"relinked": 0, "edges_added": 0, "repairs": 0}
    sims_all = vectors[rows] @ vectors[:n_total].T
    edges_added = repairs = 0
    for i, x in enumerate(rows):
        sims = sims_all[i]
        sims[x] = -np.inf                       # no self edge
        kk = min(k, r_width, n_total - 1)
        part = np.argpartition(-sims, kk - 1)[:kk]
        cand = part[np.argsort(-sims[part])].astype(np.int32)
        row = adjacency[x]
        deg = int((row >= 0).sum())
        merged = np.concatenate([row[:deg], cand])
        _, first = np.unique(merged, return_index=True)
        merged = merged[np.sort(first)]         # stable: old edges first
        if merged.size > r_width:
            merged = _alpha_rng_prune(int(x), merged, vectors, r_width,
                                      alpha)
        added = merged.size - deg
        adjacency[x, : merged.size] = merged
        adjacency[x, merged.size:] = -1
        edges_added += max(added, 0)
        for y in cand:
            ea, rp = _request_reverse(adjacency, vectors, int(x), int(y),
                                      alpha)
            edges_added += ea
            repairs += rp
    return {"relinked": int(rows.size), "edges_added": edges_added,
            "repairs": repairs}


def patch_adjacency(adjacency: np.ndarray, vectors: np.ndarray,
                    n_before: int, n_after: int, *, k: int = 32,
                    alpha: float = 1.2) -> dict:
    """Reverse-edge repair (DESIGN.md §9): splice appended rows
    [n_before, n_after) into an existing padded adjacency, in place.

    Each new row x gets forward edges to its k nearest prior rows (prior =
    built rows plus earlier rows of this batch, so intra-batch edges form);
    every forward edge (x -> y) then requests the reverse edge (y -> x):
    appended into a free slot when y has one, otherwise y's neighbourhood
    is re-selected by the SAME α-RNG rule the build uses to cap over-degree
    hubs — over {current neighbours of y} ∪ {x}, width-capped at the padded
    row width R — so repeated inserts keep the directional-diversity
    invariant instead of silently dropping reverse edges or growing R.

    ``adjacency`` is (m, R) int32 with -1 padding and rows [n_before, m)
    all -1; ``vectors`` is the (m, d) capacity slab with rows < n_after
    written. Returns {"edges_added", "repairs"} for accounting."""
    r_width = adjacency.shape[1]
    new_ids = np.arange(n_before, n_after)
    if new_ids.size == 0:
        return {"edges_added": 0, "repairs": 0}
    sims_all = vectors[new_ids] @ vectors[:n_after].T
    edges_added = repairs = 0
    for i, x in enumerate(new_ids):
        sims = sims_all[i, :x]                    # prior rows only, no self
        kk = min(k, r_width, sims.size)
        if kk == 0:
            continue
        part = np.argpartition(-sims, kk - 1)[:kk]
        nbrs = part[np.argsort(-sims[part])].astype(np.int32)
        adjacency[x, : nbrs.size] = nbrs
        adjacency[x, nbrs.size:] = -1
        edges_added += nbrs.size
        for y in nbrs:
            ea, rp = _request_reverse(adjacency, vectors, int(x), int(y),
                                      alpha)
            edges_added += ea
            repairs += rp
    return {"edges_added": edges_added, "repairs": repairs}


def graph_stats(g: Graph) -> dict:
    return {
        "total_edges": g.n_edges,
        "mean_degree": float(g.degrees.mean()),
        "min_degree": int(g.degrees.min()),
        "max_degree": int(g.degrees.max()),
        "memory_mb": g.memory_bytes() / 2**20,
    }
