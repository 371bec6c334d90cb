"""Batched drift-guided search on one device (beyond-paper engine).

Runs Q queries in lockstep: all walk state is fixed-shape (packed int32
visited/in-results/pass bitmaps, V-sorted fixed-capacity frontier/beam
queues, running top-k results), one iteration expands one node per active
query, and every expansion distance comes from ``fiber_expand_walk`` (the
CUDA kernel on the card, its plain version on the CPU), which applies the
packed pass bitmap in the same pass.

A filtered search batch (``search_batch``) runs predicate evaluation
(``filter_eval_batch``), then the restart rounds (``atlas_round``: batched
anchor selection from the ``DeviceAtlas`` + the lockstep walk). The two
``lax.while_loop``s of the reference become Python loops whose exit
conditions are read on the host: once per round, and once every
``HOP_CHECK_EVERY`` walk hops. A hop run after every lane has finished
changes no output (finished lanes are fully masked), so the checks
change only how much work is done, never the result; ``stats["syncs"]``
counts them.

Vectorization deltas vs the sequential reference (DESIGN.md §3):
* queues hold only first-seen nodes (a node enters exactly one queue once);
* the phase-1 -> 2 fallback seeds the beam from (frontier ∪ this
  expansion's neighbours) rather than "all seen unexpanded nodes";
* converged queries idle (masked) until the batch drains.

Every ``top_k``/merge is a stable sort, so ties (queues are full of
INF/-1) resolve to the lower index exactly as ``lax.top_k`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.batched.bitmap import (n_words, popcount, set_bits,
                                             test_bits, unpack_bits)
from repro_torch.core.config import WalkConfig, coerce_config
from repro_torch.core.device_atlas import (DeviceAtlas, pack_dnf,
                                           pack_predicates, resolve_device,
                                           table_n_disj, words_to_torch)
from repro_torch.core.predicate import DNF, as_dnf, disjunct_selectivity
from repro_torch.core.search import FiberIndex
from repro_torch.core.types import FilterPredicate, Query
from repro_torch.kernels import ops
from repro_torch.kernels.ops import MAX_CLAUSES
from repro_torch.kernels.ref import top_k

INF = 3.4e38  # float32(3.4e38) once it lands in a float32 tensor

TERM_RUNNING, TERM_CONVERGED, TERM_EARLY, TERM_STALL, TERM_MAXHOP = 0, 1, 2, 3, 4

# walk hops between host reads of "is any lane still running"
HOP_CHECK_EVERY = 8

# the walk-budget section of the unified config tree (core/config.py) IS
# the engine's parameter object
BatchedParams = WalkConfig


def _merge_queue(q_v, q_i, new_v, new_i, cap: int):
    """Merge sorted queue (Q,cap) with candidates (Q,m); keep cap smallest
    (ties: queue entries first, then candidates in index order)."""
    v = torch.cat([q_v, new_v], dim=1)
    i = torch.cat([q_i, new_i.to(q_i.dtype)], dim=1)
    sv, sel = torch.sort(v, dim=1, stable=True)
    return sv[:, :cap], i.gather(1, sel[:, :cap])


def _pop(q_v, q_i):
    x_v, x_i = q_v[:, 0], q_i[:, 0]
    q_v = torch.cat([q_v[:, 1:], torch.full_like(q_v[:, :1], INF)], dim=1)
    q_i = torch.cat([q_i[:, 1:], torch.full_like(q_i[:, :1], -1)], dim=1)
    return x_v, x_i, q_v, q_i


def _eval_passes(metadata, fields, allowed, bounds=None):
    """Batched predicate evaluation -> packed (Q, ceil(n/32)) int32 pass
    bitmaps through ``filter_eval_batch``. Disjunctive (Q, D, C) tables
    carry their live-disjunct counts in the dead-disjunct sentinel;
    ``bounds`` (Q, D, C, 2) marks interval clauses (None = pure value-set
    batch)."""
    n_disj = table_n_disj(fields) if fields.ndim == 3 else None
    return ops.filter_eval_batch(metadata, fields, allowed, n_disj, bounds)


def walk_batch(vectors, adjacency, pass_bm, q_vecs, seeds,
               p: BatchedParams, init_results=None):
    """One lockstep walk round.

    vectors (n, d) f32; adjacency (n, R) i32 (-1 pad); pass_bm
    (Q, ceil(n/32)) int32 packed filter bitmaps; q_vecs (Q, d); seeds
    (Q, S) i32 (-1 pad). Returns dict of results + diagnostics, plus
    ``syncs``, the host reads of the loop condition. All per-point walk
    state (visited / in-results / pass) is bitmap-packed.
    """
    n = vectors.shape[0]
    Q = q_vecs.shape[0]
    R = adjacency.shape[1]
    dev = q_vecs.device
    k, B, F = p.k, p.beam_width, p.frontier_cap
    i32 = torch.int32

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    seeds = seeds.to(i32)
    safe_seeds = seeds.clamp(min=0).long()
    seed_valid = seeds >= 0
    seed_sims = torch.einsum("qsd,qd->qs", vectors[safe_seeds], q_vecs)
    seed_v = torch.where(seed_valid, 1.0 - seed_sims, INF)

    zero_bm = full((Q, n_words(n)), 0, i32)
    visited = set_bits(zero_bm, seeds, seed_valid)
    frontier_v, frontier_i = _merge_queue(
        full((Q, F), INF), full((Q, F), -1, i32), seed_v, seeds, F)
    beam_v = full((Q, B), INF)
    beam_i = full((Q, B), -1, i32)

    # cross-round dedup: a node carried in init_results must not re-enter
    # the result queue when a later restart re-reaches it (its value is a
    # pure function of (q, node), so dropping the re-merge is exactly the
    # sequential engine's dict dedup). Traversal is unaffected.
    if init_results is None:
        res0_v = full((Q, k), INF)
        res0_i = full((Q, k), -1, i32)
        in_res = zero_bm
    else:
        res0_v, res0_i = init_results
        in_res = set_bits(zero_bm, res0_i, res0_i >= 0)

    seed_pass = test_bits(pass_bm, seeds) & ~test_bits(in_res, seeds)
    res_v, res_i = _merge_queue(res0_v, res0_i,
                                torch.where(seed_pass, seed_v, INF), seeds, k)

    phase = full((Q,), 1, i32)
    stall = full((Q,), 0, i32)
    term = full((Q,), TERM_RUNNING, i32)
    hops = full((Q,), 0, i32)
    p1_hops = full((Q,), 0, i32)
    kf = min(p.frontier_width, R)
    syncs = 0

    for t in range(p.max_hops):
        if t % HOP_CHECK_EVERY == 0:
            syncs += 1
            if not bool((term == TERM_RUNNING).any()):
                break
        active = term == TERM_RUNNING
        f_empty = frontier_v[:, 0] >= INF / 2
        b_empty = beam_v[:, 0] >= INF / 2
        # phase-1 queries with drained frontier fall to phase 2 now
        phase = torch.where((phase == 1) & f_empty, 2, phase)
        use_frontier = phase == 1
        uf = use_frontier[:, None]
        # pop one node per query
        fv, fi, nf_v, nf_i = _pop(frontier_v, frontier_i)
        bv, bi, nb_v, nb_i = _pop(beam_v, beam_i)
        x_v = torch.where(use_frontier, fv, bv)
        x = torch.where(use_frontier, fi, bi)
        frontier_v = torch.where(uf, nf_v, frontier_v)
        frontier_i = torch.where(uf, nf_i, frontier_i)
        beam_v = torch.where(uf, beam_v, nb_v)
        beam_i = torch.where(uf, beam_i, nb_i)
        # termination checks (phase-2 semantics, Alg. 4 lines 14-22)
        v_k = res_v[:, k - 1]
        nothing = use_frontier & f_empty & b_empty | ~use_frontier & b_empty
        early = ~use_frontier & (x_v > v_k) & (v_k < INF / 2)
        stallout = ~use_frontier & (stall >= p.stall_budget)
        term = torch.where(active & nothing, TERM_CONVERGED, term)
        term = torch.where(active & ~nothing & early, TERM_EARLY, term)
        term = torch.where(active & ~nothing & ~early & stallout, TERM_STALL,
                           term)
        live = term == TERM_RUNNING
        # ---- expand x (masked for dead queries) ----
        xs = x.clamp(min=0).long()
        nbrs = adjacency[xs]                                    # (Q, R)
        nvalid = (nbrs >= 0) & live[:, None]
        seen = test_bits(visited, nbrs)
        new = nvalid & ~seen
        visited = set_bits(visited, nbrs, new)
        # one gather+dot yields both traversal distances and pass-masked
        # candidates (the kernel probes the pass bitmap in the same pass)
        sims, sims_p = ops.fiber_expand_walk(q_vecs, vectors, nbrs, pass_bm)
        v_n = 1.0 - sims
        pass_r = torch.isfinite(sims_p) & live[:, None]
        # results: merge new filtered, minus nodes a prior round already
        # banked (in_res is static within the round: nodes merged this
        # round are first-seen, so `new` already excludes them)
        in_res_r = test_bits(in_res, nbrs)
        cand_v = torch.where(new & pass_r & ~in_res_r, v_n, INF)
        res_v, res_i = _merge_queue(res_v, res_i, cand_v, nbrs, k)
        # local signals
        n_pass = pass_r.sum(1)
        vx = 1.0 - torch.einsum("qd,qd->q", vectors[xs], q_vecs)
        drift = torch.where(
            n_pass > 0,
            torch.where(pass_r, v_n, 0.0).sum(1) / n_pass.clamp(min=1) - vx,
            float("inf"))
        new_filtered = (new & pass_r).sum(1)
        stall = torch.where(new_filtered > 0, 0, stall + 1).to(i32)
        neg = drift < 0
        # ---- phase logic ----
        # phase 1, drift<0: push top-K_f filtered descending new neighbours
        push1 = torch.where(
            (live & (phase == 1) & neg)[:, None] & new & pass_r
            & (v_n < vx[:, None]), v_n, INF)
        pv, sel = top_k(-push1, kf)
        push1_v, push1_i = -pv, nbrs.gather(1, sel)
        frontier_v, frontier_i = _merge_queue(frontier_v, frontier_i,
                                              push1_v, push1_i, F)
        # phase 1, drift>=0: fall to 2; beam <- frontier ∪ new neighbours
        to2 = live & (phase == 1) & ~neg
        t2 = to2[:, None]
        cand2_v = torch.cat([torch.where(t2, frontier_v, INF),
                             torch.where(t2 & new, v_n, INF)], dim=1)
        cand2_i = torch.cat([frontier_i, nbrs], dim=1)
        merged_bv, merged_bi = _merge_queue(beam_v, beam_i, cand2_v, cand2_i,
                                            B)
        beam_v = torch.where(t2, merged_bv, beam_v)
        beam_i = torch.where(t2, merged_bi, beam_i)
        frontier_v = torch.where(t2, INF, frontier_v)
        frontier_i = torch.where(t2, -1, frontier_i)
        # phase 2: beam-merge unseen; maybe re-enter phase 1
        in2 = live & (phase == 2)
        b2_v = torch.where(in2[:, None] & new, v_n, INF)
        beam_v, beam_i = _merge_queue(beam_v, beam_i, b2_v, nbrs, B)
        reenter = in2 & neg & (new_filtered > 0)
        re_v = torch.where(reenter[:, None] & new & pass_r, v_n, INF)
        rv, rsel = top_k(-re_v, kf)
        re_ids = nbrs.gather(1, rsel)
        has_cand = (-rv[:, 0]) < INF / 2
        reenter = reenter & has_cand
        re_fv, re_fi = _merge_queue(torch.full_like(frontier_v, INF),
                                    torch.full_like(frontier_i, -1),
                                    -rv, re_ids, F)
        re = reenter[:, None]
        frontier_v = torch.where(re, re_fv, frontier_v)
        frontier_i = torch.where(re, re_fi, frontier_i)
        beam_v = torch.where(re, INF, beam_v)
        beam_i = torch.where(re, -1, beam_i)
        new_phase = torch.where(to2, 2, phase)
        phase = torch.where(reenter, 1, new_phase).to(i32)
        hops = hops + live.to(i32)
        p1_hops = p1_hops + (live & use_frontier).to(i32)

    term = torch.where(term == TERM_RUNNING, TERM_MAXHOP, term)
    return dict(res_v=res_v, res_i=res_i, term=term, hops=hops,
                p1_hops=p1_hops, visited_bm=visited, syncs=syncs)


def atlas_round(datlas: DeviceAtlas, vectors, adjacency, pass_bm, passes,
                q_vecs, fields, allowed, processed, need, res_v, res_i,
                p: BatchedParams, seed_backend: str, bounds=None):
    """One full restart round for all Q queries: batched anchor selection
    from the packed atlas, then the lockstep walk. ``pass_bm`` is the
    packed (Q, ceil(n/32)) int32 filter bitmap the walk carries;
    ``passes`` is its dense (Q, n) bool unpack for the selection math.
    Queries with ``need`` false see an all-processed atlas and so get no
    seeds; a query with no seeds converges on its first walk iteration
    with its results untouched."""
    gate = processed | ~need[:, None]
    tables = ((fields, allowed) if bounds is None
              else (fields, allowed, bounds))
    seeds, used = datlas.select_anchors_batch(
        q_vecs, tables, gate, vectors, passes,
        n_seeds=p.n_seeds, c_max=p.c_max, backend=seed_backend,
        disjunct_quota=p.disjunct_quota)
    out = walk_batch(vectors, adjacency, pass_bm, q_vecs, seeds, p,
                     init_results=(res_v, res_i))
    found = (out["res_v"] < INF / 2).sum(dim=1)
    return dict(res_v=out["res_v"], res_i=out["res_i"],
                processed=processed | used, need=need & (found < p.k),
                seeded=seeds[:, 0] >= 0, hops=out["hops"],
                syncs=out["syncs"])


def search_batch(datlas: DeviceAtlas, vectors, adjacency, metadata, q_vecs,
                 fields, allowed, p: BatchedParams, seed_backend: str,
                 bounds=None):
    """A whole filtered search batch: predicate evaluation, then up to
    ``jump_budget + 1`` restart rounds (each round = ``atlas_round``). A
    round where nobody seeded is discarded wholesale (it cannot change
    results) and ends the loop, as does a round after which no query is
    short of k; both are read on the host in one sync per round."""
    Q = q_vecs.shape[0]
    dev = q_vecs.device
    pass_bm = _eval_passes(metadata, fields, allowed, bounds)
    # the dense unpack feeds only selection math and is round-invariant
    passes = unpack_bits(pass_bm, vectors.shape[0])
    processed = torch.zeros((Q, datlas.n_clusters), dtype=torch.bool,
                            device=dev)
    # a query with zero passing points can never seed or gain results:
    # starting it need-False keeps inert lanes (e.g. serve-bucket pads)
    # from holding the loop open one extra no-op round
    need = popcount(pass_bm) > 0
    res_v = torch.full((Q, p.k), INF, dtype=torch.float32, device=dev)
    res_i = torch.full((Q, p.k), -1, dtype=torch.int32, device=dev)
    hops = torch.zeros(Q, dtype=torch.int64, device=dev)
    walks = torch.zeros(Q, dtype=torch.int64, device=dev)
    syncs = 0
    for _ in range(p.jump_budget + 1):
        out = atlas_round(datlas, vectors, adjacency, pass_bm, passes,
                          q_vecs, fields, allowed, processed, need,
                          res_v, res_i, p=p, seed_backend=seed_backend,
                          bounds=bounds)
        syncs += out["syncs"] + 1
        any_seeded, any_need = torch.stack(
            [out["seeded"].any(), out["need"].any()]).tolist()
        if not any_seeded:
            break
        res_v, res_i = out["res_v"], out["res_i"]
        processed, need = out["processed"], out["need"]
        hops = hops + out["hops"]
        walks = walks + out["seeded"].to(torch.int64)
        if not any_need:
            break
    return dict(res_v=res_v, res_i=res_i, hops=hops, walks=walks,
                syncs=syncs)


def clause_dim(n_clauses: int) -> int:
    """Clause-table width for a batch whose widest predicate has
    ``n_clauses`` clauses: at least MAX_CLAUSES, then the next power of
    two (so batches share table shapes)."""
    if n_clauses <= MAX_CLAUSES:
        return MAX_CLAUSES
    return 1 << (n_clauses - 1).bit_length()


def disjunct_dim(n_disjuncts: int) -> int:
    """Disjunct-table depth for a batch whose widest predicate has
    ``n_disjuncts`` disjuncts: 1 keeps the conjunctive (Q, C) table, any
    disjunction buckets to the next power of two ≥ 2."""
    if n_disjuncts <= 1:
        return 1
    return 1 << (n_disjuncts - 1).bit_length()


def _compile_query_dnf(pred, vocab_sizes, v_cap: int):
    """Per-query predicate normalization for the batch pack: conjunctive
    FilterPredicates whose every value fits the bitmap pass through
    verbatim; everything else — expressions, precompiled DNFs, and
    FilterPredicates carrying codes beyond ``v_cap`` — compiles v_cap-aware
    so oversized values lower to interval clauses instead of unpackable
    bitmap bits."""
    if isinstance(pred, FilterPredicate):
        if all(v < v_cap for _, vals in pred.clauses for v in vals):
            return pred
        pred = pred.expr()
    return as_dnf(pred, vocab_sizes, v_cap=v_cap)


def pack_query_batch(queries: list[Query], *, v_cap: int,
                     vocab_sizes=None, device=None):
    """Host-side query pack: (Q, d) vector stack + clause tables with the
    clause dimension bucketed by ``clause_dim``, as tensors on ``device``
    (None means CUDA).

    When every predicate lowers to ≤ 1 disjunct of pure value-sets the
    tables keep the conjunctive (Q, C) shape, otherwise they widen to
    (Q, D, C) with D bucketed by ``disjunct_dim``. Returns
    (q_vecs, fields, allowed, bounds): ``bounds`` is the (Q, D, C, 2)
    interval table when any clause is an interval (its disjuncts packed
    rarest-first), else None — the invariant is
    ``bounds is not None ⟹ fields.ndim == 3``. Value bitmaps are int32
    words."""
    device = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    q_vecs = t(np.stack([q.vector for q in queries]).astype(np.float32))
    dnfs = [_compile_query_dnf(q.predicate, vocab_sizes, v_cap)
            for q in queries]
    d_max = max((1 if isinstance(p, FilterPredicate) else p.n_disjuncts
                 for p in dnfs), default=0)
    has_iv = any(isinstance(p, DNF) and p.has_intervals for p in dnfs)
    if d_max <= 1 and not has_iv:
        preds = [p if isinstance(p, FilterPredicate) else p.to_predicate()
                 for p in dnfs]
        n_cl = max((p.n_clauses for p in preds), default=0)
        f_np, a_np = pack_predicates(preds, max_clauses=clause_dim(n_cl),
                                     v_cap=v_cap)
        return q_vecs, t(f_np), words_to_torch(a_np, device), None
    dnfs = [as_dnf(p) for p in dnfs]
    if has_iv:
        # rare disjuncts first (union semantics are order-independent;
        # quota repair is per-disjunct and follows the same order on
        # every path)
        dnfs = [DNF(tuple(sorted(
            d.disjuncts,
            key=lambda c: disjunct_selectivity(c, vocab_sizes))))
            for d in dnfs]
    n_cl = max((p.max_clauses for p in dnfs), default=0)
    f_np, a_np, b_np, _ = pack_dnf(dnfs, max_disjuncts=disjunct_dim(d_max),
                                   max_clauses=clause_dim(n_cl), v_cap=v_cap)
    bounds = t(b_np) if has_iv else None
    return q_vecs, t(f_np), words_to_torch(a_np, device), bounds


class BatchedEngine:
    """Batched filtered search over an index resident on one device.

    ``device`` None means CUDA, and constructing the engine raises where
    there is no CUDA device; ``device="cpu"`` runs the plain PyTorch
    versions of the kernels on the host. Every knob arrives through one
    ``FnsConfig`` (``config=``, stored as ``self.cfg``). This engine is
    the fixed-size (build-once) form: ``serve.capacity`` must be None.
    """

    def __init__(self, index: FiberIndex, config=None, device=None,
                 vocab_sizes=None):
        self.device = resolve_device(device)
        cfg = coerce_config(config, {}, where="BatchedEngine")
        if cfg.serve.capacity is not None:
            raise NotImplementedError(
                "the capacity-slab (insert/delete) engine is not ported; "
                "build with serve.capacity=None")
        self.cfg = cfg
        self.index = index
        self.p = cfg.walk
        dev = self.device
        self.datlas = DeviceAtlas.from_atlas(index.atlas, v_cap=cfg.atlas.v_cap,
                                             device=dev)
        self.vectors = torch.from_numpy(
            np.ascontiguousarray(index.vectors, np.float32)).to(dev)
        self.adjacency = torch.from_numpy(
            np.ascontiguousarray(index.graph.neighbors, np.int32)).to(dev)
        self.metadata = torch.from_numpy(
            np.ascontiguousarray(index.metadata, np.int32)).to(dev)
        # per-field domains for Not/Range lowering in FilterExpr queries;
        # derived from observed codes when the dataset's declaration isn't
        # handed in (identical masks for any domain covering the corpus)
        self.vocab_sizes = (tuple(int(v) for v in vocab_sizes)
                            if vocab_sizes is not None
                            else index.vocab_sizes())

    def _pack_queries(self, queries: list[Query]):
        return pack_query_batch(queries, v_cap=self.datlas.v_cap,
                                vocab_sizes=self.vocab_sizes,
                                device=self.device)

    def search(self, queries: list[Query]):
        """Filtered top-k for a batch. Returns (ids per query as numpy
        arrays, stats) with per-query ``walks``/``hops`` and ``syncs``, the
        host reads of loop conditions the batch took. The search is
        deterministic (seeds are nearest matching members, never random
        samples)."""
        q_vecs, fields, allowed, bounds = self._pack_queries(queries)
        out = search_batch(self.datlas, self.vectors, self.adjacency,
                           self.metadata, q_vecs, fields, allowed, self.p,
                           self.cfg.serve.seed_backend, bounds=bounds)
        res_v = out["res_v"].cpu().numpy()
        res_i = out["res_i"].cpu().numpy()
        ids = [res_i[i][res_v[i] < INF / 2] for i in range(len(queries))]
        stats = {"walks": out["walks"].cpu().numpy().astype(np.int32),
                 "hops": out["hops"].cpu().numpy().astype(np.int64),
                 "syncs": out["syncs"] + 1}
        return ids, stats
