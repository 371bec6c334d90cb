"""Batched drift-guided search on one device (beyond-paper engine).

Runs Q queries in lockstep: all walk state is fixed-shape (packed int32
visited/in-results/pass bitmaps, V-sorted fixed-capacity frontier/beam
queues, running top-k results), one iteration expands one node per active
query, and every expansion distance comes from ``fiber_expand_walk`` (the
CUDA kernel on the card, its plain version on the CPU), which applies the
packed pass bitmap in the same pass.

A filtered search batch (``search_batch``) runs predicate evaluation
(``filter_eval_batch``, ANDed with the live-row bitmap on a capacity
slab), then the restart rounds (``atlas_round``: batched anchor selection
from the ``DeviceAtlas`` + one walk round, ``ops.walk_round``). As in the
reference's one fused program, nothing is read on the host inside the
batch: every round runs, its effect masked on the device when nobody
seeded, and on the card ``walk_round`` is one kernel launch that walks
each lane to its own end. ``dispatch`` therefore returns while the device
is still busy, and ``collect``'s copy of the results is the batch's one
host sync. On the CPU a round's walk is its plain version, ``walk_batch``
(the lockstep loop), which reads "is any lane running" on the host every
``HOP_CHECK_EVERY`` hops; ``stats["syncs"]`` counts those reads.

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

from repro_torch import faults
from repro_torch.core.batched.bitmap import (n_words, pack_bits, popcount,
                                             set_bits, test_bits, unpack_bits)
from repro_torch.core.config import (FnsConfig, WalkConfig,
                                     check_state_config, coerce_config)
from repro_torch.core.device_atlas import (DeviceAtlas, auto_v_cap,
                                           pack_dnf, pack_predicates,
                                           resolve_device, table_n_disj)
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
    """One lockstep walk round: the plain version of the ``walk_round``
    kernel (``ops.walk_round``).

    vectors (n, d) f32; adjacency (n, R) i32 (-1 pad); pass_bm
    (Q, ceil(n/32)) int32 packed filter bitmaps; q_vecs (Q, d); seeds
    (Q, S) i32 (-1 pad). Returns dict of results + diagnostics, plus
    ``syncs``, the host reads of the loop condition, and what the
    kernel's bound counts: ``dotted``, per lane the neighbour rows some
    output depends on (valid, and new or passing), summed over hops (the
    row dots; a lane's distinct such rows, with its seeds, are its
    ``visited_bm``), and ``expanded``, an (n,) bool of the nodes whose
    adjacency row some lane read. All per-point walk state (visited /
    in-results / pass) is bitmap-packed. Lanes never exchange data: a lane's outputs are
    those it gets walked alone, and stop changing once it terminates (a
    finished lane is fully masked), so the host reads change only how
    much work is done.
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
    dotted = full((Q,), 0, i32)
    expanded = full((n,), 0, i32)
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
        expanded.index_add_(0, xs, live.to(i32))
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
        dotted = dotted + (new | pass_r).sum(1).to(i32)
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
                p1_hops=p1_hops, visited_bm=visited, dotted=dotted,
                expanded=expanded > 0, syncs=syncs)


def atlas_round(datlas: DeviceAtlas, vectors, adjacency, pass_bm, passes,
                q_vecs, fields, allowed, processed, need, res_v, res_i,
                p: BatchedParams, seed_backend: str, bounds=None):
    """One full restart round for all Q queries: batched anchor selection
    from the packed atlas, then one walk round (``ops.walk_round``).
    ``pass_bm`` is the packed (Q, ceil(n/32)) int32 filter bitmap the walk
    carries; ``passes`` is its dense (Q, n) bool unpack for the selection
    math. Queries with ``need`` false see an all-processed atlas and so get
    no seeds; a query with no seeds converges on its first walk iteration
    with its results untouched."""
    gate = processed | ~need[:, None]
    tables = ((fields, allowed) if bounds is None
              else (fields, allowed, bounds))
    seeds, used = datlas.select_anchors_batch(
        q_vecs, tables, gate, vectors, passes,
        n_seeds=p.n_seeds, c_max=p.c_max, backend=seed_backend,
        disjunct_quota=p.disjunct_quota)
    out = ops.walk_round(vectors, adjacency, pass_bm, q_vecs,
                         seeds.contiguous(), res_v, res_i, p)
    found = (out["res_v"] < INF / 2).sum(dim=1)
    return dict(res_v=out["res_v"], res_i=out["res_i"],
                processed=processed | used, need=need & (found < p.k),
                seeded=seeds[:, 0] >= 0, hops=out["hops"],
                syncs=out["syncs"])


def search_batch(datlas: DeviceAtlas, vectors, adjacency, metadata, q_vecs,
                 fields, allowed, p: BatchedParams, seed_backend: str,
                 valid_bm=None, bounds=None):
    """A whole filtered search batch, the reference's fused program:
    predicate evaluation, then all ``jump_budget + 1`` restart rounds (each
    round = ``atlas_round``) with no host read between them. A round where
    nobody seeded is discarded on the device (``torch.where`` on a device
    scalar: it cannot change results, and every later round then finds the
    same state and seeds nobody either); a lane no longer short of k gets
    no seeds, so its walks leave it untouched. ``rounds`` in the result is
    a device scalar: the rounds the reference's loop runs (it stops after
    a round where nobody seeded or nobody is short of k). ``syncs`` counts
    the host reads of the rounds' walks: 0 with the kernel.

    ``valid_bm`` (optional, (ceil(n/32),) int32) marks live rows: rows
    with a 0 bit fail every predicate. A capacity slab uses it to keep its
    unwritten tail and its tombstones out of every pass set — including
    the unconstrained predicate, which an empty clause table would
    otherwise let through."""
    Q = q_vecs.shape[0]
    dev = q_vecs.device
    pass_bm = _eval_passes(metadata, fields, allowed, bounds)
    if valid_bm is not None:
        pass_bm = pass_bm & valid_bm[None, :]
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
    go = torch.ones((), dtype=torch.bool, device=dev)
    rounds = torch.zeros((), dtype=torch.int32, device=dev)
    syncs = 0
    for _ in range(p.jump_budget + 1):
        out = atlas_round(datlas, vectors, adjacency, pass_bm, passes,
                          q_vecs, fields, allowed, processed, need,
                          res_v, res_i, p=p, seed_backend=seed_backend,
                          bounds=bounds)
        syncs += out["syncs"]
        seeded = out["seeded"]
        any_seeded = seeded.any()
        res_v = torch.where(any_seeded, out["res_v"], res_v)
        res_i = torch.where(any_seeded, out["res_i"], res_i)
        processed = torch.where(any_seeded, out["processed"], processed)
        need = torch.where(any_seeded, out["need"], need)
        hops = hops + torch.where(any_seeded, out["hops"], 0)
        walks = walks + (seeded & any_seeded)
        rounds = rounds + go.to(torch.int32)
        go = go & any_seeded & need.any()
    return dict(res_v=res_v, res_i=res_i, hops=hops, walks=walks,
                syncs=syncs, rounds=rounds)


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
    words.

    On CUDA each array is staged through pinned host memory and copied
    with ``non_blocking=True``: a blocking copy from pageable memory would
    wait for everything already queued on the stream (the batch before
    this one), so nothing could overlap. PyTorch's pinned-memory allocator
    holds each staging buffer until its copy has run on the stream, even
    once the tensor here is dropped."""
    device = resolve_device(device)

    def t(x):
        host = torch.from_numpy(np.ascontiguousarray(x))
        if device.type != "cuda":
            return host.to(device)
        return host.pin_memory().to(device, non_blocking=True)

    def words(x):  # numpy uint32 words -> int32 words with the same bits
        return t(np.asarray(x, np.uint32).view(np.int32))

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
        return q_vecs, t(f_np), words(a_np), None
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
    return q_vecs, t(f_np), words(a_np), bounds


def _fence_pack(eng, queries: list[Query]):
    """Publish-generation fence (DESIGN.md §13).

    Pack the batch, then check the engine's ``publish_generation`` — the
    counter every device publish (ingest refresh, tombstone, maintenance
    swap) bumps. If a publish landed between the pack and here, the packed
    tables may bake stale vocab domains and the tensors the caller is
    about to bind may be mid-swap: re-pack against the new state and try
    again. ``faults.fire("serve.pre-dispatch")`` sits in the window so
    tests can script the interleaving. Returns ``(packed, generation)``
    with ``generation == eng.publish_generation`` at return time."""
    while True:
        gen = eng.publish_generation
        packed = eng._pack_queries(queries)
        faults.fire("serve.pre-dispatch")
        if eng.publish_generation == gen:
            return packed, gen
        eng.fence_retries += 1


def _to_gids(ids: list[np.ndarray], gids) -> list[np.ndarray]:
    """Map slab row indices to global ids (``gids`` None: a fixed-size
    engine, rows are ids). Identity until the first compaction moves rows
    (build + append assign gid == row)."""
    return ids if gids is None else [gids[i] for i in ids]


def fetch_results(out: dict, q_n: int):
    """A searched batch's results on the host, by one device-to-host copy
    (results, walks, hops and restart rounds packed into one int32
    tensor): the ids of each query's found rows (``res_v < INF / 2``) as
    numpy arrays, and stats with per-query ``walks``/``hops``, ``syncs``,
    the host reads the batch took, this copy included, and ``rounds``."""
    k = out["res_v"].shape[1]
    Q = out["res_v"].shape[0]
    host = torch.cat([out["res_v"].view(torch.int32), out["res_i"],
                      out["walks"].to(torch.int32)[:, None],
                      out["hops"].to(torch.int32)[:, None],
                      out["rounds"].to(torch.int32).expand(Q, 1)],
                     dim=1).cpu().numpy()
    res_v = np.ascontiguousarray(host[:, :k]).view(np.float32)
    res_i = host[:, k:2 * k]
    ids = [res_i[i][res_v[i] < INF / 2] for i in range(q_n)]
    stats = {"walks": host[:q_n, 2 * k].astype(np.int32),
             "hops": host[:q_n, 2 * k + 1].astype(np.int64),
             "syncs": out["syncs"] + 1,
             "rounds": int(host[0, 2 * k + 2]) if Q else 0}
    return ids, stats


def _place(x: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``device`` that shares no memory with
    it, even on the CPU (a slab's arrays keep changing under later
    inserts, and the search must see them only once they are published)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        device=device, dtype=dtype, copy=True)


class BatchedEngine:
    """Batched filtered search over an index resident on one device.

    ``device`` None means CUDA, and constructing the engine raises where
    there is no CUDA device; ``device="cpu"`` runs the plain PyTorch
    versions of the kernels on the host. Every knob arrives through one
    ``FnsConfig`` (``config=``, stored as ``self.cfg``); a bare
    ``WalkConfig`` or None takes this entry point's historical append-path
    default ``graph.graph_k=16``, as the reference does.

    ``serve.capacity`` (DESIGN.md §9) turns the device index into an
    append-able capacity slab: tensors are sized to ``capacity`` rows, a
    row-validity bitmap masks the unwritten tail and the tombstones out of
    every pass set, and ``insert_batch`` / ``delete_batch`` change the
    corpus in place (graph repair + incremental atlas update on a host
    mirror, ``core/batched/insert.py``, then a same-shape refresh of the
    device tensors; ``self.index`` keeps the build-time snapshot).
    ``graph.graph_k``/``graph.alpha`` are the append path's forward-edge
    count and α-RNG slack. ``serve/maintenance.py`` drains deferred work
    through ``refresh_device``.

    ``dispatches`` counts search calls where the reference counts its
    jitted calls: one per ``dispatch`` (so one per ``search`` batch), and
    in ``search_hostloop`` one for the predicate evaluation plus one per
    restart round. On the card a batch syncs once, as the reference's
    fused program does (``stats["syncs"]`` 1: ``collect``'s copy).

    A publish (``_refresh_from_slab``, ``delete_batch``) binds new tensors
    and never writes in place into one an in-flight batch reads: that
    batch keeps its own references, and the allocator reuses their memory
    only after the stream has run past it.
    """

    def __init__(self, index: FiberIndex, config=None, device=None,
                 vocab_sizes=None):
        from repro_torch.core.batched.insert import (InsertState,
                                                     make_shard_state)

        self.device = resolve_device(device)
        # this entry point's historical append-path default (graph_k=16)
        # predates the config tree's 32; applied unless a full FnsConfig
        # states otherwise
        cfg = coerce_config(config, {}, where="BatchedEngine",
                            defaults={"graph.graph_k": 16})
        self.cfg = cfg
        self.index = index
        self.p = cfg.walk
        self.publish_generation = 0
        self.fence_retries = 0
        self.dispatches = 0
        v_cap = cfg.atlas.v_cap
        capacity = cfg.serve.capacity
        n = index.vectors.shape[0]
        dev = self.device
        if capacity is None:
            self.datlas = DeviceAtlas.from_atlas(index.atlas, v_cap=v_cap,
                                                 device=dev)
            self.vectors = _place(index.vectors, dev, torch.float32)
            self.adjacency = _place(index.graph.neighbors, dev, torch.int32)
            self.metadata = _place(index.metadata, dev, torch.int32)
            self._state = None
            self._valid_bm = None
        else:
            if capacity < n:
                raise ValueError(f"capacity {capacity} < corpus size {n}")
            # widen the row width for the append path's 1.5x graph_k
            # forward edges
            graph_k = cfg.graph.graph_k
            adj = np.asarray(index.graph.neighbors, np.int32)
            w = max(adj.shape[1], graph_k + graph_k // 2)
            if w > adj.shape[1]:
                adj = np.concatenate(
                    [adj, np.full((n, w - adj.shape[1]), -1, np.int32)],
                    axis=1)
            slab = make_shard_state(
                np.asarray(index.vectors, np.float32),
                np.asarray(index.metadata, np.int32),
                np.arange(n, dtype=np.int32), adj,
                index.atlas, cap=capacity)
            if v_cap is None:
                # same auto-sizing rule as DeviceAtlas.from_atlas
                vmax = int(index.metadata.max()) if index.metadata.size \
                    else -1
                v_cap = auto_v_cap(vmax)
            self._state = InsertState(shards=[slab], v_cap=v_cap,
                                      graph_k=graph_k, alpha=cfg.graph.alpha,
                                      seed=0, next_gid=n)
            self._refresh_from_slab(v_cap)
        # per-field domains for Not/Range lowering in FilterExpr queries;
        # derived from observed codes when the dataset's declaration isn't
        # handed in (identical masks for any domain covering the corpus)
        self.vocab_sizes = (tuple(int(v) for v in vocab_sizes)
                            if vocab_sizes is not None
                            else index.vocab_sizes())

    @classmethod
    def from_state(cls, state, config=None, device=None,
                   vocab_sizes=None) -> "BatchedEngine":
        """Reconstruct a live capacity-slab engine from an ``InsertState``
        (DESIGN.md §10) with no graph/atlas rebuild: the slab already
        carries the patched adjacency and the incremental atlas, so
        everything derived (device atlas CSR, validity bitmap, the
        ``FiberIndex`` view) is re-*emitted* onto ``device`` (None means
        CUDA), never re-built. Further ``insert_batch`` calls continue
        seamlessly; the engine mutates ``state`` in place.

        An explicit full ``FnsConfig`` is validated against the state's
        shape-baked knobs (``ConfigMismatch`` on disagreement)."""
        from repro_torch.core.batched.insert import (emit_anchor_atlas,
                                                     emit_graph)

        if len(state.shards) != 1:
            raise ValueError(
                f"BatchedEngine.from_state needs a 1-shard state, got "
                f"{len(state.shards)} shards")
        cfg = coerce_config(config, {}, where="BatchedEngine.from_state")
        if isinstance(config, FnsConfig):
            check_state_config(
                cfg, graph_k=state.graph_k, v_cap=state.v_cap,
                n_clusters=state.shards[0].atlas.n_clusters,
                capacity=sum(sh.cap for sh in state.shards),
                where="BatchedEngine.from_state")
        else:
            # fold the state's baked values so self.cfg reports the truth
            cfg = cfg.with_knobs({"graph.graph_k": state.graph_k,
                                  "graph.alpha": state.alpha,
                                  "atlas.v_cap": state.v_cap})
        slab = state.shards[0]
        eng = cls.__new__(cls)
        eng.device = resolve_device(device)
        eng.cfg = cfg
        eng.index = FiberIndex(
            slab.vectors[: slab.n_valid].copy(),
            slab.metadata[: slab.n_valid].copy(),
            emit_graph(slab), emit_anchor_atlas(slab))
        eng.p = cfg.walk
        eng.publish_generation = 0
        eng.fence_retries = 0
        eng.dispatches = 0
        eng._state = state
        eng._refresh_from_slab(state.v_cap)
        eng.vocab_sizes = (tuple(int(v) for v in vocab_sizes)
                           if vocab_sizes is not None
                           else eng.index.vocab_sizes())
        eng.index.extend_vocab(eng.vocab_sizes)
        return eng

    def _refresh_from_slab(self, v_cap: int) -> None:
        """(Re)place the device tensors from the host slab mirror at fixed
        shapes — shared by construction, ingest, maintenance and
        ``from_state``. Copies the whole slab (cap x d vectors included)."""
        from repro_torch.core.batched.insert import emit_device_atlas

        slab = self._state.shards[0]
        dev = self.device
        self.datlas = emit_device_atlas(slab, v_cap, dev)
        self.vectors = _place(slab.vectors, dev)
        self.adjacency = _place(slab.adjacency, dev)
        self.metadata = _place(slab.metadata, dev)
        self._valid_bm = pack_bits(_place(slab.valid, dev))
        self.publish_generation += 1

    def insert_batch(self, vectors, metadata, *,
                     gids: np.ndarray | None = None) -> np.ndarray:
        """Append (vector, metadata) rows to the live index: slab writes +
        validity-bit flips, reverse-edge graph repair, and the incremental
        atlas update run on the host mirror, then the device tensors are
        refreshed (shapes change only when the slab outgrew its capacity,
        in which case ``ensure_capacity`` compacts/grows first). With
        ``maintenance.defer_repair`` the repair half is queued for the
        maintenance loop instead. ``gids`` re-introduces deleted documents
        under their old ids (still-live ids are rejected). Returns the new
        rows' ids."""
        from repro_torch.core.batched.insert import insert_rows
        from repro_torch.core.batched.lifecycle import ensure_capacity

        if self._state is None:
            raise ValueError(
                "engine was built without spare capacity; construct it "
                "with serve.capacity set to enable insert_batch")
        mcfg = self.cfg.maintenance
        room = ensure_capacity(self._state, np.asarray(vectors).shape[0],
                               mcfg)
        if room["grown"]:
            # keep the shape-baked knob truthful
            self.cfg = self.cfg.with_knobs(
                {"serve.capacity": room["new_cap"]})
        gids, _ = insert_rows(self._state, vectors, metadata, gids=gids,
                              defer_repair=mcfg.defer_repair)
        self._refresh_from_slab(self.datlas.v_cap)
        self.vocab_sizes = self._state.expand_vocab(self.vocab_sizes)
        # keep the index's memoized domains in sync: Not / open-ended
        # Range lowering would otherwise miss codes this ingest introduced
        self.index.extend_vocab(self.vocab_sizes)
        return gids

    def delete_batch(self, gids) -> int:
        """Tombstone documents by global id (DESIGN.md §12): clear their
        validity bits on the host mirror and re-place the packed bitmap —
        the only liveness source the search reads — so the cost is one
        bit-pack + transfer, with no graph or atlas work (the dead rows
        keep routing walks until compaction recycles them). Returns the
        number of rows tombstoned."""
        from repro_torch.core.batched.lifecycle import delete_rows

        if self._state is None:
            raise ValueError(
                "engine was built without spare capacity; deletes need a "
                "capacity-slab engine (serve.capacity set)")
        n, _ = delete_rows(self._state, gids)
        self._valid_bm = pack_bits(_place(self._state.shards[0].valid,
                                          self.device))
        self.publish_generation += 1
        return n

    def refresh_device(self, touched=None) -> None:
        """Re-place the device tensors from the host slab after host-side
        maintenance (compaction, growth, deferred repair): the hook
        ``MaintenanceLoop`` publishes through."""
        del touched  # one shard: a refresh is always full
        if self._state is not None:
            self._refresh_from_slab(self.datlas.v_cap)

    @property
    def state(self):
        """The host ``InsertState`` mirror (None on a fixed-size engine) —
        what the lifecycle/maintenance subsystem mutates."""
        return self._state

    @property
    def insert_stats(self) -> dict | None:
        """Ingest/staleness accounting, or None on a fixed-size engine."""
        return self._state.stats() if self._state is not None else None

    def _pack_queries(self, queries: list[Query]):
        return pack_query_batch(queries, v_cap=self.datlas.v_cap,
                                vocab_sizes=self.vocab_sizes,
                                device=self.device)

    def dispatch(self, queries: list[Query]) -> dict:
        """Fenced pack + the search, queued on the device without a host
        sync; returns a token for ``collect``. On the card this returns
        while the device is still searching, so the host can stage the
        next batch meanwhile (``serve/pipeline.py``). The token carries
        the results as device tensors and snapshots the global-id map and
        the publish generation, so a compaction that remaps rows before
        ``collect`` cannot mistranslate the batch."""
        (q_vecs, fields, allowed, bounds), gen = _fence_pack(self, queries)
        out = search_batch(self.datlas, self.vectors, self.adjacency,
                           self.metadata, q_vecs, fields, allowed, self.p,
                           self.cfg.serve.seed_backend,
                           valid_bm=self._valid_bm, bounds=bounds)
        self.dispatches += 1
        gids = (self._state.shards[0].global_ids.copy()
                if self._state is not None else None)
        return {"out": out, "q_n": len(queries), "generation": gen,
                "gids": gids}

    def collect(self, token: dict):
        """Finish a ``dispatch`` token: the batch's one device-to-host copy
        (results, walks, hops and rounds packed into one int32 tensor) and
        the result/stat post-processing. Returns (ids per query as numpy
        arrays, stats) with per-query ``walks``/``hops``, ``syncs`` (the
        host reads the batch took, the final copy included), ``rounds``
        (the restart rounds the reference's loop runs) and
        ``generation``, the publish generation it was dispatched against."""
        ids, stats = fetch_results(token["out"], token["q_n"])
        stats["generation"] = token["generation"]
        return _to_gids(ids, token["gids"]), stats

    def search(self, queries: list[Query]):
        """Filtered top-k for a batch: ``collect(dispatch(queries))``. The
        search is deterministic (seeds are nearest matching members, never
        random samples)."""
        return self.collect(self.dispatch(queries))

    def search_hostloop(self, queries: list[Query]):
        """The reference's per-round host loop, which it keeps as the
        exact-parity baseline for its fused ``search``. Its rounds give
        what the fused search's masked rounds give, so this runs ``search``
        and keeps the reference's accounting: one dispatch for the
        predicate evaluation plus one per restart round (counted on the
        device), where ``search`` counts one per batch."""
        ids, stats = self.collect(self.dispatch(queries))  # counts the eval
        self.dispatches += stats["rounds"]
        return ids, stats
