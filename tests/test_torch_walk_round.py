"""The walk round (``ops.walk_round``) and the single-dispatch search on
the CPU.

* Lane independence, the premise of the ``walk_round`` kernel (each lane
  walked to its own end): ``walk_batch`` on Q lanes equals each lane
  walked alone (``res_i``, ``term``, ``hops``, ``p1_hops`` and the
  visited bitmap exactly, ``res_v`` within its last bit), at each
  selectivity of the sweep, from scratch and with carried results.
* The kernel's algorithm, emulated lane by lane in numpy as
  ``csrc/walk_round.cu`` runs it (queues popped by a head offset,
  threshold-pruned merges of 32-candidate chunks placing a survivor by a
  binary search, a top-k as the same merge into sentinels and cut to the
  frontier's cap, the popped node's queued distance as its ``vx``, a lane
  stopped at its own end), equals ``walk_batch``: ids, termination codes,
  hop counts and visited bits exactly, distances at rtol 1e-6 (a dot
  summed in another order); the pruned merge and top-k place every entry
  where rank counting (the kernel's earlier merge) did
  (hypothesis, tie-heavy inputs); and the
  reads it makes are what the bound counts from ``walk_batch`` (distinct
  corpus rows, distinct adjacency rows, dots per lane).
* ``ops.walk_round`` on CPU tensors is ``walk_batch``; the kernel's
  wrapper refuses CPU tensors, budgets beyond its caps and plans it does
  not take, and ``walk_round_plan`` on the H100's caps keeps a block's
  bytes to half an SM, gives a cluster of 1-8 blocks a lane below the SM
  count and a grid that covers every lane.
* No host read in the round loop: ``BatchedEngine.dispatch`` and
  ``ShardedEngine.dispatch`` (reference mode and a mesh of two CPU
  cells) on the CPU with
  ``Tensor.item``/``tolist``/``__bool__``/``__int__``/``__float__``/
  ``__index__``/``cpu``/``numpy`` patched to raise everywhere but inside
  ``ops.walk_round``'s plain version, and ``collect``'s results still the
  reference's ids, walks and hops.
"""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without hypothesis: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro.core.batched.bitmap import pack_bits as ref_pack_bits
from repro.core.batched.engine import BatchedEngine as RefEngine
from repro.core.batched.sharded import ShardedEngine as RefSharded
from repro.core.batched.sharded import build_sharded_index as ref_build
from repro.core.config import FnsConfig as RefConfig
from repro_torch.core.batched.engine import (INF, TERM_MAXHOP,
                                             TERM_RUNNING, BatchedEngine,
                                             walk_batch)
from repro_torch.core.batched.sharded import ShardedEngine
from repro_torch.core.config import FnsConfig, WalkConfig
from repro_torch.interop import (queries_from_reference,
                                 sharded_index_from_reference)
from repro_torch.kernels import ops
from repro_torch.kernels import walk_round as wr

from _torch_parity import (build_or_sweep, build_range_sweep, port_side,
                           to_torch)
from conftest import SELECTIVITIES

P = WalkConfig(k=10, beam_width=4)
F32_INF = np.float32(INF)
N_SEEDS = 6


def _walk_inputs(sweep, level: int, with_results: bool):
    """The level's lanes of the sweep: vectors, adjacency, packed pass
    bitmaps, query vectors, seeds (random passing rows, -1 padded) and,
    with results, three passing rows banked as an earlier round's."""
    ds, index, queries = sweep
    qs = [q for q in queries if q.predicate.clauses[0][1] == (level,)]
    meta = ds.metadata
    passes = np.stack([q.predicate.mask(meta) for q in qs])
    vecs = np.asarray(index.vectors, np.float32)
    q_vecs = np.stack([q.vector for q in qs]).astype(np.float32)
    rng = np.random.default_rng(level)
    seeds = np.full((len(qs), N_SEEDS), -1, np.int32)
    res_v = np.full((len(qs), P.k), F32_INF, np.float32)
    res_i = np.full((len(qs), P.k), -1, np.int32)
    for qi in range(len(qs)):
        ok = np.nonzero(passes[qi])[0]
        take = rng.choice(ok, min(ok.size, N_SEEDS - qi % 2), replace=False)
        seeds[qi, :take.size] = take
        if with_results:
            bank = rng.choice(ok, 3, replace=False)
            v = (np.float32(1) - vecs[bank] @ q_vecs[qi]).astype(np.float32)
            order = np.argsort(v, kind="stable")
            res_v[qi, :3], res_i[qi, :3] = v[order], bank[order]
    bm = to_torch(np.asarray(ref_pack_bits(passes)))
    return (torch.from_numpy(vecs),
            torch.from_numpy(np.asarray(index.graph.neighbors, np.int32)),
            bm, torch.from_numpy(q_vecs), torch.from_numpy(seeds),
            torch.from_numpy(res_v), torch.from_numpy(res_i))


KEYS = ("res_v", "res_i", "term", "hops", "p1_hops", "visited_bm")


@pytest.mark.parametrize("with_results", [False, True])
@pytest.mark.parametrize("level", range(len(SELECTIVITIES)))
def test_lanes_are_independent(sel_sweep, level, with_results):
    """``walk_batch`` on the level's lanes equals each lane walked alone:
    the lockstep batches lanes and never mixes them. Ids, termination
    codes, hop counts and visited bits are exact; distances within rtol
    1e-6, because the host's batched dot (``einsum``) blocks its sum by
    the batch's shape, so a lane's last bit can move with Q."""
    vecs, adj, bm, qv, seeds, r_v, r_i = _walk_inputs(sel_sweep, level,
                                                      with_results)
    together = walk_batch(vecs, adj, bm, qv, seeds, P, (r_v, r_i))
    assert (together["hops"] > 0).all()
    for qi in range(qv.shape[0]):
        one = slice(qi, qi + 1)
        alone = walk_batch(vecs, adj, bm[one], qv[one], seeds[one], P,
                           (r_v[one], r_i[one]))
        for key in KEYS:
            tol = 1e-6 if key == "res_v" else 0
            torch.testing.assert_close(alone[key][0], together[key][qi],
                                       rtol=tol, atol=0,
                                       msg=f"lane {qi} {key}")


# -- the kernel's algorithm, one lane at a time ------------------------------

def _merge_ranks(q_v, q_i, c_v, c_i):
    """The rank-counting merge (the kernel's earlier algorithm): each
    entry's place is the count of entries before it (smaller, or equal
    and earlier; the queue before the candidates); sentinel candidates
    are skipped."""
    cap = q_v.size
    v = np.concatenate([q_v, c_v])
    i = np.concatenate([q_i, c_i])
    pos = np.arange(v.size)
    out_v, out_i = np.empty_like(q_v), np.empty_like(q_i)
    for e in range(v.size):
        if e >= cap and not v[e] < F32_INF:
            continue
        rank = int(((v < v[e]) | ((v == v[e]) & (pos < e))).sum())
        if rank < cap:
            out_v[rank], out_i[rank] = v[e], i[e]
    return out_v, out_i


def _top_small_ranks(vals, ids, kf):
    """The rank-counting top-k (the kernel's earlier algorithm): the kf
    smallest, ties to the lower index, the sentinel and -1 where fewer
    are below it."""
    t_v = np.full(kf, F32_INF, np.float32)
    t_i = np.full(kf, -1, np.int32)
    pos = np.arange(vals.size)
    for e in range(vals.size):
        if not vals[e] < F32_INF:
            continue
        rank = int(((vals < vals[e]) | ((vals == vals[e]) & (pos < e)))
                   .sum())
        if rank < kf:
            t_v[rank], t_i[rank] = vals[e], ids[e]
    return t_v, t_i


class _Q:
    """walk_round.cu's Queue: cap sorted entries popped by a head offset;
    logical entry j is buf[head + j], the sentinel (INF, -1) past the
    end."""

    def __init__(self, v, i, head=0):
        self.v, self.i, self.head = v.copy(), i.copy(), head

    @classmethod
    def empty(cls, cap):
        return cls(np.full(cap, F32_INF, np.float32),
                   np.full(cap, -1, np.int32))

    def logical(self):
        pad = self.head
        return (np.concatenate([self.v[pad:],
                                np.full(pad, F32_INF, np.float32)]),
                np.concatenate([self.i[pad:], np.full(pad, -1, np.int32)]))

    def pop(self):
        v, i = self.logical()
        self.head = min(self.head + 1, self.v.size)
        return v[0], i[0]


def _merge(q: _Q, c_v, c_i):
    """walk_round.cu's merge: chunks of 32 candidates in index order; a
    candidate survives only below the queue's last entry; a survivor's
    place is the queue entries at or below it (a binary search) plus the
    survivors before it in (value, index) order; a queue entry moves
    down by the survivors below it. Returns the merged queue (head 0)."""
    q_v, q_i = q.logical()
    cap = q_v.size
    for base in range(0, c_v.size, 32):
        cv, ci = c_v[base:base + 32], c_i[base:base + 32]
        surv = np.nonzero(cv < q_v[cap - 1])[0]
        if surv.size == 0:
            continue
        out_v, out_i = np.empty_like(q_v), np.empty_like(q_i)
        sv = cv[surv]
        for t, lane in enumerate(surv):
            rank = int(((sv < cv[lane]) | ((sv == cv[lane])
                                           & (surv < lane))).sum())
            place = int(np.searchsorted(q_v, cv[lane], side="right")) + rank
            if place < cap:
                out_v[place], out_i[place] = cv[lane], ci[lane]
        for j in range(cap):
            place = j + int((sv < q_v[j]).sum())
            if place < cap:
                out_v[place], out_i[place] = q_v[j], q_i[j]
        q_v, q_i = out_v, out_i
    return _Q(q_v, q_i)


def _top_small(vals, ids, kc):
    """walk_round.cu's top-k: the same merge into a queue of kc
    sentinels, ties to the lower index."""
    return _merge(_Q.empty(kc), vals, ids)


@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 64), st.integers(0, 256),
       st.integers(0, 64), st.integers(1, 6))
@settings(max_examples=300, deadline=None)
def test_pruned_merge_is_the_rank_merge(seed, cap, m, head, n_values):
    """The kernel's threshold-pruned merge and top-k (mirrored by
    ``_merge``/``_top_small``) place every entry where the rank counting
    of the kernel's earlier algorithm did, on tie-heavy inputs: a handful
    of distinct float32 values with the sentinel among them, -1 ids,
    queues of 1-64 entries popped by 0-64 heads, 0-256 candidates."""
    rng = np.random.default_rng(seed)
    pool = np.append(rng.uniform(-1, 2, n_values).astype(np.float32),
                     F32_INF)

    def draw(size):
        return rng.choice(pool, size).astype(np.float32)

    q = _Q(np.sort(draw(cap)), rng.integers(-1, 8, cap).astype(np.int32),
           min(head, cap))
    c_v, c_i = draw(m), rng.integers(-1, 8, m).astype(np.int32)
    got = _merge(q, c_v, c_i)
    want = _merge_ranks(*q.logical(), c_v, c_i)
    np.testing.assert_array_equal(got.v, want[0])
    np.testing.assert_array_equal(got.i, want[1])
    t = _top_small(c_v, c_i, cap)
    t_v, t_i = _top_small_ranks(c_v, c_i, cap)
    np.testing.assert_array_equal(t.v, t_v)
    np.testing.assert_array_equal(t.i, t_i)


def _emulate_lane(vecs, adj, passes, q, seeds, r0_v, r0_i, p):
    """One lane of walk_round.cu in numpy, hop for hop."""
    one = np.float32(1)

    def dist(rows):
        return (one - vecs[rows] @ q).astype(np.float32)

    k, B, F = p.k, p.beam_width, p.frontier_cap
    kf = min(p.frontier_width, adj.shape[1])
    kc = min(kf, F)        # pushes that can reach the frontier
    visited = np.zeros(vecs.shape[0], bool)
    in_res = set(int(i) for i in r0_i if i >= 0)
    valid = seeds >= 0
    seed_v = np.where(valid, dist(np.maximum(seeds, 0)), F32_INF)
    visited[seeds[valid]] = True
    read = visited.copy()                      # rows whose dot it takes
    expanded, dots = set(), 0
    fq = _merge(_Q.empty(F), seed_v, seeds)
    bq = _Q.empty(B)
    ok = valid & passes[np.maximum(seeds, 0)] & np.array(
        [int(s) not in in_res for s in seeds])
    rq = _merge(_Q(r0_v, r0_i), np.where(ok, seed_v, F32_INF), seeds)
    phase, stall, term, hops, p1 = 1, 0, TERM_RUNNING, 0, 0
    for _ in range(p.max_hops):
        f_empty = fq.logical()[0][0] >= INF / 2
        b_empty = bq.logical()[0][0] >= INF / 2
        if phase == 1 and f_empty:
            phase = 2
        uf = phase == 1
        x_v, x = (fq if uf else bq).pop()
        v_k = rq.v[k - 1]
        if (f_empty and b_empty) if uf else b_empty:
            term = 1
        elif not uf and x_v > v_k and v_k < INF / 2:
            term = 2
        elif not uf and stall >= p.stall_budget:
            term = 3
        if term != TERM_RUNNING:
            break
        expanded.add(int(x))
        nbrs = adj[max(int(x), 0)]
        ok = nbrs >= 0
        safe = np.maximum(nbrs, 0)
        new = ok & ~visited[safe]
        visited[nbrs[new]] = True
        pas = ok & passes[safe]
        vn = np.where(new | pas, dist(safe), F32_INF)
        read[nbrs[new | pas]] = True
        dots += int((new | pas).sum())
        fresh = np.array([int(n) not in in_res for n in nbrs])
        rq = _merge(rq, np.where(new & pas & fresh, vn, F32_INF), nbrs)
        n_pass, n_new = int(pas.sum()), int((new & pas).sum())
        total = np.float32(0)
        for v in vn[pas]:
            total = np.float32(total + v)
        drift = (np.float32(total / np.float32(n_pass)) - x_v
                 if n_pass else np.inf)
        stall = 0 if n_new else stall + 1
        neg = drift < 0
        if phase == 1 and neg:
            t = _top_small(np.where(new & pas & (vn < x_v), vn, F32_INF),
                           nbrs, kc)
            fq = _merge(fq, t.v, t.i)
        elif phase == 1:
            f_v, f_i = fq.logical()
            bq = _merge(bq, np.concatenate([f_v, np.where(new, vn,
                                                          F32_INF)]),
                        np.concatenate([f_i, nbrs]))
            fq = _Q.empty(F)
            phase = 2
        else:
            bq = _merge(bq, np.where(new, vn, F32_INF), nbrs)
            if neg and n_new:
                t = _top_small(np.where(new & pas, vn, F32_INF), nbrs, kc)
                if t.v[0] < INF / 2:
                    fq = _merge(_Q.empty(F), t.v, t.i)
                    bq = _Q.empty(B)
                    phase = 1
        hops += 1
        p1 += uf
    return dict(res_v=rq.v, res_i=rq.i,
                term=TERM_MAXHOP if term == TERM_RUNNING else term,
                hops=hops, p1_hops=p1, visited=visited, read=read,
                expanded=expanded, dots=dots)


@pytest.mark.parametrize("with_results", [False, True])
@pytest.mark.parametrize("level", range(len(SELECTIVITIES)))
def test_kernel_algorithm_matches_walk_batch(sel_sweep, level,
                                             with_results):
    vecs, adj, bm, qv, seeds, r_v, r_i = _walk_inputs(sel_sweep, level,
                                                      with_results)
    want = walk_batch(vecs, adj, bm, qv, seeds, P, (r_v, r_i))
    ds, _, queries = sel_sweep
    qs = [q for q in queries if q.predicate.clauses[0][1] == (level,)]
    for qi, q in enumerate(qs):
        got = _emulate_lane(vecs.numpy(), adj.numpy(),
                            q.predicate.mask(ds.metadata), qv[qi].numpy(),
                            seeds[qi].numpy(), r_v[qi].numpy(),
                            r_i[qi].numpy(), P)
        np.testing.assert_array_equal(got["res_i"], want["res_i"][qi])
        np.testing.assert_allclose(got["res_v"], want["res_v"][qi],
                                   rtol=1e-6)
        for key in ("term", "hops", "p1_hops"):
            assert got[key] == int(want[key][qi]), (qi, key)
        np.testing.assert_array_equal(
            np.asarray(ref_pack_bits(got["visited"])).view(np.int32),
            want["visited_bm"][qi].numpy())


@pytest.mark.parametrize("level", range(len(SELECTIVITIES)))
def test_bound_counts_what_the_kernel_reads(sel_sweep, level):
    """The bound's counts from ``walk_batch`` (chip_smoke's
    ``round_work``) are the emulated kernel's reads: its distinct corpus
    rows over all lanes are the lanes' visited bitmaps ORed, its
    distinct adjacency rows are ``expanded``, and each lane's neighbour
    dots are its ``dotted``."""
    from repro_torch.core.batched.bitmap import unpack_bits
    vecs, adj, bm, qv, seeds, r_v, r_i = _walk_inputs(sel_sweep, level,
                                                      True)
    want = walk_batch(vecs, adj, bm, qv, seeds, P, (r_v, r_i))
    ds, _, queries = sel_sweep
    qs = [q for q in queries if q.predicate.clauses[0][1] == (level,)]
    read = np.zeros(vecs.shape[0], bool)
    expanded = set()
    for qi, q in enumerate(qs):
        got = _emulate_lane(vecs.numpy(), adj.numpy(),
                            q.predicate.mask(ds.metadata), qv[qi].numpy(),
                            seeds[qi].numpy(), r_v[qi].numpy(),
                            r_i[qi].numpy(), P)
        np.testing.assert_array_equal(got["read"], got["visited"])
        assert got["dots"] == int(want["dotted"][qi]), qi
        read |= got["read"]
        expanded |= got["expanded"]
    np.testing.assert_array_equal(
        unpack_bits(want["visited_bm"], vecs.shape[0]).any(dim=0).numpy(),
        read)
    assert set(torch.nonzero(want["expanded"]).flatten().tolist()) \
        == expanded
    assert 0 < len(expanded) < int(want["hops"].sum())


# -- the dispatcher and the wrapper ------------------------------------------

def test_ops_walk_round_cpu_is_walk_batch(sel_sweep):
    args = _walk_inputs(sel_sweep, 1, True)
    vecs, adj, bm, qv, seeds, r_v, r_i = args
    got = ops.walk_round(*args, P)
    want = walk_batch(vecs, adj, bm, qv, seeds, P, (r_v, r_i))
    for key in KEYS + ("syncs",):
        assert torch.equal(torch.as_tensor(got[key]),
                           torch.as_tensor(want[key])), key
    assert got["syncs"] >= 1
    with pytest.raises(ValueError, match="walk_round"):
        ops.walk_round(*(a.to("meta") for a in args), P)


def test_wrapper_refuses_what_the_kernel_does_not_take(sel_sweep):
    """The CUDA wrapper raises on CPU tensors (no fallback), on walk
    budgets beyond the kernel's caps and on a launch plan the kernel does
    not take; the plan fits the H100's 227 KB a block at the smoke's
    widths and finds no room for a row at d=40,000."""
    args = _walk_inputs(sel_sweep, 0, False)
    with pytest.raises(ValueError, match="CUDA device"):
        wr.walk_round(*args, P)
    with pytest.raises(ValueError, match="k=65"):
        wr.walk_round(*args, WalkConfig(k=65))
    with pytest.raises(ValueError, match="adjacency width 300"):
        wr.check_params(300, 10, P)
    assert wr.check_params(96, 10, P) == P.frontier_width
    for d in (2048, 1600, 576, 8192):
        plan = wr.walk_round_plan(d, 64, N_MAIN, *H100)
        wr.check_plan(plan, d, N_MAIN)
        assert plan.smem + wr.STATIC_SMEM <= 227 * 1024
    good = wr.walk_round_plan(2048, 64, N_MAIN, *H100)
    for bad, what in ((good._replace(cluster=9, grid=9 * 64), "cluster=9"),
                      (good._replace(grid=129), "grid=129"),
                      (good._replace(slots=0), "slots=0"),
                      (good._replace(slots=33), "slots=33"),
                      (good._replace(warps=8), "warps=8"),
                      (good._replace(slots=7), "not a multiple of warps"),
                      (good._replace(smem=good.smem - 16), "smem=")):
        with pytest.raises(ValueError, match=what):
            wr.check_plan(bad, 2048, N_MAIN)
    with pytest.raises(ValueError, match="no room"):
        wr.walk_round_plan(40_000, 64, N_MAIN, *H100)


# the H100 SXM: SMs, shared memory a block (opt-in) and an SM; the smoke's
# main corpus rows
H100 = (132, 227 * 1024, 228 * 1024)
N_MAIN = 105_100


@pytest.mark.parametrize("n", [N_MAIN, 2_000_000])
@pytest.mark.parametrize("Q", [1, 64, 132, 256])
@pytest.mark.parametrize("d", [64, 576, 1600, 2048])
def test_launch_plan(d, Q, n):
    """``walk_round_plan`` on the H100's caps over n rows: a block's
    bytes within the limit and two of them within an SM (so two fit an SM
    whenever Q >= the SM count); the lane's bitmaps in shared memory
    exactly where MIN_SLOTS_BESIDE_BITMAPS row buffers still fit beside
    them (at d = 2,048 over the main corpus, not over 2,000,000 rows); the
    most gather warps (1-7) that get two buffers each, and as many
    buffers as divide among them;
    a cluster of 1 <= C <= 8 blocks a lane with C * Q <= SMs below the SM
    count; the grid a whole number of clusters that holds every lane at
    once or, past twice the SM count, is persistent (the kernel hands out
    the rest by its counter)."""
    sms, smem_block, smem_sm = H100
    plan = wr.walk_round_plan(d, Q, n, sms, smem_block, smem_sm)
    wr.check_plan(plan, d, n)
    block = plan.smem + wr.STATIC_SMEM
    assert block <= smem_block
    assert plan.blocks_per_sm * (block + wr.BLOCK_RESERVED) <= smem_sm
    assert plan.blocks_per_sm >= 2
    budget = smem_sm // 2 - wr.BLOCK_RESERVED - wr.STATIC_SMEM
    bm = 8 * ((n + 31) // 32)
    assert plan.bitmaps == int((budget - bm) // (d * 4) - 1
                               >= wr.MIN_SLOTS_BESIDE_BITMAPS)
    if d == 2048:
        assert plan.bitmaps == (n == N_MAIN)
    fit = min(wr.MAX_SLOTS, (budget - plan.bitmaps * bm) // (d * 4) - 1)
    assert plan.warps == max(1, min(wr.MAX_WARPS, fit // 2))
    assert plan.slots == plan.warps * (fit // plan.warps)
    if Q >= sms:
        assert plan.cluster == 1
    else:
        assert 1 <= plan.cluster <= wr.MAX_CLUSTER
        assert plan.cluster * Q <= sms
        assert plan.cluster == min(wr.MAX_CLUSTER, sms // Q)
    assert plan.grid % plan.cluster == 0
    assert plan.grid // plan.cluster == min(
        Q, plan.blocks_per_sm * sms // plan.cluster)


# -- no host read between the pack and collect -------------------------------

READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__",
         "cpu", "numpy")


class _NoHostReads:
    """Patch every host read of a tensor to raise, except inside
    ``ops.walk_round``'s plain version (its loop-exit reads)."""

    def __init__(self, monkeypatch):
        self.mp, self.inside, self.rounds = monkeypatch, 0, 0

    def __enter__(self):
        real_round = ops.walk_round

        def round_(*args):
            self.inside += 1
            self.rounds += 1
            try:
                return real_round(*args)
            finally:
                self.inside -= 1

        self.mp.setattr(ops, "walk_round", round_)
        for name in READS:
            real = getattr(torch.Tensor, name)

            def guard(t, *a, _real=real, _name=name, **kw):
                if not self.inside:
                    raise AssertionError(f"host read Tensor.{_name}")
                return _real(t, *a, **kw)

            self.mp.setattr(torch.Tensor, name, guard)
        return self

    def __exit__(self, *exc):
        self.mp.undo()


def _sweep(request, name):
    if name == "sel":
        return request.getfixturevalue("sel_sweep")
    return {"or": build_or_sweep, "range": build_range_sweep}[name]()


@pytest.mark.parametrize("sweep", ["sel", "or", "range"])
def test_dispatch_reads_nothing_on_the_host(request, monkeypatch, sweep):
    ds, index, queries = _sweep(request, sweep)
    vocab = None if sweep == "sel" else ds.vocab_sizes
    ref = RefEngine(index, RefConfig().with_knobs({"walk.k": 10}),
                    vocab_sizes=vocab)
    pidx, pq = port_side(index, queries)
    eng = BatchedEngine(pidx, FnsConfig().with_knobs({"walk.k": 10}),
                        device="cpu", vocab_sizes=vocab)
    with _NoHostReads(monkeypatch) as guard:
        token = eng.dispatch(pq)
    assert guard.rounds == eng.p.jump_budget + 1
    ids_p, st_p = eng.collect(token)
    ids_r, st_r = ref.search(queries)
    for a, b in zip(ids_r, ids_p):
        np.testing.assert_array_equal(b, np.asarray(a))
    np.testing.assert_array_equal(st_p["walks"], st_r["walks"])
    np.testing.assert_array_equal(st_p["hops"], st_r["hops"])
    # the hostloop's accounting: the device-counted rounds
    d0 = ref.dispatches
    ref.search_hostloop(queries)
    assert st_p["rounds"] == ref.dispatches - d0 - 1


@pytest.mark.parametrize("on_mesh", [False, True])
def test_sharded_dispatch_reads_nothing_on_the_host(sel_sweep, monkeypatch,
                                                    on_mesh):
    """Reference mode and a mesh of two CPU cells."""
    from repro_torch.launch.mesh import make_local_mesh
    ds, _, queries = sel_sweep
    knobs = {"walk.k": 10, "graph.graph_k": 16, "graph.r_max": 48}
    ref_sidx = ref_build(ds.vectors, ds.metadata, 2,
                         config=RefConfig().with_knobs(knobs))
    ref = RefSharded(ref_sidx, None, RefConfig().with_knobs(knobs))
    mesh = make_local_mesh(2, devices=["cpu"] * 2) if on_mesh else None
    port = ShardedEngine(sharded_index_from_reference(ref_sidx, "cpu"),
                         mesh, FnsConfig().with_knobs(knobs),
                         device=None if on_mesh else "cpu")
    pq = queries_from_reference(queries)
    with _NoHostReads(monkeypatch) as guard:
        token = port.dispatch(pq)
    assert guard.rounds == 2 * (port.p.jump_budget + 1)
    ids_p, st_p = port.collect(token)
    ids_r, st_r = ref.search_reference(queries)
    for a, b in zip(ids_r, ids_p):
        np.testing.assert_array_equal(b, np.asarray(a))
    np.testing.assert_array_equal(st_p["walks"], st_r["walks"])
    np.testing.assert_array_equal(st_p["hops"], st_r["hops"])
    assert 1 <= st_p["rounds"] <= port.p.jump_budget + 1
