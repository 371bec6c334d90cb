"""The port's plain kernel versions (``repro_torch.kernels.ref``) vs the
reference's jnp oracles AND its Pallas kernels in interpret mode, on the
shape sweeps of ``tests/test_kernels.py``; plus the dispatcher's CPU route
and the port's parity gate on the CPU.

Tolerances: K1 (filter_eval_batch) and K4 (filter_eval) are integer work
and must be bit-exact. K2 (fiber_expand_walk) sims are fp32 dot products
summed in a different order by each framework: allclose at
rtol=atol=1e-5, with the -inf positions identical; K5 (fiber_expand) at
rtol=atol=1e-4, the reference's own kernel-vs-oracle bar. K3
(masked_cosine_topk) sims at rtol=atol=1e-4 (the same bar), ids equal on
tie-free random data, and a tie-heavy row must give the lowest ids first.

The CUDA kernels themselves run only on the card (``chip_smoke.py``);
here their host-side tiling (``masked_cosine_topk.plan``,
``fiber_expand.walk_plan`` for K2 and K5, ``filter_eval.filter_plan``) is
checked at the smoke's shapes and ragged ones, and K3's 3xTF32 split is
emulated in torch to pin its numerics.

``repro.core`` is imported before ``repro.kernels``: the reference's
``kernels/ops.py`` imports ``repro.core``, whose ``device_atlas`` imports
``repro.kernels`` back.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.device_atlas import pack_dnf, pack_predicates
from repro.core.predicate import And, In, Not, Or, Range, as_dnf
from repro.core.types import FilterPredicate
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fiber_expand import fiber_expand as pallas_expand
from repro.kernels.fiber_expand import fiber_expand_walk as pallas_walk
from repro.kernels.filter_eval import filter_eval as pallas_filter_one
from repro.kernels.filter_eval import filter_eval_batch as pallas_filter
from repro.kernels.masked_cosine_topk import masked_cosine_topk as pallas_topk
from repro_torch.kernels import (build, fiber_expand, filter_eval,
                                 masked_cosine_topk, ops)
from repro_torch.kernels import ref as tref
from repro_torch.kernels.parity import kernel_oracle_parity

_jref_filter = jax.jit(jref.filter_eval_batch)
_jref_filter_one = jax.jit(jref.filter_eval)
_jref_walk = jax.jit(jref.fiber_expand_walk)
_jref_expand = jax.jit(jref.fiber_expand)
_jref_topk = jax.jit(jref.masked_cosine_topk, static_argnums=3)


def _t(x: np.ndarray) -> torch.Tensor:
    x = np.asarray(x)
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


def _mk(n, d, Q, seed=0):
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((Q, d)).astype(np.float32)
    bitmap = rng.integers(0, 2**32, (Q, (n + 31) // 32), dtype=np.uint32)
    return corpus, queries, bitmap


def _meta(n, F, seed, vocab=40):
    # codes -1 (unpopulated) .. vocab - 1
    return np.random.default_rng(seed).integers(-1, vocab, (n, F)).astype(
        np.int32)


def _conj_tables(F, seed, q_n=6, v_cap=64, vocab=40):
    """q_n - 2 random conjunctions of 1-3 clauses over codes below
    min(vocab, v_cap) (1-3 values a clause, or up to half of them for a
    wide vocabulary), then an unconstrained and a never() lane."""
    rng = np.random.default_rng(seed)
    top = min(vocab, v_cap)
    most = 4 if top <= 64 else top // 2   # values per clause, exclusive
    preds = [FilterPredicate.make(
        {int(f): rng.integers(0, top, rng.integers(1, most)).tolist()
         for f in rng.choice(F, rng.integers(1, 4), replace=False)})
        for _ in range(q_n - 2)]
    preds.append(FilterPredicate.make({}))      # unconstrained: pad bits 0
    preds.append(FilterPredicate(((0, ()),)))   # never: matches nothing
    return pack_predicates(preds, max_clauses=4, v_cap=v_cap)


def _dnf_tables(F, D=4, v_cap=64, vocab=40):
    """DNF tables: the fixed expressions (an OR, an interval, a NOT, never,
    always, an open interval) and, for D = 8, an eight-way OR; codes
    beyond v_cap (vocab > v_cap) lower to interval clauses."""
    vocab = [vocab] * F
    exprs = [Or(In(0, [1, 2]), In(3, [5])),
             And(In(1, [3, 4]), Range(2, 5, 20)),
             Or(Range(4, 0, 3), In(5, [39]), Not(In(1, list(range(30))))),
             Or(), And(), Range(0, 38, None)]
    if D == 8:
        exprs.append(Or(*(In(i % F, [3 * i, 3 * i + 1, v_cap - 1 - i])
                          for i in range(8))))
    dnfs = [as_dnf(e, vocab, v_cap=v_cap) for e in exprs]
    f, a, b, nd = pack_dnf(dnfs, max_disjuncts=D, max_clauses=4,
                           v_cap=v_cap)
    return f, a, b, nd, exprs, vocab


# K1 shapes across the CUDA kernel's tile and query-group edges (its tile
# is filter_eval.FILTER_ROWS = 256 rows): n = tile - 1 and tile + 1, F
# even (the padded shared-memory row stride), Wv = 32 words (v_cap 1024,
# codes beyond it in the metadata), D = 8, and Q = 265, which the plan
# for an 8-SM card splits into groups of 4 queries. The first three are
# the original cases.
_K1_CASES = [pytest.param(10, 6, 64, 6, 40, id="10"),
             pytest.param(300, 6, 64, 6, 40, id="300"),
             pytest.param(1000, 6, 64, 6, 40, id="1000"),
             pytest.param(255, 27, 1024, 6, 1100, id="tile-1-wv32"),
             pytest.param(257, 27, 1024, 6, 1100, id="tile+1-wv32"),
             pytest.param(257, 8, 64, 265, 40, id="tile+1-evenF-q265")]
_K1_DNF_CASES = [pytest.param(10, 6, 64, 4, 40, id="10"),
                 pytest.param(300, 6, 64, 4, 40, id="300"),
                 pytest.param(1000, 6, 64, 4, 40, id="1000"),
                 pytest.param(255, 27, 1024, 8, 1100, id="tile-1-wv32-d8"),
                 pytest.param(257, 8, 1024, 8, 1100,
                              id="tile+1-evenF-wv32-d8")]


def _assert_bits_equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("n,F,v_cap,q_n,vocab", _K1_CASES)
def test_filter_eval_conjunctive_bit_exact(n, F, v_cap, q_n, vocab):
    meta = _meta(n, F, n, vocab)
    f_np, a_np = _conj_tables(F, n + 1, q_n, v_cap, vocab)
    if q_n > 6:  # query groups with a ragged last one (an 8-SM card's
        # plan; the smoke forces such groups on the H100)
        _, group, _ = filter_eval.filter_plan(q_n, n, F, 1, 4, v_cap // 32, 8)
        assert 1 < group and q_n % group != 0
    got = tref.filter_eval_batch(_t(meta), _t(f_np), _t(a_np))
    jargs = (jnp.asarray(meta), jnp.asarray(f_np), jnp.asarray(a_np))
    _assert_bits_equal(got, _jref_filter(*jargs))
    _assert_bits_equal(got, pallas_filter(*jargs, tn=64, interpret=True))


@pytest.mark.parametrize("n,F,v_cap,D,vocab", _K1_DNF_CASES)
@pytest.mark.parametrize("with_bounds", [False, True])
def test_filter_eval_dnf_bit_exact(n, F, v_cap, D, vocab, with_bounds):
    """DNF tables (dead-disjunct padding, a never() and an always() lane)
    with and without the interval bounds table."""
    meta = _meta(n, F, n + 7, vocab)
    f_np, a_np, b_np, nd, exprs, vocab = _dnf_tables(F, D, v_cap, vocab)
    if not with_bounds:  # interval-free rows of the same tables
        b_np = None
    bounds_t = None if b_np is None else _t(b_np)
    got = tref.filter_eval_batch(_t(meta), _t(f_np), _t(a_np), _t(nd),
                                 bounds_t)
    jb = None if b_np is None else jnp.asarray(b_np)
    jargs = (jnp.asarray(meta), jnp.asarray(f_np), jnp.asarray(a_np),
             jnp.asarray(nd), jb)
    _assert_bits_equal(got, _jref_filter(*jargs))
    _assert_bits_equal(got, pallas_filter(*jargs, tn=64, interpret=True))
    # n_disj derived from the dead-disjunct sentinel gives the same bits
    assert torch.equal(got, tref.filter_eval_batch(
        _t(meta), _t(f_np), _t(a_np), None, bounds_t))
    if with_bounds:  # and equals the expression-tree oracle
        want = np.stack([e.mask(meta, vocab) for e in exprs])
        bits = np.unpackbits(got.numpy().view(np.uint8), axis=1,
                             bitorder="little")[:, :n].astype(bool)
        np.testing.assert_array_equal(bits, want)


def _single_tables(case, seed):
    """K4 tables: (C,) fields and a dense (C, 256) uint8 allowed table —
    three active clauses, or none at all (every row passes)."""
    rng = np.random.default_rng(seed)
    if case == "inactive":
        fields = np.full(4, -1, np.int32)
    else:
        fields = np.asarray([0, 5, -1, 2], np.int32)
    allowed = rng.integers(0, 2, (4, 256)).astype(np.uint8)
    return fields, allowed


def _k4_numpy(meta, fields, allowed):
    """The K4 semantics in numpy: (n,) bool pass mask."""
    ok = np.ones(meta.shape[0], bool)
    for f, row in zip(fields, allowed):
        if f >= 0:
            v = meta[:, f]
            ok &= (v >= 0) & (v < row.size) & (row[np.clip(v, 0,
                                                           row.size - 1)] > 0)
    return ok


@pytest.mark.parametrize("n", [10, 40, 300, 1000])
@pytest.mark.parametrize("case", ["active", "inactive"])
def test_filter_eval_single_bit_exact(n, case):
    """K4's plain version equals the jnp oracle bit for bit, pad bits
    included (they are 0), and the Pallas kernel on the first n bits."""
    meta = _meta(n, 6, n + 3)
    fields, allowed = _single_tables(case, n)
    got = tref.filter_eval(_t(meta), _t(fields), _t(allowed))
    assert got.shape == ((n + 31) // 32,) and got.dtype == torch.int32
    jargs = (jnp.asarray(meta), jnp.asarray(fields), jnp.asarray(allowed))
    _assert_bits_equal(got, _jref_filter_one(*jargs))
    bits = np.unpackbits(got.numpy().view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(bits[:n].astype(bool),
                                  _k4_numpy(meta, fields, allowed))
    assert not bits[n:].any(), "pad bits must be 0"
    # The Pallas kernel leaves the pad bits of the last word set when no
    # clause is active and n % 32 != 0 (its padded rows carry code -1 and
    # nothing tests them); its oracle, K1 and the port clear them. So only
    # the first n bits are held to it.
    pallas = np.asarray(pallas_filter_one(*jargs, tn=64, interpret=True))
    p_bits = np.unpackbits(pallas.view(np.uint8), bitorder="little")
    np.testing.assert_array_equal(bits[:n], p_bits[:n])


@pytest.mark.parametrize("n,d,Q,R", [(64, 16, 2, 5), (500, 64, 7, 24),
                                     (1000, 128, 3, 48)])
def test_fiber_expand_matches(n, d, Q, R):
    """K5's plain version against the jnp oracle and the interpret-mode
    Pallas kernel: -inf exactly where the id is -1 or its bit is 0."""
    corpus, queries, bitmap = _mk(n, d, Q, seed=R + 2)
    ids = np.random.default_rng(R + 2).integers(-1, n, (Q, R)).astype(
        np.int32)
    got = tref.fiber_expand(_t(queries), _t(corpus), _t(ids), _t(bitmap))
    jargs = (jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(ids),
             jnp.asarray(bitmap))
    for want in (_jref_expand(*jargs), pallas_expand(*jargs, interpret=True)):
        want = np.asarray(want)
        want = np.where(want <= -3.4e38 / 2, -np.inf, want)
        np.testing.assert_array_equal(np.isneginf(got.numpy()),
                                      np.isneginf(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_predicate_tables_identical():
    """``ops.predicate_tables`` gives the reference's dense K4 tables,
    clauses past max_clauses and values past v_cap dropped alike."""
    from repro_torch.core.types import FilterPredicate as TPred
    specs = [{0: [3, 4], 2: [1]}, {1: list(range(10))}, {},
             {0: [1], 1: [2], 2: [3], 3: [4], 4: [300, 5]}]
    for spec in specs:
        for kw in ({}, {"max_clauses": 2, "v_cap": 64}):
            want = jops.predicate_tables(FilterPredicate.make(spec), 6, **kw)
            got = ops.predicate_tables(TPred.make(spec), 6, **kw)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_parity_gate_on_cpu():
    """The port's parity gate, run through the CPU route: every probe,
    the expression-tree checks included, comes back clean."""
    assert kernel_oracle_parity("cpu") == []


@pytest.mark.parametrize("n,d,Q,R", [(64, 16, 2, 5), (500, 64, 7, 24),
                                     (1000, 128, 3, 48)])
def test_fiber_expand_walk_matches(n, d, Q, R):
    corpus, queries, bitmap = _mk(n, d, Q, seed=R + 1)
    ids = np.random.default_rng(R + 1).integers(-1, n, (Q, R)).astype(
        np.int32)
    s_t, p_t = tref.fiber_expand_walk(_t(queries), _t(corpus), _t(ids),
                                      _t(bitmap))
    jargs = (jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(ids),
             jnp.asarray(bitmap))
    for s_j, p_j in (_jref_walk(*jargs), pallas_walk(*jargs, interpret=True)):
        for got, want in ((s_t, s_j), (p_t, p_j)):
            want = np.asarray(want)
            np.testing.assert_array_equal(np.isneginf(got.numpy()),
                                          np.isneginf(want))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("n,d,Q,k", [(100, 32, 3, 8), (513, 64, 5, 16),
                                     (1024, 128, 9, 32), (2000, 256, 2, 25)])
def test_masked_cosine_topk_matches(n, d, Q, k):
    corpus, queries, bitmap = _mk(n, d, Q, seed=n)
    s_t, i_t = tref.masked_cosine_topk(_t(queries), _t(corpus), _t(bitmap),
                                       k)
    jargs = (jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(bitmap))
    for s_j, i_j in (_jref_topk(*jargs, k),
                     pallas_topk(*jargs, k=k, qt=8, nt=512, interpret=True)):
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


def test_masked_cosine_topk_sparse_and_empty_rows():
    """Fewer than k passing rows: the tail is -inf/-1 in both packages."""
    n, d, Q, k = 300, 16, 3, 10
    corpus, queries, _ = _mk(n, d, Q, seed=5)
    mask = np.zeros((Q, n), bool)
    mask[0, [3, 77, 299]] = True       # 3 < k rows pass
    mask[2, ::7] = True
    bitmap = np.packbits(np.pad(mask, ((0, 0), (0, (-n) % 32))), axis=1,
                         bitorder="little").view(np.uint32)
    s_t, i_t = tref.masked_cosine_topk(_t(queries), _t(corpus), _t(bitmap),
                                       k)
    s_j, i_j = _jref_topk(jnp.asarray(queries), jnp.asarray(corpus),
                          jnp.asarray(bitmap), k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert sorted(i_t[0, :3].tolist()) == [3, 77, 299]
    assert (i_t[0, 3:] == -1).all() and torch.isneginf(s_t[0, 3:]).all()
    assert (i_t[1] == -1).all()


def test_masked_cosine_topk_ties_lowest_id_first():
    """A tie-heavy row (many equal scores): ids come lowest first, as
    lax.top_k and the Pallas running merge give them."""
    n, d, Q, k = 700, 8, 2, 32
    corpus = np.zeros((n, d), np.float32)
    corpus[:, 0] = 1.0
    corpus[400:450, 0] = 2.0   # 50 rows tie at the top
    queries = np.zeros((Q, d), np.float32)
    queries[:, 0] = 1.0
    bitmap = np.full((Q, (n + 31) // 32), 0xFFFFFFFF, np.uint32)
    bitmap[1, 12:14] = 0x55555555   # rows 384..447: every other one passes
    s_t, i_t = tref.masked_cosine_topk(_t(queries), _t(corpus), _t(bitmap),
                                       k)
    jargs = (jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(bitmap))
    for s_j, i_j in (_jref_topk(*jargs, k),
                     pallas_topk(*jargs, k=k, qt=8, nt=512, interpret=True)):
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(i_t[0].numpy(), np.arange(400, 432))
    np.testing.assert_array_equal(
        i_t[1].numpy(),
        np.concatenate([np.arange(400, 448, 2), np.arange(448, 450),
                        np.arange(0, 6)]))


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as ``cvt.rna.tf32.f32`` rounds and the K3 kernel's
    ``tf32_rna`` computes it: add half the weight of the 13 mantissa bits
    TF32 drops to the bit pattern (round to nearest, ties away from zero),
    then clear them."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(
        torch.float32)


def test_tf32_rna_rounds_to_nearest_ties_away():
    bits = np.array([0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F801001,
                     0x3F7FF000, 0x7F7FF000], np.uint32)
    got = _tf32_rna(torch.from_numpy(bits.view(np.float32))).numpy()
    np.testing.assert_array_equal(
        got.view(np.uint32),
        np.array([0x3F802000, 0xBF802000, 0x3F800000, 0x3F802000,
                  0x3F800000, 0x7F800000], np.uint32))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        10_000).astype(np.float32))
    r = _tf32_rna(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    # nearest: within half a TF32 ulp (2^-11 relative)
    assert ((r - x).abs() <= x.abs() * 2.0**-11).all()


def test_3xtf32_split_holds_fp32_accuracy():
    """The K3 kernel's products: each operand splits into hi = tf32(x) and
    lo = tf32(x - hi), and lo*hi + hi*lo + hi*hi accumulate in fp32. On unit
    vectors at d = 2048 the three products land within 1e-6 of the fp32
    product (as close to the float64 truth as fp32 itself); one TF32
    product alone does not."""
    rng = np.random.default_rng(0)
    d = 2048
    q = rng.standard_normal((64, d))
    x = rng.standard_normal((2000, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    truth = q @ x.T
    q32, x32 = torch.from_numpy(q.astype(np.float32)), \
        torch.from_numpy(x.astype(np.float32))
    fp32 = (q32 @ x32.T).double().numpy()
    q_hi, x_hi = _tf32_rna(q32), _tf32_rna(x32)
    q_lo, x_lo = _tf32_rna(q32 - q_hi), _tf32_rna(x32 - x_hi)
    # TF32 x TF32 products are exact in fp32 (11 + 11 significant bits), so
    # fp32 matmuls of the parts are the tensor cores' products
    three = (q_lo @ x_hi.T + q_hi @ x_lo.T + q_hi @ x_hi.T).double().numpy()
    one = (q_hi @ x_hi.T).double().numpy()
    err3 = np.abs(three - fp32).max()
    err1 = np.abs(one - fp32).max()
    assert err3 < 1e-6, err3
    assert err1 > 1e-6, err1
    assert np.abs(three - truth).max() < 2 * np.abs(fp32 - truth).max() \
        + 1e-7


@pytest.mark.parametrize("q_n,n,want", [
    (256, 105_100, (4, 50, 66)),    # the smoke's kernel phase
    (64, 105_100, (1, 32, 103)),    # the search's Q=64 batches
    (6, 800, (1, 32, 1)),           # the parity gate's probes
    (70, 1000, (2, 32, 1)),         # n % 32 != 0, Q across one tile
    (130, 4133, (3, 32, 5)),
    (1, 1, (1, 32, 1)),
])
def test_masked_cosine_topk_plan(q_n, n, want):
    """K3's pass-1 grid: query tiles of 64, chunks of 32-64 bitmap words
    sized so that the grid gives each of 132 SMs two blocks where the
    corpus allows; the chunks cover every word exactly once."""
    got = masked_cosine_topk.plan(q_n, n, 132)
    assert got == want
    q_tiles, chunk_words, n_chunks = got
    words = -(-n // 32)
    assert q_tiles * masked_cosine_topk.QUERY_TILE >= q_n
    assert 32 <= chunk_words <= 64
    assert (n_chunks - 1) * chunk_words < words <= n_chunks * chunk_words


@pytest.mark.parametrize("q_n,r,d,want", [
    (256, 96, 2048, (4, 48, 73_728)),   # the smoke's kernel phase
    (64, 96, 2048, (4, 20, 73_728)),    # the search's Q=64 hops
    (6, 24, 64, (4, 8, 2_304)),         # the parity gate's probes
    (3, 5, 37, (4, 5, 1_440)),          # d % 4 != 0, R below a warp
    (1, 96, 16_384, (1, 2, 196_608)),   # one warp's two rows fill the block
])
def test_fiber_expand_walk_plan(q_n, r, d, want):
    """K2's grid: blocks of up to 4 warps with a query and two row buffers
    per warp in shared memory, R split so that even Q = 64 gives each of
    132 SMs two blocks; every neighbour slot belongs to one block."""
    got = fiber_expand.walk_plan(q_n, r, d, 132)
    assert got == want
    warps, span, smem = got
    blocks = -(-r // span)
    assert (blocks - 1) * span < r <= blocks * span
    assert smem == (1 + 2 * warps) * (-(-d // 4) * 16)
    assert smem <= fiber_expand.WALK_SMEM_LIMIT
    if q_n * -(-r // (2 * warps)) >= 2 * 132:
        assert q_n * blocks >= 2 * 132


def test_fiber_expand_walk_plan_refuses_huge_rows():
    with pytest.raises(ValueError, match="row buffers"):
        fiber_expand.walk_plan(1, 96, 30_000, 132)


@pytest.mark.parametrize("q_n,r,d,want", [
    (256, 96, 2048, (4, 48, 73_728)),   # the smoke's K5 phase (K2 shapes)
    (6, 24, 64, (4, 8, 2_304)),         # the parity gate's probes
    (1, 96, 2048, (4, 8, 73_728)),      # one query: R split 12 ways
    (5, 33, 130, (4, 7, 4_752)),        # d % 4 != 0 (4-byte copies)
    (1, 1, 4, (4, 1, 144)),
])
def test_fiber_expand_plan(q_n, r, d, want):
    """K5 launches on K2's plan: the same shared memory (a query staged
    once per block, two row buffers per warp) and the same R split, so a
    small Q still spreads over the SMs; every slot belongs to one block."""
    got = fiber_expand.walk_plan(q_n, r, d, 132)
    assert got == want
    warps, span, smem = got
    blocks = -(-r // span)
    assert (blocks - 1) * span < r <= blocks * span
    assert smem == (1 + fiber_expand.WALK_SLOTS * warps) * (-(-d // 4) * 16)
    # two blocks per SM where R allows, at about two slots per warp
    assert q_n * blocks >= 2 * 132 or blocks == -(-r // (2 * warps))


@pytest.mark.parametrize("q_n,n,F,D,C,Wv,want", [
    (256, 105_100, 27, 1, 4, 8, (256, 42, 32_064)),    # smoke conj, v_cap 256
    (256, 105_100, 27, 1, 4, 32, (256, 42, 32_064)),   # smoke conj, v_cap 1024
    (256, 105_100, 27, 8, 4, 32, (256, 42, 60_288)),   # bench OR, D = 8
    (64, 105_100, 27, 2, 4, 32, (256, 10, 29_696)),    # search OR, Q = 64
    (1, 105_100, 27, 1, 4, 32, (256, 1, 27_808)),      # one query
    (256, 10, 27, 8, 4, 32, (256, 1, 28_480)),         # n < 32
    (263, 10_000, 8, 1, 4, 2, (256, 4, 9_664)),        # even F, ragged group
])
def test_filter_eval_batch_plan(q_n, n, F, D, C, Wv, want):
    """K1's grid: tiles of 128 or 256 rows, a row stride padded to odd,
    query groups no smaller than the target of FILTER_BLOCKS_PER_SM blocks
    per SM needs (each tile is read from L2 once per group), and two
    buffers of at least one query's fields, bounds and live-disjunct count
    beside the tile within the shared-memory limit."""
    got = filter_eval.filter_plan(q_n, n, F, D, C, Wv, 132)
    assert got == want
    rows, group, smem = got
    tiles = -(-n // rows)
    groups = -(-q_n // group)
    target = filter_eval.FILTER_BLOCKS_PER_SM * 132
    assert rows in (128, 256)
    assert (groups - 1) * group < q_n <= groups * group
    per_q = 4 * (D * C * 3 + 1)
    assert rows * (F | 1) * 4 + 2 * per_q <= smem
    assert smem <= filter_eval.FILTER_SMEM_LIMIT
    if tiles * q_n >= target:
        assert tiles * groups >= target
    # no more groups than the target needs, rounded down to whole queries
    assert groups <= max(1, 2 * -(-target // tiles))


@pytest.mark.parametrize("rows,F,want", [(256, 60, 256), (256, 120, 128),
                                         (128, 27, 128)])
def test_filter_eval_batch_plan_shrinks_tiles(monkeypatch, rows, F, want):
    """A tile wider than the shared-memory limit allows halves toward 128
    rows."""
    monkeypatch.setattr(filter_eval, "FILTER_ROWS", rows)
    got, _, smem = filter_eval.filter_plan(256, 105_100, F, 1, 4, 32, 132)
    assert got == want and smem <= filter_eval.FILTER_SMEM_LIMIT


def test_filter_eval_batch_plan_refuses_huge_tables():
    with pytest.raises(ValueError, match="do not fit"):
        filter_eval.filter_plan(256, 105_100, 27, 128, 64, 32, 132)
    with pytest.raises(ValueError, match="do not fit"):
        filter_eval.filter_plan(1, 1000, 300, 1, 4, 8, 132)


def test_top_k_matches_lax_top_k_on_ties():
    x = np.array([[1., 3., 3., 2., 3., -np.inf, -np.inf, 3.4e38, 3.4e38]],
                 np.float32)
    v_t, i_t = tref.top_k(torch.from_numpy(x), 6)
    v_j, i_j = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    v_t, i_t = tref.top_k(torch.from_numpy(-x), 6)
    v_j, i_j = jax.lax.top_k(jnp.asarray(-x), 6)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


def test_ops_sends_cpu_tensors_to_plain_versions(monkeypatch):
    """On CPU tensors the dispatcher runs the plain version and never
    touches a kernel wrapper (which would raise here: no CUDA)."""
    def boom(*a, **k):
        raise AssertionError("kernel wrapper called for a CPU tensor")

    for mod, name in ((filter_eval, "filter_eval_batch"),
                      (filter_eval, "filter_eval"),
                      (fiber_expand, "fiber_expand_walk"),
                      (fiber_expand, "fiber_expand"),
                      (masked_cosine_topk, "masked_cosine_topk")):
        monkeypatch.setattr(mod, name, boom)
    before = dict(build.LAUNCHES)
    corpus, queries, bitmap = _mk(200, 16, 3, seed=2)
    ids = np.random.default_rng(2).integers(-1, 200, (3, 7)).astype(np.int32)
    meta = _meta(200, 6, 3)
    f_np, a_np = _conj_tables(6, 4)
    args = (_t(queries), _t(corpus), _t(bitmap))
    for got, want in zip(ops.masked_cosine_topk(*args, 5),
                         tref.masked_cosine_topk(*args, 5)):
        assert torch.equal(got, want)
    walk_args = (_t(queries), _t(corpus), _t(ids), _t(bitmap))
    for got, want in zip(ops.fiber_expand_walk(*walk_args),
                         tref.fiber_expand_walk(*walk_args)):
        assert torch.equal(got, want)
    assert torch.equal(ops.fiber_expand(*walk_args),
                       tref.fiber_expand(*walk_args))
    fargs = (_t(meta), _t(f_np), _t(a_np))
    assert torch.equal(ops.filter_eval_batch(*fargs),
                       tref.filter_eval_batch(*fargs))
    one = tuple(_t(x) for x in _single_tables("active", 1))
    assert torch.equal(ops.filter_eval(_t(meta), *one),
                       tref.filter_eval(_t(meta), *one))
    assert dict(build.LAUNCHES) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs the plain version: handed CPU tensors
    it raises before building or launching anything."""
    corpus, queries, bitmap = _mk(64, 8, 2, seed=1)
    ids = np.zeros((2, 3), np.int32)
    with pytest.raises(ValueError, match="CUDA"):
        masked_cosine_topk.masked_cosine_topk(_t(queries), _t(corpus),
                                              _t(bitmap), 4)
    with pytest.raises(ValueError, match="CUDA"):
        fiber_expand.fiber_expand_walk(_t(queries), _t(corpus), _t(ids),
                                       _t(bitmap))
    with pytest.raises(ValueError, match="CUDA"):
        fiber_expand.fiber_expand(_t(queries), _t(corpus), _t(ids),
                                  _t(bitmap))
    f_np, a_np = _conj_tables(6, 1)
    with pytest.raises(ValueError, match="CUDA"):
        filter_eval.filter_eval_batch(_t(_meta(64, 6, 1)), _t(f_np),
                                      _t(a_np))
    one = tuple(_t(x) for x in _single_tables("active", 1))
    with pytest.raises(ValueError, match="CUDA"):
        filter_eval.filter_eval(_t(_meta(64, 6, 1)), *one)
