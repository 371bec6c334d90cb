"""The port's plain kernel versions (``repro_torch.kernels.ref``) vs the
reference's jnp oracles AND its Pallas kernels in interpret mode, on the
shape sweeps of ``tests/test_kernels.py``; plus the dispatcher's CPU route.

Tolerances: K1 (filter_eval_batch) is integer work and must be bit-exact.
K2 (fiber_expand_walk) sims are fp32 dot products summed in a different
order by each framework: allclose at rtol=atol=1e-5, with the -inf
positions identical. K3 (masked_cosine_topk) sims at rtol=atol=1e-4 (the
reference's own kernel-vs-oracle bar), ids equal on tie-free random data,
and a tie-heavy row must give the lowest ids first.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.device_atlas import pack_dnf, pack_predicates
from repro.core.predicate import And, In, Not, Or, Range, as_dnf
from repro.core.types import FilterPredicate
from repro.kernels import ref as jref
from repro.kernels.fiber_expand import fiber_expand_walk as pallas_walk
from repro.kernels.filter_eval import filter_eval_batch as pallas_filter
from repro.kernels.masked_cosine_topk import masked_cosine_topk as pallas_topk
from repro_torch.kernels import fiber_expand, filter_eval, masked_cosine_topk
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

_jref_filter = jax.jit(jref.filter_eval_batch)
_jref_walk = jax.jit(jref.fiber_expand_walk)
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


def _meta(n, F, seed):
    # codes -1 (unpopulated) .. 39
    return np.random.default_rng(seed).integers(-1, 40, (n, F)).astype(
        np.int32)


def _conj_tables(F, seed):
    rng = np.random.default_rng(seed)
    preds = [FilterPredicate.make(
        {int(f): rng.integers(0, 40, rng.integers(1, 4)).tolist()
         for f in rng.choice(F, rng.integers(1, 4), replace=False)})
        for _ in range(4)]
    preds.append(FilterPredicate.make({}))      # unconstrained: pad bits 0
    preds.append(FilterPredicate(((0, ()),)))   # never: matches nothing
    return pack_predicates(preds, max_clauses=4, v_cap=64)


def _dnf_tables(F):
    vocab = [40] * F
    exprs = [Or(In(0, [1, 2]), In(3, [5])),
             And(In(1, [3, 4]), Range(2, 5, 20)),
             Or(Range(4, 0, 3), In(5, [39]), Not(In(1, list(range(30))))),
             Or(), And(), Range(0, 38, None)]
    dnfs = [as_dnf(e, vocab, v_cap=64) for e in exprs]
    f, a, b, nd = pack_dnf(dnfs, max_disjuncts=4, max_clauses=4, v_cap=64)
    return f, a, b, nd, exprs, vocab


def _assert_bits_equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("n", [10, 300, 1000])
def test_filter_eval_conjunctive_bit_exact(n):
    F = 6
    meta = _meta(n, F, n)
    f_np, a_np = _conj_tables(F, n + 1)
    got = tref.filter_eval_batch(_t(meta), _t(f_np), _t(a_np))
    jargs = (jnp.asarray(meta), jnp.asarray(f_np), jnp.asarray(a_np))
    _assert_bits_equal(got, _jref_filter(*jargs))
    _assert_bits_equal(got, pallas_filter(*jargs, tn=64, interpret=True))


@pytest.mark.parametrize("n", [10, 300, 1000])
@pytest.mark.parametrize("with_bounds", [False, True])
def test_filter_eval_dnf_bit_exact(n, with_bounds):
    """DNF tables (dead-disjunct padding, a never() and an always() lane)
    with and without the interval bounds table."""
    F = 6
    meta = _meta(n, F, n + 7)
    f_np, a_np, b_np, nd, exprs, vocab = _dnf_tables(F)
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
                      (fiber_expand, "fiber_expand_walk"),
                      (masked_cosine_topk, "masked_cosine_topk")):
        monkeypatch.setattr(mod, name, boom)
    before = (filter_eval.launches, fiber_expand.launches,
              masked_cosine_topk.launches)
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
    fargs = (_t(meta), _t(f_np), _t(a_np))
    assert torch.equal(ops.filter_eval_batch(*fargs),
                       tref.filter_eval_batch(*fargs))
    assert (filter_eval.launches, fiber_expand.launches,
            masked_cosine_topk.launches) == before


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
    f_np, a_np = _conj_tables(6, 1)
    with pytest.raises(ValueError, match="CUDA"):
        filter_eval.filter_eval_batch(_t(_meta(64, 6, 1)), _t(f_np),
                                      _t(a_np))
