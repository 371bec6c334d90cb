"""The port's int32-word bitmap helpers vs the reference's uint32 ones on
the same random masks: identical words (through a uint32 view) for pack
and scatter-OR, identical bools for unpack/test, identical popcounts —
including duplicate indices in one scatter, already-set bits, negative
(pad) indices, set sign bits, and n not a multiple of 32."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.batched import bitmap as _rb
from repro_torch.core.batched import bitmap as pb
from repro_torch.interop import bitmap_to_numpy, bitmap_to_torch


class rb:
    """The reference helpers, each jitted whole (one compile per shape
    instead of one per primitive)."""
    pack_bits = staticmethod(jax.jit(_rb.pack_bits))
    unpack_bits = staticmethod(jax.jit(_rb.unpack_bits, static_argnums=1))
    test_bits = staticmethod(jax.jit(_rb.test_bits))
    set_bits = staticmethod(jax.jit(_rb.set_bits))
    popcount = staticmethod(jax.jit(_rb.popcount))


# (queries, bits, seed): n on both sides of word edges, one and many rows
CASES = [(1, 1, 0), (2, 31, 1), (3, 32, 2), (4, 33, 3), (2, 150, 4),
         (5, 200, 5)]


def _rand_mask(rng, q, n):
    return rng.random((q, n)) < rng.random()


def _words(bm: torch.Tensor) -> np.ndarray:
    return bitmap_to_numpy(bm)


def _port(words_u32: np.ndarray) -> torch.Tensor:
    return bitmap_to_torch(words_u32, "cpu")


@pytest.mark.parametrize("q,n,seed", CASES)
def test_pack_unpack_match_reference(q, n, seed):
    rng = np.random.default_rng(seed)
    mask = _rand_mask(rng, q, n)
    want = np.asarray(rb.pack_bits(jnp.asarray(mask)))
    got = pb.pack_bits(torch.from_numpy(mask))
    assert got.dtype == torch.int32 and tuple(got.shape) == (q, pb.n_words(n))
    np.testing.assert_array_equal(_words(got), want)
    np.testing.assert_array_equal(pb.unpack_bits(got, n).numpy(), mask)
    np.testing.assert_array_equal(
        pb.unpack_bits(got, n).numpy(),
        np.asarray(rb.unpack_bits(jnp.asarray(want), n)))


@pytest.mark.parametrize("q,n,seed", CASES)
def test_test_bits_match_reference(q, n, seed):
    rng = np.random.default_rng(seed)
    mask = _rand_mask(rng, q, n)
    idx = rng.integers(-1, n, (q, 13)).astype(np.int32)
    words = np.asarray(rb.pack_bits(jnp.asarray(mask)))
    want = np.asarray(rb.test_bits(jnp.asarray(words), jnp.asarray(idx)))
    got = pb.test_bits(_port(words), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q,n,seed", CASES)
def test_set_bits_match_reference(q, n, seed):
    """Scatter-OR with duplicate indices (a slice of idx concatenated onto
    itself), off flags, pad indices and bits already set."""
    rng = np.random.default_rng(seed)
    mask = _rand_mask(rng, q, n)
    m = 11
    idx = rng.integers(-1, n, (q, m)).astype(np.int32)
    idx = np.concatenate([idx, idx[:, : m // 2 + 1]], axis=1)
    on = rng.random(idx.shape) < 0.7
    words = np.asarray(rb.pack_bits(jnp.asarray(mask)))
    want = np.asarray(rb.set_bits(jnp.asarray(words), jnp.asarray(idx),
                                  jnp.asarray(on)))
    got = pb.set_bits(_port(words), torch.from_numpy(idx),
                      torch.from_numpy(on))
    np.testing.assert_array_equal(_words(got), want)


@pytest.mark.parametrize("q,n,seed", CASES)
def test_popcount_matches_reference(q, n, seed):
    rng = np.random.default_rng(seed)
    mask = _rand_mask(rng, q, n)
    words = np.asarray(rb.pack_bits(jnp.asarray(mask)))
    got = pb.popcount(_port(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(rb.popcount(jnp.asarray(words))))
    np.testing.assert_array_equal(got.numpy(), mask.sum(axis=1))


def test_sign_bit_words():
    """Bit 31 set makes the int32 word negative: shifts must stay logical
    (no sign smear into lower bits) in every helper."""
    words = np.array([[0x80000000, 0xFFFFFFFF, 0x80000001, 0]], np.uint32)
    bm = _port(words)
    n = 32 * words.shape[1]
    want = np.asarray(rb.unpack_bits(jnp.asarray(words), n))
    np.testing.assert_array_equal(pb.unpack_bits(bm, n).numpy(), want)
    assert int(pb.popcount(bm)[0]) == 1 + 32 + 2
    idx = np.array([[31, 30, 63, 64, 95, 127, -1]], np.int32)
    np.testing.assert_array_equal(
        pb.test_bits(bm, torch.from_numpy(idx)).numpy(),
        np.asarray(rb.test_bits(jnp.asarray(words), jnp.asarray(idx))))
    on = np.ones_like(idx, bool)
    np.testing.assert_array_equal(
        _words(pb.set_bits(bm, torch.from_numpy(idx), torch.from_numpy(on))),
        np.asarray(rb.set_bits(jnp.asarray(words), jnp.asarray(idx),
                               jnp.asarray(on))))


def test_set_bits_is_idempotent_or():
    rng = np.random.default_rng(3)
    mask = _rand_mask(rng, 3, 90)
    idx = torch.from_numpy(rng.integers(0, 90, (3, 20)).astype(np.int32))
    on = torch.ones((3, 20), dtype=torch.bool)
    once = pb.set_bits(pb.pack_bits(torch.from_numpy(mask)), idx, on)
    twice = pb.set_bits(once, idx, on)
    assert torch.equal(once, twice)
