"""Packed bitmaps for the lockstep walk state (DESIGN.md §3), on
``torch.int32`` words.

The layout is the reference's: bit ``i`` of word ``w`` holds entry
``32*w + i`` and pad bits beyond ``n`` are 0. Words are int32 because
torch's uint32 has no ``>>``, no ``arange`` and no scatter; the bit
pattern is identical, so ``bm.numpy().view(np.uint32)`` is the
reference's uint32 bitmap. Shifts of a word therefore go through int64
lanes (``& 0xFFFFFFFF`` first) so a set sign bit never smears into the
bits below it.

``set_bits`` is a scatter-OR built from scatter-add: it dedupes indices
within a row and drops already-set bits first, so ``add == or`` exactly.
"""
from __future__ import annotations

import torch

_LOW32 = 0xFFFFFFFF


def n_words(n: int) -> int:
    """Words needed to hold ``n`` bits."""
    return -(-n // 32)


def to_int32_words(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 word with the same bits."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _u32(bm: torch.Tensor) -> torch.Tensor:
    """int32 words -> their unsigned value in int64 lanes."""
    return bm.to(torch.int64) & _LOW32


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """``(..., n) bool -> (..., ceil(n/32)) int32``; bit i of word w is
    entry 32*w + i. Pad bits (beyond n) are 0."""
    *lead, n = mask.shape
    pad = (-n) % 32
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, pad))
    m = m.reshape(*lead, -1, 32)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) \
        << torch.arange(32, device=mask.device)
    return to_int32_words((m * weights).sum(-1))


def unpack_bits(bm: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., W) int32 -> (..., n) bool`` (inverse of ``pack_bits``)."""
    shifts = torch.arange(32, device=bm.device)
    bits = (_u32(bm)[..., None] >> shifts) & 1
    flat = bits.reshape(*bm.shape[:-1], bm.shape[-1] * 32)
    return flat[..., :n].to(torch.bool)


def test_bits(bm: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather bits: ``bm (Q, W) int32``, ``idx (Q, m) int32`` ->
    ``(Q, m) bool``. Negative indices test False (pad convention)."""
    safe = idx.clamp(min=0).to(torch.int64)
    word = torch.gather(bm, 1, safe >> 5)
    bit = (_u32(word) >> (safe & 31)) & 1
    return bit.to(torch.bool) & (idx >= 0)


# not a test: keep pytest from collecting the helper if a test module
# imports it by name
test_bits.__test__ = False


def set_bits(bm: torch.Tensor, idx: torch.Tensor,
             on: torch.Tensor) -> torch.Tensor:
    """Scatter-OR: set bit ``idx[q, j]`` of row q where ``on[q, j]``.

    Negative indices are ignored. Safe for duplicate indices within a row
    and for bits that are already set: only the first ``on`` occurrence of
    a not-yet-set index contributes ``1 << (idx & 31)`` to its word, so the
    underlying scatter-add equals a bitwise OR. Returns a new tensor.
    """
    _, m = idx.shape
    safe = idx.clamp(min=0).to(torch.int64)
    on = on & (idx >= 0) & ~test_bits(bm, idx)
    # dup[q, j] <=> an earlier position i<j carries the same index with on
    eq = safe[:, :, None] == safe[:, None, :]            # [q, i, j]
    ar = torch.arange(m, device=idx.device)
    earlier = ar[:, None] < ar[None, :]
    dup = (eq & on[:, :, None] & earlier[None]).any(dim=1)
    add = torch.where(on & ~dup, torch.ones_like(safe) << (safe & 31),
                      torch.zeros_like(safe))
    out = _u32(bm).scatter_add(1, safe >> 5, add)
    return to_int32_words(out)


def popcount(bm: torch.Tensor) -> torch.Tensor:
    """``(..., W) int32 -> (...,) int32`` total set bits (SWAR per word,
    in int64 lanes so the shifts are logical)."""
    x = _u32(bm)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    per_word = ((x * 0x01010101) & _LOW32) >> 24
    return per_word.sum(-1).to(torch.int32)
