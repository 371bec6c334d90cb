"""Attention: chunked (flash-style) softmax for prefill and encode, plain
decode attention over a cache, and the flash-decode combine for a cache
whose sequence is split over a mesh axis (long-context serving).

The chunked form never materializes the (S, S) score matrix: a loop over
query blocks and an inner loop over KV blocks carry running (max, sum,
acc), the standard online-softmax recurrence. The reference computes both
functions in plain jnp outside any Pallas kernel; the port computes the
same function in plain torch ops (not ``scaled_dot_product_attention``,
whose blocking and rounding are its own), under autograd for the training
loss.
"""
from __future__ import annotations

import torch

from repro_torch.launch.placement import (NamedSharding, P, Sharded, place,
                                          run_cells)
from repro_torch.models import settings

NEG_INF = -1e30


def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: int) -> torch.Tensor:
    """(qc, kc) bool mask. ``window`` <= 0 means unbounded lookback (full
    attention)."""
    diff = q_pos[:, None] - k_pos[None, :]
    m = diff < (window if window > 0 else 1 << 30)
    if causal:
        m &= diff >= 0
    return m


def _scaled(s: torch.Tensor, hd: int) -> torch.Tensor:
    """Scores times hd**-0.5 in the scores' dtype, the scale rounded to
    that dtype first, as jnp does with a Python scalar (torch would keep
    it in fp32); then fp32 for the softmax."""
    return (s * torch.tensor(hd ** -0.5, dtype=s.dtype)).float()


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); GQA via H % KV == 0
    (query head h reads KV head h // G).

    ``q_offset``: absolute position of q[0] (for prefill continuation).
    Sq and Sk may differ (cross-attention, ``causal=False``). Returns
    (B, Sq, H, hd).
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if settings.UNROLL_SCANS:  # accounting mode: coarse blocks, same FLOPs
        q_chunk, kv_chunk = settings.ACCT_Q_CHUNK, settings.ACCT_KV_CHUNK
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    if Sq % q_chunk or Sk % kv_chunk:
        raise ValueError(f"chunked_attention: Sq={Sq} and Sk={Sk} must be "
                         f"multiples of their chunks ({q_chunk}, "
                         f"{kv_chunk})")
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, hd)
    outs = []   # one block a query chunk, joined once (no in-place writes
    # for autograd to track)
    for q0 in range(0, Sq, q_chunk):
        qblk = qg[:, q0:q0 + q_chunk]                       # (B,qc,KV,G,hd)
        q_pos = q_offset + q0 + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, q_chunk), device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, hd), device=dev)
        for k0 in range(0, Sk, kv_chunk):
            kblk = k[:, k0:k0 + kv_chunk]                   # (B,kc,KV,hd)
            vblk = v[:, k0:k0 + kv_chunk]
            k_pos = k0 + torch.arange(kv_chunk, device=dev)
            s = _scaled(torch.einsum("bqkgh,bckh->bkgqc", qblk, kblk), hd)
            mask = _block_mask(q_pos, k_pos, causal, window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bckh->bkgqh", p.to(vblk.dtype), vblk)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        # (B, KV, G, qc, hd) -> (B, qc, KV, G, hd)
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     window: int = 0) -> torch.Tensor:
    """Single-step decode. q: (B, 1, H, hd); caches: (B, S, KV, hd).

    ``cache_len``: count of valid positions (new token included).
    """
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, hd)
    s = _scaled(torch.einsum("bkgh,bskh->bkgs", qr, k_cache), hd)
    pos = torch.arange(S, device=q.device)
    valid = pos < cache_len
    if window > 0:
        valid &= pos >= cache_len - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd)


def flash_decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: int, base: int,
                         cell, seq_axis: str, window: int = 0) -> torch.Tensor:
    """One cell's part of ``flash_decode_sharded``: the online softmax of
    ``q`` (B, 1, H, hd) over its cache slice (B, S_loc, KV, hd), which
    holds positions ``base`` ..., combined with the other cells' along
    ``seq_axis`` by one pmax and two psums. A slice wholly past
    ``cache_len`` scores NEG_INF everywhere (finite, so its ``p`` is 1),
    and only its weight exp(m - max m) = 0 removes it. Returns the
    attention over the whole cache (B, 1, H, hd)."""
    B, _, H, hd = q.shape
    S_loc, KV = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(B, KV, H // KV, hd)
    s = _scaled(torch.einsum("bkgh,bskh->bkgs", qr, k_cache), hd)
    pos = base + torch.arange(S_loc, device=q.device)
    valid = pos < cache_len
    if window > 0:
        valid &= pos >= cache_len - window
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)                                   # (B, KV, G)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    pv = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype), v_cache)
    g_m = cell.pmax(m, seq_axis)
    corr = torch.exp(m - g_m)
    l_g = cell.psum(l * corr, seq_axis)
    pv_g = cell.psum(pv.float() * corr[..., None], seq_axis)
    out = pv_g / torch.clamp(l_g, min=1e-30)[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)


def flash_decode_sharded(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: int, *, mesh,
                         seq_axis: str, window: int = 0) -> torch.Tensor:
    """Decode attention over a cache whose SEQUENCE dim is split over
    ``seq_axis`` of ``mesh`` (the reference's shard_map flash decode):
    ``q`` (B, 1, H, hd) on every cell, each cell's block of the caches
    (B, S, KV, hd) — tensors, placed here, or ``Sharded`` already on
    ``P(None, seq_axis)`` — reduced by ``flash_decode_partial``. Returns
    the result (B, 1, H, hd) on the mesh's first cell."""
    spec = P(None, seq_axis, None, None)
    caches = [c if isinstance(c, Sharded) else
              place(c, NamedSharding(mesh, spec)) for c in (k_cache, v_cache)]
    qs = place(q, NamedSharding(mesh, P()))
    S = caches[0].shape[1]

    def cell_fn(cell):
        kb, vb = caches[0].local(cell), caches[1].local(cell)
        base = cell.block(seq_axis) * (S // cell.size(seq_axis))
        return flash_decode_partial(qs.local(cell), kb, vb, cache_len, base,
                                    cell, seq_axis, window)

    return run_cells(mesh, cell_fn).flat[0]
