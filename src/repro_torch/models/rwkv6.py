"""RWKV-6 "Finch": attention-free linear recurrence with data-dependent
decay (arXiv:2404.05892) and a matrix-valued per-head state.

Time-mix per head h with head size N:
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    y_t = r_t (S_{t-1} + diag(u) k_t v_tᵀ)
with w_t = exp(-exp(w0 + tanh(x̃ W_a) W_b)), the LoRA-produced decay.
Channel-mix: r ⊙ (relu(k x W_k)² W_v) with token shift.

r, k, v, w and the state are fp32 (the reference's ``hs`` casts), as is
the per-head groupnorm; the projections run in the activations' dtype.
The reference scans in rematted chunks of 256 steps, which changes no
number; the port runs every step in one loop.

In a cell of a device mesh (``cell``, its model axis ``axis``) the leaves
are the cell's blocks as ``param_shardings`` places them: ``wr``, ``wk``,
``wv``, ``wg`` and ``cm_k`` by column, ``wo``, ``cm_v`` and ``cm_r`` by
row, where the width divides the axis; the rest whole. ``x`` is the
cell's batch block, every position and all of d.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import init_dense

LORA_R = 64
GN_EPS = 64e-5


def init_rwkv_layer(gen: torch.Generator, d: int, d_ff: int,
                    head_size: int) -> dict:
    """The reference's flat leaves and recipe, drawn from ``gen``."""
    dev = gen.device
    H = d // head_size

    def dense(*shape, scale=None):
        return init_dense(gen, shape, scale)

    return {
        "mu": dense(5, d, scale=0.1),           # r, k, v, g, w shifts
        "w0": torch.full((d,), -2.0, device=dev),
        "w_a": dense(d, LORA_R, scale=0.01),
        "w_b": dense(LORA_R, d, scale=0.01),
        "u": dense(H, head_size, scale=0.1),    # bonus
        "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
        "wg": dense(d, d), "wo": dense(d, d),
        "ln_x": torch.zeros(d, device=dev),     # per-head groupnorm
        "cm_mu": dense(2, d, scale=0.1),        # channel-mix k, r shifts
        "cm_k": dense(d, d_ff), "cm_v": dense(d_ff, d), "cm_r": dense(d, d),
    }


def _shift(x: torch.Tensor, last: torch.Tensor):
    """Token shift: x_{t-1} with ``last`` (B, d) as t = -1. Returns the
    shifted sequence and the new last token."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1), x[:, -1]


def _wkv_scan(r, k, v, w, u, s):
    """r, k, v, w: (B, S, H, N) fp32 (w the decay in (0, 1)); u: (H, N);
    s: (B, H, N, N). Returns y (B, S, H, N) and the final state."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]         # (B,H,N,N)
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t],
                               s + u[..., None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def own_heads(p, head_size: int, cell=None) -> bool:
    """Whether a cell runs its own block of heads: its columns of ``wr``
    (and ``wk``, ``wv``, ``wg``) are fewer than d and hold whole heads.
    Its ``wkv`` is then that block of heads; else every head."""
    d_loc = p.wr.shape[1]
    return cell is not None and d_loc < p.wr.shape[0] \
        and d_loc % head_size == 0


def rwkv_time_mix(p, x: torch.Tensor, state, head_size: int, cell=None,
                  axis: str = "model"):
    """x: (B, S, d). state = (shift last (B, d), wkv (B, H, N, N) fp32)
    or None.

    In a cell whose block of ``wr``..``wg`` holds whole heads (d / n
    columns, n cells on ``axis``) it runs those heads: the decay LoRA
    whole (``w_a``, ``w_b`` replicated), then cut to the heads' columns,
    as are ``u`` and ``ln_x``, and the per-head group norm stays local;
    ``wkv`` is the heads' block. Where the columns cut heads apart (d / n
    not a multiple of the head size) the cell all-gathers r, k, v and g
    over ``axis`` ((n - 1)/n of 4·B·S·d activations) and runs every
    head, its ``wkv`` whole. Either way ``wo``'s product is the cell's
    partial over its rows, summed over ``axis`` (B·S·d from each of the
    n - 1 others)."""
    B, S, d = x.shape
    H, N = d // head_size, head_size
    dt_ = x.dtype
    d_loc = p.wr.shape[1]
    split = cell is not None and d_loc < d
    c0 = cell.block(axis) * d_loc if split else 0
    gathered = split and not own_heads(p, N, cell)
    cols = slice(0, d) if gathered or not split else slice(c0, c0 + d_loc)
    Hc = (cols.stop - cols.start) // N
    if state is None:
        last = torch.zeros((B, d), dtype=dt_, device=x.device)
        s0 = torch.zeros((B, Hc, N, N), device=x.device)
    else:
        last, s0 = state
    prev, new_last = _shift(x, last)
    mu = p.mu.to(dt_)
    xr, xk, xv, xg, xw = (x + mu[i] * (prev - x) for i in range(5))
    r = xr @ p.wr.to(dt_)
    k = xk @ p.wk.to(dt_)
    v = xv @ p.wv.to(dt_)
    g = xg @ p.wg.to(dt_)
    if gathered:
        r, k, v, g = (cell.all_gather(t, axis, -1) for t in (r, k, v, g))
    lora = torch.tanh(xw @ p.w_a.to(dt_)) @ p.w_b.to(dt_)
    w = torch.exp(-torch.exp(p.w0[cols] + lora[..., cols].float()))

    def hs(t):
        return t.float().reshape(B, S, Hc, N)

    heads = slice(cols.start // N, cols.stop // N)
    y, sF = _wkv_scan(hs(r), hs(k), hs(v), w.reshape(B, S, Hc, N),
                      p.u[heads], s0)
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, unbiased=False)
    y = (y - mean) * torch.rsqrt(var + GN_EPS)
    y = y.reshape(B, S, Hc * N) * (1.0 + p.ln_x[cols])
    out = y.to(dt_) * F.silu(g.float()).to(dt_)
    if gathered:
        out = out[..., c0:c0 + d_loc]
    out = out @ p.wo.to(dt_)
    return (cell.psum(out, axis) if split else out), (new_last, sF)


def rwkv_channel_mix(p, x: torch.Tensor, state, cell=None,
                     axis: str = "model", d_ff: int = 0):
    """state = the last token (B, d) or None.

    In a cell, ``cm_k``'s columns and ``cm_v``'s rows are its block of
    the hidden width ``d_ff`` where they are split (``cm_v`` holds fewer
    rows): the product's partial is summed over
    ``axis`` (B·S·d from each of the n - 1 others). ``cm_r``'s rows are
    its block of d where d splits: its partial over the cell's columns of
    the shifted input is summed over ``axis`` (B·S·d) before the
    sigmoid."""
    B, S, d = x.shape
    dt_ = x.dtype
    last = torch.zeros((B, d), dtype=dt_, device=x.device) \
        if state is None else state
    prev, new_last = _shift(x, last)
    mu = p.cm_mu.to(dt_)
    xk = x + mu[0] * (prev - x)
    xr = x + mu[1] * (prev - x)
    k = torch.square(F.relu((xk @ p.cm_k.to(dt_)).float())).to(dt_)
    kv = k @ p.cm_v.to(dt_)
    if cell is not None and p.cm_v.shape[0] < d_ff:
        kv = cell.psum(kv, axis)
    rows = p.cm_r.shape[0]
    if cell is not None and rows < d:
        c0 = cell.block(axis) * rows
        r = cell.psum(xr[..., c0:c0 + rows] @ p.cm_r.to(dt_), axis)
    else:
        r = xr @ p.cm_r.to(dt_)
    r = torch.sigmoid(r.float()).to(dt_)
    return r * kv, new_last
