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


def rwkv_time_mix(p, x: torch.Tensor, state, head_size: int):
    """x: (B, S, d). state = (shift last (B, d), wkv (B, H, N, N) fp32)
    or None."""
    B, S, d = x.shape
    H, N = d // head_size, head_size
    dt_ = x.dtype
    if state is None:
        last = torch.zeros((B, d), dtype=dt_, device=x.device)
        s0 = torch.zeros((B, H, N, N), device=x.device)
    else:
        last, s0 = state
    prev, new_last = _shift(x, last)
    mu = p.mu.to(dt_)
    xr, xk, xv, xg, xw = (x + mu[i] * (prev - x) for i in range(5))
    r = xr @ p.wr.to(dt_)
    k = xk @ p.wk.to(dt_)
    v = xv @ p.wv.to(dt_)
    g = xg @ p.wg.to(dt_)
    lora = torch.tanh(xw @ p.w_a.to(dt_)) @ p.w_b.to(dt_)
    w = torch.exp(-torch.exp(p.w0 + lora.float()))

    def hs(t):
        return t.float().reshape(B, S, H, N)

    y, sF = _wkv_scan(hs(r), hs(k), hs(v), w.reshape(B, S, H, N), p.u, s0)
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, unbiased=False)
    y = (y - mean) * torch.rsqrt(var + GN_EPS)
    y = y.reshape(B, S, d) * (1.0 + p.ln_x)
    out = y.to(dt_) * F.silu(g.float()).to(dt_)
    return out @ p.wo.to(dt_), (new_last, sF)


def rwkv_channel_mix(p, x: torch.Tensor, state):
    """state = the last token (B, d) or None."""
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
    r = torch.sigmoid((xr @ p.cm_r.to(dt_)).float()).to(dt_)
    return r * kv, new_last
