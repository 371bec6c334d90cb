"""Selective SSM (Mamba-style) head of the Hymba hybrid block.

The state h (B, d_in, N) is fp32, as are dt and A; the conv tail keeps
the activations' dtype. The reference scans in rematted chunks of 256
steps, which bounds its training memory and changes no number; the port
runs every step in one loop, its per-step inputs formed a chunk of
``CHUNK`` steps at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import init_dense

CONV_K = 4
CHUNK = 64   # steps whose discretized inputs are formed together


def init_mamba(gen: torch.Generator, d_model: int, d_in: int, n_state: int,
               dt_rank: int) -> dict:
    """The reference's leaves and recipe, drawn from ``gen``."""
    dev = gen.device
    a = torch.arange(1, n_state + 1, dtype=torch.float32,
                     device=dev).repeat(d_in, 1)
    return {
        "in_proj": init_dense(gen, (d_model, 2 * d_in)),
        "conv_w": init_dense(gen, (CONV_K, d_in), scale=0.5),
        "conv_b": torch.zeros(d_in, device=dev),
        "x_proj": init_dense(gen, (d_in, dt_rank + 2 * n_state)),
        "dt_proj": init_dense(gen, (dt_rank, d_in)),
        "dt_bias": torch.full((d_in,), -4.0, device=dev),
        "A_log": torch.log(a),
        "D": torch.ones(d_in, device=dev),
        "out_proj": init_dense(gen, (d_in, d_model)),
    }


def mamba_forward(p, x: torch.Tensor, state=None):
    """x: (B, S, d_model) -> (y (B, S, d_model), state), where state =
    (h (B, d_in, N) fp32, conv tail (B, CONV_K - 1, d_in))."""
    B, S, _ = x.shape
    dt_ = x.dtype
    d_in = p.conv_b.shape[0]
    n = p.A_log.shape[1]
    dt_rank = p.dt_proj.shape[0]

    xh, z = (x @ p.in_proj.to(dt_)).split(d_in, dim=-1)
    if state is None:
        h = torch.zeros((B, d_in, n), device=x.device)
        tail = torch.zeros((B, CONV_K - 1, d_in), dtype=dt_, device=x.device)
    else:
        h, tail = state
    # causal depthwise conv (kernel 4) over time, summed in x's dtype
    xpad = torch.cat([tail, xh], dim=1)
    conv_w = p.conv_w.to(dt_)
    xc = xpad[:, 0:S] * conv_w[0]
    for i in range(1, CONV_K):
        xc = xc + xpad[:, i:i + S] * conv_w[i]
    xc = F.silu((xc + p.conv_b.to(dt_)).float()).to(dt_)
    new_tail = xpad[:, S:]

    dt, Bc, Cc = (xc @ p.x_proj.to(dt_)).split([dt_rank, n, n], dim=-1)
    dt = F.softplus((dt @ p.dt_proj.to(dt_)).float() + p.dt_bias)  # fp32
    A = -torch.exp(p.A_log)                                        # (d_in, N)
    dtx = dt * xc.float()
    Bf, Cf = Bc.float(), Cc.float()
    ys = []
    for c0 in range(0, S, CHUNK):
        sl = slice(c0, min(c0 + CHUNK, S))
        dA = torch.exp(dt[:, sl, :, None] * A)           # (B, c, d_in, N)
        dBx = dtx[:, sl, :, None] * Bf[:, sl, None, :]
        for t in range(dA.shape[1]):
            h = dA[:, t] * h + dBx[:, t]
            ys.append(torch.bmm(h, Cf[:, c0 + t, :, None])[..., 0])
    y = torch.stack(ys, dim=1) + p.D * xc.float()
    y = (y * F.silu(z.float())).to(dt_)
    return y @ p.out_proj.to(dt_), (h, new_tail)
