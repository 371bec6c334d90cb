"""Selective SSM (Mamba-style) head of the Hymba hybrid block.

The state h (B, d_in, N) is fp32, as are dt and A; the conv tail keeps
the activations' dtype. The reference scans in rematted chunks of 256
steps, which bounds its training memory and changes no number; the port
runs every step in one loop, its per-step inputs formed a chunk of
``CHUNK`` steps at a time.

In a cell of a device mesh the layer runs on the cell's block of the
d_in channels (``mamba_forward``'s ``cell``): the scan, conv, dt, D and
gate are per channel, so only the projections into and out of the
channels meet the other cells.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import init_dense

CONV_K = 4
CHUNK = 64   # steps whose discretized inputs are formed together


def dt_rank(d_model: int) -> int:
    """The rank of the dt projection (the reference's recipe)."""
    return max(d_model // 16, 8)


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


def own_channels(p, cell=None) -> bool:
    """Whether a cell runs its own block of the d_in channels (its rows of
    ``out_proj``; ``conv_b`` is whole), its state that block's; else
    every channel."""
    return cell is not None and p.out_proj.shape[0] < p.conv_b.shape[0]


def mamba_forward(p, x: torch.Tensor, state=None, cell=None,
                  axis: str = "model"):
    """x: (B, S, d_model) -> (y (B, S, d_model), state), where state =
    (h (B, d_in, N) fp32, conv tail (B, CONV_K - 1, d_in)).

    In a cell of a mesh (``cell``, with ``x`` its batch block, every
    position and all of d_model) the leaves are the cell's blocks as
    ``param_shardings`` places them. Where ``out_proj``'s rows (the
    channels) are split over ``axis`` the cell runs its block of dc =
    d_in / n channels, and ``state`` is that block's; else every channel.
    What it needs beyond its blocks it gathers over ``axis`` (n cells,
    bytes for one call, received a cell):

    * ``in_proj``'s columns [x | z] are split contiguously, so the first
      half of the cells hold x and the rest z: the cell's product is
      all-gathered, (n - 1)/n of B·S·2·d_in activations, and its x and z
      channels cut from it;
    * ``x_proj`` (d_in, dt_rank + 2N), its columns split where they
      divide: the cells' channels of the conv output are all-gathered,
      (n - 1)/n of B·S·d_in activations, and the cells' columns of the
      product (where split) again, of B·S·(dt_rank + 2N);
    * ``dt_proj`` (dt_rank, d_in), its rows split where they divide: the
      leaf's rows are all-gathered ((n - 1)/n of dt_rank·d_in fp32) and
      the cell's channels' columns taken;
    * ``out_proj``'s product is the cell's partial, summed over ``axis``
      (B·S·d_model activations from each of the n - 1 others).

    Every product runs in the activations' dtype as on one device, over
    the same contraction, so the cells' channels equal the one-device
    pass's up to the sum over ``out_proj``'s rows."""
    B, S, d_model = x.shape
    dt_ = x.dtype
    d_in = p.conv_b.shape[0]          # replicated: the whole width
    n = p.A_log.shape[1]
    split = own_channels(p, cell)
    dc = p.out_proj.shape[0] if split else d_in
    c0 = cell.block(axis) * dc if split else 0
    ch = slice(c0, c0 + dc)

    xz = x @ p.in_proj.to(dt_)
    if cell is not None and xz.shape[-1] < 2 * d_in:
        xz = cell.all_gather(xz, axis, -1)
    xh, z = xz[..., ch], xz[..., d_in + c0:d_in + c0 + dc]
    if state is None:
        h = torch.zeros((B, dc, n), device=x.device)
        tail = torch.zeros((B, CONV_K - 1, dc), dtype=dt_, device=x.device)
    else:
        h, tail = state
    # causal depthwise conv (kernel 4) over time, summed in x's dtype
    xpad = torch.cat([tail, xh], dim=1)
    conv_w = p.conv_w[:, ch].to(dt_)
    xc = xpad[:, 0:S] * conv_w[0]
    for i in range(1, CONV_K):
        xc = xc + xpad[:, i:i + S] * conv_w[i]
    xc = F.silu((xc + p.conv_b[ch].to(dt_)).float()).to(dt_)
    new_tail = xpad[:, S:]

    rank = p.dt_proj.shape[0] if cell is None else dt_rank(d_model)
    proj = (cell.all_gather(xc, axis, -1) if split else xc) \
        @ p.x_proj.to(dt_)
    if proj.shape[-1] < rank + 2 * n:
        proj = cell.all_gather(proj, axis, -1)
    dt, Bc, Cc = proj.split([rank, n, n], dim=-1)
    dt_proj = p.dt_proj
    if dt_proj.shape[0] < rank:
        dt_proj = cell.all_gather(dt_proj, axis, 0)
    dt = F.softplus((dt @ dt_proj[:, ch].to(dt_)).float()
                    + p.dt_bias[ch])                               # fp32
    A = -torch.exp(p.A_log[ch])                                    # (dc, N)
    dtx = dt * xc.float()
    Bf, Cf = Bc.float(), Cc.float()
    ys = []
    for t0 in range(0, S, CHUNK):
        sl = slice(t0, min(t0 + CHUNK, S))
        dA = torch.exp(dt[:, sl, :, None] * A)           # (B, c, dc, N)
        dBx = dtx[:, sl, :, None] * Bf[:, sl, None, :]
        for t in range(dA.shape[1]):
            h = dA[:, t] * h + dBx[:, t]
            ys.append(torch.bmm(h, Cf[:, t0 + t, :, None])[..., 0])
    y = torch.stack(ys, dim=1) + p.D[ch] * xc.float()
    y = (y * F.silu(z.float())).to(dt_)
    out = y @ p.out_proj.to(dt_)
    if split:
        out = cell.psum(out, axis)
    return out, (h, new_tail)
