"""Shared model building blocks: norms, RoPE, projections, embedding, loss.

Conventions (the reference's):
* params are stored fp32 and cast to bf16 for compute (``CDT``);
* activations flow bf16, residual stream bf16, norms/softmax in fp32;
* a layer's parameters live in its own module of the layer list (the
  reference stacks them under a leading L dim for its scan).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

CDT = torch.bfloat16  # compute dtype


def cast(x):
    """fp32 tensors of a (nested dict/list) tree to ``CDT``; others kept."""
    if isinstance(x, dict):
        return {k: cast(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(cast(v) for v in x)
    return x.to(CDT) if x.dtype == torch.float32 else x


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope_freq(hd: int, theta: float) -> np.ndarray:
    """Rotary frequencies in fp32, computed as the reference does (numpy
    fp32), so both packages rotate by the same angles."""
    half = hd // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.lru_cache(maxsize=None)
def _rope_freq_on(hd: int, theta: float, device: torch.device):
    """``rope_freq`` as a tensor on ``device``, copied there once: a copy
    from host memory per call would wait for the device's queue."""
    return torch.from_numpy(rope_freq(hd, theta)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (..., S)."""
    half = x.shape[-1] // 2
    freq = _rope_freq_on(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].float() * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a TP-shardable multiple (DESIGN.md §4)."""
    return ((v + multiple - 1) // multiple) * multiple


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens].to(CDT)


def unembed_logits(h: torch.Tensor, table: torch.Tensor, real_vocab: int,
                   offset: int = 0) -> torch.Tensor:
    """h @ table.T with padded-id masking; logits fp32 for a stable loss.
    ``table`` holds the rows of ids ``offset``... (a block of the padded
    vocabulary on a mesh cell)."""
    logits = (h @ table.to(CDT).T).float()
    v_pad = table.shape[0]
    if v_pad + offset > real_vocab:
        pad = torch.arange(offset, offset + v_pad,
                           device=logits.device) >= real_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 1e-4) -> torch.Tensor:
    """Stable token-mean cross-entropy (+ z-loss), differentiated as the
    reference's: its max is stopped only where it is subtracted, so the
    gradient of ``lse`` also carries the max's own (split evenly among
    tied maxima, as ``amax`` and jnp's max split it)."""
    m = logits.amax(dim=-1, keepdim=True)
    shifted = logits - m.detach()
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss.mean()


def init_dense(gen: torch.Generator, shape,
               scale: float | None = None) -> torch.Tensor:
    """Normal fp32 weights of std ``scale`` (default 1/sqrt(fan_in)),
    drawn from ``gen`` on its device; on the ``meta`` device, where no
    generator draws, the shape alone."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * s
