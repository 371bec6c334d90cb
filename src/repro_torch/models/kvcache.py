"""Decode-state structures per architecture family, as plain dicts of
stacked (leading L) tensors; ``prefill`` allocates its cache here.

* dense/moe/vlm: full-length K/V per layer (SWA layers mask to the window);
* hybrid (hymba): a K/V ring of ``min(window, S)`` slots + the mamba
  (ssm fp32, conv tail) state;
* ssm (rwkv6): the matrix-valued wkv state (fp32) + the token-shift
  tails, O(1) in S;
* audio (whisper): decoder self K/V (``max_decode_len`` positions by
  default, the reference's layout) + the frozen cross K/V over the
  encoder's output (the spec's length).

Over a mesh of more than one cell the cache is placed by
``cache_shardings``: each leaf ``Sharded``, its blocks views of one
zeroed tensor where the cells share a device. A recurrent state's block
that several cells hold (a dim the model axis does not divide, the shift
tails always) is a copy of its own on each: a decode step reads the old
state and writes the new one in place, and cells sharing one block
would read each other's writes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.device_atlas import resolve_device
from repro_torch.launch.mesh import staging_device
from repro_torch.launch.placement import place
from repro_torch.launch.shardings import cache_shardings
from repro_torch.models import common
from repro_torch.models.mamba import CONV_K


def cache_specs(cfg: ArchConfig, spec: ShapeSpec,
                dec_len: int | None = None) -> dict:
    """Name -> (shape, dtype) of the decode state for ``spec``'s batch
    and sequence length (for audio, the encoder's: the decoder's K/V
    holds ``dec_len`` positions, default ``cfg.max_decode_len``)."""
    B, S = spec.global_batch, spec.seq_len
    L, KV, hd, d = cfg.n_layers, cfg.n_kv_heads, cfg.hd, cfg.d_model
    out = {"pos": ((), torch.int32)}
    if cfg.family == "ssm":
        H, N = d // cfg.rwkv_head_size, cfg.rwkv_head_size
        out.update(wkv=((L, B, H, N, N), torch.float32),
                   shift_tm=((L, B, d), common.CDT),
                   shift_cm=((L, B, d), common.CDT))
        return out
    if cfg.family == "audio":
        C = cfg.max_decode_len if dec_len is None else dec_len
        out.update(k=((L, B, C, KV, hd), common.CDT),
                   v=((L, B, C, KV, hd), common.CDT),
                   ck=((L, B, S, KV, hd), common.CDT),
                   cv=((L, B, S, KV, hd), common.CDT))
        return out
    W = min(cfg.sliding_window or S, S) if cfg.family == "hybrid" else S
    out.update(k=((L, B, W, KV, hd), common.CDT),
               v=((L, B, W, KV, hd), common.CDT))
    if cfg.family == "hybrid":
        d_in = cfg.ssm_expand * d
        out.update(ssm=((L, B, d_in, cfg.ssm_state), torch.float32),
                   conv=((L, B, CONV_K - 1, d_in), common.CDT))
    return out


def init_cache(cfg: ArchConfig, spec: ShapeSpec, device=None,
               dec_len: int | None = None, env=None) -> dict:
    """An empty decode state: zeros on ``device`` (None means CUDA) and
    ``pos`` 0 (the port keeps the position a Python int, so decoding
    reads no device scalar). With ``env`` over a mesh of more than one
    cell (``device`` then None), each leaf placed on it by
    ``cache_shardings``."""
    specs = {name: sd for name, sd in cache_specs(cfg, spec,
                                                  dec_len).items()
             if name != "pos"}
    if env is None or env.cells == 1:
        dev = resolve_device(device)
        return {"pos": 0, **{name: torch.zeros(shape, dtype=dtype,
                                               device=dev)
                             for name, (shape, dtype) in specs.items()}}
    if device is not None:
        raise ValueError("init_cache: pass device=None with a mesh")
    like = {name: torch.empty(shape, dtype=dtype, device="meta")
            for name, (shape, dtype) in specs.items()}
    where = cache_shardings(cfg, env.mesh, like)
    home = staging_device(env.mesh)
    out = {"pos": 0}
    for name, x in like.items():
        leaf = place(torch.zeros(x.shape, dtype=x.dtype, device=home),
                     where[name])
        out[name] = leaf if name in KV_LEAVES else _own_blocks(leaf)
    return out


KV_LEAVES = ("k", "v", "ck", "cv")


def _own_blocks(leaf):
    """``leaf`` with every block that an earlier cell also holds
    replaced by a copy (a ``Sharded``'s blocks, in place)."""
    seen = set()
    for index in np.ndindex(leaf.shards.shape):
        x = leaf.shards[index]
        if id(x) in seen:
            leaf.shards[index] = x.clone()
        seen.add(id(x))
    return leaf
