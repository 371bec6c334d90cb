"""Decode-state structures, as plain dicts of stacked (leading L) tensors;
``prefill`` allocates its cache here.

Only the dense/vlm layout is ported: full-length K/V per layer (SWA layers
mask to the window). The hybrid ring buffer, the rwkv6 state and whisper's
cross K/V come with their families (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.device_atlas import resolve_device
from repro_torch.models import common
from repro_torch.models.common import check_family


def cache_specs(cfg: ArchConfig, spec: ShapeSpec) -> dict:
    """Name -> (shape, dtype) of the decode state for ``spec``'s batch
    and sequence length."""
    check_family(cfg)
    B, S = spec.global_batch, spec.seq_len
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    return {"pos": ((), torch.int32),
            "k": ((L, B, S, KV, hd), common.CDT),
            "v": ((L, B, S, KV, hd), common.CDT)}


def init_cache(cfg: ArchConfig, spec: ShapeSpec, device=None) -> dict:
    """An empty decode state: zero K/V on ``device`` (None means CUDA)
    and ``pos`` 0 (the port keeps the position a Python int, so decoding
    reads no device scalar)."""
    dev = resolve_device(device)
    out = {name: torch.zeros(shape, dtype=dtype, device=dev)
           for name, (shape, dtype) in cache_specs(cfg, spec).items()
           if name != "pos"}
    return {"pos": 0, **out}
