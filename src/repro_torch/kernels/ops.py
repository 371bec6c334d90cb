"""Device dispatch for the main-path kernels.

A CPU tensor goes to the plain PyTorch version (``kernels/ref.py``); a
CUDA tensor launches the hand-written kernel, which either runs or
raises: there is no fallback from a CUDA tensor to the plain version.
Any other device raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.config import AtlasConfig, KernelConfig
from repro_torch.kernels import fiber_expand as _fe
from repro_torch.kernels import filter_eval as _fv
from repro_torch.kernels import masked_cosine_topk as _mct
from repro_torch.kernels import ref

# module-level names derived from the one config origin (core/config.py)
MAX_CLAUSES = KernelConfig().max_clauses
V_CAP = AtlasConfig().v_cap_min


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for device "
                     f"{t.device}")


def masked_cosine_topk(queries, corpus, bitmap, k: int):
    if _on_cuda(corpus, "masked_cosine_topk"):
        return _mct.masked_cosine_topk(queries, corpus, bitmap, k)
    return ref.masked_cosine_topk(queries, corpus, bitmap, k)


def fiber_expand_walk(q_vecs, corpus, ids, bitmap):
    if _on_cuda(corpus, "fiber_expand_walk"):
        return _fe.fiber_expand_walk(q_vecs, corpus, ids, bitmap)
    return ref.fiber_expand_walk(q_vecs, corpus, ids, bitmap)


def filter_eval_batch(metadata, fields, allowed, n_disj=None, bounds=None):
    if _on_cuda(metadata, "filter_eval_batch"):
        return _fv.filter_eval_batch(metadata, fields, allowed, n_disj,
                                     bounds)
    return ref.filter_eval_batch(metadata, fields, allowed, n_disj, bounds)
