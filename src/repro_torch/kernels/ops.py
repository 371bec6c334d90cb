"""Device dispatch for the kernels.

A CPU tensor goes to the plain PyTorch version (``kernels/ref.py``); a
CUDA tensor launches the hand-written kernel, which either runs or
raises: there is no fallback from a CUDA tensor to the plain version.
Any other device raises. ``predicate_tables`` converts a conjunctive
``FilterPredicate`` into the dense clause tables ``filter_eval`` takes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.config import AtlasConfig, KernelConfig
from repro_torch.kernels import fiber_expand as _fe
from repro_torch.kernels import filter_eval as _fv
from repro_torch.kernels import masked_cosine_topk as _mct
from repro_torch.kernels import ref
from repro_torch.kernels import walk_round as _wr

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


def walk_round(vectors, adjacency, pass_bm, q_vecs, seeds, res_v, res_i, p):
    """One restart round of the walk from carried results (res_v, res_i):
    the ``walk_round`` kernel on CUDA tensors; on the CPU its plain
    version, ``walk_batch``, which reads its loop exit on the host."""
    if _on_cuda(vectors, "walk_round"):
        return _wr.walk_round(vectors, adjacency, pass_bm, q_vecs, seeds,
                              res_v, res_i, p)
    from repro_torch.core.batched.engine import walk_batch
    return walk_batch(vectors, adjacency, pass_bm, q_vecs, seeds, p,
                      init_results=(res_v, res_i))


def filter_eval_batch(metadata, fields, allowed, n_disj=None, bounds=None):
    if _on_cuda(metadata, "filter_eval_batch"):
        return _fv.filter_eval_batch(metadata, fields, allowed, n_disj,
                                     bounds)
    return ref.filter_eval_batch(metadata, fields, allowed, n_disj, bounds)


def fiber_expand(q_vecs, corpus, ids, bitmap):
    if _on_cuda(corpus, "fiber_expand"):
        return _fe.fiber_expand(q_vecs, corpus, ids, bitmap)
    return ref.fiber_expand(q_vecs, corpus, ids, bitmap)


def filter_eval(metadata, fields, allowed):
    if _on_cuda(metadata, "filter_eval"):
        return _fv.filter_eval(metadata, fields, allowed)
    return ref.filter_eval(metadata, fields, allowed)


def predicate_tables(pred, n_fields: int,
                     max_clauses: int = MAX_CLAUSES,
                     v_cap: int = V_CAP) -> tuple[np.ndarray, np.ndarray]:
    """FilterPredicate -> (fields (C,) i32, allowed (C, v_cap) u8)."""
    fields = np.full(max_clauses, -1, np.int32)
    allowed = np.zeros((max_clauses, v_cap), np.uint8)
    for i, (f, vals) in enumerate(pred.clauses[:max_clauses]):
        fields[i] = f
        for v in vals:
            if 0 <= v < v_cap:
                allowed[i, v] = 1
    return fields, allowed
