"""K1: predicate evaluation -> packed pass bitmaps (``csrc/filter_eval.cu``).

``filter_eval_batch`` launches the hand-written CUDA kernel on CUDA
tensors; ``kernels.ref.filter_eval_batch`` is the plain PyTorch version
of the same function (the CPU path and the kernel's bit-exact target). The
dispatcher in ``kernels/ops.py`` picks between them by device.

Clause tables are the packers' (``core/device_atlas.py``): conjunctive
fields (Q, C) i32 with -1 = inactive clause, or disjunctive (Q, D, C) with
``DEAD_DISJUNCT`` marking the padding tail; allowed value bitmaps as int32
words (Q, [D,] C, Wv); optional interval bounds (Q, D, C, 2) i32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.batched.bitmap import n_words
from repro_torch.kernels import build

# disjunct-table sentinel (shared with the packers in core.device_atlas):
# a fields entry of -1 is an inactive clause inside a live disjunct
# (conjunction over nothing = pass), DEAD_DISJUNCT marks the padding tail
# of dead disjuncts (contributes False to the union). Live disjuncts pack
# densely from 0, so the per-query count is recoverable from the table.
DEAD_DISJUNCT = -2

# kernel launches since the count was last set to 0 (read by the smoke
# test to show the main path went through the kernel)
launches = 0

_C_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,       # meta, n, F
           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # tables
           ctypes.c_void_p,                                    # n_disj
           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_void_p]                   # out, stream


def table_n_disj(fields: torch.Tensor) -> torch.Tensor:
    """(Q, D, C) fields table -> (Q,) i32 live-disjunct counts."""
    return (fields[:, :, 0] > DEAD_DISJUNCT).sum(dim=1).to(torch.int32)


def filter_eval_batch(metadata: torch.Tensor, fields: torch.Tensor,
                      allowed: torch.Tensor,
                      n_disj: torch.Tensor | None = None,
                      bounds: torch.Tensor | None = None) -> torch.Tensor:
    """The CUDA kernel: same contract as ``ref.filter_eval_batch``;
    every tensor must be a contiguous int32 tensor on one CUDA device.
    Returns (Q, ceil(n/32)) int32 pass bitmaps, pad bits 0."""
    global launches
    what = "filter_eval_batch"
    if fields.ndim == 2:  # conjunctive form = one live disjunct
        q_n, C = fields.shape
        D = 1
        if bounds is not None:
            raise ValueError(f"{what}: bounds need (Q, D, C) tables")
        n_disj = torch.ones(q_n, dtype=torch.int32, device=fields.device)
    elif fields.ndim == 3:
        q_n, D, C = fields.shape
        if n_disj is None:
            n_disj = table_n_disj(fields)
    else:
        raise ValueError(f"{what}: fields must be (Q, C) or (Q, D, C)")
    n_disj = n_disj.to(torch.int32).contiguous()
    n, F = metadata.shape
    Wv = allowed.shape[-1]
    if allowed.shape != (*fields.shape, Wv):
        raise ValueError(f"{what}: allowed {tuple(allowed.shape)} does not "
                         f"match fields {tuple(fields.shape)}")
    if bounds is not None and bounds.shape != (*fields.shape, 2):
        raise ValueError(f"{what}: bounds {tuple(bounds.shape)} does not "
                         f"match fields {tuple(fields.shape)}")
    tensors = dict(metadata=metadata, fields=fields, allowed=allowed,
                   n_disj=n_disj)
    if bounds is not None:
        tensors["bounds"] = bounds
    device = build.require_cuda(what, **tensors)
    build.require_dtype(what, torch.int32, **tensors)
    out = torch.empty((q_n, n_words(n)), dtype=torch.int32,
                      device=device)
    lib = build.load("filter_eval")
    fn = lib.filter_eval_batch_launch
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    rc = fn(build.ptr(metadata), n, F, build.ptr(fields), build.ptr(allowed),
            build.ptr(bounds), build.ptr(n_disj), q_n, D, C, Wv,
            build.ptr(out), build.stream(device))
    build.check(lib, rc, what)
    launches += 1
    return out

