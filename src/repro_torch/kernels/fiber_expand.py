"""K2: walk-hop neighbour gather + dot + pass-bit probe
(``csrc/fiber_expand.cu``).

``fiber_expand_walk`` launches the hand-written CUDA kernel on CUDA
tensors; ``kernels.ref.fiber_expand_walk`` is the plain PyTorch version
(the CPU path and the kernel's allclose target). The dispatcher in
``kernels/ops.py`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# kernel launches since the count was last set to 0 (read by the smoke
# test to show the main path went through the kernel)
launches = 0

_C_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3


def fiber_expand_walk(q_vecs: torch.Tensor, corpus: torch.Tensor,
                      ids: torch.Tensor, bitmap: torch.Tensor):
    """The CUDA kernel: q_vecs (Q, d) f32; corpus (n, d) f32; ids (Q, R)
    i32 (-1 pad); bitmap (Q, ceil(n/32)) i32, all contiguous on one CUDA
    device. Returns (sims, sims_pass), both (Q, R) f32 with -inf masking,
    as ``ref.fiber_expand_walk``."""
    global launches
    what = "fiber_expand_walk"
    device = build.require_cuda(what, q_vecs=q_vecs, corpus=corpus, ids=ids,
                                bitmap=bitmap)
    build.require_dtype(what, torch.float32, q_vecs=q_vecs, corpus=corpus)
    build.require_dtype(what, torch.int32, ids=ids, bitmap=bitmap)
    q_n, d = q_vecs.shape
    n = corpus.shape[0]
    R = ids.shape[1]
    if corpus.shape[1] != d or ids.shape[0] != q_n \
            or bitmap.shape[0] != q_n or bitmap.shape[1] * 32 < n:
        raise ValueError(f"{what}: shapes q_vecs {tuple(q_vecs.shape)}, "
                         f"corpus {tuple(corpus.shape)}, ids "
                         f"{tuple(ids.shape)}, bitmap {tuple(bitmap.shape)}")
    vec4 = int(d % 4 == 0 and q_vecs.data_ptr() % 16 == 0
               and corpus.data_ptr() % 16 == 0)
    sims = torch.empty((q_n, R), dtype=torch.float32, device=device)
    sims_pass = torch.empty_like(sims)
    lib = build.load("fiber_expand")
    fn = lib.fiber_expand_walk_launch
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    rc = fn(build.ptr(q_vecs), build.ptr(corpus), build.ptr(ids),
            build.ptr(bitmap), q_n, R, d, bitmap.shape[1], vec4,
            build.ptr(sims), build.ptr(sims_pass), build.stream(device))
    build.check(lib, rc, what)
    launches += 1
    return sims, sims_pass
