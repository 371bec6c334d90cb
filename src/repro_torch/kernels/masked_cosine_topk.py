"""K3: bitmap-masked cosine scores -> per-query top-k
(``csrc/masked_cosine_topk.cu``).

``masked_cosine_topk`` launches the hand-written CUDA kernel (a per-chunk
pass and a merge pass) on CUDA tensors; ``kernels.ref.masked_cosine_topk``
is the plain PyTorch version (the CPU path and the kernel's target). The
dispatcher in ``kernels/ops.py`` picks between them by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# the kernel keeps each query's list in one warp's registers
MAX_K = 32

# kernel launches since the count was last set to 0 (read by the smoke
# test to show the main path went through the kernel)
launches = 0

_C_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
           + [ctypes.c_void_p] * 5)


def masked_cosine_topk(queries: torch.Tensor, corpus: torch.Tensor,
                       bitmap: torch.Tensor, k: int):
    """The CUDA kernel: queries (Q, d) f32, corpus (n, d) f32, bitmap
    (Q, ceil(n/32)) i32, all contiguous on one CUDA device; 1 <= k <= 32.
    Returns (sims (Q, k) f32 desc, ids (Q, k) i32; -inf/-1 where fewer than
    k rows pass; ties go to the lower id), as ``ref.masked_cosine_topk``."""
    global launches
    what = "masked_cosine_topk"
    device = build.require_cuda(what, queries=queries, corpus=corpus,
                                bitmap=bitmap)
    build.require_dtype(what, torch.float32, queries=queries, corpus=corpus)
    build.require_dtype(what, torch.int32, bitmap=bitmap)
    q_n, d = queries.shape
    n = corpus.shape[0]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{what}: k={k} outside [1, {MAX_K}]")
    if k > n:
        raise ValueError(f"{what}: k={k} > corpus rows {n}")
    if corpus.shape[1] != d or bitmap.shape[0] != q_n \
            or bitmap.shape[1] * 32 < n:
        raise ValueError(f"{what}: shapes queries {tuple(queries.shape)}, "
                         f"corpus {tuple(corpus.shape)}, bitmap "
                         f"{tuple(bitmap.shape)}")
    lib = build.load("masked_cosine_topk")
    lib.masked_cosine_topk_chunks.argtypes = [ctypes.c_int]
    lib.masked_cosine_topk_chunks.restype = ctypes.c_int
    n_chunks = lib.masked_cosine_topk_chunks(n)
    vec4 = int(d % 4 == 0 and corpus.data_ptr() % 16 == 0)
    part_s = torch.empty((q_n, n_chunks, k), dtype=torch.float32,
                         device=device)
    part_i = torch.empty((q_n, n_chunks, k), dtype=torch.int32,
                         device=device)
    sims = torch.empty((q_n, k), dtype=torch.float32, device=device)
    ids = torch.empty((q_n, k), dtype=torch.int32, device=device)
    fn = lib.masked_cosine_topk_launch
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    rc = fn(build.ptr(queries), build.ptr(corpus), build.ptr(bitmap),
            q_n, n, d, bitmap.shape[1], k, vec4, build.ptr(part_s),
            build.ptr(part_i), build.ptr(sims), build.ptr(ids),
            build.stream(device))
    build.check(lib, rc, what)
    launches += 1
    return sims, ids
