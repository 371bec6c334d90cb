"""K2 and K5: neighbour gather + dot + pass-bit probe
(``csrc/fiber_expand.cu``).

``fiber_expand_walk`` (K2, the walk hop's two outputs) and
``fiber_expand`` (K5, the pass-masked output alone) launch the
hand-written CUDA kernels on CUDA tensors; ``kernels.ref`` holds the plain
PyTorch versions of both (the CPU path and the kernels' allclose targets).
The dispatcher in ``kernels/ops.py`` picks between them by device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

# K2: 4 input pointers, (Q, R, d, W, warps, span, smem, vec4), then the
# outputs and the stream
_C_ARGS_WALK = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
# K5: the same with one output
_C_ARGS_ONE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2

# K2 and K5 blocks: up to 4 warps, each with two d-float row buffers beside
# the block's staged query, in the H100's 227 KB of shared memory per block
# less the kernel's 1.5 KB of static arrays; at least two blocks per SM
WALK_WARPS = 4
WALK_SLOTS = 2   # row buffers per warp (the kernel's kSlots)
WALK_SMEM_LIMIT = 225 * 1024
WALK_BLOCKS_PER_SM = 2


def walk_plan(q_n: int, r: int, d: int, n_sm: int) -> tuple[int, int, int]:
    """(warps per block, neighbour slots per block, shared-memory bytes)
    of the K2 and K5 grid (ceil(r / span), q_n). R is split so that the grid
    gives every SM ``WALK_BLOCKS_PER_SM`` blocks where R allows (at least
    two slots per warp); raises if d is too large for one warp's two row
    buffers."""
    row = math.ceil(d / 4) * 16
    warps = min(WALK_WARPS, (WALK_SMEM_LIMIT // row - 1) // WALK_SLOTS)
    if warps < 1:
        raise ValueError(f"fiber_expand_walk: d={d} leaves no room for two "
                         f"row buffers in {WALK_SMEM_LIMIT} bytes")
    split = min(math.ceil(WALK_BLOCKS_PER_SM * n_sm / max(q_n, 1)),
                math.ceil(r / (2 * warps)))
    span = math.ceil(r / max(split, 1))
    return warps, span, (1 + WALK_SLOTS * warps) * row


def _check(what: str, q_vecs, corpus, ids, bitmap) -> tuple:
    """Validate the shared inputs of K2 and K5; returns (device, vec4)."""
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
    return device, vec4


def fiber_expand_walk(q_vecs: torch.Tensor, corpus: torch.Tensor,
                      ids: torch.Tensor, bitmap: torch.Tensor):
    """The K2 CUDA kernel: q_vecs (Q, d) f32; corpus (n, d) f32; ids
    (Q, R) i32 (-1 pad); bitmap (Q, ceil(n/32)) i32, all contiguous on one
    CUDA device. Returns (sims, sims_pass), both (Q, R) f32 with -inf
    masking, as ``ref.fiber_expand_walk``."""
    what = "fiber_expand_walk"
    device, vec4 = _check(what, q_vecs, corpus, ids, bitmap)
    q_n, d = q_vecs.shape
    R = ids.shape[1]
    sims = torch.empty((q_n, R), dtype=torch.float32, device=device)
    sims_pass = torch.empty_like(sims)
    warps, span, smem = walk_plan(q_n, R, d, build.sm_count(device))
    lib = build.load("fiber_expand")
    fn = lib.fiber_expand_walk_launch
    fn.argtypes = _C_ARGS_WALK
    fn.restype = ctypes.c_int
    rc = fn(build.ptr(q_vecs), build.ptr(corpus), build.ptr(ids),
            build.ptr(bitmap), q_n, R, d, bitmap.shape[1], warps, span, smem,
            vec4, build.ptr(sims), build.ptr(sims_pass), build.stream(device))
    build.check(lib, rc, what)
    build.LAUNCHES[what] += 1
    return sims, sims_pass


def fiber_expand(q_vecs: torch.Tensor, corpus: torch.Tensor,
                 ids: torch.Tensor, bitmap: torch.Tensor) -> torch.Tensor:
    """The K5 CUDA kernel: the inputs of ``fiber_expand_walk``; returns
    sims (Q, R) f32, -inf unless the id is >= 0 and its pass bit is set,
    as ``ref.fiber_expand``. Rows whose bit is 0 are never read, nor is
    the query of a block none of whose slots pass."""
    what = "fiber_expand"
    device, vec4 = _check(what, q_vecs, corpus, ids, bitmap)
    q_n, d = q_vecs.shape
    R = ids.shape[1]
    sims = torch.empty((q_n, R), dtype=torch.float32, device=device)
    warps, span, smem = walk_plan(q_n, R, d, build.sm_count(device))
    lib = build.load("fiber_expand")
    fn = lib.fiber_expand_launch
    fn.argtypes = _C_ARGS_ONE
    fn.restype = ctypes.c_int
    rc = fn(build.ptr(q_vecs), build.ptr(corpus), build.ptr(ids),
            build.ptr(bitmap), q_n, R, d, bitmap.shape[1], warps, span, smem,
            vec4, build.ptr(sims), build.stream(device))
    build.check(lib, rc, what)
    build.LAUNCHES[what] += 1
    return sims
