"""One restart round of the batched walk in one launch
(``csrc/walk_round.cu``).

``walk_round`` launches the hand-written CUDA kernel on CUDA tensors: one
block a query lane, each running its own hops to its own end, so the
round reads nothing on the host. Its plain version is the port's
``core/batched/engine.walk_batch`` (the lockstep PyTorch loop); the
dispatcher in ``kernels/ops.py`` picks between them by device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.batched.bitmap import n_words
from repro_torch.kernels import build

# 7 input pointers, (Q, d, R, W, S, k, B, F, kf, stall_budget, max_hops,
# vec4, gw, smem), 6 output pointers and the stream
_C_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 14
           + [ctypes.c_void_p] * 7)

# the kernel's caps (csrc/walk_round.cu): one neighbour slot a thread
MAX_R = 256
MAX_SEEDS = 256
MAX_QUEUE = 64
# gather warps (each with two d-float row buffers beside the staged query)
# in the dynamic shared memory a block may take beside the kernel's 12 KB
# of static arrays, within the H100's 227 KB a block
ROUND_WARPS = 8
ROUND_SLOTS = 2
ROUND_SMEM_LIMIT = 200 * 1024


def walk_round_plan(d: int) -> tuple[int, int]:
    """(gather warps, dynamic shared-memory bytes) of a block at width
    ``d``; raises if d is too large for one warp's two row buffers."""
    row = math.ceil(d / 4) * 16
    gw = min(ROUND_WARPS, (ROUND_SMEM_LIMIT // row - 1) // ROUND_SLOTS)
    if gw < 1:
        raise ValueError(f"walk_round: d={d} leaves no room for two row "
                         f"buffers in {ROUND_SMEM_LIMIT} bytes")
    return gw, (1 + ROUND_SLOTS * gw) * row


def check_params(R: int, S: int, p) -> int:
    """Raise where the walk's shapes or budgets exceed the kernel's caps;
    returns kf, the pushes an expansion keeps."""
    kf = min(p.frontier_width, R)
    bad = []
    if not 1 <= R <= MAX_R:
        bad.append(f"adjacency width {R} outside [1, {MAX_R}]")
    if S > MAX_SEEDS:
        bad.append(f"{S} seeds > {MAX_SEEDS}")
    for name, v in (("k", p.k), ("beam_width", p.beam_width),
                    ("frontier_cap", p.frontier_cap)):
        if not 1 <= v <= MAX_QUEUE:
            bad.append(f"{name}={v} outside [1, {MAX_QUEUE}]")
    if kf < 1:
        bad.append(f"frontier_width={p.frontier_width} < 1")
    if bad:
        raise ValueError("walk_round: " + "; ".join(bad))
    return kf


def walk_round(vectors: torch.Tensor, adjacency: torch.Tensor,
               pass_bm: torch.Tensor, q_vecs: torch.Tensor,
               seeds: torch.Tensor, res_v: torch.Tensor, res_i: torch.Tensor,
               p) -> dict:
    """The CUDA kernel: vectors (n, d) f32; adjacency (n, R) i32 (-1 pad);
    pass_bm (Q, ceil(n/32)) i32; q_vecs (Q, d) f32; seeds (Q, S) i32 (-1
    pad); res_v (Q, k) f32 / res_i (Q, k) i32, the results carried into the
    round; ``p`` the walk's ``WalkConfig``; all contiguous on one CUDA
    device. Returns what ``walk_batch`` returns (res_v, res_i, term, hops,
    p1_hops, visited_bm), with ``syncs`` 0: nothing is read on the host."""
    what = "walk_round"
    n, d = vectors.shape
    q_n, S = seeds.shape
    R = adjacency.shape[1]
    kf = check_params(R, S, p)
    device = build.require_cuda(what, vectors=vectors, adjacency=adjacency,
                                pass_bm=pass_bm, q_vecs=q_vecs, seeds=seeds,
                                res_v=res_v, res_i=res_i)
    build.require_dtype(what, torch.float32, vectors=vectors, q_vecs=q_vecs,
                        res_v=res_v)
    build.require_dtype(what, torch.int32, adjacency=adjacency,
                        pass_bm=pass_bm, seeds=seeds, res_i=res_i)
    W = n_words(n)
    if adjacency.shape[0] != n or q_vecs.shape != (q_n, d) \
            or pass_bm.shape != (q_n, W) \
            or res_v.shape != (q_n, p.k) or res_i.shape != (q_n, p.k):
        raise ValueError(
            f"{what}: shapes vectors {tuple(vectors.shape)}, adjacency "
            f"{tuple(adjacency.shape)}, pass_bm {tuple(pass_bm.shape)}, "
            f"q_vecs {tuple(q_vecs.shape)}, seeds {tuple(seeds.shape)}, "
            f"results {tuple(res_v.shape)} / {tuple(res_i.shape)}, k={p.k}")
    gw, smem = walk_round_plan(d)
    vec4 = int(d % 4 == 0 and q_vecs.data_ptr() % 16 == 0
               and vectors.data_ptr() % 16 == 0)

    def out(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    o_v = out((q_n, p.k), torch.float32)
    o_i = out((q_n, p.k), torch.int32)
    term = out((q_n,), torch.int32)
    hops = out((q_n,), torch.int32)
    p1_hops = out((q_n,), torch.int32)
    visited = out((q_n, W), torch.int32)
    lib = build.load(what)
    fn = lib.walk_round_launch
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    rc = fn(build.ptr(vectors), build.ptr(adjacency), build.ptr(pass_bm),
            build.ptr(q_vecs), build.ptr(seeds), build.ptr(res_v),
            build.ptr(res_i), q_n, d, R, W, S, p.k,
            p.beam_width, p.frontier_cap, kf, p.stall_budget, p.max_hops,
            vec4, gw, smem, build.ptr(o_v), build.ptr(o_i), build.ptr(term),
            build.ptr(hops), build.ptr(p1_hops), build.ptr(visited),
            build.stream(device))
    build.check(lib, rc, what)
    build.LAUNCHES[what] += 1
    return dict(res_v=o_v, res_i=o_i, term=term, hops=hops, p1_hops=p1_hops,
                visited_bm=visited, syncs=0)
