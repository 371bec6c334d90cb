"""K1 and K4: predicate evaluation -> packed pass bitmaps
(``csrc/filter_eval.cu``).

``filter_eval_batch`` (K1, a batch of clause tables) and ``filter_eval``
(K4, one conjunctive query over a dense uint8 allowed table) launch the
hand-written CUDA kernels on CUDA tensors; ``kernels.ref`` holds the plain
PyTorch versions of both (the CPU path and the kernels' bit-exact
targets). The dispatcher in ``kernels/ops.py`` picks between them by
device.

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

# K1: meta, n, F, the four table pointers, (Q, D, C, Wv, rows, group,
# smem), out, stream
_C_ARGS = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
           + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
           + [ctypes.c_void_p] * 2)
_C_ARGS_SINGLE = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # meta, n, F
                  ctypes.c_void_p, ctypes.c_void_p,  # fields, allowed
                  ctypes.c_int, ctypes.c_int,        # C, v_cap
                  ctypes.c_void_p, ctypes.c_void_p]  # out, stream

# K1 blocks: 8 warps over a tile of FILTER_ROWS metadata rows (128 or
# 256: 4 or 8 rows a thread, each warp sweeping its own queries over the
# whole tile), with two buffers of a chunk of the query group's fields,
# bounds and live-disjunct counts, about FILTER_TABLE_BYTES each, beside it
# (one is swept while the next chunk is copied into the other), in at most
# FILTER_SMEM_LIMIT bytes of shared memory (two blocks fit in an H100 SM's
# 228 KB); query groups sized so the grid gives each SM
# FILTER_BLOCKS_PER_SM blocks.
FILTER_ROWS = 256
FILTER_TABLE_BYTES = 16 * 1024
FILTER_SMEM_LIMIT = 113 * 1024
FILTER_BLOCKS_PER_SM = 16


def filter_plan(q_n: int, n: int, F: int, D: int, C: int, Wv: int,
                n_sm: int) -> tuple[int, int, int]:
    """(rows per tile, queries per group, shared-memory bytes) of the K1
    grid (ceil(n / rows), ceil(q_n / group)). A block copies its tile of
    metadata rows once (row stride ``F | 1``) and sweeps every query of its
    group over it, so the groups are as few as the target of
    ``FILTER_BLOCKS_PER_SM`` blocks per SM allows: each tile is read from
    L2 once per group. The rest of the shared memory holds two chunks of
    the group's fields, bounds (counted whether given or not) and
    live-disjunct counts; the allowed words stay in global memory. The
    tile shrinks from ``FILTER_ROWS`` toward 128 rows to fit; raises where
    one query's tables and a 128-row tile do not fit."""
    stride = F | 1
    per_q = 4 * (D * C * 3 + 1)

    def smem(rows, chunk):  # the tile, then two table buffers
        return (-(-rows * stride // 4) * 16
                + 2 * (-(-chunk * per_q // 16) * 16 + 16))

    rows = FILTER_ROWS
    while rows > 128 and smem(rows, 1) > FILTER_SMEM_LIMIT:
        rows //= 2
    if smem(rows, 1) > FILTER_SMEM_LIMIT:
        raise ValueError(
            f"filter_eval_batch: one query's tables ({per_q} bytes: D={D}, "
            f"C={C}, Wv={Wv}) and a {rows}-row tile of F={F} fields do not "
            f"fit in {FILTER_SMEM_LIMIT} bytes of shared memory")
    tiles = max(1, -(-n // rows))
    groups = -(-FILTER_BLOCKS_PER_SM * n_sm // tiles)
    group = max(1, q_n // groups)
    chunk = max(1, min(group, FILTER_TABLE_BYTES // per_q))
    while chunk > 1 and smem(rows, chunk) > FILTER_SMEM_LIMIT:
        chunk -= 1
    return rows, group, smem(rows, chunk)


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
    rows, group, smem = filter_plan(q_n, n, F, D, C, Wv,
                                    build.sm_count(device))
    lib = build.load("filter_eval")
    fn = lib.filter_eval_batch_launch
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    rc = fn(build.ptr(metadata), n, F, build.ptr(fields), build.ptr(allowed),
            build.ptr(bounds), build.ptr(n_disj), q_n, D, C, Wv, rows, group,
            smem, build.ptr(out), build.stream(device))
    build.check(lib, rc, what)
    build.LAUNCHES[what] += 1
    return out


def filter_eval(metadata: torch.Tensor, fields: torch.Tensor,
                allowed: torch.Tensor) -> torch.Tensor:
    """The K4 CUDA kernel: metadata (n, F) i32; fields (C,) i32 (-1 =
    inactive clause); allowed (C, v_cap) uint8 (nonzero = code allowed),
    all contiguous on one CUDA device. Returns the (ceil(n/32),) int32
    pass bitmap with pad bits 0, as ``ref.filter_eval``."""
    what = "filter_eval"
    device = build.require_cuda(what, metadata=metadata, fields=fields,
                                allowed=allowed)
    build.require_dtype(what, torch.int32, metadata=metadata, fields=fields)
    build.require_dtype(what, torch.uint8, allowed=allowed)
    n, F = metadata.shape
    if fields.ndim != 1 or allowed.ndim != 2 \
            or allowed.shape[0] != fields.shape[0]:
        raise ValueError(f"{what}: fields {tuple(fields.shape)} and allowed "
                         f"{tuple(allowed.shape)} must be (C,) and (C, v_cap)")
    C, v_cap = allowed.shape
    out = torch.empty(n_words(n), dtype=torch.int32, device=device)
    lib = build.load("filter_eval")
    fn = lib.filter_eval_launch
    fn.argtypes = _C_ARGS_SINGLE
    fn.restype = ctypes.c_int
    rc = fn(build.ptr(metadata), n, F, build.ptr(fields), build.ptr(allowed),
            C, v_cap, build.ptr(out), build.stream(device))
    build.check(lib, rc, what)
    build.LAUNCHES[what] += 1
    return out

