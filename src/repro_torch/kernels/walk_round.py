"""One restart round of the batched walk in one launch
(``csrc/walk_round.cu``).

``walk_round`` launches the hand-written CUDA kernel on CUDA tensors:
every query lane runs its own hops to its own end, so the round reads
nothing on the host. Its plain version is the port's
``core/batched/engine.walk_batch`` (the lockstep PyTorch loop); the
dispatcher in ``kernels/ops.py`` picks between them by device.

``walk_round_plan`` is the one place that shapes the launch, from the
width, the lane count and the device's SM count and shared memory: the
ring's row buffers, a block's bytes (at most half an SM's, so two blocks
fit an SM), the grid (persistent, lanes handed out by a device counter,
when Q >= the SM count) and the cluster size (C blocks a lane when Q is
smaller: C = clamp(SMs // Q, 1, 8)).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.core.batched.bitmap import n_words
from repro_torch.kernels import build

# 7 input pointers, (Q, d, R, W, S, k, B, F, kf, stall_budget, max_hops,
# vec4, slots, warps, bitmaps, smem, grid, cluster), 7 output pointers (the
# counter last) and the stream
_C_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 18
           + [ctypes.c_void_p] * 8)
_I = ctypes.c_int

# the kernel's caps (csrc/walk_round.cu): 32-slot chunks of neighbours
MAX_R = 256
MAX_SEEDS = 256
MAX_QUEUE = 64
MAX_SLOTS = 32        # ring row buffers
MAX_WARPS = 7         # gather warps (a block's warps but the first)
MAX_CLUSTER = 8       # blocks a lane (the portable cluster size)
# a block's static shared memory at most (the queues, the message, the
# dots, the ring's barriers; checked on the device) and what the card
# reserves beside each block
STATIC_SMEM = 8 * 1024
BLOCK_RESERVED = 1024
BLOCKS_PER_SM = 2
# row buffers the ring keeps beside the lane's bitmaps in shared memory,
# at least (more did not move the round's time on the H100: 6, 8 and 12
# at d = 2,048 read within 2% of each other)
MIN_SLOTS_BESIDE_BITMAPS = 6


class Plan(NamedTuple):
    slots: int          # ring row buffers, a multiple of warps
    warps: int          # gather warps, each owning slots / warps buffers
    bitmaps: int        # 1: the lane's pass and visited words in smem
    smem: int           # dynamic shared memory a block: query + ring
                        # (+ the bitmaps)
    blocks_per_sm: int  # blocks an SM must hold
    grid: int           # blocks launched, a multiple of cluster
    cluster: int        # blocks a lane


def walk_round_plan(d: int, Q: int, n: int, sms: int, smem_block: int,
                    smem_sm: int) -> Plan:
    """The launch at width ``d`` for ``Q`` lanes over ``n`` rows on a
    device of ``sms`` SMs with ``smem_block`` bytes of shared memory a
    block (opt-in) and ``smem_sm`` an SM. The lane's pass and visited
    bitmaps (8 * ceil(n/32) bytes) go to shared memory where at least
    MIN_SLOTS_BESIDE_BITMAPS row buffers still fit. The ring has the most
    gather warps (up to 7) that get two of the buffers that fit each (one
    where only one fits), and as many buffers as divide among them: a
    buffer is read by one warp. Raises if d leaves no room for a row
    buffer."""
    row = math.ceil(d / 4) * 16
    budget = (min(smem_block, smem_sm // BLOCKS_PER_SM - BLOCK_RESERVED)
              - STATIC_SMEM)
    bm = 8 * n_words(n)
    bitmaps = int((budget - bm) // row - 1 >= MIN_SLOTS_BESIDE_BITMAPS)
    fit = min(MAX_SLOTS, (budget - bitmaps * bm) // row - 1)
    if fit < 1:
        raise ValueError(f"walk_round: d={d} leaves no room for a row "
                         f"buffer beside the query in {budget} bytes")
    warps = max(1, min(MAX_WARPS, fit // 2))
    slots = warps * (fit // warps)
    cluster = 1 if Q >= sms else min(MAX_CLUSTER, max(1, sms // max(Q, 1)))
    lanes = max(1, min(Q, BLOCKS_PER_SM * sms // cluster))
    return Plan(slots, warps, bitmaps, (1 + slots) * row + bitmaps * bm,
                BLOCKS_PER_SM, cluster * lanes, cluster)


def check_plan(plan: Plan, d: int, n: int) -> None:
    """Raise where a plan asks what the kernel does not take (its
    launcher refuses the same)."""
    bad = []
    if not 1 <= plan.slots <= MAX_SLOTS:
        bad.append(f"slots={plan.slots} outside [1, {MAX_SLOTS}]")
    if not 1 <= plan.warps <= MAX_WARPS:
        bad.append(f"warps={plan.warps} outside [1, {MAX_WARPS}]")
    elif plan.slots % plan.warps:
        bad.append(f"slots={plan.slots} not a multiple of "
                   f"warps={plan.warps}")
    if not 1 <= plan.cluster <= MAX_CLUSTER:
        bad.append(f"cluster={plan.cluster} outside [1, {MAX_CLUSTER}]")
    elif plan.grid < plan.cluster or plan.grid % plan.cluster:
        bad.append(f"grid={plan.grid} not a positive multiple of "
                   f"cluster={plan.cluster}")
    need = ((1 + plan.slots) * math.ceil(d / 4) * 16
            + plan.bitmaps * 8 * n_words(n))
    if plan.smem < need:
        bad.append(f"smem={plan.smem} below the query, {plan.slots} rows "
                   f"at d={d} and the bitmaps ({need} bytes)")
    if bad:
        raise ValueError("walk_round: plan " + "; ".join(bad))


_DEVICE: dict[int, tuple[int, int, int]] = {}
_GRANTED: dict[tuple[int, int, int], tuple[int, int, int]] = {}


def device_caps(lib, device: torch.device) -> tuple[int, int, int]:
    """(SMs, shared memory a block, shared memory an SM) of ``device``,
    read once from ``cudaDeviceGetAttribute``."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _DEVICE:
        vals = [_I(), _I(), _I()]
        fn = lib.walk_round_device
        fn.argtypes = [_I] + [ctypes.POINTER(_I)] * 3
        fn.restype = _I
        build.check(lib, fn(idx, *map(ctypes.byref, vals)), "walk_round")
        _DEVICE[idx] = tuple(v.value for v in vals)
    return _DEVICE[idx]


def plan_for(lib, device: torch.device, d: int, Q: int, n: int) -> Plan:
    """``walk_round_plan`` on ``device``, held once per (device, smem,
    cluster) against what the device grants (``cudaOccupancyMaxActive*``):
    raises where the kernel's static shared memory exceeds STATIC_SMEM,
    fewer than the plan's blocks fit an SM or no cluster fits."""
    plan = walk_round_plan(d, Q, n, *device_caps(lib, device))
    key = (device.index or 0, plan.smem, plan.cluster)
    if key not in _GRANTED:
        vals = [_I(), _I(), _I()]
        fn = lib.walk_round_occupancy
        fn.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 3
        fn.restype = _I
        with torch.cuda.device(device):
            rc = fn(plan.smem, plan.cluster, *map(ctypes.byref, vals))
        build.check(lib, rc, "walk_round")
        _GRANTED[key] = tuple(v.value for v in vals)
    bps, clusters, static = _GRANTED[key]
    if static > STATIC_SMEM or bps < plan.blocks_per_sm or (
            plan.cluster > 1 and clusters < 1):
        raise RuntimeError(
            f"walk_round: the device grants {bps} blocks an SM and {clusters}"
            f" clusters of {plan.cluster} for {plan} (static shared memory "
            f"{static} bytes, at most {STATIC_SMEM})")
    return plan


def plan_of(q_vecs: torch.Tensor, n: int) -> Plan:
    """The plan ``walk_round`` launches for these (Q, d) query vectors
    over ``n`` rows on their device."""
    return plan_for(build.load("walk_round"), q_vecs.device,
                    q_vecs.shape[1], q_vecs.shape[0], n)


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
    lib = build.load(what)
    plan = plan_for(lib, device, d, q_n, n)
    check_plan(plan, d, n)
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
    counter = torch.zeros(1, dtype=torch.int32, device=device)
    fn = lib.walk_round_launch
    fn.argtypes = _C_ARGS
    fn.restype = _I
    with torch.cuda.device(device):
        rc = fn(build.ptr(vectors), build.ptr(adjacency), build.ptr(pass_bm),
                build.ptr(q_vecs), build.ptr(seeds), build.ptr(res_v),
                build.ptr(res_i), q_n, d, R, W, S, p.k,
                p.beam_width, p.frontier_cap, kf, p.stall_budget, p.max_hops,
                vec4, plan.slots, plan.warps, plan.bitmaps, plan.smem,
                plan.grid, plan.cluster,
                build.ptr(o_v), build.ptr(o_i), build.ptr(term),
                build.ptr(hops), build.ptr(p1_hops), build.ptr(visited),
                build.ptr(counter), build.stream(device))
    build.check(lib, rc, what)
    build.LAUNCHES[what] += 1
    return dict(res_v=o_v, res_i=o_i, term=term, hops=hops, p1_hops=p1_hops,
                visited_bm=visited, syncs=0)
