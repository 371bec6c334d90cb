"""Depth-extrapolated cost accounting for the dry-run roofline.

The reference needs this because XLA's cost analysis counts a scanned
layer body once; the port's counter (``roofline.CostCounter``) sees every
executed op, so a full-depth trace is already complete. The extrapolation
still earns its keep: the mamba and rwkv6 recurrences are Python loops of
a few ops a token, so a full-depth trace of ``train_4k`` or ``long_500k``
takes millions of dispatches. So, as the reference does:

1. trace the cell at two reduced depths (L1, L2 = one and two pattern
   periods) in accounting mode (``models/settings.UNROLL_SCANS``: coarse
   attention blocks, the same FLOPs);
2. linear extrapolation: per_layer = (c2 - c1)/(L2 - L1), fixed = c1 - L1 *
   per_layer, total = fixed + L_full * per_layer. Embedding/unembed/loss land
   in ``fixed``; per-layer attention, FFN/MoE and their collectives in
   ``per_layer``. gemma3's 26 layers are not a multiple of its 6-layer
   period, so its total counts 26 average layers, as the reference's does;
3. recurrent inner steps: the reference adds their FLOPs analytically
   (``_recurrent_correction_flops``, its body counted once). The counter
   already counts each step's contraction, once a step and pass: mamba's
   ``bmm(h, C)`` (2·d_in·N a token) and rwkv6's ``einsum`` of r with the
   state (2·d·head_size a token), in the forward, its rematerialization and
   the two products of their backward, the reference's 4x. It counts no
   FLOPs for the elementwise rest (decay, input and state updates: the
   counter gives elementwise ops no FLOPs). So the port adds only that
   rest: the reference's correction less the counted share, 2/9 of mamba's
   9·d_in·N and 2/6 of rwkv6's 6·d·head_size; nothing is counted twice.
   Their bytes are counted (every step's ops move their tensors in eager
   mode), so no byte correction is due either. On a mesh the rest is
   divided by the mesh's chips, as the reference divides its whole
   correction.

On the production meshes (``mesh="pod"`` or ``"multi"``) each depth is
one cell's trace (``dryrun.trace_mesh_cell``), and the wire bytes are
extrapolated kind by kind, as the reference extrapolates the collectives
it parses from each depth's HLO.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.configs.base import SHAPES, ArchConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import CostCounter
from repro_torch.models import settings

# the share of each family's analytic step FLOPs the counter sees (the
# step's one contraction), by family
_COUNTED_SHARE = {"hybrid": 2.0 / 9.0, "ssm": 2.0 / 6.0}


def _trace_costs(cfg: ArchConfig, shape_name: str, policy: str,
                 mesh: str = "single") -> dict:
    """Trace one cfg variant's step on ``meta`` (on one card, or a chip of
    the ``dryrun.MESHES`` mesh ``mesh``); return its counts."""
    spec = SHAPES[shape_name]
    if mesh == "single":
        fn, _ = dryrun.step_call(cfg, spec, "meta", policy)
        with CostCounter() as counter:
            fn()
        c = counter.costs()
    else:
        c, _ = dryrun.trace_mesh_cell(cfg, spec, dryrun.meta_mesh(mesh),
                                      policy)
        c["wire_bytes"] = sum(c["coll_by_kind"].values())
    return {"flops": c["flops"], "bytes": c["bytes"],
            "wire_bytes": c["wire_bytes"], "coll_by_kind": c["coll_by_kind"],
            "coll_counts": c["coll_counts"],
            "coll_network": c["coll_network"]}


def _recurrent_correction_flops(cfg: ArchConfig, shape_name: str) -> float:
    """Analytic FLOPs of rolled inner-step recurrences (per device-global),
    the reference's model; ``accounting_cell`` adds the part its counter
    does not see (``_COUNTED_SHARE``)."""
    spec = SHAPES[shape_name]
    tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode" else 1)
    mult = 4.0 if spec.kind == "train" else 1.0  # fwd + 2 bwd + remat fwd
    if cfg.family == "hybrid":
        d_in = cfg.ssm_expand * cfg.d_model
        return mult * 9.0 * tokens * d_in * cfg.ssm_state * cfg.n_layers
    if cfg.family == "ssm":
        return (mult * 6.0 * tokens * cfg.d_model * cfg.rwkv_head_size
                * cfg.n_layers)
    return 0.0


def _pattern_len(cfg: ArchConfig) -> int:
    return (cfg.local_global_ratio + 1) if cfg.local_global_ratio else 1


def reduced_depth(cfg: ArchConfig, ell: int) -> ArchConfig:
    return dataclasses.replace(
        cfg, n_layers=ell,
        n_enc_layers=ell if cfg.n_enc_layers else 0)


def _extrapolate(b1: dict, b2: dict, l1: int, l2: int, L: int) -> dict:
    """Each kind of ``b1``/``b2`` (counts at depths l1, l2) at depth L."""
    out = {}
    for k in set(b1) | set(b2):
        v1, v2 = b1.get(k, 0.0), b2.get(k, 0.0)
        per = (v2 - v1) / (l2 - l1)
        out[k] = (v1 - l1 * per) + L * per
    return out


def accounting_cell(arch: str, shape_name: str, multi_pod: bool = False,
                    policy: str = "tp", mesh: str | None = None) -> dict:
    """Extrapolated (flops, bytes, wire_bytes) a chip for the full-depth
    cell, with the reference's keys: on one GPU (``mesh`` ``single``, the
    default), or a chip of the 16 x 16 (``pod``) or 2 x 16 x 16 (``multi``,
    also ``multi_pod=True``) mesh, where each depth is traced on one cell
    (``dryrun.trace_mesh_cell``), the wire bytes are extrapolated kind by
    kind (their node-network share too) and the recurrences' uncounted
    FLOPs are divided by the mesh's chips, as the reference divides its
    correction."""
    mesh = mesh or ("multi" if multi_pod else "single")
    chips = dryrun.MESHES[mesh][1]
    cfg = get_config(arch)
    pat = _pattern_len(cfg)
    l1, l2 = pat, 2 * pat
    t0 = time.time()
    settings.UNROLL_SCANS = True
    try:
        c1 = _trace_costs(reduced_depth(cfg, l1), shape_name, policy, mesh)
        c2 = _trace_costs(reduced_depth(cfg, l2), shape_name, policy, mesh)
    finally:
        settings.UNROLL_SCANS = False
    out = {"l1": l1, "l2": l2, "accounting_s": round(time.time() - t0, 1)}
    L = cfg.n_layers
    for key in ("flops", "bytes", "wire_bytes"):
        per_layer = (c2[key] - c1[key]) / (l2 - l1)
        fixed = c1[key] - l1 * per_layer
        out[key] = fixed + L * per_layer
        out[f"{key}_per_layer"] = per_layer
        out[f"{key}_fixed"] = fixed
    out["coll_by_kind"] = _extrapolate(c1["coll_by_kind"], c2["coll_by_kind"],
                                       l1, l2, L)
    out["flops"] += (_recurrent_correction_flops(cfg, shape_name)
                     * (1.0 - _COUNTED_SHARE.get(cfg.family, 0.0)) / chips)
    out["coll_counts_l2"] = c2["coll_counts"]
    if chips > 1:
        out["mesh"], out["chips"] = dryrun.MESHES[mesh][:2]
        out["network_by_kind"] = _extrapolate(
            c1["coll_network"], c2["coll_network"], l1, l2, L)
        out["network_bytes"] = sum(out["network_by_kind"].values())
    return out
