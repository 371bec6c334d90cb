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
   mode), so no byte correction is due either.
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


def _trace_costs(cfg: ArchConfig, shape_name: str, policy: str) -> dict:
    """Trace one cfg variant's step on ``meta``; return its counts."""
    fn, _ = dryrun.step_call(cfg, SHAPES[shape_name], "meta", policy)
    with CostCounter() as counter:
        fn()
    c = counter.costs()
    return {"flops": c["flops"], "bytes": c["bytes"],
            "wire_bytes": c["wire_bytes"], "coll_by_kind": c["coll_by_kind"],
            "coll_counts": c["coll_counts"]}


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


def accounting_cell(arch: str, shape_name: str, multi_pod: bool = False,
                    policy: str = "tp") -> dict:
    """Extrapolated (flops, bytes, wire_bytes) for the full-depth cell on
    one GPU, with the reference's keys."""
    if multi_pod:
        raise dryrun.mesh_not_ported("accounting_cell(multi_pod=True)")
    cfg = get_config(arch)
    pat = _pattern_len(cfg)
    l1, l2 = pat, 2 * pat
    t0 = time.time()
    settings.UNROLL_SCANS = True
    try:
        c1 = _trace_costs(reduced_depth(cfg, l1), shape_name, policy)
        c2 = _trace_costs(reduced_depth(cfg, l2), shape_name, policy)
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
    kinds = set(c1["coll_by_kind"]) | set(c2["coll_by_kind"])
    out["coll_by_kind"] = {}
    for k in kinds:
        b1, b2 = c1["coll_by_kind"].get(k, 0.0), c2["coll_by_kind"].get(k, 0.0)
        pl = (b2 - b1) / (l2 - l1)
        out["coll_by_kind"][k] = (b1 - l1 * pl) + L * pl
    out["flops"] += (_recurrent_correction_flops(cfg, shape_name)
                     * (1.0 - _COUNTED_SHARE.get(cfg.family, 0.0)))
    out["coll_counts_l2"] = c2["coll_counts"]
    return out
