"""Dry-run of (arch x shape) cells on one GPU: what a step costs, counted
from the ops the port runs, without running it.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
        --shape decode_32k [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--accounting]

Each cell's step (``make_train_step``, ``prefill`` or ``decode_step`` at
the shape's batch and length) runs once on ``meta`` tensors under
``roofline.CostCounter``: nothing is allocated, every aten op is counted.
The record has the reference's keys, for a mesh of one card
(``"mesh": "1xH100"``, ``"chips": 1``, no collectives); in place of XLA's
``memory_analysis()`` it holds the step's argument, output and peak bytes
(arguments plus the counter's live-storage peak) and ``fits``, the peak
against the card's memory. Most full-size cells do not fit one card:
that is a record with ``fits: false``, not a failure.

The roofline constants and the memory come from the card
(``--device cuda``, the default: ``roofline.chip_for`` its name, its
``total_memory``); ``--device cpu`` takes the H100 SXM row and traces the
same. ``--mesh multi`` raises: the multi-chip rows come after the
training slice over a mesh (ROADMAP queue 1 item 5). Results go to ``results/torch/`` (one JSON a cell, ``.err`` with
the traceback where a cell failed; the exit code is nonzero if any did);
``launch/report.py`` renders them.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback

import torch
from torch import nn

from repro_torch.configs import SHAPES, cell_plan, get_config
from repro_torch.configs.base import ARCH_NAMES, ShapeSpec
from repro_torch.core.device_atlas import resolve_device
from repro_torch.launch import roofline as rf
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import (ShardEnv, decode_step,
                                            init_params, prefill)
from repro_torch.optim.adamw import (AdamWConfig, init_opt_state,
                                     make_train_step)

MESH = "1xH100"
DRYRUN_DIR = "results/torch/dryrun"
ACCT_DIR = "results/torch/accounting"


def mesh_not_ported(what: str):
    return NotImplementedError(
        f"{what}: the dry-run counts one GPU; its multi-chip rows come "
        f"after the training slice over a mesh (ROADMAP queue 1 item 5)")


def resolve_policy(policy: str, cfg) -> tuple[str, bool]:
    """Returns (param policy, zero1). "auto" = the optimized configuration
    from the §Perf iterations: pure-DP for sub-4B archs, ZeRO-1 always.
    On one card only the gradient sync dtype it implies changes the
    step ("auto": bf16)."""
    if policy == "auto":
        return ("dp" if cfg.param_count() < 4e9 else "tp"), True
    if policy == "zero1":
        return "tp", True
    if policy in ("dp", "sp"):
        return policy, True
    return "tp", False


def target_chip(device=None) -> tuple[rf.Chip, float]:
    """(roofline constants, memory bytes) of the card on ``device`` (None
    means CUDA); for a CPU device, the H100 SXM row and its memory."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        chip = rf.chip_for(torch.cuda.get_device_name(dev))
        return chip, float(torch.cuda.get_device_properties(dev)
                           .total_memory)
    return rf.H100_SXM, rf.H100_SXM.memory_bytes


def _inputs(cfg, spec: ShapeSpec, dev: torch.device, gen) -> dict:
    """The step's batch (``cfg.input_specs``) on ``dev``: token ids below
    the vocabulary and normal bf16 embeddings drawn from ``gen``; on
    ``meta``, the shapes alone."""
    out = {}
    for name, (shape, dtype) in cfg.input_specs(spec).items():
        if dev.type == "meta":
            out[name] = torch.empty(shape, dtype=dtype, device=dev)
        elif dtype.is_floating_point:
            out[name] = torch.randn(shape, generator=gen,
                                    device=dev).to(dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=gen, device=dev, dtype=dtype)
    return out


def step_call(cfg, spec: ShapeSpec, device, policy: str = "tp",
              seed: int = 0):
    """(fn, args): one step of ``spec``'s kind on ``device``, ready to
    run, and the tensors it takes. Weights are ``init_params(cfg, seed)``
    (stand-ins on ``meta``); training takes them fp32 with fresh AdamW
    state through ``make_train_step``; prefill and decode take them cast
    to bf16, as the reference's dry-run serves. Decode writes the cache's
    last slot (its whole length is read either way)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    params = init_params(cfg, seed, dev)
    batch = _inputs(cfg, spec, dev, gen)
    env = ShardEnv()
    if spec.kind == "train":
        opt = init_opt_state(params)
        step = make_train_step(cfg, env, AdamWConfig(
            grad_sync_dtype="bf16" if policy == "auto" else "f32"))
        return (lambda: step(params, opt, batch)), (params, opt, batch)
    params = params.to(torch.bfloat16)
    if spec.kind == "prefill":
        return (lambda: prefill(params, batch, cfg, env)), (params, batch)
    cache = init_cache(cfg, spec, dev)
    cache["pos"] = (cfg.max_decode_len if cfg.family == "audio"
                    else spec.seq_len) - 1
    return ((lambda: decode_step(params, cache, batch, cfg, env)),
            (params, cache, batch))


def storage_bytes(tree, exclude=()) -> int:
    """Bytes of the distinct storages under ``tree`` (dicts, lists,
    tuples, modules' parameters), leaving out those under ``exclude``."""
    def keys(node, out):
        if isinstance(node, torch.Tensor):
            st = node.untyped_storage()
            out[st._cdata] = st.nbytes()
        elif isinstance(node, nn.Module):
            keys(list(node.parameters()), out)
        elif isinstance(node, dict):
            keys(list(node.values()), out)
        elif isinstance(node, (list, tuple)):
            for x in node:
                keys(x, out)
        return out
    skip = keys(exclude, {})
    return sum(n for k, n in keys(tree, {}).items() if k not in skip)


def count_step(fn, args) -> tuple[rf.CostCounter, dict]:
    """Runs ``fn`` under a ``CostCounter``; returns the counter and the
    step's memory: argument, output and peak bytes (arguments plus the
    most the step's own tensors held at once). The garbage collector is
    held off during the step, so no storage that only a collection frees
    is freed at a point that differs between runs (a caller that reads
    the allocator around the step collects before it)."""
    gc.disable()
    try:
        with rf.CostCounter() as counter:
            out = fn()
    finally:
        gc.enable()
    arg_b = storage_bytes(args)
    mem = {"argument_bytes": arg_b,
           "output_bytes": storage_bytes(out, exclude=args),
           "peak_bytes": arg_b + counter.peak_bytes}
    return counter, mem


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               policy: str = "tp", device=None) -> dict:
    """Trace one (arch x shape) cell on ``meta``; returns its record.
    ``device`` is the card whose constants and memory the record uses."""
    if multi_pod:
        raise mesh_not_ported("lower_cell(multi_pod=True)")
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    chip, capacity = target_chip(device)
    t0 = time.time()
    fn, args = step_call(cfg, spec, "meta", policy)
    counter, mem = count_step(fn, args)
    t_lower = time.time() - t0
    mem.update(capacity_bytes=capacity, fits=mem["peak_bytes"] <= capacity)
    colls = {"wire_bytes": counter.wire_bytes,
             "by_kind": dict(counter.coll_by_kind),
             "counts": dict(counter.coll_counts)}
    rec = {
        "arch": arch, "shape": shape_name, "mesh": MESH, "chips": 1,
        "kind": spec.kind, "chip": chip.name,
        "lower_s": round(t_lower, 1),
        "compile_s": 0.0,  # eager: nothing is compiled
        "memory": mem,
        "flops_per_chip": counter.flops,
        "bytes_per_chip": counter.bytes,
        "kernel_ops": counter.kernel_ops,
        "collectives": colls,
        "model_flops_global": rf.model_flops(cfg, spec),
    }
    terms = rf.roofline_terms(rec["flops_per_chip"], rec["bytes_per_chip"],
                              colls["wire_bytes"], chip)
    rec["roofline"] = {
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "useful_flops_ratio":
            rec["model_flops_global"] / max(rec["flops_per_chip"], 1.0),
    }
    return rec


def _sweep(cells, run, out_dir: str, show) -> int:
    """Runs each missing cell's record into ``out_dir``; returns the
    failures (each with an ``.err`` traceback)."""
    os.makedirs(out_dir, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        tag = f"{arch}__{shape}__single"
        path = os.path.join(out_dir, tag + ".json")
        if os.path.exists(path):
            print(f"[skip] {tag} (cached)")
            continue
        print(f"[cell] {tag}")
        try:
            rec = run(arch, shape)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print("  " + show(rec))
        except Exception as e:  # noqa: BLE001 — record and continue sweep
            failures += 1
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())
            print(f"  FAIL: {e}")
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--accounting", action="store_true",
                    help="two-depth extrapolated cost pass "
                         "(launch/accounting.py)")
    ap.add_argument("--policy", default="tp",
                    choices=["tp", "zero1", "auto", "dp", "sp"],
                    help="sharding policy (tp=baseline, auto=optimized)")
    ap.add_argument("--out", default=DRYRUN_DIR)
    ap.add_argument("--device", default="cuda",
                    help="the card whose constants and memory apply "
                         "(cpu: the H100 SXM row); tracing is on meta")
    args = ap.parse_args(argv)
    if args.mesh != "single":
        raise mesh_not_ported(f"--mesh {args.mesh}")
    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in cell_plan(a)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    if args.accounting:
        from repro_torch.launch.accounting import accounting_cell
        out_dir = (ACCT_DIR if args.policy == "tp"
                   else f"{ACCT_DIR}_{args.policy}")
        failures = _sweep(
            cells, lambda a, s: accounting_cell(a, s, False, args.policy),
            out_dir,
            lambda r: (f"flops={r['flops']:.3e}/chip "
                       f"bytes={r['bytes']:.3e} wire={r['wire_bytes']:.3e} "
                       f"({r['accounting_s']}s)"))
        raise SystemExit(1 if failures else 0)

    def show(rec):
        r, m = rec["roofline"], rec["memory"]
        return (f"ok: compute={r['compute_s']:.4f}s "
                f"memory={r['memory_s']:.4f}s "
                f"collective={r['collective_s']:.4f}s "
                f"dominant={r['dominant']} peak={m['peak_bytes'] / 2**30:.2f}"
                f" GiB fits={m['fits']} (trace {rec['lower_s']}s)")

    failures = _sweep(
        cells, lambda a, s: lower_cell(a, s, False, args.policy, args.device),
        args.out, show)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
