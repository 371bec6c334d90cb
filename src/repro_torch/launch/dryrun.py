"""Dry-run of (arch x shape) cells: what a step costs a chip, counted
from the ops the port runs, without running it; on one GPU or on the
reference's production meshes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
        --shape decode_32k [--mesh single|pod|multi|both] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--accounting]

Each cell's step (``make_train_step``, ``prefill`` or ``decode_step`` at
the shape's batch and length) runs once on ``meta`` tensors under
``roofline.CostCounter``: nothing is allocated, every aten op is counted.
The record has the reference's keys. In place of XLA's
``memory_analysis()`` it holds the step's argument, output and peak bytes
a chip (arguments plus the counter's live-storage peak) and ``fits``, the
peak against the card's memory. A full-size cell that does not fit is a
record with ``fits: false``, not a failure.

``--mesh single`` (the default) counts one card (``"mesh": "1xH100"``,
``"chips": 1``, no collectives). ``--mesh pod`` and ``--mesh multi`` count
a chip of the reference's production meshes, 16 x 16 (``"16x16"``, 256
chips; the reference's ``single``) and 2 x 16 x 16 (``"2x16x16"``, 512
chips); ``both`` gives both, as the reference's ``both`` does. The
parameters, optimizer state, batch and cache are placed on a mesh of
``meta`` cells by the reference's shardings and policy
(``resolve_policy``), and one cell's step is traced alone
(``placement.cell_counters(..., trace=index)``): its collectives return
the group's shapes and report their wire bytes, so a chip's count costs
one cell's trace. Cells whose blocks have the same shapes do the same
work; the record traces one cell of each distinct set of block shapes
(``cells_traced``) and keeps the largest count of each kind. A training
step's cell runs ``forward_loss``'s cell body and its backward (the
collectives' adjoints reported), then ``optim.adamw.cell_update``: the
gradient sync its layout implies (``placement.sync_axes``, the cells
``psum_partials`` sums: an all-reduce over the cells that share its
block; under ZeRO-1 a reduce-scatter onto its optimizer block, an
all-reduce over that block's replicas and an all-gather of the new
parameters), the global norm's all-reduce and the update of its blocks
(``_mesh_train_step``), the cell's share of ``make_train_step``. A mesh's cells lie on nodes of ``roofline.CELLS_PER_NODE`` cards
in row-major order; a collective whose group spans nodes is priced at
the node network's rate (``collectives.network_by_kind``,
``priced_by``).

The roofline constants and the memory come from the card
(``--device cuda``, the default: ``roofline.chip_for`` its name, its
``total_memory``); ``--device cpu`` takes the H100 SXM row and traces the
same. Results go to ``results/torch/`` (one JSON a cell and mesh, tagged
``__single``, ``__pod`` or ``__multi``; ``.err`` with the traceback
where a cell failed; the exit code is nonzero if any did);
``launch/report.py`` renders them.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback

import numpy as np
import torch
from torch import nn

from repro_torch.configs import SHAPES, cell_plan, get_config
from repro_torch.configs.base import ARCH_NAMES, ShapeSpec
from repro_torch.core.device_atlas import resolve_device
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import data_axis_names, make_production_mesh
from repro_torch.launch.placement import (P, axes_size, block_slices,
                                          cell_counters)
from repro_torch.launch.shardings import opt_shardings
from repro_torch.models.kvcache import init_cache
from repro_torch.models.transformer import (ShardEnv, _batch_shape,
                                            _on_cells, cell_loss,
                                            decode_step, init_params,
                                            place_params, prefill)
from repro_torch.optim.adamw import (AdamWConfig, cell_update,
                                     init_opt_state, leaves,
                                     make_train_step)

MESH = "1xH100"
# --mesh name -> (record's mesh, chips, multi_pod); None: one card
MESHES = {"single": (MESH, 1, None), "pod": ("16x16", 256, False),
          "multi": ("2x16x16", 512, True)}
DRYRUN_DIR = "results/torch/dryrun"
ACCT_DIR = "results/torch/accounting"


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


def meta_mesh(name: str):
    """The production mesh of ``--mesh name`` (``pod`` or ``multi``) on
    ``meta`` cells."""
    _, chips, multi = MESHES[name]
    return make_production_mesh(multi_pod=multi, devices=["meta"] * chips)


def mesh_step(cfg, spec: ShapeSpec, mesh, policy: str = "tp"):
    """(fn, args, env): one step of ``spec``'s kind on ``mesh`` (``meta``
    cells), its parameters, optimizer state, batch and cache placed by the
    reference's shardings for ``resolve_policy(policy)`` (``env``);
    called under ``cell_counters(..., trace=index)``, ``fn`` traces the
    cell at ``index``. Weights and state are ``meta`` stand-ins, fp32 for
    training (``_mesh_train_step``) and bf16 for serving."""
    pol, zero1 = resolve_policy(policy, cfg)
    env = ShardEnv(mesh, data_axes=data_axis_names(mesh), policy=pol)
    params = init_params(cfg, 0, "meta")
    batch = _inputs(cfg, spec, torch.device("meta"), None)
    if spec.kind == "train":
        placed = place_params(params, env)
        opt = init_opt_state(placed, opt_shardings(
            cfg, mesh, {"m": placed, "v": placed, "step": torch.zeros(())},
            pol, zero1))
        ocfg = AdamWConfig(grad_sync_dtype="bf16" if policy == "auto"
                           else "f32")
        return ((lambda: _mesh_train_step(cfg, env, placed, opt, batch,
                                          ocfg)),
                (placed.tree(), opt, batch), env)
    placed = place_params(params.to(torch.bfloat16), env)
    if spec.kind == "prefill":
        return ((lambda: prefill(placed, batch, cfg, env)),
                (placed.tree(), batch), env)
    cache = init_cache(cfg, spec, env=env)
    cache["pos"] = (cfg.max_decode_len if cfg.family == "audio"
                    else spec.seq_len) - 1
    return ((lambda: decode_step(placed, cache, batch, cfg, env)),
            (placed.tree(), cache, batch), env)


def _mesh_train_step(cfg, env: ShardEnv, placed, opt: dict, batch: dict,
                     ocfg: AdamWConfig):
    """One training step as each cell of ``env``'s mesh runs it in an SPMD
    program, to be traced a cell at a time (``cell_counters(...,
    trace=index)``): ``forward_loss``'s cell body
    (``transformer.cell_loss``) and its backward from the cell's loss,
    weighed as ``_loss_cells`` weighs its batch block, then
    ``optim.adamw.cell_update`` (the sync and update of
    ``make_train_step`` on the cell's blocks). Returns each cell's
    (loss, ``cell_update`` result). Where every cell's forward pass is its
    own (dp, a batch block a cell) this is ``make_train_step``'s step;
    where collectives join the passes the port's one backward crosses the
    cells' graph, which a cell's backward here stops short of, and only
    its count stands (``tests/test_torch_cost_mesh.py`` holds both)."""
    inputs, body = cell_loss(batch, cfg)
    B, S = _batch_shape(inputs)
    blocks = axes_size(env.mesh, env.at(None, B, S).full()[0])

    def step(p, b, e):
        xs = leaves(p)
        with torch.enable_grad():
            loss = body(p, b, e)
            gs = torch.autograd.grad(loss / blocks, xs, allow_unused=True)
        return loss.detach(), cell_update(e.cell, placed, xs, gs, opt, ocfg)

    return _on_cells(placed, inputs, cfg, env, step, "forward_loss")


def _held_bytes(tree, env: ShardEnv, index) -> int:
    """Bytes of the blocks the cell at ``index`` holds of ``tree``'s
    leaves: a placed leaf's block, a batch leaf's block as the residual
    stream of its length is split (``_on_cells``)."""
    total = 0
    if isinstance(tree, dict):
        return sum(_held_bytes(v, env, index) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_held_bytes(v, env, index) for v in tree)
    if hasattr(tree, "local"):
        blk = tree.local(index)
        if blk is not None:
            total = blk.numel() * blk.element_size()
    elif torch.is_tensor(tree):
        spec = P(*env.at(None, tree.shape[0], tree.shape[1]).act()[
            :tree.ndim]) if tree.ndim >= 2 else P()
        sl = block_slices(env.mesh, spec, tree.shape, index)
        total = (int(np.prod([x.stop - x.start for x in sl]))
                 * tree.element_size())
    return total


def _block_shapes(tree, index) -> list:
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _block_shapes(v, index)]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _block_shapes(v, index)]
    if hasattr(tree, "local"):
        blk = tree.local(index)
        return [() if blk is None else (tuple(blk.shape), str(blk.dtype))]
    return []


def cell_classes(args, mesh) -> list[tuple]:
    """One cell index for each distinct multiset of the block shapes the
    cells hold of ``args``' placed leaves, in cell order (cells of one
    class do the same work: a layer-owned block of another layer has the
    same shapes)."""
    seen: dict = {}
    for index in np.ndindex(mesh.devices.shape):
        key = tuple(sorted(_block_shapes(args, index)))
        seen.setdefault(key, index)
    return list(seen.values())


def trace_mesh_cell(cfg, spec: ShapeSpec, mesh, policy: str = "tp"):
    """Traces ``mesh_step`` on one cell of each class (``cell_classes``);
    returns (the counts a chip, the largest over the cells traced, and
    the memory a chip, as ``count_step`` gives it, and the cells
    traced)."""
    fn, args, env = mesh_step(cfg, spec, mesh, policy)
    cells = cell_classes(args, mesh)
    best: dict = {}
    for index in cells:
        gc.disable()
        try:
            with cell_counters(rf.CostCounter, trace=index) as counters:
                out = fn()
            c = counters[tuple(index)]
            live = c.live_bytes
            del out
        finally:
            gc.enable()
        arg_b = _held_bytes(args, env, index)
        got = {"flops": c.flops, "bytes": c.bytes,
               "kernel_ops": c.kernel_ops,
               "argument_bytes": arg_b, "output_bytes": live,
               "peak_bytes": arg_b + c.peak_bytes}
        for key, v in got.items():
            best[key] = max(best.get(key, 0), v)
        for key in ("coll_by_kind", "coll_counts", "coll_network"):
            into = best.setdefault(key, {})
            for kind, v in getattr(c, key).items():
                into[kind] = max(into.get(kind, 0), v)
    return best, [list(i) for i in cells]


def _priced_by(by_kind: dict, network: dict) -> dict:
    """Which rate priced each kind's wire bytes."""
    out = {}
    for kind, w in by_kind.items():
        net = network.get(kind, 0.0)
        out[kind] = ("network" if net >= w else
                     "nvlink" if not net else "nvlink+network")
    return out


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               policy: str = "tp", device=None,
               mesh: str | None = None) -> dict:
    """Trace one (arch x shape) cell on ``meta``; returns its record.
    ``mesh``: ``single`` (one card, the default), ``pod`` (16 x 16) or
    ``multi`` (2 x 16 x 16, also ``multi_pod=True``). ``device`` is the
    card whose constants and memory the record uses."""
    mesh = mesh or ("multi" if multi_pod else "single")
    mesh_name, chips, _ = MESHES[mesh]
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    chip, capacity = target_chip(device)
    t0 = time.time()
    extra = {}
    if chips == 1:
        fn, args = step_call(cfg, spec, "meta", policy)
        counter, mem = count_step(fn, args)
        c = {"flops": counter.flops, "bytes": counter.bytes,
             "kernel_ops": counter.kernel_ops,
             "coll_by_kind": dict(counter.coll_by_kind),
             "coll_counts": dict(counter.coll_counts),
             "coll_network": dict(counter.coll_network)}
    else:
        c, traced = trace_mesh_cell(cfg, spec, meta_mesh(mesh), policy)
        mem = {k: c[k] for k in ("argument_bytes", "output_bytes",
                                  "peak_bytes")}
        extra = {"policy": list(resolve_policy(policy, cfg)),
                 "cells_traced": traced}
    t_lower = time.time() - t0
    mem.update(capacity_bytes=capacity, fits=mem["peak_bytes"] <= capacity)
    wire = sum(c["coll_by_kind"].values())
    network = sum(c["coll_network"].values())
    colls = {"wire_bytes": wire, "by_kind": c["coll_by_kind"],
             "counts": c["coll_counts"]}
    if chips > 1:
        colls.update(network_bytes=network,
                     network_by_kind=c["coll_network"],
                     priced_by=_priced_by(c["coll_by_kind"],
                                          c["coll_network"]))
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": chips, "kind": spec.kind, "chip": chip.name,
        "lower_s": round(t_lower, 1),
        "compile_s": 0.0,  # eager: nothing is compiled
        "memory": mem,
        "flops_per_chip": c["flops"],
        "bytes_per_chip": c["bytes"],
        "kernel_ops": c["kernel_ops"],
        "collectives": colls,
        "model_flops_global": rf.model_flops(cfg, spec),
        **extra,
    }
    terms = rf.roofline_terms(rec["flops_per_chip"], rec["bytes_per_chip"],
                              wire, chip, network)
    rec["roofline"] = {
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "useful_flops_ratio": rec["model_flops_global"]
        / max(rec["flops_per_chip"] * chips, 1.0),
    }
    return rec


def _sweep(cells, meshes, run, out_dir: str, show) -> int:
    """Runs each missing (cell, mesh) record into ``out_dir``; returns the
    failures (each with an ``.err`` traceback)."""
    os.makedirs(out_dir, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        for mesh in meshes:
            tag = f"{arch}__{shape}__{mesh}"
            path = os.path.join(out_dir, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (cached)")
                continue
            print(f"[cell] {tag}")
            try:
                rec = run(arch, shape, mesh)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print("  " + show(rec))
            except Exception as e:  # noqa: BLE001 — record and continue
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
                    choices=["single", "pod", "multi", "both"],
                    help="single: one card; pod: 16x16; multi: 2x16x16; "
                         "both: pod and multi")
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
    meshes = (["pod", "multi"] if args.mesh == "both" else [args.mesh])
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
            cells, meshes,
            lambda a, s, m: accounting_cell(a, s, policy=args.policy,
                                            mesh=m),
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
        cells, meshes,
        lambda a, s, m: lower_cell(a, s, policy=args.policy,
                                   device=args.device, mesh=m),
        args.out, show)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
