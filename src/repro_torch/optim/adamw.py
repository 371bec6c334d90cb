"""AdamW with global-norm clipping, warmup+cosine schedule and decoupled
weight decay, as plain functions on trees of tensors.

A tree is nested dicts, lists and tuples of tensors, or a
``Transformer``, read through ``Transformer.tree()`` (its layers a list of
per-layer dicts where the reference stacks each leaf under L). Leaves go
in the reference's order: dict keys sorted, then list positions.
Optimizer state mirrors the parameter tree: ``m`` and ``v`` are plain
trees in that layout, ``step`` an int32 scalar tensor.

Nothing here mutates its inputs: ``adamw_update`` and a
``make_train_step`` step return new parameters and new state, as the
reference's functions do, so a caller's parameters can seed several
runs. The update follows the reference's operations in its order (clip
scale, bias corrections from the float step, ``mh / (sqrt(vh) + eps)``,
decay added to ``delta`` before ``lr``), not ``torch.optim.AdamW``'s,
which decays by a separate multiply.

Over a mesh the parameters are ``MeshParams`` and every other tree
holds ``launch.placement.Sharded`` leaves: ``value_and_grad`` runs one
backward over the cells' graph and syncs each leaf's per-cell partials
(``placement.psum_partials``, in fp32) into the parameters' layout;
``global_norm``
counts each element once; ``init_opt_state`` lays ``m``/``v`` out by
``launch.shardings.opt_shardings`` (ZeRO-1 where they say so); and
``adamw_update`` updates each block of ``m``/``v`` once a device, on that
block of the gradient (a view: the reduce-scatter's take), and gathers
the new parameters back to their layout (``placement.reshard``).
``cell_update`` is that sync and update as one cell of an SPMD program
runs it, on its own blocks: what the dry-run traces a chip of a
production mesh by (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.launch.placement import (Sharded, block_slices, gather,
                                          holds, place, psum_partials,
                                          reshard, sync_axes)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_sync_dtype: str = "f32"  # "bf16": gradients rounded to bf16
    # before the update, once summed over the batch (what the reference's
    # cast ahead of its data-axis all-reduce computes: XLA sums over the
    # batch inside the backward, before it)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _view(tree):
    """A ``Transformer``'s (or ``MeshParams``') parameter tree; any other
    tree as it is."""
    return tree.tree() if hasattr(tree, "with_tree") else tree


def _walk(node, path: tuple, out: list) -> None:
    """Append ``node``'s (path, leaf) pairs to ``out``. A module-level
    recursion, not a closure over ``out``: a self-recursive closure is a
    reference cycle, so every tree it collected would wait for the
    garbage collector."""
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (str(k),), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, path + (str(i),), out)
    elif node is not None:
        out.append((path, node))


def leaves_with_path(tree) -> list[tuple[tuple[str, ...], torch.Tensor]]:
    """(path, leaf) pairs in the reference's leaf order: dict keys sorted
    and list positions (as strings), depth first."""
    out: list = []
    _walk(_view(tree), (), out)
    return out


def leaves(tree) -> list[torch.Tensor]:
    return [x for _, x in leaves_with_path(tree)]


def _build(node, it):
    """``node``'s structure with its leaves taken in order from ``it``
    (module-level for the reason ``_walk`` gives)."""
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return None if node is None else next(it)


def unflatten(like, new_leaves, plain: bool = False):
    """``like``'s structure holding ``new_leaves`` (in ``leaves`` order):
    a new ``Transformer`` (``MeshParams``) for a ``Transformer``
    (``MeshParams``) unless ``plain``, which gives its tree layout."""
    out = _build(_view(like), iter(new_leaves))
    if hasattr(like, "with_tree") and not plain:
        return like.with_tree(out)
    return out


def tree_map(fn: Callable, tree, plain: bool = False):
    return unflatten(tree, [fn(x) for x in leaves(tree)], plain)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to ``min_lr_ratio``
    of it, in fp32 as the reference computes it."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.peak_lr * torch.minimum(warm, cos)


def _mesh_params(tree) -> bool:
    return hasattr(tree, "with_tree") and hasattr(tree, "cells")


def init_opt_state(params, shardings=None) -> dict:
    """fp32 zeros ``m`` and ``v`` in the parameters' tree layout and a
    zero int32 ``step`` on their device. For ``MeshParams``, placed by
    ``shardings`` (the port's layout of ``opt_shardings``; default: its
    layout for the parameters' mesh and policy, without ZeRO-1), each
    block of ``m`` and ``v`` once a device."""
    if _mesh_params(params):
        if shardings is None:
            from repro_torch.launch.shardings import opt_shardings
            shardings = opt_shardings(
                params.cfg, params.env.mesh,
                {"m": params, "v": params, "step": torch.zeros(())},
                params.env.policy)
        dev = params.env.mesh.devices.flat[0]

        def zeros(tree_s):
            return unflatten(params, [
                place(torch.zeros(p.shape, dtype=torch.float32, device=dev),
                      where) for p, where in zip(leaves(params),
                                                 leaves(tree_s))],
                plain=True)
        return {"m": zeros(shardings["m"]), "v": zeros(shardings["v"]),
                "step": place(torch.zeros((), dtype=torch.int32,
                                          device=dev), shardings["step"])}

    def zeros():
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params, plain=True)
    dev = leaves(params)[0].device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _decay_mask(path) -> bool:
    """No weight decay on norms / scalars / biases. The reference's test,
    kept as it is: a token matches anywhere in the leaf's name, so "u"
    also exempts every leaf whose name holds a "u" (``w_up``, ``unembed``,
    ``router``, ``out_proj``), a reference defect the port copies."""
    name = str(path[-1]) if path else ""
    return not any(t in name for t in ("ln", "norm", "bias", "b0", "w0",
                                       "beta", "mu", "u", "D", "A_log"))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares. A
    placed leaf (``Sharded``) counts each of its blocks once, whatever
    the cells and devices that hold it, summed on the mesh's first
    cell."""
    return torch.sqrt(sum(_sum_squares(g) for g in leaves(tree)))


def _sum_squares(g) -> torch.Tensor:
    if not isinstance(g, Sharded):
        return torch.sum(torch.square(g.float()))
    dev, seen, total = g.mesh.devices.flat[0], set(), None
    for index in np.ndindex(g.shards.shape):
        x = g.shards[index]
        if x is None:
            continue
        k = tuple((b.start, b.stop) for b in block_slices(
            g.mesh, g.spec, g.shape, index))
        if k not in seen:
            seen.add(k)
            part = torch.sum(torch.square(x.float())).to(dev)
            total = part if total is None else total + part
    return total


def _scalars(cfg: AdamWConfig, step: torch.Tensor, gnorm: torch.Tensor):
    """The step's clip scale, lr and bias corrections (fp32 tensors)."""
    clip = torch.tensor(cfg.clip_norm, dtype=torch.float32,
                        device=gnorm.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    return scale, lr, 1 - cfg.b1 ** step.float(), 1 - cfg.b2 ** step.float()


def _upd(cfg: AdamWConfig, path, p, g, m, v, scale, lr, b1c, b2c):
    """One leaf's (or block's) update, the reference's operations in its
    order."""
    g = g.float() * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    mh = m / b1c
    vh = v / b2c
    delta = mh / (torch.sqrt(vh) + cfg.eps)
    if _decay_mask(path):
        delta = delta + cfg.weight_decay * p.float()
    return (p - lr * delta).to(p.dtype), m, v


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig):
    """Returns (new_params, new_opt_state, metrics); the inputs are left
    as they are. ``metrics``: the pre-clip ``grad_norm`` and the step's
    ``lr``, scalar tensors. Placed (``MeshParams``): ``_update_placed``."""
    if _mesh_params(params):
        return _update_placed(grads, opt_state, params, cfg)
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scalars = _scalars(cfg, step, gnorm)
    new_p, new_m, new_v = [], [], []
    for (path, p), g, m, v in zip(leaves_with_path(params), leaves(grads),
                                  leaves(opt_state["m"]),
                                  leaves(opt_state["v"])):
        np_, nm, nv = _upd(cfg, path, p.detach(), g, m, v, *scalars)
        new_p.append(np_)
        new_m.append(nm)
        new_v.append(nv)
    return (unflatten(params, new_p),
            {"m": unflatten(opt_state["m"], new_m),
             "v": unflatten(opt_state["v"], new_v), "step": step},
            {"grad_norm": gnorm, "lr": scalars[1]})


def _update_placed(grads, opt_state: dict, params, cfg: AdamWConfig):
    """``adamw_update`` of ``MeshParams``: each distinct block of ``m``/
    ``v`` (laid out by ``opt_shardings``, ZeRO-1 or not) updated once a
    device on its block of the synced gradient and of the parameter
    (views of the blocks the cell holds), then the new parameter blocks
    gathered back to the parameters' layout (``reshard``). The step's
    scalars are computed on the mesh's first cell, as one device's
    are."""
    mesh = params.env.mesh
    step = gather(opt_state["step"]) + 1
    gnorm = global_norm(grads)
    scalars = _scalars(cfg, step, gnorm)
    on: dict = {}
    new_p, new_m, new_v = [], [], []
    for (path, p), g, m, v in zip(leaves_with_path(params), leaves(grads),
                                  leaves(opt_state["m"]),
                                  leaves(opt_state["v"])):
        gm = reshard(g, m.sharding)
        pm = reshard(p, m.sharding)
        shards = [np.empty(m.shards.shape, dtype=object) for _ in range(3)]
        done: dict = {}
        for index in np.ndindex(m.shards.shape):
            if m.shards[index] is None:
                continue
            dev = mesh.devices[index]
            k = (dev, tuple((b.start, b.stop) for b in block_slices(
                mesh, m.spec, m.shape, index)))
            if k not in done:
                if dev not in on:
                    on[dev] = tuple(x.to(dev) for x in scalars)
                done[k] = _upd(cfg, path, pm.shards[index].detach(),
                               gm.shards[index], m.shards[index],
                               v.shards[index], *on[dev])
            for out, x in zip(shards, done[k]):
                out[index] = x
        pieces = Sharded(m.sharding, p.shape, p.dtype, shards[0])
        new_p.append(reshard(pieces, p.sharding))
        new_m.append(Sharded(m.sharding, m.shape, m.dtype, shards[1]))
        new_v.append(Sharded(v.sharding, v.shape, v.dtype, shards[2]))
    return (unflatten(params, new_p),
            {"m": unflatten(opt_state["m"], new_m),
             "v": unflatten(opt_state["v"], new_v),
             "step": place(step, opt_state["step"].sharding)},
            {"grad_norm": gnorm, "lr": scalars[1]})


def value_and_grad(fn: Callable, params):
    """(fn(params), d fn / d each leaf) with the gradients as a plain tree
    of ``params``' layout (zeros for a leaf ``fn`` does not read).
    ``params`` is not changed: a ``Transformer``'s own parameters are
    differentiated without accumulating ``.grad``, another tree's leaves
    through detached copies.

    ``MeshParams``: one backward from the loss ``fn`` returns (the cells'
    combined loss) over the cells' graph, to every cell's own leaves; each
    leaf's partials then summed into its placed gradient by
    ``psum_partials``."""
    if _mesh_params(params):
        return _mesh_value_and_grad(fn, params)
    if hasattr(params, "with_tree"):
        work, xs = params, leaves(params)
    else:
        xs = [x.detach().requires_grad_() for x in leaves(params)]
        work = unflatten(params, xs)
    with torch.enable_grad():
        loss = fn(work)
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]
    return loss.detach(), unflatten(params, gs, plain=True)


def cell_partials(fn: Callable, params) -> tuple:
    """(the loss ``fn`` returns for ``MeshParams``, each leaf's partials):
    one backward over the cells' graph to every cell's own leaves; the
    partials of leaf i are an object array of the mesh's shape, each
    cell's gradient of its block (None where the loss does not read
    it)."""
    cells = list(np.ndindex(params.cells.shape))
    per_cell = [leaves(params.cells[index]) for index in cells]
    n = len(per_cell[0])
    with torch.enable_grad():
        loss = fn(params)
        gs = list(torch.autograd.grad(
            loss, [x for xs in per_cell for x in xs], allow_unused=True))
    out = []
    for i in range(n):
        partials = np.empty(params.cells.shape, dtype=object)
        for c, index in enumerate(cells):
            partials[index] = gs[c * n + i]
        out.append(partials)
    return loss.detach(), out


def _mesh_value_and_grad(fn: Callable, params):
    loss, parts = cell_partials(fn, params)
    out = []
    for i, placed in enumerate(leaves(params)):
        out.append(psum_partials(parts[i], placed.sharding, placed.shape))
        parts[i] = None    # freed once summed
    return loss, unflatten(params, out, plain=True)


def _bf16(g):
    """A gradient leaf rounded to bf16; a placed one each distinct block
    once."""
    if not isinstance(g, Sharded):
        return g.to(torch.bfloat16)
    done: dict = {}
    shards = np.empty(g.shards.shape, dtype=object)
    for index in np.ndindex(shards.shape):
        x = g.shards[index]
        if x is not None:
            shards[index] = done.setdefault(id(x), x.to(torch.bfloat16))
    return Sharded(g.sharding, g.shape, torch.bfloat16, shards)


@torch.no_grad()
def cell_update(cell, params, xs, gs, opt_state: dict,
                cfg: AdamWConfig) -> dict:
    """``make_train_step``'s gradient sync and ``adamw_update`` as one cell
    of an SPMD program runs them, on its own blocks: ``cell`` is a
    ``launch.placement.Cell``, ``params`` the placed parameters
    (``MeshParams``), ``xs`` the cell's blocks of their leaves and ``gs``
    its partials of them (None counts as zeros). Each partial is summed
    over the cells that share its block, in cell order as
    ``psum_partials`` sums it, onto the cell's block of ``m``
    (``Cell.psum_scatter`` over ``placement.sync_axes``: a reduce-scatter
    where ZeRO-1 splits ``m`` further, an all-reduce over the block's
    replicas), then rounded to bf16 under a bf16 sync; the global norm
    counts each block once (on the first of its replicas) and is
    all-reduced; each block of ``m``/``v`` the cell holds is updated by
    ``_upd``, and where ZeRO-1 split it the new parameter block is
    all-gathered (``Cell.gather_blocks``). Returns {"params": the cell's
    new parameter blocks, "m", "v": its new blocks of them (None where it
    holds none), "grad_norm"}. Only the sum of squares behind the norm is
    taken in another order than ``adamw_update`` takes it."""
    named = leaves_with_path(params)
    ms, vs = leaves(opt_state["m"]), leaves(opt_state["v"])
    synced, sq = [], torch.zeros((), dtype=torch.float32, device=cell.device)
    for (_, leaf), x, g, m in zip(named, xs, gs, ms):
        g = torch.zeros_like(x) if g is None else g
        scatter, reduce = sync_axes(leaf.sharding, m.sharding)
        sl = None
        if holds(m.sharding, cell.index):
            sl = (slice(None),) * g.ndim
            if m.sharding.stack is None:
                pb = block_slices(cell.mesh, leaf.spec, leaf.shape,
                                  cell.index)
                mb = block_slices(cell.mesh, m.spec, m.shape, cell.index)
                sl = tuple(slice(b.start - a.start, b.stop - a.start)
                           for a, b in zip(pb, mb))
        g = cell.psum_scatter(g, scatter, reduce, sl)
        if g is not None:
            if cfg.grad_sync_dtype == "bf16":
                g = g.to(torch.bfloat16)
            if cell.block(reduce) == 0:
                sq = sq + torch.sum(torch.square(g.float()))
        synced.append((g, sl, scatter))
    gnorm = torch.sqrt(cell.psum(sq, cell.mesh.axis_names))
    scalars = _scalars(cfg, opt_state["step"].local(cell) + 1, gnorm)
    out = {"params": [], "m": [], "v": [], "grad_norm": gnorm}
    for (path, _), x, (g, sl, scatter), m, v in zip(named, xs, synced, ms,
                                                    vs):
        new = nm = nv = None
        if g is not None:
            new, nm, nv = _upd(cfg, path, x.detach()[sl], g, m.local(cell),
                               v.local(cell), *scalars)
        if scatter:
            new = cell.gather_blocks(new, sl, scatter, x.shape, x.dtype)
        out["params"].append(new)
        out["m"].append(nm)
        out["v"].append(nv)
    return out


def make_train_step(cfg_arch, env, opt_cfg: AdamWConfig,
                    loss_fn: Callable | None = None):
    """Builds the (params, opt_state, batch) -> (params, opt_state,
    metrics) step: the loss (``forward_loss`` by default) and its
    gradients, rounded to bf16 under ``grad_sync_dtype="bf16"``, then
    ``adamw_update``. ``metrics`` adds the step's ``loss``. Given
    ``MeshParams`` (placed for ``env``) and placed state, the gradients
    are the whole mesh's: each cell's partials summed in fp32, the sum
    rounded to bf16 under ``grad_sync_dtype="bf16"``. That is what the
    reference computes on 8 virtual CPU devices (its bf16 gradients are
    the fp32 sums rounded, within one bf16 rounding of its fp32 ones, no
    element zeroed): XLA reduces over the batch inside the backward's
    products, before the cast it pins ahead of the step's own sync.
    Rounding each partial first zeroes elements whose partials cancel,
    and the loss's onehot(argmax) term then turns those into large
    differences a step later."""
    from repro_torch.models.transformer import forward_loss
    lfn = loss_fn or forward_loss

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p: lfn(p, batch, cfg_arch, env), params)
        if opt_cfg.grad_sync_dtype == "bf16":
            grads = tree_map(_bf16, grads)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg)
        return params, opt_state, {**metrics, "loss": loss}

    return train_step
