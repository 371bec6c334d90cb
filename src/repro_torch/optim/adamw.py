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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn


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
    # before the update (the reference casts them ahead of its data-axis
    # all-reduce; on one device the rounding is all that is left)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _view(tree):
    """A ``Transformer``'s parameter tree; any other tree as it is."""
    return tree.tree() if isinstance(tree, nn.Module) else tree


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
    a new ``Transformer`` for a ``Transformer`` unless ``plain``, which
    gives its tree layout."""
    out = _build(_view(like), iter(new_leaves))
    if isinstance(like, nn.Module) and not plain:
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


def init_opt_state(params) -> dict:
    """fp32 zeros ``m`` and ``v`` in the parameters' tree layout and a
    zero int32 ``step`` on their device."""
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
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig):
    """Returns (new_params, new_opt_state, metrics); the inputs are left
    as they are. ``metrics``: the pre-clip ``grad_norm`` and the step's
    ``lr``, scalar tensors."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.tensor(cfg.clip_norm, dtype=torch.float32,
                        device=gnorm.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(path, p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if _decay_mask(path):
            delta = delta + cfg.weight_decay * p.float()
        return (p - lr * delta).to(p.dtype), m, v

    new_p, new_m, new_v = [], [], []
    for (path, p), g, m, v in zip(leaves_with_path(params), leaves(grads),
                                  leaves(opt_state["m"]),
                                  leaves(opt_state["v"])):
        np_, nm, nv = upd(path, p.detach(), g, m, v)
        new_p.append(np_)
        new_m.append(nm)
        new_v.append(nv)
    return (unflatten(params, new_p),
            {"m": unflatten(opt_state["m"], new_m),
             "v": unflatten(opt_state["v"], new_v), "step": step},
            {"grad_norm": gnorm, "lr": lr})


def value_and_grad(fn: Callable, params):
    """(fn(params), d fn / d each leaf) with the gradients as a plain tree
    of ``params``' layout (zeros for a leaf ``fn`` does not read).
    ``params`` is not changed: a ``Transformer``'s own parameters are
    differentiated without accumulating ``.grad``, another tree's leaves
    through detached copies."""
    if isinstance(params, nn.Module):
        work, xs = params, leaves(params)
    else:
        xs = [x.detach().requires_grad_() for x in leaves(params)]
        work = unflatten(params, xs)
    with torch.enable_grad():
        loss = fn(work)
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]
    return loss.detach(), unflatten(params, gs, plain=True)


def make_train_step(cfg_arch, env, opt_cfg: AdamWConfig,
                    loss_fn: Callable | None = None):
    """Builds the (params, opt_state, batch) -> (params, opt_state,
    metrics) step: the loss (``forward_loss`` by default) and its
    gradients, rounded to bf16 under ``grad_sync_dtype="bf16"``, then
    ``adamw_update``. ``metrics`` adds the step's ``loss``."""
    from repro_torch.models.transformer import forward_loss
    lfn = loss_fn or forward_loss

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(
            lambda p: lfn(p, batch, cfg_arch, env), params)
        if opt_cfg.grad_sync_dtype == "bf16":
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        params, opt_state, metrics = adamw_update(grads, opt_state, params,
                                                  opt_cfg)
        return params, opt_state, {**metrics, "loss": loss}

    return train_step
