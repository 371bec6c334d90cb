"""Architecture-generic LM: init, training loss, prefill, decode and
encode, for every family.

One layer loop covers dense GQA (llama / minitron / smollm and the
internvl backbone, which takes precomputed patch embeddings), gemma3's
local:global sliding-window interleave, MoE FFNs (dbrx, kimi-k2 with its
shared expert; ``models/moe.py``), hymba's parallel attention + mamba
heads (``models/mamba.py``), attention-free rwkv6 (``models/rwkv6.py``)
and whisper's encoder-decoder (a non-causal encoder over precomputed
frame embeddings, then decoder blocks with cross-attention to its
output).

Parameters are an ``nn.Module`` (``Transformer``): one ``Tree`` per
layer where the reference stacks every leaf under a leading L dim for its
scan; the leaves keep the reference's names, shapes and fp32 storage, and
every pass casts them as the reference does. ``forward_loss`` runs under
autograd, each layer rematerialized in the backward pass
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` with
``nothing_saveable``); ``prefill``, ``decode_step`` and ``encode`` run
without it. Every pass runs on the device the parameters live on.

Over a device mesh (``ShardEnv(mesh, data_axes, model_axis, policy)``)
the serving passes and ``forward_loss`` of every family run on every
cell
(``launch.placement.run_cells``): the parameters placed by
``param_shardings`` (``MeshParams``: each cell's module of its blocks,
views where the cell is on their device), the batch split as the
reference's ``act3`` lays out the residual stream, and each cell's pass
the one-device pass on its local heads, KV heads, FFN width, experts,
mamba channels, rwkv6 heads and vocab, joined where the reference's
constraints and shard_maps imply: a sum over ``model`` after each
row-parallel product (``wo``, ``w_down``, ``out_proj``, ``cm_v``,
``cm_r``) where it is split, the gathers mamba and rwkv6 need where their
blocks do not line up (``models/{mamba,rwkv6}.py``), a gather of the
vocab-split logits, the MoE's all_to_alls and psum (``models/moe.py``),
the flash-decode combine where the cache's sequence is split (a hybrid
ring's slots too), and the relayouts between the residual stream's
layout and the full sequence's under "sp". Every state a layer leaves
(K/V, the ring's slots, mamba's and rwkv6's states, whisper's cross
K/V) is stored into its cell's block of the cache placed by
``cache_shardings``. A mesh of one cell runs the one-device pass on
that cell's device, bit for bit.

``forward_loss`` over the cells is one autograd graph: each cell's
module holds its own ``Parameter`` leaves (views of the placed blocks),
the collectives are plain differentiable tensor ops between the cells'
tensors, and the loss the cells return is combined on the caller's
thread, where one backward runs (``optim.adamw.value_and_grad``). So each
cell's gradient is a partial of its own, which the sync sums
(``launch.placement.psum_partials``). Over more than one cell no layer
is rematerialized: a recompute would run during the backward, on
autograd's thread, where no cell runs to meet its collectives. That
costs activation memory (``PERF.md`` §6: llama3.2-1b at 8 x 128 tokens
on 2 x 4), not numbers.

Two differences from the reference, on purpose, both in the decode
cache (ROADMAP queue 3):
* its dense and moe ``prefill`` keeps a cache exactly as long as the
  prompt, so every ``decode_step`` overwrites the last prompt position's
  K/V (``src/repro/models/transformer.py:371,436,439``). The port's
  ``prefill`` takes the cache length to leave room for; ``decode_step``
  then computes what ``prefill`` over the longer sequence computes, and
  raises when the cache is full;
* its hybrid ring keeps the prompt's last ``min(window, S)`` positions in
  order (``:274-276``) but decodes at ``pos % S_cache`` (``:435``), so a
  prompt shorter than the window loses its first token to the first
  decode, and a longer one not a multiple of the window evicts the wrong
  position. The port's ring holds ``min(window, cache_len)`` slots with
  position p at ``p % ring``, so it always holds the window.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.device_atlas import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.placement import (NamedSharding, P, Sharded,
                                          block_index, fit, full_spec,
                                          gather, map_with_path, place,
                                          place_tree, run_cells)
from repro_torch.launch.shardings import param_shardings
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (CDT, embed_lookup, init_dense,
                                       pad_vocab, rms_norm, rope,
                                       softmax_xent, swiglu, unembed_logits)
from repro_torch.models.kvcache import KV_LEAVES, init_cache
from repro_torch.models.mamba import (dt_rank, init_mamba, mamba_forward,
                                      own_channels)
from repro_torch.models.moe import MoEDims, moe_cell, moe_ffn
from repro_torch.models.rwkv6 import (init_rwkv_layer, own_heads,
                                      rwkv_channel_mix, rwkv_time_mix)


@dataclasses.dataclass(frozen=True)
class ShardEnv:
    """Mesh + axis naming (the reference's). ``mesh=None``: one device, no
    collectives. ``mesh``: a ``launch.mesh.Mesh``; a mesh of one cell
    runs the one-device pass on that cell's device.

    policy="tp": TP over the model axis (default). policy="dp": pure data
    parallel: batch over ALL mesh axes, params replicated. policy="sp":
    TP params with the residual stream's SEQUENCE split over the model
    axis (Megatron-SP).

    The reference's constraint helpers (``dp3``, ``logits3``, ``act3``,
    ``heads4``) place a tensor on the mesh by the spec the reference
    constrains it to (``*_spec``; a dim its axes do not divide is kept
    whole). Inside a cell's pass (``at``) the same specs say how the
    cell's block is laid out, and ``to_full``/``to_act`` relayout it."""
    mesh: Any = None
    data_axes: tuple = ("data",)
    model_axis: str = "model"
    policy: str = "tp"   # tp | dp | sp (sequence-parallel residual stream)
    # inside a cell's pass: the cell, the global batch and sequence
    cell: Any = dataclasses.field(default=None, compare=False, repr=False)
    batch: int = dataclasses.field(default=0, compare=False, repr=False)
    seq: int = dataclasses.field(default=0, compare=False, repr=False)

    def __post_init__(self):
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(
                f"ShardEnv: mesh must be a repro_torch.launch.mesh.Mesh or "
                f"None, not {type(self.mesh).__name__}")
        if self.policy not in ("tp", "dp", "sp"):
            raise ValueError(f"ShardEnv: unknown policy {self.policy!r}")

    @property
    def n_model(self) -> int:
        return self.mesh.shape[self.model_axis] if self.mesh is not None else 1

    @property
    def cells(self) -> int:
        """Cells on the mesh (1 without one)."""
        return 1 if self.mesh is None else int(self.mesh.devices.size)

    @property
    def batch_axes(self) -> tuple:
        if self.policy == "dp":
            return tuple(self.data_axes) + (self.model_axis,)
        return self.data_axes

    def _b_axes(self, b: int):
        ax = self.batch_axes
        if self.mesh is None:
            return ax
        n = 1
        for a in ax:
            n *= self.mesh.shape[a]
        if b % n:
            return self.data_axes  # fall back when batch won't split
        return ax

    def dp3_spec(self, shape) -> P:   # (B, S, d), sequence replicated
        return P(self._b_axes(shape[0]), None, None)

    def logits3_spec(self, shape) -> P:
        if self.policy == "dp":
            return P(self._b_axes(shape[0]), None, None)
        return P(self.data_axes, None, self.model_axis)

    def act3_spec(self, shape) -> P:
        if self.policy == "sp" and shape[1] % max(self.n_model, 1) == 0 \
                and self.n_model > 1:
            return P(self.data_axes, self.model_axis, None)
        return self.dp3_spec(shape)

    def heads4_spec(self, shape) -> P:   # (B, S, H, hd)
        if self.policy != "dp" and shape[2] % max(self.n_model, 1) == 0 \
                and self.n_model > 1:
            return P(self.data_axes, None, self.model_axis, None)
        return P(self._b_axes(shape[0]), None, None, None)

    def constrain(self, x, spec):
        """``x`` (a tensor, or ``Sharded``) placed on the mesh by ``spec``
        fitted to its shape; ``x`` itself without a mesh."""
        if self.mesh is None:
            return x
        if isinstance(x, Sharded):
            x = gather(x)
        return place(x, NamedSharding(self.mesh, fit(self.mesh, spec,
                                                     x.shape)))

    def dp3(self, x):
        return self.constrain(x, self.dp3_spec(x.shape))

    def logits3(self, x):
        return self.constrain(x, self.logits3_spec(x.shape))

    def act3(self, x):
        return self.constrain(x, self.act3_spec(x.shape))

    def heads4(self, x):
        return self.constrain(x, self.heads4_spec(x.shape))

    # -- inside a cell's pass --------------------------------------------

    def at(self, cell, batch: int, seq: int) -> "ShardEnv":
        """This env inside ``cell``'s pass over a (batch, seq) input."""
        return dataclasses.replace(self, cell=cell, batch=batch, seq=seq)

    def act(self) -> P:
        """The residual stream's layout (B, S, d) in this pass."""
        shape = (self.batch, self.seq, 1)
        return fit(self.mesh, self.act3_spec(shape), shape)

    def full(self) -> P:
        """The full sequence's layout (B, S, d): what attention, the FFN
        and the LM head take."""
        shape = (self.batch, self.seq, 1)
        return fit(self.mesh, self.dp3_spec(shape), shape)

    def to_full(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.cell is None else \
            self.cell.relayout(x, self.act(), self.full())

    def to_act(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.cell is None else \
            self.cell.relayout(x, self.full(), self.act())

    def sum_model(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the model axis of a row-parallel product's
        partials (in cell order)."""
        return x if self.cell is None else \
            self.cell.psum(x, self.model_axis)


ONE_DEVICE = ShardEnv(None)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Tree(nn.Module):
    """A dict of the reference's parameter leaves as a module: each fp32
    tensor a ``Parameter`` under its leaf name, each sub-dict a child
    ``Tree`` (read as ``p.attn.wq``, ``p.ffn.router``, ``p.mamba.A_log``,
    or rwkv6's flat ``p.wr``)."""

    def __init__(self, leaves: dict):
        super().__init__()
        for name, v in leaves.items():
            if isinstance(v, dict):
                self.add_module(name, Tree(v))
            else:
                self.register_parameter(name, nn.Parameter(v))


def _tree(module: nn.Module) -> dict:
    """A module's parameters as a dict by leaf name, a ``ModuleList`` as
    a list of its layers' dicts."""
    out: dict = {n: p for n, p in module._parameters.items()
                 if p is not None}
    for n, child in module._modules.items():
        out[n] = ([_tree(c) for c in child]
                  if isinstance(child, nn.ModuleList) else _tree(child))
    return out


class Transformer(nn.Module):
    """Every parameter of an LM: the embedding (none for a ``patch``
    frontend, which feeds embeddings), the layers, the final norm, the
    (padded-vocab) unembedding and, for an encoder-decoder (whisper), the
    encoder's layers and final norm."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        """``tree``: {"unembed", "final_norm", "layers": [one dict of the
        reference's leaves a layer], "embed" unless the frontend is
        ``patch``, and "enc_layers" and "enc_final_norm" where the config
        has encoder layers}, all fp32 tensors on one device."""
        super().__init__()
        self.cfg = cfg
        self.unembed = nn.Parameter(tree["unembed"])
        self.final_norm = nn.Parameter(tree["final_norm"])
        self.layers = nn.ModuleList(Tree(lp) for lp in tree["layers"])
        self.embed = (nn.Parameter(tree["embed"])
                      if cfg.frontend != "patch" else None)
        self.enc_layers = self.enc_final_norm = None
        if cfg.n_enc_layers:
            self.enc_layers = nn.ModuleList(Tree(lp)
                                            for lp in tree["enc_layers"])
            self.enc_final_norm = nn.Parameter(tree["enc_final_norm"])

    @property
    def device(self) -> torch.device:
        return self.unembed.device

    def tree(self) -> dict:
        """The parameters as the reference's tree of leaves, with
        ``layers`` (and ``enc_layers``) a list of per-layer dicts where
        the reference stacks each leaf; the values are this module's own
        ``Parameter``s."""
        return _tree(self)

    def with_tree(self, tree: dict) -> "Transformer":
        """A new module of this config holding ``tree``'s tensors (in
        ``tree()``'s layout); this one is left as it is."""
        return Transformer(self.cfg, tree)


def on_device(params: Transformer, device) -> Transformer:
    """``params`` itself where it already lives on ``device``, else a copy
    there. The caller's module never moves (``nn.Module.to`` moves in
    place; the reference's parameters are immutable), so two users on
    different devices can share one module."""
    dev = torch.empty(0, device=device).device  # "cuda" -> "cuda:0"
    return params if params.device == dev else copy.deepcopy(params).to(dev)


class MeshParams:
    """A ``Transformer`` placed on ``env``'s mesh by ``param_shardings``
    (``placed``: each leaf ``Sharded``) and, for each cell, a
    ``Transformer`` of its blocks (``local``), whose ``Parameter``s are
    that cell's own autograd leaves. Where every cell is on the
    parameters' device the blocks are views of them and a replicated leaf
    is the tensor itself: placing costs no memory."""

    def __init__(self, params: Transformer, env: ShardEnv):
        self._build(params.cfg, env, place_tree(params.tree(), param_shardings(
            params.cfg, env.mesh, params, env.policy)))

    @classmethod
    def from_placed(cls, cfg: ArchConfig, env: ShardEnv,
                    placed: dict) -> "MeshParams":
        """Parameters already placed on ``env``'s mesh (a tree in
        ``tree()``'s layout of ``Sharded`` leaves laid out by
        ``param_shardings``, as an update or a restore returns them):
        no leaf is copied."""
        out = cls.__new__(cls)
        out._build(cfg, env, placed)
        return out

    def _build(self, cfg: ArchConfig, env: ShardEnv, placed: dict) -> None:
        self.cfg, self.env, self.placed = cfg, env, placed
        self.cells = np.empty(env.mesh.devices.shape, dtype=object)
        for index in np.ndindex(self.cells.shape):
            self.cells[index] = Transformer(cfg, map_with_path(
                lambda _, leaf: leaf.local(index), placed))

    def local(self, cell) -> Transformer:
        return self.cells[cell.index]

    def tree(self) -> dict:
        """The placed leaves (``Sharded``) in ``Transformer.tree()``'s
        layout."""
        return self.placed

    def with_tree(self, tree: dict) -> "MeshParams":
        """``from_placed`` on this mesh and policy."""
        return MeshParams.from_placed(self.cfg, self.env, tree)


def place_params(params, env: ShardEnv):
    """``params`` ready for ``env``'s passes: as they are without a mesh;
    on the cell's device for a mesh of one cell (``on_device``); placed
    (``MeshParams``) on a larger mesh, unless they already are."""
    if isinstance(params, MeshParams):
        return _placed(params, env, "place_params")
    if env.mesh is None:
        return params
    if env.cells == 1:
        return on_device(params, env.mesh.devices.flat[0])
    return MeshParams(params, env)


def _placed(params, env: ShardEnv, what: str):
    """``params`` where they are as ``env``'s passes take them, else a
    ValueError: as they are without a mesh; on the cell's device for a
    mesh of one cell; placed for this mesh and policy on a larger one.
    A pass never places them itself, which would copy the model at every
    call: the caller does, once (``place_params``)."""
    if env.mesh is None:
        ok = not isinstance(params, MeshParams)
    elif env.cells == 1:
        ok = (isinstance(params, Transformer)
              and params.device == env.mesh.devices.flat[0])
    else:
        ok = (isinstance(params, MeshParams) and params.env.mesh is env.mesh
              and params.env.policy == env.policy)
    if not ok:
        raise ValueError(f"{what}: the parameters are not placed for this "
                         f"mesh and policy (place them once with "
                         f"place_params)")
    return params


def _init_ffn(gen, d: int, f: int) -> dict:
    return {"w_gate": init_dense(gen, (d, f)), "w_up": init_dense(gen, (d, f)),
            "w_down": init_dense(gen, (f, d))}


def _init_moe(gen, cfg: ArchConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": init_dense(gen, (d, E), scale=0.02),
         "w1": init_dense(gen, (E, d, f)), "w3": init_dense(gen, (E, d, f)),
         "w2": init_dense(gen, (E, f, d))}
    if cfg.n_shared_experts:
        p["shared"] = _init_ffn(gen, d, f * cfg.n_shared_experts)
    return p


def _init_attn(gen, cfg: ArchConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": init_dense(gen, (d, H * hd)),
            "wk": init_dense(gen, (d, KV * hd)),
            "wv": init_dense(gen, (d, KV * hd)),
            "wo": init_dense(gen, (H * hd, d))}


def _init_layer(gen, cfg: ArchConfig, cross: bool = False) -> dict:
    """One layer's leaves; ``cross`` adds a decoder layer's
    cross-attention (``ln_cross``, ``cross``)."""
    d = cfg.d_model
    p = {"ln1": torch.zeros(d, device=gen.device),
         "ln2": torch.zeros(d, device=gen.device)}
    if cfg.family == "ssm":
        return {**p, **init_rwkv_layer(gen, d, cfg.d_ff, cfg.rwkv_head_size)}
    p["attn"] = _init_attn(gen, cfg)
    if cross:
        p["ln_cross"] = torch.zeros(d, device=gen.device)
        p["cross"] = _init_attn(gen, cfg)
    if cfg.family == "hybrid":
        p["mamba"] = init_mamba(gen, d, cfg.ssm_expand * d, cfg.ssm_state,
                                dt_rank=dt_rank(d))
        p["beta"] = torch.zeros(2, device=gen.device)
    p["ffn"] = _init_moe(gen, cfg) if cfg.is_moe else \
        _init_ffn(gen, d, cfg.d_ff)
    return p


class _MetaDraws:
    """What ``init_params`` reads of a generator on the ``meta`` device,
    where ``torch.Generator`` does not exist: its device."""
    device = torch.device("meta")


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Transformer:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (None means CUDA), by the reference's recipe: normal at
    1/sqrt(fan_in) for the projections and experts, 0.02 for the
    embeddings and the router, zeros for the norm scales, and the mamba
    and rwkv6 leaves' own constants (its numbers differ, since jax draws
    its own). An audio config's decoder layers also draw their
    cross-attention, and its encoder layers come last. On the ``meta``
    device nothing is drawn or allocated: the leaves are shapes alone, the
    dry-run's stand-ins (``launch/dryrun.py``)."""
    dev = resolve_device(device)
    gen = (_MetaDraws() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    v_pad, d = pad_vocab(cfg.vocab_size), cfg.d_model
    layers = [_init_layer(gen, cfg, cross=cfg.family == "audio")
              for _ in range(cfg.n_layers)]
    tree = {"unembed": init_dense(gen, (v_pad, d), scale=0.02),
            "final_norm": torch.zeros(d, device=gen.device), "layers": layers}
    if cfg.frontend != "patch":
        tree["embed"] = init_dense(gen, (v_pad, d), scale=0.02)
    if cfg.n_enc_layers:
        tree["enc_layers"] = [_init_layer(gen, cfg)
                              for _ in range(cfg.n_enc_layers)]
        tree["enc_final_norm"] = torch.zeros(d, device=gen.device)
    return Transformer(cfg, tree)


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _layer_windows(cfg: ArchConfig) -> list[int]:
    """Per-layer attention window (0 = full/global)."""
    if cfg.local_global_ratio:  # gemma3: 5 local then 1 global, repeating
        r = cfg.local_global_ratio
        return [0 if (i % (r + 1)) == r else cfg.sliding_window
                for i in range(cfg.n_layers)]
    return [cfg.sliding_window] * cfg.n_layers


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return h @ w.to(h.dtype)


def _chunk(n: int, most: int) -> int:
    """The attention chunk for a length ``n``: the reference's (``most``,
    or ``n`` where shorter) wherever that divides ``n``, else the largest
    divisor of ``n`` below it. The reference asserts instead, so it
    cannot attend Whisper's 1,500 encoder frames; the port takes chunks
    of 500 and 750 there."""
    return next(c for c in range(min(n, most), 0, -1) if n % c == 0)


def _kv_groups(k, v, cfg: ArchConfig, n_q: int, env: ShardEnv):
    """The K/V heads a cell's ``n_q`` query heads read. Where the query
    heads are split over the model axis but the KV heads are not (they do
    not divide it, e.g. gemma3's one), head h reads group h // G: the
    groups of this cell's heads, contiguous where its heads cover whole
    groups, else one a head."""
    if n_q == cfg.n_heads or k.shape[2] < cfg.n_kv_heads:
        return k, v
    G = cfg.n_heads // cfg.n_kv_heads
    h0 = env.cell.block(env.model_axis) * n_q
    if n_q % G == 0:
        g0 = h0 // G
        return k[:, :, g0:g0 + n_q // G], v[:, :, g0:g0 + n_q // G]
    idx = torch.div(h0 + torch.arange(n_q, device=k.device), G,
                    rounding_mode="floor")
    return k[:, :, idx], v[:, :, idx]


def _attend_full(p: Tree, h, cfg: ArchConfig, window: int, positions,
                 causal: bool = True, kv=None, env: ShardEnv = ONE_DEVICE):
    """Chunked attention. h: (B, S, d). Self-attention (``kv`` None)
    rotates q and k by RoPE; cross-attention takes k and v from ``kv``
    (B, Sk, d), unrotated and unmasked. Returns the output and the
    layer's (k, v), (B, Sk, KV, hd) each. In a cell the head counts are
    its own (its blocks of ``wq``, ``wk``, ``wv``), and where ``wo`` is
    split the output is the sum of the cells' products."""
    B, S, _ = h.shape
    hd = cfg.hd
    H, KV = p.wq.shape[1] // hd, p.wk.shape[1] // hd
    src = h if kv is None else kv
    Sk = src.shape[1]
    q = _proj(h, p.wq).reshape(B, S, H, hd)
    k = _proj(src, p.wk).reshape(B, Sk, KV, hd)
    v = _proj(src, p.wv).reshape(B, Sk, KV, hd)
    if kv is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    ka, va = _kv_groups(k, v, cfg, H, env)
    o = attn_lib.chunked_attention(q, ka, va, causal=causal and kv is None,
                                   window=window, q_chunk=_chunk(S, 512),
                                   kv_chunk=_chunk(Sk, 1024))
    out = _proj(o.reshape(B, S, H * hd), p.wo)
    return (env.sum_model(out) if H < cfg.n_heads else out), (k, v)


def _swiglu(p: Tree, h: torch.Tensor, f: int = 0,
            env: ShardEnv = ONE_DEVICE) -> torch.Tensor:
    """A SwiGLU of hidden width ``f``; in a cell whose block of it is
    narrower, the sum of the cells' products."""
    y = swiglu(h, p.w_gate.to(h.dtype), p.w_up.to(h.dtype),
               p.w_down.to(h.dtype))
    return env.sum_model(y) if p.w_down.shape[0] < f else y


def _ffn_apply(p: Tree, h: torch.Tensor, cfg: ArchConfig, mode: str,
               env: ShardEnv = ONE_DEVICE) -> torch.Tensor:
    """The layer's FFN: a SwiGLU, or the MoE (capacity-bounded outside
    decode, dropless in it; in a cell, ``moe_cell``) plus kimi-k2's
    shared expert. In a cell ``h`` is laid out as ``env.full()``."""
    if not cfg.is_moe:
        return _swiglu(p, h, cfg.d_ff, env)
    dims = MoEDims(cfg.n_experts, cfg.moe_top_k, cfg.capacity_factor)
    if env.cell is None:
        y = moe_ffn(h, p, dims, mode=mode)
    else:
        y = moe_cell(h, p, dims, env.cell, env.full(),
                     (env.batch, env.seq, h.shape[-1]), env.model_axis,
                     env.data_axes, mode)
    if cfg.n_shared_experts:
        y = y + _swiglu(p.shared, h, cfg.d_ff * cfg.n_shared_experts, env)
    return y


def _mix_heads(beta: torch.Tensor, ao: torch.Tensor,
               mo: torch.Tensor) -> torch.Tensor:
    """Hymba's parallel heads: sigmoid(beta)-weighted sum in fp32."""
    b = torch.sigmoid(beta.float())
    return (b[0] * ao.float() + b[1] * mo.float()).to(ao.dtype)


def _block_forward(p: Tree, h, cfg: ArchConfig, window: int, positions,
                   mode: str, enc_out=None, causal: bool = True,
                   env: ShardEnv = ONE_DEVICE):
    """One block (train/prefill/encode path). Returns (h, the layer's
    decode state: k/v, plus mamba's ssm/conv for hybrid, the cross K/V
    ck/cv where ``enc_out`` is given; rwkv6's wkv and shift tails for
    ssm). In a cell, ``h`` is its block of the residual stream
    (``env.act()``); attention, mamba, rwkv6's mixes, the cross-attention
    and the FFN take the full sequence (``enc_out`` too), each on the
    cell's heads, channels or hidden block, and the states returned are
    the cell's blocks of them."""
    eps = cfg.norm_eps
    cell, ax = env.cell, env.model_axis
    if cfg.family == "ssm":
        y, (shift_tm, wkv) = rwkv_time_mix(
            p, env.to_full(rms_norm(h, p.ln1, eps)), None,
            cfg.rwkv_head_size, cell, ax)
        h = h + env.to_act(y)
        y, shift_cm = rwkv_channel_mix(
            p, env.to_full(rms_norm(h, p.ln2, eps)), None, cell, ax,
            cfg.d_ff)
        return h + env.to_act(y), {"wkv": wkv, "shift_tm": shift_tm,
                                   "shift_cm": shift_cm}
    hybrid = cfg.family == "hybrid"
    hn = env.to_full(rms_norm(h, p.ln1, eps))
    ao, (k, v) = _attend_full(p.attn, hn, cfg, window, positions, causal,
                              env=env)
    state = {"k": k, "v": v}
    if hybrid:
        mo, (state["ssm"], state["conv"]) = mamba_forward(
            p.mamba, hn, None, cell, ax)
        ao = _mix_heads(p.beta, ao, mo)
    h = h + env.to_act(ao)
    if enc_out is not None:  # whisper decoder: cross-attend to the encoder
        co, (state["ck"], state["cv"]) = _attend_full(
            p.cross, env.to_full(rms_norm(h, p.ln_cross, eps)), cfg, 0,
            positions, kv=enc_out, env=env)
        h = h + env.to_act(co)
    y = _ffn_apply(p.ffn, env.to_full(rms_norm(h, p.ln2, eps)), cfg, mode,
                   env)
    return h + env.to_act(y), state


def _block_out(p: Tree, h, cfg: ArchConfig, window: int, positions,
               mode: str, enc_out, causal: bool):
    """``_block_forward``'s h alone: what a rematerialized layer keeps."""
    return _block_forward(p, h, cfg, window, positions, mode, enc_out,
                          causal)[0]


def _store(cache: dict, li: int, state: dict,
           env: ShardEnv = ONE_DEVICE) -> None:
    """Layer ``li``'s prefill state into the cache. K/V of positions
    0..S-1 go to slot ``p % R`` of the cache's R slots, the last
    ``min(S, R)`` of them kept (R >= S but for a hybrid ring shorter than
    the prompt); the recurrent states are copied whole. In a cell, every
    leaf is relaid out as the cache is placed (``cache_shardings``) and
    each cell writes its block (of K/V, the slots it holds)."""
    if env.cell is not None:
        for name, x in state.items():
            now = _state_now(name, x, cache[name], env)
            if name in KV_LEAVES:
                _store_kv_cell(cache[name], li, x, now, env)
            else:
                _write_state(cache, li, name, x, now, env)
        return
    for name, x in state.items():
        if name not in KV_LEAVES:
            cache[name][li] = x
            continue
        S, R = x.shape[1], cache[name].shape[2]
        m = min(S, R)
        slots = torch.arange(S - m, S, device=x.device) % R
        cache[name][li][:, slots] = x[:, S - m:]


def _cache_layout(leaf: Sharded) -> tuple:
    """A placed cache leaf's per-layer layout: one entry a dim after L
    (for K/V: batch, seq, KV heads, hd), each a tuple of axes."""
    return full_spec(leaf.spec, len(leaf.shape))[1:]


def _state_now(name: str, x: torch.Tensor, leaf: Sharded,
               env: ShardEnv) -> tuple:
    """How a cell's block ``x`` of layer state ``name`` is laid out in its
    pass: the batch as the full sequence's (``env.full()``), and the KV
    heads, channels or heads over the model axis where ``x`` holds fewer
    than the leaf (a cell's block of them)."""
    ax = env.model_axis

    def split(dx, dl):
        return ax if x.shape[dx] < leaf.shape[dl] else None

    b = env.full()[0]
    if name in KV_LEAVES:           # (B, S, KV, hd)
        return (b, None, split(2, 3), None)
    if name in ("ssm", "wkv"):      # (B, d_in, N) / (B, H, N, N)
        return (b, split(1, 2), None, None)[:x.ndim]
    if name == "conv":              # (B, CONV_K - 1, d_in)
        return (b, None, split(2, 3))
    return (b, None)                # shift tails (B, d)


def _store_kv_cell(leaf: Sharded, li: int, x: torch.Tensor, now: tuple,
                   env: ShardEnv) -> None:
    """A cell's K or V (or cross K/V; its batch block and heads, laid out
    as ``now``, every position) into its block of the placed cache:
    relaid out to the cache's batch and heads, then the positions of the
    slots the cell holds (position p in slot ``p % R``, the last
    ``min(S, R)`` positions kept). Those positions fill at most two runs
    of slots, from ``p0 % R`` to the end and from slot 0 on; each is
    cut to the cell's slots and copied as a slice, so the host never
    waits for the device."""
    b, s, kv, _ = _cache_layout(leaf)
    dst = leaf.local(env.cell)[li]
    x = env.cell.relayout(x, now, (b, None, kv, None))
    S, R = x.shape[1], leaf.shape[2]
    lo = env.cell.block(s) * dst.shape[1]
    hi = lo + dst.shape[1]
    p0 = S - min(S, R)
    first = min(S - p0, R - p0 % R)
    for pos, slot, n in ((p0, p0 % R, first), (p0 + first, 0, S - p0 - first)):
        a, z = max(slot, lo), min(slot + n, hi)
        if a < z:
            dst[:, a - lo:z - lo] = x[:, pos + a - slot:pos + z - slot]


def _read_state(cache: dict, li: int, name: str, now: tuple,
                env: ShardEnv) -> torch.Tensor:
    """Layer ``li``'s state ``name`` as a decode step takes it: the
    cache's own tensor without a cell; in a cell, a copy of its block
    relaid out to ``now`` (a copy, so no cell reads a block another has
    overwritten)."""
    leaf = cache[name]
    if env.cell is None:
        return leaf[li]
    return env.cell.relayout(leaf.local(env.cell)[li].clone(),
                             _cache_layout(leaf), now)


def _write_state(cache: dict, li: int, name: str, x: torch.Tensor,
                 now: tuple, env: ShardEnv) -> None:
    """``_read_state``'s inverse: ``x`` (laid out as ``now`` in a cell)
    into layer ``li``'s block of the cache."""
    leaf = cache[name]
    if env.cell is None:
        leaf[li] = x
        return
    leaf.local(env.cell)[li].copy_(env.cell.relayout(x, now,
                                                     _cache_layout(leaf)))


def _stack_forward(params: Transformer, cfg: ArchConfig, h,
                   mode: str = "prefill", cache=None, enc_out=None,
                   encoder: bool = False, remat: bool = False,
                   env: ShardEnv = ONE_DEVICE):
    """Every layer in order, each with its own window (the encoder's,
    ``encoder=True``: all global and non-causal); with ``cache``, each
    layer's decode state stored there (``_store``); with ``remat``, each
    layer recomputed in the backward pass, only its input kept."""
    S = h.shape[1] if env.cell is None else env.seq
    positions = torch.arange(S, device=h.device)[None, :]
    if encoder:
        layers, windows, causal = (params.enc_layers,
                                   [0] * len(params.enc_layers), False)
    else:
        layers, windows, causal = params.layers, _layer_windows(cfg), True
    for li, (lp, w) in enumerate(zip(layers, windows)):
        if remat:
            h = checkpoint(_block_out, lp, h, cfg, w, positions, mode,
                           enc_out, causal, use_reentrant=False,
                           preserve_rng_state=False)
            continue
        h, state = _block_forward(lp, h, cfg, w, positions, mode, enc_out,
                                  causal, env)
        if cache is not None:
            _store(cache, li, state, env)
    return h


def _ids(params: Transformer, x) -> torch.Tensor:
    """Token ids (numpy or a tensor) as int64 on the parameters' device."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x))
    return x.to(params.device).long()


def _embed(params: Transformer, batch: dict) -> torch.Tensor:
    """The residual stream's input: ``embeds`` (the patch frontend's
    precomputed embeddings) or the embedding rows of ``tokens``, bf16, on
    the parameters' device."""
    if "embeds" in batch:
        return torch.as_tensor(batch["embeds"], device=params.device).to(CDT)
    return embed_lookup(params.embed, _ids(params, batch["tokens"]))


def _whisper_encode(params: Transformer, frames, cfg: ArchConfig,
                    env: ShardEnv = ONE_DEVICE,
                    remat: bool = False) -> torch.Tensor:
    """The encoder over ``frames`` (B, S_enc, d), the frame frontend's
    precomputed embeddings: non-causal blocks with RoPE, then its final
    norm. In a cell (``env`` over the encoder's batch and S_enc) the
    frames are its block of them laid out as the residual stream, the
    blocks run on its heads and FFN block, and the output is its batch
    block of the full sequence, what the cross-attention reads."""
    h = torch.as_tensor(frames, device=params.device).to(CDT)
    h = _stack_forward(params, cfg, h, "train", encoder=True, remat=remat,
                       env=env)
    return env.to_full(rms_norm(h, params.enc_final_norm, cfg.norm_eps))


# ---------------------------------------------------------------------------
# over a mesh
# ---------------------------------------------------------------------------

def _on_mesh(env: ShardEnv) -> bool:
    """True where a pass runs on the cells of a mesh of more than one."""
    return env.cells > 1


def _batch_shape(batch: dict) -> tuple[int, int]:
    x = batch["embeds"] if "embeds" in batch else batch["tokens"]
    return tuple(np.shape(x)[:2])


def _on_cells(params, batch: dict, cfg: ArchConfig, env: ShardEnv, body,
              what: str):
    """``body(local params, local batch, cell env)`` on every cell, each
    given its block of every leaf of ``batch`` as the residual stream of
    the leaf's length is laid out (``env.act()``; whisper's frames by
    their own length). Returns the cells' results (an object array)."""
    placed = _placed(params, env, what)
    B, S = _batch_shape(batch)
    whole = {k: v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
             for k, v in batch.items()}

    def cell_fn(cell):
        local = {k: cell.take(v, P(*env.at(cell, B, v.shape[1]).act()[
            :v.ndim])) for k, v in whole.items()}
        return body(placed.local(cell), local, env.at(cell, B, S))

    return run_cells(env.mesh, cell_fn)


def _gathered(env: ShardEnv, blocks, B: int, spec) -> torch.Tensor:
    """The cells' blocks (each laid out as ``spec``'s batch entry says,
    the rest whole) as one tensor on the mesh's first cell."""
    x0 = blocks.flat[0]
    shape = (B,) + tuple(x0.shape[1:])
    lay = NamedSharding(env.mesh, P(spec[0]))
    return gather(Sharded(lay, shape, x0.dtype, blocks))


def _logits(params: Transformer, h, cfg: ArchConfig,
            env: ShardEnv) -> torch.Tensor:
    """The LM head: ``unembed_logits``; in a cell whose block of the
    (padded) vocabulary is narrower, its logits (pad ids masked by their
    global id) gathered over the model axis."""
    V_loc = params.unembed.shape[0]
    if env.cell is None or V_loc == pad_vocab(cfg.vocab_size):
        return unembed_logits(h, params.unembed, cfg.vocab_size)
    lo = env.cell.block(env.model_axis) * V_loc
    return env.cell.all_gather(
        unembed_logits(h, params.unembed, cfg.vocab_size, offset=lo),
        env.model_axis, -1)


# ---------------------------------------------------------------------------
# full-model passes
# ---------------------------------------------------------------------------

def forward_loss(params, batch: dict, cfg: ArchConfig,
                 env: ShardEnv) -> torch.Tensor:
    """Training loss for every family (mode ``train``, full teacher
    forcing): the token-mean cross-entropy plus z-loss of the logits
    against ``labels``, a scalar that autograd differentiates back to
    every parameter. Each layer is rematerialized in the backward pass.
    An audio batch carries ``frames`` for the encoder and ``tokens`` for
    the decoder. On a mesh of one cell the parameters must be on its
    device; over a larger one they are placed for it (``place_params``),
    every cell computes the loss of its block of the batch and the
    result, on the mesh's first cell, is the whole batch's token mean
    (``_loss_cells``)."""
    if _on_mesh(env):
        return _loss_cells(params, batch, cfg, env)
    _placed(params, env, "forward_loss")
    enc = (_whisper_encode(params, batch["frames"], cfg, env, remat=True)
           if cfg.family == "audio" else None)
    h = _stack_forward(params, cfg, _embed(params, batch), "train",
                       enc_out=enc, remat=True)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = unembed_logits(h, params.unembed, cfg.vocab_size)
    return softmax_xent(logits, _ids(params, batch["labels"]))


def cell_loss(batch: dict, cfg: ArchConfig):
    """(the batch without its labels, ``body``): ``body(p, b, e)`` is
    ``forward_loss``'s work in one cell (``_on_cells``): the layers on its
    block of the residual stream (no remat; an audio batch's encoder
    first, on its block of the frames), relaid out to the full sequence
    before the head, the vocab-split logits gathered, and ``softmax_xent``
    of its batch block's labels (split as ``env.full()``)."""
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    labels = batch["labels"]
    labels = (labels if torch.is_tensor(labels)
              else torch.from_numpy(np.asarray(labels)))
    B = _batch_shape(inputs)[0]
    audio = cfg.family == "audio"
    S_enc = int(np.shape(inputs["frames"])[1]) if audio else 0

    def body(p, b, e):
        enc = (_whisper_encode(p, b["frames"], cfg, e.at(e.cell, B, S_enc))
               if audio else None)
        h = _stack_forward(p, cfg, _embed(p, b), "train", enc_out=enc,
                           env=e)
        h = rms_norm(e.to_full(h), p.final_norm, cfg.norm_eps)
        lab = e.cell.take(labels, P(*e.full()[:2]))
        return softmax_xent(_logits(p, h, cfg, e), _ids(p, lab))

    return inputs, body


def _loss_cells(params, batch: dict, cfg: ArchConfig,
                env: ShardEnv) -> torch.Tensor:
    """``forward_loss`` on the cells, under the caller's grad mode: each
    cell's loss (``cell_loss``). The cells of one batch block hold the
    same loss, so the first cell of each block counts, once; the blocks'
    token means, summed in block order on the first cell and divided by
    their number, are the batch's (the blocks are equal)."""
    inputs, body = cell_loss(batch, cfg)
    B, S = _batch_shape(inputs)
    out = _on_cells(params, inputs, cfg, env, body, "forward_loss")
    entry = env.at(None, B, S).full()[0]
    first: dict = {}
    for index in np.ndindex(out.shape):
        first.setdefault(block_index(env.mesh, index, entry), index)
    dev = env.mesh.devices.flat[0]
    total = None
    for b in sorted(first):
        x = out[first[b]].to(dev)
        total = x if total is None else total + x
    return total / len(first)


@torch.no_grad()
def prefill(params, batch: dict, cfg: ArchConfig, env: ShardEnv,
            cache_len: int | None = None):
    """Prefill pass: returns (last-position logits (B, 1, V_pad) fp32, the
    cache). A K/V cache holds ``cache_len`` positions (default: the
    prompt's S, the reference's layout; for audio ``max_decode_len``, the
    reference's padding), so ``cache_len - S`` tokens can be decoded after
    it; a hybrid ring holds ``min(sliding_window, cache_len)``. An ssm
    cache is the recurrent state alone. An audio batch also carries
    ``frames``: the encoder runs first, and the cache keeps each decoder
    layer's cross K/V over its output (``ck``, ``cv``).

    On a mesh, ``params`` are placed for it (``place_params``); over more
    than one cell the logits come back on the mesh's first cell and every
    leaf of the cache but ``pos`` is ``Sharded`` by ``cache_shardings``."""
    if _on_mesh(env):
        return _prefill_cells(params, batch, cfg, env, cache_len)
    params = _placed(params, env, "prefill")
    h = _embed(params, batch)
    B, S, _ = h.shape
    enc = (_whisper_encode(params, batch["frames"], cfg)
           if cfg.family == "audio" else None)
    default = cfg.max_decode_len if enc is not None else S
    C = default if cache_len is None else cache_len
    if C < S:
        raise ValueError(f"prefill: cache_len {C} is shorter than the "
                         f"prompt ({S})")
    if enc is None:
        spec, dec_len = ShapeSpec("prefill", C, B, "prefill"), None
    else:
        spec, dec_len = ShapeSpec("prefill", enc.shape[1], B, "prefill"), C
    cache = {**init_cache(cfg, spec, h.device, dec_len), "pos": S}
    h = _stack_forward(params, cfg, h, cache=cache, enc_out=enc)
    h = rms_norm(h[:, -1:], params.final_norm, cfg.norm_eps)
    return unembed_logits(h, params.unembed, cfg.vocab_size), cache


def _prefill_cells(params, batch, cfg: ArchConfig, env: ShardEnv,
                   cache_len: int | None):
    """``prefill`` on the cells: an audio batch's encoder first (each
    cell on its block of the frames), then the decoder, each layer's
    state stored into the cells' blocks of the placed cache."""
    B, S = _batch_shape(batch)
    audio = cfg.family == "audio"
    C = cache_len if cache_len is not None else \
        cfg.max_decode_len if audio else S
    if C < S:
        raise ValueError(f"prefill: cache_len {C} is shorter than the "
                         f"prompt ({S})")
    if audio:
        S_enc = int(np.shape(batch["frames"])[1])
        spec, dec_len = ShapeSpec("prefill", S_enc, B, "prefill"), C
    else:
        spec, dec_len = ShapeSpec("prefill", C, B, "prefill"), None
    cache = {**init_cache(cfg, spec, dec_len=dec_len, env=env), "pos": S}

    def body(p, b, e):
        enc = (_whisper_encode(p, b["frames"], cfg, e.at(e.cell, B, S_enc))
               if audio else None)
        h = _stack_forward(p, cfg, _embed(p, b), cache=cache, enc_out=enc,
                           env=e)
        h = rms_norm(e.to_full(h)[:, -1:], p.final_norm, cfg.norm_eps)
        return _logits(p, h, cfg, e)

    out = _on_cells(params, batch, cfg, env, body, "prefill")
    return _gathered(env, out, B, env.at(None, B, S).full()), cache


def _ring(cfg: ArchConfig, slots: int) -> bool:
    """A hybrid K/V cache as long as the window: its slots are reused
    (the oldest position leaves the window as the new one enters)."""
    return cfg.family == "hybrid" and slots == cfg.sliding_window


@torch.no_grad()
def decode_step(params, cache: dict, batch: dict, cfg: ArchConfig,
                env: ShardEnv):
    """One-token decode against a populated cache. Writes the token's
    state into the cache in place (no copy of the whole cache per step;
    over a mesh, each cell into its block) and returns (logits (B, 1,
    V_pad), the cache with ``pos`` advanced)."""
    pos = cache["pos"]
    if "k" in cache:
        R = cache["k"].shape[2]
        if pos >= R and not _ring(cfg, R):
            raise ValueError(
                f"decode_step: the cache's {R} positions are all used; "
                f"prefill with cache_len= the prompt plus the tokens to "
                f"decode")
    if _on_mesh(env):
        def body(p, b, e):
            h = _embed(p, b)
            posv = torch.full((1, 1), pos, dtype=torch.int32,
                              device=h.device)
            for li, (lp, w) in enumerate(zip(p.layers,
                                             _layer_windows(cfg))):
                h = _decode_block(lp, h, cfg, w, pos, posv, cache, li, e)
            h = rms_norm(h, p.final_norm, cfg.norm_eps)
            return _logits(p, h, cfg, e)

        B = _batch_shape(batch)[0]
        out = _on_cells(params, batch, cfg, env, body, "decode_step")
        return (_gathered(env, out, B, env.at(None, B, 1).full()),
                {**cache, "pos": pos + 1})
    params = _placed(params, env, "decode_step")
    h = _embed(params, batch)
    posv = torch.full((1, 1), pos, dtype=torch.int32, device=h.device)
    for li, (lp, w) in enumerate(zip(params.layers, _layer_windows(cfg))):
        h = _decode_block(lp, h, cfg, w, pos, posv, cache, li)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = unembed_logits(h, params.unembed, cfg.vocab_size)
    return logits, {**cache, "pos": pos + 1}


def _decode_attend_cell(q, new, cfg: ArchConfig, cache: dict, li: int,
                        pos: int, window: int, env: ShardEnv,
                        names: tuple = ("k", "v")):
    """A cell's decode attention over its block of the placed cache
    ``names`` (self-attention's K/V, or whisper's cross K/V): the new
    token's K/V (``new``; None for the cross K/V, which stay as prefill
    left them) relaid out as the cache is and written where the cell
    holds slot ``pos % R``; the queries relaid out to the cache's batch
    (and KV heads where they are split) and attended there, or, where the
    cache's sequence is split, every head attended over the cell's slots
    and combined over the sequence's axis (``flash_decode_partial``).
    The valid slots are the first ``min(pos + 1, R)`` (a ring's order
    does not matter: RoPE is in K), all R for the cross K/V. Returns the
    output laid out as ``q``."""
    cell = env.cell
    ax = env.model_axis
    kl, vl = cache[names[0]], cache[names[1]]
    b, s, kv, _ = _cache_layout(kl)
    b_now = env.full()[0]
    h_now = ax if q.shape[2] < cfg.n_heads else None
    kc, vc = kl.local(cell)[li], vl.local(cell)[li]
    R = kl.shape[2]
    lo = cell.block(s) * kc.shape[1]
    clen = R
    if new is not None:
        clen = min(pos + 1, R)
        kv_now = ax if new[0].shape[2] < cfg.n_kv_heads else None
        for x, dst in zip(new, (kc, vc)):
            x = cell.relayout(x, (b_now, None, kv_now), (b, None, kv, None))
            if lo <= pos % R < lo + dst.shape[1]:
                dst[:, pos % R - lo] = x[:, 0]
    q_now = (b_now, None, h_now, None)
    if s:   # the sequence split over the cells: flash decode
        q_all = cell.relayout(q, q_now, (b, None, None, None))
        o = attn_lib.flash_decode_partial(q_all, kc, vc, clen, lo, cell, s,
                                          window)
        return cell.relayout(o, (b, None, None, None), q_now)
    h_att = kv or h_now   # heads split as the cache's KV heads, else as q's
    q_att = cell.relayout(q, q_now, (b, None, h_att, None))
    ka, va = (_kv_groups(kc, vc, cfg, q_att.shape[2], env) if not kv
              else (kc, vc))
    o = attn_lib.decode_attention(q_att, ka, va, clen, window=window)
    return cell.relayout(o, (b, None, h_att, None), q_now)


def _decode_ssm(p: Tree, h, cfg: ArchConfig, cache: dict, li: int,
                env: ShardEnv):
    """rwkv6's single-token block: the time and channel mixes on the
    layer's states (in a cell, its copies of its blocks: ``wkv`` on its
    heads where its columns hold whole heads, the shift tails whole)."""
    eps = cfg.norm_eps
    cell, ax = env.cell, env.model_axis
    b = env.full()[0] if cell is not None else None
    heads = ax if own_heads(p, cfg.rwkv_head_size, cell) else None
    now = {"shift_tm": (b, None), "shift_cm": (b, None),
           "wkv": (b, heads, None, None)}
    state = (_read_state(cache, li, "shift_tm", now["shift_tm"], env),
             _read_state(cache, li, "wkv", now["wkv"], env))
    y, (shift_tm, wkv) = rwkv_time_mix(p, rms_norm(h, p.ln1, eps), state,
                                       cfg.rwkv_head_size, cell, ax)
    h = h + y
    y, shift_cm = rwkv_channel_mix(
        p, rms_norm(h, p.ln2, eps),
        _read_state(cache, li, "shift_cm", now["shift_cm"], env), cell, ax,
        cfg.d_ff)
    for name, x in (("shift_tm", shift_tm), ("wkv", wkv),
                    ("shift_cm", shift_cm)):
        _write_state(cache, li, name, x, now[name], env)
    return h + y


def _decode_block(p: Tree, h, cfg: ArchConfig, window: int, pos: int,
                  posv, cache: dict, li: int, env: ShardEnv = ONE_DEVICE):
    """Single-token block forward; updates layer ``li``'s slices of the
    cache. K/V go to slot ``pos % R`` (R >= pos + 1 but for a full ring,
    which holds exactly the window, so it attends every slot). An audio
    layer then cross-attends every position of the cached encoder K/V.
    In a cell the heads, channels and hidden block are its own, its
    states its blocks of the placed cache, and where ``wo`` (or
    ``out_proj``, ``w_down``) is split the output is the sum of the
    cells' products."""
    eps = cfg.norm_eps
    if cfg.family == "ssm":
        return _decode_ssm(p, h, cfg, cache, li, env)
    hybrid = cfg.family == "hybrid"
    cell, ax = env.cell, env.model_axis
    hn = rms_norm(h, p.ln1, eps)
    B, hd = hn.shape[0], cfg.hd
    H, KV = p.attn.wq.shape[1] // hd, p.attn.wk.shape[1] // hd
    q = rope(_proj(hn, p.attn.wq).reshape(B, 1, H, hd), posv,
             cfg.rope_theta)
    k = rope(_proj(hn, p.attn.wk).reshape(B, 1, KV, hd), posv,
             cfg.rope_theta)
    v = _proj(hn, p.attn.wv).reshape(B, 1, KV, hd)
    win = 0 if hybrid else window
    if cell is None:
        kc, vc = cache["k"][li], cache["v"][li]
        R = kc.shape[1]
        kc[:, pos % R] = k[:, 0]
        vc[:, pos % R] = v[:, 0]
        ao = attn_lib.decode_attention(q, kc, vc, min(pos + 1, R),
                                       window=win)
    else:
        ao = _decode_attend_cell(q, (k, v), cfg, cache, li, pos, win, env)
    split = H < cfg.n_heads   # wo's rows: the output is a partial
    ao = _proj(ao.reshape(B, 1, H * hd), p.attn.wo)
    ao = env.sum_model(ao) if split else ao
    if hybrid:
        ch = ax if own_channels(p.mamba, cell) else None
        b = env.full()[0] if cell is not None else None
        now = {"ssm": (b, ch, None), "conv": (b, None, ch)}
        state = tuple(_read_state(cache, li, n, now[n], env)
                      for n in ("ssm", "conv"))
        mo, new = mamba_forward(p.mamba, hn, state, cell, ax)
        for name, x in zip(("ssm", "conv"), new):
            _write_state(cache, li, name, x, now[name], env)
        ao = _mix_heads(p.beta, ao, mo)
    h = h + ao
    if cfg.family == "audio":
        qc = _proj(rms_norm(h, p.ln_cross, eps),
                   p.cross.wq).reshape(B, 1, H, hd)
        if cell is None:
            ck = cache["ck"][li]
            co = attn_lib.decode_attention(qc, ck, cache["cv"][li],
                                           ck.shape[1])
        else:
            co = _decode_attend_cell(qc, None, cfg, cache, li, pos, 0, env,
                                     ("ck", "cv"))
        co = _proj(co.reshape(B, 1, H * hd), p.cross.wo)
        h = h + (env.sum_model(co) if split else co)
    return h + _ffn_apply(p.ffn, rms_norm(h, p.ln2, eps), cfg, "decode",
                          env)


@torch.no_grad()
def encode(params, batch: dict, cfg: ArchConfig,
           env: ShardEnv) -> torch.Tensor:
    """Sequence embedding: final-norm hidden state at the last position,
    unit-normalized fp32 (B, d) — the representation the FNS retrieval
    layer indexes (DESIGN.md §4). An audio arch runs its decoder stack
    alone (no frames, no cross-attention), as the reference does. Over a
    mesh of more than one cell the embeddings come back on its first
    cell."""
    def body(p, b, e):
        h = e.to_full(_stack_forward(p, cfg, _embed(p, b), env=e))
        hf = rms_norm(h[:, -1], p.final_norm, cfg.norm_eps).float()
        return hf / torch.clamp(torch.linalg.vector_norm(
            hf, dim=-1, keepdim=True), min=1e-9)

    if not _on_mesh(env):
        return body(_placed(params, env, "encode"), batch, ONE_DEVICE)
    B, S = _batch_shape(batch)
    out = _on_cells(params, batch, cfg, env, body, "encode")
    return _gathered(env, out, B, env.at(None, B, S).full())
