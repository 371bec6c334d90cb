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
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (CDT, embed_lookup, init_dense,
                                       pad_vocab, rms_norm, rope,
                                       softmax_xent, swiglu, unembed_logits)
from repro_torch.models.kvcache import init_cache
from repro_torch.models.mamba import init_mamba, mamba_forward
from repro_torch.models.moe import MoEDims, moe_ffn
from repro_torch.models.rwkv6 import (init_rwkv_layer, rwkv_channel_mix,
                                      rwkv_time_mix)


@dataclasses.dataclass(frozen=True)
class ShardEnv:
    """The reference's sharding environment. Only ``mesh=None`` (one
    device, no sharding constraints) is ported; the multi-GPU port takes
    the mesh, its axis names and policies (ROADMAP queue 1 item 5)."""
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "ShardEnv: a device mesh is not ported; pass mesh=None")


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
                                dt_rank=max(d // 16, 8))
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


def _attend_full(p: Tree, h, cfg: ArchConfig, window: int, positions,
                 causal: bool = True, kv=None):
    """Chunked attention. h: (B, S, d). Self-attention (``kv`` None)
    rotates q and k by RoPE; cross-attention takes k and v from ``kv``
    (B, Sk, d), unrotated and unmasked. Returns the output and the
    layer's (k, v), (B, Sk, KV, hd) each."""
    B, S, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = h if kv is None else kv
    Sk = src.shape[1]
    q = _proj(h, p.wq).reshape(B, S, H, hd)
    k = _proj(src, p.wk).reshape(B, Sk, KV, hd)
    v = _proj(src, p.wv).reshape(B, Sk, KV, hd)
    if kv is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = attn_lib.chunked_attention(q, k, v, causal=causal and kv is None,
                                   window=window, q_chunk=_chunk(S, 512),
                                   kv_chunk=_chunk(Sk, 1024))
    return _proj(o.reshape(B, S, H * hd), p.wo), (k, v)


def _swiglu(p: Tree, h: torch.Tensor) -> torch.Tensor:
    return swiglu(h, p.w_gate.to(h.dtype), p.w_up.to(h.dtype),
                  p.w_down.to(h.dtype))


def _ffn_apply(p: Tree, h: torch.Tensor, cfg: ArchConfig,
               mode: str) -> torch.Tensor:
    """The layer's FFN: a SwiGLU, or the MoE (capacity-bounded outside
    decode, dropless in it) plus kimi-k2's shared expert."""
    if not cfg.is_moe:
        return _swiglu(p, h)
    y = moe_ffn(h, p, MoEDims(cfg.n_experts, cfg.moe_top_k,
                              cfg.capacity_factor), mode=mode)
    if cfg.n_shared_experts:
        y = y + _swiglu(p.shared, h)
    return y


def _mix_heads(beta: torch.Tensor, ao: torch.Tensor,
               mo: torch.Tensor) -> torch.Tensor:
    """Hymba's parallel heads: sigmoid(beta)-weighted sum in fp32."""
    b = torch.sigmoid(beta.float())
    return (b[0] * ao.float() + b[1] * mo.float()).to(ao.dtype)


def _block_forward(p: Tree, h, cfg: ArchConfig, window: int, positions,
                   mode: str, enc_out=None, causal: bool = True):
    """One block (train/prefill/encode path). Returns (h, the layer's
    decode state: k/v, plus mamba's ssm/conv for hybrid, the cross K/V
    ck/cv where ``enc_out`` is given; rwkv6's wkv and shift tails for
    ssm)."""
    eps = cfg.norm_eps
    if cfg.family == "ssm":
        y, (shift_tm, wkv) = rwkv_time_mix(p, rms_norm(h, p.ln1, eps), None,
                                           cfg.rwkv_head_size)
        h = h + y
        y, shift_cm = rwkv_channel_mix(p, rms_norm(h, p.ln2, eps), None)
        return h + y, {"wkv": wkv, "shift_tm": shift_tm,
                       "shift_cm": shift_cm}
    hn = rms_norm(h, p.ln1, eps)
    ao, (k, v) = _attend_full(p.attn, hn, cfg, window, positions, causal)
    state = {"k": k, "v": v}
    if cfg.family == "hybrid":
        mo, (state["ssm"], state["conv"]) = mamba_forward(p.mamba, hn)
        ao = _mix_heads(p.beta, ao, mo)
    h = h + ao
    if enc_out is not None:  # whisper decoder: cross-attend to the encoder
        co, (state["ck"], state["cv"]) = _attend_full(
            p.cross, rms_norm(h, p.ln_cross, eps), cfg, 0, positions,
            kv=enc_out)
        h = h + co
    return h + _ffn_apply(p.ffn, rms_norm(h, p.ln2, eps), cfg, mode), state


def _block_out(p: Tree, h, cfg: ArchConfig, window: int, positions,
               mode: str, enc_out, causal: bool):
    """``_block_forward``'s h alone: what a rematerialized layer keeps."""
    return _block_forward(p, h, cfg, window, positions, mode, enc_out,
                          causal)[0]


def _store(cache: dict, li: int, state: dict) -> None:
    """Layer ``li``'s prefill state into the cache. K/V of positions
    0..S-1 go to slot ``p % R`` of the cache's R slots, the last
    ``min(S, R)`` of them kept (R >= S but for a hybrid ring shorter than
    the prompt); the recurrent states are copied whole."""
    for name, x in state.items():
        if name not in ("k", "v"):
            cache[name][li] = x
            continue
        S, R = x.shape[1], cache[name].shape[2]
        m = min(S, R)
        slots = torch.arange(S - m, S, device=x.device) % R
        cache[name][li][:, slots] = x[:, S - m:]


def _stack_forward(params: Transformer, cfg: ArchConfig, h,
                   mode: str = "prefill", cache=None, enc_out=None,
                   encoder: bool = False, remat: bool = False):
    """Every layer in order, each with its own window (the encoder's,
    ``encoder=True``: all global and non-causal); with ``cache``, each
    layer's decode state stored there (``_store``); with ``remat``, each
    layer recomputed in the backward pass, only its input kept."""
    S = h.shape[1]
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
                                  causal)
        if cache is not None:
            _store(cache, li, state)
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
                    env: ShardEnv | None = None,
                    remat: bool = False) -> torch.Tensor:
    """The encoder over ``frames`` (B, S_enc, d), the frame frontend's
    precomputed embeddings: non-causal blocks with RoPE, then its final
    norm."""
    h = torch.as_tensor(frames, device=params.device).to(CDT)
    h = _stack_forward(params, cfg, h, "train", encoder=True, remat=remat)
    return rms_norm(h, params.enc_final_norm, cfg.norm_eps)


# ---------------------------------------------------------------------------
# full-model passes
# ---------------------------------------------------------------------------

def forward_loss(params: Transformer, batch: dict, cfg: ArchConfig,
                 env: ShardEnv) -> torch.Tensor:
    """Training loss for every family (mode ``train``, full teacher
    forcing): the token-mean cross-entropy plus z-loss of the logits
    against ``labels``, a scalar that autograd differentiates back to
    every parameter. Each layer is rematerialized in the backward pass.
    An audio batch carries ``frames`` for the encoder and ``tokens`` for
    the decoder."""
    enc = (_whisper_encode(params, batch["frames"], cfg, env, remat=True)
           if cfg.family == "audio" else None)
    h = _stack_forward(params, cfg, _embed(params, batch), "train",
                       enc_out=enc, remat=True)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = unembed_logits(h, params.unembed, cfg.vocab_size)
    return softmax_xent(logits, _ids(params, batch["labels"]))


@torch.no_grad()
def prefill(params: Transformer, batch: dict, cfg: ArchConfig,
            env: ShardEnv, cache_len: int | None = None):
    """Prefill pass: returns (last-position logits (B, 1, V_pad) fp32, the
    cache). A K/V cache holds ``cache_len`` positions (default: the
    prompt's S, the reference's layout; for audio ``max_decode_len``, the
    reference's padding), so ``cache_len - S`` tokens can be decoded after
    it; a hybrid ring holds ``min(sliding_window, cache_len)``. An ssm
    cache is the recurrent state alone. An audio batch also carries
    ``frames``: the encoder runs first, and the cache keeps each decoder
    layer's cross K/V over its output (``ck``, ``cv``)."""
    h = _embed(params, batch)
    B, S, _ = h.shape
    enc = (_whisper_encode(params, batch["frames"], cfg, env)
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


def _ring(cfg: ArchConfig, slots: int) -> bool:
    """A hybrid K/V cache as long as the window: its slots are reused
    (the oldest position leaves the window as the new one enters)."""
    return cfg.family == "hybrid" and slots == cfg.sliding_window


@torch.no_grad()
def decode_step(params: Transformer, cache: dict, batch: dict,
                cfg: ArchConfig, env: ShardEnv):
    """One-token decode against a populated cache. Writes the token's
    state into the cache in place (no copy of the whole cache per step)
    and returns (logits (B, 1, V_pad), the cache with ``pos`` advanced)."""
    pos = cache["pos"]
    if "k" in cache:
        R = cache["k"].shape[2]
        if pos >= R and not _ring(cfg, R):
            raise ValueError(
                f"decode_step: the cache's {R} positions are all used; "
                f"prefill with cache_len= the prompt plus the tokens to "
                f"decode")
    h = _embed(params, batch)
    posv = torch.full((1, 1), pos, dtype=torch.int32, device=h.device)
    for li, (lp, w) in enumerate(zip(params.layers, _layer_windows(cfg))):
        h = _decode_block(lp, h, cfg, w, pos, posv, cache, li)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = unembed_logits(h, params.unembed, cfg.vocab_size)
    return logits, {**cache, "pos": pos + 1}


def _decode_block(p: Tree, h, cfg: ArchConfig, window: int, pos: int,
                  posv, cache: dict, li: int):
    """Single-token block forward; updates layer ``li``'s slices of the
    cache. K/V go to slot ``pos % R`` (R >= pos + 1 but for a full ring,
    which holds exactly the window, so it attends every slot). An audio
    layer then cross-attends every position of the cached encoder K/V."""
    eps = cfg.norm_eps
    if cfg.family == "ssm":
        y, (cache["shift_tm"][li], cache["wkv"][li]) = rwkv_time_mix(
            p, rms_norm(h, p.ln1, eps),
            (cache["shift_tm"][li], cache["wkv"][li]), cfg.rwkv_head_size)
        h = h + y
        y, cache["shift_cm"][li] = rwkv_channel_mix(
            p, rms_norm(h, p.ln2, eps), cache["shift_cm"][li])
        return h + y
    hn = rms_norm(h, p.ln1, eps)
    B = hn.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kc, vc = cache["k"][li], cache["v"][li]
    R = kc.shape[1]
    q = rope(_proj(hn, p.attn.wq).reshape(B, 1, H, hd), posv,
             cfg.rope_theta)
    kc[:, pos % R] = rope(_proj(hn, p.attn.wk).reshape(B, 1, KV, hd), posv,
                          cfg.rope_theta)[:, 0]
    vc[:, pos % R] = _proj(hn, p.attn.wv).reshape(B, KV, hd)
    ao = attn_lib.decode_attention(
        q, kc, vc, min(pos + 1, R),
        window=0 if cfg.family == "hybrid" else window)
    ao = _proj(ao.reshape(B, 1, H * hd), p.attn.wo)
    if cfg.family == "hybrid":
        mo, (cache["ssm"][li], cache["conv"][li]) = mamba_forward(
            p.mamba, hn, (cache["ssm"][li], cache["conv"][li]))
        ao = _mix_heads(p.beta, ao, mo)
    h = h + ao
    if cfg.family == "audio":
        qc = _proj(rms_norm(h, p.ln_cross, eps), p.cross.wq)
        ck = cache["ck"][li]
        co = attn_lib.decode_attention(qc.reshape(B, 1, H, hd), ck,
                                       cache["cv"][li], ck.shape[1])
        h = h + _proj(co.reshape(B, 1, H * hd), p.cross.wo)
    return h + _ffn_apply(p.ffn, rms_norm(h, p.ln2, eps), cfg, "decode")


@torch.no_grad()
def encode(params: Transformer, batch: dict, cfg: ArchConfig,
           env: ShardEnv) -> torch.Tensor:
    """Sequence embedding: final-norm hidden state at the last position,
    unit-normalized fp32 (B, d) — the representation the FNS retrieval
    layer indexes (DESIGN.md §4). An audio arch runs its decoder stack
    alone (no frames, no cross-attention), as the reference does."""
    h = _stack_forward(params, cfg, _embed(params, batch))
    hf = rms_norm(h[:, -1], params.final_norm, cfg.norm_eps).float()
    return hf / torch.clamp(torch.linalg.vector_norm(hf, dim=-1,
                                                     keepdim=True), min=1e-9)
