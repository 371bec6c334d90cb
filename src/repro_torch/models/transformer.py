"""The LM's serving passes for the dense and vlm families: init, prefill,
decode and encode.

One layer loop covers dense GQA (llama / minitron / smollm and the
internvl backbone, which takes precomputed patch embeddings) and gemma3's
local:global sliding-window interleave. The moe, hybrid, ssm and audio
families and the training loss wait for later slices (ROADMAP queue 1
item 6) and raise ``NotImplementedError``.

Parameters are an ``nn.Module`` (``Transformer``): one ``Block`` per
layer where the reference stacks every leaf under a leading L dim for its
scan; the leaves keep the reference's names, shapes and fp32 storage, and
every pass casts them to bf16 as the reference does. The passes run
without autograd, on the device the parameters live on.

One difference from the reference, on purpose: its dense ``prefill``
keeps a cache exactly as long as the prompt, so every ``decode_step``
overwrites the last prompt position's K/V (``src/repro/models/
transformer.py:371,436,439``). The port's ``prefill`` takes the cache
length to leave room for; ``decode_step`` then computes what ``prefill``
over the longer sequence computes, and raises when the cache is full.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.device_atlas import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import (CDT, check_family, embed_lookup,
                                       init_dense, pad_vocab, rms_norm, rope,
                                       swiglu, unembed_logits)
from repro_torch.models.kvcache import init_cache


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

class Attention(nn.Module):
    """One layer's q/k/v/o projections, stored (in, out) in fp32."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk = nn.Parameter(wq), nn.Parameter(wk)
        self.wv, self.wo = nn.Parameter(wv), nn.Parameter(wo)


class SwiGLU(nn.Module):
    """One layer's gated FFN: gate, up (d, f) and down (f, d), fp32."""

    def __init__(self, w_gate, w_up, w_down):
        super().__init__()
        self.w_gate, self.w_up = nn.Parameter(w_gate), nn.Parameter(w_up)
        self.w_down = nn.Parameter(w_down)


class Block(nn.Module):
    """One transformer layer: the two norms' scales, attention, FFN."""

    def __init__(self, ln1, ln2, attn: dict, ffn: dict):
        super().__init__()
        self.ln1, self.ln2 = nn.Parameter(ln1), nn.Parameter(ln2)
        self.attn = Attention(**attn)
        self.ffn = SwiGLU(**ffn)


class Transformer(nn.Module):
    """Every parameter of a dense/vlm LM: the embedding (none for a
    ``patch`` frontend, which feeds embeddings), the layers, the final
    norm and the (padded-vocab) unembedding."""

    def __init__(self, cfg: ArchConfig, tree: dict):
        """``tree``: {"unembed", "final_norm", "layers": [per-layer dicts
        of ``Block``'s arguments], and "embed" unless the frontend is
        ``patch``}, all fp32 tensors on one device."""
        super().__init__()
        check_family(cfg)
        self.unembed = nn.Parameter(tree["unembed"])
        self.final_norm = nn.Parameter(tree["final_norm"])
        self.layers = nn.ModuleList(Block(**lp) for lp in tree["layers"])
        self.embed = (nn.Parameter(tree["embed"])
                      if cfg.frontend != "patch" else None)

    @property
    def device(self) -> torch.device:
        return self.unembed.device


def on_device(params: Transformer, device) -> Transformer:
    """``params`` itself where it already lives on ``device``, else a copy
    there. The caller's module never moves (``nn.Module.to`` moves in
    place; the reference's parameters are immutable), so two users on
    different devices can share one module."""
    dev = torch.empty(0, device=device).device  # "cuda" -> "cuda:0"
    return params if params.device == dev else copy.deepcopy(params).to(dev)


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Transformer:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (None means CUDA): normal at 1/sqrt(fan_in) for the
    projections, 0.02 for the embeddings, zeros for the norm scales (the
    reference's recipe; its numbers differ, since jax draws its own)."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, H, KV, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.d_ff
    v_pad = pad_vocab(cfg.vocab_size)

    def dense(*shape, scale=None):
        return init_dense(gen, shape, scale)

    def zeros():
        return torch.zeros(d, device=dev)

    layers = [{"ln1": zeros(), "ln2": zeros(),
               "attn": {"wq": dense(d, H * hd), "wk": dense(d, KV * hd),
                        "wv": dense(d, KV * hd), "wo": dense(H * hd, d)},
               "ffn": {"w_gate": dense(d, f), "w_up": dense(d, f),
                       "w_down": dense(f, d)}}
              for _ in range(cfg.n_layers)]
    tree = {"unembed": dense(v_pad, d, scale=0.02), "final_norm": zeros(),
            "layers": layers}
    if cfg.frontend != "patch":
        tree["embed"] = dense(v_pad, d, scale=0.02)
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


def _attend_full(p: Attention, h, cfg: ArchConfig, window: int, positions):
    """Causal chunked self-attention with RoPE. h: (B, S, d). Returns the
    output and the layer's (k, v), (B, S, KV, hd) each."""
    B, S, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = rope(_proj(h, p.wq).reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = rope(_proj(h, p.wk).reshape(B, S, KV, hd), positions, cfg.rope_theta)
    v = _proj(h, p.wv).reshape(B, S, KV, hd)
    o = attn_lib.chunked_attention(q, k, v, causal=True, window=window)
    return _proj(o.reshape(B, S, H * hd), p.wo), (k, v)


def _ffn_apply(p: SwiGLU, h: torch.Tensor) -> torch.Tensor:
    return swiglu(h, p.w_gate.to(h.dtype), p.w_up.to(h.dtype),
                  p.w_down.to(h.dtype))


def _block_forward(p: Block, h, cfg: ArchConfig, window: int, positions):
    """One transformer block (prefill/encode path). Returns (h, (k, v))."""
    ao, kv = _attend_full(p.attn, rms_norm(h, p.ln1, cfg.norm_eps), cfg,
                          window, positions)
    h = h + ao
    h = h + _ffn_apply(p.ffn, rms_norm(h, p.ln2, cfg.norm_eps))
    return h, kv


def _stack_forward(params: Transformer, cfg: ArchConfig, h, cache=None):
    """Every layer in order, each with its own window. With ``cache``
    (k, v of shape (L, B, C, KV, hd), C >= S), layer l's K/V land in
    ``cache["k"][l, :, :S]`` and ``cache["v"][l, :, :S]``."""
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)[None, :]
    for li, (lp, w) in enumerate(zip(params.layers, _layer_windows(cfg))):
        h, (k, v) = _block_forward(lp, h, cfg, w, positions)
        if cache is not None:
            cache["k"][li, :, :S] = k
            cache["v"][li, :, :S] = v
    return h


def _embed(params: Transformer, batch: dict) -> torch.Tensor:
    """The residual stream's input: ``embeds`` (the patch frontend's
    precomputed embeddings) or the embedding rows of ``tokens``, bf16, on
    the parameters' device."""
    dev = params.device
    if "embeds" in batch:
        return torch.as_tensor(batch["embeds"], device=dev).to(CDT)
    tokens = batch["tokens"]
    if not torch.is_tensor(tokens):
        tokens = torch.from_numpy(np.asarray(tokens))
    return embed_lookup(params.embed, tokens.to(dev).long())


# ---------------------------------------------------------------------------
# full-model passes
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params: Transformer, batch: dict, cfg: ArchConfig,
            env: ShardEnv, cache_len: int | None = None):
    """Prefill pass: returns (last-position logits (B, 1, V_pad) fp32, the
    cache). The cache holds ``cache_len`` positions (default: the
    prompt's S, the reference's layout), the first S filled, so
    ``cache_len - S`` tokens can be decoded after it."""
    check_family(cfg)
    h = _embed(params, batch)
    B, S, _ = h.shape
    C = S if cache_len is None else cache_len
    if C < S:
        raise ValueError(f"prefill: cache_len {C} is shorter than the "
                         f"prompt ({S})")
    cache = {**init_cache(cfg, ShapeSpec("prefill", C, B, "prefill"),
                          h.device), "pos": S}
    h = _stack_forward(params, cfg, h, cache)
    h = rms_norm(h[:, -1:], params.final_norm, cfg.norm_eps)
    return unembed_logits(h, params.unembed, cfg.vocab_size), cache


@torch.no_grad()
def decode_step(params: Transformer, cache: dict, batch: dict,
                cfg: ArchConfig, env: ShardEnv):
    """One-token decode against a populated cache. Writes the token's K/V
    into the cache in place (no copy of the whole cache per step) and
    returns (logits (B, 1, V_pad), the cache with ``pos`` advanced)."""
    check_family(cfg)
    pos, S_cache = cache["pos"], cache["k"].shape[2]
    if pos >= S_cache:
        raise ValueError(
            f"decode_step: the cache's {S_cache} positions are all used; "
            f"prefill with cache_len= the prompt plus the tokens to decode")
    h = _embed(params, batch)
    posv = torch.full((1, 1), pos, dtype=torch.int32, device=h.device)
    for li, (lp, w) in enumerate(zip(params.layers, _layer_windows(cfg))):
        h = _decode_block(lp, h, cfg, w, pos, posv, cache["k"][li],
                          cache["v"][li])
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = unembed_logits(h, params.unembed, cfg.vocab_size)
    return logits, {**cache, "pos": pos + 1}


def _decode_block(p: Block, h, cfg: ArchConfig, window: int, pos: int,
                  posv, kc, vc):
    """Single-token block forward; writes slot ``pos`` of this layer's
    caches ``kc``/``vc`` (B, S_cache, KV, hd)."""
    hn = rms_norm(h, p.ln1, cfg.norm_eps)
    B = hn.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = rope(_proj(hn, p.attn.wq).reshape(B, 1, H, hd), posv,
             cfg.rope_theta)
    kc[:, pos] = rope(_proj(hn, p.attn.wk).reshape(B, 1, KV, hd), posv,
                      cfg.rope_theta)[:, 0]
    vc[:, pos] = _proj(hn, p.attn.wv).reshape(B, KV, hd)
    ao = attn_lib.decode_attention(q, kc, vc, pos + 1, window=window)
    h = h + _proj(ao.reshape(B, 1, H * hd), p.attn.wo)
    return h + _ffn_apply(p.ffn, rms_norm(h, p.ln2, cfg.norm_eps))


@torch.no_grad()
def encode(params: Transformer, batch: dict, cfg: ArchConfig,
           env: ShardEnv) -> torch.Tensor:
    """Sequence embedding: final-norm hidden state at the last position,
    unit-normalized fp32 (B, d) — the representation the FNS retrieval
    layer indexes (DESIGN.md §4)."""
    check_family(cfg)
    h = _stack_forward(params, cfg, _embed(params, batch))
    hf = rms_norm(h[:, -1], params.final_norm, cfg.norm_eps).float()
    return hf / torch.clamp(torch.linalg.vector_norm(hf, dim=-1,
                                                     keepdim=True), min=1e-9)
