"""Architecture + shape configuration registry.

Every assigned architecture gets one module in this package defining a
module-level ``CONFIG: ArchConfig``. ``get_config(name)`` resolves by arch id
(e.g. ``llama3.2-1b``). Shapes are global (same four for every LM arch), with
per-arch applicability rules (sub-quadratic requirement for ``long_500k``,
enc-dec handling for whisper) resolved by ``cell_plan``.

The port's copy has the reference's fields and values.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch


# ---------------------------------------------------------------------------
# Shapes (assigned; identical for every LM arch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0           # mamba state size (hymba)
    ssm_expand: int = 2          # mamba inner expansion
    rwkv_head_size: int = 64     # rwkv6 time-mix head size

    # Attention pattern
    sliding_window: int = 0      # 0 = full attention
    local_global_ratio: int = 0  # gemma3: N local layers per 1 global

    # Enc-dec (whisper)
    n_enc_layers: int = 0        # 0 = decoder-only
    max_decode_len: int = 512    # decoder self-cache length for enc-dec decode shapes

    # Modality frontend stub: none | patch | frame
    frontend: str = "none"

    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6

    # --- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports the ``long_500k`` shape (SSM/hybrid/SWA)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    # --- parameter counting (for roofline MODEL_FLOPS = 6·N·D) --------------
    def _attn_params(self) -> int:
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.hd
        return d * h * hd + 2 * d * kv * hd + h * hd * d  # q, k+v, o

    def _ffn_params_per_expert(self) -> int:
        return 3 * self.d_model * self.d_ff  # SwiGLU: gate, up, down

    def _mamba_params(self) -> int:
        d_in = self.ssm_expand * self.d_model
        n = self.ssm_state
        # in_proj (x,z), conv, dt/B/C proj, A, D, out_proj
        return (2 * self.d_model * d_in + 4 * d_in
                + d_in * (2 * n + d_in // 16) + d_in * n + d_in
                + d_in * self.d_model)

    def _rwkv_params(self) -> int:
        d = self.d_model
        # time-mix: r,k,v,g,o projections + data-dependent decay lora + channel-mix
        return 5 * d * d + 2 * d * 64 + (d * self.d_ff + self.d_ff * d + d * d)

    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count (embedding + layers + head)."""
        d = self.d_model
        emb = self.vocab_size * d
        head = self.vocab_size * d  # untied
        per_layer: float = 0.0
        if self.family == "ssm":  # rwkv6
            per_layer = self._rwkv_params()
        else:
            attn = self._attn_params()
            if self.is_moe:
                n_e = self.moe_top_k if active_only else self.n_experts
                ffn = (n_e + self.n_shared_experts) * self._ffn_params_per_expert()
                ffn += self.d_model * self.n_experts  # router
                moe_layers = self.n_layers - self.first_dense_layers
                dense_ffn = self._ffn_params_per_expert()
                total_layers = (moe_layers * (attn + ffn)
                                + self.first_dense_layers * (attn + dense_ffn))
                enc = 0
                if self.n_enc_layers:
                    enc = self.n_enc_layers * (attn + dense_ffn)
                return emb + head + total_layers + enc
            ffn = self._ffn_params_per_expert()
            per_layer = attn + ffn
            if self.family == "hybrid":
                per_layer += self._mamba_params()
        total = self.n_layers * per_layer
        if self.n_enc_layers:
            total += self.n_enc_layers * (self._attn_params()
                                          + self._ffn_params_per_expert())
        return int(emb + head + total)

    # --- input specs ---------------------------------------------------------
    def input_specs(self, shape: "str | ShapeSpec") -> dict[str, Any]:
        """(shape, dtype) records, one for every model input of a shape
        (a ``SHAPES`` name or a ``ShapeSpec``), as ``models.kvcache.
        cache_specs`` gives the cache's; the reference returns
        ``jax.ShapeDtypeStruct``s of the same shapes and dtypes. The
        dry-run makes them ``meta`` tensors.

        * train:   tokens+labels (or frontend embeds+labels)
        * prefill: tokens (or embeds)
        * decode:  one new token + cache shape handled by the step fn itself
                   (cache specs come from ``models.kvcache.cache_specs``).
        """
        spec = shape if isinstance(shape, ShapeSpec) else SHAPES[shape]
        B, S = spec.global_batch, spec.seq_len
        i32 = torch.int32
        bf16 = torch.bfloat16
        if self.frontend == "frame" and self.n_enc_layers:
            # enc-dec audio: precomputed frame embeddings + decoder tokens
            dec_len = (1 if spec.kind == "decode" else
                       min(max(S // 8, 16), self.max_decode_len - 64))
            out = {"frames": ((B, S, self.d_model), bf16),
                   "tokens": ((B, dec_len), i32)}
            if spec.kind == "train":
                out["labels"] = ((B, dec_len), i32)
            return out
        if self.frontend == "patch":
            # VLM: precomputed patch embeddings prepended conceptually; the
            # backbone consumes embeddings directly.
            out = {"embeds": ((B, S if spec.kind != "decode" else 1,
                               self.d_model), bf16)}
            if spec.kind == "train":
                out["labels"] = ((B, S), i32)
            return out
        if spec.kind == "decode":
            return {"tokens": ((B, 1), i32)}
        out = {"tokens": ((B, S), i32)}
        if spec.kind == "train":
            out["labels"] = ((B, S), i32)
        return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_MODULES = {
    "hymba-1.5b": "hymba_1p5b",
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2",
    "rwkv6-3b": "rwkv6_3b",
    "internvl2-76b": "internvl2_76b",
    "llama3.2-1b": "llama3p2_1b",
    "minitron-8b": "minitron_8b",
    "gemma3-1b": "gemma3_1b",
    "smollm-135m": "smollm_135m",
    "whisper-small": "whisper_small",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def reduced_config(name: str) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    c = get_config(name)
    n_heads = min(c.n_heads, 4)
    kv = max(1, min(c.n_kv_heads, n_heads))
    while n_heads % kv:
        kv -= 1
    return dataclasses.replace(
        c,
        n_layers=min(c.n_layers, 2),
        d_model=128,
        n_heads=n_heads,
        n_kv_heads=kv,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_experts=min(c.n_experts, 4) if c.is_moe else 0,
        moe_top_k=min(c.moe_top_k, 2) if c.is_moe else 0,
        n_shared_experts=min(c.n_shared_experts, 1),
        first_dense_layers=min(c.first_dense_layers, 1),
        ssm_state=min(c.ssm_state, 8) if c.ssm_state else 0,
        sliding_window=min(c.sliding_window, 32) if c.sliding_window else 0,
        n_enc_layers=min(c.n_enc_layers, 2),
        max_decode_len=64,
        rwkv_head_size=32,
    )


def cell_plan(arch: str) -> list[str]:
    """Shape names that are live dry-run cells for this arch."""
    c = get_config(arch)
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not c.sub_quadratic:
            continue  # needs sub-quadratic attention; skip noted in DESIGN.md
        out.append(s.name)
    return out


def model_flops_per_token(cfg: ArchConfig) -> float:
    """MODEL_FLOPS/token = 6·N (active params for MoE)."""
    return 6.0 * cfg.param_count(active_only=True)
