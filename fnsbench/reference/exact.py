"""Exact filtered top-k, fiber sizes and exact similarities: plain PyTorch
in float32 with TF32 off (float64 for the similarities the comparison
judges by), computed in blocks on whatever device holds the corpus. The
lower-precision control (``tf32=True``) runs the same products in TF32:
on the card through cuBLAS, on the CPU by rounding both inputs to TF32's
10-bit mantissa as the card's tensor cores do.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from fnsbench.reference.predicates import mask_torch

BLOCK = 1024        # queries a product block
PAIR_BLOCK = 1 << 17  # (query, row) pairs a similarity block


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, nearest, ties
    away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products in full float32 (``tf32`` False) or in TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fiber_sizes(preds: list, meta: torch.Tensor) -> np.ndarray:
    """Rows passing each predicate."""
    if not preds:
        return np.zeros(0, dtype=np.int64)
    return torch.stack([mask_torch(p, meta).sum() for p in preds]
                       ).cpu().numpy().astype(np.int64)


def exact_topk(vectors: torch.Tensor, meta: torch.Tensor, qvecs: np.ndarray,
               preds: list, k: int, *, tf32: bool = False) -> list:
    """Each query's ids of its ``k`` most similar passing rows (fewer
    where fewer pass), best first."""
    dev = vectors.device
    emulate = tf32 and dev.type != "cuda"
    corpus = tf32_round(vectors) if emulate else vectors
    out = []
    for lo in range(0, len(preds), BLOCK):
        q = torch.as_tensor(qvecs[lo:lo + BLOCK], dtype=torch.float32,
                            device=dev)
        with matmul_precision(tf32):
            s = (tf32_round(q) if emulate else q) @ corpus.T
        passes = torch.stack([mask_torch(p, meta)
                              for p in preds[lo:lo + BLOCK]])
        s = s.masked_fill(~passes, float("-inf"))
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        v, i = v.cpu().numpy(), i.cpu().numpy()
        out += [ii[np.isfinite(vv)].astype(np.int64) for vv, ii in zip(v, i)]
    return out


def pair_sims(vectors: torch.Tensor, qvecs: torch.Tensor, entries: np.ndarray,
              ids: np.ndarray) -> np.ndarray:
    """float64 cosine of query ``entries[j]`` with row ``ids[j]``."""
    dev = vectors.device
    out = []
    for lo in range(0, len(ids), PAIR_BLOCK):
        e = torch.as_tensor(entries[lo:lo + PAIR_BLOCK], device=dev)
        r = torch.as_tensor(ids[lo:lo + PAIR_BLOCK], device=dev)
        out.append((vectors[r].double() * qvecs[e].double()).sum(1).cpu())
    if not out:
        return np.zeros(0)
    return torch.cat(out).numpy()
