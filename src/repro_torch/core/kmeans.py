"""Blocked Lloyd's k-means on the sphere (atlas substrate, paper §4.2).

Spherical k-means: assignment by max cosine, centroids re-normalized.
kmeans++-style seeding with a sampled candidate pool keeps init O(n·K') not
O(n·K·d) per step.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import normalize


def _plusplus_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    n = x.shape[0]
    centers = np.empty((k, x.shape[1]), dtype=x.dtype)
    centers[0] = x[rng.integers(n)]
    d2 = np.maximum(0.0, 1.0 - x @ centers[0])
    for i in range(1, k):
        p = d2 / max(d2.sum(), 1e-12)
        centers[i] = x[rng.choice(n, p=p)]
        d2 = np.minimum(d2, np.maximum(0.0, 1.0 - x @ centers[i]))
    return centers


def kmeans(x: np.ndarray, k: int, iters: int = 15, seed: int = 0,
           block: int = 8192) -> tuple[np.ndarray, np.ndarray]:
    """Returns (centroids (k,d) unit-norm, assignment (n,) int32)."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    k = min(k, n)
    centers = _plusplus_init(x, k, rng)
    assign = np.zeros(n, dtype=np.int32)
    for _ in range(iters):
        for s in range(0, n, block):
            e = min(s + block, n)
            assign[s:e] = np.argmax(x[s:e] @ centers.T, axis=1)
        sums = np.zeros_like(centers)
        np.add.at(sums, assign, x)
        counts = np.bincount(assign, minlength=k)
        empty = counts == 0
        if empty.any():  # re-seed empty clusters from random points
            sums[empty] = x[rng.integers(0, n, size=int(empty.sum()))]
            counts[empty] = 1
        centers = normalize(sums / counts[:, None])
    return centers, assign
