"""Brute-force filtered ground truth (blocked matmul; oracle for everything)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import Dataset, Query


def filtered_topk(vectors: np.ndarray, q: np.ndarray, passes: np.ndarray,
                  k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k by cosine among ``passes`` rows. Returns (ids, sims)."""
    ids = np.nonzero(passes)[0]
    if ids.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.float32)
    sims = vectors[ids] @ q
    k = min(k, ids.size)
    sel = np.argpartition(-sims, k - 1)[:k]
    order = np.argsort(-sims[sel])
    sel = sel[order]
    return ids[sel], sims[sel].astype(np.float32)


def attach_ground_truth(ds: Dataset, queries: list[Query], k: int = 25,
                        block: int = 4096) -> None:
    """Compute exact filtered top-k for each query in place. The pass mask
    is the predicate's expression-tree oracle; the dataset's declared
    vocabularies supply the Not/Range domains for FilterExpr queries."""
    for q in queries:
        passes = q.predicate.mask(ds.metadata, ds.vocab_sizes)
        q.gt_ids, q.gt_sims = filtered_topk(ds.vectors, q.vector, passes, k)


def recall_at_k(found_ids: np.ndarray, gt_ids: np.ndarray) -> float:
    """Fractional recall vs the ground-truth set (paper §8.3 semantics)."""
    if gt_ids is None or gt_ids.size == 0:
        return 1.0
    return float(np.intersect1d(found_ids, gt_ids).size) / float(gt_ids.size)
