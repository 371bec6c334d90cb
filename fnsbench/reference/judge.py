"""The comparison that decides ``correct``, and recall@k.

Each request is one query of the pool and the answer the program gave
it: ids, best first, or none. Answers are judged by what they say:

* ``unanswered``: requests with no answer after the drain (limit 0);
* ``errors``: requests the program answered with an error (limit 0);
* ``bad_ids``: returned ids outside the corpus, repeated within an
  answer, beyond k, or failing the request's predicate by this
  module's own evaluator (limit 0: the filter is exact);
* ``short_answers``: answers with fewer than min(k, rows passing) ids
  (limit 0: a top-k search returns k rows wherever k pass);
* ``order_gap``: the widest amount by which a later id of an answer is
  more similar to the query than an earlier one, by float64 cosine.
  The program orders its results by float32 similarity, so a sound run
  reads rounding only; products in a lower precision misorder near
  ties by far more. Its limit is the configuration's, set from readings
  of the program and of the TF32 control (PERF.md).

Recall@k is |returned ∩ exact top-k| / min(k, rows passing), averaged
over every request; one never answered recalls 0.
"""
from __future__ import annotations

import numpy as np
import torch

from fnsbench.reference.exact import exact_topk, fiber_sizes, pair_sims
from fnsbench.reference.predicates import mask_np


def unique_answers(entries: np.ndarray, answers: list):
    """Distinct (entry, ids) answers, a representative request each and
    how many requests gave it; answers that are None are left out."""
    seen: dict = {}
    for j, (e, ids) in enumerate(zip(entries.tolist(), answers)):
        if ids is None:
            continue
        key = (e, np.asarray(ids, dtype=np.int64).tobytes())
        if key in seen:
            seen[key][1] += 1
        else:
            seen[key] = [j, 1]
    reps = [v[0] for v in seen.values()]
    counts = np.asarray([v[1] for v in seen.values()], dtype=np.int64)
    return reps, counts


def order_gaps(sims: np.ndarray, lengths: np.ndarray, k: int) -> np.ndarray:
    """Per answer, max over positions j > i of sims[j] - sims[i] (0 when
    the answer is in order)."""
    u = len(lengths)
    grid = np.full((u, k), np.nan)
    pos = np.arange(k)[None, :] < lengths[:, None]
    grid[pos] = sims
    best_before = np.fmin.accumulate(np.where(np.isnan(grid), np.inf, grid),
                                     axis=1)
    gap = grid[:, 1:] - best_before[:, :-1]
    gap = np.where(np.isnan(gap), -np.inf, gap)
    return np.maximum(gap.max(axis=1, initial=-np.inf), 0.0)


def judge(vectors: torch.Tensor, meta: torch.Tensor, pool_vecs: np.ndarray,
          preds: list, entries: np.ndarray, answers: list, errors: list,
          k: int, limits: dict, recall: bool = True):
    """Returns ({check: (value, limit)}, recall@k, readings) for the
    requests ``entries`` (pool indices) with their ``answers`` (id arrays
    best first, or None) and ``errors`` (None or a message). Recall is
    left out (nan) where ``recall`` is False."""
    n = vectors.shape[0]
    meta_np = meta.cpu().numpy()
    fiber = fiber_sizes(preds, meta)
    reps, counts = unique_answers(entries, answers)
    bad = short = 0
    lens = np.zeros(len(reps), dtype=np.int64)
    pair_e, pair_i = [], []
    for u, j in enumerate(reps):
        e = int(entries[j])
        ids = np.asarray(answers[j], dtype=np.int64)
        inside = ids[(ids >= 0) & (ids < n)]
        nbad = (ids.size - inside.size
                + ids.size - np.unique(ids).size
                + max(0, ids.size - k)
                + int((~mask_np(preds[e], meta_np[inside])).sum()))
        bad += nbad * counts[u]
        short += int(ids.size < min(k, fiber[e])) * counts[u]
        if nbad == 0:
            lens[u] = ids.size
            pair_e.append(np.full(ids.size, e))
            pair_i.append(ids)
    qv = torch.as_tensor(pool_vecs, device=vectors.device)
    sims = pair_sims(vectors, qv,
                     np.concatenate(pair_e) if pair_e else np.zeros(0, int),
                     np.concatenate(pair_i) if pair_i else np.zeros(0, int))
    gaps = order_gaps(sims, lens, k) if len(reps) else np.zeros(0)

    mean_recall = float("nan")
    if recall:
        gt = exact_topk(vectors, meta, pool_vecs, preds, k)
        hit = 0.0
        for u, j in enumerate(reps):
            e = int(entries[j])
            found = np.intersect1d(np.asarray(answers[j], dtype=np.int64),
                                   gt[e]).size
            hit += counts[u] * found / max(1, min(k, fiber[e]))
        mean_recall = hit / len(answers) if len(answers) else float("nan")

    checks = {
        "unanswered": (int(sum(a is None for a in answers)), 0),
        "errors": (int(sum(x is not None for x in errors)), 0),
        "bad_ids": (int(bad), 0),
        "short_answers": (int(short), 0),
        "order_gap": (float(gaps.max(initial=0.0)), limits["order_gap"]),
    }
    readings = {"fiber_min": int(fiber.min()) if fiber.size else 0,
                "distinct_answers": len(reps),
                "order_gap_p99": float(np.quantile(gaps, 0.99))
                if len(gaps) else 0.0}
    return checks, mean_recall, readings


def verdict(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())
