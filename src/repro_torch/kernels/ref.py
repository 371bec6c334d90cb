"""Plain PyTorch versions of the main-path kernels (the allclose targets
of the CUDA kernels, and what a CPU tensor runs).

Semantics contract shared by kernel and plain version (identical to the
reference package's jnp oracles; bitmaps are int32 words with the
reference's bit layout, see ``core/batched/bitmap.py``):

* masked_cosine_topk: scores = Q @ X^T; positions whose filter bit is 0 (or
  column >= n) score -inf; per-query top-k (sims desc, ids; ties go to the
  lower id); -inf/-1 where fewer than k rows pass.
* fiber_expand_walk: ONE gather+dot per (q, r) feeding two outputs — sims
  masked only by id validity (the walk's traversal distances) and sims
  additionally masked by the filter bit (the result-queue candidates).
* filter_eval_batch: packed (Q, ceil(n/32)) pass bitmaps from the
  ``pack_predicates`` clause tables (fields (Q, C) i32; allowed (Q, C, Wv)
  value-bitmap words); disjunctive (Q, D, C) ``pack_dnf`` tables OR the
  per-disjunct conjunctive bitmaps (dead-disjunct padding, marked with
  field sentinel -2, contributes nothing); code -1 fails every clause.
"""
from __future__ import annotations

import torch

from repro_torch.core.batched.bitmap import pack_bits

NEG = float("-inf")


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` semantics along the last axis: the k largest values in
    descending order, ties broken toward the LOWER index. ``torch.topk``
    gives no such order among ties (and walk queues are full of INF/-1
    ties), so this is a stable descending sort, sliced."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _bit(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bit ``pos & 31`` of each int32 word, as bool (logical shift)."""
    return (((words.to(torch.int64) & 0xFFFFFFFF) >> (pos & 31)) & 1) == 1


def masked_cosine_topk(queries: torch.Tensor, corpus: torch.Tensor,
                       bitmap: torch.Tensor, k: int):
    """queries (Q, d); corpus (n, d); bitmap (Q, ceil(n/32)) int32.

    Returns (sims (Q, k) f32 desc, ids (Q, k) i32; -inf/-1 where fewer than
    k pass)."""
    n = corpus.shape[0]
    scores = queries.float() @ corpus.float().T
    cols = torch.arange(n, device=corpus.device)
    bits = _bit(bitmap[:, cols >> 5], cols)
    scores = torch.where(bits, scores, NEG)
    sims, ids = top_k(scores, k)
    ids = torch.where(torch.isfinite(sims), ids, -1).to(torch.int32)
    return sims, ids


def fiber_expand_walk(q_vecs: torch.Tensor, corpus: torch.Tensor,
                      ids: torch.Tensor, bitmap: torch.Tensor):
    """q_vecs (Q, d); corpus (n, d); ids (Q, R) i32 (-1 pad);
    bitmap (Q, n_words) int32. Returns (sims, sims_pass), both (Q, R) f32:
    ``sims`` is -inf only for padded ids, ``sims_pass`` additionally -inf
    where the id's filter bit is 0."""
    safe = ids.clamp(min=0).to(torch.int64)
    rows = corpus[safe].float()                          # (Q, R, d)
    sims = torch.einsum("qrd,qd->qr", rows, q_vecs.float())
    bits = _bit(torch.gather(bitmap, 1, safe >> 5), safe)
    valid = ids >= 0
    return (torch.where(valid, sims, NEG),
            torch.where(valid & bits, sims, NEG))


def _conj_ok(metadata: torch.Tensor, fields: torch.Tensor,
             allowed: torch.Tensor, bounds: torch.Tensor | None = None):
    """(Q, n) bool conjunction for one clause-table slice: fields (Q, C)
    i32, allowed (Q, C, Wv) value-bitmap words, optional bounds (Q, C, 2)
    i32 interval rows (a clause with lo <= hi is the two-comparison
    interval test; its bitmap row is zero)."""
    n = metadata.shape[0]
    q_n, n_clauses = fields.shape
    v_cap = allowed.shape[-1] * 32
    ok = torch.ones((q_n, n), dtype=torch.bool, device=metadata.device)
    for c in range(n_clauses):
        f = fields[:, c]                                        # (Q,)
        vals = metadata[:, f.clamp(min=0).long()].T.long()      # (Q, n)
        safe = vals.clamp(0, v_cap - 1)
        words = torch.gather(allowed[:, c, :], 1, safe >> 5)
        clause_ok = _bit(words, safe) & (vals >= 0) & (vals < v_cap)
        if bounds is not None:
            lo = bounds[:, c, 0][:, None]                       # (Q, 1)
            hi = bounds[:, c, 1][:, None]
            iv_ok = (vals >= 0) & (vals >= lo) & (vals <= hi)
            clause_ok = torch.where(lo <= hi, iv_ok, clause_ok)
        ok = torch.where((f >= 0)[:, None], ok & clause_ok, ok)
    return ok


def filter_eval_batch(metadata: torch.Tensor, fields: torch.Tensor,
                      allowed: torch.Tensor,
                      n_disj: torch.Tensor | None = None,
                      bounds: torch.Tensor | None = None):
    """metadata (n, F) i32; fields (Q, C) i32 (-1 = inactive clause);
    allowed (Q, C, ceil(v_cap/32)) int32 value-bitmap words. Returns
    (Q, ceil(n/32)) int32 packed pass bitmaps; pad bits beyond n are 0.

    Disjunctive form (the ``pack_dnf`` tables): fields (Q, D, C) i32
    (-2 = dead-disjunct padding), allowed (Q, D, C, Wv), n_disj (Q,) i32
    live-disjunct counts (derived from the sentinel when omitted); the
    bitmap is the union over live disjuncts of conjunctive bitmaps.
    Optional bounds (Q, D, C, 2) i32 marks interval clauses (lo <= hi)."""
    n = metadata.shape[0]
    q_n = fields.shape[0]
    if fields.ndim == 3:
        if n_disj is None:
            from repro_torch.kernels.filter_eval import table_n_disj
            n_disj = table_n_disj(fields)
        ok = torch.zeros((q_n, n), dtype=torch.bool, device=metadata.device)
        for d in range(fields.shape[1]):
            ok_d = _conj_ok(metadata, fields[:, d, :], allowed[:, d, :, :],
                            None if bounds is None else bounds[:, d, :, :])
            ok = ok | (ok_d & (d < n_disj)[:, None])
    else:
        ok = _conj_ok(metadata, fields, allowed)
    return pack_bits(ok)
