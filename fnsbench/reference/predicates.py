"""The benchmark's own predicates and their evaluator.

A predicate is a tuple of disjuncts; a disjunct a tuple of clauses; a
clause ``("in", field, codes)`` (the row's code is one of ``codes``) or
``("range", field, lo, hi)`` (the code lies in ``[lo, hi]``). A row
passes when every clause of some disjunct holds. Code -1 marks an
unpopulated field and passes no clause. This module is the reference's
evaluator: it imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch


def conj(clauses: dict) -> tuple:
    """One disjunct of ``In`` clauses from ``{field: codes}``."""
    return (tuple(("in", int(f), tuple(sorted(int(v) for v in vs)))
                  for f, vs in sorted(clauses.items())),)


def or_pair(field_a: int, field_b: int, code: int) -> tuple:
    return ((("in", field_a, (code,)),), (("in", field_b, (code,)),))


def prefix_range(field: int, hi: int) -> tuple:
    return ((("range", field, 0, hi),),)


def _clause_np(c, meta: np.ndarray) -> np.ndarray:
    col = meta[:, c[1]]
    if c[0] == "in":
        return np.isin(col, np.asarray([v for v in c[2] if v >= 0],
                                       dtype=np.int64))
    if c[0] == "range":
        return (col >= max(c[2], 0)) & (col <= c[3])
    raise ValueError(f"unknown clause {c!r}")


def mask_np(pred: tuple, meta: np.ndarray) -> np.ndarray:
    """(rows,) bool: which rows of ``meta`` pass ``pred``."""
    out = np.zeros(meta.shape[0], dtype=bool)
    for disj in pred:
        m = np.ones(meta.shape[0], dtype=bool)
        for c in disj:
            m &= _clause_np(c, meta)
        out |= m
    return out


def _clause_torch(c, meta: torch.Tensor) -> torch.Tensor:
    col = meta[:, c[1]]
    if c[0] == "in":
        codes = torch.tensor([v for v in c[2] if v >= 0], dtype=col.dtype,
                             device=col.device)
        return torch.isin(col, codes)
    if c[0] == "range":
        return (col >= max(c[2], 0)) & (col <= c[3])
    raise ValueError(f"unknown clause {c!r}")


def mask_torch(pred: tuple, meta: torch.Tensor) -> torch.Tensor:
    """``mask_np`` on a device tensor of metadata codes."""
    out = torch.zeros(meta.shape[0], dtype=torch.bool, device=meta.device)
    for disj in pred:
        m = torch.ones_like(out)
        for c in disj:
            m &= _clause_torch(c, meta)
        out |= m
    return out
