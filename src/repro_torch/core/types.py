"""Core datatypes for fiber-navigable filtered ANN search.

A *dataset* is a unit-normalized vector table plus integer-coded categorical
metadata. A *filter predicate* is a conjunction over fields, each field
restricted to a set of allowed codes (paper §3.1); single-value equality is
the common case. General boolean filters (Or / Not / Range) live in
``core.predicate`` as the ``FilterExpr`` algebra; ``FilterPredicate`` is the
conjunctive compatibility alias — a single-disjunct expression — and its
numpy oracles delegate to the expression tree (DESIGN.md §8).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.predicate import And, FilterExpr, In


@dataclasses.dataclass
class Dataset:
    """Unit-norm vectors (n, d) float32 + metadata codes (n, F) int32.

    ``field_names``/``vocab_sizes`` describe the metadata schema; code -1
    denotes "field not populated" (sparse metadata, §4.3).
    """

    vectors: np.ndarray
    metadata: np.ndarray
    field_names: list[str]
    vocab_sizes: list[int]

    def __post_init__(self) -> None:
        assert self.vectors.ndim == 2 and self.metadata.ndim == 2
        assert self.vectors.shape[0] == self.metadata.shape[0]
        assert self.metadata.shape[1] == len(self.field_names)

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def d(self) -> int:
        return self.vectors.shape[1]

    @property
    def n_fields(self) -> int:
        return self.metadata.shape[1]


@functools.lru_cache(maxsize=1024)
def _pred_expr(clauses: tuple) -> FilterExpr:
    return And(*(In(f, vals) for f, vals in clauses))


@dataclasses.dataclass(frozen=True)
class FilterPredicate:
    """Conjunctive predicate: field -> allowed value codes (paper §3.1).

    ``clauses`` maps field index to a tuple of allowed codes. A point passes
    when every constrained field's code is in the allowed set. This is the
    thin compatibility alias over the ``core.predicate`` algebra: it is
    exactly the single-disjunct expression ``And(In(f, vals), ...)`` and
    its numpy oracles evaluate that tree.
    """

    clauses: tuple[tuple[int, tuple[int, ...]], ...]

    @staticmethod
    def make(clauses: Mapping[int, Sequence[int]] | Sequence[tuple[int, int]]) -> "FilterPredicate":
        if isinstance(clauses, Mapping):
            items = [(int(f), tuple(sorted(int(v) for v in vs)))
                     for f, vs in sorted(clauses.items())]
        else:  # sequence of (field, single value) pairs
            acc: dict[int, set[int]] = {}
            for f, v in clauses:
                acc.setdefault(int(f), set()).add(int(v))
            items = [(f, tuple(sorted(vs))) for f, vs in sorted(acc.items())]
        return FilterPredicate(tuple(items))

    @property
    def n_clauses(self) -> int:
        return len(self.clauses)

    def expr(self) -> FilterExpr:
        """The predicate as a ``FilterExpr`` tree (single conjunction)."""
        return _pred_expr(self.clauses)

    def matches_row(self, row: np.ndarray,
                    vocab_sizes: Sequence[int] | None = None) -> bool:
        """O(|S|) per-node membership check (paper §5.3). Inline loop kept
        for the per-candidate hot path (HNSW baselines); bit-identical to
        ``self.expr().matches_row`` — a code of -1 fails every clause."""
        del vocab_sizes
        for f, allowed in self.clauses:
            v = int(row[f])
            if v < 0 or v not in allowed:
                return False
        return True

    def mask(self, metadata: np.ndarray,
             vocab_sizes: Sequence[int] | None = None) -> np.ndarray:
        """Vectorized corpus-wide pass mask (the per-query bitmap precompute
        used by the batched engine; semantics identical to matches_row)."""
        return self.expr().mask(metadata, vocab_sizes)


@dataclasses.dataclass
class Query:
    vector: np.ndarray            # (d,) unit-norm
    predicate: "FilterPredicate | FilterExpr"
    gt_ids: np.ndarray | None = None      # ground-truth filtered top-k ids
    gt_sims: np.ndarray | None = None
    selectivity: float = float("nan")


@dataclasses.dataclass
class WalkStats:
    """Per-walk record: termination + stall-point diagnostics (paper §8.2)."""

    hops: int = 0
    phase1_hops: int = 0
    phase2_hops: int = 0
    termination: str = "none"     # converged | early_stop | stall_budget | max_hops | no_seeds
    stall_node: int = -1
    stall_rho: float = float("nan")       # fiber density at stall point
    stall_drift: float = float("nan")
    stall_b_minus: int = -1               # |B^-(x*)|
    stall_potential: float = float("nan")  # V(x*)
    n_results: int = 0


@dataclasses.dataclass
class SearchStats:
    """Per-query record aggregating the outer restart loop (Alg. 2)."""

    n_walks: int = 0
    hops: int = 0
    n_results: int = 0
    walks: list[WalkStats] = dataclasses.field(default_factory=list)
    recall_after_walk: list[float] = dataclasses.field(default_factory=list)


def normalize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    nrm = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(nrm, 1e-12)
