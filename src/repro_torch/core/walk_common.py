"""Shared per-query walk state: potential cache, seen/expanded sets, results.

The potential is V(x) = 1 − cos(q, x) (paper §3.3). ``passes`` is the
per-query corpus filter mask (vectorized precompute; semantics identical to
the paper's cached per-node O(|S|) check — see DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.types import WalkStats


@dataclasses.dataclass
class WalkContext:
    vectors: np.ndarray          # (n, d) unit-norm
    graph: Graph
    q: np.ndarray                # (d,)
    passes: np.ndarray           # (n,) bool — filter mask for this query

    def __post_init__(self) -> None:
        n = self.vectors.shape[0]
        self.V = np.full(n, np.inf, dtype=np.float32)   # potential cache
        self.seen = np.zeros(n, dtype=bool)
        self.expanded = np.zeros(n, dtype=bool)
        self.results: dict[int, float] = {}             # id -> cos sim

    # -- potentials -----------------------------------------------------------
    def potential(self, ids: np.ndarray) -> np.ndarray:
        """V for ids, computing+caching the uncached ones in one matmul."""
        ids = np.asarray(ids, dtype=np.int64)
        miss = ids[~np.isfinite(self.V[ids])]
        if miss.size:
            self.V[miss] = 1.0 - self.vectors[miss] @ self.q
        return self.V[ids]

    # -- expansion ------------------------------------------------------------
    def expand(self, x: int) -> tuple[np.ndarray, np.ndarray, int]:
        """Expand node x: mark neighbors seen, cache V, collect filtered.

        Returns (all neighbor ids, newly-seen neighbor ids, new_filtered).
        """
        self.expanded[x] = True
        nbrs = self.graph.neighbor_list(x).astype(np.int64)
        new = nbrs[~self.seen[nbrs]]
        self.seen[new] = True
        v = self.potential(nbrs)  # cache for drift + queue management
        new_filtered = 0
        if new.size:
            new_pass = new[self.passes[new]]
            new_filtered = int(new_pass.size)
            for y in new_pass:
                self.results[int(y)] = float(1.0 - self.V[y])
        return nbrs, new, new_filtered

    def seed(self, seeds: list[int]) -> np.ndarray:
        ids = np.asarray(sorted(set(seeds)), dtype=np.int64)
        self.potential(ids)
        self.seen[ids] = True
        for s in ids[self.passes[ids]]:
            self.results[int(s)] = float(1.0 - self.V[s])
        return ids

    # -- local signals (paper §3.3) --------------------------------------------
    def fiber_stats(self, x: int, nbrs: np.ndarray) -> tuple[float, float, int]:
        """(ρ_S(x), drift(x), |B⁻(x)|) at node x given its neighbor ids."""
        if nbrs.size == 0:
            return 0.0, float("nan"), 0
        p = self.passes[nbrs]
        rho = float(p.mean())
        vx = float(self.potential(np.asarray([x]))[0])
        vn = self.potential(nbrs)
        fib = vn[p]
        drift = float((fib - vx).mean()) if fib.size else float("nan")
        b_minus = int(np.sum(vn[~p] < vx))
        return rho, drift, b_minus

    def stall_record(self, x: int, stats: WalkStats) -> None:
        if x < 0:
            return
        nbrs = self.graph.neighbor_list(x).astype(np.int64)
        rho, drift, bm = self.fiber_stats(x, nbrs)
        stats.stall_node = x
        stats.stall_rho = rho
        stats.stall_drift = drift
        stats.stall_b_minus = bm
        stats.stall_potential = float(self.potential(np.asarray([x]))[0])

    def kth_best_potential(self, k: int) -> float:
        """V_(k): potential of current k-th best result (inf if < k results)."""
        if len(self.results) < k:
            return np.inf
        sims = np.fromiter(self.results.values(), dtype=np.float32)
        kth = np.partition(-sims, k - 1)[k - 1]
        return float(1.0 + kth)  # 1 - (kth best sim)
