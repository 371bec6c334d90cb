"""HNSW baseline (Malkov & Yashunin) with the two filtered-search strategies
the paper compares against (§6):

* post-filter: retrieve k×20 unfiltered results, discard non-matching;
* traversal-filter: navigate the full graph, collect only matching results
  (FAISS ``IDSelector`` semantics: the candidate queue is unfiltered, the
  result heap admits only selected ids).

The base layer is extractable as a ``Graph`` so the paper's graph-agnostic
claim (guided search on the HNSW base layer) is testable.
"""
from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.types import FilterPredicate


@dataclasses.dataclass
class HNSW:
    vectors: np.ndarray
    m: int
    layers: list[list[list[int]]]   # layers[level][node] -> neighbor ids
    levels: np.ndarray              # (n,) max level per node
    entry: int
    max_level: int

    # ------------------------------------------------------------- build ----
    @staticmethod
    def build(vectors: np.ndarray, m: int = 16, ef_construction: int = 100,
              seed: int = 0) -> "HNSW":
        n = vectors.shape[0]
        rng = np.random.default_rng(seed)
        ml = 1.0 / math.log(m)
        levels = np.minimum(
            (-np.log(rng.random(n)) * ml).astype(np.int32), 32)
        max_level = int(levels.max(initial=0))
        layers: list[list[list[int]]] = [
            [[] for _ in range(n)] for _ in range(max_level + 1)]
        idx = HNSW(vectors, m, layers, levels, entry=0, max_level=int(levels[0]))
        for i in range(1, n):
            idx._insert(i, ef_construction)
        return idx

    def _dist(self, i: int, q: np.ndarray) -> float:
        return float(1.0 - self.vectors[i] @ q)

    def _dists(self, ids: np.ndarray, q: np.ndarray) -> np.ndarray:
        return 1.0 - self.vectors[ids] @ q

    def _greedy(self, q: np.ndarray, ep: int, level: int) -> int:
        """ef=1 greedy descent at one level."""
        cur, cur_d = ep, self._dist(ep, q)
        improved = True
        while improved:
            improved = False
            nbrs = np.asarray(self.layers[level][cur], dtype=np.int64)
            if nbrs.size == 0:
                break
            ds = self._dists(nbrs, q)
            j = int(np.argmin(ds))
            if ds[j] < cur_d:
                cur, cur_d = int(nbrs[j]), float(ds[j])
                improved = True
        return cur

    def _search_layer(self, q: np.ndarray, ep: int, ef: int, level: int,
                      ) -> list[tuple[float, int]]:
        """ef-search at one level; returns [(dist, id)] sorted ascending."""
        d0 = self._dist(ep, q)
        visited = {ep}
        cand = [(d0, ep)]                 # min-heap
        best = [(-d0, ep)]                # max-heap of current top-ef
        while cand:
            d, x = heapq.heappop(cand)
            if d > -best[0][0] and len(best) >= ef:
                break
            nbrs = [y for y in self.layers[level][x] if y not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            arr = np.asarray(nbrs, dtype=np.int64)
            ds = self._dists(arr, q)
            for dy, y in zip(ds, arr):
                if len(best) < ef or dy < -best[0][0]:
                    heapq.heappush(cand, (float(dy), int(y)))
                    heapq.heappush(best, (-float(dy), int(y)))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted((-d, i) for d, i in best)

    def _shrink(self, node: int, level: int) -> None:
        cap = 2 * self.m if level == 0 else self.m
        nbrs = self.layers[level][node]
        if len(nbrs) <= cap:
            return
        arr = np.asarray(nbrs, dtype=np.int64)
        ds = self._dists(arr, self.vectors[node])
        keep = arr[np.argsort(ds)[:cap]]
        self.layers[level][node] = [int(x) for x in keep]

    def _insert(self, i: int, ef_construction: int) -> None:
        q = self.vectors[i]
        lvl = int(self.levels[i])
        ep = self.entry
        for level in range(self.max_level, lvl, -1):
            ep = self._greedy(q, ep, level)
        for level in range(min(lvl, self.max_level), -1, -1):
            found = self._search_layer(q, ep, ef_construction, level)
            nbrs = [x for _, x in found[: self.m]]
            self.layers[level][i] = nbrs
            for x in nbrs:
                self.layers[level][x].append(i)
                self._shrink(x, level)
            ep = found[0][1]
        if lvl > self.max_level:
            self.max_level = lvl
            self.entry = i

    # ------------------------------------------------------------ search ----
    def _descend(self, q: np.ndarray) -> int:
        ep = self.entry
        for level in range(self.max_level, 0, -1):
            ep = self._greedy(q, ep, level)
        return ep

    def search(self, q: np.ndarray, k: int, ef: int = 400) -> tuple[np.ndarray, np.ndarray]:
        ep = self._descend(q)
        found = self._search_layer(q, ep, max(ef, k), 0)[:k]
        ids = np.asarray([i for _, i in found], dtype=np.int64)
        sims = np.asarray([1.0 - d for d, _ in found], dtype=np.float32)
        return ids, sims

    def search_post_filter(self, q: np.ndarray, pred: FilterPredicate,
                           metadata: np.ndarray, k: int, ef: int = 400,
                           over_fetch: int = 20) -> np.ndarray:
        ids, _ = self.search(q, k * over_fetch, ef=max(ef, k * over_fetch))
        if ids.size == 0:
            return ids
        ok = pred.mask(metadata[ids])
        return ids[ok][:k]

    def search_traversal_filter(self, q: np.ndarray, pred: FilterPredicate,
                                metadata: np.ndarray, k: int, ef: int = 400,
                                ) -> np.ndarray:
        """FAISS IDSelector semantics: navigate the full graph, collect only
        matching ids. As in FAISS, the CANDIDATE heap is capacity-bounded at
        ef (MinimaxHeap): when full, farther candidates are dropped — this is
        what bounds exploration (and what makes selective filters fail by
        converging in a region shaped by the full graph, paper §1)."""
        passes = pred.mask(metadata)
        ep = self._descend(q)
        d0 = self._dist(ep, q)
        visited = {ep}
        cand = [(d0, ep)]                       # min-heap, capacity ~ef
        bound = float("inf")                    # drop-threshold when full
        best: list[tuple[float, int]] = []      # max-heap over matching only
        if passes[ep]:
            best.append((-d0, ep))
        while cand:
            d, x = heapq.heappop(cand)
            if len(best) >= ef and d > -best[0][0]:
                break
            nbrs = [y for y in self.layers[0][x] if y not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            arr = np.asarray(nbrs, dtype=np.int64)
            ds = self._dists(arr, q)
            for dy, y in zip(ds, arr):
                dy, y = float(dy), int(y)
                if dy >= bound:
                    continue                    # farther than kept capacity
                heapq.heappush(cand, (dy, y))
                if passes[y]:
                    heapq.heappush(best, (-dy, y))
                    if len(best) > ef:
                        heapq.heappop(best)
            if len(cand) > 2 * ef:              # amortized capacity prune
                cand = heapq.nsmallest(ef, cand)
                heapq.heapify(cand)
                bound = cand[-1][0]
        found = sorted((-d, i) for d, i in best)[:k]
        return np.asarray([i for _, i in found], dtype=np.int64)

    # -------------------------------------------------- base-layer export ----
    def base_graph(self) -> Graph:
        """Level-0 adjacency as a ``Graph`` (paper §4.1 graph-agnostic test)."""
        n = self.vectors.shape[0]
        degs = np.asarray([len(self.layers[0][i]) for i in range(n)],
                          dtype=np.int32)
        r_pad = int(degs.max(initial=1))
        nbr = np.full((n, r_pad), -1, dtype=np.int32)
        for i in range(n):
            lst = self.layers[0][i]
            nbr[i, : len(lst)] = lst
        return Graph(nbr, degs)
