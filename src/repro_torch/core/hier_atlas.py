"""Hierarchical anchor atlas (paper §4.3 scaling option 1).

Two-level structure: K1 ≈ n^(1/4) super-clusters over the flat atlas's
K ≈ √n cluster centroids, with the inverted index lifted to both levels.
Query cost: match super-clusters in O(|S|), score K1 centroids, then score
only the matching sub-clusters of the top super-clusters — O(n^(1/4)·d)
anchor scoring per restart instead of O(√n·d), with identical seed
semantics (the paper leaves this unevaluated; tests/test_hier_atlas.py
validates recall parity against the flat atlas). Host numpy, as in the
reference; the port's copy differs only in ``to_device``'s device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.atlas import (AnchorAtlas, _spec_keys,
                                    _union_over_disjuncts)
from repro_torch.core.kmeans import kmeans
from repro_torch.core.types import Dataset, FilterPredicate


@dataclasses.dataclass
class HierAtlas:
    flat: AnchorAtlas
    super_centroids: np.ndarray          # (K1, d)
    super_assign: np.ndarray             # (K,) cluster -> super
    members_of_super: list[np.ndarray]   # super -> cluster ids
    # super_index[f][v] -> super-cluster ids with >=1 matching point
    super_index: list[dict[int, np.ndarray]]

    @property
    def n_clusters(self) -> int:
        return self.flat.n_clusters

    @staticmethod
    def build(ds: Dataset, atlas: AnchorAtlas | None = None,
              seed: int = 0) -> "HierAtlas":
        flat = atlas or AnchorAtlas.build(ds, seed=seed)
        k1 = max(2, int(round(flat.n_clusters ** 0.5)))
        sup_c, sup_assign = kmeans(flat.centroids, k1, iters=10, seed=seed)
        members = [np.nonzero(sup_assign == s)[0].astype(np.int32)
                   for s in range(k1)]
        # lift the inverted index: value -> supers (dedup of cluster level)
        super_index: list[dict[int, np.ndarray]] = []
        for f in range(len(flat.cluster_index)):
            lifted: dict[int, np.ndarray] = {}
            for v, clusters in flat.cluster_index[f].items():
                lifted[v] = np.unique(sup_assign[clusters])
            super_index.append(lifted)
        return HierAtlas(flat, sup_c, sup_assign.astype(np.int32), members,
                         super_index)

    def _matching_supers_conj(self, clauses) -> np.ndarray:
        acc: np.ndarray | None = None
        for f, allowed in clauses:
            idx = self.super_index[f]
            parts = [idx[v] for v in _spec_keys(allowed, idx)]
            cur = (np.unique(np.concatenate(parts)) if parts
                   else np.empty(0, dtype=np.int32))
            acc = cur if acc is None else np.intersect1d(acc, cur,
                                                         assume_unique=True)
            if acc.size == 0:
                return acc
        if acc is None:
            acc = np.arange(len(self.members_of_super), dtype=np.int32)
        return acc

    def matching_supers(self, pred) -> np.ndarray:
        """Candidate super-clusters for a conjunctive ``FilterPredicate``
        or a compiled ``DNF`` (union over disjuncts, as in the flat
        atlas)."""
        return _union_over_disjuncts(pred, self._matching_supers_conj)

    def select_anchors(self, q: np.ndarray, pred: FilterPredicate,
                       processed: set[int], n_seeds: int = 10,
                       c_max: int = 5, rng=None,
                       vectors: np.ndarray | None = None,
                       n_supers: int = 4) -> tuple[list[int], list[int]]:
        """Two-level anchor selection; same return contract as the flat
        atlas, so FiberIndex/search can use either interchangeably."""
        supers = self.matching_supers(pred)
        if supers.size == 0:
            return [], []
        scores = self.super_centroids[supers] @ q
        top = supers[np.argsort(-scores)[:n_supers]]
        flat_match = self.flat.matching_clusters(pred)
        cand: list[int] = []
        for s in top:
            sub = np.intersect1d(self.members_of_super[s], flat_match,
                                 assume_unique=False)
            cand.extend(int(c) for c in sub if c not in processed)
        if not cand:
            return [], []
        sub_scores = self.flat.centroids[cand] @ q
        ranked = [cand[i] for i in np.argsort(-sub_scores)]
        seeds: list[int] = []
        used: list[int] = []
        yielding = 0
        for c in ranked:
            if len(seeds) >= n_seeds or yielding >= c_max:
                break
            pts = self.flat.cluster_members_matching(c, pred)
            used.append(c)
            if pts.size == 0:
                continue
            yielding += 1
            take = min(n_seeds - len(seeds), pts.size)
            if vectors is not None and pts.size > take:
                sims = vectors[pts] @ q
                pts = pts[np.argsort(-sims)[:take]]
            elif rng is not None and pts.size > take:
                pts = rng.choice(pts, size=take, replace=False)
            seeds.extend(int(p) for p in pts[:take])
        return seeds, used

    # flat-atlas API passthroughs used by FiberIndex consumers
    def to_device(self, v_cap: int | None = None, device=None):
        """Device export delegates to the flat atlas: the hierarchy exists
        to cut *host* centroid scoring from O(√n·d) to O(n^(1/4)·d), but on
        device the full (Q, K) centroid matmul is a single product, so the
        flat layout is both simpler and faster there (DESIGN.md §3).
        ``device`` None means CUDA."""
        return self.flat.to_device(v_cap=v_cap, device=device)

    def matching_clusters(self, pred):
        return self.flat.matching_clusters(pred)

    def cluster_members_matching(self, c, pred, cap: int = 4096):
        return self.flat.cluster_members_matching(c, pred, cap)
