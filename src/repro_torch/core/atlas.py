"""Anchor atlas (paper §4.2): k-means clusters + per-cluster metadata
statistics + inverted cluster index for O(|S|) candidate-cluster retrieval.

Storage is O(n·F) (Lemma 4.1): each point contributes one ``members`` entry
and at most one ``cluster_index`` insertion per populated field.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.kmeans import kmeans
from repro_torch.core.predicate import Interval
from repro_torch.core.types import Dataset, FilterPredicate


def _spec_keys(spec, by_key: dict) -> list:
    """Keys of ``by_key`` selected by a clause spec: literal membership for
    value-sets, a dict-key scan for symbolic intervals (exact — the dict
    holds only codes actually present, so the scan is O(#distinct codes),
    never O(interval width))."""
    if isinstance(spec, Interval):
        return [v for v in by_key if spec.lo <= v <= spec.hi]
    return [v for v in spec if v in by_key]


def _disjuncts(pred) -> tuple:
    """Clause lists of a predicate's disjuncts: a compiled ``DNF`` carries
    several, a conjunctive ``FilterPredicate`` is its own single one."""
    d = getattr(pred, "disjuncts", None)
    return d if d is not None else (pred.clauses,)


def _union_over_disjuncts(pred, conj_fn) -> np.ndarray:
    """Evaluate a per-conjunct candidate function over every disjunct of
    ``pred`` and union the results (sorted unique int32 ids) — the one
    OR-semantics used by all atlas candidate lookups."""
    parts = [conj_fn(cl) for cl in _disjuncts(pred)]
    parts = [p for p in parts if p.size]
    if not parts:
        return np.empty(0, dtype=np.int32)
    return np.unique(np.concatenate(parts))


@dataclasses.dataclass
class AnchorAtlas:
    centroids: np.ndarray                      # (K, d) unit-norm
    assign: np.ndarray                         # (n,) int32 point -> cluster
    # members[c][f][v] -> np.ndarray of point ids (paper's members lists)
    members: list[dict[int, dict[int, np.ndarray]]]
    # cluster_index[f][v] -> np.ndarray of cluster ids (inverted index)
    cluster_index: list[dict[int, np.ndarray]]

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    # -- construction -------------------------------------------------------
    @staticmethod
    def build(ds: Dataset, n_clusters: int | None = None, iters: int = 15,
              seed: int = 0) -> "AnchorAtlas":
        k = n_clusters or int(np.ceil(np.sqrt(ds.n)))
        centroids, assign = kmeans(ds.vectors, k, iters=iters, seed=seed)
        return AnchorAtlas.from_assignment(centroids, assign, ds.metadata)

    @staticmethod
    def from_assignment(centroids: np.ndarray, assign: np.ndarray,
                        metadata: np.ndarray) -> "AnchorAtlas":
        """Build the members / inverted-index tables for a GIVEN clustering
        (the single O(n·F) pass of Lemma 4.1). This is the one shared
        construction: ``build`` feeds it a fresh kmeans, the dynamic-insert
        path feeds it the incrementally maintained assignment."""
        k = centroids.shape[0]
        F = metadata.shape[1]
        members: list[dict[int, dict[int, np.ndarray]]] = [
            {f: {} for f in range(F)} for _ in range(k)]
        cindex: list[dict[int, np.ndarray]] = [{} for _ in range(F)]
        order = np.argsort(assign, kind="stable")
        for f in range(F):
            # rows in cluster order (then row order), unpopulated ones out;
            # each (cluster, value) group's rows in that order, the groups
            # in the order their first rows come: each dict's keys in the
            # order a walk of those rows first meets them
            col = metadata[order, f].astype(np.int64)
            keep = col >= 0
            rows, vals = order[keep], col[keep]
            if rows.size == 0:
                continue
            cs = assign[rows].astype(np.int64)
            key = cs * (int(vals.max()) + 1) + vals
            by = np.argsort(key, kind="stable")
            key = key[by]
            starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
            ends = np.r_[starts[1:], key.size]
            groups = np.argsort(by[starts], kind="stable")
            seen: dict[int, list[int]] = {}
            for g in groups:
                a, b = starts[g], ends[g]
                c, v = int(cs[by[a]]), int(vals[by[a]])
                members[c][f][v] = rows[by[a:b]].astype(np.int32)
                seen.setdefault(v, []).append(c)
            cindex[f] = {v: np.unique(np.asarray(lst, dtype=np.int32))
                         for v, lst in seen.items()}
        return AnchorAtlas(centroids, assign.astype(np.int32), members, cindex)

    # -- query-time operations ----------------------------------------------
    def _matching_clusters_conj(self, clauses) -> np.ndarray:
        """C_match = ∩_i cluster_index[f_i][A_i] in O(|S|) set ops."""
        acc: np.ndarray | None = None
        for f, allowed in clauses:
            idx = self.cluster_index[f]
            cs = [idx[v] for v in _spec_keys(allowed, idx)]
            cur = (np.unique(np.concatenate(cs)) if cs
                   else np.empty(0, dtype=np.int32))
            acc = cur if acc is None else np.intersect1d(acc, cur,
                                                         assume_unique=True)
            if acc.size == 0:
                return acc
        if acc is None:  # unconstrained conjunct: all clusters match
            acc = np.arange(self.n_clusters, dtype=np.int32)
        return acc

    def matching_clusters(self, pred) -> np.ndarray:
        """Candidate clusters for a conjunctive ``FilterPredicate`` (the
        paper's postings intersection) or a compiled ``DNF`` (union of the
        per-disjunct intersections — a cluster is a candidate iff any
        disjunct can match inside it)."""
        return _union_over_disjuncts(pred, self._matching_clusters_conj)

    def _members_matching_conj(self, c: int, clauses) -> np.ndarray:
        acc: np.ndarray | None = None
        for f, allowed in clauses:
            by_val = self.members[c][f]
            parts = [by_val[v] for v in _spec_keys(allowed, by_val)]
            cur = (np.unique(np.concatenate(parts)) if parts
                   else np.empty(0, dtype=np.int32))
            acc = cur if acc is None else np.intersect1d(acc, cur,
                                                         assume_unique=True)
            if acc.size == 0:
                return acc
        if acc is None:
            acc = np.nonzero(self.assign == c)[0].astype(np.int32)
        return acc

    def cluster_members_matching(self, c: int, pred,
                                 cap: int = 4096) -> np.ndarray:
        """Filter-matching point ids inside cluster c via members
        intersection, unioned over the predicate's disjuncts (a single
        conjunction for plain FilterPredicates)."""
        return _union_over_disjuncts(
            pred, lambda cl: self._members_matching_conj(c, cl))[:cap]

    def select_anchors(
        self, q: np.ndarray, pred: FilterPredicate, processed: set[int],
        n_seeds: int = 10, c_max: int = 5, rng: np.random.Generator | None = None,
        vectors: np.ndarray | None = None,
    ) -> tuple[list[int], list[int]]:
        """One anchor-selection round (Alg. 2 lines 3–14).

        When ``vectors`` is given, seeds are the NEAREST matching members of
        each yielding cluster (the paper's in-cluster brute-force cosine,
        §4.3 — "negligible" cost, and what masked_cosine_topk accelerates on
        TPU); otherwise a deterministic random sample.

        Returns (seed point ids, cluster ids consumed this round).
        """
        cand = [c for c in self.matching_clusters(pred).tolist()
                if c not in processed]
        if not cand:
            return [], []
        scores = self.centroids[cand] @ q
        ranked = [cand[i] for i in np.argsort(-scores)]
        seeds: list[int] = []
        used: list[int] = []
        yielding = 0
        # C_match is a per-field superset for conjunctions: a cluster may hold
        # points matching each clause separately but none jointly. We scan
        # ranked clusters until c_max *seed-yielding* clusters are consumed
        # ("seeds are drawn until the seed budget is filled", §4.2) — still
        # O(|C_match|) work per restart.
        for c in ranked:
            if len(seeds) >= n_seeds or yielding >= c_max:
                break
            pts = self.cluster_members_matching(c, pred)
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

    # -- device export -------------------------------------------------------
    def to_device(self, v_cap: int | None = None, device=None):
        """Pack into a DeviceAtlas (flat device tensors; DESIGN.md §3) for
        batched on-accelerator anchor selection. v_cap=None auto-sizes to
        the metadata vocabulary; ``device`` None means CUDA."""
        from repro_torch.core.device_atlas import DeviceAtlas
        return DeviceAtlas.from_atlas(self, v_cap=v_cap, device=device)

    # -- storage accounting (Lemma 4.1 validation) ---------------------------
    def storage_entries(self) -> tuple[int, int]:
        m = sum(arr.size for cl in self.members for by_f in cl.values()
                for arr in by_f.values())
        ci = sum(arr.size for by_f in self.cluster_index for arr in by_f.values())
        return m, ci
