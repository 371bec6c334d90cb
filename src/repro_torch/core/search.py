"""Outer search loop with anchor restarts (paper Algorithm 2).

Graph-agnostic: works on any ``Graph`` (α-kNN or an HNSW base layer) plus an
``AnchorAtlas`` or a ``HierAtlas``. The walk procedure is injected (beam /
drift-guided).
Host numpy and ``heapq`` only, as in the reference: the sequential path
runs on the CPU whatever device the batched engines use.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Literal

import numpy as np

from repro_torch.core.atlas import AnchorAtlas
from repro_torch.core.graph import Graph
from repro_torch.core.hier_atlas import HierAtlas
from repro_torch.core.predicate import (FilterExpr, as_dnf,
                                       derived_vocab_sizes)
from repro_torch.core.types import FilterPredicate, Query, SearchStats
from repro_torch.core.walk_beam import beam_walk
from repro_torch.core.walk_common import WalkContext
from repro_torch.core.walk_guided import guided_walk
from repro_torch.data.ground_truth import recall_at_k


@dataclasses.dataclass(frozen=True)
class SearchParams:
    k: int = 25
    jump_budget: int = 3          # J: restarts beyond the first walk
    n_seeds: int = 10             # n_s
    c_max: int = 5                # clusters sampled per restart
    beam_width: int = 40          # B (beam walk default; guided uses 2)
    frontier_width: int = 5       # K_f
    stall_budget: int = 100       # T
    max_hops: int = 100
    walk: Literal["beam", "guided"] = "guided"
    refine_rounds: int = 0   # beyond-paper: post-walk neighbor sweeps of the
    # current top results (backfills near-tie neighbours that the tiny guided
    # beam pruned; see EXPERIMENTS.md §Perf ANN track)


@dataclasses.dataclass
class FiberIndex:
    """The paper's full index: proximity graph + anchor atlas."""

    vectors: np.ndarray
    metadata: np.ndarray
    graph: Graph
    atlas: AnchorAtlas | HierAtlas

    def vocab_sizes(self) -> tuple[int, ...]:
        """Per-field domains for FilterExpr Not/Range lowering, derived
        from the metadata once and memoized. NOT an invariant once ingest
        exists: ``extend_vocab`` must be called when inserts widen a
        field's domain, or Not/open-ended-Range queries silently miss the
        newly introduced codes."""
        vs = getattr(self, "_vocab_sizes", None)
        if vs is None:
            vs = derived_vocab_sizes(self.metadata)
            self._vocab_sizes = vs
        return vs

    def extend_vocab(self, sizes) -> tuple[int, ...]:
        """Widen the memoized per-field domains to cover ``sizes``
        (elementwise max; extra trailing fields append). Engines call this
        after every ingest batch so the sequential parity path lowers
        Not/Range against domains that include inserted codes."""
        cur = self.vocab_sizes()
        sizes = tuple(int(s) for s in sizes)
        merged = tuple(max(a, b) for a, b in zip(cur, sizes))
        self._vocab_sizes = merged + sizes[len(cur):]
        return self._vocab_sizes


def search(index: FiberIndex, q: np.ndarray,
           pred: "FilterPredicate | FilterExpr",
           params: SearchParams = SearchParams(),
           gt_ids: np.ndarray | None = None,
           seed: int = 0) -> tuple[np.ndarray, np.ndarray, SearchStats]:
    """Approximate filtered top-k of q. Returns (ids, sims, stats).

    ``pred`` may be a conjunctive ``FilterPredicate`` or any ``FilterExpr``
    — expressions compile to a bounded DNF (Not/Range lowered against the
    domains observed in the index metadata) and the atlas unions candidate
    clusters/members over the disjuncts."""
    rng = np.random.default_rng(seed)
    if isinstance(pred, FilterExpr):
        pred = as_dnf(pred, index.vocab_sizes())
    passes = pred.mask(index.metadata)
    results: dict[int, float] = {}
    processed: set[int] = set()
    stats = SearchStats()
    for _ in range(params.jump_budget + 1):
        seeds, used = index.atlas.select_anchors(
            q, pred, processed, n_seeds=params.n_seeds, c_max=params.c_max,
            rng=rng, vectors=index.vectors)
        processed.update(used)
        if not seeds:
            break
        ctx = WalkContext(index.vectors, index.graph, q, passes)
        if params.walk == "beam":
            ws = beam_walk(ctx, seeds, beam_width=params.beam_width,
                           max_hops=params.max_hops, k=params.k)
        else:
            ws = guided_walk(ctx, seeds, beam_width=params.beam_width,
                             frontier_width=params.frontier_width,
                             stall_budget=params.stall_budget,
                             max_hops=params.max_hops, k=params.k)
        stats.walks.append(ws)
        stats.n_walks += 1
        stats.hops += ws.hops
        for i, s in ctx.results.items():  # dedupe, keep best similarity
            if s > results.get(i, -np.inf):
                results[i] = s
        if gt_ids is not None:
            ids_now = _topk_ids(results, params.k)
            stats.recall_after_walk.append(recall_at_k(ids_now, gt_ids))
        if len(results) >= params.k:
            break
    for _ in range(params.refine_rounds):
        top = _topk_ids(results, params.k)
        if top.size == 0:
            break
        nbrs = np.unique(index.graph.neighbors[top])
        nbrs = nbrs[nbrs >= 0]
        nbrs = nbrs[passes[nbrs]]
        nbrs = np.asarray([i for i in nbrs if i not in results], dtype=np.int64)
        if nbrs.size == 0:
            break
        sims_n = index.vectors[nbrs] @ q
        for i, sv in zip(nbrs, sims_n):
            results[int(i)] = float(sv)
    stats.n_results = len(results)
    ids = _topk_ids(results, params.k)
    sims = np.asarray([results[int(i)] for i in ids], dtype=np.float32)
    return ids, sims, stats


def _topk_ids(results: dict[int, float], k: int) -> np.ndarray:
    if not results:
        return np.empty(0, dtype=np.int64)
    ids = np.fromiter(results.keys(), dtype=np.int64)
    sims = np.fromiter(results.values(), dtype=np.float32)
    order = np.argsort(-sims)[:k]
    return ids[order]


def run_queries(index: FiberIndex, queries: list[Query],
                params: SearchParams = SearchParams(),
                ) -> tuple[list[np.ndarray], list[SearchStats]]:
    all_ids, all_stats = [], []
    for qi, q in enumerate(queries):
        ids, _, st = search(index, q.vector, q.predicate, params,
                            gt_ids=q.gt_ids, seed=qi)
        all_ids.append(ids)
        all_stats.append(st)
    return all_ids, all_stats
