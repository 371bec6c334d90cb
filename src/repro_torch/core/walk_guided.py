"""Walk strategy 2: drift-guided two-phase navigation (Alg. 4).

Phase 1 (fiber descent): pop the lowest-potential frontier node; while
drift(x) < 0 queue the top-K_f filtered, descending, unexpanded neighbors.
Phase 2 (full-graph beam): standard beam with passive collection. Dynamic
re-entry into Phase 1 requires drift < 0 AND new_filtered > 0 — the fiber
must be actively producing results, not merely theoretically present.
"""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.core.types import WalkStats
from repro_torch.core.walk_common import WalkContext


def _pop_unexpanded(heap: list[tuple[float, int]], ctx: WalkContext) -> int:
    while heap:
        _, x = heapq.heappop(heap)
        if not ctx.expanded[x]:
            return x
    return -1


def _top_b_unexpanded(ids: np.ndarray, ctx: WalkContext, b: int) -> list[tuple[float, int]]:
    ids = np.asarray(ids, dtype=np.int64)
    ids = np.unique(ids[ids >= 0])
    ids = ids[~ctx.expanded[ids]]
    if ids.size == 0:
        return []
    v = ctx.potential(ids)
    order = np.argsort(v)[:b]
    return [(float(v[i]), int(ids[i])) for i in order]


def guided_walk(ctx: WalkContext, seeds: list[int], beam_width: int = 2,
                frontier_width: int = 5, stall_budget: int = 100,
                max_hops: int = 100, k: int = 25) -> WalkStats:
    stats = WalkStats()
    seed_ids = ctx.seed(seeds)
    frontier: list[tuple[float, int]] = [
        (float(v), int(s)) for v, s in zip(ctx.potential(seed_ids), seed_ids)]
    heapq.heapify(frontier)
    beam: list[tuple[float, int]] = []
    discovered: list[int] = list(seed_ids)   # all seen ids (for beam reseeding)
    phase, stall = 1, 0
    last = -1
    while stats.hops < max_hops:
        # --- node selection ---------------------------------------------------
        if phase == 1:
            x = _pop_unexpanded(frontier, ctx)
            if x < 0:  # frontier exhausted -> fall back to full-graph beam
                phase = 2
                beam = _top_b_unexpanded(np.asarray(discovered), ctx, beam_width)
                heapq.heapify(beam)
                if not beam:
                    stats.termination = "converged"
                    break
                continue
        else:
            x = _pop_unexpanded(beam, ctx)
            if x < 0:
                stats.termination = "converged"
                break
            vk = ctx.kth_best_potential(k)
            if float(ctx.potential(np.asarray([x]))[0]) > vk:
                stats.termination = "early_stop"
                break
            if stall >= stall_budget:
                stats.termination = "stall_budget"
                break
        # --- expand -----------------------------------------------------------
        last = x
        nbrs, new, new_filtered = ctx.expand(x)
        discovered.extend(int(y) for y in new)
        stats.hops += 1
        if phase == 1:
            stats.phase1_hops += 1
        else:
            stats.phase2_hops += 1
        # --- fiber diagnostics (paper §3.3) ------------------------------------
        rho, drift, _ = ctx.fiber_stats(x, nbrs)
        stall = 0 if new_filtered > 0 else stall + 1
        # --- phase logic --------------------------------------------------------
        neg_drift = np.isfinite(drift) and drift < 0
        if phase == 1:
            if neg_drift:
                vx = float(ctx.V[x])
                fils = nbrs[ctx.passes[nbrs]]
                fils = fils[~ctx.expanded[fils]]
                vf = ctx.potential(fils)
                desc = fils[vf < vx]
                vd = ctx.V[desc]
                for i in np.argsort(vd)[:frontier_width]:
                    heapq.heappush(frontier, (float(vd[i]), int(desc[i])))
            else:
                phase = 2
                pool = np.concatenate(
                    [nbrs, np.asarray([n for _, n in frontier], dtype=np.int64)])
                beam = _top_b_unexpanded(pool, ctx, beam_width)
                heapq.heapify(beam)
                frontier = []
        else:
            for y in new:
                heapq.heappush(beam, (float(ctx.V[y]), int(y)))
            if len(beam) > beam_width:       # sort & prune to B (Alg. 4 l.46)
                beam = heapq.nsmallest(beam_width, beam)
                heapq.heapify(beam)
            if neg_drift and new_filtered > 0:
                # rebuild frontier from the filtered unexpanded nodes of the
                # beam pool (beam ∪ this expansion's neighborhood — the beam
                # was just seeded from N(x), pre-prune)
                bids = np.concatenate(
                    [np.asarray([n for _, n in beam], dtype=np.int64), nbrs])
                bids = np.unique(bids)
                bids = bids[ctx.passes[bids] & ~ctx.expanded[bids]]
                cand = _top_b_unexpanded(bids, ctx, frontier_width) if bids.size else []
                if cand:
                    frontier = cand
                    heapq.heapify(frontier)
                    phase = 1
                    beam = []
    if stats.termination == "none":
        stats.termination = "max_hops"
    ctx.stall_record(last, stats)
    stats.n_results = len(ctx.results)
    return stats
