"""Walk strategy 1: beam search with passive filtered collection (Alg. 3)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import WalkStats
from repro_torch.core.walk_common import WalkContext


def beam_walk(ctx: WalkContext, seeds: list[int], beam_width: int = 40,
              max_hops: int = 100, k: int = 25) -> WalkStats:
    stats = WalkStats()
    seed_ids = ctx.seed(seeds)
    # candidates kept as (V, id); pruned to top-B by similarity each step
    cand_ids = seed_ids.copy()
    cand_ids = cand_ids[np.argsort(ctx.potential(cand_ids))][:beam_width]
    last = -1
    while stats.hops < max_hops:
        unexp = cand_ids[~ctx.expanded[cand_ids]]
        if unexp.size == 0:
            stats.termination = "converged"
            break
        x = int(unexp[0])  # cand_ids is V-sorted, so first unexpanded is best
        last = x
        nbrs, new, _ = ctx.expand(x)
        stats.hops += 1
        stats.phase2_hops += 1
        if new.size:
            cand_ids = np.concatenate([cand_ids, new])
            cand_ids = cand_ids[np.argsort(ctx.potential(cand_ids),
                                           kind="stable")][:beam_width]
    else:
        pass
    if stats.termination == "none":
        stats.termination = "max_hops"
    ctx.stall_record(last, stats)
    stats.n_results = len(ctx.results)
    return stats
