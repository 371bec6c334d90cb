"""The paper's own index/search configuration (§6) plus our CPU-scaled
benchmark defaults, as one import point."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FNSConfig:
    # index (paper §6)
    graph_k: int = 64              # alpha-kNN k (mean degree ~128)
    r_max: int = 128
    alpha: float = 1.2
    n_clusters: int | None = None  # None -> ceil(sqrt(n))
    # search (paper §6)
    k: int = 25
    jump_budget: int = 3           # J
    c_max: int = 5
    n_seeds: int = 10
    beam_width_beam: int = 40      # plain beam search B
    beam_width_guided: int = 2     # guided search B
    frontier_width: int = 5        # K_f
    stall_budget: int = 100        # T
    max_hops: int = 100
    # stall-analysis overrides (paper §8.2)
    stall_beam_width: int = 4
    stall_max_hops: int = 500


PAPER = FNSConfig()
# CPU-scaled bench defaults (n=40k corpus): degree scaled with sqrt(n/105k)
BENCH = FNSConfig(graph_k=48, r_max=144)
