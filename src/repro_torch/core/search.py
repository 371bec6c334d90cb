"""The index container and the sequential search parameters (the part of
``core/search.py`` the batched engine needs; the sequential ``search`` /
``run_queries`` loop and its walks are not ported yet)."""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from repro_torch.core.atlas import AnchorAtlas
from repro_torch.core.graph import Graph
from repro_torch.core.predicate import derived_vocab_sizes


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
    atlas: AnchorAtlas

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
