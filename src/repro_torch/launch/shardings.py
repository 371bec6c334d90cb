"""Placement of the sharded search index on a device mesh (DESIGN.md §7,
§13).

The reference's ``index_shardings`` returns ``NamedSharding``s: index
leaves partitioned on their leading shard dim over the ``data`` axis, the
query-side inputs partitioned on their leading batch dim over the query
axis (or replicated). The port's mesh is a grid of ``torch.device``s
(``launch/mesh.py``), so the placement is said directly: which cell holds
which row shard for which lane, and which block of the batch a lane
takes. Cells of any other axis (``model`` when it carries no lanes)
would hold replicas that compute the same result; the port runs the
first of them only.

The LM's shardings (``param_/opt_/batch_/cache_shardings``) are not
ported: they belong to the LM's multi-device slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.launch.mesh import index_axis_size


@dataclasses.dataclass(frozen=True)
class IndexShardings:
    """``rows[s, l]`` is the cell that holds row shard s and searches
    lane l's block of the query batch (``query_block``): a shard is
    replicated over the lanes, and lane l's per-shard top-ks merge on its
    lead cell ``rows[0, l]``."""

    rows: np.ndarray   # (S, L) object array of torch.device

    @property
    def n_lanes(self) -> int:
        return self.rows.shape[1]

    def query_block(self, q_n: int, lane: int) -> slice:
        """Lane ``lane``'s contiguous block of a batch of ``q_n`` queries
        (``q_n`` a multiple of the lane count, as ``shard_map`` needs)."""
        if q_n % self.n_lanes:
            raise ValueError(
                f"a batch of {q_n} queries does not split over "
                f"{self.n_lanes} lanes; pad it to a multiple first")
        b = q_n // self.n_lanes
        return slice(lane * b, (lane + 1) * b)


def index_shardings(mesh, axis: str = "data",
                    query_axis: str | None = None) -> IndexShardings:
    """Placement for the sharded search index: every corpus-row-indexed
    tensor of shard s (vectors, adjacency, metadata, global ids, validity
    bitmap, atlas leaves) on the cells at index s of ``axis``; the query
    batch split into blocks over ``query_axis`` when the mesh carries
    one, else replicated, so one lane searches the whole batch."""
    names = mesh.axis_names
    n_shards = index_axis_size(mesh, axis)
    n_lanes = int(mesh.shape[query_axis]) if query_axis is not None else 1
    rows = np.empty((n_shards, n_lanes), dtype=object)
    for s in range(n_shards):
        for lane in range(n_lanes):
            at = [0] * len(names)
            if axis in names:
                at[names.index(axis)] = s
            if query_axis is not None:
                at[names.index(query_axis)] = lane
            rows[s, lane] = mesh.devices[tuple(at)]
    return IndexShardings(rows)
