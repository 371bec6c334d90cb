"""Shared builders for the port-vs-reference parity tests: the disjunctive
and range sweeps of ``test_disjunctive_search.py`` / ``test_range_predicates.py``
(same recipes, same sizes), and the conversions that hand the same index
and queries to both packages."""
import numpy as np
import torch

from repro.core import AnchorAtlas, FiberIndex, build_alpha_knn
from repro.data.ground_truth import attach_ground_truth
from repro.data.synth import (add_or_pair_fields, add_timestamp_field,
                              make_or_queries, make_range_queries,
                              make_selectivity_dataset)
from repro_torch.interop import index_from_reference, queries_from_reference

SWEEP_SELS = (0.5, 0.1, 0.02)


def _index(ds):
    graph = build_alpha_knn(ds.vectors, k=16, r_max=48, alpha=1.2)
    atlas = AnchorAtlas.build(ds, seed=0)
    return FiberIndex(ds.vectors, ds.metadata, graph, atlas)


def build_or_sweep():
    """Two-field OR selectivities ~{0.5, 0.1, 0.02}, 4 queries per level."""
    ds = add_or_pair_fields(
        make_selectivity_dataset(SWEEP_SELS, n=2400, d=48, n_components=16),
        sels=SWEEP_SELS)
    queries = []
    for ci, _ in enumerate(SWEEP_SELS):
        queries.extend(make_or_queries(ds, ci + 1, 4))
    attach_ground_truth(ds, queries, k=10)
    return ds, _index(ds), queries


def build_range_sweep():
    """Timestamp-window selectivities ~{0.5, 0.1, 0.02}, 4 queries each."""
    ds = add_timestamp_field(
        make_selectivity_dataset(SWEEP_SELS, n=2400, d=48, n_components=16))
    queries = []
    for sel in SWEEP_SELS:
        queries.extend(make_range_queries(ds, sel, 4))
    attach_ground_truth(ds, queries, k=10)
    return ds, _index(ds), queries


def port_side(index, queries):
    """The same index and queries as the port's objects."""
    return index_from_reference(index), queries_from_reference(queries)


def to_torch(x) -> torch.Tensor:
    """A reference array (jax or numpy) as a CPU tensor; uint32 bitmap
    words become the port's int32 words with the same bits."""
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(np.array(x, copy=True))
