"""Carry state across from the JAX reference package to the port.

Everything crosses as numpy arrays, read off the reference objects by
attribute (duck typing), so this module imports neither ``jax`` nor the
reference package. Packed bitmaps cross as numpy ``uint32`` views of the
port's int32 words (same bits, see ``core/batched/bitmap.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import predicate as P
from repro_torch.core.atlas import AnchorAtlas
from repro_torch.core.device_atlas import (DeviceAtlas, resolve_device,
                                           words_to_torch)
from repro_torch.core.graph import Graph
from repro_torch.core.search import FiberIndex
from repro_torch.core.types import FilterPredicate, Query


def _np(x, dtype=None) -> np.ndarray:
    return np.array(np.asarray(x), dtype=dtype, copy=True)


def index_from_reference(ref_index) -> FiberIndex:
    """The reference's ``FiberIndex`` (vectors, metadata, graph
    neighbors/degrees, and the ``AnchorAtlas`` fields) as the port's."""
    g, a = ref_index.graph, ref_index.atlas
    graph = Graph(_np(g.neighbors, np.int32), _np(g.degrees, np.int32))
    members = [{f: {v: _np(ids, np.int32) for v, ids in by_v.items()}
                for f, by_v in by_f.items()} for by_f in a.members]
    cluster_index = [{v: _np(cs, np.int32) for v, cs in by_v.items()}
                     for by_v in a.cluster_index]
    atlas = AnchorAtlas(_np(a.centroids), _np(a.assign, np.int32), members,
                        cluster_index)
    return FiberIndex(_np(ref_index.vectors), _np(ref_index.metadata),
                      graph, atlas)


def device_atlas_from_reference(ref_datlas, device=None) -> DeviceAtlas:
    """The reference's ``DeviceAtlas`` leaves (via ``np.asarray``) as the
    port's ``DeviceAtlas`` on ``device`` (None means CUDA)."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.from_numpy(_np(x)).to(device=dev, dtype=dtype)

    return DeviceAtlas(
        t(ref_datlas.centroids, torch.float32),
        t(ref_datlas.assign, torch.int64), t(ref_datlas.csr_pts, torch.int64),
        t(ref_datlas.csr_offsets, torch.int64),
        t(ref_datlas.inv_perm, torch.int64),
        bitmap_to_torch(ref_datlas.presence, dev),
        t(ref_datlas.code_min, torch.int32),
        t(ref_datlas.code_max, torch.int32), v_cap=int(ref_datlas.v_cap))


def bitmap_to_torch(words, device=None) -> torch.Tensor:
    """uint32 words (the reference's bitmaps) -> the port's int32 words."""
    return words_to_torch(np.asarray(words), resolve_device(device))


def bitmap_to_numpy(bm: torch.Tensor) -> np.ndarray:
    """The port's int32 words -> the reference's uint32 bitmap layout."""
    return bm.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def predicate_from_reference(pred):
    """A reference predicate (``FilterPredicate``, a ``FilterExpr`` tree or
    a compiled ``DNF``) rebuilt from the port's classes of the same name."""
    kind = type(pred).__name__
    if kind == "FilterPredicate":
        return FilterPredicate(tuple((int(f), tuple(int(v) for v in vals))
                                     for f, vals in pred.clauses))
    if kind == "In":
        return P.In(pred.field, pred.values)
    if kind == "Range":
        return P.Range(pred.field, pred.lo, pred.hi)
    if kind in ("And", "Or"):
        return getattr(P, kind)(*(predicate_from_reference(c)
                                  for c in pred.children))
    if kind == "Not":
        return P.Not(predicate_from_reference(pred.child))
    if kind == "DNF":
        def spec(s):
            if type(s).__name__ == "Interval":
                return P.Interval(int(s.lo), int(s.hi))
            return tuple(int(v) for v in s)
        return P.DNF(tuple(tuple((int(f), spec(s)) for f, s in clauses)
                           for clauses in pred.disjuncts))
    raise TypeError(f"cannot carry a {kind} predicate across")


def queries_from_reference(queries) -> list[Query]:
    """Reference ``Query`` objects as the port's (vector, predicate, ground
    truth and selectivity copied)."""
    return [Query(vector=_np(q.vector, np.float32),
                  predicate=predicate_from_reference(q.predicate),
                  gt_ids=None if q.gt_ids is None else _np(q.gt_ids),
                  gt_sims=None if q.gt_sims is None else _np(q.gt_sims),
                  selectivity=q.selectivity) for q in queries]
