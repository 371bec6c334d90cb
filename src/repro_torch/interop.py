"""Carry state across from the JAX reference package to the port, and
LM training state (parameters, AdamW state) back.

Everything crosses as numpy arrays, read off the reference objects by
attribute or key (duck typing), so this module imports neither ``jax``
nor the reference package. Packed bitmaps cross as numpy ``uint32`` views of the
port's int32 words (same bits, see ``core/batched/bitmap.py``).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core import predicate as P
from repro_torch.core.atlas import AnchorAtlas
from repro_torch.core.batched.insert import (HostAtlas, InsertParams,
                                             InsertState, ShardState)
from repro_torch.core.batched.sharded import ShardedIndex
from repro_torch.core.device_atlas import (DeviceAtlas, resolve_device,
                                           words_to_torch)
from repro_torch.core.graph import Graph
from repro_torch.core.search import FiberIndex
from repro_torch.core.types import FilterPredicate, Query
from repro_torch.launch.placement import Sharded, gather, place, place_tree
from repro_torch.launch.shardings import layer_sharding

if TYPE_CHECKING:
    from repro_torch.models.transformer import Transformer


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


def insert_state_from_reference(ref_state) -> InsertState:
    """The reference's live-index ``InsertState`` (its capacity slabs,
    host atlases, backlog and counters, all numpy) as the port's, sharing
    no memory with it — what ``BatchedEngine.from_state`` takes."""
    def shard(sh):
        a = sh.atlas
        atlas = HostAtlas(_np(a.centroids, np.float32),
                          _np(a.assign, np.int32),
                          _np(a.base_counts, np.int64),
                          _np(a.base_centroids, np.float32),
                          reclusters=int(a.reclusters))
        return ShardState(_np(sh.vectors, np.float32),
                          _np(sh.adjacency, np.int32),
                          _np(sh.metadata, np.int32),
                          _np(sh.global_ids, np.int32), int(sh.n_valid),
                          atlas, live=_np(sh.live, bool))

    p = ref_state.params
    return InsertState(
        shards=[shard(sh) for sh in ref_state.shards],
        v_cap=int(ref_state.v_cap), graph_k=int(ref_state.graph_k),
        alpha=float(ref_state.alpha), seed=int(ref_state.seed),
        next_gid=int(ref_state.next_gid),
        params=InsertParams(float(p.recluster_occupancy),
                            float(p.recluster_drift), int(p.kmeans_iters)),
        inserted=int(ref_state.inserted), batches=int(ref_state.batches),
        repairs=int(ref_state.repairs),
        applied_seq=int(ref_state.applied_seq),
        deleted=int(ref_state.deleted),
        compactions=int(ref_state.compactions), grown=int(ref_state.grown),
        pending=[tuple(int(x) for x in e) for e in ref_state.pending])


def sharded_index_from_reference(ref_sidx, device=None) -> ShardedIndex:
    """The reference's ``ShardedIndex`` (stacked arrays, stacked atlas
    leaves, and the host ``InsertState`` where it has one) as the port's,
    on ``device`` (None means CUDA), sharing no memory with it."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.from_numpy(_np(x)).to(device=dev, dtype=dtype)

    st = ref_sidx.insert_state
    return ShardedIndex(
        vectors=t(ref_sidx.vectors, torch.float32),
        adjacency=t(ref_sidx.adjacency, torch.int32),
        metadata=t(ref_sidx.metadata, torch.int32),
        global_ids=t(ref_sidx.global_ids, torch.int32),
        valid_bm=bitmap_to_torch(ref_sidx.valid_bm, dev),
        datlas=device_atlas_from_reference(ref_sidx.datlas, dev),
        n=int(ref_sidx.n),
        vocab_sizes=(None if ref_sidx.vocab_sizes is None
                     else tuple(int(v) for v in ref_sidx.vocab_sizes)),
        insert_state=None if st is None else insert_state_from_reference(st))


def _port_tree(ref_tree, cfg, dev) -> dict:
    """A reference LM tree (params, or an AdamW moment of them) in the
    port's layout on ``dev``: ``layers`` and ``enc_layers`` as lists of
    per-layer dicts, layer l holding slice l of every stacked leaf."""
    counts = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers}

    def t(x):
        return torch.from_numpy(_np(x, np.float32)).to(dev)

    def layer(tree, li):
        return {k: layer(v, li) if isinstance(v, dict) else t(_np(v)[li])
                for k, v in tree.items()}

    return {k: ([layer(v, li) for li in range(counts[k])] if k in counts
                else t(v)) for k, v in ref_tree.items()}


def params_from_reference(ref_params, cfg, device=None) -> Transformer:
    """The reference's LM parameter pytree (leaves stacked under a
    leading L dim in ``layers``, and in ``enc_layers`` for an
    encoder-decoder) as the port's ``Transformer`` for ``cfg``, fp32 on
    ``device`` (None means CUDA): layer l of the port holds slice l of
    every stacked leaf."""
    # here, not at the top: the search-side state above needs no LM
    from repro_torch.models.transformer import Transformer
    return Transformer(cfg, _port_tree(ref_params, cfg,
                                       resolve_device(device)))


def opt_state_from_reference(ref_opt, cfg, device=None,
                             shardings=None) -> dict:
    """The reference's AdamW state ({"m", "v"} in its parameter layout,
    an int32 "step") as the port's, on ``device`` (None means CUDA); with
    ``shardings`` (the port's layout of ``launch.shardings.
    opt_shardings``, as ``init_opt_state`` of placed parameters takes
    it), placed on their mesh instead."""
    dev = torch.device("cpu") if shardings is not None else \
        resolve_device(device)
    out = {"m": _port_tree(ref_opt["m"], cfg, dev),
           "v": _port_tree(ref_opt["v"], cfg, dev),
           "step": torch.tensor(int(np.asarray(ref_opt["step"])),
                                dtype=torch.int32, device=dev)}
    return out if shardings is None else place_tree(out, shardings)


def _tree_of(node):
    """A ``Transformer``'s or ``MeshParams``' tree; any other node as it
    is."""
    return node.tree() if hasattr(node, "with_tree") else node


def _host(x) -> np.ndarray:
    if isinstance(x, Sharded):
        x = gather(x, "cpu")
    return x.detach().cpu().numpy()


def _reference_layout(node, leaf, stack):
    """``node`` (a port tree; a module or ``MeshParams`` read through its
    ``tree()``) in the reference's layout: each list of per-layer trees
    stacked leaf by leaf under a leading L (``stack``), every other leaf
    through ``leaf``."""
    node = _tree_of(node)
    if isinstance(node, dict):
        return {k: _reference_layout(v, leaf, stack) for k, v in node.items()}
    if isinstance(node, list):
        return _stack_trees([_reference_layout(x, leaf, stack)
                             for x in node], stack)
    return leaf(node)


def _stack_trees(parts: list, stack):
    if isinstance(parts[0], dict):
        return {k: _stack_trees([p[k] for p in parts], stack)
                for k in parts[0]}
    return stack(parts)


def tree_to_reference(tree) -> dict:
    """A port tree (a ``Transformer`` or ``MeshParams``, AdamW state, or
    a dict holding them; placed leaves gathered) as the reference's
    pytree layout of host numpy arrays: the layer lists stacked under L.
    What ``params_from_reference``, ``opt_state_from_reference`` and
    ``tree_from_reference`` undo, and what the training checkpoints hold
    (and what the reference's passes and optimizer take)."""
    return _reference_layout(tree, _host, np.stack)


def reference_shapes(tree) -> dict:
    """``tree_to_reference``'s structure with each leaf a ``meta`` tensor
    of its shape and dtype (no copy, no memory): a ``like`` for
    ``checkpoint.ckpt.restore``."""
    def leaf(x):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")

    def stack(xs):
        return torch.empty((len(xs),) + tuple(xs[0].shape),
                           dtype=xs[0].dtype, device="meta")

    return _reference_layout(tree, leaf, stack)


def tree_from_reference(ref_tree, like, device=None, shardings=None):
    """A tree in the reference's layout (host arrays, e.g. a restored
    checkpoint) as a port tree shaped like ``like`` (a new ``Transformer``
    or ``MeshParams`` where ``like`` holds one), each leaf a tensor on
    ``device`` (None means CUDA) with the reference's dtype, or placed as
    ``like``'s leaf is where that is ``Sharded``. ``shardings``: a tree
    of ``NamedSharding``s in the reference's layout (its ``param_`` and
    ``opt_shardings``, stacked leaves under L), which places every leaf
    instead, each layer of a stacked leaf by ``layer_sharding``; placed
    parameters then stay on their mesh and policy (``like``'s)."""
    return _from_reference(ref_tree, like, device, shardings)


def _from_reference(ref, node, device, where):
    """``tree_from_reference``'s recursion, at module level: a
    self-recursive closure is a reference cycle, and the tensors it made
    would wait for the garbage collector."""
    if hasattr(node, "with_tree"):
        mesh = getattr(getattr(node, "env", None), "mesh", None)
        if where is not None and _mesh_of(where) is not mesh:
            raise ValueError("tree_from_reference: the parameters are not "
                             "placed on the shardings' mesh")
        return node.with_tree(_from_reference(ref, node.tree(), device,
                                              where))
    if isinstance(node, dict):
        return {k: _from_reference(ref[k], v, device,
                                   None if where is None else where[k])
                for k, v in node.items()}
    if isinstance(node, list):
        return [_from_reference(_slice(ref, li), x, device,
                                None if where is None else
                                _layer_of(where, li, len(node)))
                for li, x in enumerate(node)]
    arr = torch.from_numpy(_np(ref))
    if where is None and isinstance(node, Sharded):
        where = node.sharding
    return arr.to(resolve_device(device)) if where is None else \
        place(arr, where)


def _mesh_of(where):
    while isinstance(where, dict):
        where = next(iter(where.values()))
    return where.mesh


def _layer_of(where, li: int, layers: int):
    if isinstance(where, dict):
        return {k: _layer_of(v, li, layers) for k, v in where.items()}
    return layer_sharding(where, li, layers)


def _slice(ref, li):
    if isinstance(ref, dict):
        return {k: _slice(v, li) for k, v in ref.items()}
    return np.asarray(ref)[li]
