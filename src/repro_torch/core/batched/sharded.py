"""Sharded filtered search over a row-partitioned index (DESIGN.md §7,
§13).

The reference's ``ShardedEngine`` partitions the corpus row-wise into S
contiguous shards (vectors, metadata, a shard-local α-kNN subgraph, a
per-shard ``DeviceAtlas`` and packed row-validity bitmaps for the pad
rows), runs the same fused ``search_batch`` on every shard, maps each
shard's local top-k to global ids and merges them exactly. It runs in two
modes, and so does the port:

* **reference mode** (``mesh=None``): the shards one after another on one
  device, with the identical merge. That is how an S-shard snapshot
  restores onto a machine with fewer than S devices, with zero rebuild
  and unchanged results.
* **mesh mode** (a ``launch.mesh.Mesh``): shard s lives on the cells at
  index s of the mesh's ``data`` axis. On a 2D mesh the batch is split
  into lane blocks over the query axis, and each lane's cells search its
  block. The reference's ``all_gather`` over ``data`` becomes a copy of
  each shard's top-k to the lane's lead cell, in shard order, then the
  same merge; its ``psum`` of hops and walks becomes a sum. One process
  drives every cell, one after another.

The merge is exact: every point lives on exactly one shard and its
distance is a pure function of (q, point), so the k smallest of the union
of per-shard top-ks is the top-k of the union of the per-shard results.
Per-query search state is row-independent, and the batch-level loop
exits only skip rounds that change nothing, so a lane's block gives its
rows the results the whole batch would.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.atlas import AnchorAtlas
from repro_torch.core.batched.bitmap import pack_bits
from repro_torch.core.batched.engine import (_fence_pack, _place,
                                             fetch_results, pack_query_batch,
                                             search_batch)
from repro_torch.core.batched.insert import (InsertState, emit_device_atlas,
                                             insert_rows, make_shard_state)
from repro_torch.core.config import FnsConfig, coerce_config
from repro_torch.core.device_atlas import (DeviceAtlas, auto_v_cap,
                                           resolve_device, stack_atlases)
from repro_torch.core.graph import build_shard_graphs
from repro_torch.core.predicate import FilterExpr, derived_vocab_sizes
from repro_torch.core.types import Dataset, Query
from repro_torch.launch.mesh import (index_axis_size, lead_device,
                                     query_axis_name)
from repro_torch.launch.shardings import index_shardings


@dataclasses.dataclass
class ShardedIndex:
    """Device-ready row partition of a filtered-ANN corpus.

    Every tensor carries a leading shard dim S and lives on one device;
    shard s owns a balanced contiguous row block (``graph.shard_bounds``)
    padded to the common row count m = ceil(n/S) (ceil(capacity/S) with
    append room). Adjacency and atlas ids are shard-LOCAL;
    ``global_ids`` maps them back (-1 = pad).
    """

    vectors: torch.Tensor      # (S, m, d) f32, zero on pad rows
    adjacency: torch.Tensor    # (S, m, R) i32 shard-local ids, -1 padded
    metadata: torch.Tensor     # (S, m, F) i32, -1 on pad rows
    global_ids: torch.Tensor   # (S, m) i32 local row -> global id, -1 = pad
    valid_bm: torch.Tensor     # (S, ceil(m/32)) i32 packed row-validity
    datlas: DeviceAtlas        # per-shard atlases, leaves stacked to (S, ...)
    n: int                     # real (unpadded) corpus size
    # per-field domains for FilterExpr Not/Range lowering
    vocab_sizes: tuple[int, ...] | None = None
    # host mirror for the append path: attached only when the build
    # reserved ``capacity``; None = build-once index, insert_batch raises
    insert_state: InsertState | None = None

    @property
    def n_shards(self) -> int:
        return self.vectors.shape[0]

    @property
    def rows_per_shard(self) -> int:
        return self.vectors.shape[1]


def _stack_slabs(slabs, v_cap: int, device) -> dict:
    """The device tensors of a list of shard slabs, stacked on ``device``."""
    return dict(
        vectors=_place(np.stack([sl.vectors for sl in slabs]), device),
        adjacency=_place(np.stack([sl.adjacency for sl in slabs]), device),
        metadata=_place(np.stack([sl.metadata for sl in slabs]), device),
        global_ids=_place(np.stack([sl.global_ids for sl in slabs]), device),
        valid_bm=pack_bits(_place(np.stack([sl.valid for sl in slabs]),
                                  device)),
        datlas=stack_atlases([emit_device_atlas(sl, v_cap, device)
                              for sl in slabs]))


def build_sharded_index(vectors: np.ndarray, metadata: np.ndarray,
                        n_shards: int, *, config: FnsConfig | None = None,
                        device=None) -> ShardedIndex:
    """Partition a corpus into ``n_shards`` row blocks and build each
    shard's subgraph + atlas on the host, then place the stacked tensors
    on ``device`` (None means CUDA). All shards share one n_clusters and
    one v_cap (the atlas leaves stack to fixed shapes), and every shard is
    padded to m rows; pad rows are killed by the row-validity bitmap,
    never by luck of the predicate.

    ``serve.capacity`` reserves append room: m becomes
    ceil(capacity / S) and the spare rows are capacity-slab slots that
    ``ShardedEngine.insert_batch`` fills later. Without it,
    m = ceil(n / S) and inserts fail on capacity.

    Every knob comes from ``config`` (one ``FnsConfig``; the reference's
    loose keyword shims, deprecated there, are not carried over)."""
    device = resolve_device(device)
    cfg = coerce_config(config, {}, where="build_sharded_index")
    graph_k, alpha = cfg.graph.graph_k, cfg.graph.alpha
    n_clusters, v_cap = cfg.atlas.n_clusters, cfg.atlas.v_cap
    seed, capacity = cfg.atlas.kmeans_seed, cfg.serve.capacity
    vectors = np.asarray(vectors, np.float32)
    metadata = np.asarray(metadata, np.int32)
    n = vectors.shape[0]
    f_count = metadata.shape[1]
    if capacity is not None and capacity < n:
        raise ValueError(f"capacity {capacity} < corpus size {n}")
    graphs, bounds = build_shard_graphs(vectors, n_shards, k=graph_k,
                                        r_max=cfg.graph.r_max, alpha=alpha,
                                        block=cfg.graph.build_block)
    m = -(-max(n, capacity or 0) // n_shards)
    min_real = min(hi - lo for lo, hi in bounds)
    if n_clusters is None:
        n_clusters = int(np.ceil(np.sqrt(m)))
    n_clusters = min(n_clusters, min_real)
    if v_cap is None:
        vmax = int(metadata.max()) if metadata.size else -1
        v_cap = auto_v_cap(vmax)

    # one adjacency width across shards, with room for the forward edges
    # appended rows request later (1.5x graph_k, see insert.insert_rows)
    r = max(max(g.r_pad for g in graphs), graph_k + graph_k // 2)
    field_names = [f"f{i}" for i in range(f_count)]
    slabs = []
    for s, (lo, hi) in enumerate(bounds):
        ds_s = Dataset(vectors[lo:hi], metadata[lo:hi], field_names,
                       [v_cap] * f_count)
        atlas = AnchorAtlas.build(ds_s, n_clusters=n_clusters, seed=seed)
        adj_s = np.full((hi - lo, r), -1, np.int32)
        adj_s[:, : graphs[s].r_pad] = graphs[s].neighbors
        slabs.append(make_shard_state(
            vectors[lo:hi], metadata[lo:hi],
            np.arange(lo, hi, dtype=np.int32), adj_s, atlas, cap=m))
    # the insert state only exists when append room was reserved: a
    # build-once index must REFUSE inserts rather than silently absorb a
    # few rows into its ceil(n/S) padding slack
    istate = (InsertState(shards=slabs, v_cap=v_cap, graph_k=graph_k,
                          alpha=alpha, seed=seed, next_gid=n)
              if capacity is not None else None)
    return ShardedIndex(**_stack_slabs(slabs, v_cap, device), n=n,
                        vocab_sizes=derived_vocab_sizes(metadata),
                        insert_state=istate)


def index_from_state(state: InsertState, vocab_sizes=None,
                     device=None) -> ShardedIndex:
    """Re-stack a device-ready ``ShardedIndex`` on ``device`` (None means
    CUDA) from a (restored) host ``InsertState`` with ZERO graph/atlas
    rebuild: the slabs already carry the patched adjacency and
    incremental atlases, so the device tables are re-*emitted* at the same
    fixed shapes. The state object is attached, so ingest continues where
    the snapshot left off."""
    return ShardedIndex(**_stack_slabs(state.shards, state.v_cap,
                                       resolve_device(device)),
                        n=state.next_gid, vocab_sizes=vocab_sizes,
                        insert_state=state)


def merge_topk(all_v: torch.Tensor, all_i: torch.Tensor, k: int):
    """Exact cross-shard merge: (S, Q, k) per-shard top-ks -> (Q, k)
    global top-k, the k smallest values. Ids are globally unique (a point
    lives on one shard), so no dedup is needed. Ties break shard-major,
    the lowest flattened index first, as the reference's ``lax.top_k``
    does: a stable ascending sort (``torch.topk`` breaks ties in no fixed
    order)."""
    s, q_n, k_in = all_v.shape
    cat_v = all_v.permute(1, 0, 2).reshape(q_n, s * k_in)
    cat_i = all_i.permute(1, 0, 2).reshape(q_n, s * k_in)
    vals, sel = torch.sort(cat_v, dim=1, stable=True)
    return vals[:, :k], torch.gather(cat_i, 1, sel[:, :k])


class _Shard(NamedTuple):
    """One row shard's device tensors, as one cell holds them."""

    vectors: torch.Tensor      # (m, d)
    adjacency: torch.Tensor    # (m, R)
    metadata: torch.Tensor     # (m, F)
    global_ids: torch.Tensor   # (m,)
    valid_bm: torch.Tensor     # (ceil(m/32),)
    datlas: DeviceAtlas

    def to(self, device) -> "_Shard":
        """The shard on ``device``: the same tensors where they already
        live there, so cells that share a device share one copy."""
        return _Shard(*(t.to(device) for t in self[:5]),
                      DeviceAtlas(*(t.to(device)
                                    for t in self.datlas.leaves()),
                                  v_cap=self.datlas.v_cap))


class ShardedEngine:
    """Filtered search over a row-sharded index, in reference mode
    (``mesh=None``: every shard on ``device``) or on a ``Mesh`` (shard s
    on the cells at index s of its ``data`` axis).

    ``search`` runs the fused per-shard ``search_batch`` for each shard,
    maps local result ids to global ids and merges the per-shard top-ks
    exactly (``merge_topk``). On a mesh whose query axis (from
    ``cfg.mesh.query_axes``, ``model`` reused when there is no ``query``
    axis; none when ``cfg.mesh.query_parallel`` is off) spans
    ``q_lanes`` > 1 cells, the batch is padded to a multiple of
    ``q_lanes`` with inert queries and split into lane blocks, each
    searched against every shard on its own cells and merged on its lead
    cell. ``dispatches`` counts one a batch on a mesh and ``n_shards`` a
    batch in reference mode, as the reference counts its programs.

    ``device`` None means CUDA and raises without it; it must stay None
    when a mesh is given, since the mesh places every shard (and the
    queries are packed on the first cell). A mesh whose ``data`` axis is
    not the index's shard count raises ``ValueError``; any object but a
    ``Mesh`` raises ``TypeError``.

    ``dispatch``/``collect`` keep the reference's token contract: a
    fenced pack + the search, then the results' one device-to-host copy.
    The search's loop exits are read on the host, so ``dispatch`` returns
    once the batch is searched.
    """

    def __init__(self, sindex: ShardedIndex, mesh=None, config=None,
                 seed_backend: str | None = None, device=None):
        s = sindex.n_shards
        self.device = lead_device(mesh, device)
        if mesh is not None and index_axis_size(mesh) != s:
            raise ValueError(
                f"index has {s} shards but mesh axis 'data' spans "
                f"{index_axis_size(mesh)} devices")
        cfg = coerce_config(config, {}, where="ShardedEngine")
        if seed_backend is not None:
            cfg = cfg.with_knobs({"serve.seed_backend": seed_backend})
        self.cfg = cfg
        self.mesh, self.p = mesh, cfg.walk
        self._seed_backend = cfg.serve.seed_backend
        self._istate = sindex.insert_state
        self.v_cap = sindex.datlas.v_cap
        self.vocab_sizes = sindex.vocab_sizes
        self.n, self.n_shards = sindex.n, s
        # 2D query×data layout (DESIGN.md §13): a second mesh axis of size
        # > 1 from cfg.mesh.query_axes splits the batch into q_lanes
        # blocks, each walked against every data shard
        self.q_axis = (query_axis_name(mesh, cfg.mesh.query_axes)
                       if mesh is not None and cfg.mesh.query_parallel
                       else None)
        self.q_lanes = (int(mesh.shape[self.q_axis])
                        if self.q_axis is not None else 1)
        if mesh is None:
            self._sh = None
            dev = self.device
            self.vectors = sindex.vectors.to(dev)
            self.adjacency = sindex.adjacency.to(dev)
            self.metadata = sindex.metadata.to(dev)
            self.global_ids = sindex.global_ids.to(dev)
            self.valid_bm = sindex.valid_bm.to(dev)
            self.datlas = DeviceAtlas(
                *(t.to(dev) for t in sindex.datlas.leaves()),
                v_cap=sindex.datlas.v_cap)
        else:
            self._sh = index_shardings(mesh, query_axis=self.q_axis)
            # per-shard cells (S, q_lanes); the stacked tensors of
            # reference mode are not kept
            self._cells = [self._on_cells(
                r, _Shard(sindex.vectors[r], sindex.adjacency[r],
                          sindex.metadata[r], sindex.global_ids[r],
                          sindex.valid_bm[r], sindex.datlas.shard(r)))
                for r in range(s)]
        # host stacks + per-shard emitted atlases (reference mode), made
        # at the first publish so later ones re-emit only the shards they
        # touched
        self._host: dict | None = None
        self._shard_atlases: list[DeviceAtlas | None] = []
        self.dispatches = 0
        self.publish_generation = 0
        self.fence_retries = 0

    def _on_cells(self, s: int, shard: _Shard) -> list[_Shard]:
        """Shard ``s`` on each of its cells, one per lane."""
        return [shard.to(dev) for dev in self._sh.rows[s]]

    def _cell(self, s: int, lane: int = 0) -> _Shard:
        """Shard ``s`` as lane ``lane`` searches it: its cell on a mesh,
        views into the stacked tensors in reference mode."""
        if self.mesh is not None:
            return self._cells[s][lane]
        return _Shard(self.vectors[s], self.adjacency[s], self.metadata[s],
                      self.global_ids[s], self.valid_bm[s],
                      self.datlas.shard(s))

    # -- live index -----------------------------------------------------------
    def insert_batch(self, vectors: np.ndarray, metadata: np.ndarray, *,
                     gids: np.ndarray | None = None) -> np.ndarray:
        """Append (vector, metadata) rows to the live index: balance-aware
        shard placement, slab writes + validity-bit flips, reverse-edge
        graph repair and incremental atlas updates on the host mirror,
        then the touched shards are published with the same shapes (see
        ``_refresh_device_index``). Returns the new rows' global ids.
        ``dispatches`` is untouched."""
        if self._istate is None:
            raise ValueError(
                "index has no insert state; build it with serve.capacity "
                "set to reserve append room")
        from repro_torch.core.batched.lifecycle import ensure_capacity

        st, mcfg = self._istate, self.cfg.maintenance
        room = ensure_capacity(st, np.asarray(vectors).shape[0], mcfg)
        if room["grown"]:
            # keep the shape-baked knob truthful for snapshot/restore
            self.cfg = self.cfg.with_knobs(
                {"serve.capacity": room["new_cap"] * len(st.shards)})
        gids, touched = insert_rows(st, vectors, metadata, gids=gids,
                                    defer_repair=mcfg.defer_repair)
        if room["compacted"] or room["grown"]:
            self.refresh_device()  # rows moved / shapes changed: full
        else:
            self._refresh_device_index(touched)
        return gids

    def delete_batch(self, gids) -> int:
        """Tombstone documents by global id: clear their bits on the host
        mirror and re-place the packed validity bitmap (on a mesh, only
        the touched shards', on their cells) — the single liveness source
        the search reads — so a delete costs one bit-pack + transfer, with
        no graph or atlas work. Returns the number of rows tombstoned."""
        if self._istate is None:
            raise ValueError(
                "index has no insert state; deletes need a capacity-slab "
                "index (built with serve.capacity set)")
        from repro_torch.core.batched.lifecycle import delete_rows

        st = self._istate
        n, touched = delete_rows(st, gids)
        if self.mesh is not None:
            for s in touched:
                bm = pack_bits(_place(st.shards[s].valid,
                                      self._sh.rows[s, 0]))
                self._cells[s] = [c._replace(valid_bm=bm.to(dev)) for c, dev
                                  in zip(self._cells[s], self._sh.rows[s])]
            self.publish_generation += 1
            return n
        if self._host is not None:
            for s in touched:
                self._host["valid"][s] = st.shards[s].valid
            valid = self._host["valid"]
        else:
            valid = np.stack([sl.valid for sl in st.shards])
        self.valid_bm = pack_bits(_place(valid, self.device))
        self.publish_generation += 1
        return n

    def refresh_device(self, touched: list[int] | None = None) -> None:
        """Publish the host mirror after host-side maintenance
        (compaction, growth, deferred repair) — the hook
        ``MaintenanceLoop`` publishes through. ``touched=None`` refreshes
        every shard; slab growth drops the stacked host cache (reference
        mode) so the new shapes propagate."""
        st = self._istate
        if st is None:
            return
        if (self._host is not None
                and self._host["vectors"].shape[1] != st.shards[0].cap):
            self._host = None  # stale stacked shapes after grow_state
            touched = None
        if touched is None:
            touched = list(range(len(st.shards)))
        self._refresh_device_index(touched)

    @property
    def state(self):
        """The host ``InsertState`` mirror (None on a build-once index) —
        what the lifecycle/maintenance subsystem mutates."""
        return self._istate

    def _refresh_device_index(self, touched: list[int]) -> None:
        """Publish. On a mesh: each touched shard is placed anew on its own
        cells. In reference mode: the touched shards are written into the
        host stacks, their atlases re-emitted, and every stacked tensor
        re-placed on the device (the whole stack, as the reference
        re-places it)."""
        st, dev = self._istate, self.device
        if self.mesh is not None:
            for s in touched:
                sl, at = st.shards[s], self._sh.rows[s, 0]
                self._cells[s] = self._on_cells(s, _Shard(
                    _place(sl.vectors, at), _place(sl.adjacency, at),
                    _place(sl.metadata, at), _place(sl.global_ids, at),
                    pack_bits(_place(sl.valid, at)),
                    emit_device_atlas(sl, self.v_cap, at)))
            self._published(st)
            return
        if self._host is None:
            self._host = {
                name: np.stack([getattr(sl, name) for sl in st.shards])
                for name in ("vectors", "adjacency", "metadata",
                             "global_ids", "valid")}
            self._shard_atlases = [
                None if s in touched else emit_device_atlas(sl, self.v_cap,
                                                            dev)
                for s, sl in enumerate(st.shards)]
        for s in touched:
            sl = st.shards[s]
            for name in ("vectors", "adjacency", "metadata", "global_ids",
                         "valid"):
                self._host[name][s] = getattr(sl, name)
            self._shard_atlases[s] = emit_device_atlas(sl, self.v_cap, dev)
        self.vectors = _place(self._host["vectors"], dev)
        self.adjacency = _place(self._host["adjacency"], dev)
        self.metadata = _place(self._host["metadata"], dev)
        self.global_ids = _place(self._host["global_ids"], dev)
        self.valid_bm = pack_bits(_place(self._host["valid"], dev))
        self.datlas = stack_atlases(self._shard_atlases)
        self._published(st)

    def _published(self, st: InsertState) -> None:
        self.n = st.next_gid
        self.vocab_sizes = st.expand_vocab(self.vocab_sizes)
        self.publish_generation += 1

    @property
    def insert_stats(self) -> dict | None:
        """Ingest/staleness accounting, or None on a build-once index."""
        return self._istate.stats() if self._istate is not None else None

    # -- search ---------------------------------------------------------------
    def _pack_queries(self, queries: list[Query]):
        return pack_query_batch(queries, v_cap=self.v_cap,
                                vocab_sizes=self.vocab_sizes,
                                device=self.device)

    def _pad_to_lanes(self, queries: list[Query]) -> list[Query]:
        """Pad the batch to a multiple of ``q_lanes`` so it splits into
        equal lane blocks. Pads are inert — ``FilterExpr.never()`` admits
        no point, so they never seed — and carry a unit basis vector: a
        zero vector would go NaN under cosine normalization."""
        rem = len(queries) % self.q_lanes
        if self.q_lanes == 1 or rem == 0:
            return queries
        basis = np.zeros(np.asarray(queries[0].vector).shape, np.float32)
        basis[0] = 1.0
        dummy = Query(vector=basis, predicate=FilterExpr.never())
        return list(queries) + [dummy] * (self.q_lanes - rem)

    def _run(self, packed, lanes: int) -> dict:
        """The program behind ``dispatch`` and ``search_reference``: for
        each of ``lanes`` blocks of the packed batch, the fused per-shard
        searches in shard order on the lane's cells, local ids mapped
        through ``global_ids`` (-1 kept), the per-shard top-ks copied to
        the lane's lead cell and merged there; then the lanes' results
        concatenated on ``self.device``. Hops and walks sum over shards,
        syncs over every search; ``rounds`` (a device scalar) is the most
        restart rounds any search ran."""
        q_n = packed[0].shape[0]
        out_v, out_i, out_h, out_w = [], [], [], []
        syncs = 0
        rounds = torch.zeros((), dtype=torch.int32, device=self.device)
        for lane in range(lanes):
            rows = (self._sh.query_block(q_n, lane) if lanes > 1
                    else slice(None))
            lead = self._cell(0, lane).vectors.device
            per_v, per_i = [], []
            hops = walks = 0
            for s in range(self.n_shards):
                c = self._cell(s, lane)
                q_vecs, fields, allowed, bounds = (
                    None if x is None else x[rows].to(c.vectors.device)
                    for x in packed)
                out = search_batch(c.datlas, c.vectors, c.adjacency,
                                   c.metadata, q_vecs, fields, allowed,
                                   self.p, self._seed_backend,
                                   valid_bm=c.valid_bm, bounds=bounds)
                res_i = out["res_i"]
                gids = c.global_ids[res_i.clamp(min=0).long()]
                per_v.append(out["res_v"].to(lead))
                per_i.append(torch.where(res_i >= 0, gids, -1).to(lead))
                hops = hops + out["hops"].to(lead)
                walks = walks + out["walks"].to(lead)
                syncs += out["syncs"]
                rounds = torch.maximum(rounds, out["rounds"].to(self.device))
            res_v, res_i = merge_topk(torch.stack(per_v),
                                      torch.stack(per_i), self.p.k)
            out_v.append(res_v.to(self.device))
            out_i.append(res_i.to(self.device))
            out_h.append(hops.to(self.device))
            out_w.append(walks.to(self.device))
        return dict(res_v=torch.cat(out_v), res_i=torch.cat(out_i),
                    hops=torch.cat(out_h), walks=torch.cat(out_w),
                    syncs=syncs, rounds=rounds)

    def dispatch(self, queries: list[Query], seed: int = 0) -> dict:
        """Fenced pack + the search; returns a token for ``collect``. On a
        mesh the batch is padded to the lanes and counts one dispatch; in
        reference mode it counts ``n_shards``."""
        del seed
        q_n = len(queries)
        packed, gen = _fence_pack(self, self._pad_to_lanes(queries))
        if self.mesh is None:
            out = self._run(packed, 1)
            self.dispatches += self.n_shards
        else:
            out = self._run(packed, self.q_lanes)
            self.dispatches += 1
        return {"out": out, "q_n": q_n, "generation": gen}

    def collect(self, token: dict):
        """Finish a ``dispatch`` token: one device-to-host copy + result
        post-processing, the lane pads sliced off. Returns (global ids per
        query, stats) with per-query ``walks``/``hops`` summed over
        shards, ``syncs`` and ``generation``, the publish generation it
        was dispatched against."""
        ids, stats = fetch_results(token["out"], token["q_n"])
        stats["generation"] = token["generation"]
        return ids, stats

    def search(self, queries: list[Query], seed: int = 0):
        """Filtered top-k for a batch across all shards:
        ``collect(dispatch(queries))``."""
        del seed
        return self.collect(self.dispatch(queries))

    def search_reference(self, queries: list[Query]):
        """The shard-at-a-time search of the whole batch without the fence
        and without counting dispatches (the reference's single-device
        baseline; on a mesh, on the cells of lane 0). The mesh path must
        match it bit for bit."""
        packed = self._pack_queries(queries)
        return fetch_results(self._run(packed, 1), len(queries))
