"""Sharded filtered search over a row-partitioned index (DESIGN.md §7), in
reference mode: every shard on one device.

The reference's ``ShardedEngine`` partitions the corpus row-wise into S
contiguous shards (vectors, metadata, a shard-local α-kNN subgraph, a
per-shard ``DeviceAtlas`` and packed row-validity bitmaps for the pad
rows), runs the same fused ``search_batch`` on every shard with the
queries replicated, maps each shard's local top-k to global ids and
merges them exactly. The port runs the reference's *reference mode*
(``mesh=None``): the shards one after another on one device, with the
identical merge. That is how an S-shard snapshot restores onto a machine
with fewer than S devices, with zero rebuild and unchanged results. The
multi-device dispatch (a ``torch.distributed`` all_gather in place of the
reference's ``shard_map``) is not ported: a mesh raises.

The merge is exact: every point lives on exactly one shard and its
distance is a pure function of (q, point), so the k smallest of the union
of per-shard top-ks is the top-k of the union of the per-shard results.
"""
from __future__ import annotations

import dataclasses

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
from repro_torch.core.predicate import derived_vocab_sizes
from repro_torch.core.types import Dataset, Query


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


class ShardedEngine:
    """Filtered search over a row-sharded index, every shard on one
    device (the reference's reference mode, ``mesh=None``).

    ``search`` runs the fused per-shard ``search_batch`` shard after
    shard, maps local result ids to global ids and merges the per-shard
    top-ks exactly (``merge_topk``). ``dispatches`` counts per-shard
    programs, ``n_shards`` a batch, as the reference counts them in this
    mode. ``device`` None means CUDA and raises without it; the index's
    tensors are placed there. A non-None ``mesh`` raises: the
    multi-device dispatch is not ported.

    ``dispatch``/``collect`` keep the reference's token contract: a
    fenced pack + the search, then the results' one device-to-host copy.
    The search's loop exits are read on the host, so ``dispatch`` returns
    once the batch is searched.
    """

    def __init__(self, sindex: ShardedIndex, mesh=None, config=None,
                 seed_backend: str | None = None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "ShardedEngine: the multi-device (mesh) dispatch is not "
                "ported (ROADMAP queue 1 item 7); pass mesh=None to run "
                "every shard on one device")
        self.mesh = mesh
        self.device = resolve_device(device)
        cfg = coerce_config(config, {}, where="ShardedEngine")
        if seed_backend is not None:
            cfg = cfg.with_knobs({"serve.seed_backend": seed_backend})
        self.cfg = cfg
        self.p = cfg.walk
        self._seed_backend = cfg.serve.seed_backend
        self._istate = sindex.insert_state
        dev = self.device
        self.vectors = sindex.vectors.to(dev)
        self.adjacency = sindex.adjacency.to(dev)
        self.metadata = sindex.metadata.to(dev)
        self.global_ids = sindex.global_ids.to(dev)
        self.valid_bm = sindex.valid_bm.to(dev)
        self.datlas = DeviceAtlas(
            *(t.to(dev) for t in sindex.datlas.leaves()),
            v_cap=sindex.datlas.v_cap)
        self.v_cap = sindex.datlas.v_cap
        self.vocab_sizes = sindex.vocab_sizes
        self.n, self.n_shards = sindex.n, sindex.n_shards
        # host stacks + per-shard emitted atlases, made at the first
        # publish so later ones re-emit only the shards they touched
        self._host: dict | None = None
        self._shard_atlases: list[DeviceAtlas | None] = []
        self.dispatches = 0
        self.publish_generation = 0
        self.fence_retries = 0

    # -- live index -----------------------------------------------------------
    def insert_batch(self, vectors: np.ndarray, metadata: np.ndarray, *,
                     gids: np.ndarray | None = None) -> np.ndarray:
        """Append (vector, metadata) rows to the live index: balance-aware
        shard placement, slab writes + validity-bit flips, reverse-edge
        graph repair and incremental atlas updates on the host mirror,
        then the stacked device tensors are re-placed with the same
        shapes. Returns the new rows' global ids. ``dispatches`` is
        untouched."""
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
        mirror and re-place the packed validity bitmap — the single
        liveness source the search reads — so a delete costs one bit-pack
        + transfer, with no graph or atlas work. Returns the number of rows
        tombstoned."""
        if self._istate is None:
            raise ValueError(
                "index has no insert state; deletes need a capacity-slab "
                "index (built with serve.capacity set)")
        from repro_torch.core.batched.lifecycle import delete_rows

        st = self._istate
        n, touched = delete_rows(st, gids)
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
        """Re-place the stacked device tensors from the host mirror after
        host-side maintenance (compaction, growth, deferred repair) — the
        hook ``MaintenanceLoop`` publishes through. ``touched=None``
        refreshes every shard; slab growth drops the stacked host cache so
        the new shapes propagate."""
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
        """Publish: write the touched shards into the host stacks, re-emit
        their atlases, and re-place every stacked tensor on the device
        (the whole stack, as the reference re-places it)."""
        st, dev = self._istate, self.device
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

    def _run_reference(self, q_vecs, fields, allowed, bounds) -> dict:
        """The shard-at-a-time program behind both ``dispatch`` and
        ``search_reference``: the fused per-shard searches in shard order,
        local ids mapped through ``global_ids`` (-1 kept), then the exact
        merge. Hops, walks and syncs sum over shards."""
        per_v, per_i = [], []
        hops = walks = 0
        syncs = 0
        for s in range(self.n_shards):
            out = search_batch(self.datlas.shard(s), self.vectors[s],
                               self.adjacency[s], self.metadata[s], q_vecs,
                               fields, allowed, self.p, self._seed_backend,
                               valid_bm=self.valid_bm[s], bounds=bounds)
            res_i = out["res_i"]
            gids = self.global_ids[s][res_i.clamp(min=0).long()]
            per_v.append(out["res_v"])
            per_i.append(torch.where(res_i >= 0, gids, -1))
            hops = hops + out["hops"]
            walks = walks + out["walks"]
            syncs += out["syncs"]
        res_v, res_i = merge_topk(torch.stack(per_v), torch.stack(per_i),
                                  self.p.k)
        return dict(res_v=res_v, res_i=res_i, hops=hops, walks=walks,
                    syncs=syncs)

    def dispatch(self, queries: list[Query], seed: int = 0) -> dict:
        """Fenced pack + the shard-at-a-time search; returns a token for
        ``collect``. Counts ``n_shards`` dispatches."""
        del seed
        (q_vecs, fields, allowed, bounds), gen = _fence_pack(self, queries)
        out = self._run_reference(q_vecs, fields, allowed, bounds)
        self.dispatches += self.n_shards
        return {"out": out, "q_n": len(queries), "generation": gen}

    def collect(self, token: dict):
        """Finish a ``dispatch`` token: one device-to-host copy + result
        post-processing. Returns (global ids per query, stats) with
        per-query ``walks``/``hops`` summed over shards, ``syncs`` and
        ``generation``, the publish generation it was dispatched
        against."""
        ids, stats = fetch_results(token["out"], token["q_n"])
        stats["generation"] = token["generation"]
        return ids, stats

    def search(self, queries: list[Query], seed: int = 0):
        """Filtered top-k for a batch across all shards:
        ``collect(dispatch(queries))``."""
        del seed
        return self.collect(self.dispatch(queries))

    def search_reference(self, queries: list[Query]):
        """The shard-at-a-time search without the fence and without
        counting dispatches (the reference's single-device baseline, which
        ``search`` is in this mode)."""
        q_vecs, fields, allowed, bounds = self._pack_queries(queries)
        return fetch_results(self._run_reference(q_vecs, fields, allowed,
                                                 bounds), len(queries))
