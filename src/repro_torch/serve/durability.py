"""Crash-consistent serving state: slab snapshots + a checksummed ingest
write-ahead journal (DESIGN.md §10).

A capacity-slab index is mutable, and without this module its mutations
live only in process memory — a crash loses every ingested row and forces
a full graph/atlas rebuild. This module makes the mutable engine state
durable with two complementary pieces:

* **Snapshots** — ``state_to_tree`` serializes the complete host
  ``InsertState`` (slab vectors/metadata, patched adjacency, global-id
  maps, per-shard incremental atlases, insert/seq counters, scalar build
  knobs as one JSON leaf) through the existing ``checkpoint.ckpt``
  atomic-rename + per-leaf-CRC format; ``engine_from_state`` rebuilds a
  working engine from it with ZERO graph/atlas rebuild — every derived
  device table (atlas CSR/presence/envelopes, validity bitmaps) is
  re-*emitted* from the slabs, never re-built. It restores onto any
  mesh: an S-shard state goes onto a mesh of S data cells as it is, onto
  a wider one padded with empty slabs (``pad_state``), and without a
  mesh (or onto a narrower one) into ``ShardedEngine``'s reference mode
  (bit-identical shard-at-a-time execution). The format is the
  reference's, byte for byte, so either package recovers the other's
  snapshots and journals.

* **Journal** — an append-only write-ahead log of ingest batches.
  ``serve.ingest`` appends the (vectors, metadata, seq) record — length-
  framed, with independent CRC32s over header and payload — and fsyncs
  BEFORE any validity bit flips, so the crash window between slab write
  and publish can always be replayed. Recovery = latest readable
  snapshot + replay of journal records with ``seq > applied_seq``
  through the normal insert path (idempotent by seq). A successful
  snapshot truncates the journal.

Torn-tail rule: appends are sequential, so a crash leaves a byte PREFIX
of the file. An incomplete frame at EOF is therefore a torn tail —
dropped silently (the batch was never acknowledged). But bytes that are
all present yet fail their CRC were not truncated, they were corrupted:
that raises ``JournalCorruption`` (a clean, loud error) rather than ever
serving silently wrong state. The header CRC is what separates the two
cases — without it, a corrupted length field would masquerade as a
plausible torn tail and swallow the rest of the log.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import typing
import zlib

import numpy as np

from repro_torch import faults
from repro_torch.checkpoint import ckpt
from repro_torch.core.batched.engine import BatchedEngine, BatchedParams
from repro_torch.core.batched.insert import (HostAtlas, InsertParams,
                                             InsertState, ShardState)
from repro_torch.core.batched.sharded import (ShardedEngine,
                                              index_from_state)
from repro_torch.core.config import FnsConfig, check_state_config
from repro_torch.launch.mesh import (index_axis_size, lead_device,
                                     staging_device)

FORMAT = 2  # v2: per-shard liveness masks + lifecycle counters/backlog
# Record kinds are distinguished by magic so the legacy insert framing is
# byte-identical (a pre-lifecycle journal replays unchanged); the header
# CRC covers the magic, so a flipped kind is corruption, never a reparse.
MAGIC = 0x464E534A          # "FNSJ": insert, auto-assigned gids (legacy)
MAGIC_INSERT_GIDS = 0x464E5347  # "FNSG": insert with explicit gids
MAGIC_DELETE = 0x464E5344   # "FNSD": delete by gids
MAGIC_COMPACT = 0x464E5343  # "FNSC": compact tombstoned shards
_HDR = struct.Struct("<IQIII")  # magic, seq, rows, dim, fields
_CRC = struct.Struct("<I")


class DurabilityError(RuntimeError):
    """A durability-layer invariant was violated (corrupt snapshot meta,
    unknown format version, ...)."""


class JournalCorruption(DurabilityError):
    """Complete journal bytes failed CRC verification: real corruption,
    not a torn tail — never silently dropped."""


class JournalRecord(typing.NamedTuple):
    """One replayable WAL operation. ``seq``/``vectors``/``metadata``
    keep their historical positions (pre-lifecycle code unpacked records
    as (seq, vecs, meta) tuples); ``kind`` is "insert" | "delete" |
    "compact", and ``gids`` carries explicit insert ids (None = the
    replay re-derives them from ``next_gid``, which is deterministic
    because every operation replays in seq order) or the delete set."""

    seq: int
    vectors: np.ndarray | None
    metadata: np.ndarray | None
    kind: str = "insert"
    gids: np.ndarray | None = None


class Journal:
    """Append-only, CRC-framed operation log. One record per ingest /
    delete / compact operation:

        header  = magic u32 | seq u64 | rows u32 | dim u32 | fields u32
        hcrc    = crc32(header) u32
        payload = vectors f32 row-major | metadata i32 row-major
                  [| gids i32]                    (kind-dependent)
        pcrc    = crc32(payload) u32

    The magic encodes the record kind (module constants); insert records
    with auto-assigned gids keep the pre-lifecycle framing byte-for-byte.
    """

    def __init__(self, path: str):
        self.path = path

    def _append_record(self, magic: int, seq: int, rows: int, dim: int,
                       fields: int, payload: bytes) -> None:
        header = _HDR.pack(magic, seq, rows, dim, fields)
        body = header + _CRC.pack(zlib.crc32(header)) + payload
        with open(self.path, "ab") as f:
            # two writes with the fault point between them: a SIGKILL here
            # leaves a genuine torn record for recovery to drop
            split = len(body) // 2
            f.write(body[:split])
            f.flush()
            faults.fire("journal.mid-append")
            f.write(body[split:])
            f.write(_CRC.pack(zlib.crc32(payload)))
            f.flush()
            os.fsync(f.fileno())

    def append(self, seq: int, vectors: np.ndarray, metadata: np.ndarray,
               gids: np.ndarray | None = None) -> None:
        """WAL an insert batch (explicit ``gids`` = re-introduction of
        deleted documents; they ride the payload so replay reuses them)."""
        vectors = np.ascontiguousarray(vectors, np.float32)
        metadata = np.ascontiguousarray(np.atleast_2d(metadata), np.int32)
        rows, dim = vectors.shape
        payload = vectors.tobytes() + metadata.tobytes()
        magic = MAGIC
        if gids is not None:
            magic = MAGIC_INSERT_GIDS
            payload += np.ascontiguousarray(gids, np.int32).tobytes()
        self._append_record(magic, seq, rows, dim, metadata.shape[1],
                            payload)

    def append_delete(self, seq: int, gids) -> None:
        """WAL a delete (the gid set is the whole operation)."""
        gids = np.ascontiguousarray(np.asarray(gids, np.int32).ravel())
        self._append_record(MAGIC_DELETE, seq, gids.size, 0, 0,
                            gids.tobytes())

    def append_compact(self, seq: int) -> None:
        """WAL a compaction. The record carries no payload: compaction is
        deterministic given the slab state, and replay force-compacts
        every tombstoned shard — a superset of any threshold-triggered
        run, equally consistent (documents are addressed by gid, never by
        slot, so replayed row layouts need not match the crashed run's)."""
        self._append_record(MAGIC_COMPACT, seq, 0, 0, 0, b"")

    def read(self) -> tuple[list[JournalRecord], int]:
        """Parse the journal: -> (records, clean_len). ``records`` are
        ``JournalRecord``s in append order; ``clean_len`` is the byte
        length of the intact prefix (a torn tail after it is dropped,
        per the module torn-tail rule). Complete-but-CRC-failing bytes
        raise ``JournalCorruption``."""
        if not os.path.exists(self.path):
            return [], 0
        with open(self.path, "rb") as f:
            data = f.read()
        out: list[JournalRecord] = []
        off = 0
        hdr_n = _HDR.size + _CRC.size
        kinds = {MAGIC: "insert", MAGIC_INSERT_GIDS: "insert",
                 MAGIC_DELETE: "delete", MAGIC_COMPACT: "compact"}
        while off < len(data):
            if off + hdr_n > len(data):
                break  # torn tail: incomplete header
            header = data[off:off + _HDR.size]
            magic, seq, rows, dim, fields = _HDR.unpack(header)
            (hcrc,) = _CRC.unpack(data[off + _HDR.size:off + hdr_n])
            if magic not in kinds or zlib.crc32(header) != hcrc:
                raise JournalCorruption(
                    f"journal {self.path!r}: record header at byte {off} "
                    f"failed CRC32 — corrupted, refusing to replay")
            plen = rows * dim * 4 + rows * fields * 4
            if magic in (MAGIC_INSERT_GIDS, MAGIC_DELETE):
                plen += rows * 4  # trailing i32 gid block
            end = off + hdr_n + plen + _CRC.size
            if end > len(data):
                break  # torn tail: incomplete payload
            payload = data[off + hdr_n:off + hdr_n + plen]
            (pcrc,) = _CRC.unpack(data[end - _CRC.size:end])
            if zlib.crc32(payload) != pcrc:
                raise JournalCorruption(
                    f"journal {self.path!r}: record seq {seq} payload "
                    f"failed CRC32 — corrupted, refusing to replay")
            if magic == MAGIC_DELETE:
                rec = JournalRecord(seq, None, None, "delete",
                                    np.frombuffer(payload, np.int32))
            elif magic == MAGIC_COMPACT:
                rec = JournalRecord(seq, None, None, "compact")
            else:
                vn = rows * dim * 4
                mn = vn + rows * fields * 4
                vecs = np.frombuffer(payload[:vn],
                                     np.float32).reshape(rows, dim)
                meta = np.frombuffer(payload[vn:mn],
                                     np.int32).reshape(rows, fields)
                gids = (np.frombuffer(payload[mn:], np.int32)
                        if magic == MAGIC_INSERT_GIDS else None)
                rec = JournalRecord(seq, vecs, meta, "insert", gids)
            out.append(rec)
            off = end
        return out, off

    def repair(self) -> int:
        """Truncate a torn tail off the journal so post-recovery appends
        land after the intact prefix. Returns the dropped byte count."""
        recs, clean = self.read()
        del recs
        size = os.path.getsize(self.path) if os.path.exists(self.path) else 0
        if size > clean:
            with open(self.path, "r+b") as f:
                f.truncate(clean)
        return size - clean

    def truncate(self) -> None:
        """Drop every record (a snapshot has made them redundant)."""
        open(self.path, "wb").close()


# -- InsertState <-> checkpoint tree ----------------------------------------

def state_to_tree(state: InsertState, extra: dict | None = None) -> dict:
    """Serialize the complete mutable engine state as a checkpoint tree:
    one nested dict of per-shard slab arrays plus a single ``meta`` leaf
    (JSON as uint8) holding every scalar — counters, build knobs, per-shard
    n_valid, and the caller's ``extra`` (serving params etc.)."""
    meta = {"format": FORMAT,
            "n_shards": len(state.shards),
            "v_cap": state.v_cap, "graph_k": state.graph_k,
            "alpha": state.alpha, "seed": state.seed,
            "next_gid": state.next_gid, "inserted": state.inserted,
            "batches": state.batches, "repairs": state.repairs,
            "applied_seq": state.applied_seq,
            "insert_params": dataclasses.asdict(state.params),
            # lifecycle (format 2): counters + the deferred-repair backlog
            # (FIFO of [shard, lo, hi] — row ranges are snapshot-stable
            # because compaction drains a shard's backlog before remapping)
            "deleted": state.deleted, "compactions": state.compactions,
            "grown": state.grown,
            "pending": [[int(s), int(lo), int(hi)]
                        for s, lo, hi in state.pending],
            "shards": [{"n_valid": int(sh.n_valid),
                        "reclusters": int(sh.atlas.reclusters)}
                       for sh in state.shards],
            "extra": extra or {}}
    tree: dict = {"meta": np.frombuffer(json.dumps(meta).encode(), np.uint8)}
    for s, sh in enumerate(state.shards):
        tree[f"shard{s}"] = {
            "vectors": sh.vectors, "adjacency": sh.adjacency,
            "metadata": sh.metadata, "global_ids": sh.global_ids,
            "live": sh.live.astype(np.uint8),
            "assign": sh.atlas.assign, "centroids": sh.atlas.centroids,
            "base_counts": sh.atlas.base_counts,
            "base_centroids": sh.atlas.base_centroids}
    return tree


def state_from_tree(arrays: dict) -> tuple[InsertState, dict]:
    """Inverse of ``state_to_tree`` from a template-free checkpoint load
    (flat path -> array). Returns (state, extra)."""
    try:
        meta = json.loads(bytes(bytearray(np.asarray(arrays["meta"]))))
    except Exception as e:
        raise DurabilityError(
            f"snapshot meta leaf is unreadable: {e}") from e
    if meta.get("format") not in (1, FORMAT):
        raise DurabilityError(
            f"snapshot format {meta.get('format')!r} is not supported "
            f"(this build reads formats 1..{FORMAT})")
    shards = []
    for s, shm in enumerate(meta["shards"]):
        pre = f"shard{s}/"
        atlas = HostAtlas(
            centroids=np.array(arrays[pre + "centroids"], np.float32),
            assign=np.array(arrays[pre + "assign"], np.int32),
            base_counts=np.array(arrays[pre + "base_counts"], np.int64),
            base_centroids=np.array(arrays[pre + "base_centroids"],
                                    np.float32),
            reclusters=shm["reclusters"])
        # format-1 snapshots predate deletes: no live leaf means liveness
        # is the written prefix (ShardState derives it from n_valid)
        live = (np.array(arrays[pre + "live"]).astype(bool)
                if pre + "live" in arrays else None)
        shards.append(ShardState(
            np.array(arrays[pre + "vectors"], np.float32),
            np.array(arrays[pre + "adjacency"], np.int32),
            np.array(arrays[pre + "metadata"], np.int32),
            np.array(arrays[pre + "global_ids"], np.int32),
            shm["n_valid"], atlas, live=live))
    state = InsertState(
        shards=shards, v_cap=meta["v_cap"], graph_k=meta["graph_k"],
        alpha=meta["alpha"], seed=meta["seed"], next_gid=meta["next_gid"],
        params=InsertParams(**meta["insert_params"]),
        inserted=meta["inserted"], batches=meta["batches"],
        repairs=meta["repairs"], applied_seq=meta["applied_seq"],
        deleted=meta.get("deleted", 0),
        compactions=meta.get("compactions", 0),
        grown=meta.get("grown", 0),
        pending=[(int(s), int(lo), int(hi))
                 for s, lo, hi in meta.get("pending", [])])
    return state, meta["extra"]


# -- cross-mesh engine reconstruction ---------------------------------------

def pad_state(state: InsertState, n_shards: int) -> InsertState:
    """Grow a restored state to ``n_shards`` by appending EMPTY slabs
    (n_valid 0, all rows invalid, centroids cloned from shard 0 so the
    stacked atlas keeps its K). Exact by construction: an empty shard's
    validity bitmap fails every predicate, and balance-aware placement
    fills the empty slabs first on subsequent inserts."""
    s0 = state.shards[0]
    k = s0.atlas.n_clusters
    while len(state.shards) < n_shards:
        atlas = HostAtlas(
            centroids=s0.atlas.centroids.copy(),
            assign=np.zeros(s0.cap, np.int32),
            base_counts=np.zeros(k, np.int64),
            base_centroids=s0.atlas.centroids.copy())
        state.shards.append(ShardState(
            np.zeros_like(s0.vectors),
            np.full_like(s0.adjacency, -1),
            np.full_like(s0.metadata, -1),
            np.full(s0.cap, -1, np.int32), 0, atlas))
    return state


def engine_from_state(state: InsertState, *, mesh=None, config=None,
                      params: BatchedParams | None = None,
                      seed_backend: str | None = None, vocab_sizes=None,
                      device=None):
    """Reconstruct a live engine from a restored state on whatever mesh
    this process has — zero graph/atlas rebuild on every path:

    * the mesh's ``data`` axis spans exactly the snapshot's S shards ->
      ``ShardedEngine`` on the mesh (each host slab placed on its cells);
    * it spans MORE cells -> pad with empty slabs, then the mesh
      (exact, see ``pad_state``);
    * no mesh, or one that spans FEWER cells: a 1-shard state becomes a
      ``BatchedEngine``; a multi-shard state runs in ``ShardedEngine``'s
      reference mode (shard-at-a-time execution on one device, so
      restoring a 4-shard snapshot keeps the 4-shard search semantics,
      and with them the recall profile).

    Without a mesh everything runs on ``device`` (None means CUDA); with
    one, ``device`` must be None and the fallback engines run on the
    mesh's first cell (``launch.mesh.lead_device``).

    ``config`` (an ``FnsConfig``) is the one knob source; when given, its
    shape-baked knobs are validated against the state (``ConfigMismatch``
    on conflict — graph_k/v_cap/capacity are baked into the slabs and
    cannot be changed by a restore). ``params`` (a ``WalkConfig``) is the
    legacy form the engines fold in. ``seed_backend`` lands in the
    engine's ``serve.seed_backend`` knob, the port engines' only seed
    backend switch."""
    device = lead_device(mesh, device)
    if isinstance(config, FnsConfig):
        check_state_config(
            config, graph_k=state.graph_k, v_cap=state.v_cap,
            n_clusters=state.shards[0].atlas.n_clusters,
            capacity=sum(sh.cap for sh in state.shards),
            where="engine_from_state")
    eff = config if config is not None else params
    s = len(state.shards)
    target = index_axis_size(mesh) if mesh is not None else 1
    if mesh is not None and target >= s:
        if target > s:
            pad_state(state, target)
        return ShardedEngine(index_from_state(state, vocab_sizes=vocab_sizes,
                                              device=staging_device(mesh)),
                             mesh, config=eff, seed_backend=seed_backend)
    if s == 1:
        eng = BatchedEngine.from_state(state, config=eff, device=device,
                                       vocab_sizes=vocab_sizes)
        if seed_backend is not None:
            eng.cfg = eng.cfg.with_knobs(
                {"serve.seed_backend": seed_backend})
        return eng
    return ShardedEngine(index_from_state(state, vocab_sizes=vocab_sizes,
                                          device=device),
                         None, config=eff, seed_backend=seed_backend,
                         device=device)


# -- the store: snapshots dir + journal under one root ----------------------

class DurableStore:
    """One durability root for a serving process:

        <path>/snapshots/step_<applied_seq>/...   (ckpt format, CRC'd)
        <path>/journal.bin                        (WAL since last snapshot)

    Snapshot steps are numbered by ``applied_seq`` so the recovery
    ordering (load snapshot, replay journal seq > applied_seq) is encoded
    in the directory listing itself."""

    def __init__(self, path: str, keep: int = 3):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.keep = keep
        self.snap_dir = os.path.join(path, "snapshots")
        self.journal = Journal(os.path.join(path, "journal.bin"))

    def snapshot(self, state: InsertState, extra: dict | None = None) -> int:
        """Atomically persist the full engine state, then truncate the
        journal (every journaled record is applied before ``ingest``
        returns, so a successful snapshot strictly covers them). A crash
        before the rename leaves the previous snapshot + intact journal —
        recovery is unaffected."""
        step = state.applied_seq
        cfg = (extra or {}).get("config")
        meta = ({"config_fingerprint": cfg.get("fingerprint"),
                 "config": cfg.get("knobs")} if cfg else None)
        ckpt.save(self.snap_dir, step, state_to_tree(state, extra),
                  keep=self.keep, meta=meta)
        self.journal.truncate()
        return step

    def load_latest(self) -> tuple[InsertState, dict, int]:
        """Latest *readable* snapshot (corrupt/torn newest falls back to
        the previous, via ``ckpt.restore_latest``)."""
        (arrays, _manifest), step = ckpt.restore_latest(self.snap_dir)
        state, extra = state_from_tree(arrays)
        return state, extra, step

    def has_snapshot(self) -> bool:
        return bool(ckpt.all_steps(self.snap_dir))
