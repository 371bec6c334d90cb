"""Crash-consistent serving in the port (``repro_torch.serve.durability``
through ``RetrievalService``, ``device="cpu"``): snapshot round trip with
every build entry point boobytrapped, journal replay, multi-shard recovery
without a mesh (recovery onto a mesh is ``test_torch_mesh.py``), the
three in-process fault points and the three SIGKILL crashes (a
subprocess that imports only the port), corruption detection,
torn journal records and ingest validation; and recovery across packages
in both directions (one shard and two), where the recovered service's
``query_batch`` ids and ``staleness()`` must equal the writer's.

The corpus is the reference durability suite's: 600 x 32, graph_k 12,
r_max 36, 480 build rows plus chunks of 40."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.core.search import SearchParams as RefParams
from repro.core.types import Dataset as RefDataset
from repro.serve.retrieval import RetrievalService as RefService
from repro_torch import faults
from repro_torch.core.config import FnsConfig, WalkConfig
from repro_torch.core.search import SearchParams
from repro_torch.core.types import Dataset
from repro_torch.interop import queries_from_reference
from repro_torch.serve.retrieval import RetrievalService

SELS = (0.5, 0.1, 0.02)
GRAPH = dict(graph_k=12, r_max=36)
CHUNK = 40
BASE_N = 480  # + 3 chunks of 40 = the full 600-row corpus
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ds():
    from repro.data.synth import make_selectivity_dataset

    return make_selectivity_dataset(SELS, n=600, d=32, n_components=12,
                                    seed=11)


@pytest.fixture(scope="module")
def ref_queries(ds):
    from repro.data.synth import make_selectivity_queries

    return [q for code in range(len(SELS))
            for q in make_selectivity_queries(ds, code, 6)]


@pytest.fixture(scope="module")
def queries(ref_queries):
    return queries_from_reference(ref_queries)


def _mk_service(ds, n_rows):
    base = Dataset(ds.vectors[:n_rows], ds.metadata[:n_rows],
                   ds.field_names, list(ds.vocab_sizes))
    return RetrievalService.build(base, params=SearchParams(k=10,
                                                            max_hops=80),
                                  capacity=ds.n, device="cpu", **GRAPH)


def _mk_ref_service(ds, n_rows):
    base = RefDataset(ds.vectors[:n_rows], ds.metadata[:n_rows],
                      ds.field_names, list(ds.vocab_sizes))
    return RefService.build(base, params=RefParams(k=10, max_hops=80),
                            capacity=ds.n, **GRAPH)


def _query(svc, queries):
    ids, _ = svc.query_batch(np.stack([q.vector for q in queries]),
                             [q.predicate for q in queries])
    return ids


def _assert_same_ids(a_ids, b_ids):
    assert len(a_ids) == len(b_ids)
    for i, (a, b) in enumerate(zip(a_ids, b_ids)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"query {i}")


def _chunk(ds, i):
    lo = BASE_N + i * CHUNK
    return ds.vectors[lo:lo + CHUNK], ds.metadata[lo:lo + CHUNK]


def _control(ds, rows):
    """A never-crashed service over the first ``rows`` rows, ingested in
    the same chunks."""
    ctrl = _mk_service(ds, BASE_N)
    for lo in range(BASE_N, rows, CHUNK):
        ctrl.ingest(ds.vectors[lo:lo + CHUNK], ds.metadata[lo:lo + CHUNK])
    return ctrl


# -- snapshot / restore ------------------------------------------------------

def test_snapshot_restore_roundtrip_zero_rebuild(ds, queries, tmp_path,
                                                 monkeypatch):
    """Restore reproduces the grown service exactly without any graph or
    atlas construction: every build entry point raises during recovery."""
    svc = _mk_service(ds, BASE_N)
    svc.ingest(*_chunk(ds, 0))
    svc.enable_durability(str(tmp_path))
    ids0 = _query(svc, queries)
    st0 = svc.staleness()

    def trap(name):
        def _boom(*a, **k):
            raise AssertionError(f"recovery path called {name}")
        return _boom

    import repro_torch.core.atlas as atlas_mod
    import repro_torch.core.batched.insert as insert_mod
    import repro_torch.core.batched.sharded as sharded_mod
    import repro_torch.serve.retrieval as retrieval_mod
    monkeypatch.setattr(retrieval_mod, "build_alpha_knn",
                        trap("build_alpha_knn"))
    monkeypatch.setattr(sharded_mod, "build_shard_graphs",
                        trap("build_shard_graphs"))
    monkeypatch.setattr(atlas_mod, "kmeans", trap("kmeans"))
    monkeypatch.setattr(insert_mod, "kmeans", trap("kmeans"))
    monkeypatch.setattr(atlas_mod.AnchorAtlas, "build",
                        trap("AnchorAtlas.build"))

    svc2 = RetrievalService.recover(str(tmp_path), device="cpu")
    eng2 = svc2._live_engine()
    d0 = eng2.dispatches
    ids1 = _query(svc2, queries)
    assert eng2.dispatches - d0 == 1
    _assert_same_ids(ids0, ids1)
    assert svc2.staleness() == st0
    monkeypatch.undo()
    svc2.ingest(*_chunk(ds, 1))
    assert svc2.staleness()["inserted_rows"] == 2 * CHUNK


def test_journal_replay_after_restore(ds, queries, tmp_path):
    """Ingests after the last snapshot live only in the journal; recovery
    replays them and serves exactly what the live service serves; replay
    is idempotent; ``restore`` serves the snapshot rows only."""
    svc = _mk_service(ds, BASE_N)
    svc.enable_durability(str(tmp_path))
    svc.ingest(*_chunk(ds, 0))
    svc.snapshot()
    svc.ingest(*_chunk(ds, 1))
    svc.delete([5, BASE_N + 3])
    ids0 = _query(svc, queries)

    svc2 = RetrievalService.recover(str(tmp_path), device="cpu")
    assert svc2.staleness() == svc.staleness()
    _assert_same_ids(ids0, _query(svc2, queries))
    svc3 = RetrievalService.recover(str(tmp_path), device="cpu")
    assert svc3.staleness() == svc2.staleness()
    _assert_same_ids(_query(svc2, queries), _query(svc3, queries))
    svc4 = RetrievalService.restore(str(tmp_path), device="cpu")
    assert svc4.staleness()["corpus_rows"] == BASE_N + CHUNK
    assert svc4._next_seq == svc2._next_seq


def test_recover_multi_shard_without_mesh(ds, queries, tmp_path):
    """A 2-shard snapshot on one device serves through ``ShardedEngine``'s
    reference mode with the same results, and keeps absorbing inserts."""
    from repro_torch.core.batched.sharded import (ShardedEngine,
                                                  build_sharded_index)
    from repro_torch.serve.durability import DurableStore, engine_from_state

    cfg = FnsConfig(walk=WalkConfig(k=10)).with_knobs(
        {"serve.capacity": ds.n, "graph.graph_k": 12, "graph.r_max": 36})
    sidx = build_sharded_index(ds.vectors[:BASE_N], ds.metadata[:BASE_N], 2,
                               config=cfg, device="cpu")
    eng = ShardedEngine(sidx, None, cfg, device="cpu")
    eng.insert_batch(*_chunk(ds, 0))
    ids0, _ = eng.search(queries)

    store = DurableStore(str(tmp_path))
    store.snapshot(eng.state)
    state, _, _ = store.load_latest()
    eng2 = engine_from_state(state, mesh=None, params=WalkConfig(k=10),
                             vocab_sizes=tuple(ds.vocab_sizes), device="cpu")
    assert isinstance(eng2, ShardedEngine) and eng2.mesh is None
    _assert_same_ids(ids0, eng2.search(queries)[0])
    eng2.insert_batch(*_chunk(ds, 1))
    assert eng2.insert_stats["inserted_rows"] == 2 * CHUNK
    with pytest.raises(TypeError, match="Mesh"):
        engine_from_state(state, mesh=object(), device="cpu")


def test_mesh_and_missing_cuda_raise(ds, tmp_path, monkeypatch):
    """Anything but a ``Mesh`` raises ``TypeError``, and a mesh with a
    ``device`` ``ValueError`` (the mesh places everything);
    ``device=None`` without a mesh means CUDA and raises where there is
    none, for ``build`` and ``recover`` alike."""
    import torch

    from repro_torch.launch.mesh import make_local_mesh

    base = Dataset(ds.vectors[:BASE_N], ds.metadata[:BASE_N],
                   ds.field_names, list(ds.vocab_sizes))
    with pytest.raises(TypeError, match="Mesh"):
        RetrievalService.build(base, mesh=object(), device="cpu", **GRAPH)
    with pytest.raises(ValueError, match="device=None"):
        RetrievalService.build(base, mesh=make_local_mesh(
            2, devices=["cpu"] * 2), device="cpu", **GRAPH)
    svc = _mk_service(ds, BASE_N)
    svc.enable_durability(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalService.build(base, **GRAPH)
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalService.recover(str(tmp_path))
    with pytest.raises(TypeError, match="Mesh"):
        RetrievalService.recover(str(tmp_path), mesh=object(), device="cpu")


# -- fault injection: in-process crash points --------------------------------

def test_fault_point_post_slab_write(ds, queries, tmp_path):
    """Crash after the slab write, before the validity flip: the batch was
    journaled first, so recovery replays it and serves exactly what a
    never-crashed service over the same rows serves."""
    svc = _mk_service(ds, BASE_N)
    svc.enable_durability(str(tmp_path))
    faults.arm("ingest.post-slab-write")
    try:
        with pytest.raises(faults.InjectedFault):
            svc.ingest(*_chunk(ds, 0))
    finally:
        faults.disarm()
    svc2 = RetrievalService.recover(str(tmp_path), device="cpu")
    assert svc2.staleness()["corpus_rows"] == BASE_N + CHUNK
    _assert_same_ids(_query(svc2, queries),
                     _query(_control(ds, BASE_N + CHUNK), queries))


def test_fault_point_mid_journal_append(ds, tmp_path):
    """Crash mid-append: a torn tail, dropped by recovery; the repaired
    journal takes and replays the next append."""
    svc = _mk_service(ds, BASE_N)
    svc.enable_durability(str(tmp_path))
    svc.ingest(*_chunk(ds, 0))
    faults.arm("journal.mid-append")
    try:
        with pytest.raises(faults.InjectedFault):
            svc.ingest(*_chunk(ds, 1))
    finally:
        faults.disarm()
    svc2 = RetrievalService.recover(str(tmp_path), device="cpu")
    assert svc2.staleness()["corpus_rows"] == BASE_N + CHUNK
    svc2.ingest(*_chunk(ds, 1))
    svc3 = RetrievalService.recover(str(tmp_path), device="cpu")
    assert svc3.staleness()["corpus_rows"] == BASE_N + 2 * CHUNK


def test_fault_point_pre_snapshot_rename(ds, tmp_path):
    """Crash before the snapshot's atomic rename: the old snapshot + the
    intact journal recover everything; the next save sweeps the tmp."""
    svc = _mk_service(ds, BASE_N)
    svc.enable_durability(str(tmp_path))
    svc.ingest(*_chunk(ds, 0))
    faults.arm("snapshot.pre-rename")
    try:
        with pytest.raises(faults.InjectedFault):
            svc.snapshot()
    finally:
        faults.disarm()
    snap_dir = tmp_path / "snapshots"
    assert any(n.endswith(".tmp") for n in os.listdir(snap_dir))
    svc2 = RetrievalService.recover(str(tmp_path), device="cpu")
    assert svc2.staleness()["corpus_rows"] == BASE_N + CHUNK
    svc2.snapshot()
    assert not any(n.endswith(".tmp") for n in os.listdir(snap_dir))
    svc3 = RetrievalService.recover(str(tmp_path), device="cpu")
    assert svc3.staleness()["corpus_rows"] == BASE_N + CHUNK


# -- fault injection: real SIGKILL subprocesses ------------------------------

CRASH_SCRIPT = textwrap.dedent(f"""
    import os, sys
    sys.path.insert(0, "src")
    root, point = sys.argv[1], sys.argv[2]
    from repro_torch.core.search import SearchParams
    from repro_torch.core.types import Dataset
    from repro_torch.data.synth import make_selectivity_dataset
    from repro_torch.serve.retrieval import RetrievalService
    BASE_N, CHUNK = {BASE_N}, {CHUNK}
    ds = make_selectivity_dataset({SELS!r}, n=600, d=32, n_components=12,
                                  seed=11)
    svc = RetrievalService.build(
        Dataset(ds.vectors[:BASE_N], ds.metadata[:BASE_N], ds.field_names,
                list(ds.vocab_sizes)),
        params=SearchParams(k=10, max_hops=80), capacity=ds.n, device="cpu",
        graph_k={GRAPH["graph_k"]}, r_max={GRAPH["r_max"]})
    svc.enable_durability(root)
    def chunk(i):
        lo = BASE_N + i * CHUNK
        return ds.vectors[lo:lo + CHUNK], ds.metadata[lo:lo + CHUNK]
    svc.ingest(*chunk(0))
    svc.snapshot()
    svc.ingest(*chunk(1))
    assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                   for m in sys.modules), "the crash process imported jax"
    os.environ["FNS_FAULT"] = point  # read at fire time: SIGKILL self
    if point == "snapshot.pre-rename":
        svc.snapshot()
    else:
        svc.ingest(*chunk(2))
    print("SURVIVED", flush=True)
    sys.exit(3)
""")

# fault point -> rows the recovered service must serve (the crashed batch
# survives only if it was fully journaled before the kill)
_SIGKILL_CASES = [
    ("ingest.post-slab-write", BASE_N + 3 * CHUNK),
    ("journal.mid-append", BASE_N + 2 * CHUNK),
    ("snapshot.pre-rename", BASE_N + 2 * CHUNK),
]


@pytest.mark.parametrize("point,expect_rows", _SIGKILL_CASES,
                         ids=[c[0] for c in _SIGKILL_CASES])
def test_sigkill_recovery_parity(ds, queries, tmp_path, point, expect_rows):
    """A subprocess running only the port SIGKILLs itself at the fault
    point; this process recovers from the surviving files and serves
    exactly what a never-crashed service over the same rows serves."""
    root = str(tmp_path)
    proc = subprocess.run([sys.executable, "-c", CRASH_SCRIPT, root, point],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == -9, (
        f"expected SIGKILL at {point}, got rc={proc.returncode}\n"
        f"stdout={proc.stdout}\nstderr={proc.stderr}")
    assert "SURVIVED" not in proc.stdout

    svc = RetrievalService.recover(root, device="cpu")
    assert svc.staleness()["corpus_rows"] == expect_rows
    _assert_same_ids(_query(svc, queries),
                     _query(_control(ds, expect_rows), queries))
    if expect_rows < ds.n:
        svc.ingest(ds.vectors[expect_rows:expect_rows + CHUNK],
                   ds.metadata[expect_rows:expect_rows + CHUNK])
        svc.snapshot()
        svc2 = RetrievalService.recover(root, device="cpu")
        assert svc2.staleness()["corpus_rows"] == expect_rows + CHUNK


# -- corruption detection ----------------------------------------------------

def test_journal_corruption_detected(ds, tmp_path):
    """A flipped byte in a complete record is corruption, not a torn tail:
    recovery refuses loudly, for a payload byte and for a header byte."""
    from repro_torch.serve.durability import JournalCorruption

    svc = _mk_service(ds, BASE_N)
    svc.enable_durability(str(tmp_path))
    svc.ingest(*_chunk(ds, 0))
    jp = tmp_path / "journal.bin"
    raw = bytearray(jp.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    jp.write_bytes(bytes(raw))
    with pytest.raises(JournalCorruption, match="CRC32"):
        RetrievalService.recover(str(tmp_path), device="cpu")
    raw[len(raw) // 2] ^= 0xFF
    raw[4] ^= 0x01
    jp.write_bytes(bytes(raw))
    with pytest.raises(JournalCorruption, match="header"):
        RetrievalService.recover(str(tmp_path), device="cpu")


def test_snapshot_corruption_falls_back(ds, tmp_path):
    """A corrupted newest snapshot falls back to the previous readable
    one; with every snapshot corrupted the error is clean."""
    from repro_torch.checkpoint.ckpt import CheckpointCorruption

    svc = _mk_service(ds, BASE_N)
    svc.enable_durability(str(tmp_path))
    svc.ingest(*_chunk(ds, 0))
    svc.snapshot()
    steps = sorted(os.listdir(tmp_path / "snapshots"))
    assert len(steps) == 2

    def corrupt(step_name):
        f = tmp_path / "snapshots" / step_name / "arrays.npz"
        raw = bytearray(f.read_bytes())
        at = raw.find(np.ascontiguousarray(ds.vectors[:8],
                                           np.float32).tobytes()[:16])
        assert at >= 0
        raw[at + 5] ^= 0xFF
        f.write_bytes(bytes(raw))

    corrupt(steps[-1])
    svc2 = RetrievalService.recover(str(tmp_path), device="cpu")
    assert svc2.staleness()["corpus_rows"] == BASE_N
    corrupt(steps[0])
    with pytest.raises(CheckpointCorruption, match="no readable"):
        RetrievalService.recover(str(tmp_path), device="cpu")


def test_torn_record_boundary_cases(tmp_path):
    """Prefix truncations anywhere in a record are torn tails (dropped and
    repaired); complete-byte corruption raises; and every record kind the
    port writes is byte-identical to the reference's."""
    from repro.serve.durability import Journal as RefJournal
    from repro_torch.serve.durability import Journal, JournalCorruption

    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((6, 8)).astype(np.float32)
    meta = rng.integers(0, 9, (6, 2)).astype(np.int32)
    jp = str(tmp_path / "j.bin")
    j = Journal(jp)
    j.append(1, vecs, meta)
    j.append(2, vecs * 2, meta + 1)
    recs, clean = j.read()
    assert [r[0] for r in recs] == [1, 2]
    np.testing.assert_array_equal(recs[1][1], vecs * 2)
    full = open(jp, "rb").read()
    assert clean == len(full)
    rec_len = len(full) // 2
    for cut in (3, 20, rec_len - 1):
        with open(jp, "wb") as f:
            f.write(full[:rec_len + cut])
        recs, clean = j.read()
        assert [r[0] for r in recs] == [1] and clean == rec_len
        assert j.repair() == cut
        assert os.path.getsize(jp) == rec_len
        with open(jp, "wb") as f:
            f.write(full)
    open(jp, "wb").close()
    assert j.read() == ([], 0)
    assert Journal(str(tmp_path / "nope.bin")).read() == ([], 0)
    bad = bytearray(full)
    bad[9] ^= 0xFF
    with open(jp, "wb") as f:
        f.write(bytes(bad))
    with pytest.raises(JournalCorruption):
        j.read()

    def write_all(journal):
        journal.append(1, vecs, meta)
        journal.append(2, vecs[:2], meta[:2], gids=np.array([7, 3]))
        journal.append_delete(3, [4, 9, 2])
        journal.append_compact(4)

    write_all(Journal(str(tmp_path / "p.bin")))
    write_all(RefJournal(str(tmp_path / "r.bin")))
    assert ((tmp_path / "p.bin").read_bytes()
            == (tmp_path / "r.bin").read_bytes())
    recs_p, _ = Journal(str(tmp_path / "r.bin")).read()
    assert [(r.seq, r.kind) for r in recs_p] == [
        (1, "insert"), (2, "insert"), (3, "delete"), (4, "compact")]
    np.testing.assert_array_equal(recs_p[1].gids, [7, 3])
    np.testing.assert_array_equal(recs_p[2].gids, [4, 9, 2])


# -- ingest validation -------------------------------------------------------

def test_ingest_validation_clean_errors(ds, tmp_path):
    """Bad ingest inputs fail up front with clean messages, before the
    journal write."""
    svc = _mk_service(ds, BASE_N)
    svc.enable_durability(str(tmp_path))
    good_v = ds.vectors[BASE_N:BASE_N + 4]
    good_m = ds.metadata[BASE_N:BASE_N + 4]
    with pytest.raises(ValueError, match="must be 2-D"):
        svc.ingest(np.zeros((2, 3, 4)), good_m[:2])
    with pytest.raises(ValueError, match="one metadata row per vector"):
        svc.ingest(good_v, good_m[:3])
    with pytest.raises(ValueError, match="fields"):
        svc.ingest(good_v, good_m[:, :-1])
    with pytest.raises(ValueError, match="serves dim"):
        svc.ingest(good_v[:, :-2], good_m)
    bad = good_m.copy()
    bad[0, 0] = 10 ** 6
    with pytest.raises(ValueError, match="declared vocab domain"):
        svc.ingest(good_v, bad)
    with pytest.raises(ValueError, match="still live"):
        svc.ingest(good_v, good_m, gids=[1, 2, 3, 4])
    with pytest.raises(ValueError, match="unknown or already-deleted"):
        svc.delete([10 ** 5])
    assert os.path.getsize(tmp_path / "journal.bin") == 0
    assert svc.staleness()["inserted_rows"] == 0
    svc.ingest(good_v, good_m)
    assert svc.staleness()["inserted_rows"] == 4


# -- recovery across packages -------------------------------------------------

def _churn(svc, ds, tmp_path):
    """Durability on, one ingest, a snapshot, then a journal suffix: an
    ingest, a delete and a re-introduction under an explicit gid."""
    svc.enable_durability(str(tmp_path))
    svc.ingest(*_chunk(ds, 0))
    svc.snapshot()
    svc.ingest(*_chunk(ds, 1))
    svc.delete([2, 7, BASE_N + 1])
    svc.ingest(ds.vectors[7:8], ds.metadata[7:8], gids=[7])


def test_reference_writes_port_recovers(ds, ref_queries, queries, tmp_path):
    ref = _mk_ref_service(ds, BASE_N)
    _churn(ref, ds, tmp_path)
    port = RetrievalService.recover(str(tmp_path), device="cpu")
    assert port.staleness() == ref.staleness()
    _assert_same_ids(_query(port, queries), _query(ref, ref_queries))
    assert port._next_seq == ref._next_seq


def test_port_writes_reference_recovers(ds, ref_queries, queries, tmp_path):
    port = _mk_service(ds, BASE_N)
    _churn(port, ds, tmp_path)
    ref = RefService.recover(str(tmp_path))
    assert ref.staleness() == port.staleness()
    _assert_same_ids(_query(ref, ref_queries), _query(port, queries))
    assert ref._next_seq == port._next_seq


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_two_shard_recovery_across_packages(ds, ref_queries, queries,
                                            tmp_path, writer):
    """A 2-shard service (sharded reference mode, no mesh) snapshots and
    journals; the other package recovers it into its own sharded
    reference mode with the same ids and the same staleness."""
    from repro.core.batched.sharded import ShardedEngine as RefSharded
    from repro.core.batched.sharded import \
        build_sharded_index as ref_build_sharded
    from repro.core.config import FnsConfig as RefConfig
    from repro_torch.core.batched.sharded import (ShardedEngine,
                                                  build_sharded_index)

    knobs = {"walk.k": 10, "walk.max_hops": 80, "serve.capacity": ds.n,
             "graph.graph_k": 12, "graph.r_max": 36}
    rcfg, pcfg = RefConfig().with_knobs(knobs), FnsConfig().with_knobs(knobs)
    base = (ds.vectors[:BASE_N], ds.metadata[:BASE_N])
    if writer == "reference":
        eng = RefSharded(ref_build_sharded(*base, 2, config=rcfg), None,
                         config=rcfg)
        svc = RefService(None, RefParams(k=10, max_hops=80), config=rcfg,
                         capacity=ds.n, _sharded=eng)
    else:
        eng = ShardedEngine(build_sharded_index(*base, 2, config=pcfg,
                                                device="cpu"),
                            None, config=pcfg, device="cpu")
        svc = RetrievalService(None, SearchParams(k=10, max_hops=80),
                               config=pcfg, capacity=ds.n, device="cpu",
                               _sharded=eng)
    _churn(svc, ds, tmp_path)
    if writer == "reference":
        other = RetrievalService.recover(str(tmp_path), device="cpu")
        assert isinstance(other._sharded, ShardedEngine)
        mine, theirs = _query(svc, ref_queries), _query(other, queries)
    else:
        other = RefService.recover(str(tmp_path))
        assert isinstance(other._sharded, RefSharded)
        mine, theirs = _query(svc, queries), _query(other, ref_queries)
    assert other.staleness() == svc.staleness()
    _assert_same_ids(theirs, mine)
    assert sum(len(i) for i in mine) > 0
