"""The port's sharded search and serving over a device mesh
(``launch/mesh.py``, ``launch/shardings.py``, ``ShardedEngine(mesh=)``,
``engine_from_state(mesh=)``, ``RetrievalService(mesh=)``) on meshes of
CPU cells (``devices=["cpu"] * n``, the counterpart of the reference's
``--xla_force_host_platform_device_count``):

* the mesh helpers, beside the reference's own on the same mesh object;
* the mesh engine against the port's reference mode (ids, walks, hops,
  dispatches) on the selectivity, OR and range sweeps, on 1D meshes of 2
  and 4 data cells, a 2 x 2 data x query mesh and a 1 x 4 query mesh, with
  a batch that does not split evenly over the lanes;
* the mesh engine against the reference's ``shard_map`` program, run in a
  subprocess on 8 virtual CPU devices (conj, OR and range on a 4 x 1 and a
  2 x 4 mesh);
* the live index on a mesh, op for op against reference mode;
* recovery across meshes (the reference's ``test_recover_cross_mesh``)
  and a reference snapshot recovered onto a port mesh;
* ``query_batch`` routed to the mesh engine, its bucket rounded to the
  lanes.

Everything runs on the CPU through the plain PyTorch versions, so exact
equality is the bar.
"""
import copy
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core.search import SearchParams as RefParams
from repro.core.types import Dataset as RefDataset
from repro.data.synth import (add_or_pair_fields, add_timestamp_field,
                              make_or_queries, make_range_queries,
                              make_selectivity_dataset,
                              make_selectivity_queries)
from repro.launch import mesh as ref_mesh
from repro.serve.retrieval import RetrievalService as RefService
from repro_torch.core.batched import lifecycle
from repro_torch.core.batched.sharded import (ShardedEngine,
                                              build_sharded_index)
from repro_torch.core.config import FnsConfig
from repro_torch.core.search import SearchParams
from repro_torch.core.types import Dataset, FilterPredicate, Query, normalize
from repro_torch.interop import queries_from_reference
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.mesh import make_local_mesh, make_serving_mesh
from repro_torch.launch.shardings import index_shardings
from repro_torch.serve.retrieval import RetrievalService

from test_torch_sharded import assert_search_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = {"graph.graph_k": 16, "graph.r_max": 48, "walk.k": 10,
         "walk.beam_width": 4}
SELS = (0.5, 0.1, 0.02)
# name: (mesh maker, data-axis size, query lanes): 1D over 2 and 4 data
# cells, 2 x 2 data x query, 1 x 4 query-only
MESHES = {
    "data2": (lambda: make_local_mesh(2, devices=["cpu"] * 2), 2, 1),
    "data4": (lambda: make_local_mesh(4, devices=["cpu"] * 4), 4, 1),
    "data2xquery2": (lambda: make_serving_mesh(2, 2, devices=["cpu"] * 4),
                     2, 2),
    "data1xquery4": (lambda: make_serving_mesh(1, 4, devices=["cpu"] * 4),
                     1, 4),
}


def mesh_sweeps():
    """(dataset, reference queries) for the conj, OR and range sweeps, 12
    queries each: the conj sweep at the reference's mesh-test size
    (``tests/test_sharded_engine.py``), OR and range at the parity
    sweeps' (``tests/_torch_parity.py``)."""
    conj = make_selectivity_dataset(SELS, n=1200, d=32, n_components=12)
    ors = add_or_pair_fields(
        make_selectivity_dataset(SELS, n=2400, d=48, n_components=16),
        sels=SELS)
    rng = add_timestamp_field(
        make_selectivity_dataset(SELS, n=2400, d=48, n_components=16))
    return {
        "conj": (conj, [q for v in range(3)
                        for q in make_selectivity_queries(conj, v, 4)]),
        "or": (ors, [q for ci in range(3)
                     for q in make_or_queries(ors, ci + 1, 4)]),
        "range": (rng, [q for sel in SELS
                        for q in make_range_queries(rng, sel, 4)]),
    }


@pytest.fixture(scope="module")
def sweeps():
    return {name: (ds, queries_from_reference(qs))
            for name, (ds, qs) in mesh_sweeps().items()}


@pytest.fixture(scope="module")
def index(sweeps):
    """``index(sweep, n_shards)``: the port's sharded index of a sweep,
    built once per module."""
    built = {}

    def get(sweep, n_shards):
        if (sweep, n_shards) not in built:
            ds, _ = sweeps[sweep]
            built[sweep, n_shards] = build_sharded_index(
                ds.vectors, ds.metadata, n_shards,
                config=FnsConfig().with_knobs(KNOBS), device="cpu")
        return built[sweep, n_shards]
    return get


# -- the mesh helpers ---------------------------------------------------------

def test_mesh_helpers_match_reference(monkeypatch):
    """Axis names, shapes and sizes; the query axis on data x query and
    data x model meshes (a dedicated ``query`` axis wins, ``model`` is
    reused when it is the only one); the same answers from the
    reference's helpers on the port's mesh object; ``query_parallel``
    off; ``index_shardings``' cells; a short device count raises."""
    m1 = make_local_mesh(4, devices=["cpu"] * 4)
    m2 = make_serving_mesh(2, 4, devices=["cpu"] * 8)
    m3 = make_local_mesh(2, 2, devices=["cpu"] * 4)
    assert m1.axis_names == ("data", "model") and m1.devices.shape == (4, 1)
    assert m2.shape == {"data": 2, "query": 4}
    assert all(d == torch.device("cpu") for d in m2.devices.flat)
    for m in (m1, m2, m3, None):
        for fn in ("query_axis_name", "query_axis_size"):
            if m is None and fn == "query_axis_size":
                continue
            assert getattr(port_mesh, fn)(m) == getattr(ref_mesh, fn)(m)
        if m is not None:
            for fn in ("index_axis_size", "data_axis_names"):
                assert getattr(port_mesh, fn)(m) == getattr(ref_mesh, fn)(m)
    assert port_mesh.query_axis_name(m1) is None
    assert port_mesh.query_axis_name(m2) == "query"
    assert port_mesh.query_axis_name(m3) == "model"
    assert port_mesh.query_axis_size(m2) == 4
    assert port_mesh.index_axis_size(m2, "query") == 4
    assert port_mesh.index_axis_size(m2, "pod") == 1

    sh = index_shardings(m2, "data", query_axis="query")
    assert sh.rows.shape == (2, 4) and sh.n_lanes == 4
    assert sh.query_block(12, 2) == slice(6, 9)
    with pytest.raises(ValueError, match="pad it"):
        sh.query_block(10, 0)
    assert index_shardings(m2).rows.shape == (2, 1)

    rng = np.random.default_rng(4)
    vecs = normalize(rng.standard_normal((300, 8)))
    meta = rng.integers(0, 3, (300, 2)).astype(np.int32)
    cfg = FnsConfig().with_knobs({"walk.k": 5, "graph.graph_k": 8})
    sidx = build_sharded_index(vecs, meta, 2, config=cfg, device="cpu")
    assert ShardedEngine(sidx, m3, cfg).q_axis == "model"
    off = ShardedEngine(sidx, m2, cfg.with_knobs(
        {"mesh.query_parallel": False}))
    assert off.q_axis is None and off.q_lanes == 1
    ids, _ = off.search([_query(rng, 8)])   # Q=1 needs no lane split
    assert ids[0].size == 5

    # a short device count raises; there is no quiet fallback
    with pytest.raises(ValueError, match="given 3 devices"):
        make_local_mesh(4, devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        make_serving_mesh(1, 2)
    assert make_local_mesh(1).devices[0, 0] == torch.device("cuda", 0)


def _query(rng, d):
    return Query(vector=normalize(rng.standard_normal(d)).astype(np.float32),
                 predicate=FilterPredicate.make({}))


# -- the mesh engine against the port's reference mode ------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("sweep", ["conj", "or", "range"])
def test_mesh_matches_reference_mode(sweeps, index, mesh_name, sweep):
    """The mesh engine returns reference mode's ids, walks and hops on the
    same index; it counts one dispatch a batch, reference mode one a
    shard. On the lane meshes a batch of 7 (not a multiple of the lanes)
    is padded, and the pads never reach the results or the stats."""
    make, n_shards, lanes = MESHES[mesh_name]
    sidx = index(sweep, n_shards)
    cfg = FnsConfig().with_knobs(KNOBS)
    _, queries = sweeps[sweep]
    ref = ShardedEngine(sidx, None, cfg, device="cpu")
    eng = ShardedEngine(sidx, make(), cfg)
    assert eng.q_lanes == lanes and eng.device == torch.device("cpu")
    out = eng.search(queries)
    assert eng.dispatches == 1
    want = ref.search(queries)
    assert ref.dispatches == n_shards
    assert_search_equal(want, out, f"{mesh_name}/{sweep}")
    assert_search_equal(want, eng.search_reference(queries), "reference")
    assert eng.dispatches == 1
    assert sum(i.size > 0 for i in out[0]) == len(queries)
    if lanes > 1:
        out7 = eng.search(queries[:7])
        assert eng.dispatches == 2
        assert len(out7[0]) == 7 and out7[1]["walks"].shape == (7,)
        assert_search_equal(ref.search(queries[:7]), out7, "Q=7")


def test_cells_share_one_copy(index):
    """Cells on the index's own device take views of its stacked tensors
    (no copy); the lanes of one shard share one set of tensors."""
    sidx = index("conj", 2)
    eng = ShardedEngine(sidx, make_serving_mesh(2, 2, devices=["cpu"] * 4),
                        FnsConfig().with_knobs(KNOBS))
    for s in range(2):
        a, b = eng._cells[s]
        assert a.vectors is b.vectors and a.datlas.centroids is \
            b.datlas.centroids
        assert a.vectors.untyped_storage().data_ptr() == \
            sidx.vectors.untyped_storage().data_ptr()
        np.testing.assert_array_equal(a.vectors.numpy(),
                                      sidx.vectors[s].numpy())


# -- the mesh engine against the reference's shard_map program ----------------

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys; sys.path.insert(0, "src"); sys.path.insert(0, "tests")
    import numpy as np
    from repro.core.batched.sharded import ShardedEngine, build_sharded_index
    from repro.core.config import FnsConfig
    from repro.launch.mesh import make_local_mesh, make_serving_mesh
    from test_torch_mesh import KNOBS, mesh_sweeps

    cfg = FnsConfig().with_knobs(KNOBS)
    out = {}
    for mesh_name, mesh, s in (
            ("local4", make_local_mesh(data=4, model=1), 4),
            ("serving2x4", make_serving_mesh(data=2, query=4), 2)):
        for sweep, (ds, qs) in mesh_sweeps().items():
            sidx = build_sharded_index(ds.vectors, ds.metadata, s,
                                       config=cfg)
            eng = ShardedEngine(sidx, mesh, cfg)
            subs = {"": qs, "_q7": qs[:7]} if s == 2 else {"": qs}
            for tag, sub in subs.items():
                ids, st = eng.search(sub)
                key = f"{mesh_name}_{sweep}{tag}"
                out[key + "_ids"] = np.stack([
                    np.pad(np.asarray(r, np.int32), (0, 10 - len(r)),
                           constant_values=-1) for r in ids])
                out[key + "_walks"] = np.asarray(st["walks"])
                out[key + "_hops"] = np.asarray(st["hops"])
            assert eng.dispatches == len(subs), eng.dispatches
    np.savez(sys.argv[1], **out)
    print("reference-mesh ok")
""")


@pytest.fixture(scope="module")
def reference_mesh_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref_mesh") / "out.npz")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, path],
                       capture_output=True, text=True, timeout=420,
                       cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "reference-mesh ok" in r.stdout
    return dict(np.load(path))


@pytest.mark.parametrize("mesh_name", ["local4", "serving2x4"])
def test_mesh_matches_reference_package(sweeps, index, reference_mesh_run,
                                        mesh_name):
    """The reference's ``ShardedEngine`` on 8 virtual CPU devices
    (``make_local_mesh(4, 1)``, ``make_serving_mesh(2, 4)``) and the
    port's on the same meshes of CPU cells: ids, walks and hops equal on
    conj, OR and range, and on the 2 x 4 mesh for a lane-padded batch of
    7."""
    want = reference_mesh_run
    s = 4 if mesh_name == "local4" else 2
    mesh = (make_local_mesh(4, devices=["cpu"] * 4) if s == 4
            else make_serving_mesh(2, 4, devices=["cpu"] * 8))
    for sweep in ("conj", "or", "range"):
        eng = ShardedEngine(index(sweep, s), mesh,
                            FnsConfig().with_knobs(KNOBS))
        _, queries = sweeps[sweep]
        for tag, sub in ({"": queries, "_q7": queries[:7]} if s == 2
                         else {"": queries}).items():
            ids, st = eng.search(sub)
            key = f"{mesh_name}_{sweep}{tag}"
            got = np.stack([np.pad(r.astype(np.int32), (0, 10 - len(r)),
                                   constant_values=-1) for r in ids])
            np.testing.assert_array_equal(got, want[key + "_ids"], key)
            np.testing.assert_array_equal(st["walks"], want[key + "_walks"])
            np.testing.assert_array_equal(st["hops"], want[key + "_hops"])


# -- the live index on a mesh -------------------------------------------------

def test_live_index_on_mesh_matches_reference_mode():
    """Insert (inline repair), delete, compact (publishing only the
    compacted shards), refill and grow past capacity, on a 2 x 2 mesh and
    in reference mode from the same build: equal searches after every
    step, and every cell holds exactly reference mode's shard."""
    from test_insert import _full_dataset
    from test_torch_lifecycle import _batches

    ds = add_timestamp_field(_full_dataset(), domain=1024)
    knobs = {**KNOBS, "atlas.v_cap": 1024, "serve.capacity": 1000}
    cfg = FnsConfig().with_knobs(knobs)
    sidx = build_sharded_index(ds.vectors[:750], ds.metadata[:750], 2,
                               config=cfg, device="cpu")
    sidx_ref = copy.deepcopy(sidx)
    eng = ShardedEngine(sidx, make_serving_mesh(2, 2, devices=["cpu"] * 4),
                        cfg)
    ref = ShardedEngine(sidx_ref, None, cfg, device="cpu")
    batches = {name: queries_from_reference(qs)
               for name, qs in _batches(ds).items()}

    def check(tag):
        assert eng.n == ref.n and eng.vocab_sizes == ref.vocab_sizes
        assert eng.publish_generation == ref.publish_generation
        for s in range(2):
            want = ref._cell(s)
            for cell in eng._cells[s]:
                for name in ("vectors", "adjacency", "metadata",
                             "global_ids", "valid_bm"):
                    assert torch.equal(getattr(cell, name),
                                       getattr(want, name)), (tag, s, name)
                for a, b in zip(cell.datlas.leaves(), want.datlas.leaves()):
                    assert torch.equal(a, b), (tag, s)
        for name, qs in batches.items():
            assert_search_equal(ref.search(qs), eng.search(qs),
                                f"{tag}/{name}")

    both = (eng, ref)
    check("build")
    g = [e.insert_batch(ds.vectors[750:875], ds.metadata[750:875])
         for e in both]
    np.testing.assert_array_equal(g[0], g[1])
    check("insert")
    dead = np.sort(np.random.default_rng(5).choice(875, 120, replace=False))
    assert [e.delete_batch(dead) for e in both] == [120, 120]
    check("delete")
    for e in both:
        rep = lifecycle.compact_state(e.state, force=True)
        assert rep["reclaimed"] == 120
        e.refresh_device(rep["shards"])
    check("compact")
    for e in both:
        e.insert_batch(ds.vectors[875:1000], ds.metadata[875:1000])
    check("refill")
    rng = np.random.default_rng(3)
    extra = normalize(rng.standard_normal((200, ds.d))).astype(np.float32)
    for e in both:
        e.insert_batch(extra, ds.metadata[:200].copy())
    assert eng.state.shards[0].cap > 500
    assert eng.insert_stats["slab_growths"] == 1
    assert eng.cfg.flatten() == ref.cfg.flatten()
    check("grow")


# -- serving over a mesh ------------------------------------------------------

GRAPH = dict(graph_k=12, r_max=36)
CHUNK = 40
BASE_N = 480


@pytest.fixture(scope="module")
def durable_ds():
    return make_selectivity_dataset(SELS, n=600, d=32, n_components=12,
                                    seed=11)


@pytest.fixture(scope="module")
def labeled(durable_ds):
    return [(f"sel{sel}", q) for code, sel in enumerate(SELS)
            for q in queries_from_reference(
                make_selectivity_queries(durable_ds, code, 6))]


def _service(ds, n_rows, mesh=None):
    base = Dataset(ds.vectors[:n_rows], ds.metadata[:n_rows],
                   ds.field_names, list(ds.vocab_sizes))
    return RetrievalService.build(
        base, params=SearchParams(k=10, max_hops=80), mesh=mesh,
        capacity=ds.n, device=None if mesh is not None else "cpu", **GRAPH)


def _query_ids(svc, labeled):
    ids, _ = svc.query_batch(np.stack([q.vector for _, q in labeled]),
                             [q.predicate for _, q in labeled])
    return ids


def _same_ids(a_ids, b_ids):
    assert len(a_ids) == len(b_ids)
    for i, (a, b) in enumerate(zip(a_ids, b_ids)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"query {i}")


def _recalls(svc, ds, labeled, n_valid):
    from test_insert import _grouped_recalls

    return _grouped_recalls(labeled, _query_ids(svc, labeled), ds.vectors,
                            ds.metadata, n_valid, tuple(ds.vocab_sizes))


def test_recover_cross_mesh(durable_ds, labeled, tmp_path):
    """A 4-shard snapshot onto a 4-cell mesh and onto no mesh, both
    bit-identical to the writer; a 1-shard snapshot onto the 4-cell mesh
    (empty slabs padded on): recall within 0.02 of the writer's, and the
    padded shards fill on later ingests."""
    ds = durable_ds
    mesh = make_local_mesh(4, devices=["cpu"] * 4)
    svc = _service(ds, BASE_N, mesh=mesh)
    assert svc.index is None   # the global graph is never built
    svc.enable_durability(str(tmp_path / "m4"))
    svc.ingest(ds.vectors[BASE_N:BASE_N + CHUNK],
               ds.metadata[BASE_N:BASE_N + CHUNK])
    ids0 = _query_ids(svc, labeled)
    assert svc._sharded.n_shards == 4 and svc._sharded.mesh is mesh
    svc_m = RetrievalService.recover(str(tmp_path / "m4"), mesh=mesh)
    assert svc_m._sharded.mesh is mesh
    _same_ids(ids0, _query_ids(svc_m, labeled))
    assert svc_m.staleness() == svc.staleness()
    svc_r = RetrievalService.recover(str(tmp_path / "m4"), device="cpu")
    assert svc_r._sharded.mesh is None and svc_r._sharded.n_shards == 4
    _same_ids(ids0, _query_ids(svc_r, labeled))

    svc1 = _service(ds, BASE_N)
    svc1.enable_durability(str(tmp_path / "m1"))
    svc1.ingest(ds.vectors[BASE_N:BASE_N + CHUNK],
                ds.metadata[BASE_N:BASE_N + CHUNK])
    n_valid = BASE_N + CHUNK
    rec0 = _recalls(svc1, ds, labeled, n_valid)
    svc_p = RetrievalService.recover(str(tmp_path / "m1"), mesh=mesh)
    eng = svc_p._sharded
    assert eng.mesh is mesh and eng.n_shards == 4
    # the snapshot's rows stay on shard 0; the journal's chunk, replayed
    # after the padding, went to the empty slabs
    n_rows = [sh.n_valid for sh in eng.state.shards]
    assert n_rows[0] == BASE_N and sum(n_rows) == n_valid
    rec1 = _recalls(svc_p, ds, labeled, n_valid)
    for label in rec0:
        assert rec1[label] >= rec0[label] - 0.02, (label, rec0, rec1)
    gids = svc_p.ingest(ds.vectors[n_valid:n_valid + CHUNK],
                        ds.metadata[n_valid:n_valid + CHUNK])
    assert svc_p.staleness()["corpus_rows"] == n_valid + CHUNK
    assert sorted(int(g) for g in gids) == list(range(n_valid,
                                                      n_valid + CHUNK))
    assert all(sh.n_valid > n for sh, n in zip(eng.state.shards[1:],
                                                n_rows[1:]))


def test_reference_snapshot_onto_port_mesh(durable_ds, labeled, tmp_path):
    """A snapshot and journal the reference's service wrote (one shard)
    restored by the port onto a 2-cell mesh (an empty slab padded on):
    the ids of the reference's own restore; recovered with the journal
    onto a 2 x 2 mesh (the replayed rows land in the padded slab): the
    reference's recovered corpus, at its recall within 0.02."""
    ds = durable_ds
    base = RefDataset(ds.vectors[:BASE_N], ds.metadata[:BASE_N],
                      ds.field_names, list(ds.vocab_sizes))
    ref = RefService.build(base, params=RefParams(k=10, max_hops=80),
                           capacity=ds.n, **GRAPH)
    root = str(tmp_path / "ref")
    ref.enable_durability(root)
    ref.ingest(ds.vectors[BASE_N:BASE_N + CHUNK],
               ds.metadata[BASE_N:BASE_N + CHUNK])   # journal only
    vecs = np.stack([q.vector for _, q in labeled])
    preds = [q.predicate for _, q in labeled]

    want, _ = RefService.restore(root).query_batch(vecs, preds)
    svc = RetrievalService.restore(
        root, mesh=make_local_mesh(2, devices=["cpu"] * 2))
    assert svc._sharded.n_shards == 2 and svc._live_engine() is svc._sharded
    _same_ids(want, _query_ids(svc, labeled))
    assert svc.staleness()["corpus_rows"] == BASE_N

    ref_rec = RefService.recover(root)
    svc = RetrievalService.recover(
        root, mesh=make_serving_mesh(2, 2, devices=["cpu"] * 4))
    assert svc._sharded.q_lanes == 2
    st, st_ref = svc.staleness(), ref_rec.staleness()
    assert st["corpus_rows"] == st_ref["corpus_rows"] == BASE_N + CHUNK
    assert st["inserted_rows"] == st_ref["inserted_rows"] == CHUNK
    from test_insert import _grouped_recalls

    args = (ds.vectors, ds.metadata, BASE_N + CHUNK, tuple(ds.vocab_sizes))
    rec0 = _grouped_recalls(labeled, ref_rec.query_batch(vecs, preds)[0],
                            *args)
    rec1 = _grouped_recalls(labeled, _query_ids(svc, labeled), *args)
    for label in rec0:
        assert rec1[label] >= rec0[label] - 0.02, (label, rec0, rec1)


def test_query_batch_routes_to_mesh_engine_and_buckets_for_lanes():
    """A service built on a mesh answers ``query_batch`` through the mesh
    engine (the global graph and the single-device engine are never
    built), one dispatch a batch, and its bucket rounds up to a multiple
    of the lanes: 5 queries run as 8 on 4 lanes and as 9 on 3. The
    pipeline forms its batches for the same lanes."""
    from repro_torch.serve.pipeline import ServePipeline

    rng = np.random.default_rng(5)
    n, d = 800, 16
    vecs = normalize(rng.standard_normal((n, d)))
    meta = rng.integers(0, 5, (n, 3)).astype(np.int32)
    ds = Dataset(vecs, meta, [f"f{i}" for i in range(3)], [5] * 3)
    preds = [FilterPredicate.make({0: [i % 5]}) for i in range(5)]
    qv = rng.standard_normal((5, d))
    for mesh, lanes, bucket in (
            (make_local_mesh(4, devices=["cpu"] * 4), 1, 8),
            (make_serving_mesh(2, 4, devices=["cpu"] * 8), 4, 8),
            (make_serving_mesh(2, 3, devices=["cpu"] * 6), 3, 9)):
        svc = RetrievalService.build(ds, graph_k=8, r_max=24,
                                     params=SearchParams(k=5, max_hops=40),
                                     mesh=mesh)
        eng = svc._live_engine()
        assert svc._sharded is eng and eng.q_lanes == lanes
        seen = []
        orig = eng.search
        eng.search = lambda qs, **k: seen.append(len(qs)) or orig(qs, **k)
        try:
            ids, stats = svc.query_batch(qv, preds)
        finally:
            eng.search = orig
        assert seen == [bucket]
        assert svc._engine is None and svc.index is None
        assert eng.dispatches == 1
        assert len(ids) == 5 and stats["walks"].shape == (5,)
        for i, row in enumerate(ids):
            assert row.size > 0 and (meta[row, 0] == i % 5).all()
        assert ServePipeline(svc).queue.q_lanes == lanes
