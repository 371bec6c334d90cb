"""The port's sharded engine in reference mode (``ShardedEngine(mesh=None)``,
every shard on one device) beside the reference's on the same inputs: the
sharded build (stacked arrays and atlas leaves), ``stack_atlases`` /
``pad_rows`` / the per-shard view, ``merge_topk`` (ties included), the
search's ids, walks and hops against the reference's ``search_reference``
on the selectivity, OR and range sweeps for S in {2, 4} and both seed
backends, the tiny-corpus exact case, and the device contract (a mesh of
the wrong size or type raises, the default device is CUDA). The live
sharded index is ``test_torch_sharded_lifecycle.py``; the mesh engine is
``test_torch_mesh.py``.

Everything runs on the CPU through the plain PyTorch versions, so exact
equality is the bar.
"""
import numpy as np
import pytest
import torch

from repro.core.batched.sharded import ShardedEngine as RefEngine
from repro.core.batched.sharded import build_sharded_index as ref_build
from repro.core.batched.sharded import merge_topk as ref_merge
from repro.core.config import FnsConfig as RefConfig
from repro.core.device_atlas import DeviceAtlas as RefAtlas
from repro.core.device_atlas import stack_atlases as ref_stack
from repro.core.types import FilterPredicate, Query, normalize
from repro_torch.core.batched.sharded import (ShardedEngine,
                                              build_sharded_index,
                                              merge_topk)
from repro_torch.core.config import FnsConfig
from repro_torch.core.device_atlas import DeviceAtlas, stack_atlases
from repro_torch.interop import (bitmap_to_numpy, queries_from_reference,
                                 sharded_index_from_reference)

from _torch_parity import build_or_sweep, build_range_sweep

KNOBS = {"graph.graph_k": 16, "graph.r_max": 48, "walk.k": 10,
         "walk.beam_width": 4}
LEAVES = ("centroids", "assign", "csr_pts", "csr_offsets", "inv_perm",
          "presence", "code_min", "code_max")


def _leaf_np(atlas, name) -> np.ndarray:
    """An atlas leaf of either package as numpy (bitmaps as uint32)."""
    x = getattr(atlas, name)
    if isinstance(x, torch.Tensor):
        return (bitmap_to_numpy(x) if name == "presence"
                else x.numpy())
    return np.asarray(x)


def assert_atlas_equal(port, ref, tag=""):
    for name in LEAVES:
        np.testing.assert_array_equal(_leaf_np(port, name),
                                      _leaf_np(ref, name),
                                      err_msg=f"{tag} datlas.{name}")
    assert port.v_cap == ref.v_cap


def assert_index_equal(port, ref, tag=""):
    """Stacked arrays, validity bitmaps and atlas leaves bit-identical."""
    for name in ("vectors", "adjacency", "metadata", "global_ids"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=f"{tag} {name}")
    np.testing.assert_array_equal(bitmap_to_numpy(port.valid_bm),
                                  np.asarray(ref.valid_bm),
                                  err_msg=f"{tag} valid_bm")
    assert_atlas_equal(port.datlas, ref.datlas, tag)
    assert port.n == ref.n


def assert_search_equal(ref_out, port_out, tag=""):
    (ids_r, st_r), (ids_p, st_p) = ref_out, port_out
    assert len(ids_p) == len(ids_r)
    for i, (a, b) in enumerate(zip(ids_r, ids_p)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=f"{tag}[{i}]")
    np.testing.assert_array_equal(st_p["walks"], st_r["walks"],
                                  err_msg=f"{tag} walks")
    np.testing.assert_array_equal(st_p["hops"], st_r["hops"],
                                  err_msg=f"{tag} hops")


# -- the sharded build ------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("capacity", [None, 2600])
def test_build_sharded_index_bit_identical(sel_sweep, n_shards, capacity):
    ds, _, _ = sel_sweep
    knobs = {**KNOBS, "serve.capacity": capacity}
    ref = ref_build(ds.vectors, ds.metadata, n_shards,
                    config=RefConfig().with_knobs(knobs))
    port = build_sharded_index(ds.vectors, ds.metadata, n_shards,
                               config=FnsConfig().with_knobs(knobs),
                               device="cpu")
    assert port.n_shards == n_shards
    assert port.rows_per_shard == -(-(capacity or ds.n) // n_shards)
    assert_index_equal(port, ref)
    assert port.vocab_sizes == tuple(ref.vocab_sizes)
    assert (port.insert_state is None) == (capacity is None)
    if capacity is not None:
        for p, r in zip(port.insert_state.shards, ref.insert_state.shards):
            for name in ("vectors", "adjacency", "metadata", "global_ids",
                         "live"):
                np.testing.assert_array_equal(getattr(p, name),
                                              getattr(r, name))
        assert port.insert_state.stats() == ref.insert_state.stats()
    # the carried-over reference index is the same index
    assert_index_equal(sharded_index_from_reference(ref, "cpu"), ref)


def test_stack_pad_and_shard_view(sel_sweep):
    """Two atlases of different row counts padded to a common m and
    stacked: identical to the reference; ``shard(s)`` gives back each
    padded atlas as contiguous views into the stack."""
    from repro.core import AnchorAtlas as RefAnchorAtlas
    from repro.core.types import Dataset as RefDataset
    from repro_torch.core.atlas import AnchorAtlas
    from repro_torch.core.types import Dataset

    ds, _, _ = sel_sweep
    ref_atlases, port_atlases = [], []
    for lo, hi in [(0, 1100), (1100, 2400)]:
        args = (ds.vectors[lo:hi], ds.metadata[lo:hi], ds.field_names,
                list(ds.vocab_sizes))
        ra = RefAnchorAtlas.build(RefDataset(*args), n_clusters=30, seed=0)
        pa = AnchorAtlas.build(Dataset(*args), n_clusters=30, seed=0)
        rd = RefAtlas.from_atlas(ra, v_cap=64).pad_rows(1300)
        pd = DeviceAtlas.from_atlas(pa, v_cap=64, device="cpu")
        pd = pd.pad_rows(1300)
        assert_atlas_equal(pd, rd, f"pad_rows {lo}:{hi}")
        assert pd.pad_rows(1300) is pd
        ref_atlases.append(rd)
        port_atlases.append(pd)
    with pytest.raises(ValueError, match="pad_rows"):
        port_atlases[0].pad_rows(10)
    stacked = stack_atlases(port_atlases)
    assert_atlas_equal(stacked, ref_stack(ref_atlases), "stack")
    for s, pd in enumerate(port_atlases):
        view = stacked.shard(s)
        assert_atlas_equal(view, ref_atlases[s], f"shard({s})")
        for leaf, whole in zip(view.leaves(), stacked.leaves()):
            assert leaf.is_contiguous()
            assert leaf.untyped_storage().data_ptr() == \
                whole.untyped_storage().data_ptr()
    assert_atlas_equal(stack_atlases([stacked.shard(s) for s in (0, 1)]),
                       ref_stack(ref_atlases), "round trip")
    odd = DeviceAtlas(*port_atlases[1].leaves(), v_cap=128)
    with pytest.raises(ValueError, match="v_cap"):
        stack_atlases([port_atlases[0], odd])
    with pytest.raises(ValueError, match="shapes"):
        stack_atlases([port_atlases[0], port_atlases[1].pad_rows(1400)])


@pytest.mark.parametrize("case", ["random", "ties"])
def test_merge_topk_identical(case):
    """(S, Q, k) per-shard results -> the reference's merge exactly; the
    tie-heavy case draws values from a handful of levels plus the INF
    sentinel, so most of the k winners tie and the order among them is
    shard-major."""
    rng = np.random.default_rng(11)
    s, q_n, k_in, k = 4, 16, 10, 10
    if case == "random":
        v = rng.random((s, q_n, k_in), dtype=np.float32)
    else:
        v = rng.choice(np.array([0.25, 0.5, 0.75, 3.4e38], np.float32),
                       (s, q_n, k_in))
    v = np.sort(v, axis=2)
    i = rng.permutation(s * q_n * k_in).astype(np.int32).reshape(v.shape)
    i[v >= 3.4e38] = -1
    rv, ri = ref_merge(v, i, k)
    pv, pi = merge_topk(torch.from_numpy(v), torch.from_numpy(i), k)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


# -- the search -------------------------------------------------------------

def _engines(ref_sidx, seed_backend=None):
    ref = RefEngine(ref_sidx, None, RefConfig().with_knobs(KNOBS),
                    seed_backend=seed_backend)
    port = ShardedEngine(sharded_index_from_reference(ref_sidx, "cpu"),
                         None, FnsConfig().with_knobs(KNOBS),
                         seed_backend=seed_backend, device="cpu")
    return ref, port


def _sweep_index(ds, n_shards):
    return ref_build(ds.vectors, ds.metadata, n_shards,
                     config=RefConfig().with_knobs(KNOBS))


@pytest.fixture(scope="module")
def or_sweep():
    return build_or_sweep()


@pytest.fixture(scope="module")
def range_sweep():
    return build_range_sweep()


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("seed_backend", ["topk", "sort"])
def test_selectivity_sweep_identical(sel_sweep, n_shards, seed_backend):
    ds, _, queries = sel_sweep
    ref, port = _engines(_sweep_index(ds, n_shards), seed_backend)
    d0 = port.dispatches
    port_out = port.search(queries_from_reference(queries))
    assert port.dispatches - d0 == n_shards
    assert_search_equal(ref.search_reference(queries), port_out,
                        f"S={n_shards}/{seed_backend}")
    assert sum(i.size > 0 for i in port_out[0]) == len(queries)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("sweep", ["or", "range"])
def test_or_and_range_sweeps_identical(request, n_shards, sweep):
    ds, _, queries = request.getfixturevalue(f"{sweep}_sweep")
    ref, port = _engines(_sweep_index(ds, n_shards))
    out_p = port.search(queries_from_reference(queries))
    assert_search_equal(ref.search_reference(queries), out_p,
                        f"{sweep} S={n_shards}")
    # search_reference is the same program without fence or counting
    d0 = port.dispatches
    assert_search_equal(out_p, port.search_reference(
        queries_from_reference(queries)), f"{sweep} search_reference")
    assert port.dispatches == d0


def test_tiny_corpus_many_shards_exact():
    """A corpus barely larger than the shard count: every shard is
    exhaustively seeded, so the merged result is the exact top-k."""
    rng = np.random.default_rng(0)
    vecs = normalize(rng.standard_normal((10, 8)))
    meta = rng.integers(0, 3, (10, 2)).astype(np.int32)
    cfg = FnsConfig().with_knobs({"graph.graph_k": 4, "graph.r_max": 8,
                                  "walk.k": 3, "walk.beam_width": 2})
    sidx = build_sharded_index(vecs, meta, 4, config=cfg, device="cpu")
    eng = ShardedEngine(sidx, None, cfg, device="cpu")
    q = Query(vector=normalize(rng.standard_normal(8)).astype(np.float32),
              predicate=FilterPredicate.make({}))
    ids, _ = eng.search(queries_from_reference([q]))
    exact = np.argsort(-(vecs @ q.vector))[:3]
    assert set(ids[0].tolist()) == set(exact.tolist())


def test_mesh_device_and_capacity_errors(monkeypatch):
    """A mesh whose data axis is not the shard count raises
    ``ValueError`` (as the reference's does), anything but a ``Mesh``
    ``TypeError``, and a mesh with a ``device`` ``ValueError``; a
    build-once index refuses inserts and deletes; the default device is
    CUDA, which raises where there is none."""
    from repro_torch.launch.mesh import make_local_mesh

    rng = np.random.default_rng(1)
    vecs = normalize(rng.standard_normal((40, 8)))
    meta = rng.integers(0, 3, (40, 2)).astype(np.int32)
    cfg = FnsConfig().with_knobs({"graph.graph_k": 4, "graph.r_max": 8})
    sidx = build_sharded_index(vecs, meta, 2, config=cfg, device="cpu")
    with pytest.raises(ValueError, match="2 shards but mesh axis 'data'"):
        ShardedEngine(sidx, make_local_mesh(4, devices=["cpu"] * 4), cfg)
    with pytest.raises(TypeError, match="Mesh"):
        ShardedEngine(sidx, object(), cfg, device="cpu")
    with pytest.raises(ValueError, match="device=None"):
        ShardedEngine(sidx, make_local_mesh(2, devices=["cpu"] * 2), cfg,
                      device="cpu")
    eng = ShardedEngine(sidx, None, cfg, device="cpu")
    with pytest.raises(ValueError, match="serve.capacity"):
        eng.insert_batch(vecs[:2], meta[:2])
    with pytest.raises(ValueError, match="serve.capacity"):
        eng.delete_batch([0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedEngine(sidx, None, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_sharded_index(vecs, meta, 2, config=cfg)
