"""Port ``DeviceAtlas`` vs the reference's, on the same index carried over
through ``repro_torch.interop``: identical packed leaves, and
``select_anchors_batch`` returns IDENTICAL seeds (same order) and ``used``
masks for both seed backends over several restart rounds — conjunctive
(sel_sweep), OR and range batches, and the dominant/rare OR quota case."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.batched.engine import pack_query_batch as ref_pack
from repro.core.device_atlas import DeviceAtlas as RefDeviceAtlas
from repro.core.device_atlas import pack_dnf as ref_pack_dnf
from repro.core.device_atlas import pack_predicates as ref_pack_predicates
from repro.core.predicate import In, Or, as_dnf
from repro_torch.core.atlas import AnchorAtlas
from repro_torch.core.batched.engine import pack_query_batch
from repro_torch.core.device_atlas import MEMBER_CAP, DeviceAtlas
from repro_torch.interop import (device_atlas_from_reference,
                                 queries_from_reference)

from _torch_parity import (build_or_sweep, build_range_sweep, port_side,
                           to_torch)
from test_disjunctive_search import _starved_or_setup

LEAVES = ("centroids", "assign", "csr_pts", "csr_offsets", "inv_perm",
          "presence", "code_min", "code_max")


def _assert_same_leaves(port: DeviceAtlas, ref) -> None:
    assert port.v_cap == ref.v_cap
    for name in LEAVES:
        got = getattr(port, name).numpy()
        want = np.asarray(getattr(ref, name))
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=name)


def _rounds(ref_datlas, port_datlas, q_vecs, ref_tables, vectors, passes,
            rounds=3, **kw):
    """Run ``rounds`` selection rounds on both, OR-ing ``used`` into the
    processed mask each time; assert identical seeds and used masks."""
    q_n, k = q_vecs.shape[0], ref_datlas.n_clusters
    proc = np.zeros((q_n, k), bool)
    port_tables = tuple(to_torch(t) for t in ref_tables)
    # one compile for all rounds (op-by-op dispatch recompiles per op)
    ref_select = jax.jit(functools.partial(
        RefDeviceAtlas.select_anchors_batch, **kw))
    for r in range(rounds):
        s_r, u_r = ref_select(
            ref_datlas, jnp.asarray(q_vecs),
            tuple(jnp.asarray(t) for t in ref_tables), jnp.asarray(proc),
            jnp.asarray(vectors), jnp.asarray(passes))
        s_p, u_p = port_datlas.select_anchors_batch(
            torch.from_numpy(q_vecs), port_tables, torch.from_numpy(proc),
            torch.from_numpy(vectors), torch.from_numpy(passes), **kw)
        np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_r),
                                      err_msg=f"seeds, round {r}")
        np.testing.assert_array_equal(u_p.numpy(), np.asarray(u_r),
                                      err_msg=f"used, round {r}")
        proc = proc | np.asarray(u_r)
    return proc


@pytest.fixture(scope="module")
def sweep_atlases(sel_sweep):
    ds, index, queries = sel_sweep
    pidx, pq = port_side(index, queries)
    return (ds, index, queries, index.atlas.to_device(),
            pidx.atlas.to_device(device="cpu"))


def test_packed_atlas_leaves_identical(sweep_atlases):
    _, index, _, ref_datlas, port_datlas = sweep_atlases
    _assert_same_leaves(port_datlas, ref_datlas)
    # the interop route (reference leaves via np.asarray) gives the same
    _assert_same_leaves(device_atlas_from_reference(ref_datlas, "cpu"),
                        ref_datlas)


@pytest.mark.parametrize("backend", ["sort", "topk"])
@pytest.mark.parametrize("n_seeds,c_max", [(10, 5), (3, 1)])
def test_conjunctive_selection_identical(sweep_atlases, backend, n_seeds,
                                         c_max):
    ds, _, queries, ref_datlas, port_datlas = sweep_atlases
    q_vecs = np.stack([q.vector for q in queries])
    tables = ref_pack_predicates([q.predicate for q in queries],
                                 max_clauses=4, v_cap=ref_datlas.v_cap)
    passes = np.stack([q.predicate.mask(ds.metadata) for q in queries])
    proc = _rounds(ref_datlas, port_datlas, q_vecs, tables, ds.vectors,
                   passes, rounds=4, n_seeds=n_seeds, c_max=c_max,
                   backend=backend)
    # later rounds really ran: some queries consumed more than one round's
    assert (proc.sum(axis=1) > c_max).any()


@pytest.fixture(scope="module")
def or_side():
    ds, index, queries = build_or_sweep()
    pidx, _ = port_side(index, queries)
    return ds, index, queries, index.atlas.to_device(), \
        pidx.atlas.to_device(device="cpu")


@pytest.fixture(scope="module")
def range_side():
    ds, index, queries = build_range_sweep()
    pidx, _ = port_side(index, queries)
    return ds, index, queries, index.atlas.to_device(), \
        pidx.atlas.to_device(device="cpu")


@pytest.mark.parametrize("backend", ["sort", "topk"])
@pytest.mark.parametrize("side", ["or_side", "range_side"])
def test_dnf_selection_identical(request, side, backend):
    """OR tables (rank 3) and interval tables (rank 3 + bounds), packed by
    both packages' ``pack_query_batch`` (identical tables), then selection
    over several rounds."""
    ds, _, queries, ref_datlas, port_datlas = request.getfixturevalue(side)
    _assert_same_leaves(port_datlas, ref_datlas)
    _, f, a, b = ref_pack(queries, v_cap=ref_datlas.v_cap,
                          vocab_sizes=ds.vocab_sizes)
    pq = queries_from_reference(queries)
    _, pf, pa, pb = pack_query_batch(pq, v_cap=port_datlas.v_cap,
                                     vocab_sizes=ds.vocab_sizes,
                                     device="cpu")
    tables = (f, a) if b is None else (f, a, b)
    port_tables = (pf, pa) if pb is None else (pf, pa, pb)
    assert len(tables) == (3 if side == "range_side" else 2)
    for got, want in zip(port_tables, tables):
        np.testing.assert_array_equal(got.numpy(), to_torch(want).numpy())
    q_vecs = np.stack([q.vector for q in queries])
    passes = np.stack([q.predicate.mask(ds.metadata, ds.vocab_sizes)
                       for q in queries])
    _rounds(ref_datlas, port_datlas, q_vecs, tables, ds.vectors, passes,
            rounds=3, n_seeds=10, c_max=5, backend=backend)


@pytest.mark.parametrize("quota", [0, 2])
@pytest.mark.parametrize("backend", ["sort", "topk"])
def test_disjunct_quota_selection_identical(quota, backend):
    """The engineered dominant/rare OR case: without a quota the rare
    disjunct starves, with it the rare cluster is force-visited; the port
    must pick the same seeds and consume the same clusters either way."""
    vecs, meta, atlas, rare_ids = _starved_or_setup()
    pred = Or(In(0, [1]), In(1, [1]))
    ref_datlas = RefDeviceAtlas.from_atlas(atlas)
    port_datlas = DeviceAtlas.from_atlas(
        AnchorAtlas(atlas.centroids, atlas.assign, atlas.members,
                    atlas.cluster_index), device="cpu")
    _assert_same_leaves(port_datlas, ref_datlas)
    f_np, a_np, _, _ = ref_pack_dnf([as_dnf(pred, [2, 2])],
                                    v_cap=ref_datlas.v_cap)
    q = np.eye(vecs.shape[1], dtype=np.float32)[:1]
    passes = pred.mask(meta, [2, 2])[None]
    _rounds(ref_datlas, port_datlas, q, (f_np, a_np), vecs, passes,
            rounds=2, n_seeds=10, c_max=5, backend=backend,
            disjunct_quota=quota)
    s, _ = port_datlas.select_anchors_batch(
        torch.from_numpy(q), (to_torch(f_np), to_torch(a_np)),
        torch.zeros((1, 3), dtype=torch.bool), torch.from_numpy(vecs),
        torch.from_numpy(passes), n_seeds=10, c_max=5, backend=backend,
        disjunct_quota=quota)
    assert np.isin(s.numpy(), rare_ids).sum() == (2 if quota else 0)


@pytest.mark.parametrize("used_from", ["selection", "nothing"])
def test_disjunct_quota_kernel_route_matches_dense(or_side, used_from):
    """Where there is no dense score product (``sims`` None: the topk
    backend on CUDA), each disjunct's quota sweep is a masked_cosine_topk
    call over its one-cluster mask. Here that call takes the plain version,
    and the repaired seeds and ``used`` masks must equal the dense route's:
    after a real first-round selection (no disjunct starved here, so the
    seeds pass through) and with nothing visited (every live disjunct
    starved)."""
    ds, _, queries, _, port_datlas = or_side
    pq = queries_from_reference(queries)
    q_vecs, f, a, _ = pack_query_batch(pq, v_cap=port_datlas.v_cap,
                                       vocab_sizes=ds.vocab_sizes,
                                       device="cpu")
    assert f.ndim == 3
    vectors = torch.from_numpy(ds.vectors)
    passes = torch.from_numpy(np.stack(
        [q.predicate.mask(ds.metadata, ds.vocab_sizes) for q in queries]))
    processed = torch.zeros((len(queries), port_datlas.n_clusters),
                            dtype=torch.bool)
    seeds, used = port_datlas.select_anchors_batch(
        q_vecs, (f, a), processed, vectors, passes, n_seeds=10, c_max=5,
        backend="topk", disjunct_quota=0)
    if used_from == "nothing":
        used = torch.zeros_like(used)
        seeds = torch.full_like(seeds, -1)
    dmasks = port_datlas._disjunct_cluster_masks(f, a, None)
    _, rank_id = port_datlas._matched_counts(passes)
    scores = q_vecs @ port_datlas.centroids.T
    out = {}
    for route, sims in (("kernel", None), ("dense", q_vecs @ vectors.T)):
        out[route] = port_datlas._apply_disjunct_quota(
            q_vecs, dmasks, processed, vectors, sims, passes, rank_id,
            scores, used, seeds, n_seeds=10, member_cap=MEMBER_CAP, quota=2)
    for got, want in zip(out["kernel"], out["dense"]):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    if used_from == "nothing":  # the repair did something
        assert not torch.equal(out["dense"][1], used)
        assert bool((out["dense"][0] >= 0).any())
