"""The port's sequential search path against the reference's, on the same
numpy-seeded index and queries: ``search``/``run_queries`` (ids, sims and
every ``SearchStats``/``WalkStats`` field) for the beam and the guided
walk on conjunctive, OR and range predicates; the stall tables; the HNSW
baseline (graph, levels, all three searches); and the batched engine's
``search_hostloop`` against the port's ``search`` and the reference's
``search_hostloop``. Every comparison is exact."""
import dataclasses

import numpy as np
import pytest

from repro.core import stall as ref_stall
from repro.core.batched.engine import BatchedEngine as RefEngine
from repro.core.config import FnsConfig as RefConfig
from repro.core.config import WalkConfig as RefWalk
from repro.core.hnsw import HNSW as RefHNSW
from repro.core.search import SearchParams as RefParams
from repro.core.search import run_queries as ref_run_queries
from repro.core.search import search as ref_search
from repro.data.ground_truth import recall_at_k
from repro_torch.core import stall
from repro_torch.core.batched.engine import BatchedEngine
from repro_torch.core.config import FnsConfig, WalkConfig
from repro_torch.core.hnsw import HNSW
from repro_torch.core.search import SearchParams, run_queries, search
from repro_torch.interop import predicate_from_reference

from _torch_parity import build_or_sweep, build_range_sweep, port_side


@pytest.fixture(scope="module")
def or_sweep():
    return build_or_sweep()


@pytest.fixture(scope="module")
def range_sweep():
    return build_range_sweep()


def _sweep(request, name):
    return request.getfixturevalue(name)


def _stats_dict(st) -> dict:
    return dataclasses.asdict(st)


# walk, extra SearchParams knobs
WALKS = {
    "guided": dict(walk="guided", beam_width=4),
    "beam": dict(walk="beam", beam_width=40),
    "guided_refine": dict(walk="guided", beam_width=2, refine_rounds=2),
    "restarts": dict(walk="guided", beam_width=2, n_seeds=2, c_max=1,
                     max_hops=4),
}


@pytest.mark.parametrize("sweep", ["sel_sweep", "or_sweep", "range_sweep"])
@pytest.mark.parametrize("walk", list(WALKS))
def test_search_identical(request, sweep, walk):
    """``search`` on every query: the same ids in the same order, the same
    sims, and equal stats (walks, hops, per-walk termination and stall
    diagnostics, recall after each walk)."""
    ds, index, queries = _sweep(request, sweep)
    knobs = dict(k=10, **WALKS[walk])
    pidx, pq = port_side(index, queries)
    ref_p, port_p = RefParams(**knobs), SearchParams(**knobs)
    most_walks = 0
    for qi, (q, p) in enumerate(zip(queries, pq)):
        ids_r, sims_r, st_r = ref_search(index, q.vector, q.predicate,
                                         ref_p, gt_ids=q.gt_ids, seed=qi)
        ids_p, sims_p, st_p = search(pidx, p.vector, p.predicate, port_p,
                                     gt_ids=p.gt_ids, seed=qi)
        np.testing.assert_array_equal(ids_p, ids_r, err_msg=f"query {qi}")
        np.testing.assert_array_equal(sims_p, sims_r, err_msg=f"query {qi}")
        np.testing.assert_equal(_stats_dict(st_p), _stats_dict(st_r))
        most_walks = max(most_walks, st_p.n_walks)
    if walk == "restarts":  # the tiny walk budget forces restarts
        assert most_walks > 1


@pytest.mark.parametrize("walk", ["guided", "beam"])
def test_run_queries_identical(sel_sweep, walk):
    """``run_queries`` (seed = query index) on the selectivity sweep."""
    _, index, queries = sel_sweep
    knobs = dict(k=10, **WALKS[walk])
    pidx, pq = port_side(index, queries)
    ids_r, st_r = ref_run_queries(index, queries, RefParams(**knobs))
    ids_p, st_p = run_queries(pidx, pq, SearchParams(**knobs))
    assert len(ids_p) == len(ids_r) == len(queries)
    for a, b, sa, sb in zip(ids_p, ids_r, st_p, st_r):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_equal(_stats_dict(sa), _stats_dict(sb))
    rec = np.mean([recall_at_k(i, q.gt_ids) for i, q in zip(ids_p, queries)])
    assert rec > 0.5


def test_topk_ties_order_like_reference():
    """``_topk_ids`` breaks ties as ``np.argsort(-sims)`` does."""
    from repro.core.search import _topk_ids as ref_topk
    from repro_torch.core.search import _topk_ids

    res = {7: 0.5, 3: 0.5, 9: 0.9, 1: 0.5, 4: 0.1, 2: 0.9}
    for k in (1, 2, 3, 4, 6, 10):
        np.testing.assert_array_equal(_topk_ids(res, k), ref_topk(res, k))
    assert _topk_ids({}, 3).size == 0


@pytest.fixture(scope="module")
def stall_run(small_index, small_queries):
    """Both packages' guided run over the shared 40-query corpus, whose
    selectivities span the paper's bins."""
    params = dict(k=10, walk="guided", beam_width=4)
    pidx, pq = port_side(small_index, small_queries)
    ids_r, st_r = ref_run_queries(small_index, small_queries,
                                  RefParams(**params))
    ids_p, st_p = run_queries(pidx, pq, SearchParams(**params))
    sels = [q.selectivity for q in small_queries]
    recs = [recall_at_k(i, q.gt_ids) for i, q in zip(ids_r, small_queries)]
    return st_r, st_p, sels, recs


def test_stall_tables_identical(stall_run):
    """Per-walk regimes and the paper's three tables (regimes by
    selectivity, stall diagnostics by regime, terminations by
    selectivity) are equal."""
    st_r, st_p, sels, recs = stall_run
    assert stall.REGIMES == ref_stall.REGIMES
    assert stall.SELECTIVITY_BINS == ref_stall.SELECTIVITY_BINS
    for lo, hi in stall.SELECTIVITY_BINS:
        assert stall.bin_name(lo, hi) == ref_stall.bin_name(lo, hi)
    regimes = set()
    for a, b, sel in zip(st_p, st_r, sels):
        for wa, wb in zip(a.walks, b.walks):
            r = stall.classify_stall(wa, sel)
            assert r == ref_stall.classify_stall(wb, sel)
            regimes.add(r)
    assert len(regimes - {None}) >= 2
    np.testing.assert_equal(stall.regimes_by_selectivity(st_p, sels, recs),
                            ref_stall.regimes_by_selectivity(st_r, sels,
                                                             recs))
    np.testing.assert_equal(stall.aggregate_stalls(st_p, sels, recs),
                            ref_stall.aggregate_stalls(st_r, sels, recs))
    np.testing.assert_equal(stall.termination_by_selectivity(st_p, sels),
                            ref_stall.termination_by_selectivity(st_r,
                                                                 sels))


def test_stall_classification_rules():
    """The classifier's thresholds, on hand-made stall points."""
    from repro_torch.core.types import WalkStats

    def ws(rho, bm):
        w = WalkStats()
        w.stall_node, w.stall_rho, w.stall_b_minus = 1, rho, bm
        return w

    assert stall.classify_stall(ws(0.049, 1), 0.1) == "topological_cut"
    assert stall.classify_stall(ws(0.051, 1), 0.1) == "geometric_fold"
    assert stall.classify_stall(ws(0.5, 0), 0.1) == "genuine_basin"
    assert stall.classify_stall(WalkStats(), 0.1) is None


@pytest.fixture(scope="module")
def hnsw_pair(sel_sweep):
    ds, _, _ = sel_sweep
    vecs = ds.vectors[:900]
    return (RefHNSW.build(vecs, m=8, ef_construction=40, seed=3),
            HNSW.build(vecs.copy(), m=8, ef_construction=40, seed=3))


def test_hnsw_build_identical(hnsw_pair):
    ref, port = hnsw_pair
    assert port.entry == ref.entry and port.max_level == ref.max_level
    np.testing.assert_array_equal(port.levels, ref.levels)
    assert port.layers == ref.layers
    g_r, g_p = ref.base_graph(), port.base_graph()
    np.testing.assert_array_equal(g_p.neighbors, g_r.neighbors)
    np.testing.assert_array_equal(g_p.degrees, g_r.degrees)


def test_hnsw_searches_identical(hnsw_pair, sel_sweep):
    """Unfiltered, post-filter and traversal-filter searches."""
    ds, _, queries = sel_sweep
    ref, port = hnsw_pair
    meta = ds.metadata[:900]
    for q in queries[::3]:
        pred = predicate_from_reference(q.predicate)
        ids_r, sims_r = ref.search(q.vector, 10, ef=64)
        ids_p, sims_p = port.search(q.vector, 10, ef=64)
        np.testing.assert_array_equal(ids_p, ids_r)
        np.testing.assert_array_equal(sims_p, sims_r)
        np.testing.assert_array_equal(
            port.search_post_filter(q.vector, pred, meta, 10, ef=64),
            ref.search_post_filter(q.vector, q.predicate, meta, 10, ef=64))
        np.testing.assert_array_equal(
            port.search_traversal_filter(q.vector, pred, meta, 10, ef=64),
            ref.search_traversal_filter(q.vector, q.predicate, meta, 10,
                                        ef=64))


def test_search_on_hnsw_base_layer_identical(hnsw_pair, sel_sweep):
    """The graph-agnostic claim: the guided search over the HNSW base
    layer (and the sweep's atlas restricted to the same rows)."""
    from repro.core import AnchorAtlas, FiberIndex
    from repro.core.types import Dataset

    ds, _, queries = sel_sweep
    ref_h, _ = hnsw_pair
    sub = Dataset(ds.vectors[:900], ds.metadata[:900], ds.field_names,
                  ds.vocab_sizes)
    index = FiberIndex(sub.vectors, sub.metadata, ref_h.base_graph(),
                       AnchorAtlas.build(sub, n_clusters=16, seed=0))
    pidx, pq = port_side(index, queries[::4])
    knobs = dict(k=10, walk="guided", beam_width=4)
    for qi, (q, p) in enumerate(zip(queries[::4], pq)):
        ids_r, sims_r, _ = ref_search(index, q.vector, q.predicate,
                                      RefParams(**knobs), seed=qi)
        ids_p, sims_p, _ = search(pidx, p.vector, p.predicate,
                                  SearchParams(**knobs), seed=qi)
        np.testing.assert_array_equal(ids_p, ids_r)
        np.testing.assert_array_equal(sims_p, sims_r)


# -- the batched engine's host loop ------------------------------------------

HOSTLOOP_WALKS = {"default": dict(k=10, beam_width=4),
                  "restarts": dict(k=10, beam_width=4, n_seeds=2, c_max=1,
                                   max_hops=3)}


@pytest.mark.parametrize("capacity", [None, 2600])
@pytest.mark.parametrize("walk", list(HOSTLOOP_WALKS))
def test_search_hostloop_identical(sel_sweep, walk, capacity):
    """``search_hostloop`` returns the port's ``search`` results and the
    reference's ``search_hostloop`` results (ids, walks, hops), and counts
    dispatches as the reference does."""
    _, index, queries = sel_sweep
    knobs = HOSTLOOP_WALKS[walk]
    serve = {} if capacity is None else {"serve.capacity": capacity}
    ref = RefEngine(index, RefConfig(walk=RefWalk(**knobs)).with_knobs(
        serve))
    pidx, pq = port_side(index, queries)
    port = BatchedEngine(pidx, FnsConfig(walk=WalkConfig(**knobs))
                         .with_knobs(serve), device="cpu")
    ids_f, st_f = port.search(pq)
    assert port.dispatches == 1
    ids_h, st_h = port.search_hostloop(pq)
    ids_r, st_r = ref.search_hostloop(queries)
    assert port.dispatches - 1 == ref.dispatches >= 2
    for i, (a, b, c) in enumerate(zip(ids_h, ids_f, ids_r)):
        np.testing.assert_array_equal(a, b, err_msg=f"query {i}")
        np.testing.assert_array_equal(a, np.asarray(c), err_msg=f"query {i}")
    for key in ("walks", "hops"):
        np.testing.assert_array_equal(st_h[key], st_f[key])
        np.testing.assert_array_equal(st_h[key], st_r[key])
        assert st_h[key].dtype == np.asarray(st_r[key]).dtype
    if walk == "restarts":
        assert (st_h["walks"] > 1).any()
