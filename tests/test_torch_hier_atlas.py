"""The port's hierarchical atlas (paper §4.3) against the reference's on
the conftest ``small_ds`` corpus and the OR sweep: the super-cluster
leaves, candidate supers, both rounds of ``select_anchors`` (nearest
seeds and seeded random draws) and ``run_queries`` ids through a
``FiberIndex`` holding either atlas. Every comparison is exact; the
recall check is the reference test's (hier > flat - 0.08)."""
import numpy as np
import pytest
import torch

from repro.core.hier_atlas import HierAtlas as RefHier
from repro.core.predicate import as_dnf as ref_as_dnf
from repro.core.search import FiberIndex as RefIndex
from repro.core.search import SearchParams as RefParams
from repro.core.search import run_queries as ref_run_queries
from repro.data.ground_truth import recall_at_k
from repro_torch.core.hier_atlas import HierAtlas
from repro_torch.core.predicate import as_dnf
from repro_torch.core.search import FiberIndex, SearchParams, run_queries

from _torch_parity import build_or_sweep, port_side


@pytest.fixture(scope="module")
def both(small_index, small_queries):
    """(reference hier, port hier, port index, port queries) over the
    conftest corpus and its flat atlas."""
    p_index, p_queries = port_side(small_index, small_queries)
    ref = RefHier.build(None, small_index.atlas)
    return ref, HierAtlas.build(None, p_index.atlas), p_index, p_queries


def test_leaves_match_reference(both):
    ref, hier, _, _ = both
    assert np.array_equal(ref.super_centroids, hier.super_centroids)
    assert np.array_equal(ref.super_assign, hier.super_assign)
    assert hier.super_assign.dtype == np.int32
    assert len(ref.members_of_super) == len(hier.members_of_super)
    for a, b in zip(ref.members_of_super, hier.members_of_super):
        assert np.array_equal(a, b) and b.dtype == np.int32
    assert len(ref.super_index) == len(hier.super_index)
    for a, b in zip(ref.super_index, hier.super_index):
        assert a.keys() == b.keys()
        for v in a:
            assert np.array_equal(a[v], b[v])
    assert hier.n_clusters == ref.n_clusters


def _pairs(ref_pred, port_pred, ds_vocab):
    """A conjunctive predicate as it is, an expression compiled to its
    DNF in each package (as ``search`` compiles it)."""
    if hasattr(ref_pred, "clauses"):
        return ref_pred, port_pred
    return ref_as_dnf(ref_pred, ds_vocab), as_dnf(port_pred, ds_vocab)


@pytest.mark.parametrize("sweep", ["small", "or"])
def test_select_anchors_match_reference(both, small_index, small_queries,
                                        sweep):
    """Candidate supers, the passthroughs and two rounds of seeds (the
    second skipping the first's clusters), nearest-first with vectors
    and by a seeded draw without."""
    if sweep == "small":
        ref, hier, p_index = both[0], both[1], both[2]
        r_index, r_qs, p_qs = small_index, small_queries, both[3]
    else:
        _, r_index, r_qs = build_or_sweep()
        p_index, p_qs = port_side(r_index, r_qs)
        ref = RefHier.build(None, r_index.atlas)
        hier = HierAtlas.build(None, p_index.atlas)
    vocab = p_index.vocab_sizes()
    for rq, pq in zip(r_qs, p_qs):
        rp, pp = _pairs(rq.predicate, pq.predicate, vocab)
        assert np.array_equal(ref.matching_supers(rp),
                              hier.matching_supers(pp))
        assert np.array_equal(ref.matching_clusters(rp),
                              hier.matching_clusters(pp))
        for vecs in (True, False):
            r_done, p_done = set(), set()
            for _ in range(2):
                kw = dict(n_seeds=6, c_max=3)
                got_r = ref.select_anchors(
                    rq.vector, rp, r_done, rng=np.random.default_rng(7),
                    vectors=r_index.vectors if vecs else None, **kw)
                got_p = hier.select_anchors(
                    pq.vector, pp, p_done, rng=np.random.default_rng(7),
                    vectors=p_index.vectors if vecs else None, **kw)
                assert got_r == got_p
                for c in got_p[1]:
                    assert np.array_equal(
                        ref.cluster_members_matching(c, rp),
                        hier.cluster_members_matching(c, pp))
                r_done.update(got_r[1])
                p_done.update(got_p[1])


def test_run_queries_match_reference(both, small_ds, small_graph,
                                     small_index, small_queries):
    ref, hier, p_index, p_qs = both
    r_params = RefParams(k=10, walk="guided", beam_width=2)
    params = SearchParams(k=10, walk="guided", beam_width=2)
    want, _ = ref_run_queries(
        RefIndex(small_ds.vectors, small_ds.metadata, small_graph, ref),
        small_queries, r_params)
    got, _ = run_queries(
        FiberIndex(p_index.vectors, p_index.metadata, p_index.graph, hier),
        p_qs, params)
    for a, b in zip(want, got):
        assert np.array_equal(a, b)
    flat, _ = run_queries(p_index, p_qs, params)
    rf = np.mean([recall_at_k(i, q.gt_ids) for i, q in zip(flat, p_qs)])
    rh = np.mean([recall_at_k(i, q.gt_ids) for i, q in zip(got, p_qs)])
    assert rh > rf - 0.08, (rh, rf)


def test_to_device_exports_the_flat_atlas(both):
    _, hier, p_index, _ = both
    got = hier.to_device(device="cpu")
    want = p_index.atlas.to_device(device="cpu")
    fields = [f for f in vars(want) if torch.is_tensor(getattr(want, f))]
    assert fields
    for f in fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.v_cap == want.v_cap
