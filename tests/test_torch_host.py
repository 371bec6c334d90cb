"""Port host layer vs the JAX reference: the numpy copies must rebuild the
same datasets, α-kNN graph, anchor atlas and clause tables bit for bit,
and the port must import neither jax nor the reference package."""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import graph as ref_graph
from repro.core.device_atlas import pack_dnf as ref_pack_dnf
from repro.core.device_atlas import pack_predicates as ref_pack_predicates
from repro.core.predicate import In, Not, Or, Range, as_dnf
from repro.data import synth as ref_synth
from repro_torch.core.atlas import AnchorAtlas
from repro_torch.core.device_atlas import pack_dnf, pack_predicates
from repro_torch.core.graph import _symmetrize, brute_knn, build_alpha_knn
from repro_torch.data import synth
from repro_torch.interop import predicate_from_reference

from conftest import SELECTIVITIES


def _assert_atlas_equal(port, ref):
    np.testing.assert_array_equal(port.centroids, ref.centroids)
    np.testing.assert_array_equal(port.assign, ref.assign)
    assert len(port.cluster_index) == len(ref.cluster_index)
    for p_f, r_f in zip(port.cluster_index, ref.cluster_index):
        assert p_f.keys() == r_f.keys()
        for v in r_f:
            np.testing.assert_array_equal(p_f[v], r_f[v])
    for p_c, r_c in zip(port.members, ref.members):
        for f in r_c:
            assert p_c[f].keys() == r_c[f].keys()
            for v in r_c[f]:
                np.testing.assert_array_equal(p_c[f][v], r_c[f][v])


@pytest.fixture(scope="module")
def port_small_ds():
    return synth.make_dataset(synth.SynthSpec(n=3000, d=64, n_components=24,
                                              n_fields=10, seed=0))


def test_small_dataset_bit_identical(small_ds, port_small_ds):
    np.testing.assert_array_equal(port_small_ds.vectors, small_ds.vectors)
    np.testing.assert_array_equal(port_small_ds.metadata, small_ds.metadata)
    assert port_small_ds.vocab_sizes == small_ds.vocab_sizes
    assert port_small_ds.vectors.dtype == small_ds.vectors.dtype


def test_small_graph_bit_identical(small_graph, port_small_ds):
    g = build_alpha_knn(port_small_ds.vectors, k=24, r_max=64, alpha=1.2)
    np.testing.assert_array_equal(g.neighbors, small_graph.neighbors)
    np.testing.assert_array_equal(g.degrees, small_graph.degrees)


def test_small_atlas_bit_identical(small_atlas, port_small_ds):
    _assert_atlas_equal(AnchorAtlas.build(port_small_ds, seed=0),
                        small_atlas)


# (n, d, block, quantized): several blocks with a short last one, the
# smoke's d and n_components, a last block of one row (numpy multiplies
# it as a matrix-vector product), and vectors rounded to a grid of 1/64
# so that about 60% of the rows tie among their k + 1 best (those the
# reference's ranking decides)
GRAPH_SIZES = ((4_500, 256, 2048, False), (2_600, 2048, 512, False),
               (1_025, 64, 512, False), (1_200, 32, 256, True))


@pytest.mark.parametrize("n,d,block,quantized", GRAPH_SIZES)
def test_graph_build_matches_reference(n, d, block, quantized):
    """The port's kNN (half the block products, lines ranked through a
    threshold, tied rows by the reference's ranking) and the whole α-kNN build
    equal the reference's unchanged ones bit for bit: ``neighbors``,
    ``degrees``, the kNN ids and their similarities."""
    v = synth.make_dataset(synth.SynthSpec(n=n, d=d, n_fields=4,
                                           n_components=350, seed=0)).vectors
    if quantized:
        v = np.round(v * 64).astype(np.float32) / 64
    idx, sims = brute_knn(v, 32, block=block, return_sims=True)
    want_idx, want_sims = ref_graph.brute_knn(v, 32, block=block,
                                              return_sims=True)
    assert np.array_equal(idx, want_idx) and np.array_equal(sims, want_sims)
    times = {}
    g = build_alpha_knn(v, k=32, r_max=96, alpha=1.2, block=block,
                        times=times)
    want = ref_graph.build_alpha_knn(v, k=32, r_max=96, alpha=1.2,
                                     block=block)
    assert np.array_equal(g.neighbors, want.neighbors)
    assert np.array_equal(g.degrees, want.degrees)
    assert set(times) == {"knn_s", "symmetrize_s", "prune_s", "pruned"}
    assert times["pruned"] == sum(a.size > 96 for a in _symmetrize(idx))


def test_sel_sweep_index_bit_identical(sel_sweep):
    """The selectivity-sweep corpus, its graph and atlas, and the queries
    rebuilt by the port's own copies equal the reference fixture's."""
    ds, index, queries = sel_sweep
    pds = synth.make_selectivity_dataset(SELECTIVITIES)
    np.testing.assert_array_equal(pds.vectors, ds.vectors)
    np.testing.assert_array_equal(pds.metadata, ds.metadata)
    g = build_alpha_knn(pds.vectors, k=16, r_max=48, alpha=1.2)
    np.testing.assert_array_equal(g.neighbors, index.graph.neighbors)
    np.testing.assert_array_equal(g.degrees, index.graph.degrees)
    _assert_atlas_equal(AnchorAtlas.build(pds, seed=0), index.atlas)
    pq = []
    for v, _ in enumerate(SELECTIVITIES):
        pq.extend(synth.make_selectivity_queries(pds, v, 12))
    for a, b in zip(pq, queries):
        np.testing.assert_array_equal(a.vector, b.vector)
        assert a.predicate.clauses == b.predicate.clauses
        assert a.selectivity == b.selectivity


def test_or_and_range_datasets_bit_identical():
    base = ref_synth.make_selectivity_dataset((0.5, 0.1, 0.02), n=600, d=16,
                                              n_components=8)
    pbase = synth.make_selectivity_dataset((0.5, 0.1, 0.02), n=600, d=16,
                                           n_components=8)
    for ref_ds, port_ds in [
            (ref_synth.add_or_pair_fields(base, sels=(0.5, 0.1)),
             synth.add_or_pair_fields(pbase, sels=(0.5, 0.1))),
            (ref_synth.add_timestamp_field(base),
             synth.add_timestamp_field(pbase))]:
        np.testing.assert_array_equal(port_ds.metadata, ref_ds.metadata)
        assert port_ds.vocab_sizes == ref_ds.vocab_sizes


def test_conjunctive_tables_bit_identical(small_queries):
    preds = [q.predicate for q in small_queries]
    f_r, a_r = ref_pack_predicates(preds, max_clauses=4, v_cap=256)
    f_p, a_p = pack_predicates([predicate_from_reference(p) for p in preds],
                               max_clauses=4, v_cap=256)
    np.testing.assert_array_equal(f_p, f_r)
    np.testing.assert_array_equal(a_p, a_r)
    assert a_p.dtype == a_r.dtype == np.uint32


@pytest.mark.parametrize("kind", ["or", "range", "mixed"])
def test_dnf_tables_bit_identical(kind):
    """pack_dnf over OR, interval and mixed expressions (incl. Not over a
    big domain, a never() lane and an unconstrained lane)."""
    vocab = [8, 8, 1 << 20]
    exprs = {
        "or": [Or(In(0, [1, 2]), In(1, [3])), Or(In(0, [5]), In(1, [5])),
               Or()],
        "range": [Range(2, 10, 5000), Not(Range(2, 100, None)),
                  Range(2, None, 77)],
        "mixed": [Or(In(0, [1]), Range(2, 3, 9)), Not(In(2, [4, 5])),
                  In(0, []) | In(1, [2, 300]), Or(In(0, [1]), Not(In(0, [1])))],
    }[kind]
    ref_dnfs = [as_dnf(e, vocab, v_cap=64) for e in exprs]
    port_dnfs = [predicate_from_reference(d) for d in ref_dnfs]
    for got, want in zip(
            pack_dnf(port_dnfs, max_disjuncts=8, max_clauses=4, v_cap=64),
            ref_pack_dnf(ref_dnfs, max_disjuncts=8, max_clauses=4, v_cap=64)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_port_imports_neither_jax_nor_reference():
    """Importing every port module pulls in no jax and no reference
    package (the reference's core package imports jax on the way in)."""
    code = (
        "import sys\n"
        "import repro_torch.core.batched.engine, repro_torch.interop\n"
        "import repro_torch.kernels.build, repro_torch.kernels.ops\n"
        "import repro_torch.data.synth, repro_torch.data.ground_truth\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
