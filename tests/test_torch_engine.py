"""Port ``BatchedEngine(..., device="cpu").search`` vs the reference's
``BatchedEngine.search`` on the same index (carried over through
``repro_torch.interop``): IDENTICAL result ids (same order) and identical
per-query walks and hops, on the selectivity sweep, OR and range batches,
a batch that forces restarts, and batches padded with ``never()`` lanes."""
import numpy as np
import pytest

from repro.core.batched.engine import BatchedEngine as RefEngine
from repro.core.config import FnsConfig as RefConfig
from repro.core.config import WalkConfig as RefWalk
from repro.core.predicate import FilterExpr
from repro.core.types import Query
from repro.data.ground_truth import recall_at_k
from repro_torch.core.batched.engine import BatchedEngine
from repro_torch.core.config import FnsConfig, WalkConfig

from _torch_parity import build_or_sweep, build_range_sweep, port_side
from conftest import SELECTIVITIES

WALK = dict(k=10, beam_width=4)


def _both(index, queries, vocab_sizes=None, seed_backend=None, **walk):
    """Search the same batch through both engines; return both results."""
    knobs = {**WALK, **walk}
    serve = {} if seed_backend is None else {"serve.seed_backend":
                                             seed_backend}
    ref = RefEngine(index, RefConfig(walk=RefWalk(**knobs)).with_knobs(serve),
                    vocab_sizes=vocab_sizes)
    pidx, pq = port_side(index, queries)
    port = BatchedEngine(
        pidx, FnsConfig(walk=WalkConfig(**knobs)).with_knobs(serve),
        device="cpu", vocab_sizes=vocab_sizes)
    return ref.search(queries), port.search(pq)


def _assert_identical(ref_out, port_out):
    (ids_r, st_r), (ids_p, st_p) = ref_out, port_out
    assert len(ids_r) == len(ids_p)
    for i, (a, b) in enumerate(zip(ids_r, ids_p)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=f"query {i}")
    np.testing.assert_array_equal(st_p["walks"], st_r["walks"])
    np.testing.assert_array_equal(st_p["hops"], st_r["hops"])


@pytest.mark.parametrize("seed_backend", ["topk", "sort"])
def test_selectivity_sweep_identical(sel_sweep, seed_backend):
    _, index, queries = sel_sweep
    ref_out, port_out = _both(index, queries, seed_backend=seed_backend)
    _assert_identical(ref_out, port_out)
    ids_p, st_p = port_out
    assert st_p["syncs"] >= 2
    # identical ids make recall identical; the levels are the sweep's
    for v, _ in enumerate(SELECTIVITIES):
        idx = [i for i, q in enumerate(queries)
               if q.predicate.clauses[0][1] == (v,)]
        assert np.mean([recall_at_k(ids_p[i], queries[i].gt_ids)
                        for i in idx]) > 0.3


def test_forced_restarts_identical(sel_sweep):
    """A tiny seed budget and walk (n_seeds=2, c_max=1, max_hops=3)
    leaves the selective queries short of k after their first walk, so the
    restart rounds run (every default-knob query here walks once)."""
    _, index, queries = sel_sweep
    ref_out, port_out = _both(index, queries, n_seeds=2, c_max=1,
                              max_hops=3)
    _assert_identical(ref_out, port_out)
    assert (port_out[1]["walks"] > 1).any()


@pytest.fixture(scope="module")
def or_sweep():
    return build_or_sweep()


@pytest.fixture(scope="module")
def range_sweep():
    return build_range_sweep()


@pytest.mark.parametrize("sweep", ["or_sweep", "range_sweep"])
def test_dnf_batches_identical(request, sweep):
    ds, index, queries = request.getfixturevalue(sweep)
    ref_out, port_out = _both(index, queries, vocab_sizes=ds.vocab_sizes)
    _assert_identical(ref_out, port_out)
    for q, row in zip(queries, port_out[0]):
        assert row.size > 0
        assert q.predicate.mask(ds.metadata, ds.vocab_sizes)[row].all()


@pytest.mark.parametrize("sweep", ["sel_sweep", "or_sweep"])
def test_never_pad_lanes_inert(request, sweep):
    """Serve-bucket pads (``FilterExpr.never()`` at a unit basis vector)
    get 0 results and 0 walks, and leave the real lanes identical."""
    if sweep == "sel_sweep":
        ds, index, queries = request.getfixturevalue(sweep)
        queries, vocab = queries[::6], None
    else:
        ds, index, queries = request.getfixturevalue(sweep)
        vocab = ds.vocab_sizes
    unit = np.eye(ds.vectors.shape[1], dtype=np.float32)[0]
    pads = [Query(vector=unit, predicate=FilterExpr.never())
            for _ in range(3)]
    batch = list(queries) + pads
    ref_out, port_out = _both(index, batch, vocab_sizes=vocab)
    _assert_identical(ref_out, port_out)
    ids_p, st_p = port_out
    for row in ids_p[-3:]:
        assert row.size == 0
    assert (st_p["walks"][-3:] == 0).all() and (st_p["hops"][-3:] == 0).all()


def test_engine_defaults_to_cuda_and_raises_without_it(sel_sweep):
    """No device named means CUDA; with no CUDA device the engine refuses
    to build instead of quietly running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default engine builds")
    _, index, queries = sel_sweep
    pidx, _ = port_side(index, queries)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedEngine(pidx)


@pytest.mark.parametrize("with_results", [False, True])
def test_walk_batch_outputs_identical(small_index, small_queries,
                                      with_results):
    """One lockstep walk round, every output: result queues, termination
    codes, hop and phase-1 hop counts, and the packed visited bitmap —
    from scratch and with results carried in from an earlier round. The
    result distances may differ in the last bit (XLA's dot and torch's
    einsum sum the d products in different orders): rtol 1e-6; everything
    else is exact."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.core.batched.bitmap import pack_bits as ref_pack_bits
    from repro.core.batched.engine import walk_batch as ref_walk
    from repro_torch.core.batched.engine import walk_batch

    from _torch_parity import to_torch

    qs = small_queries[:6]
    meta = small_index.metadata
    passes = np.stack([q.predicate.mask(meta) for q in qs])
    seeds = np.full((6, 6), -1, np.int32)
    for qi in range(6):
        ok = np.nonzero(passes[qi])[0][:6]
        seeds[qi, :ok.size] = ok
    init = None
    if with_results:   # bank each query's last seed as an earlier result
        res_v = np.full((6, 5), 3.4e38, np.float32)
        res_i = np.full((6, 5), -1, np.int32)
        res_v[:, 0], res_i[:, 0] = 0.5, np.maximum(seeds[:, 2], -1)
        res_v[res_i < 0] = 3.4e38
        init = (res_v, res_i)
    q_vecs = np.stack([q.vector for q in qs])
    bm = np.asarray(ref_pack_bits(jnp.asarray(passes)))
    want = jax.jit(ref_walk, static_argnums=5)(
        jnp.asarray(small_index.vectors),
        jnp.asarray(small_index.graph.neighbors), jnp.asarray(bm),
        jnp.asarray(q_vecs), jnp.asarray(seeds),
        RefWalk(k=5, beam_width=4),
        None if init is None else tuple(jnp.asarray(x) for x in init))
    got = walk_batch(
        torch.from_numpy(small_index.vectors),
        torch.from_numpy(small_index.graph.neighbors), to_torch(bm),
        torch.from_numpy(q_vecs), torch.from_numpy(seeds),
        WalkConfig(k=5, beam_width=4),
        None if init is None else tuple(torch.from_numpy(x) for x in init))
    np.testing.assert_allclose(got["res_v"].numpy(),
                               np.asarray(want["res_v"]), rtol=1e-6)
    for key in ("res_i", "term", "hops", "p1_hops", "visited_bm"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      to_torch(want[key]).numpy(),
                                      err_msg=key)
    assert got["syncs"] >= 1
