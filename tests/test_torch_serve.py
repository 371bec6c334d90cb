"""The port's serving layer on the CPU (``RetrievalService(device="cpu")``
and ``ServePipeline``): the reference's serving cases that need no
language model, its pipeline cases (ordering, overlap with injected
latency, isolation, bucket targets, unit-basis pads, stat slicing on both
engine routes, the publish fence), the pipeline's ``_smoke``, and
``query``/``query_batch`` held to the reference service's results on the
conjunctive, OR and range sweeps and across a document lifecycle. On the
card the pipeline's overlap in time is checked by ``chip_smoke.py`` (the
stream still busy when ``dispatch`` returns)."""
import numpy as np
import pytest

from repro.core.search import SearchParams as RefParams
from repro.core.types import Dataset as RefDataset
from repro.serve.retrieval import RetrievalService as RefService
from repro_torch import faults
from repro_torch.core.config import FnsConfig, ServeConfig
from repro_torch.core.predicate import And, In, Or, Range
from repro_torch.core.search import SearchParams
from repro_torch.core.types import (Dataset, FilterPredicate, Query,
                                    normalize)
from repro_torch.interop import queries_from_reference
from repro_torch.serve.pipeline import AdmissionQueue, ServePipeline
from repro_torch.serve.retrieval import MIN_BUCKET, RetrievalService

from _torch_parity import build_or_sweep, build_range_sweep


def _q(vec, pred):
    return Query(vector=normalize(vec), predicate=pred)


def _build(ds, **kw):
    return RetrievalService.build(ds, device="cpu", **kw)


# -- the reference's serving cases (no LM) -----------------------------------

def test_query_batch_matches_filters():
    rng = np.random.default_rng(4)
    n, d = 1200, 32
    vecs = normalize(rng.standard_normal((n, d)))
    meta = rng.integers(0, 6, (n, 4)).astype(np.int32)
    ds = Dataset(vecs, meta, [f"f{i}" for i in range(4)], [6] * 4)
    svc = _build(ds, graph_k=12, r_max=36,
                 params=SearchParams(k=5, max_hops=60))
    preds = [FilterPredicate.make({0: [1]}),
             FilterPredicate.make({1: [2], 2: [3, 4]}),
             FilterPredicate.make({})]
    ids, stats = svc.query_batch(rng.standard_normal((3, d)), preds)
    assert stats["walks"].shape == (3,)
    for pred, row in zip(preds, ids):
        assert row.size > 0
        assert pred.mask(meta)[row].all()
    assert ids[2].size == 5  # unconstrained fills k


def test_query_batch_empty_and_singleton_bucket():
    """An empty batch returns ``([], {})`` without building the engine; a
    singleton and a 3-query arrival both pad to MIN_BUCKET, one dispatch
    each."""
    rng = np.random.default_rng(9)
    n, d = 600, 16
    ds = Dataset(normalize(rng.standard_normal((n, d))),
                 rng.integers(0, 5, (n, 3)).astype(np.int32),
                 [f"f{i}" for i in range(3)], [5] * 3)
    svc = _build(ds, graph_k=8, r_max=24,
                 params=SearchParams(k=5, max_hops=40))
    ids, stats = svc.query_batch(np.zeros((0, d)), [])
    assert ids == [] and stats == {}
    assert svc._engine is None
    eng = svc.engine()
    seen: list[int] = []
    orig = eng.search

    def spy(queries, **kw):
        seen.append(len(queries))
        return orig(queries, **kw)

    eng.search = spy
    try:
        d0 = eng.dispatches
        pred = FilterPredicate.make({0: [1]})
        ids, stats = svc.query_batch(rng.standard_normal((1, d)), [pred])
        assert len(ids) == 1 and stats["walks"].shape == (1,)
        assert eng.dispatches - d0 == 1
        svc.query_batch(rng.standard_normal((3, d)), [pred] * 3)
        assert seen == [MIN_BUCKET, MIN_BUCKET]
        assert eng.dispatches - d0 == 2
    finally:
        eng.search = orig
    with pytest.raises(ValueError, match="one predicate per query"):
        svc.query_batch(rng.standard_normal((2, d)), [pred])


def test_query_batch_wide_clause_widths_share_shape():
    """Predicates wider than MAX_CLAUSES pack to one power-of-two clause
    dim whatever their width."""
    from repro_torch.core.batched.engine import clause_dim
    from repro_torch.kernels.ops import MAX_CLAUSES

    assert clause_dim(0) == clause_dim(MAX_CLAUSES) == MAX_CLAUSES
    assert clause_dim(5) == clause_dim(7) == 8 and clause_dim(9) == 16
    rng = np.random.default_rng(5)
    n, d, f_count = 600, 16, 8
    meta = rng.integers(0, 4, (n, f_count)).astype(np.int32)
    ds = Dataset(normalize(rng.standard_normal((n, d))), meta,
                 [f"f{i}" for i in range(f_count)], [4] * f_count)
    svc = _build(ds, graph_k=8, r_max=24,
                 params=SearchParams(k=5, max_hops=40))
    eng = svc.engine()

    def wide_query(width):  # clauses from a real row -> matches >= 1 point
        row = meta[0]
        return _q(rng.standard_normal(d), FilterPredicate.make(
            {f: [int(row[f]), (int(row[f]) + 1) % 4] for f in range(width)}))

    q5, q7 = wide_query(5), wide_query(7)
    _, f5, a5, _ = eng._pack_queries([q5])
    _, f7, a7, _ = eng._pack_queries([q7])
    assert f5.shape == f7.shape == (1, 8)
    assert a5.shape == a7.shape
    for q in (q5, q7):
        ids, _ = eng.search([q])
        assert q.predicate.mask(meta)[ids[0]].all() and ids[0].size > 0


def test_query_batch_isolates_bad_query():
    """A query whose DNF exceeds MAX_DISJUNCTS gets an empty result and a
    per-query error; its categorical and interval batch-mates answer."""
    rng = np.random.default_rng(11)
    n, d = 600, 16
    vecs = normalize(rng.standard_normal((n, d)))
    meta = np.empty((n, 5), np.int32)
    meta[:, :4] = rng.integers(0, 5, (n, 4))
    meta[:, 4] = rng.integers(0, 1 << 20, n)  # big-vocab timestamp field
    ds = Dataset(vecs, meta, ["a", "b", "c", "e", "ts"],
                 [5, 5, 5, 5, 1 << 20])
    svc = _build(ds, graph_k=8, r_max=24,
                 params=SearchParams(k=5, max_hops=40))
    good_cat = In(0, [1]) | In(1, [2])
    good_rng = Range(4, 0, 1 << 19)
    bad = And(*[Or(In(f, [0]), In(f, [1])) for f in range(4)])
    with pytest.raises(ValueError, match="max_disjuncts"):
        svc.engine().search([_q(vecs[0], bad)])
    ids, stats = svc.query_batch(rng.standard_normal((3, d)),
                                 [good_cat, bad, good_rng])
    assert len(ids) == 3 and ids[1].size == 0
    assert stats["errors"][0] is None and stats["errors"][2] is None
    assert "max_disjuncts" in stats["errors"][1]
    for pred, row in ((good_cat, ids[0]), (good_rng, ids[2])):
        assert row.size > 0
        assert pred.mask(meta, ds.vocab_sizes)[row].all()
    _, stats_ok = svc.query_batch(rng.standard_normal((2, d)),
                                  [good_cat, good_rng])
    assert "errors" not in stats_ok


# -- the reference's pipeline cases -------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _corpus(seed=7, n=400, d=16, fields=4, vocab=5):
    rng = np.random.default_rng(seed)
    vecs = normalize(rng.standard_normal((n, d)))
    meta = rng.integers(0, vocab, (n, fields)).astype(np.int32)
    return rng, Dataset(vecs, meta, [f"f{i}" for i in range(fields)],
                        [vocab] * fields)


_PIPE_KNOBS = {"walk.k": 5, "walk.max_hops": 40, "graph.graph_k": 8,
               "graph.r_max": 24, "serve.queue_max_batch": 4,
               "serve.queue_budget_ms": 0.0}


@pytest.fixture(scope="module")
def pipe_svc():
    _, ds = _corpus()
    return ds, _build(ds, config=FnsConfig().with_knobs(_PIPE_KNOBS))


def test_admission_queue_size_and_deadline_triggers():
    clk = FakeClock()
    q = AdmissionQueue(ServeConfig(queue_max_batch=8, queue_budget_ms=5.0),
                       clock=clk)
    for _ in range(3):
        q.admit(np.zeros(4, np.float32), FilterPredicate.make({}))
    assert q.poll() is None                      # 3 < 8, wait 0ms
    clk.t += 0.004
    assert q.poll() is None                      # 4ms < 5ms budget
    clk.t += 0.002
    batch = q.poll()                             # 6ms: deadline trips
    assert batch is not None and len(batch) == 3 and len(q) == 0
    for _ in range(10):
        q.admit(np.zeros(4, np.float32), FilterPredicate.make({}))
    batch = q.poll()                             # full bucket
    assert len(batch) == 8 and len(q) == 2
    assert q.poll() is None
    assert len(q.poll(force=True)) == 2
    assert q.oldest_wait_ms() == 0.0


def test_bucket_target_rounds_to_lane_multiple():
    scfg = ServeConfig(min_bucket=4)
    assert AdmissionQueue(scfg, q_lanes=1).bucket_target(5) == 8
    assert AdmissionQueue(scfg, q_lanes=4).bucket_target(5) == 8
    assert AdmissionQueue(scfg, q_lanes=3).bucket_target(3) == 6
    assert AdmissionQueue(scfg, q_lanes=8).bucket_target(2) == 8
    assert AdmissionQueue(scfg, q_lanes=4).bucket_target(1) == 4


def test_pipeline_results_match_query_batch(pipe_svc):
    """Pump-until-drained reproduces ``query_batch`` exactly, over more
    tickets than one bucket."""
    _, svc = pipe_svc
    rng = np.random.default_rng(1)
    qs = rng.standard_normal((10, 16)).astype(np.float32)
    preds = [FilterPredicate.make({0: [i % 5]}) for i in range(10)]
    pipe = ServePipeline(svc)
    tickets = [pipe.submit(v, p) for v, p in zip(qs, preds)]
    while not all(t.done for t in tickets):
        if pipe.pump() == 0 and len(pipe.queue) == 0:
            pipe.drain()
    assert pipe.batches >= 2
    ref_ids, _ = svc.query_batch(qs, list(preds))
    for t, ref in zip(tickets, ref_ids):
        assert t.error is None and t.done
        np.testing.assert_array_equal(t.ids, ref)
        assert t.sojourn_ms is not None and t.sojourn_ms >= 0.0


def test_pipeline_stage_order_with_injected_latency(pipe_svc):
    """The pipeline's ordering: batch 1 is staged before batch 0 is
    collected, and batches are collected oldest first. (Only the order of
    the stages: the port's dispatch searches before it returns, so the
    stages do not overlap in time.)"""
    _, svc = pipe_svc
    rng = np.random.default_rng(2)
    pipe = ServePipeline(svc)
    calls = []
    faults.arm("serve.pre-dispatch", lambda: calls.append(1))
    try:
        for i in range(8):                       # 2 buckets of 4
            pipe.submit(rng.standard_normal(16).astype(np.float32),
                        FilterPredicate.make({0: [i % 5]}))
        assert pipe.pump() == 0 and pipe.inflight == 1   # stage batch 0
        assert pipe.pump() == 1 and pipe.inflight == 1   # stage 1, sync 0
        pipe.drain()
    finally:
        faults.disarm("serve.pre-dispatch")
    assert pipe.batches == 2 and len(calls) == 2
    assert [(e, no) for e, no, _ in pipe.events] == [
        ("dispatch", 0), ("dispatch", 1), ("collect", 0), ("collect", 1)]
    times = [t for _, _, t in pipe.events]
    assert times == sorted(times)


def test_pipeline_overlap_with_injected_latency(pipe_svc):
    """The reference's case: with latency injected into the pre-dispatch
    window, batch 0's collect lands after batch 1's (delayed) dispatch,
    and the sync waited out batch 1's injected staging latency."""
    import time
    _, svc = pipe_svc
    rng = np.random.default_rng(2)
    pipe = ServePipeline(svc)
    delay = 0.05
    faults.arm("serve.pre-dispatch", lambda: time.sleep(delay))
    try:
        for i in range(8):                       # 2 buckets of 4
            pipe.submit(rng.standard_normal(16).astype(np.float32),
                        FilterPredicate.make({0: [i % 5]}))
        pipe.pump()                              # stage batch 0
        pipe.pump()                              # stage batch 1, sync 0
        pipe.drain()
    finally:
        faults.disarm("serve.pre-dispatch")
    d_t = {no: t for e, no, t in pipe.events if e == "dispatch"}
    c_t = {no: t for e, no, t in pipe.events if e == "collect"}
    assert pipe.batches == 2
    assert d_t[1] < c_t[0], (d_t, c_t)           # staging precedes the sync
    assert c_t[0] - d_t[0] >= delay


def test_pipeline_smoke_on_cpu(capsys):
    """``serve/pipeline.py:_smoke`` on the host: 20 tickets in more than
    one batch, ids equal to ``query_batch``, batch 1 staged before batch
    0's collect."""
    from repro_torch.serve.pipeline import _smoke
    _smoke(device="cpu")
    assert "pipeline smoke OK" in capsys.readouterr().out


def test_pipeline_isolates_bad_ticket(pipe_svc):
    ds, svc = pipe_svc
    rng = np.random.default_rng(3)
    bad = And(*[Or(In(f, [0]), In(f, [1])) for f in range(4)])
    preds = [FilterPredicate.make({0: [1]}), bad,
             FilterPredicate.make({1: [2]})]
    pipe = ServePipeline(svc)
    tickets = [pipe.submit(rng.standard_normal(16).astype(np.float32), p)
               for p in preds]
    pipe.pump(force=True)
    pipe.drain()
    assert "max_disjuncts" in tickets[1].error
    assert tickets[1].ids.size == 0
    for t, col in ((tickets[0], 0), (tickets[2], 1)):
        assert t.error is None and t.ids.size > 0
        assert (ds.metadata[t.ids, col] == (1 if col == 0 else 2)).all()


def test_bucket_pads_are_unit_basis_not_zero(pipe_svc):
    ds, svc = pipe_svc
    rng = np.random.default_rng(4)
    eng = svc.engine()
    seen = {}
    orig = eng.search

    def spy(queries, **kw):
        seen["queries"] = queries
        return orig(queries, **kw)

    eng.search = spy
    try:
        vec = rng.standard_normal((1, 16))
        pred = [FilterPredicate.make({0: [2]})]
        ids_b, _ = svc.query_batch(vec, pred)               # pads to 4
    finally:
        eng.search = orig
    padded = seen["queries"]
    assert len(padded) == 4
    for dummy in padded[1:]:
        assert float(np.linalg.norm(dummy.vector)) == pytest.approx(1.0)
        assert not dummy.predicate.mask(ds.metadata).any()
    ids_u, _ = svc.query_batch(vec, pred, bucket=False)
    np.testing.assert_array_equal(ids_b[0], ids_u[0])


def test_stats_slice_only_per_query_axes_batched_route(pipe_svc):
    _, svc = pipe_svc
    rng = np.random.default_rng(5)
    ids, stats = svc.query_batch(
        rng.standard_normal((3, 16)),
        [FilterPredicate.make({0: [i]}) for i in range(3)])
    assert stats["walks"].shape == (3,) and stats["hops"].shape == (3,)
    assert isinstance(stats["generation"], int)
    assert stats["generation"] == svc.engine().publish_generation
    assert isinstance(stats["syncs"], int)


def test_stats_slice_only_per_query_axes_sharded_reference_route():
    """The same contract through a reference-mode ``ShardedEngine``
    attached to the service (one dispatch per shard)."""
    from repro_torch.core.batched.sharded import (ShardedEngine,
                                                  build_sharded_index)

    _, ds = _corpus(seed=8)
    cfg = FnsConfig().with_knobs(_PIPE_KNOBS)
    sidx = build_sharded_index(ds.vectors, ds.metadata, 2, config=cfg,
                               device="cpu")
    eng = ShardedEngine(sidx, None, config=cfg, device="cpu")
    svc = RetrievalService(None, SearchParams(k=5, max_hops=40), config=cfg,
                           device="cpu", _ds=ds, _sharded=eng)
    rng = np.random.default_rng(9)
    d0 = eng.dispatches
    ids, stats = svc.query_batch(
        rng.standard_normal((3, 16)),
        [FilterPredicate.make({0: [i]}) for i in range(3)])
    assert eng.dispatches - d0 == eng.n_shards
    assert len(ids) == 3
    assert stats["walks"].shape == (3,) and stats["hops"].shape == (3,)
    assert isinstance(stats["generation"], int)


def test_publish_generation_fence_interleaved_delete():
    """A publish landing between pack and dispatch makes the fence
    re-pack; the just-deleted document is absent from that very batch."""
    rng, ds = _corpus(seed=10)
    svc = _build(ds, config=FnsConfig().with_knobs(
        {**_PIPE_KNOBS, "serve.capacity": 450}))
    vec = rng.standard_normal((1, 16))
    pred = [FilterPredicate.make({0: [3]})]
    ids0, _ = svc.query_batch(vec, pred)
    target = int(ids0[0][0])
    eng = svc._live_engine()
    gen0 = eng.publish_generation

    def publish_mid_window():
        faults.disarm("serve.pre-dispatch")  # fire once, not on re-pack
        svc.delete([target])

    faults.arm("serve.pre-dispatch", publish_mid_window)
    try:
        ids1, stats1 = svc.query_batch(vec, pred)
    finally:
        faults.disarm()
    assert eng.fence_retries >= 1
    assert target not in ids1[0].tolist()
    assert stats1["generation"] == eng.publish_generation > gen0


def test_maintenance_step_reports_publish_generation():
    rng, ds = _corpus(seed=11)
    svc = _build(ds, config=FnsConfig().with_knobs(
        {**_PIPE_KNOBS, "serve.capacity": 480,
         "maintenance.defer_repair": True}))
    svc.ingest(normalize(rng.standard_normal((8, 16))),
               rng.integers(0, 5, (8, 4)).astype(np.int32))
    eng = svc._live_engine()
    out = svc.maintenance_step()
    assert out["kind"] == "repair"
    assert out["generation"] == eng.publish_generation
    assert svc.maintenance_step()["kind"] == "idle"


# -- results held to the reference service ------------------------------------

def _service_pair(ds, **kw):
    """The same corpus served by both packages (each builds its own graph
    and atlas from the same rows, bit for bit)."""
    ref = RefService.build(RefDataset(ds.vectors, ds.metadata,
                                      ds.field_names, list(ds.vocab_sizes)),
                           params=RefParams(k=10, max_hops=80), **kw)
    port = _build(Dataset(ds.vectors, ds.metadata, ds.field_names,
                          list(ds.vocab_sizes)),
                  params=SearchParams(k=10, max_hops=80), **kw)
    return ref, port


def _batch(svc, queries):
    return svc.query_batch(np.stack([q.vector for q in queries]),
                           [q.predicate for q in queries])


@pytest.fixture(scope="module")
def or_sweep():
    return build_or_sweep()


@pytest.fixture(scope="module")
def range_sweep():
    return build_range_sweep()


@pytest.mark.parametrize("sweep", ["sel_sweep", "or_sweep", "range_sweep"])
def test_query_batch_matches_reference(request, sweep):
    """``query_batch`` ids (in order), walks and hops equal the reference
    service's on the conjunctive, OR and range sweeps, and the sequential
    ``query`` returns the reference's ids, sims and walk counts."""
    ds, _, ref_qs = request.getfixturevalue(sweep)
    ref, port = _service_pair(ds, graph_k=16, r_max=48)
    qs = queries_from_reference(ref_qs)
    ids_r, st_r = _batch(ref, ref_qs)
    ids_p, st_p = _batch(port, qs)
    assert len(ids_p) == len(ids_r) == len(qs)
    for i, (a, b) in enumerate(zip(ids_p, ids_r)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"query {i}")
    for key in ("walks", "hops"):
        np.testing.assert_array_equal(st_p[key], st_r[key])
    for i in range(0, len(qs), 5):
        a = port.query(qs[i].vector, qs[i].predicate, seed=i)
        b = ref.query(ref_qs[i].vector, ref_qs[i].predicate, seed=i)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert (a[2].n_walks, a[2].hops) == (b[2].n_walks, b[2].hops)


def test_lifecycle_matches_reference(sel_sweep):
    """Ingest, delete, ``compact_now`` and maintenance through both
    services: the same ids, staleness and gids after every step."""
    ds, _, ref_qs = sel_sweep
    n0 = ds.n - 120
    base = Dataset(ds.vectors[:n0], ds.metadata[:n0], ds.field_names,
                   list(ds.vocab_sizes))
    ref, port = _service_pair(base, graph_k=16, r_max=48, capacity=ds.n)
    qs = queries_from_reference(ref_qs)

    def same():
        ids_r, _ = _batch(ref, ref_qs)
        ids_p, _ = _batch(port, qs)
        for a, b in zip(ids_p, ids_r):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert port.staleness() == ref.staleness()

    for lo in (n0, n0 + 60):
        rows = slice(lo, lo + 60)
        g_r = ref.ingest(ds.vectors[rows], ds.metadata[rows])
        g_p = port.ingest(ds.vectors[rows], ds.metadata[rows])
        np.testing.assert_array_equal(g_p, g_r)
        same()
    dead = np.arange(0, 400, 7)
    assert port.delete(dead) == ref.delete(dead)
    same()
    rep_r, rep_p = ref.compact_now(), port.compact_now()
    assert rep_p["shards"] == rep_r["shards"] and rep_p["shards"]
    same()
    while True:
        a, b = port.maintenance_step(), ref.maintenance_step()
        assert a["kind"] == b["kind"]
        if a["kind"] == "idle":
            break
    same()
