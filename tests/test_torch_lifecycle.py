"""The port's live index — capacity-slab ``BatchedEngine`` (``insert_batch``,
``delete_batch``, ``from_state``, ``dispatch``/``collect``) and
``MaintenanceLoop`` — driven op for op beside the reference's on the same
index, at the ``test_insert.py`` / ``test_lifecycle.py`` fixture sizes.

After every step the two must agree exactly: the host slab (vectors,
metadata, adjacency, live bits, global ids, atlas assign/centroids/
baselines, backlog, counters), the device tensors and the emitted
``DeviceAtlas`` leaves, and the search ids, walks and hops of a
conjunctive, an OR and a range batch, for both seed backends. Everything
is numpy on the host or the plain PyTorch path on the CPU, so exact
equality is the bar (the walk distances are compared through the ids
they select).
"""
import copy

import numpy as np
import pytest

from repro.core import AnchorAtlas, FiberIndex, build_alpha_knn
from repro.core.batched import lifecycle as ref_lifecycle
from repro.core.batched.engine import BatchedEngine as RefEngine
from repro.core.config import FnsConfig as RefConfig
from repro.core.config import WalkConfig as RefWalk
from repro.core.predicate import In, Not, Range
from repro.core.types import Dataset, FilterPredicate, Query, normalize
from repro.data.synth import (add_or_pair_fields, add_timestamp_field,
                              make_or_queries, make_range_queries,
                              make_selectivity_queries)
from repro.serve.maintenance import MaintenanceLoop as RefLoop
from repro_torch import faults
from repro_torch.core.batched import lifecycle
from repro_torch.core.batched.engine import BatchedEngine
from repro_torch.core.config import FnsConfig, WalkConfig
from repro_torch.interop import (bitmap_to_numpy, index_from_reference,
                                 insert_state_from_reference,
                                 queries_from_reference)
from repro_torch.serve.maintenance import MaintenanceLoop

from test_insert import _full_dataset, _tiny_ds

SEED_BACKENDS = ["topk", "sort"]


# -- the pair: one live index in both packages ---------------------------------

def _index(ds, n_rows, graph_k, r_max):
    base = Dataset(ds.vectors[:n_rows], ds.metadata[:n_rows],
                   ds.field_names, list(ds.vocab_sizes))
    graph = build_alpha_knn(base.vectors, k=graph_k, r_max=r_max)
    atlas = AnchorAtlas.build(base, seed=0)
    return FiberIndex(base.vectors, base.metadata, graph, atlas)


class _Pair:
    """A reference engine and a port engine (``device="cpu"``) over the same
    index and knobs; ``do`` applies one engine method to both."""

    def __init__(self, index, knobs, vocab):
        self.vocab = vocab
        self.ref = RefEngine(index, RefConfig().with_knobs(knobs),
                             vocab_sizes=vocab)
        self.port = BatchedEngine(index_from_reference(index),
                                  FnsConfig().with_knobs(knobs),
                                  device="cpu", vocab_sizes=vocab)

    def do(self, method, *args, **kw):
        out_r = getattr(self.ref, method)(*args, **kw)
        out_p = getattr(self.port, method)(*args, **kw)
        return out_r, out_p


def _assert_state_equal(ref_eng, port_eng):
    """Host slab, device tensors and emitted DeviceAtlas leaves equal."""
    rs, ps = ref_eng.state, port_eng.state
    assert len(rs.shards) == len(ps.shards) == 1
    r, p = rs.shards[0], ps.shards[0]
    assert p.n_valid == r.n_valid
    for name in ("vectors", "metadata", "adjacency", "live", "global_ids"):
        np.testing.assert_array_equal(getattr(p, name), getattr(r, name),
                                      err_msg=name)
    for name in ("assign", "centroids", "base_counts", "base_centroids"):
        np.testing.assert_array_equal(getattr(p.atlas, name),
                                      getattr(r.atlas, name),
                                      err_msg=f"atlas.{name}")
    assert p.atlas.reclusters == r.atlas.reclusters
    assert ps.pending == [tuple(e) for e in rs.pending]
    assert ps.stats() == rs.stats()
    for name in ("vectors", "adjacency", "metadata"):
        np.testing.assert_array_equal(getattr(port_eng, name).numpy(),
                                      np.asarray(getattr(ref_eng, name)),
                                      err_msg=f"device {name}")
    np.testing.assert_array_equal(bitmap_to_numpy(port_eng._valid_bm),
                                  np.asarray(ref_eng._valid_bm))
    rd, pd = ref_eng.datlas, port_eng.datlas
    for leaf in ("centroids", "assign", "csr_pts", "csr_offsets", "inv_perm",
                 "code_min", "code_max"):
        np.testing.assert_array_equal(getattr(pd, leaf).numpy(),
                                      np.asarray(getattr(rd, leaf)),
                                      err_msg=f"datlas.{leaf}")
    np.testing.assert_array_equal(bitmap_to_numpy(pd.presence),
                                  np.asarray(rd.presence))
    assert pd.v_cap == rd.v_cap
    assert port_eng.publish_generation == ref_eng.publish_generation
    assert port_eng.vocab_sizes == ref_eng.vocab_sizes
    assert port_eng.cfg.flatten() == ref_eng.cfg.flatten()


def _assert_search_equal(ref_eng, port_eng, batches, tag,
                         same_history=True):
    """Identical ids, walks and hops on every batch (and, for two engines
    that went through the same publishes, the same generation)."""
    for name, qs in batches.items():
        ids_r, st_r = ref_eng.search(qs)
        ids_p, st_p = port_eng.search(queries_from_reference(qs))
        assert len(ids_p) == len(ids_r)
        for i, (a, b) in enumerate(zip(ids_r, ids_p)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                          err_msg=f"{tag}/{name}[{i}]")
        np.testing.assert_array_equal(st_p["walks"], st_r["walks"],
                                      err_msg=f"{tag}/{name} walks")
        np.testing.assert_array_equal(st_p["hops"], st_r["hops"],
                                      err_msg=f"{tag}/{name} hops")
        if same_history:
            assert st_p["generation"] == st_r["generation"]


def _check(pair, batches, tag):
    _assert_state_equal(pair.ref, pair.port)
    _assert_search_equal(pair.ref, pair.port, batches, tag)


def _batches(ds, per=4):
    """Conjunctive, OR and range batches over a dataset that carries the
    OR pair and the ts field."""
    conj = [q for code in range(3)
            for q in make_selectivity_queries(ds, code, per)]
    ors = [q for code in (1, 2) for q in make_or_queries(ds, code, per)]
    rng = [q for sel in (0.5, 0.1) for q in make_range_queries(ds, sel, per)]
    return {"conj": conj, "or": ors, "range": rng}


@pytest.fixture(scope="module")
def full_ds():
    # ts codes stay below v_cap so the rows can be inserted
    return add_timestamp_field(_full_dataset(), domain=1024)


@pytest.fixture(scope="module")
def full_index(full_ds):
    return _index(full_ds, 750, 16, 48)


def _tiny():
    ds = add_or_pair_fields(_tiny_ds(seed=6), sels=(0.2, 0.1))
    return add_timestamp_field(ds, domain=512)


# -- the scripts -----------------------------------------------------------------

@pytest.mark.parametrize("seed_backend", SEED_BACKENDS)
def test_inline_insert_delete_compact_grow_match_reference(
        full_ds, full_index, seed_backend):
    """Build with capacity, insert (inline repair), delete, compact,
    re-insert deleted gids plus fresh rows, grow past capacity, and carry
    the live slab across with ``from_state``: both packages agree after
    every step."""
    ds = full_ds
    vocab = tuple(ds.vocab_sizes)
    knobs = {"walk.k": 10, "walk.beam_width": 4, "graph.graph_k": 16,
             "serve.capacity": 1000, "atlas.v_cap": 1024,
             "serve.seed_backend": seed_backend}
    pair = _Pair(full_index, knobs, vocab)
    batches = _batches(ds)
    _check(pair, batches, "build")

    g_r, g_p = pair.do("insert_batch", ds.vectors[750:875],
                       ds.metadata[750:875])
    np.testing.assert_array_equal(g_p, g_r)
    _check(pair, batches, "insert")

    dead = np.sort(np.random.default_rng(5).choice(875, 120, replace=False))
    assert pair.do("delete_batch", dead) == (120, 120)
    _check(pair, batches, "delete")

    rep_r = ref_lifecycle.compact_state(pair.ref.state, force=True)
    rep_p = lifecycle.compact_state(pair.port.state, force=True)
    assert rep_p == rep_r and rep_p["reclaimed"] == 120
    pair.do("refresh_device")
    _check(pair, batches, "compact")

    back = dead[:60]
    g_r, g_p = pair.do("insert_batch", ds.vectors[back], ds.metadata[back],
                       gids=back)
    np.testing.assert_array_equal(g_p, back)
    pair.do("insert_batch", ds.vectors[875:1000], ds.metadata[875:1000])
    _check(pair, batches, "reinsert")

    # 100 rows into the last 60 free slots: the slab grows and the
    # capacity knob follows
    assert pair.port.insert_stats["free_slots"] == 60
    rng = np.random.default_rng(3)
    extra_v = normalize(rng.standard_normal((100, ds.d))).astype(np.float32)
    pair.do("insert_batch", extra_v, ds.metadata[:100].copy())
    assert pair.port.state.shards[0].cap > 1000
    assert pair.port.insert_stats["slab_growths"] == 1
    _check(pair, batches, "grow")

    # the same live slab, carried across, restores in both packages
    ref2 = RefEngine.from_state(copy.deepcopy(pair.ref.state),
                                config=pair.ref.cfg, vocab_sizes=vocab)
    port2 = BatchedEngine.from_state(
        insert_state_from_reference(pair.ref.state), config=pair.port.cfg,
        device="cpu", vocab_sizes=vocab)
    _assert_state_equal(ref2, port2)
    _assert_search_equal(ref2, port2, batches, "from_state")
    _assert_search_equal(pair.ref, port2, batches, "from_state/live",
                         same_history=False)


@pytest.mark.parametrize("seed_backend", SEED_BACKENDS)
def test_deferred_repair_and_maintenance_loop_match_reference(seed_backend):
    """Deferred ingest, deletes, a budgeted maintenance step, a full drain
    (repair then compaction), growth under deferral, and ``from_state``:
    both packages agree on every step's kind and accounting and on the
    state and searches after it. The build graph is narrower than the
    append path's 1.5 x graph_k edges, so the slab's adjacency widens."""
    ds = _tiny()
    vocab = tuple(ds.vocab_sizes)
    knobs = {"walk.k": 5, "walk.beam_width": 2, "graph.graph_k": 8,
             "serve.capacity": 320, "atlas.v_cap": 512,
             "serve.seed_backend": seed_backend,
             "maintenance.defer_repair": True,
             "maintenance.compact_min_rows": 4,
             "maintenance.compact_tombstone_frac": 0.05,
             "maintenance.repair_batch_rows": 16}
    pair = _Pair(_index(ds, 200, 8, 10), knobs, vocab)
    assert pair.port.state.shards[0].adjacency.shape[1] == 12
    batches = _batches(ds, per=3)
    loops = (RefLoop(pair.ref, pair.ref.cfg.maintenance),
             MaintenanceLoop(pair.port, pair.port.cfg.maintenance))
    assert [lp.step() for lp in loops] == [{"kind": "idle"}] * 2
    _check(pair, batches, "build")

    pair.do("insert_batch", ds.vectors[200:240], ds.metadata[200:240])
    assert pair.port.state.pending_rows == 40
    _check(pair, batches, "deferred insert")

    pair.do("delete_batch", np.arange(0, 30))
    assert loops[1].pending_work() == loops[0].pending_work()
    _check(pair, batches, "delete")

    out_r, out_p = (lp.step(budget_rows=16) for lp in loops)
    assert out_p == out_r and out_p["kind"] == "repair"
    _check(pair, batches, "step")

    tot_r, tot_p = (lp.run_until_idle() for lp in loops)
    assert tot_p == tot_r and tot_p["reclaimed"] == 30
    for attr in ("steps", "repaired_rows", "reclaimed_rows", "reclusters"):
        assert getattr(loops[1], attr) == getattr(loops[0], attr), attr
    assert loops[1].idle
    _check(pair, batches, "drain")

    # fill the slab, then grow it, with repair still deferred
    pair.do("insert_batch", ds.vectors[240:320], ds.metadata[240:320])
    rng = np.random.default_rng(4)
    extra_v = normalize(rng.standard_normal((40, ds.d))).astype(np.float32)
    pair.do("insert_batch", extra_v, ds.metadata[:40].copy())
    assert pair.port.insert_stats["slab_growths"] == 1
    _check(pair, batches, "grow")
    tot_r, tot_p = (lp.run_until_idle() for lp in loops)
    assert tot_p == tot_r
    _check(pair, batches, "drain after grow")

    port2 = BatchedEngine.from_state(
        insert_state_from_reference(pair.ref.state), config=pair.port.cfg,
        device="cpu", vocab_sizes=vocab)
    _assert_search_equal(pair.ref, port2, batches, "from_state",
                         same_history=False)


# -- behavioural cases -------------------------------------------------------------

def test_unconstrained_search_never_returns_unwritten_or_deleted(full_ds):
    """An unconstrained predicate passes every live row: the validity
    bitmap alone must fence the unwritten capacity tail and the
    tombstones, and the port returns exactly the reference's ids."""
    ds = full_ds
    vocab = tuple(ds.vocab_sizes)
    pair = _Pair(_index(ds, 600, 16, 48),
                 {"walk.k": 10, "walk.beam_width": 4, "graph.graph_k": 16,
                  "serve.capacity": 1000, "atlas.v_cap": 1024}, vocab)
    rng = np.random.default_rng(0)
    src = rng.integers(0, 600, 6)
    queries = [Query(vector=v, predicate=FilterPredicate.make({}))
               for v in ds.vectors[src]]
    live = set(range(600))

    def check():
        ids_r, _ = pair.ref.search(queries)
        ids_p, _ = pair.port.search(queries_from_reference(queries))
        for a, b in zip(ids_r, ids_p):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
            assert b.size == 10
            assert live.issuperset(b.tolist()), "dead or unwritten row"

    check()
    pair.do("insert_batch", ds.vectors[600:650], ds.metadata[600:650])
    live.update(range(600, 650))
    check()
    # delete the queries' own source rows: each was its query's top hit
    gone = np.unique(np.concatenate([src, np.arange(600, 610)]))
    pair.do("delete_batch", gone)
    live.difference_update(gone.tolist())
    check()


def test_not_sees_brand_new_code_after_insert():
    """An insert that introduces a brand-new code widens the engine's and
    the index's per-field domains, so ``Not`` and open-ended ``Range``
    reach the new rows — in the port as in the reference."""
    ds = _tiny_ds(n=260)
    base_n = 200
    index = _index(ds, base_n, 16, 48)
    pair = _Pair(index, {"walk.k": 10, "walk.beam_width": 4,
                         "graph.graph_k": 16, "serve.capacity": 260}, None)
    new_code = int(ds.metadata[:base_n, 0].max()) + 1
    assert pair.port.vocab_sizes[0] == new_code
    rng = np.random.default_rng(9)
    new_v = normalize(rng.standard_normal((40, ds.d))).astype(np.float32)
    new_m = np.zeros((40, ds.metadata.shape[1]), np.int32)
    new_m[:, 0] = new_code
    _, gids = pair.do("insert_batch", new_v, new_m)
    assert pair.port.vocab_sizes[0] == new_code + 1
    assert pair.port.index.vocab_sizes()[0] == new_code + 1
    for pred in (Not(In(0, [0])), Range(0, new_code - 1, None)):
        q = [Query(vector=new_v[0], predicate=pred)]
        ids_r, _ = pair.ref.search(q)
        ids_p, _ = pair.port.search(queries_from_reference(q))
        np.testing.assert_array_equal(ids_p[0], np.asarray(ids_r[0]))
        assert set(gids.tolist()) & set(ids_p[0].tolist()), pred


@pytest.mark.parametrize("kind", ["none", "walk", "full"])
def test_graph_k_default_matches_reference(sel_sweep, kind):
    """The engine resolves its config as the reference does: no config or
    a bare WalkConfig takes the append path's graph_k=16, a full FnsConfig
    keeps its own."""
    import warnings

    _, index, _ = sel_sweep
    cfgs = {"none": (None, None),
            "walk": (RefWalk(k=5), WalkConfig(k=5)),
            "full": (RefConfig().with_knobs({"graph.graph_k": 24}),
                     FnsConfig().with_knobs({"graph.graph_k": 24}))}
    ref_cfg, port_cfg = cfgs[kind]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = RefEngine(index, ref_cfg)
        port = BatchedEngine(index_from_reference(index), port_cfg,
                             device="cpu")
    assert port.cfg.graph.graph_k == ref.cfg.graph.graph_k
    assert port.cfg.graph.graph_k == (24 if kind == "full" else 16)


def test_fence_repacks_when_a_publish_lands():
    """A publish between a batch's pack and its search (a delete in the
    ``serve.pre-dispatch`` window) makes the fence re-pack once; the batch
    reports the generation it ran against, which the reference matches."""
    ds = _tiny()
    vocab = tuple(ds.vocab_sizes)
    pair = _Pair(_index(ds, 300, 8, 16),
                 {"walk.k": 5, "walk.beam_width": 2, "graph.graph_k": 8,
                  "serve.capacity": 320, "atlas.v_cap": 512}, vocab)
    qs = _batches(ds, per=2)["conj"]
    gen0 = pair.port.publish_generation

    def delete_once(eng):
        done = []

        def action():
            if not done:
                done.append(True)
                eng.delete_batch([0])
        return action

    from repro import faults as ref_faults
    ref_faults.arm("serve.pre-dispatch", delete_once(pair.ref))
    faults.arm("serve.pre-dispatch", delete_once(pair.port))
    try:
        ids_r, st_r = pair.ref.search(qs)
        ids_p, st_p = pair.port.search(queries_from_reference(qs))
    finally:
        ref_faults.disarm()
        faults.disarm()
    assert pair.port.fence_retries == pair.ref.fence_retries == 1
    assert st_p["generation"] == st_r["generation"] == gen0 + 1
    for a, b in zip(ids_r, ids_p):
        np.testing.assert_array_equal(b, np.asarray(a))
        assert 0 not in b.tolist()


def test_live_index_needs_a_capacity_engine(sel_sweep):
    """A fixed-size engine refuses inserts, deletes and a maintenance loop
    with guidance, as the reference's does."""
    _, index, _ = sel_sweep
    eng = BatchedEngine(index_from_reference(index), device="cpu")
    assert eng.state is None and eng.insert_stats is None
    with pytest.raises(ValueError, match="capacity"):
        eng.insert_batch(index.vectors[:2], index.metadata[:2])
    with pytest.raises(ValueError, match="capacity"):
        eng.delete_batch([0])
    with pytest.raises(ValueError, match="capacity"):
        MaintenanceLoop(eng)
