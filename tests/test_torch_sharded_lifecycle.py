"""The port's live sharded index (``ShardedEngine(mesh=None)`` with a
capacity slab per shard) driven op for op beside the reference's on the
same index: inserts (inline and deferred repair), deletes, compaction,
growth past capacity, the maintenance loop and ``index_from_state``.
After every step the host slabs, the stacked device tensors, the atlas
leaves and the searches (ids, walks, hops) of a conjunctive, an OR and a
range batch must agree exactly. Also runs the port's two sharded smokes
(``insert._smoke``, ``lifecycle._smoke``) on the CPU.
"""
import copy

import jax
import numpy as np
import pytest

from repro.core.batched import lifecycle as ref_lifecycle
from repro.core.batched.sharded import ShardedEngine as RefEngine
from repro.core.batched.sharded import build_sharded_index as ref_build
from repro.core.batched.sharded import index_from_state as ref_from_state
from repro.core.config import FnsConfig as RefConfig
from repro.core.types import normalize
from repro.data.synth import add_timestamp_field
from repro.serve.maintenance import MaintenanceLoop as RefLoop
from repro_torch.core.batched import insert, lifecycle
from repro_torch.core.batched.sharded import ShardedEngine, index_from_state
from repro_torch.core.config import FnsConfig
from repro_torch.interop import (bitmap_to_numpy, insert_state_from_reference,
                                 queries_from_reference,
                                 sharded_index_from_reference)
from repro_torch.serve.maintenance import MaintenanceLoop

from test_insert import _full_dataset
from test_torch_lifecycle import _batches
from test_torch_sharded import assert_atlas_equal, assert_search_equal


class _Pair:
    """A reference and a port sharded engine (``device="cpu"``) over the
    same carried-over index; ``do`` applies one method to both."""

    def __init__(self, ref_sidx, knobs):
        self.ref = RefEngine(ref_sidx, None, RefConfig().with_knobs(knobs))
        self.port = ShardedEngine(sharded_index_from_reference(ref_sidx,
                                                               "cpu"),
                                  None, FnsConfig().with_knobs(knobs),
                                  device="cpu")

    def do(self, method, *args, **kw):
        return (getattr(self.ref, method)(*args, **kw),
                getattr(self.port, method)(*args, **kw))


def _assert_state_equal(ref, port, tag):
    """Host slabs, stacked device tensors and atlas leaves equal."""
    rs, ps = ref.state, port.state
    assert len(ps.shards) == len(rs.shards)
    for s, (r, p) in enumerate(zip(rs.shards, ps.shards)):
        assert p.n_valid == r.n_valid
        for name in ("vectors", "metadata", "adjacency", "live",
                     "global_ids"):
            np.testing.assert_array_equal(getattr(p, name), getattr(r, name),
                                          err_msg=f"{tag} shard {s} {name}")
        for name in ("assign", "centroids", "base_counts", "base_centroids"):
            np.testing.assert_array_equal(getattr(p.atlas, name),
                                          getattr(r.atlas, name),
                                          err_msg=f"{tag} {s} atlas.{name}")
    assert ps.pending == [tuple(e) for e in rs.pending]
    assert ps.stats() == rs.stats()
    for name in ("vectors", "adjacency", "metadata", "global_ids"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=f"{tag} device {name}")
    np.testing.assert_array_equal(bitmap_to_numpy(port.valid_bm),
                                  np.asarray(ref.valid_bm), err_msg=tag)
    assert_atlas_equal(port.datlas,
                       jax.tree_util.tree_unflatten(ref._tdef, ref._leaves),
                       tag)
    assert port.n == ref.n
    assert port.publish_generation == ref.publish_generation
    assert port.vocab_sizes == ref.vocab_sizes
    assert port.cfg.flatten() == ref.cfg.flatten()


def _check(pair, batches, tag):
    _assert_state_equal(pair.ref, pair.port, tag)
    for name, qs in batches.items():
        ids_r, st_r = pair.ref.search(qs)
        ids_p, st_p = pair.port.search(queries_from_reference(qs))
        assert_search_equal((ids_r, st_r), (ids_p, st_p), f"{tag}/{name}")
        assert st_p["generation"] == st_r["generation"]


@pytest.fixture(scope="module")
def full_ds():
    # ts codes stay below v_cap so the rows can be inserted
    return add_timestamp_field(_full_dataset(), domain=1024)


KNOBS = {"walk.k": 10, "walk.beam_width": 4, "graph.graph_k": 16,
         "graph.r_max": 48, "atlas.v_cap": 1024}


def test_insert_delete_compact_grow_match_reference(full_ds):
    """Build with capacity on 2 shards, insert (inline repair), delete,
    compact, insert to the last free slot, grow past capacity, and carry
    the live state across with ``index_from_state``: both packages agree
    after every step."""
    ds = full_ds
    knobs = {**KNOBS, "serve.capacity": 1000}
    ref_sidx = ref_build(ds.vectors[:750], ds.metadata[:750], 2,
                         config=RefConfig().with_knobs(knobs))
    pair = _Pair(ref_sidx, knobs)
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

    pair.do("insert_batch", ds.vectors[875:1000], ds.metadata[875:1000])
    _check(pair, batches, "refill")

    # 200 rows into the last 120 free slots: every shard's slab grows and
    # the capacity knob follows
    assert pair.port.insert_stats["free_slots"] == 120
    rng = np.random.default_rng(3)
    extra_v = normalize(rng.standard_normal((200, ds.d))).astype(np.float32)
    pair.do("insert_batch", extra_v, ds.metadata[:200].copy())
    assert pair.port.state.shards[0].cap > 500
    assert pair.port.insert_stats["slab_growths"] == 1
    _check(pair, batches, "grow")

    # the same live state, carried across, restores in both packages
    vocab = pair.ref.vocab_sizes
    ref2 = RefEngine(ref_from_state(copy.deepcopy(pair.ref.state), vocab),
                     None, pair.ref.cfg)
    port2 = ShardedEngine(
        index_from_state(insert_state_from_reference(pair.ref.state), vocab,
                         device="cpu"), None, pair.port.cfg, device="cpu")
    for name, qs in batches.items():
        out_p = port2.search(queries_from_reference(qs))
        assert_search_equal(ref2.search(qs), out_p, f"from_state/{name}")
        assert_search_equal(pair.ref.search(qs), out_p,
                            f"from_state/live/{name}")


def test_deferred_repair_and_maintenance_loop_match_reference(full_ds):
    """Deferred ingest on 4 shards, a delete, a budgeted maintenance step
    and a full drain (repair, then compaction): both packages agree on
    every step's accounting and on the state and searches after it."""
    ds = full_ds
    knobs = {**KNOBS, "serve.capacity": 1000,
             "maintenance.defer_repair": True,
             "maintenance.compact_min_rows": 4,
             "maintenance.compact_tombstone_frac": 0.05,
             "maintenance.repair_batch_rows": 32}
    ref_sidx = ref_build(ds.vectors[:800], ds.metadata[:800], 4,
                         config=RefConfig().with_knobs(knobs))
    pair = _Pair(ref_sidx, knobs)
    batches = _batches(ds, per=3)
    loops = (RefLoop(pair.ref, pair.ref.cfg.maintenance),
             MaintenanceLoop(pair.port, pair.port.cfg.maintenance))

    pair.do("insert_batch", ds.vectors[800:900], ds.metadata[800:900])
    assert pair.port.state.pending_rows == 100
    _check(pair, batches, "deferred insert")

    pair.do("delete_batch", np.arange(0, 60))
    _check(pair, batches, "delete")

    out_r, out_p = (lp.step(budget_rows=32) for lp in loops)
    assert out_p == out_r and out_p["kind"] == "repair"
    _check(pair, batches, "step")

    tot_r, tot_p = (lp.run_until_idle() for lp in loops)
    assert tot_p == tot_r and tot_p["reclaimed"] == 60
    assert pair.port.state.pending_rows == 0
    _check(pair, batches, "drained")


@pytest.mark.parametrize("smoke", [insert._smoke, lifecycle._smoke],
                         ids=["insert", "lifecycle"])
def test_sharded_smokes_on_cpu(smoke, capsys):
    smoke("cpu")
    assert "smoke ok" in capsys.readouterr().out
