"""The port's checkpoint module (``repro_torch.checkpoint.ckpt``, no jax):
the reference's checkpoint cases (roundtrip, atomic tmp dirs, keep-last-k,
async save and its failure re-raise, stale-tmp sweep, per-leaf CRC32,
newest-readable fallback) on torch-tensor trees, plus the format shared
with the reference: the same flat leaf keys as
``jax.tree_util.tree_flatten_with_path``, the same manifest bytes, and
checkpoints either package writes load in the other with equal CRCs."""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro_torch.checkpoint import ckpt


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(rng.standard_normal((4, 3))),
                       "layers": {"ln": torch.from_numpy(
                           rng.standard_normal(7))}},
            "opt": {"step": torch.tensor(5, dtype=torch.int32)}}


def _np_tree(t):
    return {"params": {"w": t["params"]["w"].numpy(),
                       "layers": {"ln": t["params"]["layers"]["ln"].numpy()}},
            "opt": {"step": t["opt"]["step"].numpy()}}


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 10, t)
    restored, step = ckpt.restore(str(tmp_path), 10, t)
    assert step == 10
    np.testing.assert_array_equal(restored["params"]["w"],
                                  t["params"]["w"].numpy())
    assert restored["opt"]["step"].dtype == np.int32
    assert int(restored["opt"]["step"]) == 5


def test_atomicity_tmp_ignored(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000002.tmp")  # simulated torn write
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_keep_last_k(tmp_path):
    t = _tree()
    for s in range(6):
        ckpt.save(str(tmp_path), s, t, keep=2)
    assert ckpt.all_steps(str(tmp_path)) == [4, 5]


def test_async_save(tmp_path):
    th = ckpt.save(str(tmp_path), 3, _tree(), asynchronous=True)
    th.join()
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    bad = {"params": {"w": torch.zeros((2, 2)),
                      "layers": {"ln": torch.zeros(7)}},
           "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), 1, bad)


def test_async_failure_reraised_on_next_save(tmp_path, monkeypatch):
    """A failed async write is recorded and re-raised by the next ``save``
    for that directory (and by ``wait()``); the save after that works."""
    t = _tree()

    def boom(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(ckpt.np, "savez", boom)
    th = ckpt.save(str(tmp_path), 1, t, asynchronous=True)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        th.wait()
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="previous asynchronous"):
        ckpt.save(str(tmp_path), 2, t)
    ckpt.save(str(tmp_path), 2, t)
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_stale_tmp_swept_on_save(tmp_path):
    os.makedirs(tmp_path / "step_00000009.tmp")  # a crashed writer's debris
    ckpt.save(str(tmp_path), 1, _tree())
    assert not (tmp_path / "step_00000009.tmp").exists()
    assert ckpt.latest_step(str(tmp_path)) == 1


def _flip_leaf_byte(npz, leaf: np.ndarray) -> None:
    raw = bytearray(npz.read_bytes())
    at = raw.find(np.ascontiguousarray(leaf).tobytes()[:8])
    assert at >= 0
    raw[at + 3] ^= 0xFF
    npz.write_bytes(bytes(raw))


def test_checksum_detects_corruption(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 4, t)
    _flip_leaf_byte(tmp_path / "step_00000004" / "arrays.npz",
                    t["params"]["w"].numpy())
    with pytest.raises(ckpt.CheckpointCorruption):
        ckpt.load_arrays(str(tmp_path), 4)


def test_manifest_crc_detects_swapped_arrays(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree(seed=1))
    ckpt.save(str(tmp_path), 2, _tree(seed=2))
    shutil.copy(tmp_path / "step_00000001" / "arrays.npz",
                tmp_path / "step_00000002" / "arrays.npz")
    with pytest.raises(ckpt.CheckpointCorruption, match="CRC32"):
        ckpt.load_arrays(str(tmp_path), 2)
    arrays, _ = ckpt.load_arrays(str(tmp_path), 2, verify=False)
    assert "params/w" in arrays
    m = tmp_path / "step_00000001" / "manifest.json"
    d = json.loads(m.read_text())
    del d["crc32"]  # pre-checksum manifests stay readable
    m.write_text(json.dumps(d))
    arrays, _ = ckpt.load_arrays(str(tmp_path), 1)
    assert "params/w" in arrays


def test_restore_latest_falls_back_to_readable(tmp_path):
    t, t2 = _tree(seed=1), _tree(seed=2)
    ckpt.save(str(tmp_path), 1, t)
    ckpt.save(str(tmp_path), 2, t2)
    _flip_leaf_byte(tmp_path / "step_00000002" / "arrays.npz",
                    t2["params"]["w"].numpy())
    restored, step = ckpt.restore_latest(str(tmp_path), t)
    assert step == 1
    np.testing.assert_array_equal(restored["params"]["w"],
                                  t["params"]["w"].numpy())
    (arrays, _), step2 = ckpt.restore_latest(str(tmp_path))
    assert step2 == 1 and "params/w" in arrays
    (tmp_path / "step_00000001" / "manifest.json").write_text("{not json")
    with pytest.raises(ckpt.CheckpointCorruption, match="no readable"):
        ckpt.restore_latest(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_latest(str(tmp_path / "empty"))


def test_restore_with_shardings_raises(tmp_path):
    """Placement by sharding is ported (``tests/test_torch_lm_mesh.py``);
    a shardings tree without a ``NamedSharding`` for a leaf raises."""
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    with pytest.raises(TypeError, match="no NamedSharding"):
        ckpt.restore(str(tmp_path), 1, t, shardings={"any": None})


# -- the format shared with the reference ------------------------------------

def _jax_keys(tree) -> list[str]:
    out = []
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                       for p in path)
        out.append(key or "_root")
    return out


@pytest.fixture(scope="module")
def live_state():
    """A small reference live index with inserts, a delete and a deferred
    backlog, carried over to the port."""
    from repro.core import AnchorAtlas, FiberIndex, build_alpha_knn
    from repro.core.batched.engine import BatchedEngine
    from repro.core.config import FnsConfig
    from repro.core.types import Dataset
    from repro.data.synth import make_selectivity_dataset
    from repro_torch.interop import insert_state_from_reference

    ds = make_selectivity_dataset((0.5, 0.1), n=300, d=16, n_components=6,
                                  seed=5)
    base = Dataset(ds.vectors[:260], ds.metadata[:260], ds.field_names,
                   ds.vocab_sizes)
    index = FiberIndex(base.vectors, base.metadata,
                       build_alpha_knn(base.vectors, k=8, r_max=24),
                       AnchorAtlas.build(base, n_clusters=6, seed=0))
    eng = BatchedEngine(index, FnsConfig().with_knobs(
        {"serve.capacity": 320, "graph.graph_k": 8,
         "maintenance.defer_repair": True}))
    eng.insert_batch(ds.vectors[260:290], ds.metadata[260:290])
    eng.delete_batch([3, 265])
    return eng.state, insert_state_from_reference(eng.state)


def test_flatten_keys_match_jax(live_state):
    """Flat keys, in order, equal ``tree_flatten_with_path``'s on
    ``state_to_tree`` output and on trees with lists, tuples, None and a
    bare leaf."""
    from repro.serve.durability import state_to_tree as ref_to_tree
    from repro_torch.serve.durability import state_to_tree

    ref_state, port_state = live_state
    tree = state_to_tree(port_state, {"x": 1})
    assert list(ckpt._flatten(tree)) == _jax_keys(ref_to_tree(ref_state,
                                                              {"x": 1}))
    assert list(ckpt._flatten(tree)) == _jax_keys(tree)
    odd = {"b": [np.zeros(2), (np.ones(1), None)], "a": {"z": 1, "c": 2.0},
           "n": None}
    int_keyed = {10: [np.zeros(3)], 2: np.ones(2)}
    for t in (odd, int_keyed):
        assert list(ckpt._flatten(t)) == _jax_keys(t)
    assert list(ckpt._flatten(np.zeros(3))) == _jax_keys(np.zeros(3)) \
        == ["_root"]


def test_port_checkpoint_loads_in_reference(tmp_path, live_state):
    """A snapshot tree the port writes (torch leaves on the CPU) loads in
    the reference's ``load_arrays`` with equal CRCs and equal arrays, and
    its manifest is byte-identical to the reference's for the same tree."""
    from repro.serve.durability import state_to_tree as ref_to_tree
    from repro_torch.serve.durability import state_to_tree

    ref_state, port_state = live_state
    port_tree = state_to_tree(port_state, {"svc": "x"})
    port_tree["shard0"]["vectors"] = torch.from_numpy(
        port_tree["shard0"]["vectors"])
    ckpt.save(str(tmp_path / "p"), 7, port_tree, meta={"m": 1})
    ref_ckpt.save(str(tmp_path / "r"), 7, ref_to_tree(ref_state,
                                                      {"svc": "x"}),
                  meta={"m": 1})
    arrays_p, man_p = ref_ckpt.load_arrays(str(tmp_path / "p"), 7)
    arrays_r, man_r = ref_ckpt.load_arrays(str(tmp_path / "r"), 7)
    assert man_p["crc32"] == man_r["crc32"]
    assert list(arrays_p) == list(arrays_r)
    for k in arrays_r:
        np.testing.assert_array_equal(arrays_p[k], arrays_r[k])
        assert arrays_p[k].dtype == arrays_r[k].dtype
    assert ((tmp_path / "p" / "step_00000007" / "manifest.json").read_bytes()
            == (tmp_path / "r" / "step_00000007" / "manifest.json")
            .read_bytes())


def test_reference_checkpoint_loads_in_port(tmp_path):
    """A jax tree the reference writes loads in the port with equal CRCs,
    through ``load_arrays``, ``restore`` and ``restore_latest``."""
    import jax.numpy as jnp

    # float32 leaves: jax (no x64) stores float64 input as float32
    t = jax.tree_util.tree_map(
        lambda x: x.float() if x.is_floating_point() else x, _tree(seed=3))
    jt = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), t)
    ref_ckpt.save(str(tmp_path), 2, jt)
    arrays, man = ckpt.load_arrays(str(tmp_path), 2)
    assert man["crc32"] == {k: ckpt._leaf_crc(v) for k, v in arrays.items()}
    restored, step = ckpt.restore(str(tmp_path), 2, t)
    assert step == 2
    np.testing.assert_equal(restored, _np_tree(t))
    (arrays2, _), step2 = ckpt.restore_latest(str(tmp_path))
    assert step2 == 2 and list(arrays2) == list(arrays)
