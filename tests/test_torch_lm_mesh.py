"""The LM's serving over a device mesh (``ShardEnv(mesh)``,
``launch/placement.py``, the LM's ``launch/shardings.py``,
``make_production_mesh``, ``moe_ffn(..., mesh)``,
``flash_decode_sharded``, the mesh-placed cache, ``ServeEngine`` and
``EncodedRetriever`` over a mesh, ``ckpt.restore(shardings=)``) on meshes
of CPU cells (``devices=["cpu"] * n``).

The reference runs on 8 virtual CPU devices
(``--xla_force_host_platform_device_count=8``) with ``Auto`` mesh axes
(``jax.make_mesh``'s default ``Explicit`` axes fail under jax 0.9), one
subprocess a module (MoE; flash decode and a sharded checkpoint; the
model passes in fp32 on 2 x 4 and on 1 x 8, and in bf16), all started
together; its specs need no devices (``AbstractMesh``) and run here.

Tolerances, stated per test: specs and checkpoints exact; the MoE and
flash decode within 1e-5 of their largest magnitude in fp32; prefill
logits and embeddings within ``F32_ATOL`` (1e-5) in fp32 and the LM
tests' bf16 bounds (logits within 2e-2, embeddings at cosine >= 0.9995)
in bf16; decode over a mesh within 1e-5 of the port's meshless decode
and of its prefill over the longer sequence in fp32 (the port's cache
keeps room for decode, unlike the reference's, so decode is held to the
port); a mesh of one cell bit for bit equal to ``mesh=None``.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

import _torch_parity  # noqa: F401  (one torch thread a process)
import repro.models.common as ref_common
import repro.models.transformer as ref_tf
from repro.configs import base as ref_configs
from repro.launch import mesh as ref_mesh_lib
from repro.launch import shardings as ref_sh
from repro.models import kvcache as ref_kvcache
from repro.models import moe as ref_moe
from repro_torch import interop
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as configs
from repro_torch.core.types import Dataset, FilterPredicate
from repro_torch.core.search import SearchParams
from repro_torch.launch import placement as pl
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import attention, common, kvcache, moe
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.retrieval import EncodedRetriever, RetrievalService

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL = 1e-5
F32_REL = 1e-5
BF16_LOGIT_ATOL = 2e-2
BF16_COS = 0.9995
AXES = ("data", "model")
SPEC_MESHES = ((2, 4), (1, 8), (4, 2), (16, 16), (2, 16, 16))
POLICIES = ("tp", "dp", "sp")
PASS_ARCHS = ("llama3.2-1b", "gemma3-1b", "internvl2-76b", "dbrx-132b",
              "kimi-k2-1t-a32b")
PASS_MESHES = ((2, 4), (1, 8))
PASS_B, PASS_S = 4, 16
MOE_CASES = {   # name -> (mesh, mode, S, capacity factor)
    "2x4_train": ((2, 4), "train", 16, 1.25),
    "1x8_train": ((1, 8), "train", 16, 1.25),
    "4x2_train": ((4, 2), "train", 16, 1.25),
    "2x4_decode": ((2, 4), "decode", 16, 1.25),
    "1x8_decode": ((1, 8), "decode", 16, 1.25),
    "4x2_decode": ((4, 2), "decode", 16, 1.25),
    "2x4_drops": ((2, 4), "train", 16, 0.5),
    "2x4_seq_fallback": ((2, 4), "train", 6, 1.25),
}
FLASH_CASES = {   # name -> (mesh, cache_len, window)
    "1x8_len27": ((1, 8), 27, 0),
    "1x8_len27_w10": ((1, 8), 27, 10),
    "2x4_len27": ((2, 4), 27, 0),
    "2x4_len40_w10": ((2, 4), 40, 10),
}


# -- shared inputs (also imported by the reference subprocesses) -----------

def ref_mesh(shape):
    """A reference mesh with ``Auto`` axes over the virtual devices."""
    names = AXES if len(shape) == 2 else ("pod",) + AXES
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))


def cpu_mesh(shape):
    """The port's mesh of the same shape, every cell on the host."""
    n = int(np.prod(shape))
    if len(shape) == 3 or n > 8:
        return make_production_mesh(multi_pod=len(shape) == 3,
                                    devices=["cpu"] * n)
    return make_local_mesh(*shape, devices=["cpu"] * n)


def pass_cfg(arch, pkg=configs):
    """The reduced config a pass case runs (a MoE with 8 experts, so they
    split over 8 model cells)."""
    cfg = pkg.reduced_config(arch)
    return dataclasses.replace(cfg, n_experts=8) if cfg.is_moe else cfg


def pass_batch(cfg, B=PASS_B, S=PASS_S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "patch":
        return {"embeds": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   (B, S)).astype(np.int32)}


def pass_keys():
    out = []
    for arch in PASS_ARCHS:
        for shape in PASS_MESHES:
            for pol in POLICIES:
                out.append(f"{arch}|{shape[0]}x{shape[1]}|{pol}|f32")
            out.append(f"{arch}|{shape[0]}x{shape[1]}|tp|bf16")
    return out


def moe_inputs(S, cf):
    """(ref config, x (4, S, d) fp32, the reference's MoE leaves)."""
    cfg = dataclasses.replace(pass_cfg("dbrx-132b", ref_configs),
                              capacity_factor=cf)
    x = np.random.default_rng(3).standard_normal(
        (4, S, cfg.d_model)).astype(np.float32)
    return cfg, x, ref_tf._init_moe(jax.random.PRNGKey(2), cfg)


def flash_inputs():
    """q (2, 1, 4, 32) and caches (2, 64, 2, 32), fp32."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, 2, 32)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return ref_tf.init_params(pass_cfg(arch, ref_configs),
                              jax.random.PRNGKey(0))


# -- the reference's runs --------------------------------------------------

PRELUDE = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys; sys.path.insert(0, "src"); sys.path.insert(0, "tests")
    import numpy as np
    import jax, jax.numpy as jnp
    import test_torch_lm_mesh as T
"""

REF_SCRIPTS = {
    "moe": PRELUDE + """
    from repro.models import moe as ref_moe
    out = {}
    for name, (shape, mode, S, cf) in T.MOE_CASES.items():
        cfg, x, params = T.moe_inputs(S, cf)
        dims = ref_moe.MoEDims(cfg.n_experts, cfg.moe_top_k, cf)
        mesh = T.ref_mesh(shape)
        f = jax.jit(lambda x, p: ref_moe.moe_ffn(x, p, dims, mesh,
                                                 mode=mode))
        out[name] = np.asarray(f(jnp.asarray(x), params))
    np.savez(sys.argv[1], **out)
    print("reference ok")
""",
    "flash_ckpt": PRELUDE + """
    from repro.checkpoint import ckpt as ref_ckpt
    from repro.launch import shardings as ref_sh
    from repro.models import attention as ref_attn
    q, k, v = T.flash_inputs()
    out = {}
    for name, (shape, clen, w) in T.FLASH_CASES.items():
        mesh = T.ref_mesh(shape)
        f = jax.jit(lambda q, k, v, c: ref_attn.flash_decode_sharded(
            q, k, v, c, mesh=mesh, seq_axis="model", window=w))
        out[name] = np.asarray(f(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.int32(clen)))
    np.savez(sys.argv[1], **out)
    # a checkpoint of llama's parameters placed on a 2 x 4 mesh
    cfg = T.pass_cfg("llama3.2-1b", T.ref_configs)
    mesh = T.ref_mesh((2, 4))
    params = jax.device_put(T.ref_params("llama3.2-1b"),
                            ref_sh.param_shardings(cfg, mesh,
                                                   T.ref_params("llama3.2-1b")))
    ref_ckpt.save(sys.argv[2], 7, {"params": params})
    print("reference ok")
""",
}

PASS_SCRIPT = PRELUDE + """
    import repro.models.common as ref_common
    import repro.models.transformer as ref_tf
    from repro.launch import shardings as ref_sh
    which = sys.argv[2]
    if which.startswith("f32"):
        ref_common.CDT = ref_tf.CDT = jnp.float32
    out = {}
    for key in T.pass_keys():
        arch, mesh_name, pol, dt = key.split("|")
        if (dt == "bf16") != (which == "bf16") or \\
                (which != "bf16" and mesh_name != which[4:]):
            continue
        cfg = T.pass_cfg(arch, T.ref_configs)
        mesh = T.ref_mesh(tuple(int(n) for n in mesh_name.split("x")))
        env = ref_tf.ShardEnv(mesh, policy=pol)
        params = jax.device_put(T.ref_params(arch), ref_sh.param_shardings(
            cfg, mesh, T.ref_params(arch), pol))
        batch = {k: jnp.asarray(v) for k, v in T.pass_batch(cfg).items()}
        f = jax.jit(lambda p, b: (ref_tf.prefill(p, b, cfg, env)[0],
                                  ref_tf.encode(p, b, cfg, env)))
        logits, emb = f(params, batch)
        out[key + "|logits"] = np.asarray(logits, np.float32)
        out[key + "|embed"] = np.asarray(emb, np.float32)
        if cfg.is_moe and dt == "bf16":
            out[key + "|routes"] = T.ref_prefill_routes(cfg, env, params,
                                                        batch)
    np.savez(sys.argv[1], **out)
    print("reference ok")
"""


def ref_prefill_routes(cfg, env, params, batch):
    """The expert ids each cell of the reference's mesh chose in each MoE
    layer of one ``prefill`` (L, data, model, T_loc, k): a
    ``jax.debug.callback`` in its ``_route`` with the cell's axis
    indices; a cell runs its layers in order."""
    seen, real = {}, ref_moe._route

    def route(x, w, dims):
        ids, weights = real(x, w, dims)
        jax.debug.callback(
            lambda a, i, j: seen.setdefault((int(i), int(j)), []).append(
                np.asarray(a)),
            ids, jax.lax.axis_index("data"), jax.lax.axis_index("model"))
        return ids, weights

    ref_moe._route = route
    try:
        jax.block_until_ready(jax.jit(
            lambda p, b: ref_tf.prefill(p, b, cfg, env)[0])(params, batch))
        jax.effects_barrier()
    finally:
        ref_moe._route = real
    n_data, n_model = (env.mesh.shape[a] for a in AXES)
    return np.stack([np.stack([np.stack(seen[i, j]) for j in range(n_model)])
                     for i in range(n_data)]).transpose(2, 0, 1, 3, 4)


class PortRoutes:
    """While open, each cell's expert ids of every ``moe._route`` call,
    in its order, by the cell's mesh index."""

    def __enter__(self):
        self.real, self.seen = moe._route, {}

        def route(x, w, dims):
            ids, weights = self.real(x, w, dims)
            self.seen.setdefault(pl.current_cell().index, []).append(
                ids.clone())
            return ids, weights

        moe._route = route
        return self.seen

    def __exit__(self, *exc):
        moe._route = self.real


def same_route_rows(ref_routes, port_seen, B):
    """(B,) bool: the batch rows every one of whose tokens chose, in every
    MoE layer, the experts the reference chose (the capacity path's
    blocks: batch over data, sequence over model)."""
    L, n_data, n_model, T_loc, k = ref_routes.shape
    b_loc = B // n_data
    same = np.ones(B, bool)
    for i in range(n_data):
        for j in range(n_model):
            got = np.stack([a.numpy() for a in port_seen[i, j]])
            agree = (np.sort(got, -1) == np.sort(ref_routes[:, i, j],
                                                 -1)).all(axis=(0, 2))
            same[i * b_loc:(i + 1) * b_loc] &= \
                agree.reshape(b_loc, -1).all(axis=1)
    return same


class ReferenceRuns:
    """Every reference subprocess, started at once; ``get(name)`` waits
    for one and returns its arrays."""

    def __init__(self, tmp):
        self.tmp, self.procs, self.paths = tmp, {}, {}
        self.ckpt_dir = os.path.join(tmp, "ref_ckpt")
        jobs = {name: [script] for name, script in REF_SCRIPTS.items()}
        jobs["flash_ckpt"].append(self.ckpt_dir)
        for which in ("f32_2x4", "f32_1x8", "bf16"):
            jobs[which] = [PASS_SCRIPT, which]
        for name, (script, *extra) in jobs.items():
            path = os.path.join(tmp, f"{name}.npz")
            self.paths[name] = path
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(script), path,
                 *extra], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env={**os.environ, "JAX_PLATFORMS": "cpu"})

    @functools.lru_cache(maxsize=None)
    def get(self, name) -> dict:
        out, err = self.procs[name].communicate(timeout=400)
        assert self.procs[name].returncode == 0, out + err
        assert "reference ok" in out
        return dict(np.load(self.paths[name]))

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def ref_runs():
    with tempfile.TemporaryDirectory() as tmp:
        runs = ReferenceRuns(tmp)
        try:
            yield runs
        finally:
            runs.close()


@pytest.fixture
def fp32(monkeypatch):
    """Both packages compute in fp32 (their ``CDT`` patched)."""
    monkeypatch.setattr(ref_common, "CDT", jnp.float32)
    monkeypatch.setattr(ref_tf, "CDT", jnp.float32)
    monkeypatch.setattr(common, "CDT", torch.float32)
    monkeypatch.setattr(tf, "CDT", torch.float32)


def _spec(s) -> tuple:
    return tuple(s.spec)


def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                     for p in path): leaf for path, leaf in leaves}


def _meta(records: dict) -> dict:
    return {k: torch.empty(shape, dtype=dt, device="meta")
            for k, (shape, dt) in records.items()}


# -- the mesh, its placement and its cells -------------------------------------

def test_make_production_mesh_matches_reference(monkeypatch):
    """The reference's production meshes (their shape and axes, read off
    its ``jax.make_mesh`` call) and the port's on as many host cells; the
    port's raises without cards."""
    seen = []
    monkeypatch.setattr(ref_mesh_lib.jax, "make_mesh",
                        lambda shape, axes: seen.append((shape, axes)))
    for multi in (False, True):
        ref_mesh_lib.make_production_mesh(multi_pod=multi)
        shape, axes = seen[-1]
        m = make_production_mesh(multi_pod=multi,
                                 devices=["cpu"] * int(np.prod(shape)))
        assert m.devices.shape == tuple(shape) and m.axis_names == axes
        assert tuple(m.shape.values()) == tuple(shape)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_production_mesh()


def test_place_and_gather_share_one_copy():
    """Blocks of a tensor on cells of its own device are views of it; a
    replicated tensor is the tensor itself on every cell; ``gather``
    rebuilds it; a tuple entry splits major to minor."""
    mesh = cpu_mesh((2, 4))
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    rep = pl.place(x, pl.NamedSharding(mesh, pl.P()))
    assert all(s is x for s in rep.shards.flat)
    both = pl.place(x, pl.NamedSharding(mesh, pl.P(("data", "model"))))
    for idx in np.ndindex(2, 4):
        blk = both.local(idx)
        assert blk.untyped_storage().data_ptr() == \
            x.untyped_storage().data_ptr()
        torch.testing.assert_close(blk, x[idx[0] * 4 + idx[1]:][:1],
                                   rtol=0, atol=0)
    split = pl.place(x, pl.NamedSharding(mesh, pl.P("data", None, "model")))
    assert split.local((1, 2)).shape == (4, 6, 1)
    assert torch.equal(pl.gather(split), x)
    assert torch.equal(pl.gather(both), x)
    with pytest.raises(ValueError, match="does not split"):
        pl.place(x, pl.NamedSharding(mesh, pl.P(None, "model")))
    assert pl.fit(mesh, pl.P(None, "model"), x.shape) == pl.P(None, None,
                                                              None)


def test_cells_collectives_under_stress():
    """``run_cells`` on 16 cells (more threads than cores) with a tiny
    switch interval: 150 rounds of psum, pmax, all_gather, all_to_all and
    relayout, every result equal to what the cells' inputs give, within
    a time bound; a cell that raises ends the run with its error, and the
    mesh's threads then run the next call (no cell left waiting)."""
    mesh = make_local_mesh(4, 4, devices=["cpu"] * 16)
    rounds = 150

    def fn(cell):
        me = float(cell.flat)
        for r in range(rounds):
            x = torch.full((4,), me + r)
            s = cell.psum(x, "model")
            row = [cell.index[0] * 4 + j for j in range(4)]
            assert s[0].item() == sum(row) + 4 * r
            assert cell.pmax(x, ("data", "model"))[0].item() == 15 + r
            g = cell.all_gather(x[:1], "data", 0)
            assert g.tolist() == [i * 4 + cell.index[1] + r
                                  for i in range(4)]
            a = cell.all_to_all(torch.arange(4.) + 10 * me, "model")
            assert a.tolist() == [10 * (cell.index[0] * 4 + j)
                                  + cell.index[1] for j in range(4)]
            y = cell.relayout(torch.full((1, 4), me), pl.P("data"),
                              pl.P(None, "model"))
            assert y[:, 0].tolist() == [i * 4 + cell.index[1]
                                        for i in range(4)]
        return cell.flat

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = time.time()
        out = pl.run_cells(mesh, fn)
        assert time.time() - t < 120
    finally:
        sys.setswitchinterval(old)
    assert sorted(out.flat) == list(range(16))

    def bad(cell):
        if cell.flat == 5:
            raise KeyError("cell 5")
        cell.psum(torch.ones(1), "model")

    with pytest.raises(KeyError, match="cell 5"):
        pl.run_cells(mesh, bad)
    # no cell was left waiting: the mesh's threads run the next call
    assert sorted(pl.run_cells(mesh, lambda c: c.flat).flat) == \
        list(range(16))


# -- specs ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_specs_match_reference(arch):
    """Every parameter leaf's spec of the full config, under tp, dp and
    sp, on 2 x 4, 1 x 8, 4 x 2, 16 x 16 and 2 x 16 x 16: the reference's
    (on ``jax.eval_shape`` leaves and an ``AbstractMesh``) equals the
    port's on its stacked layout (``interop.reference_shapes`` of a
    ``meta`` module) exactly, and on its per-layer layout with the
    stack's leading None dropped."""
    cfg_r, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    specs_r = ref_tf.param_specs(cfg_r)
    port = tf.init_params(cfg, device="meta")
    stacked = interop.reference_shapes(port)
    for shape in SPEC_MESHES:
        names = AXES if len(shape) == 2 else ("pod",) + AXES
        am = AbstractMesh(shape, names)
        mesh = cpu_mesh(shape)
        for pol in POLICIES:
            want = {k: _spec(v) for k, v in _ref_flat(
                ref_sh.param_shardings(cfg_r, am, specs_r, pol)).items()}
            got = {k: _spec(v) for k, v in ckpt._flatten(
                sh.param_shardings(cfg, mesh, stacked, pol)).items()}
            assert got == want, (shape, pol)
            per_layer = ckpt._flatten(sh.param_shardings(cfg, mesh, port,
                                                         pol))
            for key, s in per_layer.items():
                parts = key.split("/")
                if parts[0] in ("layers", "enc_layers"):
                    ref_key = "/".join([parts[0]] + parts[2:])
                    assert _spec(s) == want[ref_key][1:], (key, pol)
                else:
                    assert _spec(s) == want[key], (key, pol)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_batch_and_cache_specs_match_reference(arch):
    """``batch_shardings`` (tp and dp) of every serving shape's inputs
    and ``cache_shardings`` of its decode cache equal the reference's on
    every mesh shape."""
    cfg_r, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    for shape in SPEC_MESHES:
        names = AXES if len(shape) == 2 else ("pod",) + AXES
        am, mesh = AbstractMesh(shape, names), cpu_mesh(shape)
        for name, spec in configs.SHAPES.items():
            if spec.kind == "train":
                continue
            batch = _meta(cfg.input_specs(name))
            for pol in ("tp", "dp"):
                want = {k: _spec(v) for k, v in ref_sh.batch_shardings(
                    cfg_r, am, cfg_r.input_specs(name), pol).items()}
                got = {k: _spec(v) for k, v in sh.batch_shardings(
                    cfg, mesh, batch, pol).items()}
                assert got == want, (shape, name, pol)
            want = {k: _spec(v) for k, v in ref_sh.cache_shardings(
                cfg_r, am, ref_kvcache.cache_specs(
                    cfg_r, ref_configs.SHAPES[name])).items()}
            cache = _meta(kvcache.cache_specs(cfg, spec))
            got = {k: _spec(v) for k, v in sh.cache_shardings(
                cfg, mesh, cache).items()}
            assert got == want, (shape, name)


def test_mesh_placed_params_hold_one_copy():
    """``MeshParams`` on a 2 x 4 mesh of host cells: every cell's leaf is
    a view of the module's own tensor, a replicated leaf the same tensor
    on every cell, a split leaf its block; placing allocates nothing."""
    cfg = configs.reduced_config("llama3.2-1b")
    port = tf.init_params(cfg, device="cpu")
    env = tf.ShardEnv(cpu_mesh((2, 4)))
    placed = tf.place_params(port, env)
    assert tf.place_params(placed, env) is placed
    src = ckpt._flatten(port.tree())
    for idx in np.ndindex(2, 4):
        local = ckpt._flatten(placed.cells[idx].tree())
        for key, leaf in local.items():
            assert leaf.untyped_storage().data_ptr() == \
                src[key].untyped_storage().data_ptr(), key
    a = ckpt._flatten(placed.cells[0, 0].tree())
    b = ckpt._flatten(placed.cells[1, 3].tree())
    assert a["layers/0/ln1"].data_ptr() == b["layers/0/ln1"].data_ptr()
    assert a["layers/0/attn/wq"].shape == (cfg.d_model, cfg.n_heads // 4
                                           * cfg.hd)
    assert a["layers/0/attn/wq"].data_ptr() != \
        b["layers/0/attn/wq"].data_ptr()


# -- MoE and flash decode ------------------------------------------------------

@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_matches_reference_mesh(ref_runs, name):
    """``moe_ffn`` over a mesh of host cells against the reference's on
    the same mesh shape, fp32 within 1e-5 of the largest output: the
    capacity path (``_moe_a2a``) on 2 x 4, 1 x 8 and 4 x 2, the dropless
    decode path (``_moe_replicated``), a capacity factor of 0.5 that
    drops tokens (the output differs from the dropless one) and a
    sequence of 6 that does not split over 4 model cells (the dropless
    path, though the mode is train)."""
    shape, mode, S, cf = MOE_CASES[name]
    cfg, x, params = moe_inputs(S, cf)
    tree = tf.Tree({k: torch.from_numpy(np.array(v, np.float32))
                    for k, v in params.items()})
    dims = moe.MoEDims(cfg.n_experts, cfg.moe_top_k, cf)
    with torch.no_grad():
        got = moe.moe_ffn(torch.from_numpy(x), tree, dims, cpu_mesh(shape),
                          mode=mode)
        dropless = moe.moe_ffn(torch.from_numpy(x), tree, dims,
                               mode="decode")
    want = ref_runs.get("moe")[name]
    err = float(np.abs(got.numpy() - want).max())
    assert got.shape == x.shape and err <= F32_REL * np.abs(want).max(), err
    moved = (got - dropless).abs().amax(-1)
    if name == "2x4_drops":
        assert bool((moved > 1e-3).any())
    if name == "2x4_seq_fallback":
        assert float(moved.max()) <= F32_REL * float(dropless.abs().max())


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_decode_sharded_matches_reference(ref_runs, name):
    """``flash_decode_sharded`` over the sequence split on the model axis
    (8 blocks of 8 on 1 x 8, 4 of 16 on 2 x 4) with ``cache_len`` inside a
    middle block and the later blocks empty, with and without a window:
    within 1e-5 of the reference's and of ``decode_attention`` (fp32)."""
    shape, clen, w = FLASH_CASES[name]
    q, k, v = (torch.from_numpy(a) for a in flash_inputs())
    got = attention.flash_decode_sharded(q, k, v, clen, mesh=cpu_mesh(shape),
                                         seq_axis="model", window=w)
    want = ref_runs.get("flash_ckpt")[name]
    plain = attention.decode_attention(q, k, v, clen, window=w)
    assert got.shape == q.shape and torch.isfinite(got).all()
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= F32_REL * scale
    assert float((got - plain).abs().max()) <= F32_REL * scale


# -- the model's passes --------------------------------------------------------

def _logit_err(want, got) -> float:
    w, g = np.asarray(want, np.float32), np.asarray(got, np.float32)
    real = w > -1e29
    assert np.array_equal(real, g > -1e29)
    return float(np.abs(w - g)[real].max())


@pytest.mark.parametrize("key", pass_keys())
def test_prefill_and_encode_match_reference_mesh(ref_runs, monkeypatch,
                                                 key):
    """``prefill`` and ``encode`` over a mesh of host cells against the
    reference's on the same mesh, the parameters placed by
    ``param_shardings`` on both (reduced configs, MoEs with 8 experts,
    batch 4 x 16): fp32 logits and embeddings within 1e-5; bf16 logits
    within 2e-2 and embeddings at cosine >= 0.9995, for a MoE on the batch
    rows whose every token chose the reference's experts in every layer
    (``same_route_rows``: bf16 rounds near-tied router logits apart, and
    a flipped choice changes a row outright; at least half the rows)."""
    arch, mesh_name, pol, dt = key.split("|")
    if dt == "f32":
        for mod, val in ((ref_common, jnp.float32), (ref_tf, jnp.float32),
                         (common, torch.float32), (tf, torch.float32)):
            monkeypatch.setattr(mod, "CDT", val)
    cfg = pass_cfg(arch)
    port = interop.params_from_reference(ref_params(arch), cfg,
                                         device="cpu")
    env = tf.ShardEnv(cpu_mesh(tuple(int(n) for n in
                                     mesh_name.split("x"))), policy=pol)
    port = tf.place_params(port, env)
    batch = pass_batch(cfg)
    with PortRoutes() as seen:
        logits, cache = tf.prefill(port, batch, cfg, env)
    emb = tf.encode(port, batch, cfg, env).numpy()
    runs = ref_runs.get("bf16" if dt == "bf16" else f"f32_{mesh_name}")
    want_l, want_e = runs[key + "|logits"], runs[key + "|embed"]
    assert logits.shape == want_l.shape and emb.shape == want_e.shape
    assert isinstance(cache["k"], pl.Sharded) and cache["pos"] == PASS_S
    if dt == "f32":
        assert _logit_err(want_l, logits) <= F32_ATOL
        np.testing.assert_allclose(emb, want_e, atol=F32_ATOL, rtol=0)
        return
    rows = np.ones(PASS_B, bool)
    if cfg.is_moe:   # near-tied router logits flip in bf16: held rows
        rows = same_route_rows(runs[key + "|routes"], seen, PASS_B)
        assert rows.sum() >= PASS_B // 2, rows
    assert _logit_err(want_l[rows], logits[rows]) <= BF16_LOGIT_ATOL
    assert (emb * want_e).sum(axis=1)[rows].min() >= BF16_COS


DECODE_CASES = [(a, (2, 4), p) for a in PASS_ARCHS for p in POLICIES] + \
    [(a, (1, 8), "tp") for a in PASS_ARCHS]


@pytest.mark.parametrize("arch,shape,pol", DECODE_CASES)
def test_decode_over_mesh_matches_meshless(fp32, arch, shape, pol):
    """Teacher-forced ``decode_step``s over a mesh (the cache placed by
    ``cache_shardings``, written in place cell by cell) against the
    port's meshless decode and its prefill over the longer sequence
    (fp32, 1e-5; a MoE at a dropless capacity factor for the latter:
    decode is dropless)."""
    cfg = pass_cfg(arch)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.moe_top_k)
    port = tf.init_params(cfg, seed=1, device="cpu")
    env = tf.ShardEnv(cpu_mesh(shape), policy=pol)
    placed = tf.place_params(port, env)
    full = pass_batch(cfg, S=PASS_S + 2, seed=2)
    key = "embeds" if "embeds" in full else "tokens"
    _, c_mesh = tf.prefill(placed, {key: full[key][:, :PASS_S]}, cfg, env,
                           cache_len=PASS_S + 2)
    _, c_one = tf.prefill(port, {key: full[key][:, :PASS_S]}, cfg,
                          tf.ONE_DEVICE, cache_len=PASS_S + 2)
    for t in range(2):
        step = {key: full[key][:, PASS_S + t:PASS_S + t + 1]}
        l_mesh, c_mesh = tf.decode_step(placed, c_mesh, step, cfg, env)
        l_one, c_one = tf.decode_step(port, c_one, step, cfg, tf.ONE_DEVICE)
        l_full, _ = tf.prefill(port, {key: full[key][:, :PASS_S + t + 1]},
                               cfg, tf.ONE_DEVICE)
        assert _logit_err(l_one.numpy(), l_mesh.numpy()) <= F32_ATOL
        assert _logit_err(l_full.numpy(), l_mesh.numpy()) <= F32_ATOL
    for name in ("k", "v"):
        np.testing.assert_allclose(pl.gather(c_mesh[name]).numpy(),
                                   c_one[name].numpy(), atol=F32_ATOL,
                                   rtol=0)


def test_decode_with_sequence_split_cache(fp32):
    """A batch of 1 on a 2 x 4 mesh: the cache's sequence splits over the
    model axis (``cache_shardings``), and each decode step writes one
    cell's block and combines the cells' attention by flash decode; the
    logits within 1e-5 of the meshless decode's."""
    cfg = pass_cfg("llama3.2-1b")
    port = tf.init_params(cfg, seed=1, device="cpu")
    env = tf.ShardEnv(cpu_mesh((2, 4)))
    placed = tf.place_params(port, env)
    toks = pass_batch(cfg, B=1, S=16, seed=5)["tokens"]
    _, c_mesh = tf.prefill(placed, {"tokens": toks[:, :12]}, cfg, env,
                           cache_len=16)
    _, c_one = tf.prefill(port, {"tokens": toks[:, :12]}, cfg,
                          tf.ONE_DEVICE, cache_len=16)
    assert tuple(c_mesh["k"].spec) == (None, None, "model", None, None)
    for t in range(12, 16):
        step = {"tokens": toks[:, t:t + 1]}
        l_mesh, c_mesh = tf.decode_step(placed, c_mesh, step, cfg, env)
        l_one, c_one = tf.decode_step(port, c_one, step, cfg, tf.ONE_DEVICE)
        assert _logit_err(l_one.numpy(), l_mesh.numpy()) <= F32_ATOL
    np.testing.assert_allclose(pl.gather(c_mesh["k"]).numpy(),
                               c_one["k"].numpy(), atol=F32_ATOL, rtol=0)


def _one_cell_batch(cfg, S=8):
    b = pass_batch(cfg, B=2, S=S, seed=6)
    if cfg.family == "audio":
        b["frames"] = np.random.default_rng(7).standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_one_cell_mesh_is_bitwise_meshless(arch):
    """A 1 x 1 mesh runs the one-device pass on its cell: ``prefill``,
    two ``decode_step``s and ``encode`` bit for bit equal to
    ``mesh=None`` for every arch, and ``ServeEngine`` with it runs on the
    cell's device."""
    cfg = configs.reduced_config(arch)
    port = tf.init_params(cfg, device="cpu")
    env = tf.ShardEnv(cpu_mesh((1, 1)))
    batch = _one_cell_batch(cfg)
    key = "embeds" if "embeds" in batch else "tokens"
    extra = {"cache_len": 10} if cfg.family != "audio" else {}
    outs = []
    for e in (env, tf.ONE_DEVICE):
        logits, cache = tf.prefill(port, batch, cfg, e, **extra)
        got = [logits]
        for t in range(2):
            step = {key: batch[key][:, t:t + 1]}
            logits, cache = tf.decode_step(port, cache, step, cfg, e)
            got.append(logits)
        got.append(tf.encode(port, {key: batch[key]}, cfg, e))
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    if cfg.frontend == "none":
        assert ServeEngine(cfg, env, port).device == torch.device("cpu")


@pytest.mark.parametrize("what", ["prefill", "decode_step", "encode"])
def test_passes_refuse_parameters_not_placed_for_the_mesh(what):
    """A pass never places the parameters itself (that would copy the
    model at every call): over a mesh it takes them placed for that mesh
    and policy (``place_params``, once) and raises on a bare module, on
    parameters placed for another mesh or policy, and, without a mesh, on
    placed ones."""
    cfg = configs.reduced_config("llama3.2-1b")
    port = tf.init_params(cfg, device="cpu")
    mesh = cpu_mesh((2, 4))
    env = tf.ShardEnv(mesh)
    batch = pass_batch(cfg, B=2, S=8)
    cache = tf.prefill(tf.place_params(port, env), batch, cfg, env,
                       cache_len=9)[1]
    step = {"tokens": batch["tokens"][:, :1]}
    call = {"prefill": lambda p, e: tf.prefill(p, batch, cfg, e),
            "decode_step": lambda p, e: tf.decode_step(p, dict(cache), step,
                                                       cfg, e),
            "encode": lambda p, e: tf.encode(p, batch, cfg, e)}[what]
    for p, e in ((port, env),
                 (tf.place_params(port, tf.ShardEnv(cpu_mesh((2, 4)))), env),
                 (tf.place_params(port, tf.ShardEnv(mesh, policy="dp")),
                  env),
                 (tf.place_params(port, env), tf.ONE_DEVICE)):
        with pytest.raises(ValueError, match="place_params"):
            call(p, e)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-3b",
                                  "whisper-small"])
def test_unported_families_raise_on_a_larger_mesh(arch, monkeypatch):
    """The hybrid, ssm and audio families serve and train over a mesh of
    more than one cell: ``prefill``, ``decode_step`` and ``encode`` run
    (held to the reference in ``tests/test_torch_family_mesh.py``), and
    ``forward_loss`` there no longer raises: in fp32 (``CDT`` patched) its
    loss is the meshless one within 1e-5 relative (its gradients and
    steps are held to the reference in
    ``tests/test_torch_family_train_mesh.py``)."""
    cfg = configs.reduced_config(arch)
    port = tf.init_params(cfg, device="cpu")
    env = tf.ShardEnv(cpu_mesh((2, 4)))
    placed = tf.place_params(port, env)
    batch = _one_cell_batch(cfg)
    logits, cache = tf.prefill(placed, batch, cfg, env, cache_len=9)
    assert logits.shape[:2] == (2, 1) and torch.isfinite(
        logits[logits > -1e29]).all()
    logits, cache = tf.decode_step(placed, cache,
                                   {"tokens": batch["tokens"][:, :1]}, cfg,
                                   env)
    assert cache["pos"] == 9 and logits.shape[:2] == (2, 1)
    emb = tf.encode(placed, {"tokens": batch["tokens"]}, cfg, env)
    assert emb.shape == (2, cfg.d_model)
    labels = np.random.default_rng(8).integers(
        0, cfg.vocab_size, np.shape(batch["tokens"])).astype(np.int32)
    monkeypatch.setattr(common, "CDT", torch.float32)
    monkeypatch.setattr(tf, "CDT", torch.float32)
    train = {**batch, "labels": labels}
    got = float(tf.forward_loss(placed, train, cfg, env))
    want = float(tf.forward_loss(port, train, cfg, tf.ONE_DEVICE))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_shard_env_helpers_match_reference():
    """``n_model``, ``batch_axes``, ``_b_axes`` and the specs of ``dp3``,
    ``logits3``, ``act3`` and ``heads4`` equal the reference's
    constraints on the same shapes; the constraint helpers place a tensor
    by them."""
    for shape in ((2, 4), (1, 8), (4, 2)):
        am = AbstractMesh(shape, AXES)
        for pol in POLICIES:
            ref = ref_tf.ShardEnv(am, policy=pol)
            env = tf.ShardEnv(cpu_mesh(shape), policy=pol)
            assert (env.n_model, env.batch_axes) == (ref.n_model,
                                                     ref.batch_axes)
            seen = []
            ref_env = dataclasses.replace(ref)
            object.__setattr__(ref_env, "constrain",
                               lambda x, spec: seen.append(tuple(spec)))
            for b in (1, 2, 8, 16):
                assert env._b_axes(b) == ref._b_axes(b)
                for s in (1, 8, 12):
                    x3 = jax.ShapeDtypeStruct((b, s, 64), jnp.float32)
                    x4 = jax.ShapeDtypeStruct((b, s, 8, 16), jnp.float32)
                    for fn, x in (("dp3", x3), ("logits3", x3),
                                  ("act3", x3), ("heads4", x4)):
                        getattr(ref_env, fn)(x)
                        assert tuple(getattr(env, fn + "_spec")(x.shape)) \
                            == seen[-1], (shape, pol, fn, b, s)
    env = tf.ShardEnv(cpu_mesh((2, 4)), policy="sp")
    placed = env.act3(torch.zeros(2, 8, 4))
    assert tuple(placed.spec) == ("data", "model", None)
    assert placed.local((1, 3)).shape == (1, 2, 4)
    with pytest.raises(TypeError, match="Mesh"):
        tf.ShardEnv(object())


# -- serving and checkpoints ---------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "dbrx-132b"])
def test_serve_engine_generates_over_a_mesh(fp32, arch):
    """``ServeEngine`` over a 2 x 4 mesh of host cells (its parameters
    placed once, tokens sampled on the first cell) generates the greedy
    tokens of the meshless engine (fp32; dbrx at a dropless capacity
    factor, since its prefill's drops depend on the mesh); with a mesh,
    ``device=`` must be None."""
    cfg = pass_cfg(arch)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.moe_top_k)
    port = tf.init_params(cfg, seed=3, device="cpu")
    env = tf.ShardEnv(cpu_mesh((2, 4)))
    eng = ServeEngine(cfg, env, port)
    assert isinstance(eng.params, tf.MeshParams)
    toks = pass_batch(cfg, B=4, S=8, seed=8)["tokens"]
    got = eng.generate(toks, max_new=6)
    want = ServeEngine(cfg, tf.ONE_DEVICE, port,
                       device="cpu").generate(toks, max_new=6)
    assert got.device == torch.device("cpu") and torch.equal(got, want)
    with pytest.raises(ValueError, match="device=None"):
        ServeEngine(cfg, env, port, device="cpu")


def test_encoded_retriever_over_a_mesh(fp32):
    """``EncodedRetriever`` encoding over a 1 x 3 mesh (SmolLM's widths
    divided three ways at reduced size: 3 heads, 3 KV heads, d_ff 258 and
    a vocabulary of 600 padded to 768, its masked ids in the last block)
    for a
    meshless service: embeddings within 1e-5 of the meshless encoder's,
    and ``retrieve_batch`` the ids of ``query_batch`` on them."""
    cfg = dataclasses.replace(configs.reduced_config("smollm-135m"),
                              n_heads=3, n_kv_heads=3, d_ff=258,
                              vocab_size=600)
    port = tf.init_params(cfg, seed=4, device="cpu")
    rng = np.random.default_rng(9)
    docs = rng.integers(0, cfg.vocab_size, (300, 12)).astype(np.int32)
    vecs = tf.encode(port, {"tokens": docs}, cfg, tf.ONE_DEVICE).numpy()
    meta = rng.integers(0, 4, (300, 2)).astype(np.int32)
    svc = RetrievalService.build(Dataset(vecs, meta, ["a", "b"], [4, 4]),
                                 graph_k=8, r_max=24,
                                 params=SearchParams(k=5, max_hops=50),
                                 device="cpu")
    env = tf.ShardEnv(make_local_mesh(1, 3, devices=["cpu"] * 3))
    retr = EncodedRetriever(cfg, env, port, svc)
    assert isinstance(retr.params, tf.MeshParams)
    prompts = docs[:6]
    got = retr.embed_tokens(prompts)
    np.testing.assert_allclose(got, vecs[:6], atol=F32_ATOL, rtol=0)
    preds = [FilterPredicate.make({0: [i % 4]}) for i in range(6)]
    ids, _ = retr.retrieve_batch(prompts, preds)
    ids_q, _ = svc.query_batch(got, preds)
    assert all(np.array_equal(a, b) for a, b in zip(ids, ids_q))


def _stacked(port):
    """``port``'s parameters in the reference's stacked layout, as
    tensors."""
    return pl.map_with_path(lambda _, x: torch.from_numpy(x),
                            interop.tree_to_reference(port))


@pytest.mark.parametrize("arch", ["dbrx-132b", "hymba-1.5b", "rwkv6-3b"])
def test_restore_reshards_across_meshes(tmp_path, arch):
    """A checkpoint of parameters placed on a 2 x 4 mesh (the reference's
    stacked layout) restores onto 1 x 8 and 4 x 2 by ``param_shardings``
    there: every leaf gathered equal to the saved one, every cell's block
    equal to placing it directly; ``restore_latest`` passes the
    shardings through (a MoE, the hybrid's mamba leaves, rwkv6's flat
    leaves)."""
    cfg = pass_cfg(arch)
    port = tf.init_params(cfg, seed=5, device="cpu")
    tree = _stacked(port)
    src = pl.place_tree(tree, sh.param_shardings(cfg, cpu_mesh((2, 4)),
                                                 tree))
    ckpt.save(str(tmp_path), 3, {"params": src})
    like = {"params": interop.reference_shapes(port)}
    for shape in ((1, 8), (4, 2)):
        where = {"params": sh.param_shardings(cfg, cpu_mesh(shape),
                                              like["params"])}
        got, step = ckpt.restore(str(tmp_path), 3, like, where)
        assert step == 3
        flat_got, flat_want = ckpt._flatten(got), ckpt._flatten(
            {"params": tree})
        flat_where = ckpt._flatten(where)
        for key, leaf in flat_got.items():
            assert isinstance(leaf, pl.Sharded)
            assert torch.equal(pl.gather(leaf), flat_want[key]), key
            direct = pl.place(flat_want[key], flat_where[key])
            for idx in np.ndindex(shape):
                assert torch.equal(leaf.local(idx), direct.local(idx))
        latest, step = ckpt.restore_latest(str(tmp_path), like, where)
        assert step == 3 and isinstance(
            ckpt._flatten(latest)["params/unembed"], pl.Sharded)


def test_restore_reference_sharded_checkpoint(ref_runs):
    """A checkpoint the reference saved from llama's parameters placed on
    a 2 x 4 mesh of 8 virtual devices restores onto the port's 2 x 4 and
    1 x 8 meshes, every leaf equal to the reference's parameters."""
    ref_runs.get("flash_ckpt")
    cfg = pass_cfg("llama3.2-1b")
    ref = ref_params("llama3.2-1b")
    port = interop.params_from_reference(ref, cfg, device="cpu")
    like = {"params": interop.reference_shapes(port)}
    want = _ref_flat({"params": ref})
    for shape in ((2, 4), (1, 8)):
        where = {"params": sh.param_shardings(cfg, cpu_mesh(shape),
                                              like["params"])}
        got, step = ckpt.restore(ref_runs.ckpt_dir, 7, like, where)
        assert step == 7
        for key, leaf in ckpt._flatten(got).items():
            np.testing.assert_array_equal(pl.gather(leaf).numpy(),
                                          np.asarray(want[key]), key)
