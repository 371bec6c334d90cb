"""Training over a device mesh (``launch.shardings.opt_shardings`` with
ZeRO-1, ``forward_loss`` on the cells under autograd, the gradient sync
``placement.psum_partials``, ``optim.adamw`` on placed parameters and
state, ``TrainLoop.try_resume(shardings)``, ``interop`` of placed trees)
on meshes of CPU cells (``devices=["cpu"] * n``).

The reference runs on 8 virtual CPU devices with ``Auto`` mesh axes, as
in ``tests/test_torch_lm_mesh.py``: its jitted ``value_and_grad`` of
``forward_loss`` and its jitted ``make_train_step`` with the
parameters, optimizer state and batch placed by its shardings, in fp32
(``CDT`` patched, as the port is here), four subprocesses started
together by a module fixture; one of them also saves a sharded
checkpoint. Its specs need no devices (``AbstractMesh``) and run here.

Tolerances, stated per test: specs exact; the loss within
``LOSS_REL`` (1e-5) relative and each gradient leaf within
``GRAD_REL`` (1e-4) of its largest magnitude; after two steps m and v
within ``MOMENT_TOL[sync]`` of their largest magnitude and the
parameters within ``PARAM_LR_TOL`` x lr (``tests/test_torch_train.py``'s
bounds); the port's mesh step within ``MESHLESS_REL`` (1e-5) of its
meshless one; a mesh of one cell bit for bit; ZeRO-1 on vs off within
``tests/test_zero1.py``'s own bounds.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

import _torch_parity  # noqa: F401  (one torch thread a process)
import repro.models.common as ref_common
import repro.models.transformer as ref_tf
import repro.optim.adamw as ref_opt
from repro.configs import base as ref_configs
from repro.launch import shardings as ref_sh
from repro_torch import interop
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as configs
from repro_torch.launch import placement as pl
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, TrainLoop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("data", "model")
SPEC_MESHES = ((2, 4), (4, 2), (1, 8), (16, 16), (2, 16, 16))
POLICIES = ("tp", "dp", "sp")
LOSS_REL, GRAD_REL, MESHLESS_REL = 1e-5, 1e-4, 1e-5
MOMENT_TOL, PARAM_LR_TOL = {"f32": 1e-4, "bf16": 1e-2}, 0.25
B, S, STEPS = 8, 16, 2
OCFG = dict(peak_lr=3e-3, warmup_steps=1, total_steps=50)
GRAD_CASES = {   # name -> (arch, mesh, policy)
    "llama_2x4_tp": ("llama3.2-1b", (2, 4), "tp"),
    "llama_4x2_dp": ("llama3.2-1b", (4, 2), "dp"),
    "llama_2x4_sp": ("llama3.2-1b", (2, 4), "sp"),
    "gemma3_2x4_tp": ("gemma3-1b", (2, 4), "tp"),
    "internvl_2x4_tp": ("internvl2-76b", (2, 4), "tp"),
    "dbrx_2x4_tp": ("dbrx-132b", (2, 4), "tp"),
    "kimi_2x4_tp": ("kimi-k2-1t-a32b", (2, 4), "tp"),
}
STEP_CASES = {   # name -> (arch, mesh, policy, grad sync, ZeRO-1)
    "llama_2x4_tp_f32": ("llama3.2-1b", (2, 4), "tp", "f32", False),
    "llama_2x4_tp_f32_z1": ("llama3.2-1b", (2, 4), "tp", "f32", True),
    "llama_2x4_tp_bf16": ("llama3.2-1b", (2, 4), "tp", "bf16", False),
    "llama_2x4_tp_bf16_z1": ("llama3.2-1b", (2, 4), "tp", "bf16", True),
    "llama_4x2_dp_f32": ("llama3.2-1b", (4, 2), "dp", "f32", False),
    "llama_4x2_dp_bf16_z1": ("llama3.2-1b", (4, 2), "dp", "bf16", True),
    "dbrx_2x4_tp_f32_z1": ("dbrx-132b", (2, 4), "tp", "f32", True),
}
# the reference's sharded checkpoint: this step case's state after
# CKPT_AT steps, then one more step whose loss and state the port's
# resume onto RESUME_ONTO is held to
CKPT_CASE, CKPT_AT = "llama_2x4_tp_f32_z1", STEPS
RESUME_ONTO = ((4, 2), "dp", True)
JOBS = {"grads_dense": ["llama_2x4_tp", "llama_4x2_dp", "llama_2x4_sp",
                        "gemma3_2x4_tp"],
        "grads_moe": ["internvl_2x4_tp", "dbrx_2x4_tp", "kimi_2x4_tp"],
        "steps_tp": ["llama_2x4_tp_f32", "llama_2x4_tp_bf16",
                     "llama_2x4_tp_bf16_z1", "llama_2x4_tp_f32_z1"],
        "steps_other": ["llama_4x2_dp_f32", "llama_4x2_dp_bf16_z1",
                        "dbrx_2x4_tp_f32_z1"]}


# -- shared inputs (also imported by the reference subprocesses) -----------

def train_cfg(arch, pkg=configs):
    """The reduced config a case trains (kimi-k2 at a capacity factor
    of 1.0, at which its experts overflow)."""
    cfg = pkg.reduced_config(arch)
    if arch == "kimi-k2-1t-a32b":
        cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    return cfg


def train_batch(cfg, step=0):
    """Step ``step``'s batch (B, S): tokens or patch embeddings, and
    labels, numpy-seeded."""
    rng = np.random.default_rng(100 + step)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "patch":
        out["embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (B, S)).astype(np.int32)
    return out


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return ref_tf.init_params(train_cfg(arch, ref_configs),
                              jax.random.PRNGKey(0))


def ref_mesh(shape):
    return jax.make_mesh(shape, AXES, axis_types=(AxisType.Auto,) * 2)


def cpu_mesh(shape):
    n = int(np.prod(shape))
    if len(shape) == 3 or n > 8:
        return make_production_mesh(multi_pod=len(shape) == 3,
                                    devices=["cpu"] * n)
    return make_local_mesh(*shape, devices=["cpu"] * n)


def ocfg(sync, pkg=adamw):
    return pkg.AdamWConfig(**OCFG, grad_sync_dtype=sync)


def flat(tree) -> dict:
    """Reference-layout leaves by their ``/``-joined path, fp32 numpy."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def run_reference(name, ckpt_dir) -> dict:
    """One case on the reference's mesh (in a subprocess with 8 virtual
    devices and ``CDT`` patched to fp32): a grad case's loss and
    gradients, or a step case's losses and its parameters, m and v after
    STEPS steps; the checkpoint case also saves its state after CKPT_AT
    steps to ``ckpt_dir`` from the mesh and runs one step more."""
    from repro.checkpoint import ckpt as ref_ckpt
    from repro.models.common import use_mesh
    if name in GRAD_CASES:
        arch, shape, pol = GRAD_CASES[name]
        cfg, mesh = train_cfg(arch, ref_configs), ref_mesh(shape)
        env = ref_tf.ShardEnv(mesh, policy=pol)
        batch = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
        params = jax.device_put(ref_params(arch), ref_sh.param_shardings(
            cfg, mesh, ref_params(arch), pol))
        batch = jax.device_put(batch, ref_sh.batch_shardings(cfg, mesh,
                                                             batch, pol))
        with use_mesh(mesh):
            loss, g = jax.jit(jax.value_and_grad(
                lambda p, b: ref_tf.forward_loss(p, b, cfg, env)))(params,
                                                                   batch)
        return {f"{name}|loss": np.asarray(loss),
                **{f"{name}|g|{k}": v for k, v in flat(g).items()}}
    arch, shape, pol, sync, zero1 = STEP_CASES[name]
    cfg, mesh = train_cfg(arch, ref_configs), ref_mesh(shape)
    env = ref_tf.ShardEnv(mesh, policy=pol)
    params = ref_params(arch)
    opt = ref_opt.init_opt_state(params)
    p_sh = ref_sh.param_shardings(cfg, mesh, params, pol)
    o_sh = ref_sh.opt_shardings(cfg, mesh, jax.eval_shape(lambda: opt), pol,
                                zero1)
    batches = [{k: jnp.asarray(v) for k, v in train_batch(cfg, i).items()}
               for i in range(STEPS + 1)]
    b_sh = ref_sh.batch_shardings(cfg, mesh, batches[0], pol)
    out, losses = {}, []
    with use_mesh(mesh):
        step = jax.jit(ref_opt.make_train_step(cfg, env, ocfg(sync, ref_opt)),
                       in_shardings=(p_sh, o_sh, b_sh),
                       out_shardings=(p_sh, o_sh, None))
        p, o = jax.device_put(params, p_sh), jax.device_put(opt, o_sh)
        for i in range(STEPS):
            p, o, m = step(p, o, batches[i])
            losses.append(float(m["loss"]))
            if i == 0:   # the state the port's second step starts from
                for what, tree in (("p", p), ("m", o["m"]), ("v", o["v"])):
                    out.update({f"{name}|s1|{what}|{k}": v
                                for k, v in flat(tree).items()})
        out[f"{name}|losses"] = np.asarray(losses)
        out[f"{name}|lr"] = np.asarray(m["lr"])
        for what, tree in (("p", p), ("m", o["m"]), ("v", o["v"])):
            out.update({f"{name}|{what}|{k}": v
                        for k, v in flat(tree).items()})
        if name == CKPT_CASE:
            ref_ckpt.save(ckpt_dir, CKPT_AT, {"params": p, "opt": o})
            p, o, m = step(p, o, batches[CKPT_AT])
            out["ckpt|loss"] = np.asarray(m["loss"])
            for what, tree in (("m", o["m"]), ("v", o["v"])):
                out.update({f"ckpt|{what}|{k}": v
                            for k, v in flat(tree).items()})
    return out


REF_SCRIPT = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys; sys.path.insert(0, "src"); sys.path.insert(0, "tests")
    import numpy as np
    import jax.numpy as jnp
    import repro.models.common as ref_common
    import repro.models.transformer as ref_tf
    import test_torch_train_mesh as T
    ref_common.CDT = ref_tf.CDT = jnp.float32
    out = {}
    for name in sys.argv[2].split(","):
        out.update(T.run_reference(name, sys.argv[3]))
    np.savez(sys.argv[1], **out)
    print("reference ok")
"""


class ReferenceRuns:
    """Every reference subprocess (``JOBS``), started at once; ``get(name)``
    waits for the job that runs case ``name`` and returns its arrays."""

    def __init__(self, tmp):
        self.ckpt_dir = os.path.join(tmp, "ref_ckpt")
        self.procs, self.paths = {}, {}
        for job, names in JOBS.items():
            self.paths[job] = os.path.join(tmp, f"{job}.npz")
            self.procs[job] = subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(REF_SCRIPT),
                 self.paths[job], ",".join(names), self.ckpt_dir], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env={**os.environ, "JAX_PLATFORMS": "cpu"})

    @functools.lru_cache(maxsize=None)
    def job(self, job) -> dict:
        out, err = self.procs[job].communicate(timeout=600)
        assert self.procs[job].returncode == 0, out + err
        assert "reference ok" in out
        return dict(np.load(self.paths[job]))

    def get(self, name) -> dict:
        job = next(j for j, names in JOBS.items() if name in names)
        return self.job(job)

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


@pytest.fixture(autouse=True)
def fp32(monkeypatch):
    """The port computes in fp32 here (its ``CDT`` patched), as the
    reference's subprocesses do."""
    monkeypatch.setattr(common, "CDT", torch.float32)
    monkeypatch.setattr(tf, "CDT", torch.float32)


def _sub(records: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in records.items()
            if k.startswith(prefix)}


def _rel_errs(want: dict, got: dict) -> dict:
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].shape == got[k].shape, k
    return {k: float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in want}


def _worst(errs: dict):
    k = max(errs, key=errs.get)
    return k, errs[k]


def _port_flat(tree) -> dict:
    """A port tree (placed or not) in the reference's flat layout."""
    return flat(interop.tree_to_reference(tree))


def _setup(arch, shape, pol, zero1=False):
    """(cfg, env, placed params, placed optimizer state) on a CPU mesh,
    from the reference's weights."""
    cfg = train_cfg(arch)
    env = tf.ShardEnv(cpu_mesh(shape), policy=pol)
    port = interop.params_from_reference(ref_params(arch), cfg, device="cpu")
    params = tf.place_params(port, env)
    where = sh.opt_shardings(cfg, env.mesh, {"m": params, "v": params,
                                             "step": torch.zeros(())},
                             pol, zero1)
    return cfg, env, params, adamw.init_opt_state(params, where)


def _stacked_shardings(cfg, mesh, pol, zero1, params_like):
    """{"params", "opt"} shardings in the reference's stacked layout."""
    stacked = interop.reference_shapes(params_like)
    return {"params": sh.param_shardings(cfg, mesh, stacked, pol),
            "opt": sh.opt_shardings(cfg, mesh, {
                "m": stacked, "v": stacked, "step": torch.zeros(())},
                pol, zero1)}


# -- specs --------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_opt_specs_match_reference(arch):
    """``opt_shardings`` of the full config under tp, dp and sp, ZeRO-1
    off and on, on 2 x 4, 4 x 2, 1 x 8, 16 x 16 and 2 x 16 x 16: the
    reference's specs (on ``jax.eval_shape`` leaves and an
    ``AbstractMesh``) equal the port's on its stacked layout exactly; on
    its per-layer layout each leaf's spec is the stacked one without the
    L entry and, where ZeRO-1 put the data axes on L, the leaf is held by
    the data block that holds its layer there (``stack``), else by
    every cell."""
    cfg_r, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    opt_r = jax.eval_shape(
        lambda: ref_opt.init_opt_state(ref_tf.param_specs(cfg_r)))
    port = tf.init_params(cfg, device="meta")
    stacked = interop.reference_shapes(port)
    step = torch.zeros((), dtype=torch.int32)
    for shape in SPEC_MESHES:
        names = AXES if len(shape) == 2 else ("pod",) + AXES
        am, mesh = AbstractMesh(shape, names), cpu_mesh(shape)
        for pol in POLICIES:
            for zero1 in (False, True):
                want = {
                    k: tuple(v.spec) for k, v in flat_specs(
                        ref_sh.opt_shardings(cfg_r, am, opt_r, pol,
                                             zero1)).items()}
                got = {k: tuple(v.spec) for k, v in ckpt._flatten(
                    sh.opt_shardings(cfg, mesh, {"m": stacked, "v": stacked,
                                                 "step": step},
                                     pol, zero1)).items()}
                assert got == want, (shape, pol, zero1)
                per_layer = ckpt._flatten(sh.opt_shardings(
                    cfg, mesh, {"m": port, "v": port, "step": step}, pol,
                    zero1))
                assert len(per_layer) == 1 + 2 * len(
                    adamw.leaves(port)), (shape, pol)
                for key, s in per_layer.items():
                    parts = key.split("/")
                    if len(parts) < 3 or parts[1] not in ("layers",
                                                           "enc_layers"):
                        assert tuple(s.spec) == want[key] and \
                            s.stack is None, (key, pol, zero1)
                        continue
                    ref = want["/".join(parts[:2] + parts[3:])]
                    assert tuple(s.spec) == ref[1:], (key, pol, zero1)
                    li = int(parts[2])
                    n = cfg.n_layers if parts[1] == "layers" else \
                        cfg.n_enc_layers
                    assert s.stack == (None if ref[0] is None else
                                       (ref[0], li, n)), (key, pol, zero1)


def flat_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return {"/".join(str(p.key) for p in path): leaf
            for path, leaf in leaves}


def test_layer_owned_state_sits_on_its_data_block():
    """Full llama3.2-1b on 2 x 4 with ZeRO-1: layers 0-7's m sit whole
    (in their model blocks) on data block 0 and layers 8-15's on block
    1, as the reference's L dim splits (``P('data', None, 'model')`` for
    ``wq``); ``unembed`` gets ``P('model', 'data')``; the placed state of
    a reduced llama holds one copy of m on the host, each layer's on its
    own data block only."""
    cfg = configs.get_config("llama3.2-1b")
    mesh = cpu_mesh((2, 4))
    port = tf.init_params(cfg, device="meta")
    where = sh.opt_shardings(cfg, mesh, {"m": port, "v": port, "step": None},
                             "tp", True)
    for li in range(16):
        s = where["m"]["layers"][li]["attn"]["wq"]
        assert s.spec == pl.P(None, "model")
        assert s.stack == ("data", li, 16)
        assert [pl.holds(s, (d, 0)) for d in range(2)] == \
            [li < 8, li >= 8]
    assert where["m"]["unembed"].spec == pl.P("model", "data")
    cfg, env, params, opt = _setup("llama3.2-1b", (2, 4), "tp", zero1=True)
    wq = opt["m"]["layers"][1]["attn"]["wq"]
    assert [wq.local((d, m)) is None for d in range(2) for m in range(4)] \
        == [True] * 4 + [False] * 4
    bytes_m = sum({b.untyped_storage().data_ptr():
                   b.untyped_storage().nbytes()
                   for leaf in adamw.leaves(opt["m"])
                   for b in leaf.shards.flat if b is not None}.values())
    assert bytes_m == 4 * sum(p.numel() for p in adamw.leaves(
        interop.params_from_reference(ref_params("llama3.2-1b"), cfg,
                                      device="cpu")))


# -- the sync and the reshard -------------------------------------------------

def test_psum_partials_sums_in_cell_order_then_casts():
    """``psum_partials`` on 2 x 4: a model-split block is the sum of its
    two data cells' partials; a replicated one the sum of all eight in
    cell order, in fp32, and the bf16 sync rounds that sum (the
    reference's: its bf16 gradients are the fp32 sums rounded), each
    block once. Each device gets one sum; a cell whose partial is None
    adds nothing."""
    mesh = cpu_mesh((2, 4))
    rng = np.random.default_rng(0)
    parts = np.empty((2, 4), dtype=object)
    for idx in np.ndindex(2, 4):
        parts[idx] = torch.from_numpy(rng.standard_normal(
            (4, 8)).astype(np.float32))
    split = pl.NamedSharding(mesh, pl.P(None, "model"))
    blocks = np.empty((2, 4), dtype=object)
    for idx in np.ndindex(2, 4):
        blocks[idx] = parts[idx][:, 2 * idx[1]:2 * idx[1] + 2]
    got = pl.psum_partials(blocks, split, (4, 8))
    for m in range(4):
        assert torch.equal(got.local((0, m)), blocks[0, m] + blocks[1, m])
        assert got.local((1, m)) is got.local((0, m))
    rep = pl.NamedSharding(mesh, pl.P())
    want = None
    for idx in np.ndindex(2, 4):
        want = parts[idx] if want is None else want + parts[idx]
    got = pl.psum_partials(parts, rep, (4, 8))
    assert torch.equal(got.local((1, 3)), want)
    assert len({id(x) for x in got.shards.flat}) == 1
    cast = adamw._bf16(got)
    assert cast.dtype == torch.bfloat16
    assert torch.equal(cast.local((0, 2)), want.to(torch.bfloat16))
    assert len({id(x) for x in cast.shards.flat}) == 1
    parts[0, 1] = None
    want = None
    for idx in np.ndindex(2, 4):
        if parts[idx] is not None:
            want = parts[idx] if want is None else want + parts[idx]
    assert torch.equal(pl.psum_partials(parts, rep, (4, 8)).local((0, 0)),
                       want)


def test_reshard_takes_views_and_gathers_once_a_device():
    """``reshard`` to a finer layout takes views of the blocks held (the
    reduce-scatter's second half); back to a coarser one it assembles
    each new block once a device (the all-gather); a layer-owned layout
    (``stack``) is held by its data block only and gathers back whole."""
    mesh = cpu_mesh((2, 4))
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    rep = pl.place(x, pl.NamedSharding(mesh, pl.P(None, "model")))
    fine = pl.reshard(rep, pl.NamedSharding(mesh, pl.P("data", "model")))
    for idx in np.ndindex(2, 4):
        blk = fine.local(idx)
        assert blk.untyped_storage().data_ptr() == \
            x.untyped_storage().data_ptr()
        assert torch.equal(blk, x[4 * idx[0]:][:4, 3 * idx[1]:][:, :3])
    back = pl.reshard(fine, pl.NamedSharding(mesh, pl.P()))
    assert len({id(b) for b in back.shards.flat}) == 1
    assert torch.equal(back.local((1, 2)), x)
    owned = pl.NamedSharding(mesh, pl.P(None, "model"),
                             stack=("data", 3, 4))
    got = pl.reshard(rep, owned)
    assert [got.local((d, 0)) is None for d in range(2)] == [True, False]
    assert torch.equal(pl.gather(got), x)
    assert torch.equal(pl.gather(pl.reshard(got, pl.NamedSharding(
        mesh, pl.P("data")))), x)


# -- loss and gradients vs the reference --------------------------------------

@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_loss_and_grads_match_reference(ref_runs, name):
    """``value_and_grad`` of ``forward_loss`` over the port's mesh (one
    backward over the cells' graph, each leaf's partials synced) vs the
    reference's jitted ``value_and_grad`` on the same mesh shape: the
    loss within LOSS_REL, each gradient leaf (gathered, stacked) within
    GRAD_REL of its largest magnitude, laid out as ``param_shardings``
    places the parameters."""
    arch, shape, pol = GRAD_CASES[name]
    ref = ref_runs.get(name)
    cfg, env, params, _ = _setup(arch, shape, pol)
    batch = train_batch(cfg)
    loss, g = adamw.value_and_grad(
        lambda p: tf.forward_loss(p, batch, cfg, env), params)
    want = float(ref[f"{name}|loss"])
    assert abs(float(loss) - want) <= LOSS_REL * abs(want), (loss, want)
    where = sh.param_shardings(cfg, env.mesh, params, pol)
    for leaf, s in zip(adamw.leaves(g), adamw.leaves(where)):
        assert isinstance(leaf, pl.Sharded) and leaf.spec == s.spec
    k, err = _worst(_rel_errs(_sub(ref, f"{name}|g|"), _port_flat(g)))
    assert err <= GRAD_REL, (k, err)


# -- train steps vs the reference ---------------------------------------------

def _nest(records: dict) -> dict:
    """``/``-joined flat leaves as the reference's nested tree."""
    out: dict = {}
    for k, v in records.items():
        *head, last = k.split("/")
        node = out
        for part in head:
            node = node.setdefault(part, {})
        node[last] = v
    return out


def _check_state(ref, prefix, params, opt, sync, lr):
    for what in ("m", "v"):
        k, err = _worst(_rel_errs(_sub(ref, f"{prefix}|{what}|"),
                                  _port_flat(opt[what])))
        assert err <= MOMENT_TOL[sync], (prefix, what, k, err)
    want, got = _sub(ref, f"{prefix}|p|"), _port_flat(params)
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= PARAM_LR_TOL * lr, \
            (prefix, k)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_steps_match_reference(ref_runs, name):
    """STEPS ``make_train_step`` steps over the port's mesh (f32 or bf16
    sync, ZeRO-1 off or on) vs the reference's jitted step with its
    parameters, state and batch placed by its shardings, each step from
    the reference's state before it (the first from the shared weights,
    the second from the reference's state after the first, carried over
    by ``params_from_reference`` and ``opt_state_from_reference`` onto
    the mesh): each step's loss within LOSS_REL; m and v within
    MOMENT_TOL[sync] of each leaf's largest magnitude; the parameters
    within PARAM_LR_TOL x lr; the new state placed as ``opt_shardings``
    lays it out and the parameters as ``param_shardings``. (Run free, a
    second step also carries the first's rounding: an element whose
    clipped gradient is near eps moves by up to PARAM_LR_TOL x lr, and
    dbrx's m after two free steps then measured 1.9e-4 of its largest
    magnitude.)"""
    arch, shape, pol, sync, zero1 = STEP_CASES[name]
    ref = ref_runs.get(name)
    want = ref[f"{name}|losses"]
    cfg, env, params, opt = _setup(arch, shape, pol, zero1)
    step = adamw.make_train_step(cfg, env, ocfg(sync))
    params, opt, m = step(params, opt, train_batch(cfg))
    np.testing.assert_allclose(float(m["loss"]), want[0], rtol=LOSS_REL)
    _check_state(ref, f"{name}|s1", params, opt, sync, float(m["lr"]))
    placed = tf.place_params(interop.params_from_reference(
        _nest(_sub(ref, f"{name}|s1|p|")), cfg, device="cpu"), env)
    where = sh.opt_shardings(cfg, env.mesh, {"m": placed, "v": placed,
                                             "step": torch.zeros(())},
                             pol, zero1)
    opt = interop.opt_state_from_reference(
        {"m": _nest(_sub(ref, f"{name}|s1|m|")),
         "v": _nest(_sub(ref, f"{name}|s1|v|")), "step": np.int32(1)}, cfg,
        shardings=where)
    params, opt, m = step(placed, opt, train_batch(cfg, 1))
    np.testing.assert_allclose(float(m["loss"]), want[1], rtol=LOSS_REL)
    lr = float(m["lr"])
    np.testing.assert_allclose(lr, ref[f"{name}|lr"], rtol=1e-6)
    _check_state(ref, name, params, opt, sync, lr)
    assert isinstance(params, tf.MeshParams) and params.env is env
    for leaf, s in zip(adamw.leaves(opt), adamw.leaves(where)):
        assert leaf.sharding == s
    assert int(pl.gather(opt["step"])) == STEPS


# -- the port's mesh vs its meshless path -------------------------------------

MESHLESS_CASES = [("llama3.2-1b", (2, 4), "tp", True),
                  ("llama3.2-1b", (4, 2), "dp", True),
                  ("internvl2-76b", (2, 4), "sp", False),
                  ("dbrx-132b", (1, 4), "tp", True)]


@pytest.mark.parametrize("arch,shape,pol,zero1", MESHLESS_CASES)
def test_mesh_step_matches_meshless(arch, shape, pol, zero1):
    """One step over the mesh vs the port's meshless step on the same
    weights and batch (dbrx at a dropless capacity factor, as the
    expert-parallel path's drops depend on the mesh): the loss, the grad
    norm, each gradient leaf, m and v within MESHLESS_REL of their
    largest magnitude; and ``adamw_update`` of the meshless gradients,
    placed, within MESHLESS_REL of the meshless update, leaf by leaf."""
    cfg = train_cfg(arch)
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.moe_top_k)
    port = tf.init_params(cfg, seed=2, device="cpu")
    env = tf.ShardEnv(cpu_mesh(shape), policy=pol)
    placed = tf.place_params(port, env)
    batch = train_batch(cfg)
    where = sh.opt_shardings(cfg, env.mesh, {"m": placed, "v": placed,
                                             "step": torch.zeros(())},
                             pol, zero1)
    oc = ocfg("f32")
    p1, o1, m1 = adamw.make_train_step(cfg, tf.ONE_DEVICE, oc)(
        port, adamw.init_opt_state(port), batch)
    p2, o2, m2 = adamw.make_train_step(cfg, env, oc)(
        placed, adamw.init_opt_state(placed, where), batch)
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= \
        MESHLESS_REL * abs(float(m1["loss"]))
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=MESHLESS_REL)
    _, g1 = adamw.value_and_grad(
        lambda p: tf.forward_loss(p, batch, cfg, tf.ONE_DEVICE), port)
    _, g2 = adamw.value_and_grad(
        lambda p: tf.forward_loss(p, batch, cfg, env), placed)
    for a, b in ((g1, g2), (o1["m"], o2["m"]), (o1["v"], o2["v"])):
        k, err = _worst(_rel_errs(_port_flat(a), _port_flat(b)))
        assert err <= MESHLESS_REL, (k, err)
    g_placed = pl.place_tree(g1, sh.param_shardings(cfg, env.mesh, port,
                                                    pol))
    pu = adamw.adamw_update(g_placed, adamw.init_opt_state(placed, where),
                            placed, oc)[0]
    k, err = _worst(_rel_errs(_port_flat(p1), _port_flat(pu)))
    assert err <= MESHLESS_REL, (k, err)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "dbrx-132b", "hymba-1.5b",
                                  "whisper-small"])
def test_one_cell_mesh_is_bitwise_meshless(arch):
    """A 1 x 1 mesh (as ``launch/train.py`` sets up: ``place_params``,
    ``init_opt_state`` by ``opt_shardings``) trains two steps bit for bit
    as ``mesh=None`` does: losses, grad norms, parameters and state."""
    cfg = configs.reduced_config(arch)
    port = tf.init_params(cfg, device="cpu")
    if cfg.frontend == "frame":
        from repro_torch.data.tokens import TokenPipeline
        batches = [TokenPipeline(cfg.vocab_size, 2, 16, seed=i,
                                 frontend="frame",
                                 d_model=cfg.d_model).get_batch(0)
                   for i in range(2)]
    else:
        batches = [train_batch(cfg, i) for i in range(2)]
    env = tf.ShardEnv(cpu_mesh((1, 1)))
    placed = tf.place_params(port, env)
    runs = []
    for e, p, opt in ((env, placed, adamw.init_opt_state(
            placed, sh.opt_shardings(cfg, env.mesh, {
                "m": placed, "v": placed, "step": None}))),
            (tf.ONE_DEVICE, port, adamw.init_opt_state(port))):
        step = adamw.make_train_step(cfg, e, ocfg("f32"))
        out = []
        for b in batches:
            p, opt, m = step(p, opt, b)
            out.append((m["loss"], m["grad_norm"]))
        runs.append((out, adamw.leaves(p), adamw.leaves(opt)))
    (a, pa, oa), (b, pb, ob) = runs
    assert all(torch.equal(x, y) for u, v in zip(a, b) for x, y in zip(u, v))
    assert all(torch.equal(x, y) for x, y in zip(pa + oa, pb + ob))


# -- ZeRO-1 on vs off ---------------------------------------------------------

@pytest.mark.parametrize("shape,pol", [((4, 2), "dp"), ((2, 4), "tp")])
def test_zero1_matches_unsharded(shape, pol):
    """``tests/test_zero1.py``'s check on the port: three steps of the
    reduced llama with bf16 sync and lr 1e-2, ZeRO-1 off and on: the
    step-1 losses within 1e-5 and all within rtol 2e-3 (its bounds). The
    update is elementwise on the same synced gradients, so they are bit
    for bit equal, and so are the parameters."""
    losses, params = {}, {}
    for zero1 in (False, True):
        cfg, env, p, o = _setup("llama3.2-1b", shape, pol, zero1)
        step = adamw.make_train_step(cfg, env, adamw.AdamWConfig(
            peak_lr=1e-2, warmup_steps=1, grad_sync_dtype="bf16"))
        ls = []
        for _ in range(3):
            p, o, m = step(p, o, train_batch(cfg))
            ls.append(float(m["loss"]))
        losses[zero1], params[zero1] = ls, _port_flat(p)
    a, b = losses[False], losses[True]
    assert abs(a[0] - b[0]) < 1e-5 and np.allclose(a, b, rtol=2e-3), (a, b)
    assert a == b
    for k in params[False]:
        np.testing.assert_array_equal(params[False][k], params[True][k])


# -- resume -------------------------------------------------------------------

def _loop(step, params, opt, cfg, ckpt_dir, total):
    pipe = _Batches(cfg)
    return TrainLoop(LoopConfig(total_steps=total, ckpt_every=STEPS,
                                ckpt_dir=ckpt_dir, log_every=1,
                                async_ckpt=False),
                     step, pipe, params, opt)


class _Batches:
    """``train_batch`` as a step-indexed pipeline."""

    def __init__(self, cfg):
        self.cfg = cfg

    def get_batch(self, step):
        return train_batch(self.cfg, step)


def test_elastic_resume_2x4_to_4x2(tmp_path):
    """``TrainLoop`` on 2 x 4 (tp) runs STEPS steps and checkpoints (the
    reference's stacked layout, placed leaves gathered); a loop on 4 x 2
    (dp, ZeRO-1) resumes it by ``try_resume(shardings)`` in the
    reference's stacked layout and runs two more: its parameters and
    state right after the resume equal the saved ones, placed on 4 x 2
    by those shardings, and its losses follow a straight 2 x 4 run within
    LOSS_REL."""
    cfg, env, params, opt = _setup("llama3.2-1b", (2, 4), "tp")
    step = adamw.make_train_step(cfg, env, ocfg("f32"))
    total = STEPS + 2
    d = str(tmp_path / "ck")
    first = _loop(step, params, opt, cfg, d, STEPS)
    first.run()
    saved = _port_flat({"params": first.params, "opt": first.opt_state})
    straight = _loop(step, params, opt, cfg, str(tmp_path / "st"), total)
    want = {m["step"]: m["loss"] for m in straight.run()["metrics"]}
    (shape, pol, zero1) = RESUME_ONTO
    cfg, env2, params2, opt2 = _setup("llama3.2-1b", shape, pol, zero1)
    loop = _loop(adamw.make_train_step(cfg, env2, ocfg("f32")), params2,
                 opt2, cfg, d, total)
    where = _stacked_shardings(cfg, env2.mesh, pol, zero1, params2)
    assert loop.try_resume(where) == STEPS
    assert isinstance(loop.params, tf.MeshParams)
    assert loop.params.env is env2
    got = _port_flat({"params": loop.params, "opt": loop.opt_state})
    assert got.keys() == saved.keys()
    for k in saved:
        np.testing.assert_array_equal(got[k], saved[k])
    o_where = sh.opt_shardings(cfg, env2.mesh, {"m": params2, "v": params2,
                                                "step": torch.zeros(())},
                               pol, zero1)
    for leaf, s in zip(adamw.leaves(loop.opt_state), adamw.leaves(o_where)):
        assert leaf.sharding == s
    out = {m["step"]: m["loss"] for m in loop.run(start_step=STEPS)[
        "metrics"]}
    assert sorted(out) == list(range(STEPS, total))
    for s in out:
        assert abs(out[s] - want[s]) <= LOSS_REL * abs(want[s]), (s, out,
                                                                  want)


def test_reference_checkpoint_resumes_on_a_port_mesh(ref_runs):
    """The checkpoint the reference saved from its 2 x 4 mesh (ZeRO-1)
    after CKPT_AT steps, resumed by the port's ``TrainLoop`` onto 4 x 2
    (dp, ZeRO-1) with ``try_resume(shardings)``: the next step's loss
    within LOSS_REL of the reference's next step and its m and v within
    MOMENT_TOL["f32"]."""
    ref = ref_runs.get(CKPT_CASE)
    (shape, pol, zero1) = RESUME_ONTO
    cfg, env, params, opt = _setup("llama3.2-1b", shape, pol, zero1)
    loop = _loop(adamw.make_train_step(cfg, env, ocfg("f32")), params, opt,
                 cfg, ref_runs.ckpt_dir, CKPT_AT + 1)
    where = _stacked_shardings(cfg, env.mesh, pol, zero1, params)
    assert loop.try_resume(where) == CKPT_AT
    got = _port_flat({"params": loop.params})
    for k, v in _sub(ref, f"{CKPT_CASE}|p|").items():
        np.testing.assert_array_equal(got["params/" + k], v)
    out = loop.run(start_step=CKPT_AT)["metrics"]
    want = float(ref["ckpt|loss"])
    assert abs(out[0]["loss"] - want) <= LOSS_REL * abs(want)
    for what in ("m", "v"):
        k, err = _worst(_rel_errs(_sub(ref, f"ckpt|{what}|"),
                                  _port_flat(loop.opt_state[what])))
        assert err <= MOMENT_TOL["f32"], (what, k, err)


def test_opt_state_from_reference_onto_a_mesh():
    """``opt_state_from_reference`` with the port's ``opt_shardings``
    places the reference's state on the mesh (ZeRO-1's layer-owned
    blocks included) and ``tree_to_reference`` gathers it back bit for
    bit; ``tree_from_reference`` of placed parameters returns
    ``MeshParams`` on their mesh."""
    cfg = train_cfg("llama3.2-1b")
    params = ref_params("llama3.2-1b")
    opt = ref_opt.init_opt_state(params)
    opt = {"m": jax.tree.map(lambda x: x + 1.5, params),
           "v": jax.tree.map(lambda x: x * x, params),
           "step": opt["step"] + 3}
    cfg, env, placed, _ = _setup("llama3.2-1b", (2, 4), "tp")
    where = sh.opt_shardings(cfg, env.mesh, {"m": placed, "v": placed,
                                             "step": torch.zeros(())},
                             "tp", True)
    got = interop.opt_state_from_reference(opt, cfg, shardings=where)
    assert got["m"]["layers"][0]["attn"]["wq"].local((1, 0)) is None
    back, want = _port_flat(got), flat(opt)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    again = interop.tree_from_reference(interop.tree_to_reference(placed),
                                        placed)
    assert isinstance(again, tf.MeshParams) and again.env is env
    a, b = _port_flat(again), flat(params)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
