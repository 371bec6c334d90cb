"""Training the hybrid (hymba), ssm (rwkv6) and audio (whisper) families
over a device mesh: ``forward_loss`` on the cells under autograd (mamba
on its block of channels, rwkv6 on its heads, whisper's encoder and
cross-attention on theirs), the gradient sync, ``opt_shardings`` with
ZeRO-1 on their leaves, ``make_train_step``, placed ``interop`` trees and
an elastic ``TrainLoop.try_resume(shardings)``, on meshes of CPU cells
(``devices=["cpu"] * n``).

The reference runs on 8 virtual CPU devices with ``Auto`` mesh axes, in
fp32 (``CDT`` patched, as the port is here), in four subprocesses started
together by a module fixture, as ``tests/test_torch_train_mesh.py``
runs the dense and MoE families: its jitted ``value_and_grad`` of
``forward_loss`` and its jitted ``make_train_step`` with the parameters,
state and batch placed by its shardings; one case also saves a sharded
checkpoint. Configs are ``tests/test_torch_family_mesh.py``'s: the
reduced hymba, rwkv6 (4 heads of 32: a head a cell on 4 model cells,
half a head on 8) and whisper (a batch of 24 frames), and
``hymba-1.5b:odd`` (10 heads over 5 KV heads and ``x_proj``'s 26
columns: none divides a model axis of 4).

Tolerances, as ``tests/test_torch_train_mesh.py`` states them: the loss
within ``LOSS_REL`` (1e-5) relative, each gradient leaf within
``GRAD_REL`` (1e-4) of its largest magnitude; after each step m and v
within ``MOMENT_TOL[sync]`` and the parameters within ``PARAM_LR_TOL`` x
lr; the mesh step within ``MESHLESS_REL`` (1e-5) of the port's meshless
one; a resumed run's losses within ``LOSS_REL`` of the straight run's.
A state or gradient leaf's bound is widened to the reference's own
spread on that leaf (its one-device run against its mesh run from the
same state) where that is wider: rwkv6's per-head group norm (eps
6.4e-4) divides heads whose output hardly varies, which turns two
summation orders into up to 7.7e-4 of a leaf's largest magnitude in the
reference itself (``_check_state``, ``test_mesh_step_matches_meshless``).
"""
import functools
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread a process)
import test_torch_train_mesh as TM
from repro.configs import base as ref_configs
from repro_torch import interop
from repro_torch.launch import placement as pl
from repro_torch.launch import shardings as sh
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, TrainLoop
from test_torch_family_mesh import ODD, S_ENC, fam_cfg

LOSS_REL, GRAD_REL, MESHLESS_REL = TM.LOSS_REL, TM.GRAD_REL, TM.MESHLESS_REL
MOMENT_TOL, PARAM_LR_TOL = TM.MOMENT_TOL, TM.PARAM_LR_TOL
STEPS = TM.STEPS
HYMBA, RWKV, WHISPER = "hymba-1.5b", "rwkv6-3b", "whisper-small"
GRAD_CASES = {   # name -> (config, mesh, policy)
    "hymba_2x4_tp": (HYMBA, (2, 4), "tp"),
    "hymba_4x2_dp": (HYMBA, (4, 2), "dp"),
    "odd_2x4_tp": (ODD, (2, 4), "tp"),
    "odd_4x2_dp": (ODD, (4, 2), "dp"),
    "rwkv_2x4_tp": (RWKV, (2, 4), "tp"),
    "rwkv_4x2_dp": (RWKV, (4, 2), "dp"),
    "rwkv_1x8_tp": (RWKV, (1, 8), "tp"),
    "whisper_2x4_tp": (WHISPER, (2, 4), "tp"),
    "whisper_4x2_dp": (WHISPER, (4, 2), "dp"),
}
STEP_CASES = {   # name -> (config, mesh, policy, grad sync, ZeRO-1)
    "hymba_2x4_tp_f32_z1": (HYMBA, (2, 4), "tp", "f32", True),
    "hymba_2x4_tp_bf16_z1": (HYMBA, (2, 4), "tp", "bf16", True),
    "odd_2x4_tp_bf16_z1": (ODD, (2, 4), "tp", "bf16", True),
    "rwkv_2x4_tp_f32_z1": (RWKV, (2, 4), "tp", "f32", True),
    "rwkv_1x8_tp_bf16_z1": (RWKV, (1, 8), "tp", "bf16", True),
    "whisper_2x4_tp_f32_z1": (WHISPER, (2, 4), "tp", "f32", True),
    "whisper_4x2_dp_bf16_z1": (WHISPER, (4, 2), "dp", "bf16", True),
}
# the reference's sharded checkpoint: this step case's state after
# CKPT_AT steps, then one more step the port's resume onto RESUME_ONTO is
# held to
CKPT_CASE, CKPT_AT = "hymba_2x4_tp_f32_z1", STEPS
RESUME_ONTO = ((4, 2), "dp", True)
JOBS = {"grads_hymba": ["hymba_2x4_tp", "hymba_4x2_dp", "odd_2x4_tp",
                        "odd_4x2_dp"],
        "grads_other": ["rwkv_2x4_tp", "rwkv_4x2_dp", "rwkv_1x8_tp",
                        "whisper_2x4_tp", "whisper_4x2_dp"],
        "steps_hybrid": ["hymba_2x4_tp_f32_z1", "hymba_2x4_tp_bf16_z1",
                         "odd_2x4_tp_bf16_z1"],
        "steps_other": ["rwkv_2x4_tp_f32_z1", "rwkv_1x8_tp_bf16_z1",
                        "whisper_2x4_tp_f32_z1", "whisper_4x2_dp_bf16_z1"]}


# -- shared inputs (also imported by the reference subprocesses) -----------

def train_batch(cfg, step=0):
    """``test_torch_train_mesh.train_batch`` (B x S tokens and labels),
    plus an audio config's B x S_ENC frames, numpy-seeded."""
    out = TM.train_batch(cfg, step)
    if cfg.family == "audio":
        out["frames"] = np.random.default_rng(200 + step).standard_normal(
            (TM.B, S_ENC, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def ref_params(name):
    import jax
    from repro.models import transformer as ref_tf
    return ref_tf.init_params(fam_cfg(name, ref_configs),
                              jax.random.PRNGKey(0))


def run_reference(name, ckpt_dir) -> dict:
    """One case on the reference's mesh (a subprocess with 8 virtual
    devices, ``CDT`` patched to fp32): a grad case's loss and gradients,
    or a step case's losses and its parameters, m and v after each step;
    the checkpoint case also saves its state after CKPT_AT steps from the
    mesh and runs one step more."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import ckpt as ref_ckpt
    from repro.launch import shardings as ref_sh
    from repro.models import transformer as ref_tf
    from repro.models.common import use_mesh
    from repro.optim import adamw as ref_opt
    flat = TM.flat
    if name in GRAD_CASES:
        arch, shape, pol = GRAD_CASES[name]
        cfg, mesh = fam_cfg(arch, ref_configs), TM.ref_mesh(shape)
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
        _, g1 = jax.jit(jax.value_and_grad(lambda p, b: ref_tf.forward_loss(
            p, b, cfg, ref_tf.ShardEnv(None))))(ref_params(arch), batch)
        return {f"{name}|loss": np.asarray(loss),
                **{f"{name}|g|{k}": v for k, v in flat(g).items()},
                **{f"{name}|g1|{k}": v for k, v in flat(g1).items()}}
    arch, shape, pol, sync, zero1 = STEP_CASES[name]
    cfg, mesh = fam_cfg(arch, ref_configs), TM.ref_mesh(shape)
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
    one = jax.jit(ref_opt.make_train_step(cfg, ref_tf.ShardEnv(None),
                                          TM.ocfg(sync, ref_opt)))
    with use_mesh(mesh):
        step = jax.jit(ref_opt.make_train_step(
            cfg, env, TM.ocfg(sync, ref_opt)),
            in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, None))
        p, o = jax.device_put(params, p_sh), jax.device_put(opt, o_sh)
        for i in range(STEPS):
            p, o, m = step(p, o, batches[i])
            losses.append(float(m["loss"]))
            # the reference's one-device step from the state this step
            # started from: its own spread between the two programs
            start = (params, opt) if i == 0 else s1
            p1, o1, _ = one(jax.device_get(start[0]),
                            jax.device_get(start[1]), batches[i])
            tag = "|s1" if i == 0 else ""
            for what, tree in (("p", p1), ("m", o1["m"]), ("v", o1["v"])):
                out.update({f"{name}|one{tag}|{what}|{k}": v
                            for k, v in flat(tree).items()})
            if i == 0:   # the state the port's second step starts from
                s1 = (p, o)
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
    import test_torch_family_train_mesh as T
    ref_common.CDT = ref_tf.CDT = jnp.float32
    out = {}
    for name in sys.argv[2].split(","):
        out.update(T.run_reference(name, sys.argv[3]))
    np.savez(sys.argv[1], **out)
    print("reference ok")
"""


class ReferenceRuns(TM.ReferenceRuns):
    """``test_torch_train_mesh.ReferenceRuns`` over this file's ``JOBS``."""

    def __init__(self, tmp):
        self.ckpt_dir = os.path.join(tmp, "ref_ckpt")
        self.procs, self.paths = {}, {}
        for job, names in JOBS.items():
            self.paths[job] = os.path.join(tmp, f"{job}.npz")
            self.procs[job] = subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(REF_SCRIPT),
                 self.paths[job], ",".join(names), self.ckpt_dir],
                cwd=TM.ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})

    def get(self, name) -> dict:
        job = next(j for j, names in JOBS.items() if name in names)
        return self.job(job)


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


def _setup(arch, shape, pol, zero1=False):
    """(cfg, env, placed params, placed optimizer state) on a CPU mesh,
    from the reference's weights."""
    cfg = fam_cfg(arch)
    env = tf.ShardEnv(TM.cpu_mesh(shape), policy=pol)
    port = interop.params_from_reference(ref_params(arch), cfg, device="cpu")
    params = tf.place_params(port, env)
    where = sh.opt_shardings(cfg, env.mesh, {"m": params, "v": params,
                                             "step": torch.zeros(())},
                             pol, zero1)
    return cfg, env, params, adamw.init_opt_state(params, where)


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
    k, err = TM._worst(TM._rel_errs(TM._sub(ref, f"{name}|g|"),
                                    TM._port_flat(g)))
    assert err <= GRAD_REL, (k, err)


# -- train steps vs the reference ---------------------------------------------

def _check_state(ref, name, first, params, opt, sync, lr):
    """The port's state after a step vs the reference's mesh step (``first``:
    the first step's): m and v within MOMENT_TOL[sync] of each leaf's
    largest magnitude, the parameters within PARAM_LR_TOL x lr, each bound
    widened to the reference's own spread on that leaf where it is wider
    (its one-device step from the same state against its mesh step:
    rwkv6's group norm of near-constant heads turns the two programs'
    summation orders into up to 7.7e-4 of a gradient leaf's largest
    magnitude a step in, and a
    bf16 sync near zero into Adam steps of opposite sign)."""
    at, one = (f"{name}|s1", f"{name}|one|s1") if first else \
        (name, f"{name}|one")
    for what in ("m", "v"):
        want = TM._sub(ref, f"{at}|{what}|")
        spread = TM._rel_errs(want, TM._sub(ref, f"{one}|{what}|"))
        for k, err in TM._rel_errs(want, TM._port_flat(opt[what])).items():
            assert err <= max(MOMENT_TOL[sync], spread[k]), \
                (at, what, k, err, spread[k])
    want, other = TM._sub(ref, f"{at}|p|"), TM._sub(ref, f"{one}|p|")
    got = TM._port_flat(params)
    for k in want:
        bound = max(PARAM_LR_TOL * lr, float(np.abs(other[k] - want[k]).max()))
        assert np.abs(got[k] - want[k]).max() <= bound, (at, k, bound)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_steps_match_reference(ref_runs, name):
    """STEPS ``make_train_step`` steps over the port's mesh with ZeRO-1
    (f32 or bf16 sync) vs the reference's jitted step with its
    parameters, state and batch placed by its shardings, each step from
    the reference's state before it (carried over by
    ``params_from_reference`` and ``opt_state_from_reference`` onto the
    mesh): each step's loss within LOSS_REL, m, v and the parameters as
    ``_check_state`` bounds them; the new
    state placed as ``opt_shardings`` lays it out (mamba's ``A_log``,
    ``D``, conv and ``x_proj``, rwkv6's time-mix and decay leaves,
    whisper's encoder and cross-attention leaves)."""
    arch, shape, pol, sync, zero1 = STEP_CASES[name]
    ref = ref_runs.get(name)
    want = ref[f"{name}|losses"]
    cfg, env, params, opt = _setup(arch, shape, pol, zero1)
    step = adamw.make_train_step(cfg, env, TM.ocfg(sync))
    params, opt, m = step(params, opt, train_batch(cfg))
    np.testing.assert_allclose(float(m["loss"]), want[0], rtol=LOSS_REL)
    _check_state(ref, name, True, params, opt, sync, float(m["lr"]))
    placed = tf.place_params(interop.params_from_reference(
        TM._nest(TM._sub(ref, f"{name}|s1|p|")), cfg, device="cpu"), env)
    where = sh.opt_shardings(cfg, env.mesh, {"m": placed, "v": placed,
                                             "step": torch.zeros(())},
                             pol, zero1)
    opt = interop.opt_state_from_reference(
        {"m": TM._nest(TM._sub(ref, f"{name}|s1|m|")),
         "v": TM._nest(TM._sub(ref, f"{name}|s1|v|")), "step": np.int32(1)},
        cfg, shardings=where)
    params, opt, m = step(placed, opt, train_batch(cfg, 1))
    np.testing.assert_allclose(float(m["loss"]), want[1], rtol=LOSS_REL)
    lr = float(m["lr"])
    np.testing.assert_allclose(lr, ref[f"{name}|lr"], rtol=1e-6)
    _check_state(ref, name, False, params, opt, sync, lr)
    assert isinstance(params, tf.MeshParams) and params.env is env
    for leaf, s in zip(adamw.leaves(opt), adamw.leaves(where)):
        assert leaf.sharding == s
    assert int(pl.gather(opt["step"])) == STEPS


def test_zero1_places_the_family_leaves():
    """ZeRO-1 on 2 x 4 tp splits these families' own leaves over the data
    axis as ``opt_shardings`` says (layer-owned where it takes the L dim):
    a leaf of layer 0 is held by data block 0 only, and ``init_opt_state``
    places one copy of m on the host."""
    for arch, names in ((HYMBA, ("A_log", "D", "conv_w", "x_proj")),
                        (RWKV, ("w0", "w_a", "w_b", "u", "mu")),
                        (WHISPER, ("cross",))):
        cfg, env, params, opt = _setup(arch, (2, 4), "tp", zero1=True)
        for lname in ("layers", "enc_layers"):
            if lname == "enc_layers" and not cfg.n_enc_layers:
                continue
            layer = opt["m"][lname][0]
            leaves = dict(adamw.leaves_with_path(layer))
            hit = [p for p in leaves if any(n in p for n in names)]
            assert hit or lname == "enc_layers", (arch, names)
            for path, leaf in leaves.items():
                assert leaf.sharding.stack is not None, (arch, path)
                assert [leaf.local((d, 0)) is None for d in range(2)] == \
                    [False, True], (arch, path)
        total = sum({b.untyped_storage().data_ptr():
                     b.untyped_storage().nbytes()
                     for leaf in adamw.leaves(opt["m"])
                     for b in leaf.shards.flat if b is not None}.values())
        assert total == 4 * sum(p.numel() for p in adamw.leaves(
            interop.params_from_reference(ref_params(arch), cfg,
                                          device="cpu")))


# -- the port's mesh vs its meshless path -------------------------------------

MESHLESS_CASES = {   # (config, mesh, policy, ZeRO-1) -> its grad case
    (HYMBA, (2, 4), "tp", True): "hymba_2x4_tp",
    (ODD, (2, 4), "tp", True): "odd_2x4_tp",
    (RWKV, (1, 8), "tp", True): "rwkv_1x8_tp",
    (WHISPER, (4, 2), "dp", True): "whisper_4x2_dp",
    (WHISPER, (2, 4), "sp", False): None,
}


@pytest.mark.parametrize("arch,shape,pol,zero1", list(MESHLESS_CASES))
def test_mesh_step_matches_meshless(ref_runs, arch, shape, pol, zero1):
    """One step over the mesh vs the port's meshless step on the
    reference's weights and batch: the loss and the grad norm within
    MESHLESS_REL; each gradient leaf and m within MESHLESS_REL of their
    largest magnitude, v within twice that (v is the gradient squared),
    each widened to the reference's own spread between its mesh and its
    one-device gradients on the same mesh shape where that is wider
    (rwkv6's ``u``: 8.7e-5 on 1 x 8, and the port's 2.2e-5)."""
    cfg = fam_cfg(arch)
    name = MESHLESS_CASES[(arch, shape, pol, zero1)]
    spread = {}
    if name is not None:
        ref = ref_runs.get(name)
        spread = TM._rel_errs(TM._sub(ref, f"{name}|g|"),
                              TM._sub(ref, f"{name}|g1|"))
    port = interop.params_from_reference(ref_params(arch), cfg, device="cpu")
    env = tf.ShardEnv(TM.cpu_mesh(shape), policy=pol)
    placed = tf.place_params(port, env)
    batch = train_batch(cfg)
    where = sh.opt_shardings(cfg, env.mesh, {"m": placed, "v": placed,
                                             "step": torch.zeros(())},
                             pol, zero1)
    oc = TM.ocfg("f32")
    _, o1, m1 = adamw.make_train_step(cfg, tf.ONE_DEVICE, oc)(
        port, adamw.init_opt_state(port), batch)
    _, o2, m2 = adamw.make_train_step(cfg, env, oc)(
        placed, adamw.init_opt_state(placed, where), batch)
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= \
        MESHLESS_REL * abs(float(m1["loss"]))
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=MESHLESS_REL)
    _, g1 = adamw.value_and_grad(
        lambda p: tf.forward_loss(p, batch, cfg, tf.ONE_DEVICE), port)
    _, g2 = adamw.value_and_grad(
        lambda p: tf.forward_loss(p, batch, cfg, env), placed)
    for a, b, times in ((g1, g2, 1), (o1["m"], o2["m"], 1),
                        (o1["v"], o2["v"], 2)):
        for k, err in TM._rel_errs(TM._port_flat(a),
                                   TM._port_flat(b)).items():
            bound = times * max(MESHLESS_REL, spread.get(k, 0.0))
            assert err <= bound, (k, err, bound)


# -- resume -------------------------------------------------------------------

class _Batches:
    def __init__(self, cfg):
        self.cfg = cfg

    def get_batch(self, step):
        return train_batch(self.cfg, step)


def _loop(step, params, opt, cfg, ckpt_dir, total):
    return TrainLoop(LoopConfig(total_steps=total, ckpt_every=STEPS,
                                ckpt_dir=ckpt_dir, log_every=1,
                                async_ckpt=False),
                     step, _Batches(cfg), params, opt)


def test_elastic_hymba_resume_2x4_to_4x2(tmp_path):
    """hymba's ``TrainLoop`` on 2 x 4 (tp) runs STEPS steps and
    checkpoints (the reference's stacked layout); a loop on 4 x 2 (dp,
    ZeRO-1) resumes it by ``try_resume(shardings)`` and runs two more:
    its parameters and state right after the resume equal the saved ones
    bit for bit, placed by those shardings, and its losses follow a
    straight 2 x 4 run within LOSS_REL."""
    cfg, env, params, opt = _setup(HYMBA, (2, 4), "tp")
    step = adamw.make_train_step(cfg, env, TM.ocfg("f32"))
    total = STEPS + 2
    d = str(tmp_path / "ck")
    first = _loop(step, params, opt, cfg, d, STEPS)
    first.run()
    saved = TM._port_flat({"params": first.params, "opt": first.opt_state})
    straight = _loop(step, params, opt, cfg, str(tmp_path / "st"), total)
    want = {m["step"]: m["loss"] for m in straight.run()["metrics"]}
    shape, pol, zero1 = RESUME_ONTO
    cfg, env2, params2, opt2 = _setup(HYMBA, shape, pol, zero1)
    loop = _loop(adamw.make_train_step(cfg, env2, TM.ocfg("f32")), params2,
                 opt2, cfg, d, total)
    where = TM._stacked_shardings(cfg, env2.mesh, pol, zero1, params2)
    assert loop.try_resume(where) == STEPS
    assert isinstance(loop.params, tf.MeshParams)
    assert loop.params.env is env2
    got = TM._port_flat({"params": loop.params, "opt": loop.opt_state})
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


def test_reference_hymba_checkpoint_resumes_on_a_port_mesh(ref_runs):
    """The checkpoint the reference saved from its 2 x 4 mesh (ZeRO-1)
    after CKPT_AT hymba steps, resumed by the port's ``TrainLoop`` onto
    4 x 2 (dp, ZeRO-1): the parameters equal the reference's bit for bit,
    the next step's loss within LOSS_REL of the reference's next step and
    its m and v within MOMENT_TOL["f32"]."""
    ref = ref_runs.get(CKPT_CASE)
    shape, pol, zero1 = RESUME_ONTO
    cfg, env, params, opt = _setup(HYMBA, shape, pol, zero1)
    loop = _loop(adamw.make_train_step(cfg, env, TM.ocfg("f32")), params, opt,
                 cfg, ref_runs.ckpt_dir, CKPT_AT + 1)
    where = TM._stacked_shardings(cfg, env.mesh, pol, zero1, params)
    assert loop.try_resume(where) == CKPT_AT
    got = TM._port_flat({"params": loop.params})
    for k, v in TM._sub(ref, f"{CKPT_CASE}|p|").items():
        np.testing.assert_array_equal(got["params/" + k], v)
    out = loop.run(start_step=CKPT_AT)["metrics"]
    want = float(ref["ckpt|loss"])
    assert abs(out[0]["loss"] - want) <= LOSS_REL * abs(want)
    for what in ("m", "v"):
        k, err = TM._worst(TM._rel_errs(TM._sub(ref, f"ckpt|{what}|"),
                                        TM._port_flat(loop.opt_state[what])))
        assert err <= MOMENT_TOL["f32"], (what, k, err)


def test_placed_family_trees_cross_packages():
    """``tree_to_reference`` of placed hymba, rwkv6 and whisper
    parameters gives the reference's leaves bit for bit, and
    ``tree_from_reference`` brings them back as ``MeshParams`` on their
    mesh."""
    for arch in (HYMBA, RWKV, WHISPER):
        cfg, env, placed, _ = _setup(arch, (2, 4), "tp")
        back = TM._port_flat(placed)
        want = TM.flat(ref_params(arch))
        assert back.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(back[k], want[k])
        again = interop.tree_from_reference(
            interop.tree_to_reference(placed), placed)
        assert isinstance(again, tf.MeshParams) and again.env is env


def test_train_cli_checkpoint_resumes_on_a_mesh(tmp_path, capsys):
    """``launch/train.py --arch hymba-1.5b --device cpu`` (its one cell)
    checkpoints at step 2; ``TrainLoop``s built as the CLI builds them,
    one on its one cell and one on 4 x 2 (dp, ZeRO-1) with
    ``try_resume(shardings)``, both resume that checkpoint: their
    parameters and state equal bit for bit, and their next step's losses
    within LOSS_REL."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import reduced_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_local_mesh
    d = str(tmp_path)
    train_cli.main(["--arch", HYMBA, "--device", "cpu", "--batch", "8",
                    "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "2",
                    "--steps", "2"])
    assert capsys.readouterr().out.splitlines()[0].startswith(
        "step     0 loss ")
    assert ckpt.latest_step(d) == 2
    cfg = reduced_config(HYMBA)
    shape, pol, zero1 = RESUME_ONTO
    runs = {}
    for name, env in (("cell", tf.ShardEnv(make_local_mesh(
            devices=["cpu"]))), ("mesh", tf.ShardEnv(TM.cpu_mesh(shape),
                                                     policy=pol))):
        z1 = zero1 and name == "mesh"
        params = tf.place_params(tf.init_params(cfg, 0, "cpu"), env)
        opt = adamw.init_opt_state(params, sh.opt_shardings(
            cfg, env.mesh, {"m": params, "v": params,
                            "step": torch.zeros(())}, env.policy, z1))
        step = adamw.make_train_step(cfg, env, adamw.AdamWConfig(
            peak_lr=3e-3, warmup_steps=1, total_steps=3))
        pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=8, seq_len=16,
                             seed=0, frontend=cfg.frontend,
                             d_model=cfg.d_model)
        loop = TrainLoop(LoopConfig(total_steps=3, ckpt_every=100,
                                    ckpt_dir=d, log_every=1,
                                    async_ckpt=False), step, pipe, params,
                         opt)
        where = (TM._stacked_shardings(cfg, env.mesh, pol, z1, params)
                 if name == "mesh" else None)
        assert loop.try_resume(where) == 2
        state = TM._port_flat({"params": loop.params, "opt": loop.opt_state})
        runs[name] = state, loop.run(start_step=2)["metrics"][0]["loss"]
    (a, loss_a), (b, loss_b) = runs["cell"], runs["mesh"]
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])
    assert abs(loss_b - loss_a) <= LOSS_REL * abs(loss_a)
