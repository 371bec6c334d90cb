"""The port's training path (``forward_loss`` and its gradients,
``optim/adamw.py``, ``train/loop.py``, ``launch/train.py``) held to the
reference on the CPU, with the same weights (``interop``) and the same
numpy-seeded batches.

The reference runs with ``ShardEnv(None)`` (its default (1, 1) mesh
raises under jax 0.9 on ``Explicit`` axes); its MoE has no ``mesh=None``
path, so dbrx and kimi-k2 run on the (1, 1) ``Auto`` mesh
(``test_torch_moe.auto_mesh``). Its ``value_and_grad`` is jitted.

Tolerances, measured on these inputs and stated per test:
* fp32 compute (``CDT`` set to float32 in both packages): loss within
  1e-5; each gradient leaf within 1e-4 of its largest magnitude
  (``GRAD_F32``);
* bf16 compute: loss within 2e-3 (``LOSS_BF16``); the gradients held to
  the reference's fp32 ones as closely as its own bf16 gradients are
  (``BF16_RATIO``, ``BF16_FLOOR``; see ``test_loss_and_grads_bf16``);
* MoE expert ids of every layer equal, and so the capacity drops.
"""
import dataclasses
import functools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_moe import auto_mesh

import repro.models.common as ref_common
import repro.models.moe as ref_moe
import repro.models.transformer as ref_tf
import repro.optim.adamw as ref_opt
from repro.train import loop as ref_loop
from repro_torch import interop
from repro_torch.checkpoint import ckpt
from repro_torch.configs import reduced_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import common, moe
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train.loop import LoopConfig, TrainLoop

ENV_R, ENV = ref_tf.ShardEnv(None), tf.ShardEnv(None)
LOSS_F32, GRAD_F32 = 1e-5, 1e-4
LOSS_BF16 = 2e-3
BF16_RATIO, BF16_FLOOR = 2.5, 1e-2
MOMENT_TOL, PARAM_LR_TOL = {"f32": 1e-4, "bf16": 1e-2}, 0.25
FAMILIES = ("smollm-135m", "internvl2-76b", "dbrx-132b", "kimi-k2-1t-a32b",
            "hymba-1.5b", "rwkv6-3b")


@pytest.fixture
def fp32(monkeypatch):
    """Both packages compute in fp32 (their ``CDT`` patched)."""
    monkeypatch.setattr(ref_common, "CDT", jnp.float32)
    monkeypatch.setattr(ref_tf, "CDT", jnp.float32)
    monkeypatch.setattr(common, "CDT", torch.float32)
    monkeypatch.setattr(tf, "CDT", torch.float32)


def _env_r(cfg):
    return ref_tf.ShardEnv(auto_mesh()) if cfg.is_moe else ENV_R


def _pair(cfg, seed=0):
    ref = ref_tf.init_params(cfg, jax.random.PRNGKey(seed))
    return ref, interop.params_from_reference(ref, cfg, device="cpu")


def _batch(cfg, B, S, seed=0):
    """A training batch for ``cfg``: tokens (or patch embeddings) and
    labels; frames and decoder tokens for audio."""
    if cfg.frontend == "frame":
        return TokenPipeline(cfg.vocab_size, B, S, seed=seed,
                             frontend="frame",
                             d_model=cfg.d_model).get_batch(0)
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "patch":
        out["embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (B, S)).astype(np.int32)
    return out


def _ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def ref_value_and_grad(cfg, env):
    """The reference's jitted ``value_and_grad`` of ``forward_loss`` (made
    per call, so a patched ``CDT`` is traced)."""
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_tf.forward_loss(p, b, cfg, env)))


def _flat(tree) -> dict:
    """Reference-layout leaves by their ``/``-joined path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf, np.float32)
    return out


def _rel_errs(want: dict, got: dict) -> dict:
    """Each leaf's max abs difference over its largest magnitude in
    ``want``."""
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].shape == got[k].shape, k
    return {k: float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in want}


class Routes:
    """While open, the port's ``moe._route`` keeps each call's expert ids."""

    def __enter__(self):
        self.real, self.ids = moe._route, []

        def route(x, w, dims):
            ids, weights = self.real(x, w, dims)
            self.ids.append(ids.clone())
            return ids, weights

        moe._route = route
        return self.ids

    def __exit__(self, *exc):
        moe._route = self.real


def ref_routes(cfg, ref_params, batch, env):
    """The reference's expert ids of every MoE layer in one forward pass
    (an ordered ``jax.debug.callback`` in its ``_route``)."""
    ids, real = [], ref_moe._route

    def route(x, w, dims):
        top_ids, weights = real(x, w, dims)
        jax.debug.callback(lambda a: ids.append(np.asarray(a)), top_ids,
                           ordered=True)
        return top_ids, weights

    ref_moe._route = route
    try:
        jax.block_until_ready(jax.jit(
            lambda p, b: ref_tf.forward_loss(p, b, cfg, env))(
                ref_params, batch))
        jax.effects_barrier()
    finally:
        ref_moe._route = real
    return ids


def _drops(ids, dims) -> int:
    """(token, choice) rows the port's capacity path drops for ``ids``."""
    cap_e, row_slot, slot_e, eb, _ = moe._dispatch(ids, dims)
    kept_slots = int((eb >= 0).sum())
    return ids.numel() - kept_slots


# -- loss and gradients, every family ------------------------------------------

def _case(name):
    cfg = reduced_config(name)
    if name == "kimi-k2-1t-a32b":   # a factor at which experts overflow
        cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    ref, port = _pair(cfg)
    return cfg, ref, port, _batch(cfg, 2, 32), _env_r(cfg)


@functools.lru_cache(maxsize=None)
def ref_fp32(name):
    """The reference's fp32 loss and flat gradients on ``_case(name)``
    (shared by the fp32 and bf16 tests)."""
    cfg, ref, _, batch, env_r = _case(name)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(ref_common, "CDT", jnp.float32)
        m.setattr(ref_tf, "CDT", jnp.float32)
        loss, g = ref_value_and_grad(cfg, env_r)(ref, _ref_batch(batch))
    return float(loss), _flat(g)


def _port_grads(cfg, port, batch):
    loss, g = adamw.value_and_grad(
        lambda p: tf.forward_loss(p, batch, cfg, ENV), port)
    return float(loss), _flat(interop.tree_to_reference(g))


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_fp32(name, fp32):
    """fp32: the same loss within LOSS_F32 and every gradient leaf within
    GRAD_F32 of its largest magnitude (measured ≤ 1.5e-5, rwkv6's
    ``cm_v``); for a MoE, the same expert ids in every layer (so the same
    capacity drops; kimi-k2 at factor 1.0 drops rows)."""
    cfg, ref, port, batch, env_r = _case(name)
    loss_r, g_r = ref_fp32(name)
    loss_p, g_p = _port_grads(cfg, port, batch)
    assert abs(loss_p - loss_r) <= LOSS_F32, (loss_p, loss_r)
    errs = _rel_errs(g_r, g_p)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_F32, (worst, errs[worst])
    if cfg.is_moe:
        with torch.no_grad(), Routes() as ids_p:
            tf.forward_loss(port, batch, cfg, ENV)
        ids_r = ref_routes(cfg, ref, _ref_batch(batch), env_r)
        assert len(ids_p) == len(ids_r) == cfg.n_layers
        for a, b in zip(ids_p, ids_r):
            np.testing.assert_array_equal(a.numpy(), b)
        dims = moe.MoEDims(cfg.n_experts, cfg.moe_top_k,
                           cfg.capacity_factor)
        drops = [_drops(a, dims) for a in ids_p]
        if name == "kimi-k2-1t-a32b":
            assert sum(drops) > 0, drops    # the capacity path drops rows


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_bf16(name):
    """bf16 (the real compute dtype): the loss within LOSS_BF16 (measured
    ≤ 4.0e-4). The gradients are held to the reference's fp32 ones:
    each leaf of the port's bf16 gradient no further from them than
    BF16_RATIO times the reference's own bf16 gradient, plus BF16_FLOOR
    of the leaf's largest magnitude (measured ≤ 1.82 times, smollm's
    ``wq``). A direct bound would be loose: the loss's gradient carries
    a one-hot at each token's largest logit (the reference's
    ``softmax_xent``, ``test_reference_xent_gradient_carries_the_argmax``),
    and bf16 logits near-tie, so rounding moves whole one-hots: the
    reference's own bf16 gradient leaves its fp32 one by up to 3.8x the
    leaf's largest magnitude (rwkv6's ``w0``)."""
    cfg, ref, port, batch, env_r = _case(name)
    loss_r, g_r = ref_value_and_grad(cfg, env_r)(ref, _ref_batch(batch))
    loss_p, g_p = _port_grads(cfg, port, batch)
    assert abs(loss_p - float(loss_r)) <= LOSS_BF16, (loss_p, float(loss_r))
    want = ref_fp32(name)[1]
    err_ref, err_port = _rel_errs(want, _flat(g_r)), _rel_errs(want, g_p)
    for k in want:
        assert err_port[k] <= BF16_RATIO * err_ref[k] + BF16_FLOOR, \
            (k, err_port[k], err_ref[k])


def test_reference_xent_gradient_carries_the_argmax():
    """The reference's ``softmax_xent`` stops the max's gradient only where
    it is subtracted, so d lse / d logits is softmax plus a one-hot at the
    largest logit (the true gradient has no such term). The port copies
    it: both packages' gradients equal softmax - onehot(label) +
    onehot(argmax), here with z-loss off."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    g_r = jax.grad(lambda x: ref_common.softmax_xent(
        x, jnp.asarray(labels), z_loss=0.0))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    (g_p,) = torch.autograd.grad(common.softmax_xent(
        x, torch.from_numpy(labels), z_loss=0.0), x)
    soft = np.exp(logits - logits.max(-1, keepdims=True))
    soft /= soft.sum(-1, keepdims=True)
    eye = np.eye(11, dtype=np.float32)
    want = (soft - eye[labels] + eye[logits.argmax(-1)]) / labels.size
    np.testing.assert_allclose(np.asarray(g_r), want, atol=1e-7)
    np.testing.assert_allclose(g_p.numpy(), want, atol=1e-7)


# -- AdamW -------------------------------------------------------------------

def _rand_tree(rng, names):
    return {n: rng.standard_normal(shape).astype(np.float32)
            for n, shape in names.items()}


TREE = {"w_up": (4, 6), "w_gate": (4, 6), "unembed": (8, 4), "ln1": (4,),
        "router": (4, 3), "wq": (4, 4), "A_log": (3, 2)}


def test_adamw_update_leafwise():
    """Three ``adamw_update`` steps on a tree with decayed and exempt
    leaves, random gradients each step: params, m and v leaf by leaf,
    the step and the metrics equal the reference's within 1e-6 relative
    (fp32 arithmetic in the same order)."""
    rng = np.random.default_rng(0)
    cfg = ref_opt.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10,
                              weight_decay=0.3, clip_norm=2.0)
    p0 = _rand_tree(rng, TREE)
    pr = {k: jnp.asarray(v) for k, v in p0.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    orr, op = ref_opt.init_opt_state(pr), adamw.init_opt_state(pp)
    pcfg = adamw.AdamWConfig(**dataclasses.asdict(cfg))
    for _ in range(3):
        g = _rand_tree(rng, TREE)
        pr, orr, mr = ref_opt.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, orr, pr, cfg)
        pp, op, mp = adamw.adamw_update(
            {k: torch.from_numpy(v) for k, v in g.items()}, op, pp, pcfg)
        for want, got in ((pr, pp), (orr["m"], op["m"]), (orr["v"], op["v"])):
            for k in TREE:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                           rtol=1e-6, atol=1e-7)
        assert int(op["step"]) == int(orr["step"])
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(mp[k]), float(mr[k]), rtol=1e-6)


def test_adamw_update_leaves_its_inputs():
    """A step returns new trees; the params, state and grads it was given
    keep their values."""
    rng = np.random.default_rng(1)
    p = {k: torch.from_numpy(v) for k, v in _rand_tree(rng, TREE).items()}
    g = {k: torch.from_numpy(v) for k, v in _rand_tree(rng, TREE).items()}
    before = {k: v.clone() for k, v in p.items()}
    opt = adamw.init_opt_state(p)
    p2, opt2, _ = adamw.adamw_update(g, opt, p, adamw.AdamWConfig())
    assert int(opt["step"]) == 0 and int(opt2["step"]) == 1
    assert all(torch.equal(p[k], before[k]) for k in p)
    assert not any(opt["m"][k].any() for k in p)
    assert not torch.equal(p2["wq"], p["wq"])


def test_lr_schedule_and_global_norm_match():
    """``lr_schedule`` over warmup, decay and past the end, and
    ``global_norm`` of a random tree: the reference's values within 1e-6
    relative."""
    cfg = ref_opt.AdamWConfig(peak_lr=3e-3, warmup_steps=7, total_steps=90,
                              min_lr_ratio=0.05)
    pcfg = adamw.AdamWConfig(**dataclasses.asdict(cfg))
    for s in range(0, 101, 3):
        np.testing.assert_allclose(
            float(adamw.lr_schedule(pcfg, torch.tensor(s))),
            float(ref_opt.lr_schedule(cfg, jnp.asarray(s))), rtol=1e-6)
    t = _rand_tree(np.random.default_rng(2), TREE)
    np.testing.assert_allclose(
        float(adamw.global_norm({k: torch.from_numpy(v)
                                 for k, v in t.items()})),
        float(ref_opt.global_norm({k: jnp.asarray(v) for k, v in t.items()})),
        rtol=1e-6)


@pytest.mark.parametrize("name", ["smollm-135m", "whisper-small",
                                  "hymba-1.5b", "rwkv6-3b", "dbrx-132b",
                                  "kimi-k2-1t-a32b", "internvl2-76b"])
def test_decay_mask_leafwise(name):
    """The weight-decay mask of every leaf equals the reference's (its
    name test on the leaf's path); ``w_up`` and ``unembed`` (a "u" in the
    name) are exempt in both, ``w_gate`` decays."""
    cfg = reduced_config(name)
    ref, port = _pair(cfg)
    want = {"/".join(str(k.key) for k in path): ref_opt._decay_mask(path)
            for path, _ in jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = {}
    for path, _ in adamw.leaves_with_path(port):
        key = "/".join(p for p in path if not p.isdigit())
        got.setdefault(key, adamw._decay_mask(path))
        assert got[key] == adamw._decay_mask(path)
    assert got == want
    assert got["unembed"] is False
    if "layers/ffn/w_up" in got:
        assert got["layers/ffn/w_up"] is False
        assert got["layers/ffn/w_gate"] is True


def _step_pair(cfg, grad_sync):
    ocfg = ref_opt.AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=200,
                               grad_sync_dtype=grad_sync)
    ref, port = _pair(cfg)
    batch = _batch(cfg, 2, 32)
    r = jax.jit(ref_opt.make_train_step(cfg, _env_r(cfg), ocfg))(
        ref, ref_opt.init_opt_state(ref), _ref_batch(batch))
    p = adamw.make_train_step(cfg, ENV, adamw.AdamWConfig(
        **dataclasses.asdict(ocfg)))(port, adamw.init_opt_state(port), batch)
    return r, p, port


@pytest.mark.parametrize("grad_sync", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["smollm-135m", "hymba-1.5b"])
def test_train_step_matches_reference(name, grad_sync, fp32):
    """One ``make_train_step`` in fp32 compute, gradients synced in f32 or
    rounded to bf16: loss, grad norm and lr as the reference's; m and v
    leaf by leaf within ``MOMENT_TOL`` of each leaf's largest magnitude
    (measured ≤ 2.7e-6 in f32; ≤ 2.9e-3 in bf16, where rounding can take
    an element one bf16 ulp apart); each new parameter within
    ``PARAM_LR_TOL`` x lr of the reference's (measured ≤ 0.086 lr: the
    update m̂ / (√v̂ + eps) is ±1 for gradients well above eps, but steep
    where a gradient is near eps). The caller's parameters are left as
    they were."""
    cfg = reduced_config(name)
    (pr, orr, mr), (pp, op, mp), port0 = _step_pair(cfg, grad_sync)
    assert abs(float(mp["loss"]) - float(mr["loss"])) <= LOSS_F32
    np.testing.assert_allclose(float(mp["grad_norm"]), float(mr["grad_norm"]),
                               rtol=1e-5)
    lr = float(mr["lr"])
    np.testing.assert_allclose(float(mp["lr"]), lr, rtol=1e-6)
    assert int(op["step"]) == int(orr["step"]) == 1
    for want, got in ((orr["m"], op["m"]), (orr["v"], op["v"])):
        errs = _rel_errs(_flat(want), _flat(interop.tree_to_reference(got)))
        worst = max(errs, key=errs.get)
        assert errs[worst] <= MOMENT_TOL[grad_sync], (worst, errs[worst])
    want, got = _flat(pr), _flat(interop.tree_to_reference(pp))
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= PARAM_LR_TOL * lr, k
    fresh = _pair(cfg)[1]
    assert all(torch.equal(a, b) for a, b in
               zip(adamw.leaves(port0), adamw.leaves(fresh)))


def test_training_state_round_trips():
    """The reference's parameters and AdamW state after one step (reduced
    whisper: ``layers`` and ``enc_layers``) carried to the port
    (``params_from_reference``, ``opt_state_from_reference``) and back
    (``tree_to_reference``) are the reference's arrays, bit for bit."""
    cfg = reduced_config("whisper-small")
    ref = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
    batch = _ref_batch(_batch(cfg, 2, 32))
    ocfg = ref_opt.AdamWConfig(warmup_steps=1)
    pr, orr, _ = jax.jit(ref_opt.make_train_step(cfg, ENV_R, ocfg))(
        ref, ref_opt.init_opt_state(ref), batch)
    port = {"params": interop.params_from_reference(pr, cfg, device="cpu"),
            "opt": interop.opt_state_from_reference(orr, cfg, device="cpu")}
    assert len(port["opt"]["m"]["enc_layers"]) == cfg.n_enc_layers
    assert port["opt"]["step"].dtype == torch.int32
    back = _flat(interop.tree_to_reference(port))
    want = _flat({"params": pr, "opt": orr})
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


# the reference's four ``tests/test_optim.py`` cases, on the port

def test_optim_adamw_converges_quadratic():
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    opt = adamw.init_opt_state(params)
    cfg = adamw.AdamWConfig(peak_lr=0.1, warmup_steps=5, total_steps=300,
                            weight_decay=0.0)
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        params, opt, _ = adamw.adamw_update(grads, opt, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_optim_grad_clip_applies():
    params = {"w": torch.zeros(4)}
    opt = adamw.init_opt_state(params)
    cfg = adamw.AdamWConfig(peak_lr=1e-3, clip_norm=1.0, warmup_steps=0)
    grads = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw.adamw_update(grads, opt, params, cfg)
    assert metrics["grad_norm"] > 1e6 - 1   # reported pre-clip


def test_optim_schedule_warmup_and_decay():
    cfg = adamw.AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    lrs = [float(adamw.lr_schedule(cfg, torch.tensor(s)))
           for s in range(0, 101, 10)]
    assert lrs[1] <= 1.0 + 1e-6 and lrs[0] < lrs[1]
    assert lrs[-1] <= lrs[2]
    assert lrs[-1] >= 0.1 * 0.99


def test_optim_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    np.testing.assert_allclose(float(adamw.global_norm(t)), 5.0, rtol=1e-6)


# -- TrainLoop: the reference's four ``tests/test_train_loop.py`` cases ------

@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config("smollm-135m")
    params = tf.init_params(cfg, 0, device="cpu")
    opt = adamw.init_opt_state(params)
    step = adamw.make_train_step(cfg, ENV, adamw.AdamWConfig(
        peak_lr=3e-3, warmup_steps=5, total_steps=200))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=4, seq_len=64,
                         seed=0)
    return step, pipe, params, opt


def test_loss_descends(setup, tmp_path):
    step, pipe, params, opt = setup
    loop = TrainLoop(LoopConfig(total_steps=30, ckpt_every=100,
                                ckpt_dir=str(tmp_path)), step, pipe, params,
                     opt)
    out = loop.run()
    losses = [m["loss"] for m in out["metrics"]]
    assert losses[-1] < losses[0] - 0.2, losses


def test_resume_is_exact(setup, tmp_path):
    step, pipe, params, opt = setup
    # uninterrupted 12 steps
    a = TrainLoop(LoopConfig(total_steps=12, ckpt_every=100,
                             ckpt_dir=str(tmp_path / "a"), log_every=1),
                  step, pipe, params, opt)
    out_a = a.run()
    # interrupted at 6 + resume
    b1 = TrainLoop(LoopConfig(total_steps=6, ckpt_every=6,
                              ckpt_dir=str(tmp_path / "b"), log_every=1,
                              async_ckpt=False), step, pipe, params, opt)
    b1.run()
    b2 = TrainLoop(LoopConfig(total_steps=12, ckpt_every=100,
                              ckpt_dir=str(tmp_path / "b"), log_every=1),
                   step, pipe, params, opt)
    start = b2.try_resume()
    assert start == 6
    out_b = b2.run(start_step=start)
    la = {m["step"]: m["loss"] for m in out_a["metrics"]}
    lb = {m["step"]: m["loss"] for m in out_b["metrics"]}
    for s in range(7, 12):
        np.testing.assert_allclose(la[s], lb[s], rtol=1e-4), s


def test_preemption_checkpoints(setup, tmp_path):
    step, pipe, params, opt = setup
    loop = TrainLoop(LoopConfig(total_steps=50, ckpt_every=1000,
                                ckpt_dir=str(tmp_path), async_ckpt=False),
                     step, pipe, params, opt)
    orig = loop.train_step

    def step_then_preempt(*args):
        out = orig(*args)
        loop._preempted = True
        return out

    loop.train_step = step_then_preempt
    out = loop.run()
    assert out["preempted"]
    assert ckpt.latest_step(str(tmp_path)) == out["last_step"]


def test_straggler_detection(setup, tmp_path):
    step, pipe, params, opt = setup
    loop = TrainLoop(LoopConfig(total_steps=12, ckpt_every=100,
                                ckpt_dir=str(tmp_path),
                                straggler_factor=0.0001), step, pipe, params,
                     opt)
    out = loop.run()
    assert len(out["stragglers"]) > 0   # absurd factor flags everything


def test_loops_leave_the_shared_params(setup, tmp_path):
    """The fixture's parameters and state seed every loop above: a loop
    trains its own copies (the step is functional), so after a run they
    still equal a fresh ``init_params``."""
    step, pipe, params, opt = setup
    TrainLoop(LoopConfig(total_steps=3, ckpt_every=2,
                         ckpt_dir=str(tmp_path), async_ckpt=False),
              step, pipe, params, opt).run()
    fresh = tf.init_params(reduced_config("smollm-135m"), 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(adamw.leaves(params), adamw.leaves(fresh)))
    assert int(opt["step"]) == 0
    assert not any(m.any() for m in adamw.leaves(opt["m"]))


def test_training_leaves_no_tensor_to_the_collector(setup, tmp_path):
    """A warmed ``make_train_step`` step and a ``TrainLoop`` step with a
    checkpoint, run with the collector off, leave no tensor in cyclic
    garbage: their memory is freed by reference counting when the step
    drops it, as JAX frees its buffers, and not at some later
    collection."""
    import gc

    step, pipe, params, opt = setup
    batch = {k: torch.as_tensor(v) for k, v in pipe.get_batch(0).items()}
    step(params, opt, batch)
    gc.collect()
    gc.disable()
    try:
        step(params, opt, batch)
        TrainLoop(LoopConfig(total_steps=1, ckpt_every=1,
                             ckpt_dir=str(tmp_path)),
                  step, pipe, params, opt).run()
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        kept = [type(o).__name__ for o in gc.garbage
                if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert kept == []


def test_sigusr1_checkpoints_at_the_step_boundary(setup, tmp_path):
    """With the handlers installed, SIGUSR1 sent during step 3 ends the run
    after that step with a checkpoint of step 4 (``latest_step`` equals
    ``last_step``)."""
    step, pipe, params, opt = setup
    loop = TrainLoop(LoopConfig(total_steps=50, ckpt_every=1000,
                                ckpt_dir=str(tmp_path)), step, pipe, params,
                     opt)
    calls = []

    def step_and_signal(*args):
        calls.append(1)
        if len(calls) == 4:
            os.kill(os.getpid(), signal.SIGUSR1)
        return step(*args)

    loop.train_step = step_and_signal
    saved = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)]
    loop.install_signal_handlers()
    try:
        out = loop.run()
    finally:
        for s, h in zip((signal.SIGTERM, signal.SIGUSR1), saved):
            signal.signal(s, h)
    assert out["preempted"] and out["last_step"] == 4
    assert ckpt.latest_step(str(tmp_path)) == 4


# -- checkpoints across packages ---------------------------------------------

CROSS_STEPS, CROSS_TOTAL = 4, 7
CROSS_LOSS_TOL = 5e-3


def _cross_setup():
    cfg = reduced_config("smollm-135m")
    ocfg = ref_opt.AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=50)
    ref, port = _pair(cfg)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=2, seq_len=32,
                         seed=0)
    ref_step = jax.jit(ref_opt.make_train_step(cfg, ENV_R, ocfg))
    port_step = adamw.make_train_step(cfg, ENV, adamw.AdamWConfig(
        **dataclasses.asdict(ocfg)))
    ref_run = functools.partial(_loop, ref_loop.TrainLoop, ref_loop.LoopConfig,
                                ref_step, pipe, ref,
                                ref_opt.init_opt_state(ref))
    port_run = functools.partial(_loop, TrainLoop, LoopConfig, port_step,
                                 pipe, port, adamw.init_opt_state(port))
    return ref_run, port_run


def _loop(loop_cls, cfg_cls, step, pipe, params, opt, ckpt_dir, total,
          resume=False):
    """A loop of ``total`` steps writing a checkpoint at CROSS_STEPS;
    resumed from ``ckpt_dir`` first if asked. Returns {step: loss}."""
    loop = loop_cls(cfg_cls(total_steps=total, ckpt_every=CROSS_STEPS,
                            ckpt_dir=ckpt_dir, log_every=1, async_ckpt=False),
                    step, pipe, params, opt)
    start = loop.try_resume() if resume else 0
    assert start == (CROSS_STEPS if resume else 0)
    out = loop.run(start_step=start)
    return {m["step"]: m["loss"] for m in out["metrics"]}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_across_packages(writer, tmp_path):
    """One package trains CROSS_STEPS steps of bf16 smollm and
    checkpoints; both packages resume that checkpoint (the reader's
    own parameters replaced by the checkpoint's) and train to
    CROSS_TOTAL. The reader's losses follow the writer's within
    CROSS_LOSS_TOL (measured ≤ 2.6e-3: the two packages' bf16 gradients
    differ as ``test_loss_and_grads_bf16`` states), the first of them
    within LOSS_BF16, and the checkpoint's keys are the reference's
    ``tree_flatten_with_path`` keys."""
    ref_run, port_run = _cross_setup()
    write, read = (ref_run, port_run) if writer == "reference" else \
        (port_run, ref_run)
    d = str(tmp_path / "ck")
    write(ckpt_dir=d, total=CROSS_STEPS)
    arrays, _ = ckpt.load_arrays(d, CROSS_STEPS)
    want_keys = set()
    cfg = reduced_config("smollm-135m")
    like = {"params": ref_tf.init_params(cfg, jax.random.PRNGKey(0))}
    like["opt"] = ref_opt.init_opt_state(like["params"])
    for path, _ in jax.tree_util.tree_flatten_with_path(like)[0]:
        want_keys.add("/".join(str(k.key) for k in path))
    assert set(arrays) == want_keys
    import shutil
    d2 = str(tmp_path / "ck2")
    shutil.copytree(d, d2)
    own = write(ckpt_dir=d, total=CROSS_TOTAL, resume=True)
    other = read(ckpt_dir=d2, total=CROSS_TOTAL, resume=True)
    assert sorted(own) == sorted(other) == list(range(CROSS_STEPS,
                                                      CROSS_TOTAL))
    assert abs(own[CROSS_STEPS] - other[CROSS_STEPS]) <= LOSS_BF16
    for s in own:
        assert abs(own[s] - other[s]) <= CROSS_LOSS_TOL, (s, own, other)


# -- the CLI -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-small"])
def test_train_cli_on_cpu(arch, tmp_path, capsys):
    """``launch/train.py --device cpu`` trains a reduced arch a few steps
    with checkpoints, and a second run resumes from the last one."""
    args = ["--arch", arch, "--device", "cpu", "--steps", "3", "--batch",
            "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    train_cli.main(args)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step     0 loss ")
    assert out[-1] == "finished at step 3 (preempted=False)"
    assert ckpt.latest_step(str(tmp_path)) == 2
    train_cli.main(args)
    assert capsys.readouterr().out.splitlines() == \
        ["finished at step 3 (preempted=False)"]
