"""The hybrid (hymba), ssm (rwkv6) and audio (whisper) families serving
over a device mesh: ``prefill``, ``encode`` and ``decode_step`` on the
cells (mamba on its block of channels, rwkv6 on its heads, whisper's
encoder and cross-attention on its heads), the placed cache's every leaf
(the hybrid ring, the recurrent states, the cross K/V), ``ServeEngine``
and ``EncodedRetriever`` on meshes of CPU cells (``devices=["cpu"] * n``).

The reference runs these families on 8 virtual CPU devices with ``Auto``
mesh axes in four subprocesses started together by a module fixture
(fp32 on 2 x 4, fp32 on 1 x 8 and 1 x 5, bf16, and its one-device passes
in fp32); every run completes under jax 0.9, so every case is held to
both the reference's mesh run and its one-device pass.

Configs: the reduced ones (hymba: 4 heads and 4 KV heads, which divide a
model axis of 4 but not of 8, d_in 256, ``x_proj``'s 24 output columns
split over 4 and 8; rwkv6: 4 heads of 32, a whole head a cell on 4 model
cells and half a head on 8; whisper: 4 heads, two encoder and two decoder
layers) and ``hymba-1.5b:odd``: d 160, 10 heads over 5 KV heads (on 4
model cells neither divides, as hymba-1.5b's 25 over 5; on 5 they split
two heads and one KV head a cell), d_in 320 and ``x_proj``'s 26 output
columns, which divide none of 4, 5 and 8.

Tolerances, stated per test: fp32 logits and embeddings within
``F32_ATOL`` (1e-5) of the reference; bf16 logits within 2e-2 and
embeddings at cosine >= 0.9995; the cache and decode within 1e-5 of the
port's meshless pass in fp32 (the port's cache keeps room for decode and
its ring always holds the window, unlike the reference's: decode is held
to the port); greedy tokens and retrieval ids exact.
"""
import dataclasses
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
from repro.configs import base as ref_configs
from repro_torch import interop
from repro_torch.configs import base as configs
from repro_torch.core.search import SearchParams
from repro_torch.core.types import Dataset, FilterPredicate
from repro_torch.launch import placement as pl
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.retrieval import EncodedRetriever, RetrievalService

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL = 1e-5
BF16_LOGIT_ATOL = 2e-2
BF16_COS = 0.9995
B, S, S_ENC = 4, 16, 24
POLICIES = ("tp", "dp", "sp")
FAMILIES = ("hymba-1.5b", "rwkv6-3b", "whisper-small")
ODD = "hymba-1.5b:odd"


def fam_cfg(name, pkg=configs):
    """The reduced config of ``name`` (``ODD``: hymba's widths that no
    model axis of 4, 5 or 8 divides all of)."""
    cfg = pkg.reduced_config(name.split(":")[0])
    if name == ODD:
        cfg = dataclasses.replace(cfg, d_model=160, n_heads=10,
                                  n_kv_heads=5, head_dim=16)
    return cfg


def fam_batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, S_ENC, cfg.d_model)).astype(np.float32)
    return out


def pass_keys():
    """``arch|mesh|policy|dtype`` of every case held to the reference."""
    out = [f"{a}|{m}|{p}|f32" for a in FAMILIES for m in ("2x4", "1x8")
           for p in POLICIES]
    out += [f"{ODD}|{m}|tp|f32" for m in ("2x4", "1x5", "1x8")]
    out += [f"{a}|{m}|tp|bf16" for a in FAMILIES for m in ("2x4", "1x8")]
    out.append(f"{ODD}|1x5|tp|bf16")
    return out


def mesh_shape(name):
    return tuple(int(n) for n in name.split("x"))


def cpu_mesh(shape):
    return make_local_mesh(*shape, devices=["cpu"] * int(np.prod(shape)))


@functools.lru_cache(maxsize=None)
def ref_params(name):
    import jax
    from repro.models import transformer as ref_tf
    return ref_tf.init_params(fam_cfg(name, ref_configs),
                              jax.random.PRNGKey(0))


# -- the reference's runs --------------------------------------------------

PRELUDE = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys; sys.path.insert(0, "src"); sys.path.insert(0, "tests")
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    import repro.models.common as ref_common
    import repro.models.transformer as ref_tf
    from repro.launch import shardings as ref_sh
    import test_torch_family_mesh as T
    which = sys.argv[2]
    if which != "bf16":
        ref_common.CDT = ref_tf.CDT = jnp.float32

    def run(name, env, params):
        cfg = T.fam_cfg(name, T.ref_configs)
        batch = {k: jnp.asarray(v) for k, v in T.fam_batch(cfg).items()}
        f = jax.jit(lambda p, b: (
            ref_tf.prefill(p, b, cfg, env)[0],
            ref_tf.encode(p, {"tokens": b["tokens"]}, cfg, env)))
        logits, emb = f(params, batch)
        return np.asarray(logits, np.float32), np.asarray(emb, np.float32)
"""

PASS_SCRIPT = PRELUDE + """
    out = {}
    if which == "one":
        for name in T.FAMILIES + (T.ODD,):
            logits, emb = run(name, ref_tf.ShardEnv(None),
                              T.ref_params(name))
            out[name + "|logits"], out[name + "|embed"] = logits, emb
    for key in T.pass_keys():
        name, mesh_name, pol, dt = key.split("|")
        if which == "one" or (dt == "bf16") != (which == "bf16"):
            continue
        if dt == "f32" and (which == "f32_2x4") != (mesh_name == "2x4"):
            continue
        shape = T.mesh_shape(mesh_name)
        n = int(np.prod(shape))
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:n])
        cfg = T.fam_cfg(name, T.ref_configs)
        params = jax.device_put(T.ref_params(name), ref_sh.param_shardings(
            cfg, mesh, T.ref_params(name), pol))
        logits, emb = run(name, ref_tf.ShardEnv(mesh, policy=pol), params)
        out[key + "|logits"], out[key + "|embed"] = logits, emb
    np.savez(sys.argv[1], **out)
    print("reference ok")
"""


class ReferenceRuns:
    """The reference's four runs, started at once; ``get(which)`` waits
    for one and returns its arrays."""

    RUNS = ("f32_2x4", "f32_rest", "bf16", "one")

    def __init__(self, tmp):
        self.procs, self.paths = {}, {}
        for which in self.RUNS:
            path = os.path.join(tmp, f"{which}.npz")
            self.paths[which] = path
            self.procs[which] = subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(PASS_SCRIPT), path,
                 which], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env={**os.environ, "JAX_PLATFORMS": "cpu"})

    @functools.lru_cache(maxsize=None)
    def get(self, which) -> dict:
        out, err = self.procs[which].communicate(timeout=400)
        assert self.procs[which].returncode == 0, out + err
        assert "reference ok" in out
        return dict(np.load(self.paths[which]))

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


def _f32(monkeypatch):
    """Both packages compute in fp32 (their ``CDT`` patched)."""
    import jax.numpy as jnp
    import repro.models.common as ref_common
    import repro.models.transformer as ref_tf
    for mod, val in ((ref_common, jnp.float32), (ref_tf, jnp.float32),
                     (common, torch.float32), (tf, torch.float32)):
        monkeypatch.setattr(mod, "CDT", val)


@pytest.fixture
def fp32(monkeypatch):
    _f32(monkeypatch)


def _logit_err(want, got) -> float:
    w, g = np.asarray(want, np.float32), np.asarray(got, np.float32)
    real = w > -1e29
    assert np.array_equal(real, g > -1e29)
    return float(np.abs(w - g)[real].max())


# -- (a) prefill and encode against the reference --------------------------

@pytest.mark.parametrize("key", pass_keys())
def test_prefill_and_encode_match_reference_mesh(ref_runs, monkeypatch,
                                                 key):
    """``prefill`` (last-position logits) and ``encode`` over a mesh of
    host cells, the parameters placed by ``param_shardings``, batch 4 x
    16 (whisper with 24 frames): in fp32 within 1e-5 of the reference's
    run on the same mesh shape and of its one-device pass; in bf16 the
    logits within 2e-2 of the reference's mesh run and the embeddings at
    cosine >= 0.9995 with it."""
    name, mesh_name, pol, dt = key.split("|")
    if dt == "f32":
        _f32(monkeypatch)
    cfg = fam_cfg(name)
    env = tf.ShardEnv(cpu_mesh(mesh_shape(mesh_name)), policy=pol)
    port = tf.place_params(interop.params_from_reference(
        ref_params(name), cfg, device="cpu"), env)
    batch = fam_batch(cfg)
    logits, cache = tf.prefill(port, batch, cfg, env)
    emb = tf.encode(port, {"tokens": batch["tokens"]}, cfg, env).numpy()
    assert cache["pos"] == S and all(
        isinstance(v, pl.Sharded) for k, v in cache.items() if k != "pos")
    if dt == "bf16":
        runs = ref_runs.get("bf16")
        assert _logit_err(runs[key + "|logits"], logits) <= BF16_LOGIT_ATOL
        assert (emb * runs[key + "|embed"]).sum(axis=1).min() >= BF16_COS
        return
    mesh_run = ref_runs.get("f32_2x4" if mesh_name == "2x4" else "f32_rest")
    one = ref_runs.get("one")
    for want_l, want_e in ((mesh_run[key + "|logits"],
                            mesh_run[key + "|embed"]),
                           (one[name + "|logits"], one[name + "|embed"])):
        assert logits.shape == want_l.shape and emb.shape == want_e.shape
        assert _logit_err(want_l, logits) <= F32_ATOL
        np.testing.assert_allclose(emb, want_e, atol=F32_ATOL, rtol=0)


# -- (b) the cache after a mesh prefill, (c) decode over a mesh -------------

CACHE_CASES = [  # (arch, mesh, policy, batch, prompt, decode steps)
    ("hymba-1.5b", (2, 4), "tp", 4, 40, 3),   # ring wrapped in prefill
    ("hymba-1.5b", (2, 4), "tp", 4, 30, 5),   # ring wraps in decode
    ("hymba-1.5b", (2, 4), "tp", 1, 40, 3),   # B = 1: sequence-split ring
    ("hymba-1.5b", (2, 4), "tp", 1, 30, 5),
    ("hymba-1.5b", (2, 4), "dp", 4, 40, 3),
    ("hymba-1.5b", (2, 4), "sp", 4, 40, 3),
    ("hymba-1.5b", (1, 8), "tp", 4, 40, 3),
    (ODD, (1, 5), "tp", 1, 40, 3),
    (ODD, (2, 4), "tp", 4, 30, 5),
    ("rwkv6-3b", (2, 4), "tp", 4, 16, 3),
    ("rwkv6-3b", (2, 4), "tp", 1, 16, 3),     # states replicated over data
    ("rwkv6-3b", (2, 4), "dp", 4, 16, 3),
    ("rwkv6-3b", (1, 8), "tp", 4, 16, 3),     # half a head a cell
    ("rwkv6-3b", (1, 8), "sp", 4, 16, 3),
    ("whisper-small", (2, 4), "tp", 4, 16, 3),
    ("whisper-small", (2, 4), "tp", 1, 16, 3),  # sequence-split cross K/V
    ("whisper-small", (2, 4), "sp", 4, 16, 3),
    ("whisper-small", (1, 8), "dp", 4, 16, 3),
]


def _case_id(case):
    arch, shape, pol, b, s, n = case
    return f"{arch}-{shape[0]}x{shape[1]}-{pol}-B{b}-S{s}"


@pytest.mark.parametrize("case", CACHE_CASES, ids=_case_id)
def test_mesh_cache_and_decode_match_meshless(fp32, case):
    """After a mesh ``prefill`` (cache room for the decode steps) every
    leaf of the cache (``k``/``v`` ring slots, ``ssm``, ``conv``,
    ``wkv``, ``shift_tm``, ``shift_cm``, ``ck``, ``cv``) is placed as
    ``cache_shardings`` says and, gathered, equals the meshless cache
    within 1e-5 (fp32); then teacher-forced ``decode_step``s over the
    mesh give the meshless decode's logits within 1e-5 at every step,
    and the cache after them is still the meshless one. hymba's window is
    32 slots: a prompt of 40 wraps the ring in prefill, one of 30 wraps it
    during decode; a batch of 1 on 2 x 4 splits the ring's (and
    whisper's cross K/V's) slots over the model axis."""
    arch, shape, pol, b, s, steps = case
    cfg = fam_cfg(arch)
    port = tf.init_params(cfg, seed=1, device="cpu")
    mesh = cpu_mesh(shape)
    env = tf.ShardEnv(mesh, policy=pol)
    placed = tf.place_params(port, env)
    full = fam_batch(cfg, b=b, s=s + steps, seed=2)
    first = {**full, "tokens": full["tokens"][:, :s]}
    _, c_mesh = tf.prefill(placed, first, cfg, env, cache_len=s + steps)
    _, c_one = tf.prefill(port, first, cfg, tf.ONE_DEVICE,
                          cache_len=s + steps)

    def same_cache():
        want = sh.cache_shardings(cfg, mesh, {
            k: v for k, v in c_one.items() if k != "pos"})
        for name, leaf in c_mesh.items():
            if name == "pos":
                assert leaf == c_one["pos"]
                continue
            assert tuple(leaf.spec) == tuple(want[name].spec), name
            np.testing.assert_allclose(
                pl.gather(leaf).float().numpy(),
                c_one[name].float().numpy(), atol=F32_ATOL, rtol=0,
                err_msg=name)
        return set(c_mesh) - {"pos"}

    names = same_cache()
    expect = {"hybrid": {"k", "v", "ssm", "conv"},
              "ssm": {"wkv", "shift_tm", "shift_cm"},
              "audio": {"k", "v", "ck", "cv"}}[cfg.family]
    assert names == expect
    if cfg.family == "hybrid" and b == 1 and shape == (2, 4):
        assert tuple(c_mesh["k"].spec) == (None, None, "model", None, None)
    for t in range(steps):
        step = {"tokens": full["tokens"][:, s + t:s + t + 1]}
        l_mesh, c_mesh = tf.decode_step(placed, c_mesh, step, cfg, env)
        l_one, c_one = tf.decode_step(port, c_one, step, cfg, tf.ONE_DEVICE)
        assert _logit_err(l_one.numpy(), l_mesh.numpy()) <= F32_ATOL, t
    same_cache()


# -- (d) serving -----------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("hymba-1.5b", (2, 4)),
                                        ("hymba-1.5b", (1, 8)),
                                        (ODD, (1, 5)),
                                        (ODD, (2, 4)),
                                        ("rwkv6-3b", (2, 4)),
                                        ("rwkv6-3b", (1, 8))])
def test_serve_engine_generates_over_a_mesh(fp32, arch, shape):
    """``ServeEngine`` over a mesh of host cells generates the meshless
    engine's greedy tokens (fp32, exact), hymba's ring wrapping during
    generation (a prompt of 28 and 8 new tokens over 32 slots)."""
    cfg = fam_cfg(arch)
    port = tf.init_params(cfg, seed=3, device="cpu")
    eng = ServeEngine(cfg, tf.ShardEnv(cpu_mesh(shape)), port)
    assert isinstance(eng.params, tf.MeshParams)
    toks = fam_batch(cfg, b=4, s=28, seed=8)["tokens"]
    got = eng.generate(toks, max_new=8)
    want = ServeEngine(cfg, tf.ONE_DEVICE, port,
                       device="cpu").generate(toks, max_new=8)
    assert got.device == torch.device("cpu") and torch.equal(got, want)


def test_encoded_retriever_hymba_over_a_mesh(fp32):
    """``EncodedRetriever`` with hymba encoding over a 2 x 4 mesh for a
    meshless service: embeddings within 1e-5 of the meshless encoder's
    (fp32), and ``retrieve_batch`` the meshless retriever's ids."""
    cfg = fam_cfg("hymba-1.5b")
    port = tf.init_params(cfg, seed=4, device="cpu")
    rng = np.random.default_rng(9)
    docs = rng.integers(0, cfg.vocab_size, (300, 12)).astype(np.int32)
    vecs = tf.encode(port, {"tokens": docs}, cfg, tf.ONE_DEVICE).numpy()
    meta = rng.integers(0, 4, (300, 2)).astype(np.int32)
    svc = RetrievalService.build(Dataset(vecs, meta, ["a", "b"], [4, 4]),
                                 graph_k=8, r_max=24,
                                 params=SearchParams(k=5, max_hops=50),
                                 device="cpu")
    retr = EncodedRetriever(cfg, tf.ShardEnv(cpu_mesh((2, 4))), port, svc)
    one = EncodedRetriever(cfg, tf.ONE_DEVICE, port, svc)
    assert isinstance(retr.params, tf.MeshParams)
    prompts = docs[:8]
    np.testing.assert_allclose(retr.embed_tokens(prompts),
                               one.embed_tokens(prompts), atol=F32_ATOL,
                               rtol=0)
    preds = [FilterPredicate.make({0: [i % 4]}) for i in range(8)]
    ids, _ = retr.retrieve_batch(prompts, preds)
    want, _ = one.retrieve_batch(prompts, preds)
    assert all(np.array_equal(a, b) for a, b in zip(ids, want))
