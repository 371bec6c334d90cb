"""The port's LM layer (``repro_torch.configs``, ``repro_torch.models``)
held to the reference on the CPU, with the same weights
(``interop.params_from_reference``) and the same numpy-seeded inputs.

The reference runs with ``ShardEnv(None)``: with a default (1, 1) mesh it
raises under jax 0.9 on ``with_sharding_constraint`` over ``Explicit``
axes. Its MoE has no ``mesh=None`` path, so dbrx and kimi-k2 run on a
(1, 1) mesh with ``Auto`` axes (``test_torch_moe.auto_mesh``).

Tolerances, measured on these inputs and stated per test:
* fp32 compute (``CDT`` set to float32 in both packages): the same
  function up to summation order, logits within 1e-5 (measured ≤ 1.1e-6);
* bf16 compute (the real dtype): XLA and torch sum bf16 products in
  other orders, so logits within 2e-2 absolute at 2 layers (measured
  ≤ 1.4e-2 on logits of magnitude ≤ 0.86) and embeddings at cosine
  ≥ 0.9995 (measured ≥ 0.99990).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_moe import auto_mesh, dropless

import repro.models.common as ref_common
import repro.models.transformer as ref_tf
from repro.configs import base as ref_configs
from repro.models import attention as ref_attn
from repro_torch.configs import base as configs
from repro_torch.interop import params_from_reference
from repro_torch.models import attention, common, kvcache
from repro_torch.models import transformer as tf

ENV_R, ENV = ref_tf.ShardEnv(None), tf.ShardEnv(None)
F32_ATOL = 1e-5
BF16_LOGIT_ATOL = 2e-2
BF16_COS = 0.9995
DENSE = ("smollm-135m", "llama3.2-1b", "gemma3-1b")
FAMILIES = ("dbrx-132b", "kimi-k2-1t-a32b", "hymba-1.5b", "rwkv6-3b")


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


@pytest.fixture
def fp32(monkeypatch):
    """Both packages compute in fp32 (their ``CDT`` patched)."""
    monkeypatch.setattr(ref_common, "CDT", jnp.float32)
    monkeypatch.setattr(ref_tf, "CDT", jnp.float32)
    monkeypatch.setattr(common, "CDT", torch.float32)
    monkeypatch.setattr(tf, "CDT", torch.float32)


def _env_r(cfg):
    """The reference's env for ``cfg`` (a mesh for its MoE)."""
    return ref_tf.ShardEnv(auto_mesh()) if cfg.is_moe else ENV_R


def _pair(cfg, seed=0):
    """Reference params for ``cfg`` and the port's copy of them."""
    ref = ref_tf.init_params(cfg, jax.random.PRNGKey(seed))
    return ref, params_from_reference(ref, cfg, device="cpu")


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "patch":
        return {"embeds": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   (B, S)).astype(np.int32)}


def _ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _logit_err(ref_logits, port_logits) -> float:
    """Max abs difference over the real vocabulary (pad ids are -1e30 in
    both)."""
    r, p = _np(ref_logits), _np(port_logits)
    real = r > -1e29
    assert np.array_equal(real, p > -1e29)
    return float(np.abs(r - p)[real].max())


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_configs_equal(name):
    """Every field, derived value and plan of every arch, published and
    reduced, equals the reference's."""
    assert ref_configs.ARCH_NAMES == configs.ARCH_NAMES
    for get in ("get_config", "reduced_config"):
        a = getattr(ref_configs, get)(name)
        b = getattr(configs, get)(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.hd, a.is_moe, a.attn_free, a.sub_quadratic) == \
            (b.hd, b.is_moe, b.attn_free, b.sub_quadratic)
        for active in (False, True):
            assert a.param_count(active) == b.param_count(active)
        assert ref_configs.model_flops_per_token(a) == \
            configs.model_flops_per_token(b)
    assert ref_configs.cell_plan(name) == configs.cell_plan(name)
    assert {k: dataclasses.asdict(v) for k, v in
            ref_configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}


def test_fns_config_equal():
    from repro.configs import fns as ref_fns
    from repro_torch.configs import fns
    assert dataclasses.asdict(ref_fns.PAPER) == dataclasses.asdict(fns.PAPER)
    assert dataclasses.asdict(ref_fns.BENCH) == dataclasses.asdict(fns.BENCH)


# -- building blocks -----------------------------------------------------------

def test_common_blocks_match():
    """rms_norm (the 1 + scale form), rope (fp32 angles), swiglu,
    embed/unembed (pad ids at -1e30) and the loss, in fp32 (1e-5;
    measured ≤ 3e-7) and in bf16 (one bf16 ulp at the outputs' magnitude
    < 4, 1.6e-2; measured 0: here both round alike)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    scale = 0.1 * rng.standard_normal(16).astype(np.float32)
    pos = np.arange(6)[None, :]
    w = [rng.standard_normal(s).astype(np.float32) * 0.2
         for s in ((16, 24), (16, 24), (24, 16))]
    table = rng.standard_normal((20, 16)).astype(np.float32)
    labels = rng.integers(0, 17, (2, 6))
    for jdt, tdt, tol in ((jnp.float32, torch.float32, F32_ATOL),
                          (jnp.bfloat16, torch.bfloat16, 1.6e-2)):
        xj, xt = jnp.asarray(x, jdt), _t(x, tdt)
        pairs = [
            (ref_common.rms_norm(xj, jnp.asarray(scale)),
             common.rms_norm(xt, _t(scale))),
            (ref_common.rope(xj, jnp.asarray(pos), 500_000.0),
             common.rope(xt, torch.from_numpy(pos), 500_000.0)),
            (ref_common.swiglu(xj, *(jnp.asarray(a, jdt) for a in w)),
             common.swiglu(xt, *(_t(a, tdt) for a in w))),
        ]
        for r, p in pairs:
            assert p.dtype == tdt
            np.testing.assert_allclose(_np(p), _np(r), atol=tol, rtol=0)
    h = rng.standard_normal((2, 6, 16)).astype(np.float32)
    r = ref_common.unembed_logits(jnp.asarray(h, jnp.bfloat16),
                                  jnp.asarray(table), 17)
    p = common.unembed_logits(_t(h, torch.bfloat16), _t(table), 17)
    assert _logit_err(r, p) <= 1.6e-2
    assert (p[..., 17:] == -1e30).all()
    lf = rng.standard_normal((2, 6, 20)).astype(np.float32)
    np.testing.assert_allclose(
        float(common.softmax_xent(_t(lf), torch.from_numpy(labels))),
        float(ref_common.softmax_xent(jnp.asarray(lf),
                                      jnp.asarray(labels))), rtol=1e-6)
    toks = rng.integers(0, 20, (2, 5))
    np.testing.assert_array_equal(
        _np(common.embed_lookup(_t(table), torch.from_numpy(toks))),
        _np(ref_common.embed_lookup(jnp.asarray(table), jnp.asarray(toks))))
    tree = {"w": _t(table), "i": torch.from_numpy(toks), "l": [_t(h)]}
    cast = common.cast(tree)
    assert cast["w"].dtype == cast["l"][0].dtype == common.CDT
    assert cast["i"].dtype == torch.int64
    ref_cast = ref_common.cast({"w": jnp.asarray(table)})
    np.testing.assert_array_equal(_np(cast["w"]), _np(ref_cast["w"]))
    assert common.pad_vocab(49152) == ref_common.pad_vocab(49152) == 49152
    assert common.pad_vocab(51865) == ref_common.pad_vocab(51865)


ATTN_CASES = [  # (H, KV, Sq, Sk, window, q_chunk, kv_chunk, q_offset)
    (9, 3, 32, 32, 0, 8, 16, 0),      # SmolLM's GQA grouping, 4x2 blocks
    (4, 1, 48, 48, 12, 16, 16, 0),    # gemma3-style window across blocks
    (4, 2, 16, 48, 0, 8, 16, 32),     # continuation: q at positions 32..47
    (6, 6, 24, 24, 5, 24, 8, 0),      # MHA, one q block, window < kv block
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention_matches(case, dtype):
    """Causal / windowed / GQA / q_offset chunked attention: fp32 within
    1e-5 (measured ≤ 4.8e-7), bf16 within 1.6e-2 (one ulp at the outputs'
    magnitude < 4; measured ≤ 6.1e-5)."""
    H, KV, Sq, Sk, window, qc, kc, off = case
    rng = np.random.default_rng(sum(case))
    q = rng.standard_normal((2, Sq, H, 16)).astype(np.float32)
    k = rng.standard_normal((2, Sk, KV, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sk, KV, 16)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(causal=True, window=window, q_chunk=qc, kv_chunk=kc,
              q_offset=off)
    r = ref_attn.chunked_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                   **kw)
    p = attention.chunked_attention(*(_t(a, tdt) for a in (q, k, v)), **kw)
    assert p.dtype == tdt and p.shape == (2, Sq, H, 16)
    tol = F32_ATOL if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(_np(p), _np(r), atol=tol, rtol=0)


def test_chunked_attention_rejects_ragged_blocks():
    q = torch.zeros((1, 12, 2, 8))
    with pytest.raises(ValueError, match="multiples"):
        attention.chunked_attention(q, q, q, q_chunk=8)


@pytest.mark.parametrize("window", [0, 7])
def test_decode_attention_matches(window):
    """One query over a cache with 13 of 20 slots valid (GQA 9/3), fp32
    within 1e-5 (measured ≤ 1.8e-7)."""
    rng = np.random.default_rng(window)
    q = rng.standard_normal((2, 1, 9, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 20, 3, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 20, 3, 16)).astype(np.float32)
    r = ref_attn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(13),
                                  window=window)
    p = attention.decode_attention(_t(q), _t(kc), _t(vc), 13, window=window)
    np.testing.assert_allclose(_np(p), _np(r), atol=F32_ATOL, rtol=0)


# -- whole-model passes --------------------------------------------------------

def _smollm_gqa():
    """Reduced SmolLM at its real 9 query / 3 KV heads (the reduced
    config has 4 / 2), so a wrong GQA reshape shows."""
    return dataclasses.replace(configs.reduced_config("smollm-135m"),
                               n_heads=9, n_kv_heads=3, head_dim=16)


def _cfg(name):
    if name == "smollm-gqa":
        return _smollm_gqa()
    if name.endswith("-dropless"):
        return dropless(configs.reduced_config(name[:-len("-dropless")]))
    return configs.reduced_config(name)


MODEL_CASES = DENSE + ("internvl2-76b", "smollm-gqa") + FAMILIES


@pytest.mark.parametrize("name", MODEL_CASES)
def test_encode_and_prefill_match(name):
    """``encode`` and ``prefill`` (logits and every cache entry: K/V, and
    hymba's mamba state and conv tail, rwkv6's wkv state and shift
    tails) at S=64 (past gemma3's and hymba's reduced 32-token windows; a
    multiple of the window, so hymba's ring is in the reference's order)
    in bf16: logits within 2e-2 (measured ≤ 1.2e-2), embeddings at
    cosine ≥ 0.9995, K/V within 2% of their largest magnitude (measured
    ≤ 1.3%: layer 2's inputs already differ by bf16 rounding) and the
    other entries within 3% (measured ≤ 1.8%, hymba's ssm state, which
    sums 64 steps of such inputs)."""
    cfg = _cfg(name)
    ref, port = _pair(cfg)
    batch = _batch(cfg, 2, 64)
    env_r = _env_r(cfg)
    e_r = _np(ref_tf.encode(ref, _ref_batch(batch), cfg, env_r))
    e_p = tf.encode(port, batch, cfg, ENV).numpy()
    assert e_p.shape == (2, cfg.d_model) and e_p.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(e_p, axis=1), 1.0, atol=1e-6)
    assert (e_r * e_p).sum(axis=1).min() >= BF16_COS
    l_r, c_r = ref_tf.prefill(ref, _ref_batch(batch), cfg, env_r)
    l_p, c_p = tf.prefill(port, batch, cfg, ENV)
    assert l_p.shape == l_r.shape and l_p.dtype == torch.float32
    assert _logit_err(l_r, l_p) <= BF16_LOGIT_ATOL
    assert c_p["pos"] == int(c_r["pos"]) == 64
    assert c_p.keys() == c_r.keys()
    for key in c_r.keys() - {"pos"}:
        r, p = _np(c_r[key]), _np(c_p[key])
        assert p.shape == r.shape and p.dtype == r.dtype, key
        rel = 0.02 if key in ("k", "v") else 0.03
        np.testing.assert_allclose(p, r, atol=rel * np.abs(r).max(),
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("name", MODEL_CASES)
def test_prefill_fp32_matches(fp32, name):
    """The same passes with both packages in fp32: the same function up
    to summation order (logits and embeddings within 1e-5; MoE routing
    and capacity drops then equal)."""
    cfg = _cfg(name)
    ref, port = _pair(cfg, seed=1)
    batch = _batch(cfg, 2, 64, seed=1)
    env_r = _env_r(cfg)
    l_r, _ = ref_tf.prefill(ref, _ref_batch(batch), cfg, env_r)
    l_p, _ = tf.prefill(port, batch, cfg, ENV)
    assert _logit_err(l_r, l_p) <= F32_ATOL
    np.testing.assert_allclose(
        tf.encode(port, batch, cfg, ENV).numpy(),
        _np(ref_tf.encode(ref, _ref_batch(batch), cfg, env_r)),
        atol=F32_ATOL, rtol=0)


def _decode_vs_ref_prefill(cfg, S, T, seed=0):
    """Per decode step t: the max logit error of the port's
    ``decode_step`` (after ``prefill`` with room for T tokens) against
    the reference's ``prefill`` over the S + t + 1 tokens."""
    ref, port = _pair(cfg, seed)
    full = _batch(cfg, 2, S + T, seed)
    key = next(iter(full))
    _, cache = tf.prefill(port, {key: full[key][:, :S]}, cfg, ENV,
                          cache_len=S + T)
    errs = []
    for t in range(T):
        l_r, _ = ref_tf.prefill(ref, _ref_batch({key: full[key][:, :S + t + 1]}),
                                cfg, _env_r(cfg))
        l_p, cache = tf.decode_step(port, cache,
                                    {key: full[key][:, S + t:S + t + 1]},
                                    cfg, ENV)
        assert cache["pos"] == S + t + 1
        errs.append(_logit_err(l_r, l_p))
    return errs


DECODE_FAMILIES = ("dbrx-132b-dropless", "kimi-k2-1t-a32b-dropless",
                   "hymba-1.5b", "rwkv6-3b")


@pytest.mark.parametrize("name", DENSE + ("internvl2-76b",) + DECODE_FAMILIES)
def test_decode_matches_reference_prefill(name):
    """``decode_step`` after the port's ``prefill`` computes what the
    reference's ``prefill`` over the longer sequence computes (bf16
    logits within 2e-2; gemma3's decode crosses its 32-token window, and
    hymba's ring, as long as that window, wraps at position 32). The MoE
    configs use a dropless capacity factor: decode is dropless, so only
    a prefill that drops nothing computes its function."""
    errs = _decode_vs_ref_prefill(_cfg(name), 30, 4)
    assert max(errs) <= BF16_LOGIT_ATOL, errs


@pytest.mark.parametrize("name", ["smollm-gqa", "gemma3-1b"]
                         + list(DECODE_FAMILIES))
def test_decode_fp32_matches_reference_prefill(fp32, name):
    """As above in fp32 (within 1e-5), from a 40-token prompt: past
    hymba's 32-token window and not a multiple of it."""
    errs = _decode_vs_ref_prefill(_cfg(name), 40, 3, seed=2)
    assert max(errs) <= F32_ATOL, errs


def test_reference_decode_overwrites_last_prompt_slot(fp32):
    """The reference defect the port does not copy (ROADMAP queue 3): its
    dense ``prefill`` keeps a cache as long as the prompt, so a
    ``decode_step`` writes the new token's K/V over the last prompt
    token's. In fp32, at reduced SmolLM and S=16, its logits then miss
    its own ``prefill`` over S + 1 tokens by far more than rounding
    (measured 0.214 on logits of magnitude 0.836); the port's match it. A
    port cache without room refuses to decode."""
    cfg = configs.reduced_config("smollm-135m")
    ref, port = _pair(cfg)
    toks = _batch(cfg, 2, 17)["tokens"]
    _, c_r = ref_tf.prefill(ref, {"tokens": jnp.asarray(toks[:, :16])}, cfg,
                            ENV_R)
    l_dec, _ = ref_tf.decode_step(ref, c_r,
                                  {"tokens": jnp.asarray(toks[:, 16:])},
                                  cfg, ENV_R)
    l_full, _ = ref_tf.prefill(ref, {"tokens": jnp.asarray(toks)}, cfg,
                               ENV_R)
    assert _logit_err(l_full, l_dec) > 1000 * F32_ATOL
    _, c_p = tf.prefill(port, {"tokens": toks[:, :16]}, cfg, ENV,
                        cache_len=17)
    l_p, c_p = tf.decode_step(port, c_p, {"tokens": toks[:, 16:]}, cfg, ENV)
    assert _logit_err(l_full, l_p) <= F32_ATOL
    with pytest.raises(ValueError, match="all used"):
        tf.decode_step(port, c_p, {"tokens": toks[:, 16:]}, cfg, ENV)


def _reference_decode_miss(cfg, S):
    """fp32: how far the reference's ``decode_step`` after its
    ``prefill`` of S tokens, and the port's after its ``prefill`` with
    room for one, miss the reference's ``prefill`` over the S + 1 tokens.
    Returns (reference miss, port miss, the port's cache after the
    step)."""
    ref, port = _pair(cfg)
    toks = _batch(cfg, 2, S + 1)["tokens"]
    env_r = _env_r(cfg)
    _, c_r = ref_tf.prefill(ref, {"tokens": jnp.asarray(toks[:, :S])}, cfg,
                            env_r)
    l_dec, _ = ref_tf.decode_step(ref, c_r,
                                  {"tokens": jnp.asarray(toks[:, S:])},
                                  cfg, env_r)
    l_full, _ = ref_tf.prefill(ref, {"tokens": jnp.asarray(toks)}, cfg,
                               env_r)
    _, c_p = tf.prefill(port, {"tokens": toks[:, :S]}, cfg, ENV,
                        cache_len=S + 1)
    l_p, c_p = tf.decode_step(port, c_p, {"tokens": toks[:, S:]}, cfg, ENV)
    return _logit_err(l_full, l_dec), _logit_err(l_full, l_p), c_p


@pytest.mark.parametrize("S", [16, 40])
def test_reference_hybrid_ring_evicts_prompt(fp32, S):
    """The reference defect the port does not copy (ROADMAP queue 3):
    its hybrid ``prefill`` keeps the prompt's last min(window, S)
    positions in order, but ``decode_step`` writes at ``pos % S_cache``
    and attends the whole ring. At S=16 (< the reduced window of 32) the
    first decode overwrites prompt token 0; at S=40 (> 32, not a
    multiple) positions 8..39 sit at slots 0..31 and the first decode
    writes slot 40 % 32 = 8, evicting position 16 where position 8 should
    leave. Either way its logits miss its own ``prefill`` over S + 1
    tokens by far more than rounding (measured 0.233 at S=16 and 0.265
    at S=40 on logits of magnitude < 1); the port's match
    it. A ring shorter than the window refuses to wrap; one as long
    wraps."""
    cfg = configs.reduced_config("hymba-1.5b")
    miss_r, miss_p, c_p = _reference_decode_miss(cfg, S)
    assert miss_r > 1000 * F32_ATOL
    assert miss_p <= F32_ATOL
    ring = c_p["k"].shape[2]
    assert ring == min(cfg.sliding_window, S + 1)
    port = _pair(cfg)[1]
    tok = {"tokens": np.zeros((2, 1), np.int32)}
    if ring < cfg.sliding_window:
        with pytest.raises(ValueError, match="all used"):
            tf.decode_step(port, c_p, tok, cfg, ENV)
    else:
        for _ in range(ring):
            _, c_p = tf.decode_step(port, c_p, tok, cfg, ENV)
        assert c_p["pos"] == S + 1 + ring


def test_reference_moe_decode_overwrites_last_prompt_slot(fp32):
    """The dense defect in the moe family: with a dropless capacity
    factor (so its prefill and decode compute one function), the
    reference's decode still misses its own ``prefill`` over S + 1
    tokens by far more than rounding, because it overwrites the last
    prompt position's K/V (measured 0.241 on logits of magnitude < 1);
    the port's match it."""
    miss_r, miss_p, _ = _reference_decode_miss(
        dropless(configs.reduced_config("dbrx-132b")), 16)
    assert miss_r > 1000 * F32_ATOL
    assert miss_p <= F32_ATOL


def _leaf_shapes(port, L) -> dict:
    """The port's parameters by the reference's tree paths, with the
    leading L of the reference's stacked layers; each fp32 on the CPU."""
    out = {}
    for name, t in port.state_dict().items():
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        parts = name.split(".")
        if parts[0] == "layers":
            key = "['layers']" + "".join(f"['{p}']" for p in parts[2:])
            out[key] = (L,) + tuple(t.shape)
        else:
            out[f"['{name}']"] = tuple(t.shape)
    return out


def _ref_leaf_shapes(ref) -> dict:
    return {jax.tree_util.keystr(p): a.shape for p, a in
            jax.tree_util.tree_flatten_with_path(ref)[0]}


def test_init_params_layout():
    """``init_params`` draws every leaf the reference has, at its shape,
    fp32, on the named device, the same weights for the same seed; norm
    scales start at zero."""
    cfg = configs.reduced_config("gemma3-1b")
    ref = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
    port = tf.init_params(cfg, seed=3, device="cpu")
    assert _leaf_shapes(port, cfg.n_layers) == _ref_leaf_shapes(ref)
    again = tf.init_params(cfg, seed=3, device="cpu")
    for a, b in zip(port.parameters(), again.parameters()):
        assert torch.equal(a, b)
    assert not port.layers[1].ln2.any() and not port.final_norm.any()
    assert float(port.layers[0].attn.wq.detach().std()) == pytest.approx(
        cfg.d_model ** -0.5, rel=0.05)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_init_params_layout(name):
    """The MoE (router, experts, kimi-k2's shared expert), hybrid (mamba
    head, beta) and ssm (rwkv6's flat leaves) layers: every leaf the
    reference has, at its shape; the same seed, the same weights."""
    cfg = configs.reduced_config(name)
    ref = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
    port = tf.init_params(cfg, seed=3, device="cpu")
    assert _leaf_shapes(port, cfg.n_layers) == _ref_leaf_shapes(ref)
    again = tf.init_params(cfg, seed=3, device="cpu")
    for a, b in zip(port.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,seq", [("dbrx-132b", 24), ("hymba-1.5b", 24),
                                      ("hymba-1.5b", 48), ("rwkv6-3b", 24)])
def test_cache_specs_match_family_layouts(name, seq):
    """The moe (full K/V), hybrid (a ring of min(window, S): 24 and 32
    slots at the reduced window of 32, fp32 ssm state, conv tail) and
    ssm (fp32 wkv state, shift tails) layouts: the reference's names,
    shapes and dtypes."""
    from repro.models import kvcache as ref_kvcache
    cfg = configs.reduced_config(name)
    spec = configs.ShapeSpec("t", seq, 3, "decode")
    r = ref_kvcache.cache_specs(cfg, spec)
    p = kvcache.cache_specs(cfg, spec)
    assert r.keys() == p.keys()
    for key, (shape, dtype) in p.items():
        assert tuple(r[key].shape) == shape, key
        assert str(r[key].dtype) == str(dtype).split(".")[-1], key
    cache = kvcache.init_cache(cfg, spec, device="cpu")
    assert cache["pos"] == 0
    assert not any(v.any() for k, v in cache.items() if k != "pos")


def test_cache_specs_match_dense_layout():
    from repro.models import kvcache as ref_kvcache
    cfg = configs.reduced_config("llama3.2-1b")
    spec = configs.ShapeSpec("t", 24, 3, "decode")
    r = ref_kvcache.cache_specs(cfg, spec)
    p = kvcache.cache_specs(cfg, spec)
    assert {k: tuple(v.shape) for k, v in r.items()} == \
        {k: shape for k, (shape, _) in p.items()}
    cache = kvcache.init_cache(cfg, spec, device="cpu")
    assert cache["pos"] == 0 and cache["k"].dtype == common.CDT
    assert not cache["v"].any()


@pytest.mark.parametrize("name", ["whisper-small"])
def test_unported_families_raise(name):
    """No family is left unported (audio came last): whisper initializes
    with its encoder, its cache specs are the reference's audio layout,
    and what raises is an audio prefill without the frames its encoder
    reads."""
    from repro.models import kvcache as ref_kvcache
    cfg = configs.reduced_config(name)
    params = tf.init_params(cfg, device="cpu")
    assert len(params.enc_layers) == cfg.n_enc_layers
    spec = configs.SHAPES["decode_32k"]
    assert {k: tuple(v.shape) for k, v in
            ref_kvcache.cache_specs(cfg, spec).items()} == \
        {k: shape for k, (shape, _) in kvcache.cache_specs(cfg, spec).items()}
    with pytest.raises(KeyError, match="frames"):
        tf.prefill(params, {"tokens": np.zeros((1, 4), np.int32)}, cfg, ENV)


def test_shard_env_refuses_a_mesh():
    """A mesh is ported (``tests/test_torch_lm_mesh.py``); anything but
    the port's ``Mesh`` is refused."""
    with pytest.raises(TypeError, match="Mesh"):
        tf.ShardEnv(object())
