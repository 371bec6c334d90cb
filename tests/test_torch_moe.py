"""The port's MoE FFN (``repro_torch.models.moe``) held to the
reference's on one device, same weights and numpy-seeded inputs.

The reference's MoE has no ``mesh=None`` path (``moe_ffn`` reads
``mesh.shape``) and ``jax.make_mesh``'s default ``Explicit`` axes fail
under jax 0.9, so it runs here on a (1, 1) mesh with ``Auto`` axes: its
``train``/``prefill`` path is then ``_moe_a2a`` with one model shard and
its ``decode`` path ``_moe_replicated``.

Tolerances, measured on these inputs and stated per test: expert ids,
bucket slots and kept/dropped rows exact (fp32 logits, and bf16 logits
in the tie case); fp32 outputs within 1e-5 of their largest magnitude
(measured ≤ 1.7e-7); bf16 outputs within 8e-3 of it, two bf16 ulps
(measured ≤ 4.5e-3: the output's rounding to bf16 differs by an ulp).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro_torch.configs import reduced_config
from repro_torch.models import moe
from repro_torch.models.transformer import Tree

F32_REL, BF16_REL = 1e-5, 8e-3


@functools.lru_cache(maxsize=None)
def auto_mesh():
    """A (1, 1) ("data", "model") mesh with ``Auto`` axes, for the
    reference's MoE (also imported by ``test_torch_lm.py`` and
    ``test_torch_rag.py``)."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def dropless(cfg):
    """A MoE config whose capacity path drops nothing (factor E / k, so
    cap_e >= T·k): its ``prefill`` then computes the function of the
    dropless decode path."""
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.moe_top_k)


@functools.partial(jax.jit, static_argnames=("dims", "mode"))
def ref_moe_ffn(x, params, dims, mode):
    """The reference's ``moe_ffn`` on the Auto mesh, jitted (run eagerly
    its shard_map takes ~11 s a call here)."""
    return ref_moe.moe_ffn(x, params, dims, auto_mesh(), mode=mode)


def _np(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


def _close(got, want, rel):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


def _dtypes(dtype):
    return ((jnp.float32, torch.float32) if dtype == "float32"
            else (jnp.bfloat16, torch.bfloat16))


def _experts(cfg, seed=0):
    """The reference's MoE leaves for ``cfg`` and the port's copy."""
    ref = ref_tf._init_moe(jax.random.PRNGKey(seed), cfg)
    port = Tree({k: torch.from_numpy(np.array(v, np.float32))
                 for k, v in ref.items() if k != "shared"})
    return ref, port


def _dims(cfg, cf=None):
    return moe.MoEDims(cfg.n_experts, cfg.moe_top_k,
                       cfg.capacity_factor if cf is None else cf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_matches_random(dtype):
    """Random tokens through reduced kimi-k2's router (4 experts, top 2):
    the same expert ids (fp32 logits differ only in rounding, far from
    ties here) and combine weights."""
    cfg = reduced_config("kimi-k2-1t-a32b")
    ref_p, port_p = _experts(cfg)
    x = np.random.default_rng(0).standard_normal((96, cfg.d_model))
    jdt, tdt = _dtypes(dtype)
    ids_r, w_r = ref_moe._route(jnp.asarray(x, jdt), ref_p["router"],
                                _dims(cfg))
    ids_p, w_p = moe._route(torch.from_numpy(x).to(tdt), port_p.router,
                            _dims(cfg))
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_r))
    assert w_p.dtype == torch.float32
    np.testing.assert_allclose(_np(w_p), _np(w_r), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_ties_take_the_lower_expert(dtype):
    """kimi-k2's 384 experts, top 8, with logits that are exact small
    multiples of 0.25 (codes in {-1, 0, 1} against weights in {-1, -0.5,
    0, 0.5, 1}), so nearly every row ties across its top-k boundary: the
    ids equal ``lax.top_k``'s (the lower id first among equals) in both
    dtypes, weights too."""
    rng = np.random.default_rng(1)
    d, E, k = 16, 384, 8
    x = rng.integers(-1, 2, (64, d)).astype(np.float32)
    w = rng.integers(-2, 3, (d, E)).astype(np.float32) / 2
    dims = moe.MoEDims(E, k)
    jdt, tdt = _dtypes(dtype)
    ids_r, w_r = ref_moe._route(jnp.asarray(x, jdt), jnp.asarray(w), dims)
    ids_p, w_p = moe._route(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                            dims)
    logits = x @ w
    top = np.sort(logits, axis=1)[:, ::-1]
    assert (top[:, k - 1] == top[:, k]).mean() > 0.5   # ties at the cut
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(_np(w_p), _np(w_r), atol=1e-6, rtol=0)


@pytest.mark.parametrize("cap", [3, 7, 40])
def test_fill_buckets_matches(cap):
    """Rows dealt into 4 buckets by a destination with -1 (dropped) rows,
    over capacity (cap 3 and 7) and under it (40): the same buckets, and
    each row's bucket and slot (-1 where dropped)."""
    rng = np.random.default_rng(cap)
    T = 50
    x = rng.standard_normal((T, 3)).astype(np.float32)
    dest = rng.integers(-1, 4, T).astype(np.int32)
    ref = ref_moe._fill_buckets(jnp.asarray(x), jnp.asarray(dest), 4, cap)
    port = moe._fill_buckets(torch.from_numpy(x),
                             torch.from_numpy(dest).long(), 4, cap)
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    n_dropped, n_invalid = int((port[1] < 0).sum()), int((dest < 0).sum())
    if cap == 40:
        assert n_dropped == n_invalid
    else:   # overflow drops rows too
        assert n_dropped > n_invalid
    ids = ref_moe._fill_buckets(jnp.asarray(dest[:, None]), jnp.asarray(dest),
                                4, cap, fill_value=-1)[0]
    np.testing.assert_array_equal(
        moe._fill_buckets(torch.from_numpy(dest[:, None]).long(),
                          torch.from_numpy(dest).long(), 4, cap,
                          fill_value=-1)[0].numpy(), np.asarray(ids))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ffn_matches(dtype):
    """Per-expert SwiGLU over (E, C, d) rows against the fp32 masters:
    bf16 rows are promoted to fp32 for the products in both packages."""
    cfg = reduced_config("dbrx-132b")
    ref_p, port_p = _experts(cfg)
    xe = np.random.default_rng(2).standard_normal(
        (cfg.n_experts, 6, cfg.d_model)).astype(np.float32)
    jdt, tdt = _dtypes(dtype)
    r = ref_moe._grouped_ffn(jnp.asarray(xe, jdt), ref_p["w1"], ref_p["w3"],
                             ref_p["w2"])
    p = moe._grouped_ffn(torch.from_numpy(xe).to(tdt), port_p.w1, port_p.w3,
                         port_p.w2)
    assert p.dtype == torch.float32 and r.dtype == jnp.float32
    _close(p, r, F32_REL if dtype == "float32" else BF16_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("name", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_moe_ffn_matches(name, mode, dtype):
    """``moe_ffn`` on (2, 16, d) tokens: the capacity path (prefill, the
    default factor 1.25) and the dropless decode path."""
    cfg = reduced_config(name)
    ref_p, port_p = _experts(cfg, seed=3)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    jdt, tdt = _dtypes(dtype)
    r = ref_moe_ffn(jnp.asarray(x, jdt), ref_p, _dims(cfg), mode)
    p = moe.moe_ffn(torch.from_numpy(x).to(tdt), port_p, _dims(cfg),
                    mode=mode)
    assert p.dtype == tdt and p.shape == x.shape
    _close(p, r, F32_REL if dtype == "float32" else BF16_REL)


def _skewed(cfg, seed):
    """Tokens and a router that sends most tokens to expert 0, so the
    capacity drops rows."""
    ref_p, port_p = _experts(cfg, seed)
    router = np.array(ref_p["router"])
    router[:, 0] += 0.05
    ref_p = {**ref_p, "router": jnp.asarray(router)}
    port_p.router.data = torch.from_numpy(router)
    x = np.random.default_rng(seed).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    return ref_p, port_p, x


@pytest.mark.parametrize("cf", [1.0, 1.25])
def test_capacity_drops_match_reference(cf):
    """The capacity path's bucketing, as the reference's ``_moe_a2a``
    makes it with one shard (its lines 118-131 composed from its own
    ``_route`` and ``_fill_buckets``): the same shard slots, expert
    buckets and slots, so the same rows dropped (some, at factor 1.0),
    and the same output."""
    cfg = dataclasses.replace(reduced_config("dbrx-132b"),
                              capacity_factor=cf)
    ref_p, port_p, x = _skewed(cfg, seed=4)
    dims = _dims(cfg)
    E, k = cfg.n_experts, cfg.moe_top_k
    xt = x.reshape(-1, cfg.d_model)
    ids_r, _ = ref_moe._route(jnp.asarray(xt), ref_p["router"], dims)
    flat_e = ids_r.reshape(-1)
    cap_s = int((xt.shape[0] * k // 1) * cf) + 1
    zero = jnp.zeros_like(flat_e)
    _, _, rs_r = ref_moe._fill_buckets(flat_e[:, None], zero, 1, cap_s)
    be, _, _ = ref_moe._fill_buckets(flat_e[:, None], zero, 1, cap_s,
                                     fill_value=-1)
    re = be.reshape(-1)
    cap_e_r = int(re.shape[0] // E * cf) + 1
    _, eb_r, es_r = ref_moe._fill_buckets(re[:, None], re, E, cap_e_r)

    ids_p, _ = moe._route(torch.from_numpy(xt), port_p.router, dims)
    np.testing.assert_array_equal(ids_p.numpy(), np.asarray(ids_r))
    cap_e, rs, slot_e, eb, es = moe._dispatch(ids_p, dims)
    assert cap_e == cap_e_r
    for got, want in ((rs, rs_r), (slot_e, re), (eb, eb_r), (es, es_r)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dropped = (rs < 0) | (eb[rs.clamp(min=0)] < 0)
    dropped_r = (np.asarray(rs_r) < 0) | \
        (np.asarray(eb_r)[np.maximum(np.asarray(rs_r), 0)] < 0)
    np.testing.assert_array_equal(dropped.numpy(), dropped_r)
    if cf == 1.0:
        assert dropped.sum() > 0
    r = ref_moe_ffn(jnp.asarray(x), ref_p, dims, "prefill")
    _close(moe.moe_ffn(torch.from_numpy(x), port_p, dims, mode="prefill"),
           r, F32_REL)


def test_dropless_factor_matches_decode():
    """At capacity factor E / k the capacity path drops nothing, so it
    computes the dropless decode path's function (fp32, within 1e-5)."""
    cfg = reduced_config("dbrx-132b")
    _, port_p, x = _skewed(cfg, seed=5)
    xt = torch.from_numpy(x)
    dims = _dims(dropless(cfg))
    _close(moe.moe_ffn(xt, port_p, dims, mode="prefill"),
           moe.moe_ffn(xt, port_p, dims, mode="decode"), F32_REL)
    ids, _ = moe._route(xt.reshape(-1, cfg.d_model), port_p.router, dims)
    _, rs, _, eb, _ = moe._dispatch(ids, dims)
    assert bool((rs >= 0).all()) and bool((eb[rs] >= 0).all())
