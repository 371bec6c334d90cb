"""The port's recurrent heads (``repro_torch.models.mamba``,
``repro_torch.models.rwkv6``) held to the reference's on the same
weights (its own ``init_mamba``/``init_rwkv_layer`` leaves, carried
across as numpy) and the same numpy-seeded inputs and states.

Tolerances, measured on these inputs and stated per test:
* fp32 inputs (every op then fp32 in both packages): outputs and states
  within 1e-5 of their largest magnitude (the same function up to
  summation order; measured ≤ 5.4e-7);
* bf16 inputs (the real dtype): XLA fuses bf16 elementwise chains where
  torch rounds after each op, so outputs within 8e-3 of their largest
  magnitude, two bf16 ulps (measured ≤ 2.3e-3), and the fp32 states
  within 1e-4 (measured ≤ 4.9e-7: the projections feeding them round
  alike here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as ref_mamba
from repro.models import rwkv6 as ref_rwkv
from repro_torch.models import mamba, rwkv6
from repro_torch.models.transformer import Tree

F32_REL = 1e-5
BF16_OUT_REL, BF16_STATE_REL = 8e-3, 1e-4
D, D_IN, N_STATE, DT_RANK = 32, 64, 8, 8       # mamba head
D_RWKV, FF_RWKV, HEAD = 64, 128, 16            # rwkv6 layer


def _port_tree(ref_params) -> Tree:
    return Tree({k: torch.from_numpy(np.array(v, np.float32))
                 for k, v in ref_params.items()})


def _np(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


def _close(got, want, rel, what):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    scale = max(float(np.abs(w).max()), 1e-6)
    err = float(np.abs(g - w).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _inputs(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt), jdt, tdt


def test_init_layouts_match():
    """``init_mamba`` and ``init_rwkv_layer`` give the reference's leaves
    and shapes, with its constants (A_log, dt_bias, D, w0, conv_b,
    ln_x)."""
    gen = torch.Generator().manual_seed(0)
    for ref_fn, fn, args in ((ref_mamba.init_mamba, mamba.init_mamba,
                              (D, D_IN, N_STATE, DT_RANK)),
                             (ref_rwkv.init_rwkv_layer, rwkv6.init_rwkv_layer,
                              (D_RWKV, FF_RWKV, HEAD))):
        ref = ref_fn(jax.random.PRNGKey(0), *args)
        port = fn(gen, *args)
        assert {k: tuple(v.shape) for k, v in ref.items()} == \
            {k: tuple(v.shape) for k, v in port.items()}
        for k, v in port.items():
            assert v.dtype == torch.float32
            if k in ("A_log", "dt_bias", "D", "w0", "conv_b", "ln_x"):
                np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]),
                                           rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 17, 512])
def test_mamba_forward_matches(S, with_state, dtype):
    """``mamba_forward``: the decode fast path (S = 1), one reference
    chunk (17) and two (512, the port's loop crossing its own chunks of
    64), from zeros and from a given (ssm, conv tail) state."""
    ref_p = ref_mamba.init_mamba(jax.random.PRNGKey(S), D, D_IN, N_STATE,
                                 DT_RANK)
    rng = np.random.default_rng(S + with_state)
    xj, xt, jdt, tdt = _inputs(rng, (2, S, D), dtype)
    state_r = state_p = None
    if with_state:
        h0 = 0.5 * rng.standard_normal((2, D_IN, N_STATE)).astype(np.float32)
        tail = rng.standard_normal((2, 3, D_IN)).astype(np.float32)
        state_r = (jnp.asarray(h0), jnp.asarray(tail, jdt))
        state_p = (torch.from_numpy(h0), torch.from_numpy(tail).to(tdt))
    y_r, (h_r, t_r) = ref_mamba.mamba_forward(ref_p, xj, state_r)
    y_p, (h_p, t_p) = mamba.mamba_forward(_port_tree(ref_p), xt, state_p)
    assert y_p.dtype == tdt and h_p.dtype == torch.float32
    assert t_p.dtype == tdt
    f32 = dtype == "float32"
    _close(y_p, y_r, F32_REL if f32 else BF16_OUT_REL, "y")
    _close(h_p, h_r, F32_REL if f32 else BF16_STATE_REL, "ssm state")
    _close(t_p, t_r, F32_REL if f32 else BF16_OUT_REL, "conv tail")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 9, 512])
def test_rwkv_time_mix_matches(S, with_state, dtype):
    """``rwkv_time_mix``: token shift, the LoRA decay, the wkv scan with
    its bonus u (S = 1 is the reference's decode path; S = 512 is two of
    its 256-step chunks), the per-head groupnorm and the
    gate, from zeros and from a given (shift, wkv) state."""
    ref_p = ref_rwkv.init_rwkv_layer(jax.random.PRNGKey(S), D_RWKV, FF_RWKV,
                                     HEAD)
    rng = np.random.default_rng(S + with_state)
    xj, xt, jdt, tdt = _inputs(rng, (2, S, D_RWKV), dtype)
    state_r = state_p = None
    if with_state:
        H = D_RWKV // HEAD
        last = rng.standard_normal((2, D_RWKV)).astype(np.float32)
        s0 = 0.3 * rng.standard_normal((2, H, HEAD, HEAD)).astype(np.float32)
        state_r = (jnp.asarray(last, jdt), jnp.asarray(s0))
        state_p = (torch.from_numpy(last).to(tdt), torch.from_numpy(s0))
    y_r, (l_r, s_r) = ref_rwkv.rwkv_time_mix(ref_p, xj, state_r, HEAD)
    y_p, (l_p, s_p) = rwkv6.rwkv_time_mix(_port_tree(ref_p), xt, state_p,
                                          HEAD)
    assert y_p.dtype == tdt and s_p.dtype == torch.float32
    f32 = dtype == "float32"
    _close(y_p, y_r, F32_REL if f32 else BF16_OUT_REL, "y")
    _close(s_p, s_r, F32_REL if f32 else BF16_STATE_REL, "wkv state")
    np.testing.assert_array_equal(_np(l_p), _np(l_r))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 9])
def test_rwkv_channel_mix_matches(S, with_state, dtype):
    ref_p = ref_rwkv.init_rwkv_layer(jax.random.PRNGKey(7), D_RWKV, FF_RWKV,
                                     HEAD)
    rng = np.random.default_rng(S + 2 * with_state)
    xj, xt, jdt, tdt = _inputs(rng, (2, S, D_RWKV), dtype)
    last = rng.standard_normal((2, D_RWKV)).astype(np.float32)
    state_r = jnp.asarray(last, jdt) if with_state else None
    state_p = torch.from_numpy(last).to(tdt) if with_state else None
    y_r, l_r = ref_rwkv.rwkv_channel_mix(ref_p, xj, state_r)
    y_p, l_p = rwkv6.rwkv_channel_mix(_port_tree(ref_p), xt, state_p)
    assert y_p.dtype == tdt
    _close(y_p, y_r, F32_REL if dtype == "float32" else BF16_OUT_REL, "y")
    np.testing.assert_array_equal(_np(l_p), _np(l_r))
