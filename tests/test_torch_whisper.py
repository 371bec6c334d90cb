"""The port's audio family (whisper: the encoder, cross-attention, the
audio decode cache) held to the reference on the CPU at reduced
whisper-small, with the same weights (``interop.params_from_reference``,
its ``enc_layers`` sliced per layer) and numpy-seeded frames and tokens.
The reference runs with ``ShardEnv(None)``.

Tolerances, measured on these inputs and stated per test:
* fp32 compute (``CDT`` set to float32 in both packages): logits,
  encoder states and caches within 1e-5 (``F32_ATOL``; measured ≤ 3.2e-6);
  the loss within 1e-5 and each gradient leaf within 1e-4 of its largest
  magnitude;
* bf16 compute: logits within 2e-2 (``BF16_ATOL``, as
  ``test_torch_lm.py``; measured ≤ 1.04e-2), encoder states, caches and
  embeddings within 3e-2 of their largest magnitude (measured ≤ 1.28e-2:
  a bf16 ulp or two at that size).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as ref_attn
import repro.models.common as ref_common
import repro.models.transformer as ref_tf
from repro_torch import interop
from repro_torch.configs import ShapeSpec, reduced_config
from repro_torch.models import common, kvcache
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw

ENV_R, ENV = ref_tf.ShardEnv(None), tf.ShardEnv(None)
F32_ATOL, BF16_ATOL, BF16_REL = 1e-5, 2e-2, 3e-2
GRAD_F32 = 1e-4
B, S_ENC, S_DEC = 2, 48, 12


@pytest.fixture
def fp32(monkeypatch):
    """Both packages compute in fp32 (their ``CDT`` patched)."""
    monkeypatch.setattr(ref_common, "CDT", jnp.float32)
    monkeypatch.setattr(ref_tf, "CDT", jnp.float32)
    monkeypatch.setattr(common, "CDT", torch.float32)
    monkeypatch.setattr(tf, "CDT", torch.float32)


@pytest.fixture(params=["float32", "bfloat16"])
def dtype(request):
    if request.param == "float32":
        request.getfixturevalue("fp32")
    return request.param


@functools.lru_cache(maxsize=None)
def _pair():
    cfg = reduced_config("whisper-small")
    ref = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, ref, interop.params_from_reference(ref, cfg, device="cpu")


def _inputs(s_enc=S_ENC, s_dec=S_DEC, seed=0):
    cfg = reduced_config("whisper-small")
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal(
                (B, s_enc, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (B, s_dec)).astype(np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, rel=False):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    real = w > -1e29          # pad-vocab logits are -1e30 in both
    assert np.array_equal(real, g > -1e29)
    err = float(np.abs(g - w)[real].max())
    if dtype == "float32":
        tol = F32_ATOL
    else:
        tol = BF16_REL * float(np.abs(w[real]).max()) if rel else BF16_ATOL
    assert err <= tol, f"{err} > {tol}"


def test_init_params_leaves():
    """``init_params`` draws the reference's leaves: decoder layers with
    ``ln_cross`` and ``cross``, ``enc_layers`` without them, and
    ``enc_final_norm``; same names and shapes (through
    ``interop.tree_to_reference``), fp32; and ``params_from_reference``
    gives the port's layout back."""
    cfg, ref, port = _pair()
    mine = tf.init_params(cfg, 0, device="cpu")
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    for p in (mine, port):
        flat = interop.tree_to_reference(p)
        got = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
               for path, leaf in jax.tree_util.tree_flatten_with_path(flat)[0]}
        assert got == want
    assert "layers/cross/wq" in want and "layers/ln_cross" in want
    assert "enc_layers/attn/wq" in want and "enc_layers/cross/wq" not in want
    assert len(mine.enc_layers) == cfg.n_enc_layers
    assert all(x.dtype == torch.float32 for x in mine.parameters())
    ref_back = interop.tree_to_reference(port)
    np.testing.assert_array_equal(ref_back["enc_layers"]["attn"]["wq"],
                                  np.asarray(ref["enc_layers"]["attn"]["wq"]))


def test_whisper_encode_matches(dtype):
    """The encoder (non-causal, RoPE, no window) over numpy frames."""
    cfg, ref, port = _pair()
    x = _inputs()["frames"]
    want = ref_tf._whisper_encode(ref, jnp.asarray(x), cfg, ENV_R)
    got = tf._whisper_encode(port, x, cfg, ENV)
    _close(got, want, dtype, rel=True)


def test_encoder_takes_whisper_frame_count(fp32, monkeypatch):
    """1,500 frames (Whisper's 30-s window): the reference's chunks (512,
    1,024) do not divide it and it asserts; the port takes chunks of 500
    and 750. Held to the reference run with those chunks."""
    cfg, ref, port = _pair()
    x = np.random.default_rng(3).standard_normal(
        (1, 1500, cfg.d_model)).astype(np.float32)
    with pytest.raises(AssertionError):
        ref_tf._whisper_encode(ref, jnp.asarray(x), cfg, ENV_R)
    assert (tf._chunk(1500, 512), tf._chunk(1500, 1024)) == (500, 750)
    monkeypatch.setattr(ref_attn, "chunked_attention", functools.partial(
        ref_attn.chunked_attention, q_chunk=500, kv_chunk=750))
    want = ref_tf._whisper_encode(ref, jnp.asarray(x), cfg, ENV_R)
    got = tf._whisper_encode(port, x, cfg, ENV)
    _close(got, want, "float32")


def test_prefill_matches(dtype):
    """``prefill`` of frames + a decoder prompt: the last logits and the
    cache, self K/V padded to ``max_decode_len`` (the reference's layout
    and the port's default) and the cross K/V over the encoder."""
    cfg, ref, port = _pair()
    batch = _inputs()
    lr, cr = ref_tf.prefill(ref, _j(batch), cfg, ENV_R)
    lp, cp = tf.prefill(port, batch, cfg, ENV)
    _close(lp, lr, dtype)
    assert cp["pos"] == int(cr["pos"]) == S_DEC
    specs = kvcache.cache_specs(cfg, ShapeSpec("p", S_ENC, B, "prefill"))
    for name in ("k", "v", "ck", "cv"):
        assert tuple(cp[name].shape) == tuple(cr[name].shape) \
            == specs[name][0]
        _close(cp[name], cr[name], dtype, rel=True)
    assert cp["k"].shape[2] == cfg.max_decode_len
    assert not cp["k"][:, :, S_DEC:].any()


def test_decode_matches_reference_and_prefill(fp32):
    """fp32: four ``decode_step``s after the prefill give the reference's
    logits (its padded cache leaves room, so its last-slot overwrite
    does not arise) and the port's own prefill over the longer
    sequence."""
    cfg, ref, port = _pair()
    batch = _inputs(s_dec=S_DEC + 4)
    head = {"frames": batch["frames"], "tokens": batch["tokens"][:, :S_DEC]}
    _, cr = ref_tf.prefill(ref, _j(head), cfg, ENV_R)
    _, cp = tf.prefill(port, head, cfg, ENV)
    for t in range(S_DEC, S_DEC + 4):
        tok = batch["tokens"][:, t:t + 1]
        lr, cr = ref_tf.decode_step(ref, cr, {"tokens": jnp.asarray(tok)},
                                    cfg, ENV_R)
        lp, cp = tf.decode_step(port, cp, {"tokens": tok}, cfg, ENV)
        _close(lp, lr, "float32")
        longer = {"frames": batch["frames"],
                  "tokens": batch["tokens"][:, :t + 1]}
        _close(lp, tf.prefill(port, longer, cfg, ENV)[0], "float32")
    assert cp["pos"] == S_DEC + 4


def test_encode_audio_matches(dtype):
    """``encode`` on the audio arch runs the decoder stack over tokens
    alone (no frames, no cross-attention), as the reference does."""
    cfg, ref, port = _pair()
    toks = _inputs()["tokens"]
    want = ref_tf.encode(ref, {"tokens": jnp.asarray(toks)}, cfg, ENV_R)
    got = tf.encode(port, {"tokens": toks}, cfg, ENV)
    _close(got, want, dtype, rel=True)


def test_forward_loss_and_grads_match(fp32):
    """fp32: ``forward_loss`` (``_whisper_loss``: frames, decoder tokens
    and labels from ``TokenPipeline(frontend="frame")``) and every
    gradient leaf, the encoder's included, as the reference's
    ``value_and_grad``."""
    from repro_torch.data.tokens import TokenPipeline
    cfg, ref, port = _pair()
    batch = TokenPipeline(cfg.vocab_size, B, 64, seed=0, frontend="frame",
                          d_model=cfg.d_model).get_batch(0)
    lr, gr = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tf.forward_loss(p, b, cfg, ENV_R)))(ref, _j(batch))
    lp, gp = adamw.value_and_grad(
        lambda p: tf.forward_loss(p, batch, cfg, ENV), port)
    assert abs(float(lp) - float(lr)) <= F32_ATOL
    got = interop.tree_to_reference(gp)
    flat_r = dict(jax.tree_util.tree_flatten_with_path(gr)[0])
    flat_p = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_r.keys() == flat_p.keys()
    for k in flat_r:
        w, g = np.asarray(flat_r[k]), np.asarray(flat_p[k])
        assert np.abs(g - w).max() <= GRAD_F32 * np.abs(w).max(), k
    assert any("enc_layers" in str(k) for k in flat_r)


def test_prefill_refuses_a_short_cache():
    cfg, _, port = _pair()
    with pytest.raises(ValueError, match="shorter than the prompt"):
        tf.prefill(port, _inputs(), cfg, ENV, cache_len=S_DEC - 1)
