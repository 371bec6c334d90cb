"""The port's RAG bridge and generation on the CPU: ``TokenPipeline``,
``EncodedRetriever`` (the LM encoder feeding ``RetrievalService``),
``ServeEngine.generate`` and the ``launch/serve.py`` CLI, held to the
reference (run with ``ShardEnv(None)``; its MoE on the (1, 1) ``Auto``
mesh) with the same weights (``interop.params_from_reference``) at
reduced SmolLM, and for the moe, hybrid and ssm families at reduced
dbrx, hymba and rwkv6.

Tolerances: embeddings at cosine ≥ 0.9995 (bf16 encode; measured
≥ 0.99987); ids exact where both packages search the same vectors, and
mean id-set overlap ≥ 0.98 where each searches its own encoder's vectors
(a near-tie can swap a result)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_moe import auto_mesh, dropless

import repro.models.common as ref_common
from repro.configs import reduced_config as ref_reduced_config
from repro.core.search import SearchParams as RefParams
from repro.core.types import Dataset as RefDataset
from repro.core.types import FilterPredicate as RefPredicate
from repro.data.tokens import TokenPipeline as RefTokenPipeline
from repro.models import transformer as ref_tf
from repro.serve.retrieval import EncodedRetriever as RefRetriever
from repro.serve.retrieval import RetrievalService as RefService
from repro_torch.configs import reduced_config
from repro_torch.core.search import SearchParams
from repro_torch.core.types import Dataset, FilterPredicate
from repro_torch.data.tokens import TokenPipeline
from repro_torch.interop import params_from_reference
from repro_torch.launch import serve as serve_cli
from repro_torch.models import common
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.retrieval import EncodedRetriever, RetrievalService

COS = 0.9995
OVERLAP = 0.98
GAP = 2e-2   # bf16 logit tolerance (test_torch_lm.py)
N_DOCS, DOC_LEN = 384, 12
PREDS = ({0: [1, 2]}, {1: [0], 2: [1, 3]}, {2: [2]}, {})


@pytest.fixture(scope="module")
def lm():
    cfg = reduced_config("smollm-135m")
    ref = ref_tf.init_params(ref_reduced_config("smollm-135m"),
                             jax.random.PRNGKey(0))
    return cfg, ref, params_from_reference(ref, cfg, device="cpu")


@pytest.fixture(scope="module")
def corpus(lm):
    """Documents encoded once by the reference, served by both packages
    over the same vectors (each builds its own index, bit for bit)."""
    return _corpus(*lm[:2])


@pytest.fixture(scope="module")
def hymba():
    """Reduced hymba (attention + mamba heads, a 32-token window) and a
    corpus its reference encoded."""
    cfg = reduced_config("hymba-1.5b")
    ref = ref_tf.init_params(ref_reduced_config("hymba-1.5b"),
                             jax.random.PRNGKey(0))
    lm = (cfg, ref, params_from_reference(ref, cfg, device="cpu"))
    return lm, _corpus(cfg, ref)


def _corpus(cfg, ref):
    rng = np.random.default_rng(0)
    docs = rng.integers(0, cfg.vocab_size, (N_DOCS, DOC_LEN)).astype(np.int32)
    vecs = np.asarray(ref_tf.encode(ref, {"tokens": jnp.asarray(docs)}, cfg,
                                    ref_tf.ShardEnv(None)))
    meta = rng.integers(0, 4, (N_DOCS, 3)).astype(np.int32)
    names, vocab = [f"f{i}" for i in range(3)], [4, 4, 4]
    ref_svc = RefService.build(RefDataset(vecs, meta, names, vocab),
                               graph_k=8, r_max=24,
                               params=RefParams(k=5, max_hops=50))
    svc = RetrievalService.build(Dataset(vecs, meta, names, vocab),
                                 graph_k=8, r_max=24,
                                 params=SearchParams(k=5, max_hops=50),
                                 device="cpu")
    return docs, vecs, meta, ref_svc, svc


def _retrievers(lm, corpus):
    cfg, ref, port = lm
    return (RefRetriever(cfg, ref_tf.ShardEnv(None), ref, corpus[3]),
            EncodedRetriever(cfg, tf.ShardEnv(None), port, corpus[4]))


def _prompts(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, DOC_LEN)).astype(np.int32)


def _overlap(a_ids, b_ids) -> float:
    return float(np.mean([
        1.0 if a.size == b.size == 0 else
        np.intersect1d(a, b).size / max(a.size, b.size)
        for a, b in zip(a_ids, b_ids)]))


@pytest.mark.parametrize("frontend", ["none", "patch", "frame"])
def test_token_pipeline_bit_identical(frontend):
    kw = dict(vocab_size=500, batch=3, seq_len=40, seed=7, frontend=frontend,
              d_model=16)
    a, b = RefTokenPipeline(**kw), TokenPipeline(**kw)
    for step in (0, 1, 9):
        ra, pb = a.get_batch(step), b.get_batch(step)
        assert ra.keys() == pb.keys()
        for key in ra:
            assert ra[key].dtype == pb[key].dtype
            np.testing.assert_array_equal(ra[key], pb[key])


def test_embed_tokens_matches_reference(lm, corpus):
    """The port's encoder against the reference's on documents and
    prompts: unit fp32 rows at cosine ≥ 0.9995."""
    _check_embed_tokens(lm, corpus)


def _check_embed_tokens(lm, corpus):
    ref_r, port_r = _retrievers(lm, corpus)
    for toks in (corpus[0][:64], _prompts(lm[0], 16)):
        a, b = ref_r.embed_tokens(jnp.asarray(toks)), port_r.embed_tokens(toks)
        assert b.dtype == np.float32 and b.shape == a.shape
        np.testing.assert_allclose(np.linalg.norm(b, axis=1), 1.0, atol=1e-6)
        assert (a * b).sum(axis=1).min() >= COS


def test_retrieve_batch_matches_reference(lm, corpus):
    """``retrieve_batch`` returns exactly what the reference service
    returns for the port's embeddings (same ids in order, same walks),
    and overlaps the reference retriever's own answers by ≥ 0.98; every
    id passes its prompt's predicate. ``retrieve`` (sequential) returns
    the reference's ids for the same embeddings."""
    _check_retrieve(lm, corpus)


def test_hymba_retriever_matches_reference(hymba):
    """The same two checks with reduced hymba as the encoder (attention
    and mamba heads): embeddings at cosine ≥ 0.9995, ``retrieve_batch``
    and ``retrieve`` ids exact on the same embeddings, and an overlap of
    ≥ 0.95 with the reference retriever's own answers (measured 0.975:
    three near-tie swaps in 120 ids)."""
    _check_embed_tokens(*hymba)
    _check_retrieve(*hymba, own_overlap=0.95)


def test_hymba_retriever_fp32_returns_reference_ids(hymba, monkeypatch):
    """With both packages computing in fp32 (``CDT`` patched) the two
    encoders agree to rounding, and ``retrieve_batch`` returns the
    reference retriever's ids exactly."""
    monkeypatch.setattr(ref_common, "CDT", jnp.float32)
    monkeypatch.setattr(ref_tf, "CDT", jnp.float32)
    monkeypatch.setattr(common, "CDT", torch.float32)
    monkeypatch.setattr(tf, "CDT", torch.float32)
    _check_retrieve(*hymba, own_overlap=1.0)


def _check_retrieve(lm, corpus, own_overlap=OVERLAP):
    ref_r, port_r = _retrievers(lm, corpus)
    meta = corpus[2]
    toks = _prompts(lm[0], 24)
    specs = [PREDS[i % len(PREDS)] for i in range(len(toks))]
    ids, stats = port_r.retrieve_batch(toks, [FilterPredicate.make(s)
                                              for s in specs])
    ref_preds = [RefPredicate.make(s) for s in specs]
    vecs = port_r.embed_tokens(toks)
    want, want_stats = corpus[3].query_batch(vecs, ref_preds)
    assert len(ids) == len(want) == len(toks)
    for i, (a, b) in enumerate(zip(ids, want)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"query {i}")
        assert 0 < a.size <= 5
        assert FilterPredicate.make(specs[i]).mask(meta)[a].all()
    np.testing.assert_array_equal(stats["walks"], want_stats["walks"])
    own, _ = ref_r.retrieve_batch(jnp.asarray(toks), ref_preds)
    assert _overlap(ids, [np.asarray(r) for r in own]) >= own_overlap
    pred = FilterPredicate.make(PREDS[0])
    got = port_r.retrieve(toks[:4], pred, seed=3)
    for i, (g_ids, g_sims, _st) in enumerate(got):
        r_ids, r_sims, _ = corpus[3].query(vecs[i], ref_preds[0], seed=3 + i)
        np.testing.assert_array_equal(g_ids, r_ids)
        np.testing.assert_array_equal(g_sims, r_sims)


def _ref_last_logits(cfg, ref, prompt, generated):
    """The reference's last-position logits over the prompt plus each
    prefix of ``generated`` (its ``prefill`` over the whole sequence, no
    decode cache): (B, T, V)."""
    env = ref_tf.ShardEnv(auto_mesh() if cfg.is_moe else None)
    out = []
    for t in range(generated.shape[1]):
        seq = np.concatenate([prompt, generated[:, :t]], axis=1)
        logits, _ = ref_tf.prefill(ref, {"tokens": jnp.asarray(seq)}, cfg,
                                   env)
        out.append(np.asarray(logits[:, -1], np.float32))
    return np.stack(out, axis=1)


def test_generate_greedy_matches_reference(lm):
    """Every greedy token is the reference's choice on the same prefix:
    its argmax, or (a near-tie, which bf16 rounding may flip) a token
    whose reference logit is within the bf16 logit tolerance of the
    maximum; at least 90% are the argmax itself (measured: all 40). Two
    calls give the same tokens."""
    _check_greedy(*lm)


@pytest.mark.parametrize("name", ["dbrx-132b", "hymba-1.5b", "rwkv6-3b"])
def test_generate_family_greedy_matches_reference(name):
    """The same for the moe (dbrx with a dropless capacity factor: its
    decode is dropless), hybrid and ssm families at reduced width."""
    cfg = reduced_config(name)
    if cfg.is_moe:
        cfg = dropless(cfg)
    ref = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
    _check_greedy(cfg, ref, params_from_reference(ref, cfg, device="cpu"))


def _check_greedy(cfg, ref, port):
    prompt = _prompts(cfg, 4, seed=5)
    eng = ServeEngine(cfg, tf.ShardEnv(None), port, device="cpu")
    out = eng.generate(prompt, max_new=10)
    assert out.dtype == torch.int32 and out.shape == (4, 10)
    assert bool((out < cfg.vocab_size).all())
    assert torch.equal(out, eng.generate(prompt, max_new=10))
    toks = out.numpy()
    logits = _ref_last_logits(cfg, ref, prompt, toks)
    chosen = np.take_along_axis(logits, toks[..., None], axis=2)[..., 0]
    assert (chosen >= logits.max(axis=2) - GAP).all()
    assert (toks == logits.argmax(axis=2)).mean() >= 0.9


def test_generate_sampling_is_seeded(lm):
    cfg, _, port = lm
    eng = ServeEngine(cfg, tf.ShardEnv(None), port, device="cpu")
    prompt = _prompts(cfg, 3, seed=6)

    def sample(seed):
        return eng.generate(prompt, max_new=6, temperature=0.8,
                            generator=torch.Generator().manual_seed(seed))

    a = sample(11)
    assert torch.equal(a, sample(11))
    assert not torch.equal(a, sample(12))
    assert bool((a < cfg.vocab_size).all())
    with pytest.raises(ValueError, match="Generator"):
        eng.generate(prompt, max_new=2, temperature=0.8)


def test_entry_points_default_to_cuda(lm, corpus, monkeypatch):
    """With no device named, the LM entry points ask for CUDA and raise
    where there is none; the retriever encodes where its service runs."""
    cfg, _, port = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, tf.ShardEnv(None), port)
    retr = EncodedRetriever(cfg, tf.ShardEnv(None), port, corpus[4])
    assert retr.params.device.type == "cpu"


def test_engine_and_retriever_share_one_module(lm, corpus):
    """An engine and a retriever built over one module leave it where it
    is: on their own device they use it as it is, elsewhere a copy (the
    meta device stands in for a second device here)."""
    cfg, _, port = lm
    env = tf.ShardEnv(None)
    retr = EncodedRetriever(cfg, env, port, corpus[4])
    prompts = _prompts(cfg, 3)
    before = retr.embed_tokens(prompts)
    assert retr.params is port
    assert ServeEngine(cfg, env, port, device="cpu").params is port
    elsewhere = ServeEngine(cfg, env, port, device="meta")
    assert elsewhere.params is not port
    assert all(p.is_meta for p in elsewhere.params.parameters())
    assert all(p.device.type == "cpu" for p in port.parameters())
    assert retr.params is port
    np.testing.assert_array_equal(retr.embed_tokens(prompts), before)


def test_serve_cli_on_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--batch", "2", "--new", "5",
                    "--prompt-len", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("smollm-135m on cpu: generated 2x5 tokens")
    assert "tok/s" in out[0]


@pytest.mark.parametrize("arch", ["dbrx-132b", "hymba-1.5b", "rwkv6-3b"])
def test_serve_cli_families_on_cpu(arch, capsys):
    """The CLI serves the moe, hybrid and ssm archs (reduced) and still
    refuses the frontend archs."""
    serve_cli.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                    "--new", "5", "--prompt-len", "40"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{arch} on cpu: generated 2x5 tokens")
    with pytest.raises(SystemExit, match="frontend"):
        serve_cli.main(["--arch", "whisper-small", "--device", "cpu"])
