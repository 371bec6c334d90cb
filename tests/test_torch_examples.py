"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``) on the CPU.

* quickstart, filtered_search and stall_analysis: each pair of scripts
  runs in subprocesses (``PYTHONPATH=src``) and prints the same lines,
  filtered_search's ms/q column masked (host numpy on both sides, so the
  ids, recalls and stall tables are the same bits).
* rag_serve (reduced SmolLM, 256 documents, 8 queries) with the
  reference's weights (``interop.params_from_reference``): embeddings at
  cosine >= 0.9995 to the reference's (run with ``ShardEnv(None)``: its
  own script's (1, 1) ``Explicit`` mesh fails under jax 0.9), and the
  port's answers exactly the reference service's for the port's
  embeddings.
* train_lm (reduced SmolLM) with the reference's weights: each logged
  loss within ``test_torch_train.CROSS_LOSS_TOL`` of the reference
  ``TrainLoop``'s on the same batches; a second run resumes.
* Both LM scripts ask for CUDA unless told otherwise, and no script
  imports jax or the reference package.
"""
import ast
import importlib.util
import os
import re
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import CROSS_LOSS_TOL

import repro.optim.adamw as ref_opt
from repro.configs import reduced_config as ref_reduced_config
from repro.core.search import SearchParams as RefParams
from repro.core.types import Dataset as RefDataset
from repro.core.types import FilterPredicate as RefPredicate
from repro.data.tokens import TokenPipeline as RefTokenPipeline
from repro.models import transformer as ref_tf
from repro.serve.retrieval import RetrievalService as RefService
from repro.train import loop as ref_loop
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
HOST = ("quickstart", "filtered_search", "stall_analysis")
LM = ("rag_serve", "train_lm")
COS = 0.9995                 # test_torch_rag.py's (bf16 encode)
RAG_DOCS, RAG_QUERIES = 256, 8
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 11, 2, 32   # logs steps 0, 5, 10
MS_PER_Q = re.compile(r"\s+\d+\.\d\d$")   # filtered_search's last column


def load(name: str):
    """``examples/torch_<name>.py`` as a module (its ``main`` not run)."""
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def keep_signals():
    """The training scripts install SIGTERM/SIGUSR1 handlers: put the
    test process's own back afterwards."""
    sigs = (signal.SIGTERM, signal.SIGUSR1)
    saved = [signal.getsignal(s) for s in sigs]
    yield
    for s, h in zip(sigs, saved):
        signal.signal(s, h)


@pytest.mark.parametrize("name", HOST)
def test_host_example_prints_the_reference_lines(name):
    """The reference script and the port's, run side by side, print the
    same lines (filtered_search's ms/q masked) and exit 0."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, os.path.join("examples", f)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for f in (f"{name}.py", f"torch_{name}.py")]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append([MS_PER_Q.sub(" <ms>", line)
                     for line in out.splitlines()])
    want, got = outs
    assert len(want) > 3
    assert got == want


@pytest.fixture(scope="module")
def rag():
    """The port's rag_serve body on the reference's weights, with the
    inputs the script draws."""
    mod = load("rag_serve")
    cfg = reduced_config("smollm-135m")
    ref = ref_tf.init_params(ref_reduced_config("smollm-135m"),
                             jax.random.PRNGKey(0))
    port = params_from_reference(ref, cfg, device="cpu")
    doc_tokens, q_tokens, meta, pred = mod.inputs(cfg, RAG_DOCS, RAG_QUERIES)
    out = mod.run(cfg, port, doc_tokens, q_tokens, meta, pred, "cpu")
    return cfg, ref, doc_tokens, q_tokens, meta, out


def test_rag_serve_embeddings_match_reference(rag):
    """Documents and queries encoded by the port's script at cosine >=
    COS to the reference's encoder on the same weights."""
    cfg, ref, doc_tokens, q_tokens, _, out = rag
    env = ref_tf.ShardEnv(None)
    for toks, got in ((doc_tokens, out["vectors"]),
                      (q_tokens, out["query_vectors"])):
        want = np.asarray(ref_tf.encode(ref, {"tokens": jnp.asarray(toks)},
                                        cfg, env))
        assert got.shape == want.shape and got.dtype == np.float32
        assert float((want * got).sum(axis=1).min()) >= COS


def test_rag_serve_answers_are_the_reference_service(rag):
    """On the port's embeddings the reference's service (same build
    arguments) returns exactly the script's ids: ``retrieve_batch``'s,
    and ``retrieve``'s one query at a time; every id passes the
    predicate."""
    cfg, _, _, _, meta, out = rag
    names = [f"f{i}" for i in range(meta.shape[1])]
    svc = RefService.build(RefDataset(out["vectors"], meta, names,
                                      [8] * meta.shape[1]),
                           graph_k=24, r_max=64, params=RefParams(k=10))
    pred = RefPredicate.make({0: [2, 3], 3: [1, 4, 5]})
    ids, _ = svc.query_batch(out["query_vectors"], [pred] * RAG_QUERIES)
    assert len(ids) == len(out["ids"]) == RAG_QUERIES
    passes = pred.mask(meta)
    for a, b in zip(ids, out["ids"]):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert passes[np.asarray(b)].all()
    for i, (v, (got, _, _)) in enumerate(zip(out["query_vectors"],
                                             out["sequential"])):
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(svc.query(v, pred,
                                                           seed=i)[0]))
    assert 0.0 <= out["recall_batch"] <= 1.0


def test_rag_serve_prints_the_reference_lines(capsys):
    """``main`` on the CPU prints the reference's four lines."""
    load("rag_serve").main(["--device", "cpu", "--docs", "64", "--queries",
                            "4"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4
    assert re.fullmatch(r"indexed 64 model-encoded docs in \d+\.\ds",
                        lines[0])
    assert re.fullmatch(r"served 4 filtered queries \(selectivity \d+\.\d%\) "
                        r"in \d+ ms \(\d+\.\d ms/q incl\. encode\)", lines[1])
    assert re.fullmatch(r"recall@10 vs exact filtered search: \d\.\d{3}",
                        lines[2])
    assert re.fullmatch(r"batched \(device-resident atlas\): \d+ ms "
                        r"\(\d+\.\d ms/q incl\. encode\), recall@10 "
                        r"\d\.\d{3}, mean restarts \d+\.\d\d", lines[3])


def test_train_lm_losses_match_reference(tmp_path, capsys, keep_signals):
    """The script's training body on the reference's weights logs the
    reference ``TrainLoop``'s steps (same optimizer, schedule, batches
    and checkpoint cadence) with each loss within CROSS_LOSS_TOL, and
    prints the reference's parameter count."""
    mod = load("train_lm")
    cfg, ref_cfg = reduced_config("smollm-135m"), \
        ref_reduced_config("smollm-135m")
    ref = ref_tf.init_params(ref_cfg, jax.random.PRNGKey(0))
    port = params_from_reference(ref, cfg, device="cpu")
    out = mod.train(cfg, port, name="smollm-135m (reduced)",
                    steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    ckpt_dir=str(tmp_path / "port"), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    n_ref = sum(p.size for p in jax.tree.leaves(ref))
    assert lines[0] == f"smollm-135m (reduced): {n_ref/1e6:.1f}M params"
    assert lines[-1] == (f"done at step {TRAIN_STEPS}; stragglers "
                         f"flagged: {len(out['stragglers'])}")

    step = jax.jit(ref_opt.make_train_step(
        ref_cfg, ref_tf.ShardEnv(None), ref_opt.AdamWConfig(
            peak_lr=3e-3, warmup_steps=20, total_steps=TRAIN_STEPS)))
    pipe = RefTokenPipeline(vocab_size=ref_cfg.vocab_size, batch=TRAIN_BATCH,
                            seq_len=TRAIN_SEQ, seed=0)
    want = ref_loop.TrainLoop(ref_loop.LoopConfig(
        total_steps=TRAIN_STEPS, ckpt_every=25,
        ckpt_dir=str(tmp_path / "ref"), log_every=5), step, pipe, ref,
        ref_opt.init_opt_state(ref)).run()
    got = {m["step"]: m["loss"] for m in out["metrics"]}
    ref_losses = {m["step"]: m["loss"] for m in want["metrics"]}
    assert sorted(got) == sorted(ref_losses) == [0, 5, 10]
    for s in got:
        assert abs(got[s] - ref_losses[s]) <= CROSS_LOSS_TOL, (s, got,
                                                               ref_losses)


def test_train_lm_resumes(tmp_path, capsys, keep_signals):
    """A second run on the same ``--ckpt-dir`` resumes from the newest
    checkpoint (step 25), ends at the same last step, and logs step 25's
    loss as the first run did."""
    mod = load("train_lm")
    args = ["--device", "cpu", "--steps", "30", "--batch", "2", "--seq",
            "16", "--ckpt-dir", str(tmp_path)]
    first = mod.main(args)
    second = mod.main(args)
    lines = capsys.readouterr().out.splitlines()
    assert first["start"] == 0 and second["start"] == 25
    assert first["last_step"] == second["last_step"] == 30
    assert "resumed from step 25" in lines
    a = {m["step"]: m["loss"] for m in first["metrics"]}
    b = {m["step"]: m["loss"] for m in second["metrics"]}
    assert sorted(b) == [25]
    assert abs(a[25] - b[25]) <= 1e-4 * abs(a[25])
    assert a[25] < a[0]


@pytest.mark.parametrize("name", LM)
def test_lm_examples_default_to_cuda(name, monkeypatch, tmp_path,
                                     keep_signals):
    """With no ``--device`` the LM scripts ask for CUDA and raise where
    there is none; they never run on the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (["--docs", "16", "--queries", "2"] if name == "rag_serve"
            else ["--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load(name).main(args)


@pytest.mark.parametrize("name", HOST + LM)
def test_example_imports_neither_jax_nor_reference(name):
    """Each port script sits beside its reference and imports no jax and
    nothing of the reference package (the AST's imports)."""
    assert os.path.exists(os.path.join(EXAMPLES, f"{name}.py"))
    with open(os.path.join(EXAMPLES, f"torch_{name}.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    tops = {m.split(".")[0] for m in mods}
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "repro"}, tops
