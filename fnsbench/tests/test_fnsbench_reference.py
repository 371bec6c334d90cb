"""The benchmark's reference and its frozen data recipe, on the CPU."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from fnsbench.data import recipe
from fnsbench.reference import exact, judge
from fnsbench.reference.predicates import (conj, mask_np, mask_torch,
                                           or_pair, prefix_range)

REFERENCE = pathlib.Path(judge.__file__).resolve().parent


def random_meta(rng, n=400, f=5, v=6):
    meta = rng.integers(-1, v, (n, f)).astype(np.int32)
    return meta


def random_preds(rng, f=5, v=6, count=40):
    out = []
    for i in range(count):
        kind = i % 3
        if kind == 0:
            fields = rng.choice(f, rng.integers(1, 4), replace=False)
            out.append(conj({int(x): rng.choice(v, rng.integers(1, 3),
                                                replace=False).tolist()
                             for x in fields}))
        elif kind == 1:
            out.append(or_pair(0, 1, int(rng.integers(v))))
        else:
            out.append(prefix_range(int(rng.integers(f)),
                                    int(rng.integers(v))))
    return out


def passes_loop(pred, row) -> bool:
    for disj in pred:
        ok = True
        for c in disj:
            code = int(row[c[1]])
            if c[0] == "in":
                ok &= code >= 0 and code in c[2]
            else:
                ok &= c[2] <= code <= c[3] and code >= 0
        if ok:
            return True
    return False


def test_predicate_evaluator_matches_a_row_loop():
    rng = np.random.default_rng(0)
    meta = random_meta(rng)
    mt = torch.from_numpy(meta)
    for p in random_preds(rng):
        want = np.array([passes_loop(p, r) for r in meta])
        np.testing.assert_array_equal(mask_np(p, meta), want)
        np.testing.assert_array_equal(mask_torch(p, mt).numpy(), want)


def test_exact_topk_matches_a_brute_force_loop():
    rng = np.random.default_rng(1)
    meta = random_meta(rng, n=300)
    vecs = recipe.normalize(rng.standard_normal((300, 24)))
    qs = recipe.normalize(rng.standard_normal((30, 24)))
    preds = random_preds(rng, count=30)
    got = exact.exact_topk(torch.from_numpy(vecs), torch.from_numpy(meta),
                           qs, preds, 10)
    for q, p, ids in zip(qs, preds, got):
        rows = [i for i in range(300) if passes_loop(p, meta[i])]
        sims = {i: float(np.dot(vecs[i].astype(np.float64), q)) for i in rows}
        want = sorted(rows, key=lambda i: -sims[i])[:10]
        assert list(ids) == want


def test_fiber_sizes_count_passing_rows():
    rng = np.random.default_rng(2)
    meta = random_meta(rng)
    preds = random_preds(rng)
    np.testing.assert_array_equal(
        exact.fiber_sizes(preds, torch.from_numpy(meta)),
        [sum(passes_loop(p, r) for r in meta) for p in preds])


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.randn(10_000)
    r = exact.tf32_round(x)
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    rel = ((r - x).abs() / x.abs()).max().item()
    assert 0 < rel <= 2.0 ** -11


def test_order_gaps():
    sims = np.array([0.9, 0.8, 0.85, 0.5, 0.6, 0.7, 0.3])
    gaps = judge.order_gaps(sims, np.array([3, 3, 1, 0]), 4)
    np.testing.assert_allclose(gaps, [0.05, 0.2, 0.0, 0.0])


def tiny_judge(answers, errors=None, limit=1e-6):
    rng = np.random.default_rng(3)
    meta = rng.integers(0, 3, (200, 2)).astype(np.int32)
    vecs = recipe.normalize(rng.standard_normal((200, 16)))
    qs = recipe.normalize(rng.standard_normal((2, 16)))
    preds = [conj({0: [1]}), conj({1: [2]})]
    truth = exact.exact_topk(torch.from_numpy(vecs), torch.from_numpy(meta),
                             qs, preds, 5)
    answers = [a(truth) if callable(a) else a for a in answers]
    return (judge.judge(torch.from_numpy(vecs), torch.from_numpy(meta), qs,
                        preds, np.array([0, 1]), answers,
                        errors or [None, None], 5, {"order_gap": limit}),
            truth, meta)


def test_judge_passes_the_exact_answer():
    (checks, recall, _), _, _ = tiny_judge([lambda t: t[0], lambda t: t[1]])
    assert judge.verdict(checks) and recall == 1.0


@pytest.mark.parametrize("fault,check", [
    (lambda t, m: (None, t[1]), "unanswered"),
    (lambda t, m: (t[0][:3], t[1]), "short_answers"),
    (lambda t, m: (np.r_[t[0][:4], t[0][0]], t[1]), "bad_ids"),
    (lambda t, m: (np.r_[t[0][:4], np.nonzero(m[:, 0] != 1)[0][0]], t[1]),
     "bad_ids"),
    (lambda t, m: (np.r_[t[0][:4], 10_000], t[1]), "bad_ids"),
    (lambda t, m: (t[0][::-1], t[1]), "order_gap"),
])
def test_judge_catches(fault, check):
    (_, truth, meta) = tiny_judge([lambda t: t[0], lambda t: t[1]])
    answers = list(fault(truth, meta))
    (checks, _, _), _, _ = tiny_judge(answers)
    assert checks[check][0] > checks[check][1]
    assert not judge.verdict(checks)


def test_judge_counts_errors():
    (checks, _, _), _, _ = tiny_judge([lambda t: t[0], lambda t: t[1]],
                                      errors=[None, "DNF too wide"])
    assert checks["errors"][0] == 1 and not judge.verdict(checks)


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module else [])
            for name in names:
                assert name.split(".")[0] not in {
                    "repro_torch", "repro", "jax", "jaxlib", "flax"}, path


# -- the frozen recipe against the port's own -------------------------------

def port_synth():
    return pytest.importorskip("repro_torch.data.synth")


def test_recipe_copy_is_the_ports_bit_for_bit():
    synth = port_synth()
    spec = synth.SynthSpec(n=1500, d=48, n_components=20, n_fields=8, seed=5)
    want = synth.add_timestamp_field(synth.add_or_pair_fields(
        synth.make_dataset(spec)))
    got = recipe.add_timestamp_field(recipe.add_or_pair_fields(
        recipe.make_dataset(n=1500, d=48, n_components=20, n_fields=8,
                            seed=5, noise_scale=1.0)))
    assert got.vectors.dtype == want.vectors.dtype
    np.testing.assert_array_equal(got.vectors, want.vectors)
    np.testing.assert_array_equal(got.metadata, want.metadata)
    assert got.field_names == want.field_names
    assert got.vocab_sizes == want.vocab_sizes


def test_query_copies_are_the_ports():
    synth = port_synth()
    spec = synth.SynthSpec(n=1500, d=48, n_components=20, n_fields=8, seed=6)
    ds = synth.add_timestamp_field(synth.add_or_pair_fields(
        synth.make_dataset(spec)))
    mine = recipe.Corpus(ds.vectors, ds.metadata, ds.field_names,
                         ds.vocab_sizes)
    base = synth.Dataset(ds.vectors, ds.metadata[:, :8], ds.field_names[:8],
                         ds.vocab_sizes[:8])
    pairs = [(synth.make_queries(base, n_queries=60, seed=2),
              recipe.make_queries(mine, n_queries=60, seed=2, n_fields=8)),
             (synth.make_or_queries(ds, 2, 20),
              recipe.make_or_queries(mine, 2, 20)),
             (synth.make_range_queries(ds, 0.1, 20),
              recipe.make_range_queries(mine, 0.1, 20))]
    for want, got in pairs:
        assert len(want) == len(got)
        for w, (v, p) in zip(want, got):
            np.testing.assert_array_equal(w.vector, v)
            np.testing.assert_array_equal(
                w.predicate.mask(ds.metadata, ds.vocab_sizes),
                mask_np(p, ds.metadata))


def test_noise_scale_shrinks_the_spread():
    a = recipe.make_dataset(n=800, d=256, n_components=4, n_fields=0, seed=1)
    b = recipe.make_dataset(n=800, d=256, n_components=4, n_fields=0, seed=1,
                            noise_scale=0.5)
    sim = lambda x: np.sort(x.vectors @ x.vectors[0])[-11:-1].mean()  # noqa
    assert sim(b) > sim(a)
