"""Kernel/plain-version parity gate: fixed probes through ``ops`` on a
device, each held against its plain PyTorch version (``kernels/ref.py``).

On CUDA every probe launches the hand-written kernel and compares it with
the plain version on the same card; on the CPU ``ops`` routes to the plain
versions themselves, so the gate checks the probes' own plumbing (and the
expression-tree checks still hold the bitmaps to ``FilterExpr.mask``).

The probes are those of the reference benchmark script's gate
(``benchmarks/run.py``): n=800 rows, d=64, Q=6 queries, R=24 neighbours, a
conjunctive batch, a DNF batch and an interval batch over a 10^6-code
field, all drawn with numpy from seed 0 in the same order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device_atlas import (pack_dnf, pack_predicates,
                                           resolve_device, words_to_torch)
from repro_torch.core.predicate import (And, FilterExpr, In, Not, Or, Range,
                                        compile_to_dnf)
from repro_torch.core.types import FilterPredicate
from repro_torch.kernels import ops, ref


def _expr_bits(words: torch.Tensor, n: int) -> np.ndarray:
    """(W,) int32 words -> (n,) bool."""
    return np.unpackbits(words.cpu().numpy().view(np.uint8),
                         bitorder="little")[:n].astype(bool)


def kernel_oracle_parity(device) -> list[str]:
    """Run every probe through ``ops`` on ``device`` and hold it against
    the plain version (sims at rtol=atol=1e-4, bitmaps bit-exact) and,
    for the DNF and interval batches, the expression-tree oracle. Returns
    the mismatch descriptions (empty = all good)."""
    dev = resolve_device(device)

    def t(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device=dev, dtype=dtype)

    rng = np.random.default_rng(0)
    n, d, q_n, r = 800, 64, 6, 24
    corpus = t(rng.standard_normal((n, d)), torch.float32)
    queries = t(rng.standard_normal((q_n, d)), torch.float32)
    bitmap = words_to_torch(
        rng.integers(0, 2**32, (q_n, (n + 31) // 32), dtype=np.uint32), dev)
    ids = t(rng.integers(-1, n, (q_n, r)), torch.int32)
    meta_np = rng.integers(-1, 40, (n, 6)).astype(np.int32)
    meta = t(meta_np)
    preds = [FilterPredicate.make({0: [3, 4], 2: [1]}),
             FilterPredicate.make({1: list(range(10))}),
             FilterPredicate.make({})] * 2
    f_np, a_np = pack_predicates(preds, v_cap=64)
    fields_b, allowed_b = t(f_np), words_to_torch(a_np, dev)
    fields1 = t(np.asarray([0, 5, -1, -1], np.int32))
    allowed1 = t(rng.integers(0, 2, (4, 256)).astype(np.uint8))

    fails: list[str] = []

    def chk(name, got, want, exact=False):
        got, want = got.cpu(), want.cpu()
        ok = (torch.equal(got, want) if exact
              else torch.allclose(got, want, rtol=1e-4, atol=1e-4))
        if not ok:
            fails.append(f"{name}: kernel != plain version")

    s_k, _ = ops.masked_cosine_topk(queries, corpus, bitmap, 16)
    s_r, _ = ref.masked_cosine_topk(queries, corpus, bitmap, 16)
    chk("masked_cosine_topk", s_k, s_r)
    chk("fiber_expand", ops.fiber_expand(queries, corpus, ids, bitmap),
        ref.fiber_expand(queries, corpus, ids, bitmap))
    wk = ops.fiber_expand_walk(queries, corpus, ids, bitmap)
    wr = ref.fiber_expand_walk(queries, corpus, ids, bitmap)
    chk("fiber_expand_walk/sims", wk[0], wr[0])
    chk("fiber_expand_walk/sims_pass", wk[1], wr[1])
    chk("filter_eval", ops.filter_eval(meta, fields1, allowed1),
        ref.filter_eval(meta, fields1, allowed1), exact=True)
    chk("filter_eval_batch", ops.filter_eval_batch(meta, fields_b, allowed_b),
        ref.filter_eval_batch(meta, fields_b, allowed_b), exact=True)

    # disjunction path: DNF clause tables through the in-kernel disjunct
    # union vs the plain version vs the expression tree
    vocab = [40] * 6
    exprs = [Or(In(0, [3, 4]), In(2, [1])),
             Not(In(1, list(range(10)))),
             And(In(0, [3, 4]), Or(In(2, [1]), In(5, [2]))),
             Or(Range(3, 5, 20), And(In(0, [1, 2]), Not(In(4, [0])))),
             FilterExpr.never(), FilterExpr.always()]
    dnfs = [compile_to_dnf(e, vocab) for e in exprs]
    # the Range leaf keeps this batch on the bounds-table path
    f_d, a_d, b_d, nd = pack_dnf(dnfs, v_cap=64)
    tabs = (t(f_d), words_to_torch(a_d, dev))
    out_dk = ops.filter_eval_batch(meta, *tabs, t(nd), t(b_d))
    chk("filter_eval_batch/dnf", out_dk,
        ref.filter_eval_batch(meta, *tabs, bounds=t(b_d)), exact=True)
    for qi, e in enumerate(exprs):
        if not np.array_equal(_expr_bits(out_dk[qi], n),
                              e.mask(meta_np, vocab)):
            fails.append(f"filter_eval_batch/dnf expr {qi}: "
                         f"kernel != expression-tree oracle")

    # interval path: Range clauses over a vocab far beyond v_cap stay
    # symbolic (f, lo, hi) bounds — kernel vs plain version vs the tree
    big_vocab = [40] * 5 + [1_000_000]
    meta_iv_np = meta_np.copy()
    meta_iv_np[:, 5] = rng.integers(-1, big_vocab[5], n)
    meta_iv = t(meta_iv_np)
    iv_exprs = [Range(5, 100_000, 600_000),
                Not(Range(5, 250_000, None)),
                And(In(0, [3, 4]), Range(5, None, 900_000)),
                Or(Range(5, 0, 10_000), In(2, [1])),
                Range(5, 700_000, 10)]  # empty window -> never
    iv_dnfs = [compile_to_dnf(e, big_vocab, v_cap=64) for e in iv_exprs]
    f_i, a_i, b_i, nd_i = pack_dnf(iv_dnfs, v_cap=64)
    tabs = (t(f_i), words_to_torch(a_i, dev))
    out_ik = ops.filter_eval_batch(meta_iv, *tabs, t(nd_i), t(b_i))
    chk("filter_eval_batch/interval", out_ik,
        ref.filter_eval_batch(meta_iv, *tabs, bounds=t(b_i)), exact=True)
    for qi, e in enumerate(iv_exprs):
        if not np.array_equal(_expr_bits(out_ik[qi], n),
                              e.mask(meta_iv_np, big_vocab)):
            fails.append(f"filter_eval_batch/interval expr {qi}: "
                         f"kernel != expression-tree oracle")
    return fails


def parity_gate(device) -> None:
    """``kernel_oracle_parity`` that raises on any mismatch."""
    fails = kernel_oracle_parity(device)
    if fails:
        raise RuntimeError("kernel parity gate failed: " + "; ".join(fails))
