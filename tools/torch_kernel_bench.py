#!/usr/bin/env python3
"""The five kernels alone on the card: each kernel against its plain
version, then timed beside the plain version and, where there is one, one
PyTorch call for the same function.

    python3 tools/torch_kernel_bench.py [--src DIR] [--reps N] [--check-only]
        [--sweep] [--out PATH]

Needs one CUDA card and ``nvcc``. The data is made on the card from fixed
seeds at the smoke's widths, with no index build: a 105,100 x 2048 corpus
of unit rows; Q=256 unit queries; for K3 a k=32 mask that passes a random
half of the corpus, and k=10 masks that pass one of 324 random clusters
per query at Q=256 and Q=64 (the search path's one-cluster seed masks:
sqrt(n) clusters of ~324 rows); for K2 walk hops at Q=64 and Q=256 with
R=96 neighbour slots of which 41% hold a valid id (the smoke's 10,139 of
24,576) and pass bitmaps that pass 7% of the rows; K5 on the Q=256 hop
(about 700 passing ids, 2.8% of the slots, as the smoke's 696); for K1 a
105,100 x 27 int32 metadata with the smoke's vocabulary sizes (3% of
entries -1) and Q=256 clause tables with v_cap 1024: conjunctive (1-4
clauses over the 24 categorical fields), OR with D = 8 (2-8 live
disjuncts) and range (half the clauses intervals); for K4 one
conjunctive query (3 active clauses of C = 4 over the categorical fields,
v_cap 256) over the same metadata and over 10x its rows (1,051,000 x 27,
113.5 MB, where the bytes and not the launch dominate). Before the timed
cases, ``chip_smoke.ragged_checks`` holds every kernel to its plain
version at ragged shapes (n % 32 != 0, d % 4 != 0, Q below and across
the tiles, K1's tile and group edges, K4 across its words and grid
cap).
Checks are the smoke's: K1 and K4 bit-exact; K2 identical -inf positions
and rtol = atol = 1e-5; K5 identical -inf positions and sims within
1e-4; K3 identical fill, sims within 1e-4, an id that differs from the
plain version's must pass its mask and score its sim, no duplicates.

``--src`` picks the package to load (``src`` of this checkout by default;
point it at another checkout's ``src`` to time that version's kernels in
the same call; the ragged checks run only for a version with K1's
``filter_plan``). Each function is timed in turns (kernel, library,
plain, kernel, library; K1 and K4 have no library call); a time is the
lower of its medians of CUDA-event timed runs with the L2 cache flushed
before each, each run queued behind a spin kernel so that the host's
enqueue time does not count. Prints one JSON line per case, the card's
name and power limit, and exits non-zero on any failed check. K4's bound
counts the bytes its input needs (``chip_smoke.k4_bytes``: the first
active clause's column, later columns only for the rows still passing,
by 32-byte sector), with the whole metadata's bound beside it
(``metadata_bound_ms``). Each record also
gives the wrapper's host time per call while the card is busy
(``host_ms``: a call that waits for the card shows as milliseconds), and
K2's a streaming read (``sum``) of as many contiguous corpus rows as the
call gathers; K1's conjunctive case also times the call with every clause
inactive (its cost without a single clause test), and a ``floor`` record
gives what the timing reads for an empty kernel. ``--sweep`` also times
K1 at other tile rows and blocks-per-SM targets (which set its query
groups), K3 at fixed chunk sizes and K2 and K5 at other blocks-per-SM
targets (the wrappers' tiling constants).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as smoke  # noqa: E402  (stdlib imports only at the top)

# the smoke's field vocabularies: 24 categorical fields of
# make_dataset(SynthSpec(n_fields=24, seed=0)), the two OR fields and the
# 2^20-code timestamp field
VOCAB = (4, 64, 32, 2, 16, 16, 32, 128, 2, 4, 8, 8, 32, 64, 16, 16, 200, 32,
         8, 64, 128, 200, 64, 2, 3, 3, 1 << 20)


def host_ms(fn, reps):
    """Host time of one call of ``fn`` while the card is busy: the calls
    are made behind a ~10 ms spin kernel, so a call that waits for the
    card shows as milliseconds, one that only enqueues as microseconds."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e3


def unit(shape, gen, dev):
    import torch
    x = torch.randn(shape, generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


def timed(rec, fns, reps, flush, order=("ms", "library_ms", "plain_ms", "ms",
                                         "library_ms")):
    """Time ``fns`` in turns (``order``); each key's time is the lower of
    its medians, its runs kept beside it."""
    for key in order:
        if key in fns:
            rec.setdefault(key + "_runs", []).append(
                smoke.cuda_ms(fns[key], reps, flush))
    rec.update({key: min(rec[key + "_runs"]) for key in fns})


def k1_cases(n, gen, dev):
    """The K1 forms at Q=256 over an (n, 27) metadata with the smoke's
    vocabularies: {form: (fields, allowed, n_disj, bounds)}."""
    conj = smoke.k1_tables(256, 1, 4, VOCAB, 1024, gen, dev,
                           fields_from=range(24))
    return {
        "conj": (conj[0][:, 0].contiguous(), conj[1][:, 0].contiguous(),
                 None, None),
        "or_d8": smoke.k1_tables(256, 8, 4, VOCAB, 1024, gen, dev,
                                 fields_from=range(26), p_value=0.1,
                                 min_live=2)[:3] + (None,),
        "range": smoke.k1_tables(256, 1, 4, VOCAB, 1024, gen, dev,
                                 intervals=True),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core.batched.bitmap import pack_bits, popcount
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import fiber_expand as fe
    from repro_torch.kernels import filter_eval as fv
    from repro_torch.kernels import masked_cosine_topk as mct

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = []

    def log(case, **kw):
        rec = {"src": args.src, "case": case, **kw}
        out.append(rec)
        print(json.dumps(rec), flush=True)

    for name in build.KERNELS:
        build.load(name)
        if hasattr(build, "ptxas_report"):
            log(f"ptxas/{name}", ptxas=build.ptxas_report(name))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)

    # what the timing method reads for an empty kernel
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    if not args.check_only:
        log("floor", empty_kernel_ms=smoke.cuda_ms(
            lambda: torch.cuda._sleep(1), args.reps, flush))

    # ragged shapes first: a fault shows before the timed cases
    if hasattr(fv, "filter_plan"):
        smoke.ragged_checks(dev, log)
    else:
        log("ragged", skipped="this version has no filter_plan")

    n, d, n_clusters, R = 105_100, 2048, 324, 96

    # K1: the three forms at Q=256, bit-exact, then timed
    meta = smoke.k1_meta(n, VOCAB, gen, dev)
    k1 = k1_cases(n, gen, dev)
    for form, (fields, allowed, nd, bounds) in k1.items():
        got = fv.filter_eval_batch(meta, fields, allowed, nd, bounds)
        want = ref.filter_eval_batch(meta, fields, allowed, nd, bounds)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"K1 {form}: kernel != plain")
        active = int((fields >= 0).sum())
        rec = dict(Q=256, n=n, F=meta.shape[1], table_shape=list(
            fields.shape), active_clauses=active,
            pass_bits=int(popcount(got).sum()), ok=True)
        if hasattr(fv, "filter_plan"):
            rec["plan"] = fv.filter_plan(
                256, n, meta.shape[1], fields.shape[1] if fields.ndim == 3
                else 1, fields.shape[-1], allowed.shape[-1],
                build.sm_count(dev))
        if not args.check_only:
            n_bytes = (meta.numel() + got.numel() + sum(
                t.numel() for t in (fields, allowed, nd, bounds)
                if t is not None)) * 4
            b_ms, b_by = smoke.bound(n_bytes, 4.0 * n * active)
            timed(rec, {
                "ms": lambda: fv.filter_eval_batch(meta, fields, allowed, nd,
                                                   bounds),
                "plain_ms": lambda: ref.filter_eval_batch(
                    meta, fields, allowed, nd, bounds)},
                args.reps, flush, order=("ms", "plain_ms", "ms"))
            rec.update(host_ms=host_ms(lambda: fv.filter_eval_batch(
                meta, fields, allowed, nd, bounds), 20), bound_ms=b_ms,
                bound_by=b_by, share_of_bound=b_ms / rec["ms"])
            if form == "conj":  # the same call with every clause inactive:
                # what the sweep costs without a single clause test
                none = torch.full_like(fields, -1)
                rec["no_clause_ms"] = smoke.cuda_ms(
                    lambda: fv.filter_eval_batch(meta, none, allowed),
                    args.reps, flush)
        log(f"K1/{form}", **rec)

    # K4: one conjunctive query (3 active clauses of C = 4 over the
    # categorical fields, v_cap 256), over the smoke's 105,100 rows and
    # over 10x as many (where bytes, not launch, dominate); bit-exact, then
    # timed
    fields4, allowed4 = smoke.k4_tables(4, 3, VOCAB, 256, gen, dev,
                                        fields_from=range(24))
    for label, n_rows in (("smoke", n), ("rows_x10", 10 * n)):
        meta4 = meta if n_rows == n else smoke.k1_meta(n_rows, VOCAB, gen,
                                                       dev)
        got = fv.filter_eval(meta4, fields4, allowed4)
        want = ref.filter_eval(meta4, fields4, allowed4)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"K4 {label}: kernel != plain")
        rec = dict(n=n_rows, F=meta4.shape[1], C=4, active_clauses=3,
                   v_cap=256, pass_bits=int(popcount(got)), ok=True)
        if not args.check_only:
            n_bytes, full_bytes = smoke.k4_bytes(meta4, fields4, allowed4)
            b_ms, b_by = smoke.bound(n_bytes, 4.0 * n_rows * 3)
            timed(rec, {
                "ms": lambda: fv.filter_eval(meta4, fields4, allowed4),
                "plain_ms": lambda: ref.filter_eval(meta4, fields4,
                                                    allowed4)},
                args.reps * 5, flush, order=("ms", "plain_ms", "ms"))
            rec.update(host_ms=host_ms(lambda: fv.filter_eval(
                meta4, fields4, allowed4), 50), bound_ms=b_ms,
                bound_by=b_by, share_of_bound=b_ms / rec["ms"],
                needed_mb=n_bytes / 1e6,
                metadata_bound_ms=smoke.bound(full_bytes, 0)[0])
        log(f"K4/{label}", **rec)
        del meta4

    corpus = unit((n, d), gen, dev)
    queries = unit((256, d), gen, dev)
    assign = torch.randint(0, n_clusters, (n,), device=dev, generator=gen)
    pick = torch.randint(0, n_clusters, (256,), device=dev, generator=gen)
    masks = {"one_cluster_k10": (assign[None, :] == pick[:, None], 10),
             "random_half_k32": (torch.rand(256, n, device=dev,
                                            generator=gen) < 0.5, 32)}
    k3_cases = [(label, 256, mask, k) for label, (mask, k) in masks.items()]
    k3_cases.insert(1, ("one_cluster_k10_q64", 64,
                        masks["one_cluster_k10"][0][:64], 10))
    for label, q_n, mask, k in k3_cases:
        queries_q = queries[:q_n]
        bm = pack_bits(mask)
        err, mism = smoke.check_topk(
            f"K3 {label}", mct.masked_cosine_topk(queries_q, corpus, bm, k),
            ref.masked_cosine_topk(queries_q, corpus, bm, k), mask,
            queries_q, corpus)
        rec = dict(Q=q_n, n=n, d=d, k=k, max_abs_err=err, id_mismatches=mism,
                   ok=True)
        if not args.check_only:
            rows_any = int(mask.any(dim=0).sum())
            set_bits = int(mask.sum())
            n_bytes = (queries_q.numel() + rows_any * d + bm.numel()
                       + 2 * q_n * k) * 4
            ops = 2.0 * d * set_bits
            fns = {
                "ms": lambda: mct.masked_cosine_topk(queries_q, corpus, bm,
                                                     k),
                "plain_ms": lambda: ref.masked_cosine_topk(queries_q, corpus,
                                                           bm, k),
                "library_ms": lambda: torch.topk(torch.where(
                    mask, queries_q @ corpus.T, float("-inf")), k)}
            timed(rec, fns, args.reps, flush)
            rec.update(
                host_ms=host_ms(fns["ms"], 10),
                bytes_ms=smoke.bound(n_bytes, 0)[0],
                fp32_ops_ms=smoke.bound(0, ops)[0],
                tf32x3_ops_ms=smoke.bound(0, 3 * ops,
                                          smoke.TF32_FLOP_PER_S)[0],
                rows_any=rows_any, set_bits=set_bits)
        log(f"K3/{label}", **rec)

    pass_bm = pack_bits(torch.rand(256, n, device=dev, generator=gen) < 0.07)
    for q_n in (64, 256):
        ids = torch.randint(0, n, (q_n, R), device=dev, generator=gen,
                            dtype=torch.int32)
        pad = torch.rand(q_n, R, device=dev, generator=gen) > 10_139 / 24_576
        ids = torch.where(pad, -1, ids).contiguous()
        q, bm = queries[:q_n].contiguous(), pass_bm[:q_n].contiguous()
        err = smoke.check_walk(f"K2 Q={q_n}",
                               fe.fiber_expand_walk(q, corpus, ids, bm),
                               ref.fiber_expand_walk(q, corpus, ids, bm))
        rec = dict(Q=q_n, R=R, d=d, max_abs_err=err, ok=True)
        n_valid = int((ids >= 0).sum())
        safe = ids.clamp(min=0).long().flatten()
        if not args.check_only:
            n_rows = int(torch.unique(ids[ids >= 0]).numel())
            n_bytes = (q.numel() + n_rows * d + ids.numel() + n_valid
                       + 2 * ids.numel()) * 4
            fns = {
                "ms": lambda: fe.fiber_expand_walk(q, corpus, ids, bm),
                "plain_ms": lambda: ref.fiber_expand_walk(q, corpus, ids, bm),
                "library_ms": lambda: torch.bmm(
                    corpus.index_select(0, safe).view(q_n, R, d),
                    q.unsqueeze(2))}
            timed(rec, fns, args.reps * 5, flush)
            # a streaming read of as many contiguous rows as the call
            # gathers: what the card's memory gives this many bytes
            stream = corpus[:n_valid]
            rec.update(host_ms=host_ms(fns["ms"], 50),
                       bytes_ms=smoke.bound(n_bytes, 0)[0],
                       stream_read_ms=smoke.cuda_ms(lambda: stream.sum(),
                                                    args.reps * 5, flush),
                       valid_ids=n_valid, distinct_rows=n_rows)
        log(f"K2/Q{q_n}", **rec)

    # K5 on the Q=256 hop: a row is read only where its pass bit is set
    want = ref.fiber_expand(q, corpus, ids, bm)
    err = smoke.check_expand("K5", fe.fiber_expand(q, corpus, ids, bm), want)
    fin = torch.isfinite(want)
    rec = dict(Q=256, R=R, d=d, max_abs_err=err, valid_ids=n_valid,
               passing_ids=int(fin.sum()), ok=True)
    if not args.check_only:
        pass_rows = int(torch.unique(ids[fin]).numel())
        n_bytes = (q.numel() + 2 * ids.numel() + n_valid
                   + pass_rows * d) * 4
        b_ms, b_by = smoke.bound(n_bytes, 2.0 * d * int(fin.sum()))

        def k5_library():
            sims = torch.bmm(corpus.index_select(0, safe).view(256, R, d),
                             q.unsqueeze(2)).squeeze(2)
            return torch.where(fin, sims, float("-inf"))

        fns = {"ms": lambda: fe.fiber_expand(q, corpus, ids, bm),
               "plain_ms": lambda: ref.fiber_expand(q, corpus, ids, bm),
               "library_ms": k5_library}
        timed(rec, fns, args.reps * 5, flush)
        rec.update(host_ms=host_ms(fns["ms"], 50), bound_ms=b_ms,
                   bound_by=b_by, share_of_bound=b_ms / rec["ms"],
                   distinct_passing_rows=pass_rows)
    log("K5/Q256", **rec)

    if args.sweep:
        if hasattr(fv, "filter_plan"):
            base = fv.FILTER_ROWS, fv.FILTER_BLOCKS_PER_SM
            for rows in (128, 256):
                for bps in (1, 2, 4, 8, 16):
                    fv.FILTER_ROWS, fv.FILTER_BLOCKS_PER_SM = rows, bps
                    log("sweep/K1", rows=rows, blocks_per_sm=bps, plan=[
                        fv.filter_plan(256, n, meta.shape[1], t[0].shape[1]
                                       if t[0].ndim == 3 else 1,
                                       t[0].shape[-1], t[1].shape[-1],
                                       build.sm_count(dev))
                        for t in k1.values()], **{
                            form: smoke.cuda_ms(
                                lambda: fv.filter_eval_batch(meta, *t),
                                args.reps, flush)
                            for form, t in k1.items()})
            fv.FILTER_ROWS, fv.FILTER_BLOCKS_PER_SM = base
        k3_cases = [(label, pack_bits(mask), k)
                    for label, (mask, k) in masks.items()]
        for cw in (16, 32, 48, 64):
            mct.CHUNK_WORDS = (cw, cw)
            log("sweep/K3", chunk_words=cw, **{
                label: smoke.cuda_ms(lambda: mct.masked_cosine_topk(
                    queries, corpus, bm, k), args.reps, flush)
                for label, bm, k in k3_cases})
        base_k2 = fe.WALK_BLOCKS_PER_SM
        for bps in (1, 2, 4, 8):
            fe.WALK_BLOCKS_PER_SM = bps
            times = {}
            for q_n in (64, 256):
                ids = torch.randint(0, n, (q_n, R), device=dev, generator=gen,
                                    dtype=torch.int32)
                pad = torch.rand(q_n, R, device=dev,
                                 generator=gen) > 10_139 / 24_576
                ids = torch.where(pad, -1, ids).contiguous()
                q, bm = queries[:q_n].contiguous(), pass_bm[:q_n].contiguous()
                times[f"K2_Q{q_n}"] = smoke.cuda_ms(
                    lambda: fe.fiber_expand_walk(q, corpus, ids, bm),
                    args.reps * 5, flush)
            times["K5_Q256"] = smoke.cuda_ms(lambda: fe.fiber_expand(
                q, corpus, ids, bm), args.reps * 5, flush)
            log("sweep/K2_K5", blocks_per_sm=bps, **times)
        fe.WALK_BLOCKS_PER_SM = base_k2
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "records": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
