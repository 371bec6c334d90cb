#!/usr/bin/env python3
"""K2 and K3 alone on the card: each kernel against its plain version, then
timed beside the plain version and one PyTorch call for the same function.

    python3 tools/torch_kernel_bench.py [--src DIR] [--reps N] [--check-only]
        [--sweep] [--out PATH]

Needs one CUDA card and ``nvcc``. The data is made on the card from fixed
seeds at the smoke's widths, with no index build: a 105,100 x 2048 corpus
of unit rows; Q=256 unit queries; for K3 a k=32 mask that passes a random
half of the corpus, and k=10 masks that pass one of 324 random clusters
per query at Q=256 and Q=64 (the search path's one-cluster seed masks:
sqrt(n) clusters of ~324 rows); for K2 walk hops at Q=64 and Q=256 with R=96 neighbour slots
of which 41% hold a valid id (the smoke's 10,139 of 24,576) and pass
bitmaps that pass 7% of the rows. Ragged shapes (n % 32 != 0, d % 4 != 0,
Q below the kernels' tiles) are checked too. Checks are the smoke's: K2
identical -inf positions and rtol = atol = 1e-5; K3 identical fill, sims
within 1e-4, an id that differs from the plain version's must pass its
mask and score its sim, no duplicates.

``--src`` picks the package to load (``src`` of this checkout by default;
point it at another checkout's ``src`` to time that version's kernels in
the same call). Each function is timed twice, in turns (kernel, library,
plain, kernel, library); a time is the lower of its medians of CUDA-event
timed runs with the L2 cache flushed before each, each run queued behind
a spin kernel so that the host's enqueue time does not count. Prints one
JSON line per case, the card's name and power limit, and exits non-zero
on any failed check. Each record also gives the wrapper's host time per
call while the card is busy (``host_ms``: a call that waits for the card
shows as milliseconds), and K2's a streaming read (``sum``) of as many
contiguous corpus rows as the call gathers. ``--sweep`` also
times K3 at fixed chunk sizes and K2 at other blocks-per-SM targets (the
wrappers' tiling constants).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


def cuda_ms(fn, reps, flush):
    """Median device time of ``fn``: each run is queued behind a ~1 ms spin
    kernel and an L2 flush, so the events time the card, not the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def check_k2(got, want, what):
    import torch
    for g, w in zip(got, want):
        if not torch.equal(torch.isneginf(g), torch.isneginf(w)):
            raise SystemExit(f"{what}: -inf positions differ")
        if not torch.allclose(g, w, rtol=1e-5, atol=1e-5):
            raise SystemExit(f"{what}: kernel != plain at rtol=atol=1e-5")
    fin = torch.isfinite(want[0])
    return float((got[0][fin] - want[0][fin]).abs().max()) if fin.any() else 0.


def check_k3(got, want, queries, corpus, mask, what):
    import torch
    (s_k, i_k), (s_p, i_p) = got, want
    fin = torch.isfinite(s_p)
    if not torch.equal(torch.isfinite(s_k), fin):
        raise SystemExit(f"{what}: fill differs")
    if not torch.allclose(s_k[fin], s_p[fin], rtol=1e-4, atol=1e-4):
        raise SystemExit(f"{what}: sims differ beyond 1e-4")
    diff = (i_k != i_p) & fin
    if diff.any():
        qi, _ = torch.nonzero(diff, as_tuple=True)
        kid = i_k[diff].long()
        if not bool(mask[qi, kid].all()):
            raise SystemExit(f"{what}: id fails mask")
        true = (corpus[kid] * queries[qi]).sum(1)
        if not torch.allclose(true, s_k[diff], rtol=1e-4, atol=1e-4):
            raise SystemExit(f"{what}: id does not score its sim")
    srt = i_k.sort(dim=1).values
    if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
        raise SystemExit(f"{what}: duplicate ids")
    err = float((s_k[fin] - s_p[fin]).abs().max()) if fin.any() else 0.
    return err, int(diff.sum())


def unit(shape, gen, dev):
    import torch
    x = torch.randn(shape, generator=gen, device=dev)
    return x / x.norm(dim=1, keepdim=True)


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
    from repro_torch.core.batched.bitmap import pack_bits
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import fiber_expand as fe
    from repro_torch.kernels import masked_cosine_topk as mct

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = []

    def log(**kw):
        rec = {"src": args.src, **kw}
        out.append(rec)
        print(json.dumps(rec), flush=True)

    for name in ("fiber_expand", "masked_cosine_topk"):
        build.load(name)
        if hasattr(build, "ptxas_report"):
            log(case=f"ptxas/{name}", ptxas=build.ptxas_report(name))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)

    # ragged shapes first: a fault shows before the timed cases
    for n, d, q_n, k, r in ((1000, 37, 70, 7, 5), (800, 64, 6, 16, 24),
                            (4133, 132, 130, 32, 50)):
        corpus = unit((n, d), gen, dev)
        queries = unit((q_n, d), gen, dev)
        mask = torch.rand(q_n, n, device=dev, generator=gen) < 0.3
        bm = pack_bits(mask)
        err, mism = check_k3(mct.masked_cosine_topk(queries, corpus, bm, k),
                             ref.masked_cosine_topk(queries, corpus, bm, k),
                             queries, corpus, mask, f"K3 ragged n={n} d={d}")
        ids = torch.randint(-1, n, (q_n, r), device=dev, generator=gen,
                            dtype=torch.int32)
        e2 = check_k2(fe.fiber_expand_walk(queries, corpus, ids, bm),
                      ref.fiber_expand_walk(queries, corpus, ids, bm),
                      f"K2 ragged n={n} d={d}")
        torch.cuda.synchronize()
        log(case="ragged", n=n, d=d, Q=q_n, k=k, R=r, k3_max_abs_err=err,
            k3_id_mismatches=mism, k2_max_abs_err=e2, ok=True)

    n, d, n_clusters, R = 105_100, 2048, 324, 96
    corpus = unit((n, d), gen, dev)
    queries = unit((256, d), gen, dev)
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
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
        err, mism = check_k3(
            mct.masked_cosine_topk(queries_q, corpus, bm, k),
            ref.masked_cosine_topk(queries_q, corpus, bm, k), queries_q,
            corpus, mask, f"K3 {label}")
        rec = dict(case=f"K3/{label}", Q=q_n, n=n, d=d, k=k,
                   max_abs_err=err, id_mismatches=mism, ok=True)
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
            for key in ("ms", "library_ms", "plain_ms", "ms", "library_ms"):
                rec.setdefault(key + "_runs", []).append(
                    cuda_ms(fns[key], args.reps, flush))
            rec.update({key: min(rec[key + "_runs"]) for key in fns})
            rec.update(
                host_ms=host_ms(fns["ms"], 10),
                bytes_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                fp32_ops_ms=ops / FP32_FLOP_PER_S * 1e3,
                tf32x3_ops_ms=3 * ops / TF32_FLOP_PER_S * 1e3,
                rows_any=rows_any, set_bits=set_bits)
        log(**rec)

    pass_bm = pack_bits(torch.rand(256, n, device=dev, generator=gen) < 0.07)
    for q_n in (64, 256):
        ids = torch.randint(0, n, (q_n, R), device=dev, generator=gen,
                            dtype=torch.int32)
        pad = torch.rand(q_n, R, device=dev, generator=gen) > 10_139 / 24_576
        ids = torch.where(pad, -1, ids).contiguous()
        q, bm = queries[:q_n].contiguous(), pass_bm[:q_n].contiguous()
        err = check_k2(fe.fiber_expand_walk(q, corpus, ids, bm),
                       ref.fiber_expand_walk(q, corpus, ids, bm),
                       f"K2 Q={q_n}")
        rec = dict(case=f"K2/Q{q_n}", Q=q_n, R=R, d=d, max_abs_err=err,
                   ok=True)
        if not args.check_only:
            n_valid = int((ids >= 0).sum())
            n_rows = int(torch.unique(ids[ids >= 0]).numel())
            n_bytes = (q.numel() + n_rows * d + ids.numel() + n_valid
                       + 2 * ids.numel()) * 4
            safe = ids.clamp(min=0).long().flatten()
            fns = {
                "ms": lambda: fe.fiber_expand_walk(q, corpus, ids, bm),
                "plain_ms": lambda: ref.fiber_expand_walk(q, corpus, ids, bm),
                "library_ms": lambda: torch.bmm(
                    corpus.index_select(0, safe).view(q_n, R, d),
                    q.unsqueeze(2))}
            for key in ("ms", "library_ms", "plain_ms", "ms", "library_ms"):
                rec.setdefault(key + "_runs", []).append(
                    cuda_ms(fns[key], args.reps * 5, flush))
            rec.update({key: min(rec[key + "_runs"]) for key in fns})
            # a streaming read of as many contiguous rows as the call
            # gathers: what the card's memory gives this many bytes
            stream = corpus[:n_valid]
            rec.update(host_ms=host_ms(fns["ms"], 50),
                       bytes_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                       stream_read_ms=cuda_ms(lambda: stream.sum(),
                                              args.reps * 5, flush),
                       valid_ids=n_valid, distinct_rows=n_rows)
        log(**rec)
    if args.sweep:
        k3_cases = [(label, pack_bits(mask), k)
                    for label, (mask, k) in masks.items()]
        for cw in (16, 32, 48, 64):
            mct.CHUNK_WORDS = (cw, cw)
            log(case="sweep/K3", chunk_words=cw, **{
                label: cuda_ms(lambda: mct.masked_cosine_topk(
                    queries, corpus, bm, k), args.reps, flush)
                for label, bm, k in k3_cases})
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
                times[f"Q{q_n}"] = cuda_ms(lambda: fe.fiber_expand_walk(
                    q, corpus, ids, bm), args.reps * 5, flush)
            log(case="sweep/K2", blocks_per_sm=bps, **times)
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "records": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
