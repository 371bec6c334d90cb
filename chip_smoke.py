#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
builds a paper-size index on the host (H&M scale: 105,100 x 2048, 24
categorical fields plus two OR fields and a timestamp field), holds each
kernel against its plain PyTorch version on the card at the shapes the
search path gives it, then drives the fused filtered search
(``BatchedEngine(device="cuda").search``) on conjunctive, OR and range
batches and checks the results: every id passes its predicate, no
duplicates, at most k per query, every kernel launched, and the card's
answers agree with the host engine's on the same batches.

Prints the kernels' timings as one JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without the ``ok`` line; so does a machine without CUDA or a
directory without the package. ``--report PATH`` also writes every
measurement (and a profiler breakdown of one batch) to PATH as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
# CUDA-core FLOP/s; the kernels' scalar integer work is counted against
# the fp32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

N_PAPER = 105_100   # H&M corpus rows (paper size)
D = 2048
N_FIELDS = 24
K = 10              # results per query
Q_KERNEL = 256      # kernel-phase batch


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int, flush) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events around
    each run, the L2 cache flushed before each, after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the fp32 rate, with the side that binds."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def build_corpus(log):
    from repro_torch.core.atlas import AnchorAtlas
    from repro_torch.core.config import FnsConfig
    from repro_torch.core.graph import build_alpha_knn
    from repro_torch.core.search import FiberIndex
    from repro_torch.data.synth import (SynthSpec, add_or_pair_fields,
                                        add_timestamp_field, make_dataset)
    t0 = time.time()
    ds = make_dataset(SynthSpec(n=N_PAPER, d=D, n_fields=N_FIELDS,
                                n_components=350, seed=0))
    ds = add_timestamp_field(add_or_pair_fields(ds))
    t1 = time.time()
    graph = build_alpha_knn(ds.vectors, config=FnsConfig())
    t2 = time.time()
    atlas = AnchorAtlas.build(ds, seed=0)
    t3 = time.time()
    log("host_build", data_s=t1 - t0, graph_s=t2 - t1, atlas_s=t3 - t2,
        n=ds.n, d=ds.d, fields=ds.n_fields, graph_width=graph.r_pad,
        clusters=atlas.n_clusters)
    return ds, FiberIndex(ds.vectors, ds.metadata, graph, atlas)


def make_batches(ds):
    from repro_torch.core.types import Dataset
    from repro_torch.data.synth import (make_or_queries, make_queries,
                                        make_range_queries)
    # conjunctive filters over the 24 categorical fields (the OR and
    # timestamp fields get their own batches)
    base = Dataset(ds.vectors, ds.metadata[:, :N_FIELDS],
                   ds.field_names[:N_FIELDS], ds.vocab_sizes[:N_FIELDS])
    conj256 = make_queries(base, n_queries=256, seed=1)
    return {
        "conj_q64": conj256[:64],
        "conj_q256": conj256,
        "or_q64": (make_or_queries(ds, 1, 32) + make_or_queries(ds, 2, 32)),
        "range_q64": (make_range_queries(ds, 0.5, 21)
                      + make_range_queries(ds, 0.1, 21)
                      + make_range_queries(ds, 0.02, 22)),
    }


def kernel_phases(ds, index, batches, dev, flush, log):
    """Each kernel against its plain version on the card at the search
    path's shapes; returns the per-kernel records (launches filled in
    later from the main path's run)."""
    import numpy as np
    import torch
    from repro_torch.core.batched.bitmap import n_words, pack_bits
    from repro_torch.core.batched.engine import pack_query_batch
    from repro_torch.core.device_atlas import auto_v_cap
    from repro_torch.kernels import fiber_expand, filter_eval
    from repro_torch.kernels import masked_cosine_topk as mct
    from repro_torch.kernels import ref
    from repro_torch.kernels.filter_eval import table_n_disj

    vocab = ds.vocab_sizes
    v_cap = auto_v_cap(max(v for by_f in index.atlas.cluster_index
                           for v in by_f))
    meta = torch.from_numpy(ds.metadata).to(dev)
    vectors = torch.from_numpy(ds.vectors).to(dev)
    W = n_words(meta.shape[0])
    records = {}

    # K1: conjunctive, OR (DNF) and range (DNF + bounds) tables, Q=256
    conj = batches["conj_q256"]
    forms = {
        "conj": conj,
        "dnf": (batches["or_q64"] * 4)[:Q_KERNEL],
        "bounds": (batches["range_q64"] * 4)[:Q_KERNEL],
    }
    k1, bitmaps = {}, {}
    for form, qs in forms.items():
        _, fields, allowed, bounds = pack_query_batch(
            qs, v_cap=v_cap, vocab_sizes=vocab, device=dev)
        check((bounds is not None) == (form == "bounds"), f"K1 {form} form")
        nd = table_n_disj(fields) if fields.ndim == 3 else None
        got = filter_eval.filter_eval_batch(meta, fields, allowed, nd, bounds)
        want = ref.filter_eval_batch(meta, fields, allowed, nd, bounds)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K1 {form}: kernel != plain")
        bitmaps[form] = got
        k1[form] = dict(
            ms=cuda_ms(lambda: filter_eval.filter_eval_batch(
                meta, fields, allowed, nd, bounds), 20, flush),
            plain_ms=cuda_ms(lambda: ref.filter_eval_batch(
                meta, fields, allowed, nd, bounds), 5, flush),
            table_bytes=sum(t.numel() * 4 for t in (fields, allowed, bounds)
                            if t is not None),
            active_clauses=int((fields >= 0).sum()))
    pass_bm = bitmaps["conj"]
    # the conjunctive form is the main path's bulk traffic
    c = k1["conj"]
    n_bytes = meta.numel() * 4 + c["table_bytes"] + Q_KERNEL * W * 4
    b_ms, b_by = bound(n_bytes, 4.0 * meta.shape[0] * c["active_clauses"])
    records["filter_eval_batch"] = dict(
        name="filter_eval_batch", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/filter_eval.cu",
        replaces="src/repro/kernels/filter_eval.py:172", launches=0,
        max_abs_err=0.0, ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log("K1", ok=True, **{f"{f}_{k}": v for f, r in k1.items()
                          for k, v in r.items()})

    # K2: Q=256 walk hops, R = the adjacency width, d=2048
    rng = np.random.default_rng(0)
    adjacency = torch.from_numpy(index.graph.neighbors).to(dev)
    q_vecs = torch.from_numpy(np.stack([q.vector for q in conj])).to(dev)
    nodes = torch.from_numpy(rng.integers(0, ds.n, Q_KERNEL)).to(dev)
    ids = adjacency[nodes].contiguous()
    R = ids.shape[1]
    s_k, p_k = fiber_expand.fiber_expand_walk(q_vecs, vectors, ids, pass_bm)
    s_p, p_p = ref.fiber_expand_walk(q_vecs, vectors, ids, pass_bm)
    torch.cuda.synchronize()
    for got, want in ((s_k, s_p), (p_k, p_p)):
        check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
              "K2: -inf positions differ")
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              "K2: kernel != plain at rtol=atol=1e-5")
    fin = torch.isfinite(s_p)
    err = float((s_k[fin] - s_p[fin]).abs().max()) if fin.any() else 0.0
    n_valid = int((ids >= 0).sum())
    n_rows = int(torch.unique(ids[ids >= 0]).numel())
    n_bytes = (q_vecs.numel() * 4 + n_rows * D * 4 + ids.numel() * 4
               + n_valid * 4 + 2 * ids.numel() * 4)
    b_ms, b_by = bound(n_bytes, 2.0 * D * n_valid)
    safe = ids.clamp(min=0).long().flatten()

    def k2_library():
        rows = vectors.index_select(0, safe).view(Q_KERNEL, R, D)
        return torch.bmm(rows, q_vecs.unsqueeze(2))

    records["fiber_expand_walk"] = dict(
        name="fiber_expand_walk", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/fiber_expand.cu",
        replaces="src/repro/kernels/fiber_expand.py:52", launches=0,
        max_abs_err=err,
        ms=cuda_ms(lambda: fiber_expand.fiber_expand_walk(
            q_vecs, vectors, ids, pass_bm), 50, flush),
        plain_ms=cuda_ms(lambda: ref.fiber_expand_walk(
            q_vecs, vectors, ids, pass_bm), 20, flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(k2_library, 20, flush))
    log("K2", R=R, valid_ids=n_valid, distinct_rows=n_rows,
        **records["fiber_expand_walk"])

    # K3: k=10 over a one-cluster mask (the seed path's slot masks: each
    # query's best cluster), and k=32 over a random half of the corpus
    assign = torch.from_numpy(index.atlas.assign.astype(np.int64)).to(dev)
    cents = torch.from_numpy(index.atlas.centroids).to(dev)
    best = (q_vecs @ cents.T).argmax(dim=1)
    masks = {
        "one_cluster_k10": (assign[None, :] == best[:, None], 10),
        "random_k32": (torch.rand(Q_KERNEL, ds.n, device=dev,
                                  generator=torch.Generator(dev).manual_seed(0))
                       < 0.5, 32),
    }
    k3 = {}
    for label, (mask, k) in masks.items():
        bm = pack_bits(mask)
        s_k, i_k = mct.masked_cosine_topk(q_vecs, vectors, bm, k)
        s_p, i_p = ref.masked_cosine_topk(q_vecs, vectors, bm, k)
        torch.cuda.synchronize()
        fin = torch.isfinite(s_p)
        check(torch.equal(torch.isfinite(s_k), fin), f"K3 {label}: fill")
        check(torch.allclose(s_k[fin], s_p[fin], rtol=1e-4, atol=1e-4),
              f"K3 {label}: sims differ beyond 1e-4")
        # ids agree up to near-ties: where they differ, the kernel's id
        # must pass the mask, score what the kernel says, and be unique
        diff = (i_k != i_p) & fin
        if diff.any():
            qi, _ = torch.nonzero(diff, as_tuple=True)
            kid = i_k[diff].long()
            check(bool(mask[qi, kid].all()), f"K3 {label}: id fails mask")
            true = (vectors[kid] * q_vecs[qi]).sum(1)
            check(torch.allclose(true, s_k[diff], rtol=1e-4, atol=1e-4),
                  f"K3 {label}: id does not score its sim")
        srt = i_k.sort(dim=1).values
        check(not bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0))
                       .any()), f"K3 {label}: duplicate ids")
        err = float((s_k[fin] - s_p[fin]).abs().max()) if fin.any() else 0.0
        set_bits = int(mask.sum())
        rows_any = int(mask.any(dim=0).sum())
        n_bytes = (q_vecs.numel() * 4 + rows_any * D * 4 + bm.numel() * 4
                   + 2 * Q_KERNEL * k * 4)
        b_ms, b_by = bound(n_bytes, 2.0 * D * set_bits)

        def k3_library(mask=mask, k=k):
            return torch.topk(torch.where(mask, q_vecs @ vectors.T,
                                          float("-inf")), k)

        k3[label] = dict(
            ms=cuda_ms(lambda: mct.masked_cosine_topk(q_vecs, vectors, bm, k),
                       10, flush),
            plain_ms=cuda_ms(lambda: ref.masked_cosine_topk(
                q_vecs, vectors, bm, k), 5, flush),
            library_ms=cuda_ms(k3_library, 5, flush),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
            id_mismatches=int(diff.sum()), set_bits=set_bits,
            rows_any=rows_any)
    m = k3["one_cluster_k10"]
    records["masked_cosine_topk"] = dict(
        name="masked_cosine_topk", route="cuda", ok=True,
        source="src/repro_torch/kernels/csrc/masked_cosine_topk.cu",
        replaces="src/repro/kernels/masked_cosine_topk.py:61", launches=0,
        max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
        bound_ms=m["bound_ms"], bound_by=m["bound_by"],
        library_ms=m["library_ms"])
    log("K3", ok=True, **{f"{lbl}_{k}": v for lbl, r in k3.items()
                          for k, v in r.items()})
    return records


def ground_truth(ds, queries, dev):
    """Exact filtered top-K ids per query (host masks, card products)."""
    import numpy as np
    import torch
    vectors = torch.from_numpy(ds.vectors).to(dev)
    masks = torch.from_numpy(np.stack(
        [q.predicate.mask(ds.metadata, ds.vocab_sizes) for q in queries]))
    q_vecs = torch.from_numpy(np.stack([q.vector for q in queries])).to(dev)
    scores = torch.where(masks.to(dev), q_vecs @ vectors.T, float("-inf"))
    sims, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    sims, ids = sims[:, :K].cpu().numpy(), ids[:, :K].cpu().numpy()
    return [i[np.isfinite(s)] for s, i in zip(sims, ids)], masks.numpy()


def main_path(ds, index, batches, dev, card, log, profile_into=None):
    """The fused search through the user entry point on the card; returns
    the results by batch for the host comparison."""
    import numpy as np
    import torch
    from repro_torch.core.batched.engine import BatchedEngine
    from repro_torch.core.config import FnsConfig, WalkConfig
    from repro_torch.data.ground_truth import recall_at_k
    from repro_torch.kernels import fiber_expand, filter_eval
    from repro_torch.kernels import masked_cosine_topk as mct

    cfg = FnsConfig(walk=WalkConfig(k=K))
    t0 = time.time()
    eng = BatchedEngine(index, cfg, device=dev, vocab_sizes=ds.vocab_sizes)
    log("engine_build", s=time.time() - t0)
    gts = {name: ground_truth(ds, qs, dev) for name, qs in batches.items()}
    filter_eval.launches = fiber_expand.launches = mct.launches = 0
    results = {}
    for name, qs in batches.items():
        eng.search(qs)                      # warm-up (allocator, cuBLAS)
        torch.cuda.synchronize()
        t = time.time()
        ids, stats = eng.search(qs)
        ms = (time.time() - t) * 1e3
        gt, masks = gts[name]
        for qi, row in enumerate(ids):
            check(row.size <= K, f"{name}[{qi}]: more than k results")
            check(np.unique(row).size == row.size, f"{name}[{qi}]: dupes")
            check(bool(masks[qi][row].all()),
                  f"{name}[{qi}]: a result fails its predicate")
        rec = float(np.mean([recall_at_k(r, g) for r, g in zip(ids, gt)]))
        results[name] = dict(ids=ids, stats=stats)
        log("search", batch=name, Q=len(qs), ms_per_batch=ms,
            qps=len(qs) / ms * 1e3, recall_at_10=rec,
            mean_walks=float(stats["walks"].mean()),
            mean_hops=float(stats["hops"].mean()), syncs=stats["syncs"],
            card=card)
    launches = {"filter_eval_batch": filter_eval.launches,
                "fiber_expand_walk": fiber_expand.launches,
                "masked_cosine_topk": mct.launches}
    for name, n in launches.items():
        check(n > 0, f"main path never launched {name}")
    log("main_path_launches", **launches)
    if profile_into is not None:
        from torch.profiler import ProfilerActivity, profile
        qs = batches["conj_q64"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.search(qs)
        rows = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
        profile_into["conj_q64"] = [
            dict(name=e.key, device_us=e.device_time_total,
                 self_device_us=e.self_device_time_total, calls=e.count)
            for e in rows[:30]]
        profile_into["conj_q64_self_device_us"] = sum(
            e.self_device_time_total for e in prof.key_averages())
        profile_into["conj_q64_wall_us"] = (
            max(e.time_range.end for e in prof.events())
            - min(e.time_range.start for e in prof.events()))
    del eng
    return results, launches


def host_comparison(index, ds, batches, card_res, log):
    """The Q=64 conjunctive and OR batches through the host engine: per-lane
    id-set overlap with the card's answers (the OR batch also holds the
    disjunct-quota seeding, kernel calls on the card, to the host's dense
    products)."""
    import numpy as np
    from repro_torch.core.batched.engine import BatchedEngine
    from repro_torch.core.config import FnsConfig, WalkConfig
    eng = BatchedEngine(index, FnsConfig(walk=WalkConfig(k=K)), device="cpu",
                        vocab_sizes=ds.vocab_sizes)
    for name in ("conj_q64", "or_q64"):
        t = time.time()
        ids, _ = eng.search(batches[name])
        overlap, exact = [], 0
        for a, b in zip(card_res[name]["ids"], ids):
            overlap.append(1.0 if a.size == b.size == 0 else
                           np.intersect1d(a, b).size / max(a.size, b.size))
            exact += int(np.array_equal(a, b))
        mean = float(np.mean(overlap))
        log("host_vs_card", batch=name, mean_overlap=mean,
            exact_match_frac=exact / len(ids), host_s=time.time() - t)
        check(mean >= 0.98,
              f"{name}: card vs host id-set overlap {mean:.4f} < 0.98")


def run(report_path: str | None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.kernels import build

    report: dict = {"records": []}

    def log(what, **kw):
        rec = {"phase": what, **kw}
        report["records"].append(rec)
        print(json.dumps(rec), flush=True)

    card = card_line()
    log("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    dev = torch.device("cuda", 0)
    t = time.time()
    # one thread per kernel, so the nvcc processes run side by side
    with ThreadPoolExecutor(len(build.KERNELS)) as pool:
        list(pool.map(build.load, build.KERNELS))
    log("kernel_build", s=time.time() - t)
    ds, index = build_corpus(log)
    batches = make_batches(ds)
    flush = torch.empty(64 << 20, dtype=torch.int8, device=dev)
    records = kernel_phases(ds, index, batches, dev, flush, log)
    del flush
    torch.cuda.empty_cache()
    profile = {} if report_path else None
    card_res, launches = main_path(ds, index, batches, dev, card, log,
                                   profile)
    for name, n in launches.items():
        records[name]["launches"] = n
    host_comparison(index, ds, batches, card_res, log)
    if report_path:
        report["profile"] = profile
        report["kernels"] = list(records.values())
        os.makedirs(os.path.dirname(os.path.abspath(report_path)),
                    exist_ok=True)
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1, default=float)
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", help="also write every measurement here")
    args = ap.parse_args()
    try:
        return run(args.report)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
