#!/usr/bin/env python3
"""Recall of the port's fused search against the synthetic recipe's noise.

    PYTHONPATH=src python3 tools/torch_recall_probe.py [--n 20000]
        [--dims 64,2048] [--device cuda] [--out PATH]

``make_dataset`` adds per-dimension noise of relative scale
``SynthSpec.noise`` (0.35) to unit component centres, and ``make_queries``
adds ``query_noise`` (0.15) per dimension to a corpus point, so the noise
norms grow with the square root of d while the centres stay unit vectors.
For each d this builds the same recipe twice at n rows (24 categorical
fields, 350 components, seed 0): once with the default noise and once
with both noises scaled by sqrt(64/d), the width the recipe was tuned at.
It runs one Q=64 conjunctive batch through ``BatchedEngine(device).search``
at k=10 and prints one JSON line per case: recall@10 against the exact
filtered top-10, the noise norms, and the mean cosine of the exact top-10
beside the mean cosine over all passing rows (how much nearer the true
neighbours are than a random passing row).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core.atlas import AnchorAtlas  # noqa: E402
from repro_torch.core.batched.engine import BatchedEngine  # noqa: E402
from repro_torch.core.config import FnsConfig, WalkConfig  # noqa: E402
from repro_torch.core.graph import build_alpha_knn  # noqa: E402
from repro_torch.core.search import FiberIndex  # noqa: E402
from repro_torch.data.ground_truth import (filtered_topk,  # noqa: E402
                                           recall_at_k)
from repro_torch.data.synth import SynthSpec, make_dataset, make_queries  # noqa: E402

K = 10
DATA_NOISE = SynthSpec().noise
QUERY_NOISE = 0.15      # make_queries' default


def probe(n: int, d: int, scale: float, device: str) -> dict:
    t0 = time.time()
    ds = make_dataset(SynthSpec(n=n, d=d, n_fields=24, n_components=350,
                                noise=DATA_NOISE * scale, seed=0))
    queries = make_queries(ds, n_queries=64, seed=1,
                           query_noise=QUERY_NOISE * scale)
    cfg = FnsConfig(walk=WalkConfig(k=K))
    index = FiberIndex(ds.vectors, ds.metadata,
                       build_alpha_knn(ds.vectors, config=cfg),
                       AnchorAtlas.build(ds, seed=0))
    ids, stats = BatchedEngine(index, cfg, device=device).search(queries)
    recalls, gt_sims, pass_sims = [], [], []
    for q, found in zip(queries, ids):
        passes = q.predicate.mask(ds.metadata, ds.vocab_sizes)
        gt, sims = filtered_topk(ds.vectors, q.vector, passes, K)
        recalls.append(recall_at_k(found, gt))
        gt_sims.append(float(sims.mean()))
        pass_sims.append(float((ds.vectors[passes] @ q.vector).mean()))
    return dict(n=n, d=d, noise_scale=scale,
                data_noise_norm=DATA_NOISE * scale * math.sqrt(d),
                query_noise_norm=QUERY_NOISE * scale * math.sqrt(d),
                recall_at_10=float(np.mean(recalls)),
                gt_top10_cos=float(np.mean(gt_sims)),
                passing_cos=float(np.mean(pass_sims)),
                mean_walks=float(stats["walks"].mean()),
                mean_hops=float(stats["hops"].mean()),
                device=device, seconds=time.time() - t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--dims", default="64,2048")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the rows here as JSON")
    args = ap.parse_args()
    rows = []
    for d in (int(x) for x in args.dims.split(",")):
        for scale in sorted({1.0, math.sqrt(64 / d)}, reverse=True):
            rows.append(probe(args.n, d, scale, args.device))
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
