#!/usr/bin/env python3
"""The α-kNN graph build of the smoke's main corpus, stage by stage, with
this checkout's ``core/graph.py`` and another's, in one process.

    python3 tools/torch_graph_build.py --other DIR [--n N] [--d D]

Makes the corpus ``chip_smoke.build_corpus`` indexes (the first 105,100
rows of ``SynthSpec(n=106_444, d=2048, n_fields=24, n_components=350,
seed=0)``; ``--n``/``--d`` shrink it to rehearse), then runs Algorithm 1's
three stages at the ``FnsConfig`` defaults (k 32, r_max 96, alpha 1.2,
blocks of 2,048 rows) with the other checkout's module (DIR is a ``src``
directory; ``graph.py`` needs numpy alone, so it loads by path) and then
with this one's: the kNN (``brute_knn``), the symmetrization and the
α-RNG prune of the over-degree rows. Prints one JSON line per version
with each stage's seconds, whether the two graphs' ``neighbors`` and
``degrees`` are equal bit for bit, the host's CPU model and core count,
and the card's name and power limit where ``nvidia-smi`` answers. Host
times move between calls: compare the two versions within one call.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_PAPER, N_INSERT = 105_100, 64 + 256 + 1024   # chip_smoke's corpus


def load_graph(src: pathlib.Path, name: str):
    path = src / "repro_torch" / "core" / "graph.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stages(mod, vectors, k=32, r_max=96, alpha=1.2, block=2048):
    """``build_alpha_knn``'s three stages, each timed; (neighbors,
    degrees, seconds by stage, rows pruned)."""
    t0 = time.perf_counter()
    knn = mod.brute_knn(vectors, k, block=block)
    t1 = time.perf_counter()
    adj = mod._symmetrize(knn)
    t2 = time.perf_counter()
    pruned = 0
    for i in range(len(adj)):
        if adj[i].size > r_max:
            adj[i] = mod._alpha_rng_prune(i, adj[i], vectors, r_max, alpha)
            pruned += 1
    t3 = time.perf_counter()
    neighbors = np.full((len(adj), max(a.size for a in adj)), -1, np.int32)
    degrees = np.array([a.size for a in adj], np.int32)
    for i, a in enumerate(adj):
        neighbors[i, :a.size] = a
    return neighbors, degrees, {"knn_s": t1 - t0, "symmetrize_s": t2 - t1,
                                "prune_s": t3 - t2, "pruned": pruned}


def host() -> dict:
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            model = next(line.split(":", 1)[1].strip() for line in f
                         if line.startswith("model name"))
    except (OSError, StopIteration):
        pass
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = "none"
    return {"cpu": model, "cores": os.cpu_count(), "card": card}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's src directory")
    ap.add_argument("--n", type=int, default=N_PAPER)
    ap.add_argument("--d", type=int, default=2048)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.synth import SynthSpec, make_dataset

    t = time.time()
    vectors = make_dataset(SynthSpec(
        n=args.n + N_INSERT, d=args.d, n_fields=24, n_components=350,
        seed=0)).vectors[:args.n]
    print(json.dumps({"phase": "data", "n": args.n, "d": args.d,
                      "s": time.time() - t, **host()}), flush=True)
    out = {}
    for label, src in (("other", pathlib.Path(args.other)),
                       ("this", ROOT / "src")):
        mod = load_graph(src.resolve(), f"graph_{label}")
        t = time.time()
        nb, deg, times = stages(mod, vectors)
        out[label] = (nb, deg)
        print(json.dumps({"phase": "graph", "version": label,
                          "src": str(src), "graph_s": time.time() - t,
                          **times, "edges": int(deg.sum())}), flush=True)
    equal = all(np.array_equal(a, b) for a, b in zip(out["other"],
                                                     out["this"]))
    print(json.dumps({"phase": "equal", "neighbors_and_degrees": equal}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
