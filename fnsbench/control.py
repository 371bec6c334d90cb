"""The lower-precision control: the reference put in the program's place.

    python3 fnsbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, makes the cell's corpus and query pool as a run does,
answers every query of the pool with the exact filtered top-k computed
in TF32 (the configuration states float32), and judges those answers by
the run's own comparison. ``correct`` has to come out false: its
readings set the upper end of the ``order_gap`` limit (PERF.md). The
benchmark's runs never run this. Prints one JSON line a seed.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]


def control(cell, seed: int, device) -> dict:
    import numpy as np
    import torch
    from fnsbench.data import pool as pool_mod
    from fnsbench.reference import exact, judge
    rc = cell.config["recipe"]
    corpus = pool_mod.make_corpus(rc)
    pool = pool_mod.make_pool(corpus, cell.mix, cell.workload["pool"], seed,
                              rc["noise_scale"])
    dev = torch.device(device)
    vectors = torch.from_numpy(corpus.vectors).to(dev)
    meta = torch.from_numpy(corpus.metadata).to(dev)
    k = cell.config["knobs"]["walk.k"]
    t = time.perf_counter()
    answers = exact.exact_topk(vectors, meta, pool.vectors, pool.preds, k,
                               tf32=True)
    answer_s = time.perf_counter() - t
    checks, _, readings = judge.judge(
        vectors, meta, pool.vectors, pool.preds, np.arange(len(pool)),
        answers, [None] * len(answers), k, cell.config["limits"],
        recall=False)
    return {"seed": seed, "correct": judge.verdict(checks),
            "answer_s": answer_s, "readings": readings,
            "checks": {n: {"value": v, "limit": lim}
                       for n, (v, lim) in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from fnsbench import bench
    cell = bench.Bench().cell(args.workload)
    for seed in args.seeds:
        out = control(cell, seed, "cuda:0")
        out["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
