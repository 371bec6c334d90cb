"""The rate sweep that fixes an open cell's rate: one set-up, then the
cell's open loop at each of ``--rates`` in turn, each drained before the
next, in one process.

    python3 fnsbench/sweep.py --workload <open cell> --seed <n> --seconds <s> --rates <r> [<r> ...]

Prints one JSON line a rate: the rate offered, the rate answered inside
the window, the backlog left at its close (requests due but not yet
answered) against the backlog a quarter into it, the latency's median
and 95th percentile from due time, the mean batch and how late the loop
sent requests. The knee is the highest rate whose backlog does not grow;
the cell runs at four fifths of it (PERF.md).
"""
import argparse
import copy
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def backlog(due, done, t) -> int:
    """Requests due by ``t`` and not answered by ``t``."""
    return int(((due <= t) & ~(done <= t)).sum())


def one_rate(cell, s, seed, seconds, rate, dev) -> dict:
    import numpy as np
    from fnsbench import harness
    wl = copy.deepcopy(cell.workload)
    wl["rate"] = rate
    dispatches = []
    s["svc"].dispatch_batch, s["svc"].collect_batch = s["plain"]
    harness.instrument(s["svc"], dispatches, [])
    win = harness.drive(cell.loop, wl, s["svc"], s["pool"], s["preds"], seed,
                        seconds, dev)
    due = np.asarray(win.due)
    done = np.asarray([t.t_done if t.done else np.nan for t in win.tickets])
    sub = np.asarray(win.submitted)
    t0, t1 = win.t0, win.t_end
    lat = (done - due)[due < t1] * 1e3
    d = np.asarray(dispatches).reshape(-1, 4)
    d = d[d[:, 0] < t1]
    return {"rate": rate, "answered_per_s": float(
                ((done >= t0) & (done <= t1)).sum() / seconds),
            "backlog_quarter": backlog(due, done, t0 + seconds / 4),
            "backlog_close": backlog(due, done, t1),
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p95_ms": float(np.percentile(lat, 95)),
            "mean_batch": float(d[:, 2].mean()) if len(d) else 0.0,
            "dispatch_ms": float((d[:, 1] - d[:, 0]).mean() * 1e3)
            if len(d) else 0.0,
            "late_p95_ms": float(np.percentile((sub - due) * 1e3, 95))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from fnsbench import bench, harness
    cell = bench.Bench().cell(args.workload)
    dev = torch.device("cuda:0")
    t = time.perf_counter()
    s = harness.setup(cell, args.seed, dev, lambda *a, **k: None)
    s["plain"] = (s["svc"].dispatch_batch, s["svc"].collect_batch)
    print(json.dumps({"setup_s": time.perf_counter() - t,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    for rate in args.rates:
        print(json.dumps(one_rate(cell, s, args.seed, args.seconds, rate,
                                  dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
