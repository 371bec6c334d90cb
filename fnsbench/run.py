"""Run one cell of the benchmark once, on the card.

    python3 fnsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's corpus from its configuration's recipe and its query
pool, request order and arrivals from ``--seed``, builds and warms ``repro_torch``'s ``RetrievalService`` on ``cuda:0``, drives
``ServePipeline`` for ``--seconds``, drains it, judges every answer
against the plain reference, and prints one JSON line last: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics from a
profiled stretch (``--trace 1``), ``correct`` and each number compared
beside its limit. Exits non-zero, printing no result, without a card, or
if JAX or the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import ast  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

REFERENCE_BANNED = {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def reference_imports() -> set[str]:
    """Top-level names the reference's sources import."""
    names = set()
    for path in (ROOT / "fnsbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
    return names


def log(what: str, **kw) -> None:
    print(json.dumps({"log": what, **kw}), file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    banned = reference_imports() & REFERENCE_BANNED
    if banned:
        print(f"fnsbench/reference imports {sorted(banned)}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    from fnsbench import bench, harness
    cell = bench.Bench().cell(args.workload)
    try:
        out = harness.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda:0", T_PROCESS, log)
        harness.guard("before the result")
    except harness.ForbiddenImport as e:
        print(f"forbidden import {e}", file=sys.stderr)
        return 4
    checks = out.pop("checks")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": out.pop("memory_peak_bytes")}
    if args.trace:
        device["busy_s"] = out.pop("busy_s", 0.0)
        device["window_s"] = out.pop("window_s", 0.0)
    line = {"correct": out.pop("correct"), "attempted": out.pop("attempted"),
            "failed": out.pop("failed"), "metrics": out.pop("metrics"),
            "device": device, **out,
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
