#!/usr/bin/env python3
"""Search ms/batch on the card with two versions of the kernels, in turns.

    python3 tools/torch_search_ab.py --other DIR [--rounds N] [--out PATH]

Needs one CUDA card and ``nvcc``. Builds the smoke's index once on the host
(``chip_smoke.build_corpus``: 105,100 x 2048, a few minutes) and one
``BatchedEngine(device="cuda")``, then times ``search`` on the smoke's four
batches (conjunctive Q=64 and Q=256, OR and range Q=64) with the kernel
wrappers of this checkout (A) and with those of another checkout (B: the
``repro_torch/kernels`` wrappers under DIR, a ``src`` directory, loaded
under other module names with their own ``build`` so that they compile
that checkout's ``csrc``). The engine code is this checkout's for both,
so the comparison holds only when the two differ in ``kernels/`` alone.
Each round runs A, B, B, A; each side runs every batch once to warm up
and once timed (host clock around a search, which ends in a device-to-host
copy). Both sides must return the same ids. Prints one JSON line per
timed search, the medians per side and batch, and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
WRAPPERS = ("filter_eval", "fiber_expand", "masked_cosine_topk", "walk_round")


def load_other(src: pathlib.Path) -> dict:
    """The other checkout's wrapper modules, bound to its own build (those
    it has: a checkout from before ``walk_round`` keeps this one's)."""
    kdir = src / "repro_torch" / "kernels"

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    build = load("other_kernels_build", kdir / "build.py")
    mods = {}
    for name in WRAPPERS:
        if not (kdir / f"{name}.py").exists():
            continue
        mod = load(f"other_kernels_{name}", kdir / f"{name}.py")
        mod.build = build  # the wrappers look `build` up at call time
        mods[name] = mod
    return mods


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's src directory")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_search_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core.batched.engine import BatchedEngine
    from repro_torch.core.config import FnsConfig, WalkConfig
    from repro_torch.kernels import fiber_expand, filter_eval
    from repro_torch.kernels import masked_cosine_topk, ops, walk_round

    sides = {"A": {"filter_eval": filter_eval, "fiber_expand": fiber_expand,
                   "masked_cosine_topk": masked_cosine_topk,
                   "walk_round": walk_round},
             "B": load_other(pathlib.Path(args.other).resolve())}

    def use(side):
        mods = {**sides["A"], **sides[side]}
        ops._fv = mods["filter_eval"]
        ops._fe = mods["fiber_expand"]
        ops._mct = mods["masked_cosine_topk"]
        ops._wr = mods["walk_round"]

    card = chip_smoke.card_line()
    out = []

    def log(phase=None, **kw):
        rec = {"phase": phase, **kw} if phase else kw
        out.append(rec)
        print(json.dumps(rec), flush=True)

    ds, index, _ = chip_smoke.build_corpus(log)
    batches = chip_smoke.make_batches(ds)
    eng = BatchedEngine(index, FnsConfig(walk=WalkConfig(k=chip_smoke.K)),
                        device="cuda", vocab_sizes=ds.vocab_sizes)
    ids_by = {}
    times = {(s, b): [] for s in sides for b in batches}
    for r in range(args.rounds):
        for side in ("A", "B", "B", "A"):
            use(side)
            for name, qs in batches.items():
                eng.search(qs)
                torch.cuda.synchronize()
                t = time.time()
                ids, _ = eng.search(qs)
                ms = (time.time() - t) * 1e3
                times[(side, name)].append(ms)
                prev = ids_by.setdefault(name, ids)
                if not all(np.array_equal(a, b) for a, b in zip(prev, ids)):
                    print(f"torch_search_ab: {name}: ids differ between "
                          f"sides", file=sys.stderr)
                    return 1
                log(round=r, side=side, batch=name, ms_per_batch=ms)
    summary = {f"{s}/{b}": statistics.median(v) for (s, b), v in
               times.items()}
    log(medians=summary, card=card)
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "records": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
