#!/usr/bin/env python3
"""Mesh prefill ms against meshless, for comparing two versions of the
port inside one call on the card.

    PYTHONPATH=src python3 tools/torch_mesh_prefill.py [--src DIR]
        [--device cuda] [--reduced] [--reps 5]

On a 2 x 4 data x model mesh whose eight cells are all on ``--device``
(policy tp, bf16, random weights from ``init_params`` with seed 0):
llama3.2-1b whole at 8 x 512 tokens (``chip_smoke.py``'s lm_mesh case),
and hymba-1.5b cut to 2 layers at 8 x 128 and to 1 layer at 1 x 1,088
(its window plus 64: the batch does not divide the data axis, so the
ring's slots are split over the model axis). Each ``prefill`` is timed
by host clock around a call that ends in a synchronise, after a warm-up;
the median and every run are printed, mesh and meshless, as one JSON
line with the card's name and power limit. A version whose ``prefill``
refuses a case over a mesh gets null there. ``--src`` picks the package
to load (``src`` of this checkout by default; point it at another
checkout's ``src`` to time that version in its own process). ``--device
cpu --reduced`` rehearses it on the host at the reduced configs (host
times only; no device figure).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tf

    dev = "cuda:0" if args.device == "cuda" else args.device
    config = reduced_config if args.reduced else get_config

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    def times(fn):
        fn()
        sync()
        ts = []
        for _ in range(args.reps):
            t = time.time()
            fn()
            sync()
            ts.append((time.time() - t) * 1e3)
        return statistics.median(ts), ts

    def case(cfg, B, S, cache_len=None):
        params = tf.init_params(cfg, seed=0, device=dev)
        env = tf.ShardEnv(make_local_mesh(2, 4, devices=[dev] * 8))
        batch = {"tokens": np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)}
        kw = {} if cache_len is None else {"cache_len": cache_len}
        out = {"batch": B, "prompt": S, "layers": cfg.n_layers}
        try:
            placed = tf.place_params(params, env)
            out["mesh_ms"], out["mesh_runs"] = times(
                lambda: tf.prefill(placed, batch, cfg, env, **kw))
            del placed
        except NotImplementedError as e:
            out["mesh_ms"], out["refused"] = None, str(e).splitlines()[0]
        out["meshless_ms"], out["meshless_runs"] = times(
            lambda: tf.prefill(params, batch, cfg, tf.ONE_DEVICE, **kw))
        del params
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        return out

    hymba = config("hymba-1.5b")
    window = hymba.sliding_window
    rec = {"src": os.path.relpath(os.path.abspath(args.src), ROOT),
           "card": card() if args.device == "cuda" else "host"}
    rec["llama3.2-1b"] = case(config("llama3.2-1b"), 8, 512)
    rec["hymba-1.5b_8"] = case(dataclasses.replace(hymba, n_layers=2),
                               8, 128, 144)
    rec["hymba-1.5b_1"] = case(dataclasses.replace(hymba, n_layers=1),
                               1, window + 64, window + 72)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
