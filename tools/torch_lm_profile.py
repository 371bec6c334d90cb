#!/usr/bin/env python3
"""Where the LM path's time goes on the card.

    PYTHONPATH=src python3 tools/torch_lm_profile.py [--arch smollm-135m]
        [--device cuda] [--reduced] [--src DIR]

At the arch's published widths (random weights from ``init_params``,
seed 0): one ``encode`` of 256 documents of 64 tokens (the ``rag`` path's
corpus batch), one of 64 prompts (its query batch) and one greedy
``ServeEngine.generate`` (batch 4, prompt 32, 16 new tokens, the
``launch/serve.py`` defaults) and one ``decode_step`` of that batch
after its prompt's ``prefill``. Each is timed by host clock around calls
that end in a synchronise (median of 5, after a warm-up), then traced once
under ``torch.profiler``: the device's busy share (the kernels' device
time over the traced wall time, ``chip_smoke.kernel_device_us``) and the
torch ops whose kernels took the most device time.
Prints one JSON line per measurement, each with the card's name and
power limit. ``--device cpu --reduced`` rehearses it on the host (host
times only; no device figure). ``--src`` picks the package to load
(``src`` of this checkout by default; point it at another checkout's
``src`` to run that version, in its own process, inside the same call).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def card_line(dev) -> str:
    if dev.type != "cuda":
        return "host (no card)"
    return subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import kernel_device_us
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.transformer import (ShardEnv, decode_step, encode,
                                                init_params, prefill)
    from repro_torch.serve.engine import ServeEngine
    dev = torch.device(args.device)
    cfg = (reduced_config if args.reduced else get_config)(args.arch)
    env = ShardEnv(None)
    params = init_params(cfg, seed=0, device=dev)
    card = card_line(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    docs = TokenPipeline(cfg.vocab_size, 256, 64, seed=0).get_batch(0)
    docs = torch.from_numpy(docs["tokens"]).to(dev)
    eng = ServeEngine(cfg, env, params, device=dev)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    _, cache = prefill(params, {"tokens": prompt}, cfg, env, cache_len=48)
    step = {"tokens": prompt[:, :1]}
    cases = {
        "encode_256x64": lambda: encode(params, {"tokens": docs}, cfg, env),
        "encode_64x64": lambda: encode(params, {"tokens": docs[:64]}, cfg,
                                       env),
        "generate_4x32_new16": lambda: eng.generate(prompt, max_new=16),
        # each call writes the same slot of one cache
        "decode_step_4x1": lambda: decode_step(params, cache, step, cfg, env),
    }
    for name, fn in cases.items():
        fn()
        sync()
        times = []
        for _ in range(5):
            t = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        rec = {"case": name, "arch": cfg.name, "layers": cfg.n_layers,
               "d": cfg.d_model, "host_ms": statistics.median(times),
               "device": str(dev), "card": card,
               "src": os.path.relpath(os.path.abspath(args.src), ROOT)}
        if dev.type == "cuda":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                sync()
            events = prof.key_averages()
            busy = kernel_device_us(prof)
            wall = (max(e.time_range.end for e in prof.events())
                    - min(e.time_range.start for e in prof.events()))
            # the torch ops (host-side rows), each with its kernels' time
            ops = sorted((e for e in events if e.device_type.name == "CPU"),
                         key=lambda e: -e.self_device_time_total)
            rec.update(
                traced_wall_ms=wall / 1e3, device_busy_ms=busy / 1e3,
                device_busy_share=busy / wall,
                kernels=sum(e.count for e in events
                            if e.device_type.name == "CUDA"),
                op_rows_device_ms=sum(e.self_device_time_total
                                      for e in ops) / 1e3,
                top_ops=[dict(name=e.key, self_device_ms=(
                    e.self_device_time_total / 1e3), calls=e.count)
                         for e in ops[:8]])
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
