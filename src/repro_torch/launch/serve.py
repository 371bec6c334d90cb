"""Serving launcher CLI: batched generation with a dense, moe, hybrid or
ssm arch (a frontend arch, internvl2 or whisper, is refused).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --full   # SmolLM-135M
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --device cpu

Runs on CUDA unless ``--device`` names another device, as the reference
does on a local mesh: ``ShardEnv(make_local_mesh())``, one cell on that
device. Weights are random (``init_params`` with seed 0). Prints the
timed second call's tokens/s and the first generated ids.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.transformer import ShardEnv, init_params
from repro_torch.serve.engine import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true",
                    help="the arch's published config (default: reduced)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    if cfg.frontend != "none":
        raise SystemExit(f"{args.arch} needs a modality frontend; use the "
                         "rag_serve example for embedding workloads")
    env = ShardEnv(make_local_mesh(devices=[args.device]))
    eng = ServeEngine(cfg, env, init_params(cfg, 0, args.device))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    eng.generate(toks, max_new=args.new)  # warm-up
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.time()
    out = eng.generate(toks, max_new=args.new).cpu().numpy()
    dt = time.time() - t0
    print(f"{args.arch} on {eng.device}: generated {args.batch}x{args.new} "
          f"tokens in {dt * 1000:.0f} ms ({args.batch * args.new / dt:.1f} "
          f"tok/s)")
    print(out[:, :8])


if __name__ == "__main__":
    main()
