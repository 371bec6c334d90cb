"""Training launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 50 [--full] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.train --full   # SmolLM-135M
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small --full

Runs on CUDA unless ``--device`` names another device, on the
reference's local mesh (``ShardEnv(make_local_mesh())``: one cell, on
``--device``), the parameters placed on it once (``place_params``) and
the optimizer state laid out by ``opt_shardings``. Weights are random
(``init_params`` with seed 0), batches come from the step-indexed
``TokenPipeline`` (stub frame embeddings for whisper), and the loop
resumes from the newest checkpoint in ``--ckpt-dir``, checkpoints every
``--ckpt-every`` steps and on SIGTERM/SIGUSR1.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.shardings import opt_shardings
from repro_torch.models.transformer import (ShardEnv, init_params,
                                            place_params)
from repro_torch.optim.adamw import AdamWConfig, init_opt_state, make_train_step
from repro_torch.train.loop import LoopConfig, TrainLoop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true",
                    help="the arch's published config (default: reduced)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    env = ShardEnv(make_local_mesh(devices=[args.device]))
    params = place_params(init_params(cfg, 0, args.device), env)
    opt = init_opt_state(params, opt_shardings(
        cfg, env.mesh, {"m": params, "v": params, "step": None},
        env.policy))
    step = make_train_step(cfg, env, AdamWConfig(
        peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=args.batch,
                         seq_len=args.seq, seed=0, frontend=cfg.frontend,
                         d_model=cfg.d_model)
    loop = TrainLoop(LoopConfig(total_steps=args.steps,
                                ckpt_every=args.ckpt_every,
                                ckpt_dir=args.ckpt_dir), step, pipe, params,
                     opt)
    loop.install_signal_handlers()
    start = loop.try_resume()
    out = loop.run(start_step=start)
    for m in out["metrics"]:
        print(f"step {m['step']:5d} loss {m['loss']:.4f}")
    print(f"finished at step {out['last_step']} "
          f"(preempted={out['preempted']})")


if __name__ == "__main__":
    main()
