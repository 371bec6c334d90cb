"""Fault-tolerant training example on the PyTorch port, as
``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 60
    PYTHONPATH=src python examples/torch_train_lm.py --arch smollm-135m \
        --full --steps 300   # the ~100M-param end-to-end run
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu

Trains on ``--device`` (CUDA unless told otherwise; no CUDA raises) on a
one-cell local mesh, as ``launch/train.py`` does. Weights are random
(``init_params`` with seed 0). Resumable: re-running with the same
--ckpt-dir resumes from the latest checkpoint and regenerates identical
data batches (step-indexed pipeline).
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.shardings import opt_shardings
from repro_torch.models.transformer import (ShardEnv, init_params,
                                            place_params)
from repro_torch.optim.adamw import (AdamWConfig, init_opt_state,
                                     make_train_step)
from repro_torch.train.loop import LoopConfig, TrainLoop

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")


def train(cfg, params, *, name: str, steps: int = 60, batch: int = 8,
          seq: int = 128, ckpt_dir: str = CKPT_DIR,
          device="cuda") -> dict:
    """Train ``params`` (``name`` labels the printed parameter count)
    ``steps`` steps of ``batch`` x ``seq`` tokens on ``device``, resuming
    from the newest checkpoint in ``ckpt_dir`` and checkpointing every 25
    steps. Prints the reference's lines; returns ``TrainLoop.run``'s
    result with the step it started from and every step's seconds."""
    env = ShardEnv(make_local_mesh(devices=[device]))
    params = place_params(params, env)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{name}: {n_params/1e6:.1f}M params")
    opt = init_opt_state(params, opt_shardings(
        cfg, env.mesh, {"m": params, "v": params, "step": None}, env.policy))
    step = make_train_step(cfg, env, AdamWConfig(
        peak_lr=3e-3, warmup_steps=20, total_steps=steps))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch=batch,
                         seq_len=seq, seed=0, frontend=cfg.frontend,
                         d_model=cfg.d_model)
    loop = TrainLoop(LoopConfig(total_steps=steps, ckpt_every=25,
                                ckpt_dir=ckpt_dir, log_every=5),
                     step, pipe, params, opt)
    loop.install_signal_handlers()
    start = loop.try_resume()
    if start:
        print(f"resumed from step {start}")
    out = loop.run(start_step=start)
    for m in out["metrics"]:
        print(f"step {m['step']:4d} loss {m['loss']:.4f} "
              f"({m['dt']*1000:.0f} ms)")
    print(f"done at step {out['last_step']}; stragglers flagged: "
          f"{len(out['stragglers'])}")
    return {**out, "start": start, "step_times": loop.step_times}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    return train(cfg, init_params(cfg, 0, args.device),
                 name=f"{args.arch}{' (reduced)' if not args.full else ''}",
                 steps=args.steps, batch=args.batch, seq=args.seq,
                 ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
