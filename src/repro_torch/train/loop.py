"""Fault-tolerant training loop.

Production behaviors implemented and tested:
* checkpoint/restart: periodic atomic checkpoints; on start, resume from the
  latest complete one; the step-indexed data pipeline makes resume exact;
* preemption handling: SIGTERM/SIGUSR1 set a flag, the loop checkpoints at
  the next step boundary and exits cleanly (cluster eviction pattern);
* straggler detection: rolling step-time watermarks; steps slower than
  ``straggler_factor`` x p50 are logged with their step index;
* async checkpoint writes off the critical path, one in flight at a time.

A checkpoint holds {"params", "opt"} in the reference's on-disk layout
(``interop.tree_to_reference``: layer leaves stacked under a leading L,
the keys of ``jax.tree_util.tree_flatten_with_path``; placed leaves
gathered), so either package resumes the other's, and a run on one mesh
resumes on another. The step function is functional (it returns new
parameters and state), so the loop holds its own and the caller's
``params`` are never changed.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Callable

import numpy as np

from repro_torch import interop
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.optim.adamw import leaves


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep: int = 3
    async_ckpt: bool = True
    straggler_factor: float = 3.0
    log_every: int = 10


class TrainLoop:
    def __init__(self, cfg: LoopConfig, train_step: Callable, pipeline,
                 params, opt_state, put_batch: Callable | None = None):
        self.cfg = cfg
        self.train_step = train_step
        self.pipeline = pipeline
        self.params = params
        self.opt_state = opt_state
        self.put_batch = put_batch or (lambda b: b)
        self.metrics_log: list[dict] = []
        self.step_times: list[float] = []
        self.stragglers: list[int] = []
        self._preempted = False
        self._ckpt_thread = None

    # -- preemption -----------------------------------------------------------
    def _handle_preempt(self, signum, frame):  # noqa: ARG002
        self._preempted = True

    def install_signal_handlers(self):
        signal.signal(signal.SIGTERM, self._handle_preempt)
        signal.signal(signal.SIGUSR1, self._handle_preempt)

    # -- checkpoint -----------------------------------------------------------
    def _save(self, step: int):
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()  # one in flight at a time
        tree = interop.tree_to_reference({"params": self.params,
                                          "opt": self.opt_state})
        self._ckpt_thread = ckpt_lib.save(
            self.cfg.ckpt_dir, step, tree,
            asynchronous=self.cfg.async_ckpt, keep=self.cfg.keep)

    def try_resume(self, shardings=None) -> int:
        """Resume from the newest checkpoint in ``ckpt_dir`` (the port's or
        the reference's, saved from any mesh or none) onto where the
        loop's parameters and state live: their device, or, placed, their
        mesh and layout; returns its step, 0 when there is none.
        ``shardings``: {"params", "opt"} of ``NamedSharding``s in the
        reference's stacked layout (``param_shardings`` and
        ``opt_shardings`` of ``interop.reference_shapes``), which place
        every leaf instead (elastic resume onto that mesh, whose
        ``MeshParams`` the loop's parameters already are)."""
        latest = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if latest is None:
            return 0
        state = {"params": self.params, "opt": self.opt_state}
        tree, step = ckpt_lib.restore(self.cfg.ckpt_dir, latest,
                                      interop.reference_shapes(state))
        first = leaves(self.params)[0]
        out = interop.tree_from_reference(
            tree, state, getattr(first, "device", None), shardings)
        self.params, self.opt_state = out["params"], out["opt"]
        return step

    # -- main loop ------------------------------------------------------------
    def run(self, start_step: int = 0) -> dict:
        preempt_saved = False
        step = start_step
        for step in range(start_step, self.cfg.total_steps):
            t0 = time.time()
            batch = self.put_batch(self.pipeline.get_batch(step))
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])  # blocks: keeps timing honest
            dt = time.time() - t0
            self.step_times.append(dt)
            if len(self.step_times) >= 8:
                p50 = float(np.median(self.step_times[-64:]))
                if dt > self.cfg.straggler_factor * p50:
                    self.stragglers.append(step)
            if step % self.cfg.log_every == 0:
                self.metrics_log.append(
                    {"step": step, "loss": loss, "dt": dt,
                     "grad_norm": float(metrics["grad_norm"])})
            if (step + 1) % self.cfg.ckpt_every == 0:
                self._save(step + 1)
            if self._preempted:
                self._save(step + 1)
                preempt_saved = True
                break
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
        return {"last_step": step + 1, "preempted": preempt_saved,
                "stragglers": self.stragglers, "metrics": self.metrics_log}
