"""One run of one cell: data and index from the seed, warm-up, the timed
window over ``ServePipeline``, the drain, the comparison with the
reference, and the metrics.

The window drives the cell's traffic module (``traffic/<loop>.py``)
through a ``Window``: the module submits requests as they fall due and
pumps the pipeline; the harness stamps each request's due, submit and
answer times, and wraps the service's ``dispatch_batch`` and
``collect_batch`` to stamp each batch (its host time, its size, the
engine's hop and round counters). With ``trace`` the last ``TRACE_S``
seconds of the window run under ``torch.profiler``.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from fnsbench import program
from fnsbench.data import pool as pool_mod
from fnsbench.reference import judge as judge_mod
from fnsbench.trace import DeviceTrace, Stretch, warm_profiler

CLOCK = time.perf_counter
TRACE_S = 4.0
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (``sys.modules`` unless given) whose top-level name
    is JAX's or the JAX package's: the whole name before the first dot,
    so ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class ForbiddenImport(RuntimeError):
    pass


def guard(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"{when}: loaded {', '.join(found)}")


@dataclasses.dataclass
class Record:
    """What a run saw; times on the host's ``CLOCK`` in seconds."""

    closed_loop: bool
    t0: float
    t1: float
    due: np.ndarray
    submit: np.ndarray
    done: np.ndarray              # nan where never answered
    entry: np.ndarray             # pool index of each request
    dispatches: np.ndarray        # (start, end, q_real, q_padded) a batch
    collects: np.ndarray          # (q_real, hops, rounds) a batch
    traced_from: float | None
    trace: DeviceTrace | None
    setup_s: float
    recall: float
    n_rows: int
    n_fields: int
    k: int


class Window:
    """What a traffic module drives: ``start`` opens the window,
    ``submit`` sends the next request of the seeded order, ``pump`` runs
    the pipeline one turn, ``pop_done`` counts the requests answered
    since it last looked (answers come back in submission order)."""

    def __init__(self, pipe, vectors, preds, order, seconds, stretch_at,
                 dev):
        self.pipe, self.vectors, self.preds = pipe, vectors, preds
        self.order, self.seconds = order, seconds
        self.clock = CLOCK
        self.stretch_at = stretch_at     # seconds into the window, or None
        self.stretch = None
        self.dev = dev
        self.t0 = self.t_end = None
        self.due, self.submitted, self.entries, self.tickets = [], [], [], []
        self._open = collections.deque()

    def start(self) -> float:
        self.t0 = CLOCK()
        self.t_end = self.t0 + self.seconds
        if self.stretch_at is not None:
            self.stretch = Stretch(self.t0 + self.stretch_at, self.dev)
        return self.t0

    def submit(self, t_due: float) -> None:
        e = int(self.order[len(self.tickets) % len(self.order)])
        t = self.pipe.submit(self.vectors[e], self.preds[e])
        self.due.append(t_due)
        self.submitted.append(CLOCK())
        self.entries.append(e)
        self.tickets.append(t)
        self._open.append(t)

    def pump(self, now: float) -> None:
        if self.stretch is not None:
            self.stretch.tick(now, CLOCK)
        self.pipe.pump()

    def pop_done(self) -> int:
        n = 0
        while self._open and self._open[0].done:
            self._open.popleft()
            n += 1
        return n


def instrument(svc, dispatches: list, collects: list) -> None:
    """Stamp every batch at the service's boundary."""
    dispatch, collect = svc.dispatch_batch, svc.collect_batch

    def dispatch_batch(vectors, predicates, **kw):
        t = CLOCK()
        with torch.profiler.record_function("fnsbench.dispatch_batch"):
            ticket = dispatch(vectors, predicates, **kw)
        q_pad = ticket.get("q_padded", len(predicates)) if isinstance(
            ticket, dict) else len(predicates)
        dispatches.append((t, CLOCK(), len(predicates), q_pad))
        return ticket

    def collect_batch(ticket):
        with torch.profiler.record_function("fnsbench.collect_batch"):
            ids, stats = collect(ticket)
        collects.append((len(ids), int(np.sum(stats.get("hops", 0))),
                         int(stats.get("rounds", 0))))
        return ids, stats

    svc.dispatch_batch, svc.collect_batch = dispatch_batch, collect_batch


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(cell, seed: int, dev: torch.device, log,
          trace: bool = False) -> dict:
    """Corpus, pool, service and warm-up: everything before the window."""
    cfg, wl = cell.config, cell.workload
    rc = cfg["recipe"]
    t = CLOCK()
    corpus = pool_mod.make_corpus(rc)
    pool = pool_mod.make_pool(corpus, cell.mix, wl["pool"], seed,
                              rc["noise_scale"])
    split = {"data_s": CLOCK() - t}
    knobs = {**cfg["knobs"], **{f"serve.{k}": v
                                for k, v in wl["serve"].items()}}
    svc = program.build_service(corpus, knobs, dev, split)
    preds = [program.port_predicate(p) for p in pool.preds]
    t = CLOCK()
    for b in cell.loop.buckets(wl):
        svc.query_batch(pool.vectors[:b], preds[:b])
    sync(dev)
    split["warm_s"] = CLOCK() - t
    if trace:
        t = CLOCK()
        warm_profiler(dev)
        split["profiler_s"] = CLOCK() - t
    log("setup", **split)
    return dict(corpus=corpus, pool=pool, svc=svc, preds=preds, split=split)


def drive(loop, wl: dict, svc, pool, preds, seed: int, seconds: float,
          dev: torch.device, stretch_at: float | None = None) -> Window:
    """Traffic module ``loop`` over a new pipeline for ``seconds``, then
    the drain."""
    pipe = program.pipeline(svc, CLOCK)
    order = pool_mod.stream(seed, "requests").permutation(len(pool))
    win = Window(pipe, pool.vectors, preds, order, seconds, stretch_at, dev)
    # The window keeps every ticket for the comparison, hundreds of
    # thousands of objects that the cyclic collector would rescan in
    # pauses of up to 0.3 s (seen as a 0.3 s submit in a closed loop):
    # a cost of the harness's bookkeeping, not of the system.
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        loop.run(win, wl, pool_mod.stream(seed, "arrivals"))
        if win.stretch is not None:
            win.stretch.finish(CLOCK)
        pipe.drain()
        sync(dev)
    finally:
        gc.enable()
        gc.unfreeze()
    return win


def window(cell, s: dict, seed: int, seconds: float, trace: bool,
           dev: torch.device):
    """The timed window and the drain. Returns the window and the batch
    stamps."""
    dispatches, collects = [], []
    instrument(s["svc"], dispatches, collects)
    win = drive(cell.loop, cell.workload, s["svc"], s["pool"], s["preds"],
                seed, seconds, dev,
                max(seconds - TRACE_S, 0.0) if trace else None)
    return win, np.asarray(dispatches, dtype=np.float64).reshape(-1, 4), \
        np.asarray(collects, dtype=np.float64).reshape(-1, 3)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, log) -> dict:
    """One run; returns the result line's fields (before ``device``)."""
    dev = torch.device(device)
    s = setup(cell, seed, dev, log, trace)
    guard("after set-up")
    win, dispatches, collects = window(cell, s, seed, seconds, trace, dev)
    guard("after the window")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    answers = [t.ids if t.done else None for t in win.tickets]
    errors = [t.error for t in win.tickets]
    done = np.asarray([t.t_done if t.done else np.nan for t in win.tickets],
                      dtype=np.float64)
    corpus, pool, k = s["corpus"], s["pool"], cell.config["knobs"]["walk.k"]
    stretch = win.stretch
    record_args = dict(
        closed_loop=bool(cell.loop.CLOSED), t0=win.t0, t1=win.t_end,
        due=np.asarray(win.due), submit=np.asarray(win.submitted), done=done,
        entry=np.asarray(win.entries, dtype=np.int64), dispatches=dispatches,
        collects=collects,
        traced_from=stretch.host[0] if stretch and stretch.host else None,
        trace=stretch.trace if stretch else None,
        setup_s=win.t0 - t_process, n_rows=corpus.n,
        n_fields=corpus.metadata.shape[1], k=k)
    split = s["split"]
    del s, win
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = CLOCK()
    vectors = torch.from_numpy(corpus.vectors).to(dev)
    meta = torch.from_numpy(corpus.metadata).to(dev)
    checks, recall, readings = judge_mod.judge(
        vectors, meta, pool.vectors, pool.preds, record_args["entry"],
        answers, errors, k, cell.config["limits"])
    sync(dev)
    readings["reference_s"] = CLOCK() - t
    rec = Record(recall=recall, **record_args)

    # a traced run reports the per-layer metrics only: the profiler slows
    # the host, so its end-to-end readings are not the cell's
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.readers[m["name"]](rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    n_failed = (checks["unanswered"][0] + checks["errors"][0])
    out = {"correct": judge_mod.verdict(checks),
           "attempted": len(answers), "failed": int(n_failed),
           "metrics": metrics, "memory_peak_bytes": int(peak),
           "setup_split": split, "readings": readings,
           "generator": generator_lateness(rec), "checks": checks}
    if trace and rec.trace is not None:
        out["busy_s"] = rec.trace.busy_s
        out["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    return out


def generator_lateness(rec: Record) -> dict:
    """How late requests were sent after they fell due, in ms."""
    late = (rec.submit - rec.due) * 1e3
    if not len(late):
        return {}
    return {"p95_ms": float(np.percentile(late, 95)),
            "max_ms": float(late.max())}
