"""Admission queue + double-buffered serve pipeline (DESIGN.md §13).

``query_batch`` is synchronous: pack, dispatch, block on the host sync.
That caps a serving process at one batch per mesh — the host sits idle
while the device walks, and the device sits idle while the host packs.
This module adds the two pieces that turn the engine's
``dispatch``/``collect`` split into an actual serving loop:

* ``AdmissionQueue`` — the batch former. Arrivals are ticketed and
  accumulate until the pending count fills a ``serve.queue_max_batch``
  bucket OR the oldest ticket has waited ``serve.queue_budget_ms``,
  whichever comes first (classic size-or-deadline batching). Bucket
  targets follow ``query_batch``'s power-of-two rule, rounded up to a
  multiple of ``q_lanes``, the serving engine's query-lane count on a
  2D mesh (1 without one).

* ``ServePipeline`` — the pump. Holds up to ``serve.queue_depth`` batches
  in flight: batch N+1's forming + predicate compilation + pack (host
  work, ``RetrievalService.dispatch_batch``) runs while batch N is still
  resident on the device, and ``collect_batch`` only syncs when the
  window is full. Each dispatch is fenced against the engine's publish
  generation, so a maintenance-loop swap can't land mid-flight.

The clock is injectable so tests drive the deadline logic deterministically.

On the card the engines' ``dispatch`` queues the whole search without a
host sync (its restart rounds are gated on the device, each walk round is
one kernel launch, and the pack stages through pinned memory), so
``dispatch_batch`` returns while batch N is still on the device and batch
N+1 is formed and packed meanwhile; ``collect_batch``'s copy of the
results is a batch's one sync.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.core.config import ServeConfig


@dataclasses.dataclass
class Ticket:
    """One admitted query and its lifecycle: filled in place at collect
    time, with admission/completion stamps for sojourn (SLO) accounting."""

    vector: np.ndarray
    predicate: object
    t_admit: float
    ids: np.ndarray | None = None
    error: str | None = None
    done: bool = False
    t_done: float | None = None

    @property
    def sojourn_ms(self) -> float | None:
        """Admission-to-result latency — the number the p50/p99 SLO rows
        in BENCH_search.json measure."""
        if self.t_done is None:
            return None
        return (self.t_done - self.t_admit) * 1e3


class AdmissionQueue:
    """Size-or-deadline batch former over ticketed arrivals."""

    def __init__(self, scfg: ServeConfig | None = None, *,
                 q_lanes: int = 1, clock=time.monotonic):
        self.scfg = scfg if scfg is not None else ServeConfig()
        self.q_lanes = max(1, int(q_lanes))
        self.clock = clock
        self._pending: deque[Ticket] = deque()

    def admit(self, vector, predicate) -> Ticket:
        t = Ticket(np.asarray(vector), predicate, self.clock())
        self._pending.append(t)
        return t

    def __len__(self) -> int:
        return len(self._pending)

    def oldest_wait_ms(self) -> float:
        if not self._pending:
            return 0.0
        return (self.clock() - self._pending[0].t_admit) * 1e3

    def bucket_target(self, q_real: int) -> int:
        """The padded batch size ``q_real`` arrivals dispatch at: next
        power of two, at least ``serve.min_bucket``, rounded up to a
        multiple of the query-lane count (DESIGN.md §13)."""
        target = max(self.scfg.min_bucket, 1 << (q_real - 1).bit_length())
        return -(-target // self.q_lanes) * self.q_lanes

    def poll(self, force: bool = False) -> list[Ticket] | None:
        """Cut the next batch, or None when neither trigger has tripped:
        a full ``serve.queue_max_batch`` bucket, an oldest-ticket wait of
        ``serve.queue_budget_ms``, or an explicit ``force`` (drain)."""
        n = len(self._pending)
        if n == 0:
            return None
        full = n >= self.scfg.queue_max_batch
        due = self.oldest_wait_ms() >= self.scfg.queue_budget_ms
        if not (full or due or force):
            return None
        take = min(n, self.scfg.queue_max_batch)
        return [self._pending.popleft() for _ in range(take)]


class ServePipeline:
    """Double-buffered admission→dispatch→collect pump over a
    ``RetrievalService``.

    ``submit`` tickets a query; ``pump`` stages any due batch through
    ``dispatch_batch`` and syncs the OLDEST in-flight batch only once
    ``serve.queue_depth`` batches are in flight, so with the default
    depth 2 batch N+1 is staged before batch N's results are fetched.
    ``events`` logs ``(name, batch_no, t)`` for every dispatch and
    collect.
    """

    def __init__(self, service, *, clock=time.monotonic):
        self.service = service
        scfg = service._cfg().serve
        eng = service._live_engine()
        self.queue = AdmissionQueue(scfg,
                                    q_lanes=getattr(eng, "q_lanes", 1),
                                    clock=clock)
        self.depth = max(1, scfg.queue_depth)
        self.clock = clock
        self._inflight: deque[tuple[int, list[Ticket], dict]] = deque()
        self.events: list[tuple[str, int, float]] = []
        self.batches = 0

    def submit(self, vector, predicate) -> Ticket:
        return self.queue.admit(vector, predicate)

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def _stage(self, batch: list[Ticket]) -> None:
        no = self.batches
        self.batches += 1
        self.events.append(("dispatch", no, self.clock()))
        vecs = np.stack([t.vector for t in batch])
        ticket = self.service.dispatch_batch(vecs,
                                             [t.predicate for t in batch])
        self._inflight.append((no, batch, ticket))

    def _collect_oldest(self) -> int:
        no, batch, ticket = self._inflight.popleft()
        ids, stats = self.service.collect_batch(ticket)
        self.events.append(("collect", no, self.clock()))
        t_done = self.clock()
        errors = stats.get("errors", [None] * len(batch))
        for i, t in enumerate(batch):
            t.ids = ids[i]
            t.error = errors[i]
            t.t_done = t_done
            t.done = True
        return no

    def pump(self, force: bool = False) -> int:
        """One pump turn: stage a due batch (if any), then collect while
        the in-flight window is over depth. Returns batches collected."""
        batch = self.queue.poll(force=force)
        if batch is not None:
            self._stage(batch)
        collected = 0
        while len(self._inflight) >= self.depth:
            self._collect_oldest()
            collected += 1
        return collected

    def drain(self) -> int:
        """Flush everything: force-cut the queue into batches, then
        collect every in-flight batch. Returns batches collected."""
        while len(self.queue):
            self._stage(self.queue.poll(force=True))
        collected = 0
        while self._inflight:
            self._collect_oldest()
            collected += 1
        return collected


def _smoke(device=None) -> None:
    """In-process pipeline smoke: a tiny corpus, more tickets than one
    bucket, pump-until-drained, and results must match the synchronous
    ``query_batch`` path exactly; batch 1 must be staged before batch 0
    is collected. ``device`` None means CUDA."""
    from repro_torch.core.config import FnsConfig
    from repro_torch.core.types import Dataset, FilterPredicate
    from repro_torch.serve.retrieval import RetrievalService

    rng = np.random.default_rng(0)
    n, d = 400, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    meta = rng.integers(0, 4, size=(n, 2)).astype(np.int32)
    ds = Dataset(vecs, meta, ["a", "b"], [4, 4])
    cfg = FnsConfig().with_knobs({"walk.k": 5, "graph.graph_k": 8,
                                  "serve.queue_max_batch": 8,
                                  "serve.queue_budget_ms": 0.0})
    svc = RetrievalService.build(ds, config=cfg, device=device)
    pipe = ServePipeline(svc)
    qs = rng.normal(size=(20, d)).astype(np.float32)
    preds = [FilterPredicate.make({0: (int(i) % 4,)}) for i in range(20)]
    tickets = [pipe.submit(v, p) for v, p in zip(qs, preds)]
    while not all(t.done for t in tickets):
        if pipe.pump() == 0 and len(pipe.queue) == 0:
            pipe.drain()
    assert pipe.batches >= 2, "smoke must exercise >1 in-flight batch"
    ref_ids, _ = svc.query_batch(qs, list(preds))
    for t, ref in zip(tickets, ref_ids):
        assert t.error is None
        np.testing.assert_array_equal(np.sort(t.ids), np.sort(ref))
        assert t.sojourn_ms is not None and t.sojourn_ms >= 0.0
    d_times = {no: t for e, no, t in pipe.events if e == "dispatch"}
    c_times = {no: t for e, no, t in pipe.events if e == "collect"}
    assert d_times[1] < c_times[0], "batch 1 must stage before batch 0 syncs"
    print(f"pipeline smoke OK: {pipe.batches} batches, "
          f"{len(tickets)} tickets, overlap verified")


if __name__ == "__main__":
    _smoke()
