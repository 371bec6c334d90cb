"""Arithmetic from a run's record to its metrics, shared by the readers in
``metrics/``. A function returns None where the record holds nothing to
read, and the metric is then left out of the result line.
"""
from __future__ import annotations

import numpy as np

from fnsbench import peaks, trace as trace_mod


def due_in_window(rec) -> np.ndarray:
    return (rec.due >= rec.t0) & (rec.due < rec.t1)


def qps(rec):
    if not rec.closed_loop:
        return None
    done = (rec.done >= rec.t0) & (rec.done <= rec.t1)
    return float(done.sum() / (rec.t1 - rec.t0))


def latency_p95_ms(rec):
    """From each request's due time to its results, over every request
    due in the window; one never answered counts as infinitely late."""
    sel = due_in_window(rec)
    if rec.closed_loop or not sel.any():
        return None
    lat = np.where(np.isnan(rec.done), np.inf, rec.done - rec.due)[sel]
    return float(np.percentile(lat, 95) * 1e3)


def host_dispatches(rec) -> np.ndarray:
    """Dispatches started in the window before the traced stretch (the
    profiler slows the host), as rows (start, end, q_real, q_padded)."""
    d = rec.dispatches
    end = rec.t1 if rec.traced_from is None else rec.traced_from
    return d[(d[:, 0] >= rec.t0) & (d[:, 0] < end)]


def dispatch_ms(rec, closed: bool):
    d = host_dispatches(rec)
    if rec.closed_loop != closed or not len(d):
        return None
    return float(np.mean(d[:, 1] - d[:, 0]) * 1e3)


def batch_size(rec, closed: bool):
    d = host_dispatches(rec)
    if rec.closed_loop != closed or not len(d):
        return None
    return float(np.mean(d[:, 2]))


def queue_wait_ms(rec, closed: bool):
    """Median from a request's due time to the start of the dispatch that
    took it. The admission queue cuts batches in arrival order, so the
    i-th request submitted went out in the dispatch whose cumulative
    size first exceeds i."""
    if rec.closed_loop != closed or not len(rec.dispatches):
        return None
    edges = np.cumsum(rec.dispatches[:, 2])
    which = np.searchsorted(edges, np.arange(len(rec.due)), side="right")
    ok = which < len(rec.dispatches)
    start = np.full(len(rec.due), np.nan)
    start[ok] = rec.dispatches[which[ok], 0]
    end = rec.t1 if rec.traced_from is None else rec.traced_from
    sel = due_in_window(rec) & ok & (start < end)
    if not sel.any():
        return None
    return float(np.median(start[sel] - rec.due[sel]) * 1e3)


def window_collects(rec) -> np.ndarray:
    """Rows (q_real, hops, rounds) of the batches dispatched in the
    window."""
    d, c = rec.dispatches, rec.collects
    return c[(d[:len(c), 0] >= rec.t0) & (d[:len(c), 0] < rec.t1)]


def hops_per_query(rec, closed: bool):
    c = window_collects(rec)
    if rec.closed_loop != closed or not c[:, 0].sum():
        return None
    return float(c[:, 1].sum() / c[:, 0].sum())


def rounds_per_batch(rec, closed: bool):
    c = window_collects(rec)
    if rec.closed_loop != closed or not len(c):
        return None
    return float(c[:, 2].mean())


def kernel_ms_per_batch(rec, names, batch_names, closed: bool):
    """Device ms of the kernels ``names`` over the traced batches, a batch
    counted by its one launch of a kernel in ``batch_names``."""
    t = rec.trace
    if rec.closed_loop != closed or t is None:
        return None
    s, _ = t.op_seconds(names)
    _, batches = t.op_seconds(batch_names)
    if not batches or not s:
        return None
    return s / batches * 1e3


def k1_roofline(rec, names, closed: bool):
    """K1's bound over its device time, in %: each traced launch's bytes
    from its batch's padded size (the dispatches in the traced stretch,
    in order; their mean where the counts differ)."""
    t = rec.trace
    if rec.closed_loop != closed or t is None:
        return None
    secs, launches = t.op_seconds(names)
    d = rec.dispatches
    q = d[(d[:, 0] >= rec.traced_from) & (d[:, 0] < rec.t1), 3]
    if not launches or not secs or not len(q):
        return None
    per = [peaks.k1_bytes(rec.n_rows, rec.n_fields, int(x)) for x in q]
    n_bytes = sum(per) if len(per) == launches else np.mean(per) * launches
    return 100.0 * peaks.bound_s(n_bytes) / secs


def device_idle_pct(rec, closed: bool):
    if rec.closed_loop != closed:
        return None
    return trace_mod.idle_pct(rec.trace)
