"""Open loop: independent arrivals at a fixed ``rate`` a second. The
window's arrival count is fixed at rate x seconds and the arrival times
are those of a Poisson process given that count (sorted uniform draws),
so every seed offers the same work in another order. A request's
latency runs from its due time, however late the loop sent it."""
from __future__ import annotations

import numpy as np

CLOSED = False


def buckets(wl: dict) -> list[int]:
    """Every padded size from the smallest bucket to the largest batch."""
    s = wl["serve"]
    out, b = [], s["min_bucket"]
    while b < s["queue_max_batch"]:
        out.append(b)
        b *= 2
    return out + [s["queue_max_batch"]]


def run(win, wl: dict, rng) -> None:
    n = int(round(wl["rate"] * win.seconds))
    offsets = np.sort(rng.uniform(0.0, win.seconds, n))
    t0 = win.start()
    due = t0 + offsets
    i = 0
    while True:
        now = win.clock()
        if now >= win.t_end:
            break
        while i < n and due[i] <= now:
            win.submit(float(due[i]))
            i += 1
        win.pump(now)
    while i < n:
        win.submit(float(due[i]))
        i += 1
