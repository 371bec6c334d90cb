"""Closed loop: ``clients`` callers, each sending its next request the
moment its last one is answered (no think time)."""
from __future__ import annotations

CLOSED = True


def buckets(wl: dict) -> list[int]:
    """Batch sizes the loop can dispatch. With at least twice the largest
    batch in clients, every cut is a full batch: one batch is in flight
    and the answers to the one before refill the queue at once."""
    s = wl["serve"]
    top = s["queue_max_batch"]
    if wl["clients"] >= 2 * top:
        return [top]
    out, b = [], s["min_bucket"]
    while b < min(wl["clients"], top):
        out.append(b)
        b *= 2
    return out + [b]


def run(win, wl: dict, rng) -> None:
    t0 = win.start()
    for _ in range(wl["clients"]):
        win.submit(t0)
    while True:
        now = win.clock()
        if now >= win.t_end:
            return
        win.pump(now)
        for _ in range(win.pop_done()):
            win.submit(win.clock())
