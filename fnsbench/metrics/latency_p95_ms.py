"""95th percentile of due-to-answer time over every request due in
the window (open loops)."""
from fnsbench import reduce


def read(rec):
    return reduce.latency_p95_ms(rec)
