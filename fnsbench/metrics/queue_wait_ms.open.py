"""Median ms from a request's due time to the dispatch of its batch
(open loops)."""
from fnsbench import reduce


def read(rec):
    return reduce.queue_wait_ms(rec, closed=False)
