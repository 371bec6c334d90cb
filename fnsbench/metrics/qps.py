"""Requests answered in the window over its length (closed loops)."""
from fnsbench import reduce


def read(rec):
    return reduce.qps(rec)
