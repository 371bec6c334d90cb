"""Restart rounds a batch, from the engine's ``rounds`` counter (closed
loops)."""
from fnsbench import reduce


def read(rec):
    return reduce.rounds_per_batch(rec, closed=True)
