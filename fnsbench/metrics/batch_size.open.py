"""Mean real queries a dispatched batch (open loops)."""
from fnsbench import reduce


def read(rec):
    return reduce.batch_size(rec, closed=False)
