"""Walk hops a query, from the engine's ``hops`` counter (closed loops)."""
from fnsbench import reduce


def read(rec):
    return reduce.hops_per_query(rec, closed=True)
