"""Share of the traced stretch with no device operation running, in %
(closed loops)."""
from fnsbench import reduce


def read(rec):
    return reduce.device_idle_pct(rec, closed=True)
