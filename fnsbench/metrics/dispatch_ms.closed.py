"""Host ms until ``dispatch_batch`` returns, mean over the window's
batches before the traced stretch (closed loops)."""
from fnsbench import reduce


def read(rec):
    return reduce.dispatch_ms(rec, closed=True)
