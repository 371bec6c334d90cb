"""K1 (``filter_eval_batch``): its bytes bound over its traced device
time, in % (closed loops)."""
from fnsbench import program, reduce


def read(rec):
    return reduce.k1_roofline(rec, program.K1_KERNELS, closed=True)
