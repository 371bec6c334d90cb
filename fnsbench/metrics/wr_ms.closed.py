"""WR (``walk_round``): device ms a traced batch (closed loops)."""
from fnsbench import program, reduce


def read(rec):
    return reduce.kernel_ms_per_batch(rec, program.WR_KERNELS,
                                      program.K1_KERNELS, closed=True)
