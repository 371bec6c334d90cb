"""K3 (``masked_cosine_topk``, both its kernels): device ms a traced batch
(closed loops)."""
from fnsbench import program, reduce


def read(rec):
    return reduce.kernel_ms_per_batch(rec, program.K3_KERNELS,
                                      program.K1_KERNELS, closed=True)
