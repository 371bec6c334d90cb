"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit), and the work each kernel's share of its
roofline is counted against.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12


def bound_s(n_bytes: float, n_ops: float = 0.0,
            ops_per_s: float = FP32_FLOP_PER_S) -> float:
    """Least time the card could take: the larger of bytes over HBM's rate
    and operations over their peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s)


def k1_bytes(n_rows: int, n_fields: int, q: int) -> int:
    """Bytes K1 (``filter_eval_batch``) must move for a batch of ``q``
    queries: the int32 metadata read once and each query's packed pass
    bitmap written once. Its clause tables (about a twentieth of that at
    the cells' sizes) are left out, so the share is a lower bound."""
    return n_rows * n_fields * 4 + q * ((n_rows + 31) // 32) * 4
