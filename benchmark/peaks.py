"""Peaks of the card, and the work a kernel's roofline share is counted
against.  The work comes from the operator and the configuration, never
from the format the program stores it in, so a share reads the same work
whatever implements it and cannot pass 100% unless the time leaves out
part of that work.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet; at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


def spmv_bytes(nnz: int, n: int, k: int, dtype: str) -> int:
    """Least bytes of ``Y = A X`` with ``X`` of ``k`` columns: every value
    of ``A`` read once, no index bytes, ``X`` read once, ``Y`` written
    once, all in the configuration's cycle ``dtype``."""
    b = DTYPE_BYTES[dtype]
    return nnz * b + k * n * 2 * b


def bandwidth_bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3
