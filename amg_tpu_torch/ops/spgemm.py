"""Host sparse matrix-matrix products (setup phase).

The Galerkin triple product ``A_coarse = R @ A @ P`` is the setup-phase hot
loop (reference ``SSS_blas_mat_rap``, amg/SSS_matvec.c:398-534: a two-pass
marker SpGEMM).  Coarse-operator sparsity is data dependent, so this stays
on the host (SURVEY.md "hard parts" #3); the result is uploaded to the
device once per level.

Dispatch order:

1. native C++ extension (two-pass marker SpGEMM, ``amg_tpu/native``)
2. scipy.sparse (C code, always available in this image)
3. pure-numpy COO-expansion fallback (also the test oracle)
"""

from __future__ import annotations

import numpy as np

from ..sparse import CSR


def _native_lib():
    try:
        from ..native import lib

        return lib
    except Exception:
        return None


def spgemm(a: CSR, b: CSR) -> CSR:
    """C = A @ B on host CSR."""
    lib = _native_lib()
    if lib is not None:
        return lib.spgemm(a, b)
    try:
        import scipy.sparse as sp  # noqa

        return CSR.from_scipy(a.to_scipy() @ b.to_scipy())
    except ImportError:
        return spgemm_numpy(a, b)


def spgemm_numpy(a: CSR, b: CSR) -> CSR:
    """Pure-numpy SpGEMM via COO join (test oracle; memory-hungry)."""
    rows_a = np.repeat(np.arange(a.n_rows, dtype=np.int64), a.row_degrees)
    # join on a.indices == b row
    deg_b = b.row_degrees
    reps = deg_b[a.indices]
    out_rows = np.repeat(rows_a, reps)
    out_vals_a = np.repeat(a.data, reps)
    # for each A entry, the slice of B entries it pairs with
    starts = b.indptr[:-1][a.indices]
    offsets = np.arange(int(reps.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(reps) - reps, reps
    )
    b_pos = np.repeat(starts, reps) + offsets
    out_cols = b.indices[b_pos].astype(np.int64)
    out_vals = out_vals_a * b.data[b_pos]
    return CSR.from_coo(out_rows, out_cols, out_vals, (a.n_rows, b.n_cols))


def rap(r: CSR, a: CSR, p: CSR) -> CSR:
    """Galerkin product R @ A @ P (reference amg/SSS_matvec.c:398-534)."""
    lib = _native_lib()
    if lib is not None:
        return lib.spgemm(lib.spgemm(r, a), p)
    return spgemm(spgemm(r, a), p)
