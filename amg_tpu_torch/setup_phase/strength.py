"""Strength-of-connection matrix.

Replicates the behavior of the reference's ``strong_couplings`` +
``compress_S`` (amg/Setup/SSS_coarsen.c:106-212), vectorized in numpy:

For each row i of A:

* ``row_sum = sum_j |a_ij|`` (all entries, diagonal included)
* ``row_scl = strong_threshold * max_{j != i} |a_ij|``
* the diagonal is never strong
* if ``row_sum < (2 - max_row_sum) * |a_ii|`` the row is strongly
  diagonally dominant and has **no** strong couplings
* otherwise entry j is strong iff ``-a_ij > row_scl`` (only negative
  couplings can be strong)

The result is a compressed pattern-only CSR (no values), the analog of the
reference's ``SSS_IMAT`` S.
"""

from __future__ import annotations

import numpy as np

from ..sparse import CSR


def strength_matrix(
    a: CSR, strong_threshold: float = 0.3, max_row_sum: float = 0.9
) -> CSR:
    """Return S: pattern CSR of strong couplings (data = ones)."""
    from ..native import lib

    if lib is not None:
        return lib.strength(a, strong_threshold, max_row_sum)
    return _strength_matrix_py(a, strong_threshold, max_row_sum)


def _strength_matrix_py(
    a: CSR, strong_threshold: float = 0.3, max_row_sum: float = 0.9
) -> CSR:
    """Vectorized-numpy fallback (semantics identical to the native path)."""
    n = a.n_rows
    deg = a.row_degrees
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    absval = np.abs(a.data)
    is_diag = a.indices == rows

    # segment reductions over the (row-major) entry stream: reduceat is
    # orders of magnitude faster than np.ufunc.at's unbuffered scatter
    nonempty = deg > 0
    starts = a.indptr[:-1][nonempty]
    row_sum = np.zeros(n)
    row_scl = np.zeros(n)
    offabs = np.where(is_diag, 0.0, absval)
    if len(starts):
        row_sum[nonempty] = np.add.reduceat(absval, starts)
        row_scl[nonempty] = np.maximum.reduceat(offabs, starts)
    row_scl *= strong_threshold

    # diagonal values (first occurrence per row, like SSS_mat_get_diag)
    diag = np.zeros(n)
    # reversed so the FIRST occurrence wins on duplicate diagonals
    dr = rows[is_diag][::-1]
    diag[dr] = a.data[is_diag][::-1]

    dominant = row_sum < (2.0 - max_row_sum) * np.abs(diag)

    strong = (
        (~is_diag)
        & (~dominant[rows])
        & (-a.data > row_scl[rows])
    )

    keep_rows = rows[strong]
    keep_cols = a.indices[strong]

    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.bincount(keep_rows, minlength=n)
    np.cumsum(indptr, out=indptr)
    # entries already in row-major CSR order since `strong` preserves order
    return CSR(
        indptr,
        keep_cols.astype(np.int32),
        np.ones(len(keep_cols), dtype=np.float64),
        (n, n),
    )
