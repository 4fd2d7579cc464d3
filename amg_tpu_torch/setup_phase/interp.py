"""Interpolation (prolongation) operator construction.

Behavioral replicas of the reference:

* pattern builders ``form_P_pattern_dir`` / ``form_P_pattern_std``
  (amg/Setup/SSS_coarsen.c:577-725)
* direct interpolation values (CUDA kernel ``DIR_Step_1``,
  amg/Setup/SSS_inter.cu:104-210) — vectorized numpy here; the per-row
  independence that let the reference run one CUDA thread per row is exactly
  what lets us express it as flat array ops
* standard (distance-2) interpolation ``interp_STD``
  (amg/Setup/SSS_inter.cu:550-715)
* truncation ``SSS_amg_interp_trunc`` (amg/Setup/SSS_inter.cu:16-102) with
  the pos/neg rescaling that preserves row sums

All functions operate on host CSR; the resulting P is uploaded to the device
once per level by the hierarchy builder.
"""

from __future__ import annotations

import numpy as np

from ..params import AMGParams, FGPT, CGPT, SMALLFLOAT
from ..sparse import CSR


# ---------------------------------------------------------------------------
# Patterns
# ---------------------------------------------------------------------------


def p_pattern_dir(s: CSR, vec: np.ndarray, n_coarse: int) -> CSR:
    """Direct-interpolation pattern: F rows draw from strong C neighbors,
    C rows are identity, isolated rows are empty.

    Uses the native OpenMP count/fill passes when available (the numpy
    version below needs ~5 full-nnz passes and dominates 1M+-row setup).
    """
    from .. import native

    if native.lib is not None:
        return native.lib.p_pattern_dir(s, vec, n_coarse)
    return _p_pattern_dir_py(s, vec, n_coarse)


def _p_pattern_dir_py(s: CSR, vec: np.ndarray, n_coarse: int) -> CSR:
    n = s.n_rows
    sp, sj = s.indptr, s.indices
    rows_s = np.repeat(np.arange(n, dtype=np.int64), np.diff(sp))
    keep = (vec[rows_s] == FGPT) & (vec[sj] == CGPT)

    rows_f = rows_s[keep]          # row-major already (keep preserves order)
    cols_f = sj[keep].astype(np.int64)
    is_c = vec == CGPT

    deg = np.bincount(rows_f, minlength=n).astype(np.int64)
    deg[is_c] = 1                   # C rows: identity entry
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])

    indices = np.empty(int(indptr[-1]), dtype=np.int32)
    # F entries: within-row ordinal from the running stream position
    if len(rows_f):
        deg_f = np.bincount(rows_f, minlength=n).astype(np.int64)
        start_f = np.zeros(n, dtype=np.int64)
        np.cumsum(deg_f[:-1], out=start_f[1:])
        ordinal = np.arange(len(rows_f), dtype=np.int64) - start_f[rows_f]
        indices[indptr[rows_f] + ordinal] = cols_f
    c_rows = np.flatnonzero(is_c)
    indices[indptr[c_rows]] = c_rows
    return CSR(
        indptr,
        indices,
        np.zeros(len(indices), dtype=np.float64),
        (n, n_coarse),
    )


def p_pattern_std(s: CSR, vec: np.ndarray, n_coarse: int) -> CSR:
    """Standard-interpolation pattern: strong C neighbors plus distance-2 C
    neighbors reached through strong F neighbors (first-visit dedup order,
    like the reference's ``visited`` stamps)."""
    from .. import native

    if native.lib is not None:
        return native.lib.p_pattern_std(s, vec, n_coarse)
    n = s.n_rows
    sp, sj = s.indptr, s.indices
    visited = np.full(n, -1, dtype=np.int64)
    rows_list: list[int] = []
    cols_list: list[int] = []
    for i in range(n):
        if vec[i] == FGPT:
            for j in range(sp[i], sp[i + 1]):
                k = sj[j]
                if vec[k] == CGPT and visited[k] != i:
                    visited[k] = i
                    rows_list.append(i)
                    cols_list.append(k)
                elif vec[k] == FGPT and k != i:
                    for l in range(sp[k], sp[k + 1]):
                        h = sj[l]
                        if vec[h] == CGPT and visited[h] != i:
                            visited[h] = i
                            rows_list.append(i)
                            cols_list.append(h)
        elif vec[i] == CGPT:
            rows_list.append(i)
            cols_list.append(i)

    rows = np.asarray(rows_list, dtype=np.int64)
    cols = np.asarray(cols_list, dtype=np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSR(
        indptr,
        cols.astype(np.int32),
        np.zeros(len(cols), dtype=np.float64),
        (n, n_coarse),
    )


# ---------------------------------------------------------------------------
# Direct interpolation values
# ---------------------------------------------------------------------------


def interp_dir_values(a: CSR, vec: np.ndarray, p: CSR) -> None:
    """Fill direct-interpolation weights into ``p.data`` in place.

    For each F row i (vectorized over all rows at once):

    * split off-diagonal entries into negative/positive sums over all
      neighbors (amN/apN) and over interpolatory (pattern) neighbors
      (amP/apP)
    * ``alpha = amN/amP``; ``beta = apN/apP`` when positive interpolatory
      couplings exist, otherwise positive mass folds into the diagonal
    * ``P_ij = -alpha * a_ij / aii`` (negative a_ij) or
      ``-beta * a_ij / aii`` (positive a_ij)

    C rows get the single weight 1.0.
    """
    try:
        from ..native import lib as _native
    except Exception:
        _native = None
    if _native is not None:
        _native.dir_interp_values(a, vec, p)
        return
    n = a.n_rows
    rows_a = np.repeat(np.arange(n, dtype=np.int64), a.row_degrees)
    is_diag = a.indices == rows_a

    diag = np.zeros(n)
    dr = rows_a[is_diag][::-1]
    diag[dr] = a.data[is_diag][::-1]

    # membership: is A entry (i, j) in P's pattern row i?
    in_pattern = _membership(a, p)

    off = ~is_diag
    pos = off & (a.data > 0)
    neg = off & ~pos  # a.data <= 0 off-diagonal (reference: else branch)

    amN = np.zeros(n)
    amP = np.zeros(n)
    apN = np.zeros(n)
    apP = np.zeros(n)
    npc = np.zeros(n, dtype=np.int64)  # num positive strong couplings
    np.add.at(amN, rows_a[neg], a.data[neg])
    np.add.at(amP, rows_a[neg & in_pattern], a.data[neg & in_pattern])
    np.add.at(apN, rows_a[pos], a.data[pos])
    np.add.at(apP, rows_a[pos & in_pattern], a.data[pos & in_pattern])
    np.add.at(npc, rows_a[pos & in_pattern], 1)

    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = amN / amP
        beta = np.where(npc > 0, apN / np.where(apP != 0, apP, 1.0), 0.0)
    aii = np.where(npc > 0, diag, diag + apN)

    # scatter values onto P entries: for each P entry (i, k) find a_ik
    rows_p = np.repeat(np.arange(n, dtype=np.int64), p.row_degrees)
    a_vals = _lookup(a, rows_p, p.indices.astype(np.int64))
    f_rows = vec[rows_p] == FGPT
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.where(
            a_vals > 0,
            -beta[rows_p] * a_vals / aii[rows_p],
            -alpha[rows_p] * a_vals / aii[rows_p],
        )
    p.data[:] = np.where(f_rows, w, 1.0)


def _membership(a: CSR, p: CSR) -> np.ndarray:
    """Boolean per-A-entry: does (row, col) appear in P's pattern?"""
    n = a.n_rows
    rows_a = np.repeat(np.arange(n, dtype=np.int64), a.row_degrees)
    rows_p = np.repeat(np.arange(n, dtype=np.int64), p.row_degrees)
    # key-based membership via sorted search on (row, col) pairs
    key_a = rows_a * a.n_cols + a.indices
    key_p = rows_p * a.n_cols + p.indices
    key_p_sorted = np.sort(key_p)
    pos = np.searchsorted(key_p_sorted, key_a)
    pos = np.clip(pos, 0, len(key_p_sorted) - 1) if len(key_p_sorted) else pos
    if len(key_p_sorted) == 0:
        return np.zeros(len(key_a), dtype=bool)
    return key_p_sorted[pos] == key_a


def _lookup(a: CSR, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Values a[rows[k], cols[k]] (0 when absent), vectorized."""
    n = a.n_rows
    rows_a = np.repeat(np.arange(n, dtype=np.int64), a.row_degrees)
    key_a = rows_a * a.n_cols + a.indices
    order = np.argsort(key_a, kind="stable")
    key_sorted = key_a[order]
    val_sorted = a.data[order]
    key_q = rows * a.n_cols + cols
    pos = np.searchsorted(key_sorted, key_q)
    pos_c = np.clip(pos, 0, max(len(key_sorted) - 1, 0))
    hit = len(key_sorted) > 0
    found = key_sorted[pos_c] == key_q if hit else np.zeros(len(key_q), bool)
    out = np.zeros(len(key_q))
    if hit:
        out[found] = val_sorted[pos_c[found]]
    return out


# ---------------------------------------------------------------------------
# Standard interpolation values
# ---------------------------------------------------------------------------


def interp_std_values(a: CSR, vec: np.ndarray, p: CSR, s: CSR) -> None:
    """Distance-2 standard interpolation (reference ``interp_STD``,
    amg/Setup/SSS_inter.cu:550-715): eliminate strong F neighbors k through
    their diagonal (factor a_ik/a_kk), accumulate hat-A over interpolatory C
    points, then scale by -alpha/Ahat_i."""
    try:
        from ..native import lib as _native
    except Exception:
        _native = None
    if _native is not None:
        _native.std_interp_values(a, vec, p, s)
        return
    n = a.n_rows
    ap, aj, av = a.indptr, a.indices, a.data
    sp, sj = s.indptr, s.indices
    pp, pj = p.indptr, p.indices

    rows_a = np.repeat(np.arange(n, dtype=np.int64), a.row_degrees)
    is_diag = aj == rows_a
    diag = np.zeros(n)
    dr = rows_a[is_diag][::-1]
    diag[dr] = av[is_diag][::-1]

    # strong-C flags per A entry: S pattern ∩ C columns
    strongC = _membership(a, s) & (vec[aj] == CGPT)
    csum = np.zeros(n)
    np.add.at(csum, rows_a[strongC], av[strongC])

    from ..params import ISPT

    offd = ~is_diag
    nsum = np.zeros(n)
    np.add.at(nsum, rows_a[offd], av[offd])
    psum = np.zeros(n)
    m = offd & (vec[aj] != ISPT)
    np.add.at(psum, rows_a[m], av[m])

    ahat = np.zeros(n)

    for i in range(n):
        if vec[i] == CGPT:
            p.data[pp[i]] = 1.0
            continue
        if vec[i] != FGPT:
            continue
        alN = psum[i]
        alP = csum[i]
        prow = pj[pp[i]: pp[i + 1]]
        ahat[prow] = 0.0
        ahat[i] = diag[i]
        # reverse index for row i
        acols_i = aj[ap[i]: ap[i + 1]]
        avals_i = av[ap[i]: ap[i + 1]]
        rind_i = dict(zip(acols_i.tolist(), avals_i.tolist()))
        for jdx in range(sp[i], sp[i + 1]):
            k = sj[jdx]
            aik = rind_i.get(int(k), 0.0)
            if vec[k] == CGPT:
                ahat[k] += aik
            elif vec[k] == FGPT:
                akk = diag[k]
                factor = aik / akk
                acols_k = aj[ap[k]: ap[k + 1]]
                avals_k = av[ap[k]: ap[k + 1]]
                hits = np.nonzero(acols_k == i)[0]
                aki = float(avals_k[hits[0]]) if hits.size else 0.0
                if hits.size:
                    ahat[i] -= factor * aki
                rind_k = dict(zip(acols_k.tolist(), avals_k.tolist()))
                for m2 in range(sp[k], sp[k + 1]):
                    l = sj[m2]
                    if vec[l] == CGPT:
                        ahat[l] -= factor * rind_k.get(int(l), 0.0)
                alN -= factor * (nsum[k] - aki + akk)
                alP -= factor * csum[k]
        if pp[i + 1] > pp[i]:
            alpha = alN / alP
            p.data[pp[i]: pp[i + 1]] = -alpha * ahat[prow] / ahat[i]


# ---------------------------------------------------------------------------
# Coarse renumbering + truncation
# ---------------------------------------------------------------------------


def renumber_coarse(p: CSR, vec: np.ndarray) -> None:
    """Map P's column indices from fine numbering to coarse numbering
    (reference amg/Setup/SSS_inter.cu:374-387)."""
    cindex = np.cumsum(vec == CGPT, dtype=np.int32)
    cindex -= 1
    p.indices = cindex[p.indices]


def truncate(p: CSR, trunc_threshold: float) -> CSR:
    """Truncate small P entries, rescaling kept positive/negative groups so
    each group's row sum is preserved (reference ``SSS_amg_interp_trunc``,
    amg/Setup/SSS_inter.cu:16-102)."""
    from ..native import lib

    if lib is not None:
        return lib.truncate(p, trunc_threshold)
    return _truncate_py(p, trunc_threshold)


def _truncate_py(p: CSR, trunc_threshold: float) -> CSR:
    """Vectorized-numpy fallback (semantics identical to the native path)."""
    n = p.n_rows
    rows = np.repeat(np.arange(n, dtype=np.int64), p.row_degrees)
    v = p.data

    pos = v > 0
    neg = v < 0
    sum_pos = np.zeros(n)
    sum_neg = np.zeros(n)
    max_pos = np.zeros(n)
    min_neg = np.zeros(n)
    np.add.at(sum_pos, rows[pos], v[pos])
    np.add.at(sum_neg, rows[neg], v[neg])
    np.maximum.at(max_pos, rows[pos], v[pos])
    np.minimum.at(min_neg, rows[neg], v[neg])

    max_pos *= trunc_threshold
    min_neg *= trunc_threshold

    keep_pos = v >= max_pos[rows]
    keep_neg = v <= min_neg[rows]
    keep = keep_pos | keep_neg

    tsum_pos = np.zeros(n)
    tsum_neg = np.zeros(n)
    np.add.at(tsum_pos, rows[keep_pos], v[keep_pos])
    np.add.at(tsum_neg, rows[keep_neg], v[keep_neg])

    fac_pos = np.where(tsum_pos > SMALLFLOAT, sum_pos / np.where(tsum_pos != 0, tsum_pos, 1.0), 1.0)
    fac_neg = np.where(tsum_neg < -SMALLFLOAT, sum_neg / np.where(tsum_neg != 0, tsum_neg, 1.0), 1.0)

    new_vals = np.where(keep_pos, v * fac_pos[rows], v * fac_neg[rows])[keep]
    new_cols = p.indices[keep]
    new_rows = rows[keep]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, new_rows + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSR(indptr, new_cols.astype(np.int32), new_vals, p.shape)


def build_interpolation(
    a: CSR, s: CSR, vec: np.ndarray, n_coarse: int, pars: AMGParams
) -> CSR:
    """Full interpolation build: pattern -> values -> renumber -> truncate.

    Dispatch mirrors ``SSS_amg_interp`` (amg/Setup/SSS_inter.cu:717-735).
    """
    from ..params import InterpType

    if pars.interp_type == InterpType.DIR:
        p = p_pattern_dir(s, vec, n_coarse)
        interp_dir_values(a, vec, p)
    elif pars.interp_type == InterpType.STD:
        p = p_pattern_std(s, vec, n_coarse)
        interp_std_values(a, vec, p, s)
    else:
        raise ValueError(f"unknown interp_type {pars.interp_type}")
    renumber_coarse(p, vec)
    return truncate(p, pars.trunc_threshold)
