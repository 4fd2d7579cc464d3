"""Sparse matrix containers.

Two worlds:

* **Host**: :class:`CSR` — numpy compressed-sparse-row, used by the setup
  phase (coarsening / interpolation / Galerkin product are irregular,
  data-dependent-shape graph algorithms that belong on the host, exactly as
  the reference runs them on the CPU — reference ``SSS_MAT``,
  amg/SSS_main.h:95-105).  Same code as ``amg_tpu.sparse.CSR``.

* **Device**: torch tensors on an explicit ``device``.  :class:`Dia` (the
  banded fast path, applied by the hand-written DIA kernel in
  ``ops/dia_kernel.py``), :class:`WEll` (windowed-gather ELL for large
  unstructured levels, applied by the hand-written WEll kernels in
  ``ops/well_kernel.py`` through its derived :class:`RowSlices` layout),
  :class:`Ell` (padded ELLPACK, gather SpMV),
  :class:`Dense` (small deep levels, one matmul) and
  :class:`BandedBlocks` (RCM-ordered coarse levels as dense 128x128
  blocks along a block band, one batched matmul).  Each is built from a
  host CSR with the same padding as ``amg_tpu.sparse`` so vectors compare
  entry for entry, and has a ``to_csr`` for round-trip tests.

Rows are padded to the next multiple of 8 and the ELL width to the actual
max row degree; ELL padding entries carry ``col = row`` (a self-reference,
always a valid index) and ``val = 0`` so no masks are needed in compute.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def torch_dtype(dtype) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` / ``torch.float64`` ... -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def _to_device(arr: np.ndarray, dtype, device) -> torch.Tensor:
    """Host numpy array -> tensor of ``dtype`` on ``device``.  The cast
    happens on the host for float32/float64 (numpy rounds f64 -> f32 the
    same way) and in torch for bfloat16 (numpy has no bf16)."""
    dt = torch_dtype(dtype)
    np_dt = {torch.float32: np.float32, torch.float64: np.float64,
             torch.bfloat16: np.float32, torch.int64: np.int64,
             torch.int32: np.int32, torch.bool: np.bool_}[dt]
    host = np.ascontiguousarray(arr, dtype=np_dt)
    if not host.flags.writeable:   # e.g. a view of a JAX array
        host = host.copy()
    return torch.from_numpy(host).to(dtype=dt).to(device)


# ---------------------------------------------------------------------------
# Host CSR
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CSR:
    """Host-side CSR matrix (int32 indices, float64 values)."""

    indptr: np.ndarray   # (n_rows + 1,) int32/int64
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray     # (nnz,) float64
    shape: Tuple[int, int]

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_coo(rows, cols, vals, shape, sum_duplicates: bool = True) -> "CSR":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        # fast path: already in strict CSR order (common for re-indexed /
        # generated matrices) -> skip the O(nnz log nnz) lexsort entirely
        if len(rows):
            key = rows * shape[1] + cols
            if np.all(np.diff(key) > 0):
                indptr = np.zeros(shape[0] + 1, dtype=np.int64)
                indptr[1:] = np.bincount(rows, minlength=shape[0])
                np.cumsum(indptr, out=indptr)
                return CSR(indptr, cols.astype(np.int32), vals, tuple(shape))
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and len(rows):
            dup = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
            if dup.any():
                keep = np.concatenate([[True], ~dup])
                grp = np.cumsum(keep) - 1
                out_vals = np.zeros(keep.sum(), dtype=np.float64)
                np.add.at(out_vals, grp, vals)
                rows, cols, vals = rows[keep], cols[keep], out_vals
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        indptr[1:] = np.bincount(rows, minlength=shape[0])
        np.cumsum(indptr, out=indptr)
        return CSR(indptr, cols.astype(np.int32), vals, tuple(shape))

    @staticmethod
    def from_dense(a: np.ndarray, tol: float = 0.0) -> "CSR":
        a = np.asarray(a, dtype=np.float64)
        rows, cols = np.nonzero(np.abs(a) > tol)
        return CSR.from_coo(rows, cols, a[rows, cols], a.shape)

    @staticmethod
    def from_scipy(m) -> "CSR":
        m = m.tocsr()
        return CSR(
            np.asarray(m.indptr, dtype=np.int64),
            np.asarray(m.indices, dtype=np.int32),
            np.asarray(m.data, dtype=np.float64),
            tuple(m.shape),
        )

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data, self.indices, self.indptr), shape=self.shape
        )

    # -- basic properties ----------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def row_degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    @property
    def row_indices(self) -> np.ndarray:
        """Row index per entry (``np.repeat`` over degrees), memoized —
        the expansion costs ~seconds at 100M nnz and the setup phase asks
        for it many times per level."""
        r = getattr(self, "_row_idx_cache", None)
        if r is None or len(r) != self.nnz:
            r = np.repeat(
                np.arange(self.n_rows, dtype=np.int64), self.row_degrees
            )
            self._row_idx_cache = r
        return r

    # -- ops -----------------------------------------------------------------

    def diagonal(self) -> np.ndarray:
        """First-match diagonal per row (reference ``SSS_mat_get_diag``,
        amg/SSS_matvec.c:162)."""
        n = min(self.shape)
        diag = np.zeros(n, dtype=np.float64)
        for i in range(n):
            seg = slice(self.indptr[i], self.indptr[i + 1])
            hits = np.nonzero(self.indices[seg] == i)[0]
            if hits.size:
                diag[i] = self.data[self.indptr[i] + hits[0]]
        return diag

    def diagonal_fast(self) -> np.ndarray:
        """Vectorized diagonal extraction."""
        n = min(self.shape)
        rows = self.row_indices
        mask = (self.indices == rows) & (rows < n)
        diag = np.zeros(n, dtype=np.float64)
        diag[rows[mask]] = self.data[mask]
        return diag

    def transpose(self) -> "CSR":
        """Two-pass histogram transpose (reference ``SSS_mat_trans``,
        amg/SSS_matvec.c:330-387)."""
        try:
            from .native import lib as _native
        except Exception:
            _native = None
        if _native is not None and self.nnz:
            return _native.csr_transpose(self)
        n_rows, n_cols = self.shape
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), self.row_degrees)
        order = np.argsort(self.indices, kind="stable")
        new_indptr = np.zeros(n_cols + 1, dtype=np.int64)
        new_indptr[1:] = np.bincount(self.indices, minlength=n_cols)
        np.cumsum(new_indptr, out=new_indptr)
        return CSR(
            new_indptr,
            rows[order].astype(np.int32),
            self.data[order],
            (n_cols, n_rows),
        )

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x (host reference implementation; reference
        ``SSS_blas_mv_mxy``, amg/SSS_utils.c:182-201)."""
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int64), self.row_degrees)
        prod = self.data * x[self.indices]
        y = np.zeros(self.n_rows, dtype=np.result_type(self.data, x))
        np.add.at(y, rows, prod)
        return y

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        out = np.zeros(self.shape, dtype=dtype)
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int64), self.row_degrees)
        # duplicates (shouldn't exist) would overwrite; fine for tests
        np.add.at(out, (rows, self.indices), self.data.astype(dtype, copy=False))
        return out

    def sort_indices(self) -> "CSR":
        """Return a copy with column indices sorted within each row."""
        indices = self.indices.copy()
        data = self.data.copy()
        for i in range(self.n_rows):
            s, e = self.indptr[i], self.indptr[i + 1]
            order = np.argsort(indices[s:e], kind="stable")
            indices[s:e] = indices[s:e][order]
            data[s:e] = data[s:e][order]
        return CSR(self.indptr.copy(), indices, data, self.shape)

    def copy(self) -> "CSR":
        return CSR(
            self.indptr.copy(), self.indices.copy(), self.data.copy(), self.shape
        )

    # -- permutations (vectorized) -------------------------------------------

    def permute_rows(self, perm: np.ndarray) -> "CSR":
        """Rows reordered: new row ``i`` is old row ``perm[i]``."""
        perm = np.asarray(perm, dtype=np.int64)
        deg = self.row_degrees
        new_deg = deg[perm]
        new_indptr = np.zeros(self.n_rows + 1, dtype=np.int64)
        np.cumsum(new_deg, out=new_indptr[1:])
        # source slot of each output nnz
        pos = np.arange(int(new_indptr[-1]), dtype=np.int64) - np.repeat(
            new_indptr[:-1], new_deg
        )
        src = np.repeat(self.indptr[perm], new_deg) + pos
        return CSR(new_indptr, self.indices[src], self.data[src], self.shape)

    def permute_cols(self, col_map: np.ndarray) -> "CSR":
        """Columns relabeled: old column ``c`` becomes ``col_map[c]``."""
        col_map = np.asarray(col_map, dtype=np.int64)
        return CSR(
            self.indptr.copy(),
            col_map[self.indices].astype(np.int32),
            self.data.copy(),
            self.shape,
        )

    def permute(self, perm: np.ndarray) -> "CSR":
        """Symmetric permutation ``P A P^T`` of a square matrix: new index
        ``i`` is old index ``perm[i]``."""
        perm = np.asarray(perm, dtype=np.int64)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm), dtype=np.int64)
        return self.permute_rows(perm).permute_cols(inv)



# ---------------------------------------------------------------------------
# Device ELL
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Ell:
    """Padded ELLPACK matrix on device.

    ``cols``/``vals`` have shape ``(padded_rows, width)``.  Padding slots
    point at the row's own index (clipped to the column range) with value
    0, so gathers stay in bounds and no masking is needed.
    """

    cols: torch.Tensor   # (pr, w) int64
    vals: torch.Tensor   # (pr, w) dtype
    shape: Tuple[int, int]
    nnz: int

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.cols.shape[0]

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    @staticmethod
    def pack_host(
        a: CSR,
        row_multiple: int = 8,
        width_multiple: int = 1,
        pad_rows_to: int | None = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pack a host CSR into padded ELL numpy arrays ``(cols, vals)``."""
        n_rows, n_cols = a.shape
        deg = a.row_degrees
        width = max(int(deg.max()) if n_rows else 1, 1)
        width = _round_up(width, width_multiple)
        pr = _round_up(max(n_rows, 1), row_multiple)
        if pad_rows_to is not None:
            pr = max(pr, pad_rows_to)  # caller-specified row padding

        cols = np.repeat(
            np.arange(pr, dtype=np.int64)[:, None], width, axis=1
        )
        # self-reference padding must stay in-bounds for gathers on x
        np.clip(cols, 0, max(n_cols - 1, 0), out=cols)
        vals = np.zeros((pr, width), dtype=np.float64)

        rows = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
        # position of each nnz within its row
        pos = np.arange(a.nnz, dtype=np.int64) - np.repeat(a.indptr[:-1], deg)
        cols[rows, pos] = a.indices
        vals[rows, pos] = a.data
        return cols, vals

    @staticmethod
    def from_csr(
        a: CSR,
        dtype=torch.float64,
        row_multiple: int = 8,
        width_multiple: int = 1,
        pad_rows_to: int | None = None,
        device="cpu",
    ) -> "Ell":
        """Convert host CSR to padded ELL (host packing, one upload)."""
        cols, vals = Ell.pack_host(a, row_multiple, width_multiple, pad_rows_to)
        return Ell(
            _to_device(cols, torch.int64, device),
            _to_device(vals, dtype, device),
            a.shape,
            a.nnz,
        )

    def to_csr(self) -> CSR:
        """Device ELL back to host CSR (drops padding zeros)."""
        cols = self.cols.cpu().numpy()[: self.n_rows]
        vals = self.vals.cpu().double().numpy()[: self.n_rows]
        rr, pp = np.nonzero(vals != 0.0)
        return CSR.from_coo(rr, cols[rr, pp], vals[rr, pp], self.shape)


# ---------------------------------------------------------------------------
# Device Dense format (small deep levels)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Dense:
    """Densified operator for small grid levels.

    Deep AMG levels are small (thousands of rows) but nearly dense
    (hundreds of nnz/row after repeated Galerkin products): a dense matvec
    streams the operator once with zero gathers.  Replaces the reference's
    CSR SpMV (amg/SSS_utils.c:182-201) for levels whose dense footprint
    fits ``AMGParams.dense_level_bytes``.
    """

    vals: torch.Tensor           # (pr, pc) dtype
    shape: Tuple[int, int]
    nnz: int

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.vals.shape[0]

    @property
    def padded_cols(self) -> int:
        return self.vals.shape[1]

    @staticmethod
    def from_csr(
        a: CSR,
        dtype=torch.float64,
        row_multiple: int = 8,
        pad_rows_to: int | None = None,
        pad_cols_to: int | None = None,
        device="cpu",
    ) -> "Dense":
        n_rows, n_cols = a.shape
        pr = _round_up(max(n_rows, 1), row_multiple)
        if pad_rows_to is not None:
            pr = max(pr, pad_rows_to)
        pc = _round_up(max(n_cols, 1), 128)  # same column pad as amg_tpu
        if pad_cols_to is not None:
            pc = max(pc, pad_cols_to)
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), a.row_degrees)
        vals = np.zeros((pr, pc), dtype=np.float64)
        vals[rows, a.indices.astype(np.int64)] = a.data
        return Dense(_to_device(vals, dtype, device), (n_rows, n_cols), a.nnz)

    def to_csr(self) -> CSR:
        vals = self.vals.cpu().double().numpy()
        sub = vals[: self.n_rows, : self.n_cols]
        rr, cc = np.nonzero(sub)
        return CSR.from_coo(rr, cc, sub[rr, cc], self.shape)


# ---------------------------------------------------------------------------
# Device DIA (diagonal-offset) format
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Dia:
    """Diagonal (offset) storage on device — the fast path for banded
    operators.

    ``vals[d, i] = A[i, i + offsets[d]]`` in the 2-D ``(nd, pad)`` layout,
    with the offsets both as a static tuple and as a device ``int32``
    tensor (``offs``) that the CUDA kernel reads.  SpMV is a sum of shifted
    element-wise products with no gathers::

        y[i] = sum_d vals[d, i] * x[i + offsets[d]]   (x = 0 outside [0, pad))

    Stencil problems and their Galerkin coarse operators have few distinct
    offsets, so most levels qualify; unstructured levels fall back to
    :class:`Ell` or :class:`Dense`.
    """

    vals: torch.Tensor           # (nd, pad) dtype
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int
    offs: torch.Tensor = None    # (nd,) int32, on vals.device

    def __post_init__(self):
        if self.offs is None:
            self.offs = torch.tensor(self.offsets, dtype=torch.int32,
                                     device=self.vals.device)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.vals.shape[1]

    @property
    def n_diags(self) -> int:
        return len(self.offsets)

    @staticmethod
    def _offset_hist(a: CSR):
        """Memoized (off_lo, uniq offsets) of a host CSR — the (col - row)
        histogram is needed by both format selection and packing; one
        O(nnz) bincount pass serves both."""
        cached = getattr(a, "_off_hist_cache", None)
        if cached is not None and cached[0] == a.nnz:
            return cached[1]
        offs = a.indices - a.row_indices  # int64 result (row_indices i64)
        if len(offs):
            off_lo = int(offs.min())
            cnt = np.bincount(offs - off_lo)
            uniq = np.flatnonzero(cnt) + off_lo
        else:
            off_lo = 0
            uniq = np.zeros(0, dtype=np.int64)
        a._off_hist_cache = (a.nnz, (off_lo, uniq))
        return off_lo, uniq

    @staticmethod
    def num_offsets(a: CSR) -> int:
        """Distinct (col - row) offsets of a host CSR matrix."""
        if a.nnz == 0:
            return 0
        return len(Dia._offset_hist(a)[1])

    @staticmethod
    def from_csr(
        a: CSR,
        dtype=torch.float64,
        row_multiple: int = 8,
        pad_rows_to: int | None = None,
        device="cpu",
    ) -> "Dia":
        n_rows, n_cols = a.shape
        pr = _round_up(max(n_rows, 1), row_multiple)
        if pad_rows_to is not None:
            pr = max(pr, pad_rows_to)
        rows = a.row_indices
        if a.nnz:
            # bincount + lookup table instead of sort-based unique/searchsorted
            off_lo, uniq = Dia._offset_hist(a)
            offs = a.indices.astype(np.int64) - rows
            lut = np.full(int(uniq[-1]) - off_lo + 1, -1, dtype=np.int64)
            lut[uniq - off_lo] = np.arange(len(uniq))
            dpos = lut[offs - off_lo]
        else:
            uniq = np.zeros(0, dtype=np.int64)
            dpos = np.zeros(0, dtype=np.int64)
        # (offset, row) pairs are unique in a duplicate-free CSR
        vals_np = np.zeros((len(uniq), pr), dtype=np.float64)
        vals_np[dpos, rows] = a.data
        return Dia(
            _to_device(vals_np, dtype, device),
            tuple(int(o) for o in uniq),
            (n_rows, n_cols),
            a.nnz,
        )

    @staticmethod
    def from_numpy(vals: np.ndarray, offsets, shape, nnz: int,
                   device="cpu", dtype=None) -> "Dia":
        """Wrap already-packed ``(nd, pad)`` values (e.g. ``amg_tpu``'s
        ``Dia.vals`` as numpy) without repacking.  ``dtype`` defaults to the
        array's own; pass ``torch.bfloat16`` for bf16 values handed over as
        float32 (numpy has no bf16; the widening is exact)."""
        vals = np.asarray(vals)
        if vals.ndim != 2 or vals.shape[0] != len(offsets):
            raise ValueError(f"vals must be (nd, pad); got {vals.shape} for "
                             f"{len(offsets)} offsets")
        dt = dtype if dtype is not None else torch.from_numpy(vals[:0]).dtype
        return Dia(_to_device(vals, dt, device),
                   tuple(int(o) for o in offsets), tuple(shape), int(nnz))

    def to_csr(self) -> CSR:
        vals = self.vals.cpu().double().numpy()
        rows_l, cols_l, data_l = [], [], []
        for k, off in enumerate(self.offsets):
            i = np.arange(self.n_rows, dtype=np.int64)
            j = i + off
            m = (j >= 0) & (j < self.n_cols) & (vals[k, : self.n_rows] != 0)
            rows_l.append(i[m])
            cols_l.append(j[m])
            data_l.append(vals[k, : self.n_rows][m])
        return CSR.from_coo(
            np.concatenate(rows_l), np.concatenate(cols_l),
            np.concatenate(data_l), self.shape,
        )


# ---------------------------------------------------------------------------
# Device WEll (windowed-gather ELL) format and its row-slice layout
# ---------------------------------------------------------------------------


SLICE_ROWS = 32   # rows per slice of the RowSlices layout (one warp)
# the longest row that kernel B2 (one thread a row) reads at the pace of
# its bytes on a coarse level of few rows: past it the level waits on its
# longest rows' chains of loads (on an H100, bf16 levels of ~10-20 k rows
# against their RCM bands: 64 entries a row 0.029 ms against 0.089 ms,
# 168 entries 0.073 against 0.080, 328 entries 0.170 against 0.055)
ROW_THREAD_MAX = 128


def _slot_columns(loc: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Column of every slot entry of a WEll pack, ``(base + Q[s, r]) * 128
    + r`` with ``r = loc & 127`` and Q read at lane ``r`` of the same
    sublane (int64, the shape of ``loc``)."""
    loc = loc.to(torch.int64)
    r = loc & 127
    q = torch.gather(loc, 3, r) >> 7
    return (base.to(torch.int64)[:, :, None, None] + q) * 128 + r


@dataclasses.dataclass
class RowSlices:
    """The layout the WEll kernels read on the card: a WEll pack's entries
    without its padding slots, as row slices of 32 rows (SELL-32).

    Rows are split into segments and each segment into slices of 32 slot
    rows.  With GS classes (``classes``: a class id per padded row, -1 for
    none) segment ``g`` holds class ``g``'s rows in ascending order and the
    last segment the rows of no class; otherwise one segment holds every
    padded row in row order.  Every padded row lies in exactly one segment,
    so a product over all slices writes every entry of ``y``.

    Slot row ``t`` (``t = 32 * slice + lane``) is output row
    ``row_idx[t]`` (-1 for the lanes past a segment's end) with
    ``row_len[t]`` entries, sorted by column; entry ``j`` sits at
    ``slice_ptr[t // 32] + 32 * j + t % 32`` of ``cols``/``vals``, so the
    lanes of a slice read one coalesced run per ``j``.  A slice is as wide
    as its longest row; the shorter rows' places are never read.

    ``vals_lo`` is the second f32 plane of a df64 operator (``vals +
    vals_lo`` is the f64 value).  Level 0's f32 operator and the df64
    operator of FCG share ``cols``, ``slice_ptr``, ``row_len``,
    ``row_idx`` and the hi plane ``vals``.
    """

    cols: torch.Tensor        # (n_stored,) int32, column per place
    vals: torch.Tensor        # (n_stored,) values dtype (f32 hi plane: df64)
    slice_ptr: torch.Tensor   # (n_slices + 1,) int64, first place per slice
    row_len: torch.Tensor     # (n_slices * 32,) int32 entries per slot row
    row_idx: torch.Tensor     # (n_slices * 32,) int32 output row, -1 unused
    segments: Tuple[Tuple[int, int], ...]   # (first slice, slices) each
    classes: bool             # segment g is GS class g (last: no class)
    nnz: int                  # entries kept (nonzero values)
    vals_lo: Optional[torch.Tensor] = None  # (n_stored,) f32 lo plane

    @property
    def n_slices(self) -> int:
        return self.slice_ptr.shape[0] - 1

    @property
    def n_stored(self) -> int:
        return self.cols.shape[0]

    @staticmethod
    def from_well(w: "WEll", classes: Optional[torch.Tensor] = None,
                  device=None) -> "RowSlices":
        """Derive the layout from a WEll pack on ``device`` (default: the
        pack's) with torch ops: copy the pack there, decode every slot
        entry's column, keep the entries with a nonzero value (for a df64
        pack: ``hi != 0 or lo != 0``), order each segment's rows and each
        row's entries by column, and place them in slices.  The pack's
        copy on ``device`` is freed when this returns."""
        dev = w.vals.device if device is None else torch.device(device)
        w_vals, loc, base = (t.to(dev) for t in (w.vals, w.loc, w.base))
        w_lo = None if w.vals_lo is None else w.vals_lo.to(dev)
        ngroups, n_slots = base.shape
        pr = ngroups * 1024
        nz = w_vals != 0
        if w_lo is not None:
            nz |= w_lo != 0
        # flat index (((g * S + k) * 8 + s) * 128 + l) of each kept entry;
        # its row is g * 1024 + s * 128 + l
        flat = nz.reshape(-1).nonzero().squeeze(1)
        row = flat // (n_slots * 1024) * 1024 + flat % 1024
        inside = row < w.n_rows
        flat, row = flat[inside], row[inside]
        col = _slot_columns(loc, base).reshape(-1)[flat]

        rows_all = torch.arange(pr, device=dev)
        if classes is None:
            seg = torch.zeros(pr, dtype=torch.int64, device=dev)
            n_seg = 1
        else:
            cls = classes.to(device=dev, dtype=torch.int64)
            if cls.shape != (pr,):
                raise ValueError(f"classes must have one entry per padded "
                                 f"row ({pr}); got {tuple(cls.shape)}")
            n_cls = int(cls.max()) + 1 if pr else 0
            seg = torch.where(cls >= 0, cls, n_cls)
            n_seg = n_cls + 1
        # slot row of every padded row: segments in order, rows ascending
        seg_rows = torch.bincount(seg, minlength=n_seg)
        seg_slices = (seg_rows + SLICE_ROWS - 1) // SLICE_ROWS
        seg_first_row = torch.cumsum(seg_rows, 0) - seg_rows
        seg_first_slice = torch.cumsum(seg_slices, 0) - seg_slices
        rank = torch.empty(pr, dtype=torch.int64, device=dev)
        rank[torch.argsort(seg * pr + rows_all)] = rows_all
        slot_of_row = (seg_first_slice[seg] * SLICE_ROWS
                       + rank - seg_first_row[seg])
        n_slices = int(seg_slices.sum())
        n_slot_rows = n_slices * SLICE_ROWS

        # entries ordered by (slot row, column)
        slot = slot_of_row[row]
        order = torch.argsort(slot * max(w.pad_cols, 1) + col)
        slot, col, flat = slot[order], col[order], flat[order]
        row_len = torch.bincount(slot, minlength=n_slot_rows)
        width = row_len.reshape(n_slices, SLICE_ROWS).amax(1)
        slice_ptr = torch.cat([width.new_zeros(1),
                               torch.cumsum(width * SLICE_ROWS, 0)])
        j = (torch.arange(slot.shape[0], device=dev)
             - (torch.cumsum(row_len, 0) - row_len)[slot])
        place = (slice_ptr[slot // SLICE_ROWS] + SLICE_ROWS * j
                 + slot % SLICE_ROWS)
        n_stored = int(slice_ptr[-1])

        def plane(v):
            out = torch.zeros(n_stored, dtype=v.dtype, device=dev)
            out[place] = v.reshape(-1)[flat]
            return out

        cols = torch.zeros(n_stored, dtype=torch.int32, device=dev)
        cols[place] = col.to(torch.int32)
        row_idx = torch.full((n_slot_rows,), -1, dtype=torch.int32,
                             device=dev)
        row_idx[slot_of_row] = rows_all.to(torch.int32)
        segments = tuple(zip(seg_first_slice.tolist(), seg_slices.tolist()))
        return RowSlices(
            cols=cols, vals=plane(w_vals), slice_ptr=slice_ptr,
            row_len=row_len.to(torch.int32), row_idx=row_idx,
            segments=segments, classes=classes is not None,
            nnz=int(slot.shape[0]),
            vals_lo=None if w_lo is None else plane(w_lo))

    def class_segment(self, g: int) -> Tuple[int, int]:
        """(first slice, slices) of GS class ``g``."""
        if not self.classes or not 0 <= g < len(self.segments) - 1:
            raise ValueError(f"the layout has no GS class {g} (classes: "
                             f"{len(self.segments) - 1 if self.classes else 0})")
        return self.segments[g]

    def entries(self, first: int = 0, n: Optional[int] = None):
        """(places, slot rows) of the real entries of slices ``[first,
        first + n)`` (default: all), in place order."""
        n = self.n_slices - first if n is None else n
        ptr = self.slice_ptr
        place = torch.arange(int(ptr[first]), int(ptr[first + n]),
                             device=ptr.device)
        s = torch.searchsorted(ptr, place, right=True) - 1
        off = place - ptr[s]
        slot = s * SLICE_ROWS + off % SLICE_ROWS
        real = off // SLICE_ROWS < self.row_len[slot].long()
        return place[real], slot[real]

    def to_csr(self, shape: Tuple[int, int]) -> CSR:
        """Host CSR of the entries (f64 values; ``vals + vals_lo`` for a
        df64 layout)."""
        place, slot = self.entries()
        vals = self.vals[place].cpu().double().numpy()
        if self.vals_lo is not None:
            vals = vals + self.vals_lo[place].cpu().double().numpy()
        rows = self.row_idx[slot].cpu().numpy().astype(np.int64)
        cols = self.cols[place].cpu().numpy().astype(np.int64)
        return CSR.from_coo(rows, cols, vals, shape)


def row_slices_bytes(nnz: int, value_bytes: int, n_slices: int, x_len: int,
                     y_rows: int, x_bytes: int) -> int:
    """Bytes one product of kernel B2 (``ops/well_kernel.py``) moves over
    a row-slice layout of ``n_slices`` slices: per nonzero its value and
    4 B column, per slot row its length and output row (4 B each), the
    slices' 8 B pointers, x once (``x_len`` entries) and y once
    (``y_rows`` rows).  The count behind the kernel table's bound and
    behind ``hierarchy.reorder_for_gs``'s choice of a band over WEll."""
    return (nnz * (value_bytes + 4) + n_slices * SLICE_ROWS * 8
            + (n_slices + 1) * 8 + (x_len + y_rows) * x_bytes)


@dataclasses.dataclass
class WEll:
    """Windowed-gather ELL: ``amg_tpu``'s format for unstructured levels.

    Rows are processed in groups of 1024 (row ``g*1024 + s*128 + l`` at
    sublane ``s``, lane ``l``).  Each group's entries are packed into
    ``S`` slots; all entries of a slot draw x from one 1024-wide column
    window ``[128*base, 128*base + 1024)``, with at most one entry per row
    per slot.  An entry's column is ``(base + Q[s, r]) * 128 + r`` where
    ``r = loc & 127`` is stored at the entry's own lane and the block
    ``Q`` at lane ``r`` of the same sublane (``loc = (Q << 7) | r``,
    int16); the packer keeps that lookup conflict-free.  See
    ``amg_tpu/sparse.py:637-902`` for why the TPU needs this layout; the
    port keeps it so that its packs equal ``amg_tpu``'s array for array and
    the kernels (``ops/well_kernel.py``) compute the same products.

    ``vals_lo`` (f32, same layout) is set by :meth:`from_csr_df64`: ``vals
    + vals_lo`` reproduces the f64 operator to ~2^-48 relative, the input
    of the f64 product ``well_kernel.spmv_df64``.

    ``rows`` is the layout the kernels read (:class:`RowSlices`), derived
    from the pack when the operator is made, on ``device`` (default: the
    pack's device); ``classes`` (a GS class id per padded row, -1 for
    none) groups its rows by class, so that one class's Gauss-Seidel
    update reads only that class's entries.  The pack itself (``vals``,
    ``loc``, ``base``, ``vals_lo``) is then kept on the host, for
    ``to_csr`` and the comparison with ``amg_tpu``'s: the card holds only
    the layout the kernels read.
    """

    vals: torch.Tensor    # (ngroups, S, 8, 128) dtype
    loc: torch.Tensor     # (ngroups, S, 8, 128) int16: (Q << 7) | r
    base: torch.Tensor    # (ngroups, S) int32 window start (128-col units)
    shape: Tuple[int, int]
    nnz: int
    pad_cols: int         # x padding the windows were clamped against
    vals_lo: Optional[torch.Tensor] = None
    rows: Optional[RowSlices] = None
    # ring-halo widths (lo128, hi128), in 128-column units, for a
    # row-group-sharded apply on a D-shard ring: set at pack time when the
    # pack is headed for one (``ring_devices``), as amg_tpu sets it
    ring_plan: Optional[Tuple[int, int]] = None
    classes: dataclasses.InitVar[Optional[torch.Tensor]] = None
    device: dataclasses.InitVar[Optional[object]] = None

    def __post_init__(self, classes, device):
        if self.rows is None:
            self.rows = RowSlices.from_well(self, classes, device)
        elif classes is not None or device is not None:
            raise ValueError("pass classes and device, or a derived layout, "
                             "not both")
        self.vals, self.loc, self.base = (
            t.cpu() for t in (self.vals, self.loc, self.base))
        if self.vals_lo is not None:
            self.vals_lo = self.vals_lo.cpu()

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.vals.shape[0] * 1024

    @property
    def n_slots(self) -> int:
        return self.vals.shape[1]

    @staticmethod
    def ring_plan_host(base: np.ndarray, active: np.ndarray, n_shards: int,
                       in_m128: int) -> Tuple[int, int]:
        """Halo widths ``(lo128, hi128)`` for a row-group-sharded apply
        (``amg_tpu/sparse.py::WEll.ring_plan_host``): shard ``s`` owns row
        groups ``[s*gps, (s+1)*gps)`` and the input block of ``in_m128``
        128-column units, and every slot holding an entry (``active``,
        ``(ngroups, S)``) must read inside ``[s*in_m128 - lo, (s+1)*in_m128
        + hi)``.  Empty slots keep base 0 and are ignored."""
        ngroups = base.shape[0]
        if ngroups % n_shards != 0:
            raise ValueError(
                f"ngroups {ngroups} not divisible by {n_shards}")
        gps = ngroups // n_shards
        lo = hi = 0
        for s in range(n_shards):
            act = active[s * gps:(s + 1) * gps]
            if not act.any():
                continue
            bs = base[s * gps:(s + 1) * gps][act]
            lo = max(lo, s * in_m128 - int(bs.min()))
            hi = max(hi, int(bs.max()) + 8 - (s + 1) * in_m128)
        return max(lo, 0), max(hi, 0)

    @staticmethod
    def _plan(base: np.ndarray, vals: torch.Tensor, pc: int,
              ring_devices) -> Optional[Tuple[int, int]]:
        """``ring_plan`` of a pack headed for a ``ring_devices``-shard ring
        (None for fewer than 2 shards, or shapes that do not divide);
        ``vals`` in the stored dtype, as amg_tpu tests its own."""
        if not ring_devices or ring_devices < 2:
            return None
        if base.shape[0] % ring_devices or pc % (128 * ring_devices):
            return None
        active = vals.reshape(base.shape[0], base.shape[1], -1).ne(0) \
            .any(dim=2).numpy()
        return WEll.ring_plan_host(base, active, ring_devices,
                                   pc // 128 // ring_devices)

    @staticmethod
    def _pack_greedy_py(a: CSR, pad_cols: int):
        """Greedy first-fit slot packer (the native packer's semantics;
        per-entry Python loop, for test-sized matrices when no compiler is
        available).

        Admission of entry (row, col) into a slot requires, in order:
        (1) ``128*base <= col < 128*base + 1024`` (window fit),
        (2) the row's lane is free in the slot,
        (3) the (output-sublane, column-remainder) cell is either free or
            already maps to the same column block.
        """
        n = a.n_rows
        ngroups = _round_up(max(n, 1), 1024) // 1024
        base_max = pad_cols // 128 - 8
        per_group = []
        for g in range(ngroups):
            r0, r1 = g * 1024, min((g + 1) * 1024, n)
            lo, hi = int(a.indptr[r0]), int(a.indptr[r1])
            ecols = a.indices[lo:hi].astype(np.int64)
            erows = (np.repeat(np.arange(r0, r1),
                               np.diff(a.indptr[r0:r1 + 1])) - r0)
            evals = a.data[lo:hi]
            order = np.argsort(ecols, kind="stable")
            slots = []  # [base, occupied-rows, rmap {(su, r): q}, entries]
            for e in order:
                c, r = int(ecols[e]), int(erows[e])
                su = r >> 7
                placed = False
                for s in slots:
                    if not (128 * s[0] <= c < 128 * s[0] + 1024):
                        continue
                    if r in s[1]:
                        continue
                    q, rem = divmod(c - 128 * s[0], 128)
                    prev = s[2].get((su, rem))
                    if prev is not None and prev != q:
                        continue
                    s[1].add(r)
                    s[2][(su, rem)] = q
                    s[3].append((r, c, evals[e]))
                    placed = True
                    break
                if not placed:
                    b = min(max(c >> 7, 0), max(base_max, 0))
                    q, rem = divmod(c - 128 * b, 128)
                    slots.append([b, {r}, {(su, rem): q},
                                  [(r, c, evals[e])]])
            per_group.append(slots)
        return per_group

    @staticmethod
    def _pads(a: CSR, pad_rows_to, pad_cols_to) -> Tuple[int, int]:
        """(padded rows, padded columns), both multiples of 1024."""
        pr = _round_up(max(a.n_rows, 1), 1024)
        if pad_rows_to is not None:
            pr = max(pr, _round_up(pad_rows_to, 1024))
        pc = _round_up(max(a.n_cols, 1), 1024)
        if pad_cols_to is not None:
            pc = max(pc, _round_up(pad_cols_to, 1024))
        return pr, pc

    @staticmethod
    def pack_host(a: CSR, dtype=np.float32, pad_rows_to: int | None = None,
                  pad_cols_to: int | None = None):
        """Pack a host CSR into (vals, loc, base) numpy arrays."""
        pr, pc = WEll._pads(a, pad_rows_to, pad_cols_to)
        ngroups = pr // 1024

        try:
            from .native import lib as _native
        except Exception:
            _native = None
        if _native is not None:
            base, loc, vals = _native.well_pack(a, ngroups, pc)
            # native emits int32 (Q << 16) | r; re-encode to the int16
            # (Q << 7) | r storage format (lossless: Q < 8, r < 128)
            loc16 = (((loc >> 16) << 7) | (loc & 0x7F)).astype(np.int16)
            return vals.astype(np.dtype(dtype), copy=False), loc16, base

        per_group = WEll._pack_greedy_py(a, pc)
        S = max(max((len(s) for s in per_group), default=1), 1)
        vals = np.zeros((ngroups, S, 8, 128), dtype=np.dtype(dtype))
        loc = np.zeros((ngroups, S, 8, 128), dtype=np.int16)
        base = np.zeros((ngroups, S), dtype=np.int32)
        for g, slots in enumerate(per_group):
            for k, (b, _, rmap, entries) in enumerate(slots):
                base[g, k] = b
                for (r, c, v) in entries:
                    s, l = r >> 7, r & 127
                    vals[g, k, s, l] = v
                    loc[g, k, s, l] |= (c - 128 * b) & 127
                # Q table: lane j of sublane s holds the block of the
                # remainder-j entry
                for (s, rem), q in rmap.items():
                    loc[g, k, s, rem] |= q << 7
        return vals, loc, base

    @staticmethod
    def from_csr(a: CSR, dtype=torch.float32, pad_rows_to: int | None = None,
                 pad_cols_to: int | None = None, device="cpu",
                 classes: Optional[torch.Tensor] = None,
                 ring_devices: int | None = None) -> "WEll":
        """Pack a host CSR (values rounded from f64 to ``dtype``);
        ``classes`` groups the derived layout's rows by GS class;
        ``ring_devices`` (D > 1) sets ``ring_plan`` for a D-shard ring."""
        vals, loc, base = WEll.pack_host(a, dtype=np.float64,
                                         pad_rows_to=pad_rows_to,
                                         pad_cols_to=pad_cols_to)
        _, pc = WEll._pads(a, pad_rows_to, pad_cols_to)
        vt = _to_device(vals, dtype, "cpu")
        return WEll(vt, torch.from_numpy(loc), torch.from_numpy(base),
                    a.shape, a.nnz, pc,
                    ring_plan=WEll._plan(base, vt, pc, ring_devices),
                    classes=classes, device=device)

    @staticmethod
    def from_csr_df64(a: CSR, pad_rows_to: int | None = None,
                      pad_cols_to: int | None = None,
                      device="cpu",
                      classes: Optional[torch.Tensor] = None,
                      ring_devices: int | None = None,
                      groups: Optional[Tuple[int, int]] = None) -> "WEll":
        """Pack with the operator split into non-overlapping f32 planes
        (``vals = f32(v)``, ``vals_lo = f32(v - vals)``).  ``groups =
        (g0, g1)`` keeps the row groups ``[g0, g1)`` only, as
        :meth:`block` does, without a layout of the whole operator."""
        vals64, loc, base = WEll.pack_host(a, dtype=np.float64,
                                           pad_rows_to=pad_rows_to,
                                           pad_cols_to=pad_cols_to)
        hi = vals64.astype(np.float32)
        lo = (vals64 - hi.astype(np.float64)).astype(np.float32)
        _, pc = WEll._pads(a, pad_rows_to, pad_cols_to)
        plan = WEll._plan(base, torch.from_numpy(vals64), pc, ring_devices)
        g = slice(*groups) if groups is not None else slice(None)
        return WEll(torch.from_numpy(hi[g]), torch.from_numpy(loc[g]),
                    torch.from_numpy(base[g]), a.shape, a.nnz, pc,
                    vals_lo=torch.from_numpy(lo[g]), ring_plan=plan,
                    classes=classes, device=device)

    def block(self, g0: int, g1: int, device=None) -> "WEll":
        """Row groups ``[g0, g1)`` as an operator of their own: one
        process's block of a ring of row shards (the groups sharding of
        ``amg_tpu/parallel/dist.py:178-190``).  Its pack is a view of this
        pack's groups, on the host; its layout is derived on ``device``
        (default: this layout's) in row order, rows numbered from the
        block's first row (``g0 * 1024``).  Columns, ``shape``, ``nnz``,
        ``pad_cols`` and ``ring_plan`` stay the whole operator's."""
        dev = self.rows.vals.device if device is None else device
        return WEll(self.vals[g0:g1], self.loc[g0:g1], self.base[g0:g1],
                    self.shape, self.nnz, self.pad_cols,
                    vals_lo=(None if self.vals_lo is None
                             else self.vals_lo[g0:g1]),
                    ring_plan=self.ring_plan, device=dev)

    @staticmethod
    def from_numpy(vals, loc, base, shape, nnz: int, pad_cols: int,
                   vals_lo=None, device="cpu", dtype=None,
                   classes: Optional[torch.Tensor] = None) -> "WEll":
        """Wrap already-packed arrays (e.g. ``amg_tpu``'s ``WEll`` fields
        as numpy) without repacking.  ``dtype`` defaults to the values'
        own; pass ``torch.bfloat16`` for bf16 values handed over as float32
        (the widening is exact)."""
        vals = np.asarray(vals)
        if vals.ndim != 4 or vals.shape[2:] != (8, 128):
            raise ValueError(f"vals must be (ngroups, S, 8, 128); got "
                             f"{vals.shape}")
        dt = dtype if dtype is not None \
            else torch.from_numpy(np.empty(0, dtype=vals.dtype)).dtype
        lo = None
        if vals_lo is not None:
            lo = _to_device(np.asarray(vals_lo), torch.float32, "cpu")
        return WEll(_to_device(vals, dt, "cpu"),
                    torch.from_numpy(np.array(loc, dtype=np.int16)),
                    _to_device(np.asarray(base), torch.int32, "cpu"),
                    tuple(shape), int(nnz), int(pad_cols), vals_lo=lo,
                    classes=classes, device=device)

    def to_csr(self) -> CSR:
        vals = self.vals.cpu().double().numpy()
        if self.vals_lo is not None:
            vals = vals + self.vals_lo.cpu().double().numpy()
        loc = self.loc.cpu().numpy().astype(np.int64)
        base = self.base.cpu().numpy().astype(np.int64)
        g, k, s, l = np.nonzero(vals)
        rows = g * 1024 + s * 128 + l
        r = loc[g, k, s, l] & 127
        q = loc[g, k, s, r] >> 7      # Q table lives at lane = remainder
        cols = base[g, k] * 128 + q * 128 + r
        keep = rows < self.n_rows
        return CSR.from_coo(rows[keep], cols[keep], vals[g, k, s, l][keep],
                            self.shape)


# ---------------------------------------------------------------------------
# Device BandedBlocks format (RCM-ordered coarse levels)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BandedBlocks:
    """Block-banded dense storage for bandwidth-reduced coarse levels.

    ``vals[i, d, r, c] = A[128 i + r, 128 (i + d - nb) + c]``: block row
    ``i`` holds its ``2 nb + 1`` dense 128x128 blocks along the block
    band, the layout and contents of ``amg_tpu.sparse.BandedBlocks``.  The
    product is one batched 128x128 block matvec against shifted 128-row
    blocks of x (``ops/spmv.py``), with no gathers.  The level must be
    bandwidth-reduced first (reverse Cuthill-McKee in
    ``hierarchy.reorder_for_gs``); the fill is ``(2 nb + 1) * 128 * pad /
    nnz``, bounded there by ``AMGParams.banded_level_bytes``.
    """

    vals: torch.Tensor           # (nbr, 2*nb+1, 128, 128) dtype
    nb: int                      # block half-bandwidth
    shape: Tuple[int, int]
    nnz: int

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.vals.shape[0] * 128

    @staticmethod
    def block_bandwidth(a: CSR) -> int:
        """Max |block(col) - block(row)| over the pattern."""
        if a.nnz == 0:
            return 0
        return int(np.max(np.abs((a.indices.astype(np.int64) >> 7)
                                 - (a.row_indices >> 7))))

    @staticmethod
    def from_csr(a: CSR, dtype=torch.float64, nb: int | None = None,
                 pad_rows_to: int | None = None,
                 device="cpu") -> "BandedBlocks":
        """Pack a host CSR: the entries' flat positions are computed on the
        host and scattered into a zero tensor on ``device`` (only indices
        and values cross to the card).  Values round from f64 to ``dtype``
        through f32 for bf16, as :func:`_to_device` rounds them."""
        n = a.n_rows
        pad = _round_up(max(n, 1), 128)
        if pad_rows_to is not None:
            pad = max(pad, _round_up(pad_rows_to, 128))
        nbr = pad // 128
        if nb is None:
            nb = BandedBlocks.block_bandwidth(a)
        w = 2 * nb + 1
        rows = a.row_indices
        cols = a.indices.astype(np.int64)
        bi, r = rows >> 7, rows & 127
        d = (cols >> 7) - bi + nb
        if len(d) and (d.min() < 0 or d.max() >= w):
            raise ValueError("entries outside the declared block band")
        lin = ((bi * w + d) * 128 + r) * 128 + (cols & 127)
        dt = torch_dtype(dtype)
        flat = torch.zeros(nbr * w * 128 * 128, dtype=dt, device=device)
        flat[_to_device(lin, torch.int64, device)] = _to_device(
            a.data, dt, device)
        return BandedBlocks(flat.reshape(nbr, w, 128, 128), int(nb),
                            a.shape, a.nnz)

    def to_csr(self) -> CSR:
        vals = self.vals.cpu().double().numpy()
        bi, d, r, c = np.nonzero(vals)
        rows = bi * 128 + r
        cols = (bi + d - self.nb) * 128 + c
        keep = (rows < self.n_rows) & (cols >= 0) & (cols < self.n_cols)
        return CSR.from_coo(rows[keep], cols[keep],
                            vals[bi, d, r, c][keep], self.shape)
