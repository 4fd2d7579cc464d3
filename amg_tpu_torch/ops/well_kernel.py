"""WEll SpMV: the hand-written CUDA kernels and their plain PyTorch versions.

Port of ``amg_tpu/ops/pallas_well.py``: ``_build`` with its entry ``spmv``
(kernel B2) and ``_build_df64`` with its entry ``spmv_df64`` (kernel B3).
The kernels read the operator's row-slice layout ``a.rows``
(:class:`~amg_tpu_torch.sparse.RowSlices`, derived from the WEll pack when
the operator is made: no padding slots, one thread per row)::

    spmv(a, x)        y = A x             (vals f32 or bf16 with x f32;
                                           vals f64 with x f64)
    spmv_df64(a, x)   y = (A_hi + A_lo) x  (two f32 planes; x f64)
    spmv_window(a, xw, col0)       y = A x  with x[c] read at xw[c - col0]
    spmv_df64_window(a, xw, col0)  the same in f64 through B3
    gs_update_(a, x, b, g, diag, inv_diag, relax=None)
                      the Gauss-Seidel update of GS class g, IN PLACE on x:
                      x_i <- (b_i - (Ax)_i + d_i x_i) / d_i for the rows i
                      of class g with inv_diag_i != 0 (relaxed with
                      ``relax``), one launch over that class's slices

The window entries are the local products of a ring of row shards
(``amg_tpu_torch.parallel.halo``, the port of ``amg_tpu``'s
``pallas_well._build`` / ``_build_df64`` run per shard on a rebased x
window, ``halo.py:263-346, 450-516``): ``a`` holds the row groups of one
process's shards (:meth:`~amg_tpu_torch.sparse.WEll.block`), ``xw`` that
process's haloed block of x, whose first entry is global column ``col0``,
and a column ``c`` reads ``xw[c - col0]`` where that lies in ``xw`` and 0
elsewhere (beyond the mesh edges).  They are B2 and B3 with the column
base a parameter; the single-vector entries pass ``col0 = 0``, so a window
product equals the single-device one bit for bit on the same x values.

``spmv``/``spmv_df64`` and the window entries return ``a.padded_rows``
entries (padding rows are 0).  ``x`` may be shorter than ``a.pad_cols``:
columns at or past its length read 0, which is what the TPU entries'
zero-padded copy of x gives; a longer ``x`` is read up to ``pad_cols``
only (the window entries read all of ``xw``).  Values are widened
exactly to the vector type and the products accumulated in it (no bf16
product rule, unlike the DIA kernel).

Dispatch is by the tensors' device: CUDA tensors launch the kernels in
``amg_tpu_torch/csrc/well_spmv.cu`` (built with ``nvcc`` on first use,
bound with ctypes) or raise; CPU tensors take the plain versions
(``*_plain``), which the tests and ``chip_smoke.py`` also use as the
reference.  ``launches`` counts kernel launches per entry (a CUDA
graph's replays as ``solve.loop_graph.StepGraph`` adds them; the window
entries as ``"window"`` and ``"df64_window"``), ``launches_by_shape`` per
(entry, values dtype, rows, nnz); a block operator keeps its whole
operator's rows and nnz.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary

ENTRIES = ("spmv", "df64", "gs", "window", "df64_window")
# kernel launches per entry (plain-version calls are not counted), and per
# (entry, values dtype, rows, nnz) launch shape
launches = {e: 0 for e in ENTRIES}
launches_by_shape: dict = {}

# (values dtype, vector dtype) pairs of B2 -> suffix of its C entries
_PAIRS = {
    (torch.float32, torch.float32): "f32_f32",
    (torch.bfloat16, torch.float32): "bf16_f32",
    (torch.float64, torch.float64): "f64_f64",
}


def _bind(dll):
    p, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_double)
    for pair in _PAIRS.values():
        for name, args in (
                # vals, cols, slice_ptr, row_len, row_idx, n_slot_rows,
                # x, n_x, col0, y, stream
                (f"rows_spmv_{pair}", [p, p, p, p, p, i64, p, i64, i64, p,
                                       p]),
                # vals, cols, slice_ptr, row_len, row_idx, first slot row,
                # n_slot_rows, x, n_x, b, diag, inv_diag, 1 - relax, relax,
                # has_relax, stream
                (f"rows_gs_{pair}", [p, p, p, p, p, i64, i64, p, i64, p, p,
                                     p, f64, f64, i32, p])):
            fn = getattr(dll, name)
            fn.argtypes = args
            fn.restype = i32
    dll.rows_df64.argtypes = [p, p, p, p, p, p, i64, p, i64, i64, p, p]
    dll.rows_df64.restype = i32


_LIB = CudaLibrary("well_spmv.cu", _bind)
SOURCE = _LIB.source


def build() -> str:
    """Compile ``csrc/well_spmv.cu`` unless its library is newer than it.
    Returns the library path."""
    return _LIB.build()


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _check_dtypes(vals, vals_lo, x, df64: bool):
    if df64:
        if vals_lo is None:
            raise ValueError("spmv_df64 needs the vals_lo plane")
        if (vals.dtype, vals_lo.dtype, x.dtype) != (
                torch.float32, torch.float32, torch.float64):
            raise TypeError(f"spmv_df64 takes f32 value planes and an f64 "
                            f"vector; got ({vals.dtype}, {vals_lo.dtype}, "
                            f"{x.dtype})")
    elif (vals.dtype, x.dtype) not in _PAIRS:
        raise TypeError(f"unsupported (values, vector) dtypes "
                        f"({vals.dtype}, {x.dtype}); supported: "
                        f"{sorted((str(v), str(u)) for v, u in _PAIRS)}")
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D; got {tuple(x.shape)}")


def _check_devices(named, device):
    for name, t in named:
        if t is not None and t.device != device:
            raise ValueError(f"{name} is on {t.device}, values on {device}")


def _check(a, x, df64: bool):
    """The row-slice layout's planes against x."""
    s = a.rows
    _check_dtypes(s.vals, s.vals_lo if df64 else None, x, df64)
    if s.cols.dtype != torch.int32 or s.row_len.dtype != torch.int32 or \
            s.row_idx.dtype != torch.int32 or s.slice_ptr.dtype != torch.int64:
        raise TypeError("row slices need int32 cols, row_len, row_idx and "
                        "int64 slice_ptr")
    _check_devices((("cols", s.cols), ("slice_ptr", s.slice_ptr),
                    ("row_len", s.row_len), ("row_idx", s.row_idx),
                    ("x", x), ("vals_lo", s.vals_lo if df64 else None)),
                   s.vals.device)


def _check_gs(a, x, b, g, diag, inv_diag):
    _check(a, x, df64=False)
    first, n = a.rows.class_segment(g)
    pr = a.padded_rows
    for name, t in (("x", x), ("b", b), ("diag", diag),
                    ("inv_diag", inv_diag)):
        if t.dim() != 1 or t.shape[0] != pr or t.dtype != x.dtype:
            raise ValueError(f"{name} must be ({pr},) {x.dtype}; got "
                             f"{tuple(t.shape)} {t.dtype}")
    _check_devices((("b", b), ("diag", diag), ("inv_diag", inv_diag)),
                   a.rows.vals.device)
    return first, n


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tensors; the reference on the card)
# ---------------------------------------------------------------------------


def _x_at(a, x, cols, col0):
    """x at the columns ``cols`` (int64): ``x[c - col0]`` where that lies
    in x (and, for a whole vector, below ``pad_cols``), else 0."""
    n_x = x.shape[0] if col0 is not None else min(x.shape[0], a.pad_cols)
    k = cols - (col0 or 0)
    inside = (k >= 0) & (k < n_x)
    if n_x == 0:
        return torch.zeros(k.shape, dtype=x.dtype, device=x.device)
    return torch.where(inside, x[k.clamp(0, n_x - 1)],
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _slot_sums(a, x, first: int, n: int, df64: bool,
               col0=None) -> torch.Tensor:
    """``(A x)`` of the ``32 n`` slot rows of slices ``[first, first +
    n)``: a gather of x at the entries' columns and a row sum.  ``col0``
    (window entries): the column of ``x[0]``."""
    s = a.rows
    place, slot = s.entries(first, n)
    v = s.vals[place].to(x.dtype)
    if df64:
        v = v + s.vals_lo[place].to(x.dtype)
    prod = v * _x_at(a, x, s.cols[place].long(), col0)
    out = torch.zeros(n * 32, dtype=x.dtype, device=x.device)
    return out.index_add_(0, slot - first * 32, prod)


def _product_plain(a, x, df64: bool, col0=None) -> torch.Tensor:
    _check(a, x, df64)
    s = a.rows
    y_slot = _slot_sums(a, x, 0, s.n_slices, df64, col0)
    used = s.row_idx >= 0
    # NaN marks a row no segment covers (the kernel would leave it unset)
    y = torch.full((a.padded_rows,), float("nan"), dtype=x.dtype,
                   device=x.device)
    y[s.row_idx[used].long()] = y_slot[used]
    return y


def spmv_plain(a, x: torch.Tensor) -> torch.Tensor:
    return _product_plain(a, x, df64=False)


def spmv_df64_plain(a, x: torch.Tensor) -> torch.Tensor:
    return _product_plain(a, x, df64=True)


def spmv_window_plain(a, xw: torch.Tensor, col0: int) -> torch.Tensor:
    return _product_plain(a, xw, df64=False, col0=int(col0))


def spmv_df64_window_plain(a, xw: torch.Tensor, col0: int) -> torch.Tensor:
    return _product_plain(a, xw, df64=True, col0=int(col0))


def _gs_epilogue(ax, xr, br, dr, wr, relax):
    """The masked GS update of smoothers._masked_group_update, on the
    rows' own entries."""
    t = (br - ax + dr * xr) * wr
    if relax is not None:
        t = (1.0 - relax) * xr + relax * t
    return torch.where(wr != 0, t, xr)


def gs_update_plain_(a, x, b, g: int, diag, inv_diag, relax=None):
    """Plain version of :func:`gs_update_`; updates ``x`` in place and
    returns it."""
    first, n = _check_gs(a, x, b, g, diag, inv_diag)
    ax = _slot_sums(a, x, first, n, df64=False)
    rows = a.rows.row_idx[first * 32:(first + n) * 32]
    used = rows >= 0
    rows = rows[used].long()
    x[rows] = _gs_epilogue(ax[used], x[rows], b[rows], diag[rows],
                           inv_diag[rows], relax)
    return x


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _contiguous(named):
    for name, t in named:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _count(entry, a, err):
    if err != 0:
        raise RuntimeError(f"WEll kernel launch failed ({entry}): CUDA "
                           f"error {err}")
    launches[entry] += 1
    key = (entry, a.rows.vals.dtype, a.n_rows, a.nnz)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _layout_ptrs(s):
    return (s.vals.data_ptr(), s.cols.data_ptr(), s.slice_ptr.data_ptr(),
            s.row_len.data_ptr(), s.row_idx.data_ptr())


def _launch(a, x, df64: bool, col0=None) -> torch.Tensor:
    """Launch B3 (``df64``) or B2 over every slice; ``col0`` set: the
    window entry, x read at ``c - col0``."""
    s = a.rows
    _contiguous((("cols", s.cols), ("vals", s.vals), ("x", x),
                 ("vals_lo", s.vals_lo if df64 else None)))
    lib = _LIB.load()
    y = torch.empty(a.padded_rows, dtype=x.dtype, device=x.device)
    n_x = x.shape[0] if col0 is not None else min(x.shape[0], a.pad_cols)
    rest = (s.n_slices * 32, x.data_ptr(), n_x, int(col0 or 0),
            y.data_ptr(), _stream(x))
    if df64:
        err = lib.rows_df64(s.vals.data_ptr(), s.vals_lo.data_ptr(),
                            *_layout_ptrs(s)[1:], *rest)
    else:
        fn = getattr(lib, f"rows_spmv_{_PAIRS[(s.vals.dtype, x.dtype)]}")
        err = fn(*_layout_ptrs(s), *rest)
    entry = "df64" if df64 else "spmv"
    _count(entry if col0 is None else
           ("window" if entry == "spmv" else "df64_window"), a, err)
    return y


def _launch_gs(a, x, b, first, n, diag, inv_diag, relax):
    s = a.rows
    _contiguous((("cols", s.cols), ("vals", s.vals), ("x", x), ("b", b),
                 ("diag", diag), ("inv_diag", inv_diag)))
    if n == 0:
        return x
    fn = getattr(_LIB.load(), f"rows_gs_{_PAIRS[(s.vals.dtype, x.dtype)]}")
    err = fn(*_layout_ptrs(s), first * 32, n * 32, x.data_ptr(),
             min(x.shape[0], a.pad_cols), b.data_ptr(), diag.data_ptr(),
             inv_diag.data_ptr(), 0.0 if relax is None else 1.0 - relax,
             0.0 if relax is None else float(relax), int(relax is not None),
             _stream(x))
    _count("gs", a, err)
    return x


def _is_cuda(a, x) -> bool:
    return x.is_cuda or a.rows.vals.is_cuda


def spmv(a, x: torch.Tensor) -> torch.Tensor:
    """y = A x (kernel B2 on CUDA tensors, plain version on CPU tensors)."""
    if not _is_cuda(a, x):
        return spmv_plain(a, x)
    _check(a, x, df64=False)
    return _launch(a, x, df64=False)


def spmv_df64(a, x: torch.Tensor) -> torch.Tensor:
    """y = (A_hi + A_lo) x in f64 (kernel B3 on CUDA tensors)."""
    if not _is_cuda(a, x):
        return spmv_df64_plain(a, x)
    _check(a, x, df64=True)
    return _launch(a, x, df64=True)


def spmv_window(a, xw: torch.Tensor, col0: int) -> torch.Tensor:
    """y = A x for a block operator with x given as the window ``xw``
    whose first entry is column ``col0``: B2's window entry on CUDA
    tensors, its plain version on CPU tensors."""
    if not _is_cuda(a, xw):
        return spmv_window_plain(a, xw, col0)
    _check(a, xw, df64=False)
    return _launch(a, xw, df64=False, col0=col0)


def spmv_df64_window(a, xw: torch.Tensor, col0: int) -> torch.Tensor:
    """The f64 product of :func:`spmv_window`: B3's window entry."""
    if not _is_cuda(a, xw):
        return spmv_df64_window_plain(a, xw, col0)
    _check(a, xw, df64=True)
    return _launch(a, xw, df64=True, col0=col0)


def gs_update_(a, x, b, g: int, diag, inv_diag, relax=None):
    """Gauss-Seidel update of GS class ``g`` of a class-grouped WEll
    operator, in place on ``x`` (the sweep's private copy), which it
    returns: kernel B2's ``gs`` entry on CUDA tensors.  In-place is exact
    Gauss-Seidel because rows of one class do not couple: a row reads only
    other classes' entries of x and its own."""
    if not _is_cuda(a, x):
        return gs_update_plain_(a, x, b, g, diag, inv_diag, relax)
    first, n = _check_gs(a, x, b, g, diag, inv_diag)
    return _launch_gs(a, x, b, first, n, diag, inv_diag, relax)
