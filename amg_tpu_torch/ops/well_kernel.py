"""WEll SpMV: the hand-written CUDA kernels and their plain PyTorch versions.

Port of ``amg_tpu/ops/pallas_well.py``: ``_build`` with its entry ``spmv``
(kernel B2) and ``_build_df64`` with its entry ``spmv_df64`` (kernel B3).
For a :class:`~amg_tpu_torch.sparse.WEll` operator ``a`` with ``ngroups``
row groups of 1024 rows and ``n_slots`` slots::

    spmv(a, x)       y = A x             (vals f32 or bf16 with x f32;
                                          vals f64 with x f64)
    spmv_df64(a, x)  y = (A_hi + A_lo) x  (a.vals, a.vals_lo f32; x f64)

Both return ``ngroups * 1024`` entries (padding rows are 0).  ``x`` may be
shorter than ``a.pad_cols``: columns at or past its length read 0, which
is what the TPU entries' zero-padded copy of x gives; a longer ``x`` is
read up to ``pad_cols`` only.  Values are widened exactly to the vector
type and the products accumulated in it (no bf16 product rule, unlike
the DIA kernel).

Dispatch is by the tensors' device: CUDA tensors launch the kernels in
``amg_tpu_torch/csrc/well_spmv.cu`` (built with ``nvcc`` on first use,
bound with ctypes) or raise; CPU tensors take the plain versions
(``*_plain``), the gather of ``amg_tpu/ops/spmv.py:50-63``, which the tests
and ``chip_smoke.py`` also use as the reference.  ``launches`` counts
kernel launches per entry, ``launches_by_shape`` per (entry, values dtype,
n_slots, ngroups).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_build import CudaLibrary

ENTRIES = ("spmv", "df64")
# kernel launches per entry (plain-version calls are not counted), and per
# (entry, values dtype, n_slots, ngroups) launch shape
launches = {e: 0 for e in ENTRIES}
launches_by_shape: dict = {}

# (values dtype, vector dtype) pairs of the B2 kernel
_PAIRS = {
    (torch.float32, torch.float32): "well_f32_f32",
    (torch.bfloat16, torch.float32): "well_bf16_f32",
    (torch.float64, torch.float64): "well_f64_f64",
}


def _bind(dll):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name in _PAIRS.values():
        fn = getattr(dll, name)
        fn.argtypes = [p, p, p, i64, i32, p, i64, p, p]
        fn.restype = i32
    dll.well_df64.argtypes = [p, p, p, p, i64, i32, p, i64, p, p]
    dll.well_df64.restype = i32


_LIB = CudaLibrary("well_spmv.cu", _bind)
SOURCE = _LIB.source


def build() -> str:
    """Compile ``csrc/well_spmv.cu`` unless its library is newer than it.
    Returns the library path."""
    return _LIB.build()


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _check(a, x, df64: bool):
    vals = a.vals
    ngroups, n_slots = a.base.shape
    tile = (ngroups, n_slots, 8, 128)
    for name, t in (("vals", vals), ("loc", a.loc),
                    ("vals_lo", a.vals_lo if df64 else None)):
        if t is not None and tuple(t.shape) != tile:
            raise ValueError(f"WEll {name} must be {tile}; got "
                             f"{tuple(t.shape)}")
    if a.loc.dtype != torch.int16 or a.base.dtype != torch.int32:
        raise TypeError(f"WEll loc must be int16 and base int32; got "
                        f"{a.loc.dtype}, {a.base.dtype}")
    if df64:
        if a.vals_lo is None:
            raise ValueError("spmv_df64 needs the vals_lo plane")
        if (vals.dtype, a.vals_lo.dtype, x.dtype) != (
                torch.float32, torch.float32, torch.float64):
            raise TypeError(f"spmv_df64 takes f32 value planes and an f64 "
                            f"vector; got ({vals.dtype}, {a.vals_lo.dtype}, "
                            f"{x.dtype})")
    elif (vals.dtype, x.dtype) not in _PAIRS:
        raise TypeError(f"unsupported (values, vector) dtypes "
                        f"({vals.dtype}, {x.dtype}); supported: "
                        f"{sorted((str(v), str(u)) for v, u in _PAIRS)}")
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D; got {tuple(x.shape)}")
    for name, t in (("loc", a.loc), ("base", a.base), ("x", x),
                    ("vals_lo", a.vals_lo if df64 else None)):
        if t is not None and t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, values on "
                             f"{vals.device}")


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU tensors; the reference on the card)
# ---------------------------------------------------------------------------


def gather_index(a) -> torch.Tensor:
    """Column of every slot entry, ``(base + Q[s, r]) * 128 + r`` with
    ``r = loc & 127`` and Q read at lane ``r`` of the same sublane."""
    loc = a.loc.to(torch.int64)
    r = loc & 127
    q = torch.gather(loc, 3, r) >> 7
    return (a.base.to(torch.int64)[:, :, None, None] + q) * 128 + r


def _padded_x(a, x):
    pc = a.pad_cols
    return F.pad(x, (0, pc - x.shape[0])) if x.shape[0] < pc else x[:pc]


def spmv_plain(a, x: torch.Tensor) -> torch.Tensor:
    _check(a, x, df64=False)
    y = torch.sum(a.vals.to(x.dtype) * _padded_x(a, x)[gather_index(a)],
                  dim=1)
    return y.reshape(-1)


def spmv_df64_plain(a, x: torch.Tensor) -> torch.Tensor:
    _check(a, x, df64=True)
    v = a.vals.to(torch.float64) + a.vals_lo.to(torch.float64)
    y = torch.sum(v * _padded_x(a, x)[gather_index(a)], dim=1)
    return y.reshape(-1)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def _launch(a, x, df64: bool) -> torch.Tensor:
    planes = [("vals", a.vals), ("loc", a.loc), ("base", a.base), ("x", x)]
    if df64:
        planes.append(("vals_lo", a.vals_lo))
    for name, t in planes:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ngroups, n_slots = a.base.shape
    lib = _LIB.load()
    y = torch.empty(ngroups * 1024, dtype=x.dtype, device=x.device)
    n_x = min(x.shape[0], a.pad_cols)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if df64:
        entry = "df64"
        err = lib.well_df64(a.vals.data_ptr(), a.vals_lo.data_ptr(),
                            a.loc.data_ptr(), a.base.data_ptr(), ngroups,
                            n_slots, x.data_ptr(), n_x, y.data_ptr(), stream)
    else:
        entry = "spmv"
        fn = getattr(lib, _PAIRS[(a.vals.dtype, x.dtype)])
        err = fn(a.vals.data_ptr(), a.loc.data_ptr(), a.base.data_ptr(),
                 ngroups, n_slots, x.data_ptr(), n_x, y.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"WEll kernel launch failed: CUDA error {err}")
    launches[entry] += 1
    key = (entry, a.vals.dtype, n_slots, ngroups)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return y


def _is_cuda(a, x) -> bool:
    return x.is_cuda or a.vals.is_cuda


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
