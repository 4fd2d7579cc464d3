"""The product of a Dense operator stored in bf16 with an f32 vector: the
hand-written CUDA kernel (D1) and its plain PyTorch version.

D1 replaces no Pallas kernel: it is what XLA makes of ``amg_tpu``'s
``spmv_dense`` (``amg_tpu/ops/spmv.py:134-136``) when a Dense level's
values are bf16 (``coarse_op_dtype="bfloat16"``) and the cycle runs in
f32, a dot that reads each value as stored and widens it on the way.  The
plain version widens the whole operator to an f32 copy first and
multiplies the copy::

    spmv(a, x)                  y = A x                 (a.padded_rows,)
    spmv(a, x, start, size)     rows [start, start + size) of A x   (size,)

``a`` is a :class:`~amg_tpu_torch.sparse.Dense` operator with bf16 values
``(padded_rows, padded_cols)`` (a view of whole rows with any row stride),
``x`` one f32 vector of at least ``padded_cols`` entries, of which the
first ``padded_cols`` are read.  Each product and the sum are taken in
f32; the kernel sums in another order than the plain version's gemv, and
its order depends on the columns only, so a row range gives the rows of
the whole product bit for bit.

Dispatch is by the tensors' device: CUDA tensors launch the kernel in
``amg_tpu_torch/csrc/dense_gemv.cu`` (built with ``nvcc`` on first use,
bound with ctypes) or raise; CPU tensors take :func:`spmv_plain`, which
the tests and ``chip_smoke.py`` also use as the reference.  Callers route
here the case :func:`takes` names (``ops/spmv.py::spmv_dense``,
``solve/smoothers.py::_range_update_dense_``); an f32 or f64 operator, and
a batch of vectors, keep their matmul.  ``launches`` counts kernel
launches (a CUDA graph's replays as ``solve.loop_graph.StepGraph`` adds
them), ``launches_by_shape`` per ``("spmv", rows, cols)``.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary

ENTRIES = ("spmv",)
# kernel launches per entry (plain-version calls are not counted), and per
# ("spmv", rows launched, columns) launch shape
launches = {e: 0 for e in ENTRIES}
launches_by_shape: dict = {}


def takes(a, x: torch.Tensor) -> bool:
    """True for the product D1 computes: bf16 values, one f32 vector."""
    return x.dim() == 1 and a.vals.dtype == torch.bfloat16 \
        and x.dtype == torch.float32


def _bind(dll):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # a, ld, rows, cols, vec, x, y, stream
    dll.dense_gemv_bf16_f32.argtypes = [p, i64, i64, i64, i32, p, p, p]
    dll.dense_gemv_bf16_f32.restype = i32


_LIB = CudaLibrary("dense_gemv.cu", _bind)
SOURCE = _LIB.source


def build() -> str:
    """Compile ``csrc/dense_gemv.cu`` unless its library is newer than it.
    Returns the library path."""
    return _LIB.build()


def _rows(a, x: torch.Tensor, start: int, size) -> tuple:
    """(the values of the rows, their count); raises on what D1 does not
    take."""
    vals = a.vals
    if not takes(a, x):
        raise TypeError(f"D1 takes bf16 values and one f32 vector; got "
                        f"{vals.dtype} values and a {x.dtype} tensor of "
                        f"shape {tuple(x.shape)}")
    if vals.dim() != 2:
        raise ValueError(f"Dense values must be 2-D; got {tuple(vals.shape)}")
    pr, pc = vals.shape
    size = pr - start if size is None else size
    if start < 0 or size < 0 or start + size > pr:
        raise ValueError(f"rows [{start}, {start + size}) outside the "
                         f"operator's {pr}")
    if x.shape[0] < pc:
        raise ValueError(f"x has {x.shape[0]} entries, the operator "
                         f"{pc} columns")
    if x.device != vals.device:
        raise ValueError(f"x is on {x.device}, values on {vals.device}")
    return vals[start:start + size], size


def spmv_plain(a, x: torch.Tensor, start: int = 0,
               size: int | None = None) -> torch.Tensor:
    """Rows ``[start, start + size)`` of ``A x``: the values widened to
    f32, then one matmul."""
    sub, _ = _rows(a, x, start, size)
    return sub.to(x.dtype) @ x[: a.padded_cols]


def _launch(sub, x: torch.Tensor, size: int) -> torch.Tensor:
    """Launch D1 on the current stream over the rows ``sub``; count the
    launch."""
    cols = sub.shape[1]
    if sub.stride(1) != 1 or x.stride(0) != 1:
        raise ValueError("values and x must be contiguous along columns")
    # a one-row view may carry any row stride
    ld = sub.stride(0) if size > 1 else cols
    vec = (cols % 8 == 0 and ld % 8 == 0 and sub.data_ptr() % 16 == 0
           and x.data_ptr() % 16 == 0)
    y = torch.empty(size, dtype=x.dtype, device=x.device)
    err = _LIB.load().dense_gemv_bf16_f32(
        sub.data_ptr(), ld, size, cols, int(vec), x.data_ptr(),
        y.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"D1 launch failed: CUDA error {err}")
    launches["spmv"] += 1
    key = ("spmv", size, cols)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return y


def spmv(a, x: torch.Tensor, start: int = 0,
         size: int | None = None) -> torch.Tensor:
    """Rows ``[start, start + size)`` of ``A x`` (all rows by default):
    D1 on CUDA tensors, :func:`spmv_plain` on CPU tensors."""
    if not (x.is_cuda or a.vals.is_cuda):
        return spmv_plain(a, x, start, size)
    sub, size = _rows(a, x, start, size)
    return _launch(sub, x, size)
