"""DIA SpMV with fused epilogues, and its multi-rhs variant: the
hand-written CUDA kernels and their plain PyTorch versions.

Port of ``amg_tpu/ops/pallas_dia.py::_build`` (kernel B1) with its entries
``spmv``, ``resid`` and ``gs_update``, and of ``_build_multi`` (kernel B4)
with its entry ``spmv_multi``.  For a :class:`~amg_tpu_torch.sparse.Dia`
operator ``a`` with values ``(nd, pad)``, vectors of length ``pad`` and
batches ``X`` of ``k`` vectors, ``(k, pad)``::

    spmv(a, x)            y = A x
    resid(a, x, b)        y = b - A x
    gs_update(a, x, b, w) y = x + w * (b - A x)   (needs the main diagonal)
    spmv_multi(a, X)      Y[c] = A X[c]           (values read once for all c)

where ``(A x)[i] = sum_d vals[d, i] * x[i + off_d]`` and ``x`` reads 0
outside ``[0, pad)``.  Supported (values, vectors) dtypes: (f32, f32),
(bf16, f32) and (f64, f64).  With bf16 values, f32 vectors and nd >= 32
each product takes bf16 operands (x is rounded to bf16) and is accumulated
in f32, the rule of ``pallas_dia.py:140-141``; the product of two bf16
values is exact in f32 and is not rounded again, which is what the Pallas
kernel computes when run on the CPU (interpret mode).  Below 32 diagonals
the values are widened and multiplied in f32.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch
the kernel in ``amg_tpu_torch/csrc/dia_spmv.cu`` (built with ``nvcc`` on
first use into ``amg_tpu_torch/build/``, bound with ctypes) or raise; CPU
tensors take the plain version (``*_plain``), which the tests and
``chip_smoke.py`` also use as the reference.  ``launches`` counts kernel
launches per epilogue (B1) and under ``"multi"`` (B4).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_build import CudaLibrary

EPILOGUES = ("spmv", "resid", "update")
# kernel launches per B1 epilogue and of B4 ("multi"; plain-version calls
# are not counted), and per launch shape: (epilogue, values dtype, vector
# dtype, nd, pad) for B1, ("multi", values dtype, vector dtype, nd, pad, k)
# for B4
launches = {e: 0 for e in EPILOGUES + ("multi",)}
launches_by_shape: dict = {}

# (values dtype, vector dtype) pairs the kernels are instantiated for; the
# B4 entry of a pair is "dia_multi" + the B1 entry's suffix
_PAIRS = {
    (torch.float32, torch.float32): "dia_f32_f32",
    (torch.bfloat16, torch.float32): "dia_bf16_f32",
    (torch.float64, torch.float64): "dia_f64_f64",
}
# offsets live in shared memory: 48 KB of int32
_MAX_DIAGS = 12288


def bf16_products(nd: int, vals_dtype, x_dtype) -> bool:
    """The product rule of ``pallas_dia.py:140-141`` (with its default
    ``AMG_DIA_BF16_MUL=1``): bf16 products only on wide bands of bf16
    values applied to f32 vectors."""
    return nd >= 32 and vals_dtype == torch.bfloat16 \
        and x_dtype == torch.float32


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def _bind(dll):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    common = [p, p, i32, i64, p, p, p, p, i32]
    for name in ("dia_f32_f32", "dia_f64_f64"):
        fn = getattr(dll, name)
        fn.argtypes = common + [p]
        fn.restype = i32
    dll.dia_bf16_f32.argtypes = common + [i32, p]
    dll.dia_bf16_f32.restype = i32
    multi = [p, p, i32, i64, i32, p, p]
    for name in ("dia_multi_f32_f32", "dia_multi_f64_f64"):
        fn = getattr(dll, name)
        fn.argtypes = multi + [p]
        fn.restype = i32
    dll.dia_multi_bf16_f32.argtypes = multi + [i32, p]
    dll.dia_multi_bf16_f32.restype = i32


_LIB = CudaLibrary("dia_spmv.cu", _bind)
SOURCE = _LIB.source


def build() -> str:
    """Compile ``csrc/dia_spmv.cu`` into ``build/libdia_spmv.so`` unless
    the library is newer than the source.  Returns the library path."""
    return _LIB.build()


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _check(a, x, b=None, w=None, epilogue="spmv"):
    vals = a.vals
    if vals.dim() != 2 or vals.shape[0] != len(a.offsets):
        raise ValueError(f"Dia values must be (nd, pad); got "
                         f"{tuple(vals.shape)} for {len(a.offsets)} offsets")
    pad = vals.shape[1]
    if (vals.dtype, x.dtype) not in _PAIRS:
        raise TypeError(f"unsupported (values, vector) dtypes "
                        f"({vals.dtype}, {x.dtype}); supported: "
                        f"{sorted((str(v), str(u)) for v, u in _PAIRS)}")
    if epilogue == "update" and 0 not in a.offsets:
        raise ValueError("update epilogue requires the main diagonal")
    if epilogue == "multi" and (x.dim() != 2 or x.shape[0] < 1
                                or x.shape[1] != pad):
        raise ValueError(f"X must be (k, {pad}) with k >= 1; got "
                         f"{tuple(x.shape)}")
    for name, t in (("x", x), ("b", b), ("w", w)):
        if t is None:
            continue
        if epilogue != "multi" and (t.dim() != 1 or t.shape[0] != pad):
            raise ValueError(f"{name} must be ({pad},); got {tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, values on "
                             f"{vals.device}")
    if a.offs.device != vals.device:
        raise ValueError("offsets tensor and values on different devices")


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU tensors; the reference on the card)
# ---------------------------------------------------------------------------


def _acc_plain(a, x):
    """sum_d vals[d] * x shifted by off_d, over a zero-padded x, summed in
    offsets order (as the XLA path ``amg_tpu.ops.spmv.spmv_dia`` does).
    ``x`` is one vector ``(pad,)`` or a batch ``(k, pad)``, shifted along
    its last axis."""
    pad = a.vals.shape[1]
    offs = a.offsets
    lo = max(-min(offs), 0) if offs else 0
    hi = max(max(offs), 0) if offs else 0
    xp = F.pad(x, (lo, hi))
    bf16 = bf16_products(len(offs), a.vals.dtype, x.dtype)
    if bf16:
        xp = xp.to(torch.bfloat16)
    acc = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    for k, off in enumerate(offs):
        xs = xp[..., lo + off: lo + off + pad]
        if bf16:
            # bf16 operands, exact f32 product
            acc = acc + a.vals[k].to(x.dtype) * xs.to(x.dtype)
        else:
            acc = acc + a.vals[k].to(x.dtype) * xs
    return acc


def spmv_plain(a, x: torch.Tensor) -> torch.Tensor:
    _check(a, x)
    return _acc_plain(a, x)


def resid_plain(a, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, x, b, epilogue="resid")
    return b - _acc_plain(a, x)


def gs_update_plain(a, x: torch.Tensor, b: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    _check(a, x, b, w, epilogue="update")
    return x + w * (b - _acc_plain(a, x))


def spmv_multi_plain(a, x: torch.Tensor) -> torch.Tensor:
    """Y = A X for a batch ``X`` of shape ``(k, pad)``: per column, the
    same arithmetic as :func:`spmv_plain`."""
    _check(a, x, epilogue="multi")
    return _acc_plain(a, x)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def _launch(a, x, b, w, epilogue: str) -> torch.Tensor:
    """Launch B1 (epilogue spmv, resid or update) or B4 (``"multi"``, x a
    ``(k, pad)`` batch) on the current stream; count the launch."""
    vals = a.vals
    nd, pad = len(a.offsets), vals.shape[1]
    if nd > _MAX_DIAGS:
        raise ValueError(f"{nd} diagonals exceed the kernel's {_MAX_DIAGS}")
    for name, t in (("values", vals), ("offsets", a.offs), ("x", x),
                    ("b", b), ("w", w)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.offs.dtype != torch.int32 or a.offs.numel() != nd:
        raise ValueError("offsets tensor must be int32 of length nd")
    lib = _LIB.load()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    name = _PAIRS[(vals.dtype, x.dtype)]
    if epilogue == "multi":
        k = x.shape[0]
        args = [vals.data_ptr(), a.offs.data_ptr(), nd, pad, k, x.data_ptr(),
                y.data_ptr()]
        name = "dia_multi" + name[3:]
        key = (epilogue, vals.dtype, x.dtype, nd, pad, k)
    else:
        args = [vals.data_ptr(), a.offs.data_ptr(), nd, pad, x.data_ptr(),
                b.data_ptr() if b is not None else None,
                w.data_ptr() if w is not None else None,
                y.data_ptr(), EPILOGUES.index(epilogue)]
        key = (epilogue, vals.dtype, x.dtype, nd, pad)
    if vals.dtype == torch.bfloat16:
        args.append(int(bf16_products(nd, vals.dtype, x.dtype)))
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"DIA kernel launch failed: CUDA error {err}")
    launches[epilogue] += 1
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return y


def _is_cuda(a, x) -> bool:
    return x.is_cuda or a.vals.is_cuda


def spmv(a, x: torch.Tensor) -> torch.Tensor:
    """y = A x (kernel on CUDA tensors, plain version on CPU tensors)."""
    if not _is_cuda(a, x):
        return spmv_plain(a, x)
    _check(a, x)
    return _launch(a, x, None, None, "spmv")


def resid(a, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = b - A x in one pass."""
    if not _is_cuda(a, x):
        return resid_plain(a, x, b)
    _check(a, x, b, epilogue="resid")
    return _launch(a, x, b, None, "resid")


def gs_update(a, x: torch.Tensor, b: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """x + w * (b - A x) in one pass: the masked-GS group update
    (w = group-masked inverse diagonal), weighted Jacobi or L1-Jacobi."""
    if not _is_cuda(a, x):
        return gs_update_plain(a, x, b, w)
    _check(a, x, b, w, epilogue="update")
    return _launch(a, x, b, w, "update")


def spmv_multi(a, x: torch.Tensor) -> torch.Tensor:
    """Y = A X for a batch ``X`` of shape ``(k, pad)``, the values read once
    for all k columns (kernel B4 on CUDA tensors, plain version on CPU
    tensors)."""
    if not _is_cuda(a, x):
        return spmv_multi_plain(a, x)
    _check(a, x, epilogue="multi")
    return _launch(a, x, None, None, "multi")
