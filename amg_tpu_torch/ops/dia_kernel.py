"""DIA SpMV with fused epilogues, for one vector and for a batch: the
hand-written CUDA kernels and their plain PyTorch versions.

Port of ``amg_tpu/ops/pallas_dia.py::_build`` (kernel B1) with its entries
``spmv``, ``resid`` and ``gs_update``, and of ``_build_multi`` (kernel B4)
with its entry ``spmv_multi``; B4 also takes B1's two fused epilogues, over
the batch.  For a :class:`~amg_tpu_torch.sparse.Dia` operator ``a`` with
values ``(nd, pad)``, vectors of length ``pad`` and batches ``X``, ``B`` of
``k`` vectors, ``(k, pad)``::

    spmv(a, x)                  y = A x
    resid(a, x, b)              y = b - A x
    gs_update(a, x, b, w)       y = x + w * (b - A x)   (needs the main diagonal)
    spmv_multi(a, X)            Y[c] = A X[c]           (values read once for all c)
    resid_multi(a, X, B)        Y[c] = B[c] - A X[c]
    gs_update_multi(a, X, B, w) Y[c] = X[c] + w * (B[c] - A X[c])   (w (pad,))
    spmv_window(a, XW, lo)      Y[s, i] = sum_d vals[d, s*m + i] * XW[s, lo + i + off_d]

where ``(A x)[i] = sum_d vals[d, i] * x[i + off_d]`` and ``x`` reads 0
outside ``[0, pad)``.  ``spmv_window`` is B1's window entry (the port of
``pallas_dia.py::spmv_window``, ``:495-503``), the local product of a
row-sharded ring (``amg_tpu_torch.parallel.halo``): ``a`` holds the
values of ``S`` shards of ``m`` rows as ``(nd, S*m)`` (a view with any row
stride), ``XW`` is ``(S, lo + m + hi)``, shard ``s``'s haloed window of x
``[lo left halo | its m rows | hi right halo]`` (windows may overlap in
memory: any shard stride), and each window reads 0 outside its bounds.
One launch covers the S shards.  Supported (values, vectors) dtypes: (f32, f32),
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
``chip_smoke.py`` also use as the reference.  B1 reads ``x`` through
shared-memory windows laid out by :func:`plan`.  ``launches``
counts kernel launches per B1 epilogue (:data:`EPILOGUES`) and per B4
epilogue (:data:`MULTI`); a call made while a CUDA graph is captured is
counted too, and the code that captures takes those counts back and adds
them again at every replay (``solve.loop_graph.StepGraph``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import CudaLibrary

EPILOGUES = ("spmv", "resid", "update")            # B1
MULTI = ("multi", "multi_resid", "multi_update")   # B4, the same epilogues
WINDOW = "window"                                  # B1's window entry
# kernel launches per epilogue (plain-version calls are not counted), and
# per launch shape: (epilogue, values dtype, vector dtype, nd, pad) for B1,
# (epilogue, values dtype, vector dtype, nd, pad, k) for B4 and
# ("window", values dtype, vector dtype, nd, m, S) for the window entry
launches = {e: 0 for e in EPILOGUES + MULTI + (WINDOW,)}
launches_by_shape: dict = {}

# (values dtype, vector dtype) pairs the kernels are instantiated for; the
# B4 entry of a pair is "dia_multi" + the B1 entry's suffix
_PAIRS = {
    (torch.float32, torch.float32): "dia_f32_f32",
    (torch.bfloat16, torch.float32): "dia_bf16_f32",
    (torch.float64, torch.float64): "dia_f64_f64",
}
# B4 keeps the offsets in shared memory: 48 KB of int32
_MAX_DIAGS = 12288
# the widest run of offsets read through one shared-memory window
# (kMaxSpan in csrc/dia_spmv.cu), and the most segments a plan holds
WINDOW_SPAN = 256
MAX_SEGMENTS = 64


def bf16_products(nd: int, vals_dtype, x_dtype) -> bool:
    """The product rule of ``pallas_dia.py:140-141`` (with its default
    ``AMG_DIA_BF16_MUL=1``): bf16 products only on wide bands of bf16
    values applied to f32 vectors."""
    return nd >= 32 and vals_dtype == torch.bfloat16 \
        and x_dtype == torch.float32


@functools.lru_cache(maxsize=256)
def plan(offsets: tuple) -> tuple:
    """How B1 reads ``x``: segments ``(first, end, lo, span)`` that cover
    the diagonals ``[first, end)`` in offsets order.

    Greedily, consecutive offsets form a run while their span (largest
    minus smallest) stays within :data:`WINDOW_SPAN`.  A run of two or more
    diagonals is one windowed segment: ``lo`` is its smallest offset and
    ``span`` its span, and the kernel stages ``x`` over the block's rows
    plus that span in shared memory once for the whole run.  Runs of one
    diagonal read ``x`` directly (a window would be used once); adjacent
    ones merge into one segment with ``lo = 0, span = -1``.  At most
    ``(MAX_SEGMENTS - 1) // 2`` runs are windowed, the rest read directly,
    so no plan exceeds ``MAX_SEGMENTS``.  The plan does not change the
    arithmetic: every row sums its products in offsets order."""
    runs = []
    i, nd = 0, len(offsets)
    while i < nd:
        lo = hi = offsets[i]
        j = i + 1
        while j < nd and max(hi, offsets[j]) - min(lo, offsets[j]) \
                <= WINDOW_SPAN:
            lo, hi = min(lo, offsets[j]), max(hi, offsets[j])
            j += 1
        runs.append((i, j, lo, hi - lo))
        i = j
    segs, n_win = [], 0
    for first, end, lo, span in runs:
        if end - first >= 2 and n_win < (MAX_SEGMENTS - 1) // 2:
            segs.append((first, end, lo, span))
            n_win += 1
        elif segs and segs[-1][3] < 0:
            segs[-1] = (segs[-1][0], end, 0, -1)
        else:
            segs.append((first, end, 0, -1))
    return tuple(segs)


@functools.cache
def _plan_on(offsets: tuple, device: torch.device):
    """(the plan as an ``(n, 4)`` int32 tensor on ``device``, n, the number
    of windowed runs, the widest span or -1).  Made on first use (a copy
    to the device, which a CUDA graph capture cannot hold: the solve
    runs an eager step before it captures) and never evicted, since a
    captured graph keeps the tensor's address."""
    segs = plan(offsets)
    t = torch.tensor(segs or ((0, 0, 0, -1),), dtype=torch.int32,
                     device=device)
    return (t, len(segs), sum(s[3] >= 0 for s in segs),
            max((s[3] for s in segs), default=-1))


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def _bind(dll):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # B1: vals, offs, plan, n_segs, n_win, max_span, pad, x, b, w, y,
    # epilogue; B4: vals, offs, nd, pad, k, x, b, w, y, epilogue; the
    # window entry: vals, offs, plan, n_segs, n_win, max_span, m, S,
    # vstride, x, xs, lo, hi, y
    single = [p, p, p, i32, i32, i32, i64, p, p, p, p, i32]
    multi = [p, p, i32, i64, i32, p, p, p, p, i32]
    window = [p, p, p, i32, i32, i32, i64, i32, i64, p, i64, i64, i64, p]
    for prefix, common in (("dia", single), ("dia_multi", multi),
                           ("dia_window", window)):
        for suffix in ("_f32_f32", "_f64_f64"):
            fn = getattr(dll, prefix + suffix)
            fn.argtypes = common + [p]
            fn.restype = i32
        fn = getattr(dll, prefix + "_bf16_f32")
        fn.argtypes = common + [i32, p]
        fn.restype = i32


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
    if epilogue in ("update", "multi_update") and 0 not in a.offsets:
        raise ValueError("update epilogue requires the main diagonal")
    if epilogue in MULTI:
        if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] != pad:
            raise ValueError(f"X must be (k, {pad}) with k >= 1; got "
                             f"{tuple(x.shape)}")
    elif x.dim() != 1 or x.shape[0] != pad:
        raise ValueError(f"x must be ({pad},); got {tuple(x.shape)}")
    # b has x's shape (a batch B for B4); w is one vector for every column
    for name, t, shape in (("x", x, x.shape), ("b", b, x.shape),
                           ("w", w, (pad,))):
        if t is None:
            continue
        if t.shape != shape:
            raise ValueError(f"{name} must be {tuple(shape)}; got "
                             f"{tuple(t.shape)}")
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


def _check_window(a, xw, lo: int) -> tuple:
    """(S, m, hi) of a window launch; raises on what the entry does not
    take."""
    vals = a.vals
    if vals.dim() != 2 or vals.shape[0] != len(a.offsets):
        raise ValueError(f"Dia values must be (nd, S*m); got "
                         f"{tuple(vals.shape)} for {len(a.offsets)} offsets")
    if (vals.dtype, xw.dtype) not in _PAIRS:
        raise TypeError(f"unsupported (values, vector) dtypes "
                        f"({vals.dtype}, {xw.dtype})")
    if xw.dim() != 2 or xw.shape[0] < 1 or vals.shape[1] % xw.shape[0]:
        raise ValueError(f"windows must be (S, lo + m + hi) with S dividing "
                         f"the {vals.shape[1]} value columns; got "
                         f"{tuple(xw.shape)}")
    n_shards = xw.shape[0]
    m = vals.shape[1] // n_shards
    hi = xw.shape[1] - lo - m
    if lo < 0 or hi < 0:
        raise ValueError(f"window of {xw.shape[1]} entries cannot hold lo "
                         f"{lo} + m {m}")
    if xw.device != vals.device or a.offs.device != vals.device:
        raise ValueError("values, offsets and windows on different devices")
    return n_shards, m, hi


def spmv_window_plain(a, xw: torch.Tensor, lo: int) -> torch.Tensor:
    """The window entry's plain version: per shard, the sum in offsets
    order of :func:`_acc_plain`, over the shard's window (0 outside it)."""
    n_shards, m, hi = _check_window(a, xw, lo)
    offs = a.offsets
    nd = len(offs)
    # zeros where a diagonal reaches past the window
    zl = max(-(lo + min(offs)), 0) if offs else 0
    zh = max(max(offs) - hi, 0) if offs else 0
    xp = F.pad(xw, (zl, zh))
    bf16 = bf16_products(nd, a.vals.dtype, xw.dtype)
    if bf16:
        xp = xp.to(torch.bfloat16)
    v = a.vals.reshape(nd, n_shards, m)
    acc = torch.zeros((n_shards, m), dtype=xw.dtype, device=xw.device)
    for k, off in enumerate(offs):
        s0 = zl + lo + off
        xs = xp[:, s0: s0 + m]
        if bf16:
            acc = acc + v[k].to(xw.dtype) * xs.to(xw.dtype)
        else:
            acc = acc + v[k].to(xw.dtype) * xs
    return acc


def spmv_multi_plain(a, x: torch.Tensor) -> torch.Tensor:
    """Y = A X for a batch ``X`` of shape ``(k, pad)``: per column, the
    same arithmetic as :func:`spmv_plain`."""
    _check(a, x, epilogue="multi")
    return _acc_plain(a, x)


def resid_multi_plain(a, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, x, b, epilogue="multi_resid")
    return b - _acc_plain(a, x)


def gs_update_multi_plain(a, x: torch.Tensor, b: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    _check(a, x, b, w, epilogue="multi_update")
    return x + w * (b - _acc_plain(a, x))


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def _launch(a, x, b, w, epilogue: str) -> torch.Tensor:
    """Launch B1 (an epilogue of :data:`EPILOGUES`, x one vector) or B4 (of
    :data:`MULTI`, x a ``(k, pad)`` batch) on the current stream; count the
    launch."""
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
    if epilogue in MULTI:
        k = x.shape[0]
        args = [vals.data_ptr(), a.offs.data_ptr(), nd, pad, k]
        name = "dia_multi" + name[3:]
        key = (epilogue, vals.dtype, x.dtype, nd, pad, k)
        index = MULTI.index(epilogue)
    else:
        segs, n_segs, n_win, max_span = _plan_on(a.offsets, vals.device)
        args = [vals.data_ptr(), a.offs.data_ptr(), segs.data_ptr(), n_segs,
                n_win, max_span, pad]
        key = (epilogue, vals.dtype, x.dtype, nd, pad)
        index = EPILOGUES.index(epilogue)
    args += [x.data_ptr(), b.data_ptr() if b is not None else None,
             w.data_ptr() if w is not None else None, y.data_ptr(), index]
    if vals.dtype == torch.bfloat16:
        args.append(int(bf16_products(nd, vals.dtype, x.dtype)))
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"DIA kernel launch failed: CUDA error {err}")
    launches[epilogue] += 1
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return y


def _launch_window(a, xw, lo: int) -> torch.Tensor:
    """Launch B1's window entry on the current stream; count the launch."""
    n_shards, m, hi = _check_window(a, xw, lo)
    vals = a.vals
    nd = len(a.offsets)
    if nd > _MAX_DIAGS:
        raise ValueError(f"{nd} diagonals exceed the kernel's {_MAX_DIAGS}")
    if vals.stride(1) != 1 or xw.stride(1) != 1:
        raise ValueError("values and windows must be contiguous along rows")
    if not a.offs.is_contiguous() or a.offs.dtype != torch.int32 \
            or a.offs.numel() != nd:
        raise ValueError("offsets tensor must be contiguous int32 of "
                         "length nd")
    lib = _LIB.load()
    y = torch.empty((n_shards, m), dtype=xw.dtype, device=xw.device)
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    segs, n_segs, n_win, max_span = _plan_on(a.offsets, vals.device)
    name = "dia_window" + _PAIRS[(vals.dtype, xw.dtype)][3:]
    # x points at row 0 of shard 0's window, past its left halo
    args = [vals.data_ptr(), a.offs.data_ptr(), segs.data_ptr(), n_segs,
            n_win, max_span, m, n_shards, vals.stride(0),
            xw.data_ptr() + lo * xw.element_size(), xw.stride(0), lo, hi,
            y.data_ptr()]
    if vals.dtype == torch.bfloat16:
        args.append(int(bf16_products(nd, vals.dtype, xw.dtype)))
    err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"DIA window kernel launch failed: CUDA error "
                           f"{err}")
    key = (WINDOW, vals.dtype, xw.dtype, nd, m, n_shards)
    launches[WINDOW] += 1
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


def resid_multi(a, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """R = B - A X for batches ``X``, ``B`` of shape ``(k, pad)`` in one
    pass of B4."""
    if not _is_cuda(a, x):
        return resid_multi_plain(a, x, b)
    _check(a, x, b, epilogue="multi_resid")
    return _launch(a, x, b, None, "multi_resid")


def gs_update_multi(a, x: torch.Tensor, b: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """X + w * (B - A X) for batches ``X``, ``B`` of shape ``(k, pad)`` and
    one weight vector ``w`` of shape ``(pad,)`` in one pass of B4: the
    batched masked-GS group update.  Returns a new batch."""
    if not _is_cuda(a, x):
        return gs_update_multi_plain(a, x, b, w)
    _check(a, x, b, w, epilogue="multi_update")
    return _launch(a, x, b, w, "multi_update")


def spmv_window(a, xw: torch.Tensor, lo: int) -> torch.Tensor:
    """``Y[s, i] = sum_d vals[d, s*m + i] * xw[s, lo + i + off_d]`` for the
    ``S = xw.shape[0]`` shards of a ring, each window reading 0 outside
    itself: one launch of B1's window entry on CUDA tensors, the plain
    version on CPU tensors.  Returns ``(S, m)``."""
    if not _is_cuda(a, xw):
        return spmv_window_plain(a, xw, lo)
    return _launch_window(a, xw, lo)
