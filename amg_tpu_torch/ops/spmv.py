"""Sparse matrix-vector products on device.

The hot kernel of the whole framework: the reference's CSR SpMV is a
scalar row loop on CPU (``SSS_blas_mv_mxy``, amg/SSS_utils.c:182-201) and a
thread-per-row CUDA kernel (``spmv_kernel``, amg/Solve/SSS_cuda.cu:77-96).

Here each device format has its product: :class:`Dia` goes through the
hand-written DIA kernel (``ops/dia_kernel.py``) and :class:`WEll` through
the hand-written WEll kernels (``ops/well_kernel.py``) for every dtype
they support; a :class:`Dense` operator stored in bf16 times one f32
vector goes through the hand-written Dense kernel (``ops/dense_kernel.py``,
D1); :class:`Ell` (gather + row sum), every other :class:`Dense` product
(one matmul) and :class:`BandedBlocks` (one batched block matmul) are
plain torch and cuBLAS, as they are XLA in ``amg_tpu``.

Every product takes one vector ``(pad,)`` or a batch ``(k, pad)`` of k
right-hand sides, rows on the last axis (the batched solve): a batch on a
:class:`Dia` goes to the multi-rhs DIA kernel (B4, which also fuses the
residual), on a :class:`WEll`
through one WEll kernel launch per column, as ``amg_tpu`` runs it under
``vmap``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sparse import Ell, Dia, Dense, BandedBlocks, WEll
from . import dense_kernel, dia_kernel, well_kernel


def spmv_ell(a: Ell, x: torch.Tensor) -> torch.Tensor:
    """Gather-based ELL SpMV (general fallback)."""
    return torch.sum(a.vals * x[..., a.cols], dim=-1)


def spmv_dia(a: Dia, x: torch.Tensor) -> torch.Tensor:
    """Diagonal-offset SpMV through the DIA kernel wrapper (B1 for a
    vector, B4 for a batch)."""
    if x.dim() == 2:
        return dia_kernel.spmv_multi(a, x)
    return dia_kernel.spmv(a, x)


def spmv_dense(a: Dense, x: torch.Tensor) -> torch.Tensor:
    """Dense matvec (small deep levels; no gathers).  bf16 values times
    one f32 vector go to D1 (``dense_kernel.spmv``), which reads each value
    as stored, as XLA's fused convert + dot does.  Otherwise values stored
    in a narrower dtype are widened to the vector's dtype first, as JAX's
    type promotion does implicitly."""
    if dense_kernel.takes(a, x):
        return dense_kernel.spmv(a, x)
    v = a.vals if a.vals.dtype == x.dtype else a.vals.to(x.dtype)
    if x.dim() == 2:
        return x[..., : a.padded_cols] @ v.T
    return v @ x[: a.padded_cols]


def spmv_well(a: WEll, x: torch.Tensor) -> torch.Tensor:
    """Windowed-gather ELL SpMV, on the operator's row-slice layout: the
    f64 product of the two f32 value planes (kernel B3) when ``a.vals_lo``
    is set and x is f64, otherwise kernel B2.  A batch runs one launch per
    column."""
    if x.dim() == 2:
        return torch.stack([spmv_well(a, xc) for xc in x])
    if a.vals_lo is not None and x.dtype == torch.float64:
        return well_kernel.spmv_df64(a, x)
    return well_kernel.spmv(a, x)


def spmv_banded(a: BandedBlocks, x: torch.Tensor) -> torch.Tensor:
    """Block-banded SpMV (``amg_tpu.ops.spmv.spmv_banded``): block row
    ``i`` of y is ``sum_d vals[i, d] @ x_block(i + d - nb)``, x zero
    outside ``[0, pad)``.

    The numerics of ``amg_tpu``: x is rounded to the values' dtype, the
    products are accumulated, and y returned, in x's dtype.  ``vals`` is
    read as ``(nbr * w, 128, 128)`` matrices without a copy; x's shifted
    blocks are laid out as ``(nbr * w, 128, k)`` (``w`` times the size of
    x) for one batched matmul, whose ``w`` partial products per block row
    are then summed.  On the card bf16 values against f32 vectors take
    cuBLAS's bf16 product with f32 output (``out_dtype``), so the values
    are never widened; on the CPU, where that call does not exist, both
    operands are widened to x's dtype first, which is exact for bf16."""
    pad = a.vals.shape[0] * 128
    halo = a.nb * 128
    y = banded_window_product(a, F.pad(x[..., :pad].reshape(-1, pad),
                                       (halo, halo)), x.dtype)
    return y if x.dim() == 2 else y[0]


def banded_window_product(a: BandedBlocks, xp: torch.Tensor,
                          dtype) -> torch.Tensor:
    """The product of :func:`spmv_banded` on x given as ``(k, nb*128 +
    pad + nb*128)`` windows, x's rows with ``nb`` blocks on either side
    (zeros, or a ring's halos): ``(k, pad)`` results in ``dtype``."""
    nbr, w = a.vals.shape[:2]
    pad = nbr * 128
    xp = xp.to(a.vals.dtype)
    k = xp.shape[0]
    # window d of block row i is block i + d of the zero-padded x
    xw = (xp.reshape(k, nbr + w - 1, 128).unfold(1, w, 1)  # (k, nbr, 128, w)
          .permute(1, 3, 2, 0).reshape(nbr * w, 128, k))
    v = a.vals.reshape(nbr * w, 128, 128)
    if v.dtype == dtype:
        part = torch.bmm(v, xw)
    elif v.is_cuda and v.dtype == torch.bfloat16 and dtype == torch.float32:
        part = torch.bmm(v, xw, out_dtype=torch.float32)
    else:
        part = torch.bmm(v.to(dtype), xw.to(dtype))
    return part.reshape(nbr, w, 128, k).sum(1).reshape(pad, k).T.contiguous()


def spmv(a, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x. Returns a vector of length ``a.padded_rows`` (padding rows
    produce zeros because their values are zero).  Dispatches on format."""
    if isinstance(a, Dia):
        return spmv_dia(a, x)
    if isinstance(a, Dense):
        return spmv_dense(a, x)
    if isinstance(a, BandedBlocks):
        return spmv_banded(a, x)
    if isinstance(a, WEll):
        return spmv_well(a, x)
    if isinstance(a, Ell):
        return spmv_ell(a, x)
    raise NotImplementedError(f"no SpMV for {type(a).__name__}")


def spmv_n(a, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x truncated to the logical row count."""
    return spmv(a, x)[..., : a.n_rows]


def residual(a, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = b - A @ x (reference ``SSS_blas_mv_amxpy`` with alpha=-1 as used
    by the outer loop, amg/Solve/SSS_SOLVE.c:59-60)."""
    return b - spmv(a, x)[..., : b.shape[-1]]


def residual_fused(a, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """r = b - A @ x, with the subtraction fused into the DIA kernel for a
    Dia operator: one pass of B1's ``resid`` epilogue for one vector, of
    B4's for a ``(k, pad)`` batch, instead of a product and a separate
    elementwise pass."""
    if isinstance(a, Dia) and b.shape[-1] == a.padded_rows:
        if x.dim() == 2:
            return dia_kernel.resid_multi(a, x, b)
        return dia_kernel.resid(a, x, b)
    return b - spmv(a, x)[..., : b.shape[-1]]
