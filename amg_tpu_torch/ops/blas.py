"""BLAS-1 device operations.

Replaces the reference's scalar-loop array ops (``SSS_blas_array_*``,
amg/SSS_utils.c:151-260) with torch reductions and elementwise ops.
``psum`` is the counterpart of ``amg_tpu.ops.blas``'s ``axis_name``: for a
row-sharded vector ``(S, m)`` (S local shards of m rows, the layout of
``amg_tpu_torch.parallel``) it takes the per-shard partial sums ``(S,)``
and returns their sum over every shard of the mesh (``Mesh.psum``).
"""

from __future__ import annotations

import torch


def dot(x, y, psum=None):
    """<x, y> (reference SSS_blas_array_dot, amg/SSS_utils.c:206).  For a
    batch ``(k, n)`` one value per column, shaped ``(k, 1)`` so that it
    scales the batch's rows as a scalar scales a vector.  With ``psum``,
    ``x`` and ``y`` are row-sharded ``(S, m)`` and the result is the one
    global dot."""
    if psum is not None:
        return psum(torch.sum(x * y, dim=-1))
    if x.dim() == 2:
        return torch.sum(x * y, dim=-1, keepdim=True)
    return torch.dot(x, y)


def norm2(x, psum=None):
    """||x||_2 (reference SSS_blas_array_norm2, amg/SSS_utils.c:151); per
    column, ``(k, 1)``, for a batch ``(k, n)``; global for a row-sharded
    ``x`` with ``psum``."""
    return torch.sqrt(dot(x, x, psum))


def norminf(x):
    """||x||_inf (reference SSS_blas_array_norminf, amg/SSS_utils.c:225);
    per column, ``(k, 1)``, for a batch ``(k, n)``."""
    if x.dim() == 2:
        return torch.amax(torch.abs(x), dim=-1, keepdim=True)
    if x.numel() == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.max(torch.abs(x))


def axpy(alpha, x, y):
    """y + alpha*x (reference SSS_blas_array_axpy, amg/SSS_utils.c:217)."""
    return y + alpha * x


def axpby(alpha, x, beta, y):
    """alpha*x + beta*y (reference SSS_blas_array_axpby,
    amg/SSS_utils.c:248)."""
    return alpha * x + beta * y
