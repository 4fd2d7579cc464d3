"""Smoothers.

The reference dispatches nine smoother types but only sequential
Gauss-Seidel is live (amg/Solve/SSS_smooth.c:138-220; the comment at
amg/Solve/SSS_cycle.cu:882 concedes "smoothing could't use cuda").

Here every smoother is a function over the device
:class:`~amg_tpu_torch.hierarchy.Level`, the same branches as
``amg_tpu.solve.smoothers``:

* **Multicolor Gauss-Seidel** (default, matches ``SSS_SM_GS``): exact GS in
  the colored ordering — per color group, a row-block update.
  C/F ordering (``cf_order=1``) replicates the reference's F-then-C
  pre-smooth and C-then-F post-smooth (amg/Solve/SSS_smooth.c:4-87).
  On a Dia level with group weights the group update is one fused pass of
  the DIA kernel (``dia_kernel.gs_update``, ``gs_update_multi`` for a
  batch); on a WEll level whose layout
  groups rows by GS class it is one launch of the WEll kernel's class
  update (``well_kernel.gs_update_``) over that class's rows only.
* SGS, SOR, SSOR, GSOR, SGSOR: symmetric / relaxed variants on the same
  machinery (reference enum amg/SSS_main.h:133-145).
* Jacobi / weighted Jacobi / L1-Jacobi: one SpMV + axpy.
* Chebyshev polynomial smoothing (``SSS_SM_POLY`` analog) using Jacobi
  preconditioning and a spectral-radius estimate computed at setup.

Every branch takes one vector ``(pad,)`` or a batch ``(k, pad)`` (the
batched solve), rows on the last axis.  No function modifies its input
vectors: the solve loop in ``solve/driver.py`` keeps earlier iterates
while later cycles run.
"""

from __future__ import annotations

import torch

from ..params import SmootherType
from ..sparse import Dia, Dense, BandedBlocks, WEll
from ..ops import dense_kernel, dia_kernel, well_kernel
from ..ops.spmv import spmv
from ..ops.blas import dot


def _well_classes(level, x) -> bool:
    """True when the level's GS class updates go to the WEll kernel's
    class-update entry: one vector on a WEll level whose layout groups
    its rows by class."""
    return (x.dim() == 1 and isinstance(level.a, WEll)
            and level.a.rows.classes)


def _masked_group_update(level, x, b, g: int, relax=None,
                         inplace: bool = False):
    """Gauss-Seidel update of group ``g`` on a Dia, Dense, BandedBlocks or
    WEll level.

    Gather-free: one full SpMV, then a masked update of the group's rows.
    ``t_i = (b_i - (Ax)_i + a_ii x_i) / a_ii`` is the exact GS update
    because rows within a group are mutually independent.

    With a precomputed group-weight stack (``level.gs_w``) on a Dia level,
    the whole update runs as ONE fused DIA kernel pass ``x + w_g * (b - A x)``
    (the select, diagonal add-back and division fold into the epilogue);
    a batch takes the same epilogue of the multi-rhs kernel
    (``dia_kernel.gs_update_multi``, one launch for every column).

    On a WEll level with class-grouped rows one vector takes the WEll
    kernel's class update instead: the same formula over group ``g``'s
    rows only, one launch, no full product.  It writes ``x`` in place when
    ``inplace`` (the sweep's private copy), else a copy.
    """
    if _well_classes(level, x):
        return well_kernel.gs_update_(
            level.a, x if inplace else x.clone(), b, g, level.diag,
            level.inv_diag, relax=relax)
    if (relax is None and level.gs_w is not None
            and isinstance(level.a, Dia)
            and 0 in level.a.offsets
            and b.shape[-1] == level.a.padded_rows):
        if x.dim() == 2:
            return dia_kernel.gs_update_multi(level.a, x, b, level.gs_w[g])
        return dia_kernel.gs_update(level.a, x, b, level.gs_w[g])

    ax = spmv(level.a, x)
    t = (b - ax + level.diag * x) * level.inv_diag
    if relax is not None:
        t = (1.0 - relax) * x + relax * t
    upd = (level.gid == g) & (level.inv_diag != 0)
    return torch.where(upd, t, x)


def _group_update_(level, x, b, idx, relax=None):
    """Gauss-Seidel update of one independent group of rows, IN PLACE on
    ``x`` (the caller's private copy).

    x[i] <- (b[i] - sum_{j != i} a_ij x_j) / a_ii  for i in idx.
    ``idx`` holds real rows only: the out-of-range padding ``amg_tpu``
    relies on (JAX clamps the gather and drops the scatter) was stripped
    at pack time.
    """
    a = level.a
    sub_cols = a.cols[idx]            # (g, w)
    sub_vals = a.vals[idx]            # (g, w)
    sub_diag_mask = level.diag_mask[idx]
    gathered = x[..., sub_cols]
    off = torch.where(sub_diag_mask, torch.zeros((), dtype=a.vals.dtype,
                                                 device=x.device), sub_vals)
    t = b[..., idx] - torch.sum(off * gathered, dim=-1)
    invd = level.inv_diag[idx]
    old = x[..., idx]
    new = t * invd
    if relax is not None:
        new = (1.0 - relax) * old + relax * new
    # small-diagonal guard: keep old value (reference gs_cf,
    # amg/Solve/SSS_smooth.c:30)
    x[..., idx] = torch.where(invd != 0, new, old)


def _range_update_(level, x, b, start: int, size: int, relax=None):
    """Gauss-Seidel update of one color-contiguous row range, IN PLACE on
    ``x`` (the caller's private copy).

    Used when the level was permuted by ``reorder_for_gs``: rows
    ``[start, start+size)`` form one independent class, so the update is
    exact GS with no index gather and no scatter.
    """
    a = level.a
    end = start + size
    gathered = x[..., a.cols[start:end]]
    off = torch.where(level.diag_mask[start:end],
                      torch.zeros((), dtype=a.vals.dtype, device=x.device),
                      a.vals[start:end])
    t = b[..., start:end] - torch.sum(off * gathered, dim=-1)
    invd = level.inv_diag[start:end]
    old = x[..., start:end]
    new = t * invd
    if relax is not None:
        new = (1.0 - relax) * old + relax * new
    x[..., start:end] = torch.where(invd != 0, new, old)


def _range_update_dense_(level, x, b, start: int, size: int, relax=None):
    """Range GS update on a Dense level: one row-block matvec, IN PLACE.

    Within a color class A has no intra-class couplings, so the full-row
    product plus add-back of the diagonal term is the exact GS update.
    bf16 values times one f32 vector take D1 on the row range
    (``dense_kernel.spmv``); otherwise the rows are widened to x's dtype.
    """
    a = level.a
    end = start + size
    if dense_kernel.takes(a, x):
        ax = dense_kernel.spmv(a, x, start, size)
    else:
        sub = a.vals[start:end]
        if sub.dtype != x.dtype:
            sub = sub.to(x.dtype)
        if x.dim() == 2:
            ax = x[..., : a.padded_cols] @ sub.T
        else:
            ax = sub @ x[: a.padded_cols]
    ds = level.diag[start:end]
    invd = level.inv_diag[start:end]
    old = x[..., start:end]
    new = (b[..., start:end] - ax + ds * old) * invd
    if relax is not None:
        new = (1.0 - relax) * old + relax * new
    x[..., start:end] = torch.where(invd != 0, new, old)


def gs_sweep(level, x, b, order, relax=None):
    """One GS sweep over groups in the given order."""
    if level.ranges is not None:
        upd = (_range_update_dense_ if isinstance(level.a, Dense)
               else _range_update_)
        x = x.clone()   # one private copy per sweep, updated in place
        for g in order:
            start, size = level.ranges[g]
            upd(level, x, b, start, size, relax=relax)
    elif isinstance(level.a, (Dia, Dense, BandedBlocks, WEll)):
        inplace = _well_classes(level, x)
        if inplace:
            x = x.clone()   # one private copy per sweep, updated in place
        for g in order:
            x = _masked_group_update(level, x, b, g, relax=relax,
                                     inplace=inplace)
    else:
        x = x.clone()
        for g in order:
            _group_update_(level, x, b, level.groups[g], relax=relax)
    return x


def _order(level, forward: bool, cf_order: int, pre: bool):
    """Group ordering.

    cf_order=1: pre-smooth visits F groups then C groups, post-smooth C
    then F (reference amg/Solve/SSS_smooth.c:171,256).  cf_order=0: color
    order, reversed for the backward sweep.
    """
    ng = len(level.group_cf)
    ids = list(range(ng))
    if cf_order == 1:
        f = [g for g in ids if level.group_cf[g] == 0]
        c = [g for g in ids if level.group_cf[g] == 1]
        return tuple(f + c) if pre else tuple(c + f)
    return tuple(ids) if forward else tuple(reversed(ids))


def _jacobi(level, x, b, weight):
    r = b - spmv(level.a, x)
    return x + weight * level.inv_diag * r


def _l1_jacobi(level, x, b):
    r = b - spmv(level.a, x)
    return x + level.l1_inv * r


def _chebyshev(level, x, b, degree):
    """Chebyshev smoothing on the Jacobi-preconditioned operator, targeting
    the upper part [rho/4, rho] of the spectrum (standard AMG practice)."""
    rho = level.rho_dinv_a  # spectral radius estimate of D^{-1} A
    theta = 0.5 * (rho + rho / 4.0)
    delta = 0.5 * (rho - rho / 4.0)
    sigma = theta / delta
    rho_old = 1.0 / sigma

    r = level.inv_diag * (b - spmv(level.a, x))
    d = r / theta
    x = x + d
    for _ in range(max(degree - 1, 0)):
        rho_new = 1.0 / (2.0 * sigma - rho_old)
        r = level.inv_diag * (b - spmv(level.a, x))
        d = rho_new * rho_old * d + 2.0 * rho_new / delta * r
        x = x + d
        rho_old = rho_new
    return x


def _cg_smooth(level, x, b, nsweeps, psum=None, spmv_fn=None):
    """Krylov smoothing: ``nsweeps`` steps of Jacobi-preconditioned CG on
    A x = b from the incoming iterate (``SSS_SM_CG``, reference enum
    amg/SSS_main.h:133-145 — declared there, dead in its dispatch).

    Fixed iteration count, no convergence test.  CG smoothing is a
    *nonlinear* operation, so an outer Krylov wrap (if any) should be
    flexible (FCG / FGMRES).  The sharded cycle passes its ring product as
    ``spmv_fn`` and the mesh's ``psum`` for the dots (``amg_tpu``'s
    ``spmv_fn`` and ``axis_name``).
    """
    eps = 1e-30
    amul = spmv_fn if spmv_fn is not None else (lambda v: spmv(level.a, v))
    r = b - amul(x)
    z = level.inv_diag * r
    p = z
    rz = dot(r, z, psum)
    for _ in range(nsweeps):
        ap = amul(p)
        alpha = rz / (dot(p, ap, psum) + eps)
        x = x + alpha * p
        r = r - alpha * ap
        z = level.inv_diag * r
        rz_new = dot(r, z, psum)
        p = z + (rz_new / (rz + eps)) * p
        rz = rz_new
    return x


def smooth(level, x, b, pars, nsweeps: int, pre: bool):
    """Apply ``nsweeps`` of the configured smoother.

    Dispatch mirrors ``SSS_amg_smoother_pre/post``
    (amg/Solve/SSS_smooth.c:138-304); every branch implemented (the
    reference errors out on all but GS).
    """
    sm = pars.smoother
    relax = pars.relax

    if sm in (SmootherType.POLY, SmootherType.CHEBYSHEV):
        # a degree-d Chebyshev application IS the smoother; iterating it
        # nsweeps times would restart the recurrence — apply once per
        # pre/post call
        return _chebyshev(level, x, b, pars.poly_deg)

    if sm == SmootherType.CG:
        return _cg_smooth(level, x, b, nsweeps)

    for _ in range(nsweeps):
        if sm == SmootherType.GS:
            x = gs_sweep(level, x, b, _order(level, pre, pars.cf_order, pre))
        elif sm == SmootherType.SGS:
            x = gs_sweep(level, x, b, _order(level, True, 0, True))
            x = gs_sweep(level, x, b, _order(level, False, 0, False))
        elif sm == SmootherType.JACOBI:
            x = _jacobi(level, x, b, 1.0)
        elif sm == SmootherType.WJACOBI:
            x = _jacobi(level, x, b, relax)
        elif sm == SmootherType.L1DIAG:
            x = _l1_jacobi(level, x, b)
        elif sm == SmootherType.SOR:
            x = gs_sweep(level, x, b, _order(level, pre, pars.cf_order, pre),
                         relax=relax)
        elif sm == SmootherType.SSOR:
            x = gs_sweep(level, x, b, _order(level, True, 0, True), relax=relax)
            x = gs_sweep(level, x, b, _order(level, False, 0, False), relax=relax)
        elif sm == SmootherType.GSOR:
            x = gs_sweep(level, x, b, _order(level, pre, pars.cf_order, pre))
            x = gs_sweep(level, x, b, _order(level, pre, pars.cf_order, pre),
                         relax=relax)
        elif sm == SmootherType.SGSOR:
            x = gs_sweep(level, x, b, _order(level, True, 0, True))
            x = gs_sweep(level, x, b, _order(level, False, 0, False))
            x = gs_sweep(level, x, b, _order(level, True, 0, True), relax=relax)
            x = gs_sweep(level, x, b, _order(level, False, 0, False), relax=relax)
        else:
            raise ValueError(f"unsupported smoother {sm}")
    return x
