"""Flexible conjugate gradients (the FCG outer iteration).

Port of ``amg_tpu/solve/krylov.py:195-246``: the state and steps of
Notay's flexible CG, which the driver runs as a host loop with one AMG
cycle as the (variable) preconditioner.  Every function works on device
tensors and returns device scalars; nothing syncs with the host.  The
reference-style ``cg``/``gmres`` solvers of ``amg_tpu`` (the coarsest
Krylov solver, GMRES acceleration) are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.blas import dot, norm2


def _safe_div(num, den):
    """``num / den``, or 0 where ``den == 0`` (on the device)."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def fcg_init(amul, prec, b, x0):
    """Initial state for flexible CG: ``(x, r, z, p, rho)``."""
    r0 = b - amul(x0)
    z0 = prec(r0)
    rho0 = dot(z0, r0)
    return (x0, r0, z0, z0, rho0)


def fcg_step(amul, prec, state):
    """One flexible-CG iteration.

    Flexible CG tolerates a variable preconditioner (one low-precision AMG
    cycle) by computing beta with the Polak-Ribiere form ``<z_new, r_new -
    r_old> / <z_old, r_old>`` instead of the Fletcher-Reeves ratio.
    Returns ``(state, absres)``.
    """
    x, r, z, p, rho = state
    q = amul(p)
    alpha = _safe_div(dot(p, r), dot(p, q))
    x = x + alpha * p
    r_new = r - alpha * q
    z_new = prec(r_new)
    rho_new = dot(z_new, r_new)
    # <z_new, r_new - r_old>
    rho_pr = rho_new - dot(z_new, r)
    beta = _safe_div(rho_pr, rho)
    p = z_new + beta * p
    return (x, r_new, z_new, p, rho_new), norm2(r_new)


def fcg_refresh(amul, prec, b, state):
    """Residual replacement: recompute ``r = b - A x`` from scratch.

    The recurrence's residual drifts from the true one by accumulated
    rounding (~eps * kappa); periodic replacement, and one before
    convergence is accepted, bounds the gap (the reference CG's
    false-convergence Check III, amg/Solve/SSS_cycle.cu:311-355).  Keeps
    the search direction.
    """
    x, r, z, p, rho = state
    r = b - amul(x)
    z = prec(r)
    rho = dot(z, r)
    return (x, r, z, p, rho), norm2(r)
