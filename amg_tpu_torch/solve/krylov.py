"""Krylov solvers on device tensors.

Port of ``amg_tpu/solve/krylov.py``: the reference's coarsest-level
solvers with the textbook-correct numerics (the reference's CG beta uses
an uninitialized GPU buffer, amg/Solve/SSS_cycle.cu:373-374 — SURVEY.md
"bugs to NOT replicate"), and the flexible CG of the outer iteration:

* :func:`cg` — conjugate gradients with the reference's safety nets
  (best-solution tracking, Checks I-III, amg/Solve/SSS_cycle.cu:238-419)
  as masked device state;
* :func:`gmres` — restarted GMRES(m) with modified Gram-Schmidt, Givens
  rotations and right preconditioning (amg/Solve/SSS_cycle.cu:440-817);
* :func:`fcg` and its steps :func:`fcg_init`, :func:`fcg_step`,
  :func:`fcg_refresh` — Notay's flexible CG, which the driver runs with
  one AMG cycle as the preconditioner.

``amg_tpu`` runs ``cg`` and ``gmres`` under ``lax.while_loop``.  Here the
loops run on the host over device tensors, and the host reads the device
only between blocks of iterations:

* ``cg`` runs ``BLOCK`` iterations per host read.  Every update is masked
  by a ``running`` flag on the device, so a finished solve's state freezes
  exactly where ``amg_tpu``'s loop stops, and the true residual ``b - A x``
  is computed every iteration and selected with ``torch.where`` (the
  ``lax.cond`` of ``amg_tpu``).  One vector ``(pad,)`` or a batch ``(k,
  pad)``: a batch runs every column to its own stop, as ``vmap`` of
  ``amg_tpu``'s loop does.
* ``gmres`` runs the Arnoldi steps (products, Gram-Schmidt, norms) on the
  device, ``check_every`` steps per host read, and the Givens rotations,
  the stopping test and the back-substitution on the host in the vectors'
  dtype, in ``amg_tpu``'s order.  The rotations do not feed the Arnoldi
  steps, so the host sees a block's columns at once; steps after the stop
  are dropped, as ``amg_tpu`` masks them.

``counts`` adds up, over every call, the host reads (``syncs``), the
solves and iterations of ``cg`` and ``gmres``, and the ``cg`` solves that
did not converge.  ``cg`` and the FCG steps take ``psum`` for row-sharded
``(S, m)`` vectors (``amg_tpu``'s ``axis_name``, and what GSPMD makes of
``amg_tpu``'s ``cg`` on a row-sharded operator); ``gmres`` runs on one
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import SMALLFLOAT, MAX_STAG, MAX_RESTART, ErrorCode, StopType
from ..sparse import Ell, Dia, Dense, BandedBlocks
from ..ops.spmv import spmv
from ..ops.blas import dot, norm2, norminf

_SMALLFLOAT2 = 1e-40  # breakdown tolerance (reference SMALLFLOAT2)

# status values for the CG state machine
_RUNNING = 0
_CONVERGED = 1
_BREAKDOWN = 2

# CG iterations (and coarsest-solve GMRES steps) between host reads: a
# divisor of the coarsest GMRES's restart length 30, so that a full restart
# takes 3 reads and a coarsest solve (CG, then GMRES) reads the device at
# most (its iterations) / BLOCK + 2 times, whatever its restarts
BLOCK = 10

# host reads and work of cg/gmres, over every call (set to 0 by callers)
counts = {"syncs": 0, "cg_solves": 0, "cg_iters": 0, "cg_failed": 0,
          "gmres_solves": 0, "gmres_iters": 0}


def _as_op(a):
    if isinstance(a, (Ell, Dia, Dense, BandedBlocks)):
        return lambda v: spmv(a, v)
    return a


def _identity(v):
    return v


def _safe_div(num, den):
    """``num / den``, or 0 where ``den == 0`` (on the device)."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _cg_run(a, b, x0, tol, maxit, M=None, stop_type=None, psum=None):
    """The CG state machine of :func:`cg`.  Returns ``(x, status, it)`` as
    device tensors shaped like one column's scalars (``()`` for a vector
    or a row-sharded one, ``(k, 1)`` for a batch), and host copies of
    ``status`` and ``it`` from the last host read."""
    amul = _as_op(a)
    prec = M if M is not None else _identity
    st = StopType.REL_RES if stop_type is None else stop_type
    maxdiff = tol * 1e-4            # stagnation tolerance (reference :27)
    sol_inf_tol = SMALLFLOAT        # Check-I tolerance (reference :28)

    r0 = b - amul(x0)
    z0 = prec(r0)
    absres0 = norm2(r0, psum)
    normr0 = torch.clamp(absres0, min=SMALLFLOAT)
    rho0 = dot(z0, r0, psum)

    def _absres(r, z):
        if st == StopType.REL_PRECRES:
            return torch.sqrt(torch.abs(dot(z, r, psum)))
        return norm2(r, psum)

    def _relres(x, absres):
        if st == StopType.MOD_REL_RES:
            return absres / torch.clamp(norm2(x, psum), min=SMALLFLOAT)
        return absres / normr0

    def _near_zero(x):
        # Check I's ||x||_inf <= tol; row-sharded: no entry above tol on
        # any shard (a psum of counts)
        if psum is None:
            return norminf(x) <= sol_inf_tol
        return psum(torch.sum(torch.abs(x) > sol_inf_tol, dim=-1)
                    .to(x.dtype)) == 0

    def body(c):
        (x, r, z, p, rho, it, best_x, best_res, stag, more_step,
         status) = c
        running = (status == _RUNNING) & (it < maxit)
        t = amul(p)
        denom = dot(p, t, psum)
        breakdown = torch.abs(denom) <= _SMALLFLOAT2
        alpha = torch.where(breakdown, 0.0,
                            rho / torch.where(breakdown, 1.0, denom))
        x_n = x + alpha * p
        r_n = r - alpha * t
        z_n = prec(r_n)
        absres = _absres(r_n, z_n)
        relres = _relres(x_n, absres)

        # best-solution tracking (reference :238-242)
        better = absres < best_res - maxdiff
        best_x_n = torch.where(better, x_n, best_x)
        best_res_n = torch.where(better, absres, best_res)

        # Check I: solution close to zero (reference :245-249)
        sol_stag = _near_zero(x_n)

        # Check II trigger: stagnation (reference :252-256)
        normu = torch.clamp(norm2(x_n, psum), min=SMALLFLOAT)
        reldiff = torch.abs(alpha) * norm2(p, psum) / normu
        stag_trig = (stag <= MAX_STAG) & (reldiff < maxdiff)

        # Check III trigger: the recurrence says converged (reference
        # :311).  Both checks re-verify against the true residual b - A x,
        # computed every iteration and selected where a check fired
        conv_trig = relres < tol
        need_true = (stag_trig | conv_trig) & ~breakdown & ~sol_stag
        r_true = torch.where(need_true, b - amul(x_n), r_n)
        z_true = prec(r_true)
        abs_true = _absres(r_true, z_true)
        rel_true = _relres(x_n, abs_true)

        verified = need_true & (rel_true < tol)
        stag_fail = stag_trig & ~verified & (stag >= MAX_STAG)
        stag_restart = stag_trig & ~verified & (stag < MAX_STAG)
        false_conv = conv_trig & ~stag_trig & ~verified
        tol_fail = false_conv & (more_step >= MAX_RESTART)
        restart = (stag_restart | (false_conv & ~tol_fail)) & ~breakdown

        # adopt the recomputed residual where it was computed (reference
        # overwrites r in place at :258-260, :313-315)
        r_n = torch.where(need_true, r_true, r_n)
        z_n = torch.where(need_true, z_true, z_n)

        # priority: breakdown > converged > Check I > Check II fail >
        # Check III fail > keep running
        status_n = torch.where(
            breakdown, _BREAKDOWN, torch.where(
                verified, _CONVERGED, torch.where(
                    sol_stag, int(ErrorCode.ERROR_SOLVER_SOLSTAG),
                    torch.where(
                        stag_fail, int(ErrorCode.ERROR_SOLVER_STAG),
                        torch.where(tol_fail,
                                    int(ErrorCode.ERROR_SOLVER_TOLSMALL),
                                    _RUNNING))))).to(torch.int32)

        rho_n = dot(z_n, r_n, psum)
        beta = torch.where(rho != 0, rho_n / torch.where(rho != 0, rho, 1.0),
                           0.0)
        p_n = (~restart).to(p.dtype) * p * beta + z_n
        stag_n = stag + stag_restart.to(torch.int32)
        more_n = more_step + (false_conv & ~tol_fail).to(torch.int32)
        new = (x_n, r_n, z_n, p_n, rho_n, it + 1, best_x_n, best_res_n,
               stag_n, more_n, status_n)
        # a finished solve keeps its state: the loop of amg_tpu has stopped
        return tuple(torch.where(running, n_, o_) for n_, o_ in zip(new, c))

    one = torch.ones_like(absres0, dtype=torch.int32)
    state = (x0, r0, z0, z0, rho0, 0 * one, x0, absres0, one, one, 0 * one)
    status_h = np.zeros(one.shape, np.int32)
    it_h = np.zeros(one.shape, np.int32)
    while maxit > 0:
        for _ in range(BLOCK):
            state = body(state)
        host = torch.stack([state[10], state[5]]).cpu().numpy()
        counts["syncs"] += 1
        status_h, it_h = host[0], host[1]
        if not np.any((status_h == _RUNNING) & (it_h < maxit)):
            break
    (x, r, z, p, rho, it, best_x, best_res, stag, more_step,
     status) = state
    # restore the best solution when the final iterate is worse (reference
    # best-solution net, amg/Solve/SSS_cycle.cu:381-419)
    absres = _absres(r, z)
    x = torch.where(absres <= best_res + maxdiff, x, best_x)
    counts["cg_solves"] += status_h.size
    counts["cg_iters"] += int(it_h.sum())
    counts["cg_failed"] += int((status_h != _CONVERGED).sum())
    return x, status, it, status_h, it_h


def cg(a, b, x0, tol=1e-7, maxit=250, M=None, stop_type=None,
       return_info=False, psum=None):
    """Conjugate gradients with the reference's full safety-net state
    machine (``amg_tpu.solve.krylov.cg``).

    ``a`` is an Ell, Dia, Dense or BandedBlocks operator or a matvec
    callable; ``M`` an optional preconditioner callable (z = M(r)).  ``b``
    is one vector ``(pad,)`` or a batch ``(k, pad)``, each column solved
    to its own stop.  ``stop_type`` replicates the reference's three
    criteria (amg/Solve/SSS_cycle.cu:101-130):

    * ``REL_RES`` (default): ``||r|| / max(eps, ||r0||) < tol``
    * ``REL_PRECRES``: ``sqrt(r.z) / sqrt(r0.z0) < tol`` (B-norm)
    * ``MOD_REL_RES``: ``||r|| / max(eps, ||x||) < tol``

    Safety nets (reference amg/Solve/SSS_cycle.cu:238-355):

    * best-solution tracking and final restore (:238-242, :381-419);
    * Check I — near-zero solution => ``ERROR_SOLVER_SOLSTAG`` (:245-249);
    * Check II — stagnation (``|alpha| ||p|| / ||x|| < tol*1e-4``):
      recompute the *true* residual ``b - A x``; accept if converged, else
      restart with ``p = 0`` up to ``MAX_STAG`` times, then
      ``ERROR_SOLVER_STAG`` (:252-308);
    * Check III — false convergence: when the recurrence residual passes
      ``tol``, verify against the recomputed true residual before
      accepting; on failure restart up to ``MAX_RESTART`` times, then
      ``ERROR_SOLVER_TOLSMALL`` (:311-355).

    With ``psum`` (:meth:`~amg_tpu_torch.parallel.dist.Mesh.psum`), ``b``
    and ``x0`` are one row-sharded vector's ``(S, m)`` block and ``a`` its
    row-sharded product (a callable): every dot and norm is the global
    one.

    The host reads the state once per ``BLOCK`` iterations.  Returns
    ``(x, converged)``, or ``(x, converged, info)`` with ``return_info``
    where ``info = (status_code, iters)`` and ``status_code`` is 1 on
    convergence, ``ErrorCode.ERROR_SOLVER_*`` on a safety-net exit, 2 on
    breakdown and 0 when ``maxit`` was exhausted; device tensors, ``()``
    for one vector and ``(k,)`` for a batch.
    """
    x, status, it, _, _ = _cg_run(a, b, x0, tol, maxit, M, stop_type, psum)
    if b.dim() == 2 and psum is None:
        status, it = status.reshape(-1), it.reshape(-1)
    converged = status == _CONVERGED
    if return_info:
        return x, converged, (status, it)
    return x, converged


def fcg_init(amul, prec, b, x0, psum=None):
    """Initial state for flexible CG: ``(x, r, z, p, rho)``.  ``psum``
    (row-sharded vectors): the mesh's sum of per-shard partials, for every
    dot and norm, as ``amg_tpu``'s ``axis_name``."""
    r0 = b - amul(x0)
    z0 = prec(r0)
    rho0 = dot(z0, r0, psum)
    return (x0, r0, z0, z0, rho0)


def fcg_step(amul, prec, state, psum=None):
    """One flexible-CG iteration.

    Flexible CG tolerates a variable preconditioner (one low-precision AMG
    cycle) by computing beta with the Polak-Ribiere form ``<z_new, r_new -
    r_old> / <z_old, r_old>`` instead of the Fletcher-Reeves ratio.
    Returns ``(state, absres)``.
    """
    x, r, z, p, rho = state
    q = amul(p)
    alpha = _safe_div(dot(p, r, psum), dot(p, q, psum))
    x = x + alpha * p
    r_new = r - alpha * q
    z_new = prec(r_new)
    rho_new = dot(z_new, r_new, psum)
    # <z_new, r_new - r_old>
    rho_pr = rho_new - dot(z_new, r, psum)
    beta = _safe_div(rho_pr, rho)
    p = z_new + beta * p
    return (x, r_new, z_new, p, rho_new), norm2(r_new, psum)


def fcg_refresh(amul, prec, b, state, psum=None):
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
    rho = dot(z, r, psum)
    return (x, r, z, p, rho), norm2(r, psum)


def fcg(a, b, x0, tol=1e-7, maxit=100, M=None):
    """Flexible preconditioned CG in one loop (``amg_tpu``'s
    ``lax.while_loop`` version), with the residual replaced every 10
    iterations.

    Returns ``(x, nits, absres)``.  Stopping: ``||r|| / ||b|| < tol``
    (the AMG outer-loop criterion, amg/Solve/SSS_SOLVE.c:64-79, not the
    coarsest-CG criterion); the host reads the residual every iteration.
    """
    amul = _as_op(a)
    prec = M if M is not None else _identity
    sumb = torch.clamp(norm2(b), min=SMALLFLOAT)
    st = fcg_init(amul, prec, b, x0)
    absres = norm2(st[1])
    it = 0
    while it < maxit and float(absres / sumb) >= tol:
        st, absres = fcg_step(amul, prec, st)
        if (it + 1) % 10 == 0:
            st, absres = fcg_refresh(amul, prec, b, st)
        it += 1
    return st[0], it, absres


def _givens_column(hcol, j, cs, sn, g, normr0, tol, tiny):
    """Step ``j`` of ``amg_tpu``'s Givens update on the host, in its order
    and in the vectors' dtype: rotate the raw Hessenberg column ``hcol``
    (length m + 1) by the earlier rotations, make rotation ``j``, and
    rotate ``g``.  Updates ``cs``, ``sn``, ``g`` in place; returns the
    rotated column and whether the solve is done (the residual estimate
    ``|g[j+1]|`` passed ``tol``, or a happy breakdown)."""
    hj1 = hcol[j + 1]
    for i in range(j):
        hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
        hi1 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
        hcol[i], hcol[i + 1] = hi, hi1
    denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
    big = denom > tiny
    c_new = hcol[j] / max(denom, tiny) if big else tiny.dtype.type(1)
    s_new = hcol[j + 1] / max(denom, tiny) if big else tiny.dtype.type(0)
    cs[j], sn[j] = c_new, s_new
    hcol[j] = c_new * hcol[j] + s_new * hcol[j + 1]
    hcol[j + 1] = 0
    gj1 = -s_new * g[j]
    g[j] = c_new * g[j]
    g[j + 1] = gj1
    done = bool(np.abs(gj1) / normr0 < tol) or bool(hj1 <= tiny)
    return hcol, done


def gmres(a, b, x0, tol=1e-7, maxit=1000, restart=30, M=None,
          return_iters=False, check_every=1):
    """Restarted GMRES(m) with MGS + Givens (``amg_tpu.solve.krylov.gmres``).
    Returns ``(x, converged)`` (or ``(x, converged, iters)`` with
    ``return_iters``; ``converged`` a bool, ``iters`` an int).  ``M`` is
    applied as a RIGHT preconditioner (e.g. one AMG cycle), so the
    residual being driven down is the true residual; as in ``amg_tpu``,
    convergence is accepted on the Givens estimate ``|g|``, and the step
    is ``x += M(V y)``.

    ``b`` is one vector.  The Arnoldi steps run on the device, the Givens
    rotations, the stop and the back-substitution on the host, which reads
    the new Hessenberg columns every ``check_every`` steps: steps computed
    after the stop in a block are dropped (``amg_tpu`` runs all ``m``
    steps of a restart and masks them).  ``iters`` is the number of steps
    kept, summed over restarts.  The basis ``V`` (``(m + 1, pad)``) is
    allocated once per call.
    """
    amul = _as_op(a)
    prec = M if M is not None else _identity
    m = restart
    n = b.shape[0]
    ndt = np.float64 if b.dtype == torch.float64 else np.float32
    tol_h, tiny = ndt(tol), ndt(SMALLFLOAT)

    V = b.new_zeros((m + 1, n))
    h_raw = b.new_zeros((m + 1, m))   # Hessenberg columns before rotation
    x = x0
    it = 0
    normr0 = None
    conv = False
    while it < maxit and not conv:
        r = b - amul(x)
        beta = norm2(r)
        V[0] = r / torch.clamp(beta, min=SMALLFLOAT)
        H = np.zeros((m + 1, m), ndt)
        cs = np.zeros(m, ndt)
        sn = np.zeros(m, ndt)
        g = np.zeros(m + 1, ndt)
        j, k_eff, done = 0, 0, False
        while j < m and not done:
            j_end = min(j + check_every, m)
            for jj in range(j, j_end):
                w = amul(prec(V[jj]))
                # modified Gram-Schmidt against the built basis vectors
                hs = []
                for i in range(jj + 1):
                    hij = dot(V[i], w)
                    w = w - hij * V[i]
                    hs.append(hij)
                hj1 = norm2(w)
                V[jj + 1] = torch.where(
                    hj1 > SMALLFLOAT, w / torch.clamp(hj1, min=SMALLFLOAT), w)
                h_raw[: jj + 2, jj] = torch.stack(hs + [hj1])
            # one host read: the block's raw columns (and, first, beta)
            host = torch.cat([beta.reshape(1),
                              h_raw[:, j:j_end].T.reshape(-1)]).cpu().numpy()
            counts["syncs"] += 1
            if j == 0:
                g[0] = host[0]
                if normr0 is None:
                    normr0 = max(tiny, host[0])
                    if host[0] / normr0 < tol_h:   # amg_tpu's initial test
                        conv = True
                        break
            cols = host[1:].reshape(j_end - j, m + 1)
            for jj in range(j, j_end):
                H[:, jj], done = _givens_column(cols[jj - j].copy(), jj, cs,
                                                sn, g, normr0, tol_h, tiny)
                k_eff = jj + 1
                if done:
                    break
            j = j_end
        if conv:
            break
        # back-substitution on the k_eff x k_eff triangular system
        y = np.zeros(m, ndt)
        for jj in range(k_eff - 1, -1, -1):
            s = g[jj] - np.dot(H[jj, :], y)
            hjj = H[jj, jj]
            y[jj] = s / hjj if np.abs(hjj) > tiny else 0
        yd = torch.from_numpy(y[:k_eff]).to(b.device)
        x = x + prec(V[:k_eff].T @ yd)
        it += k_eff
        conv = bool(np.abs(g[min(k_eff, m)]) / normr0 < tol_h)
    counts["gmres_solves"] += 1
    counts["gmres_iters"] += it
    if return_iters:
        return x, conv, it
    return x, conv
