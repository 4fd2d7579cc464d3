"""The entry frame of the solvers: what ``AMGSolver``, ``SpmdAMGSolver``
and ``DistAMGSolver`` do around their cycles, written once.

* :class:`Staging` moves host vectors into a solver's padded device
  layout and its solutions back, in the ``amg.upload`` and
  ``amg.download`` spans.  This is the whole-vector form; the row form of
  a row-sharded level 0 (``parallel/dist.py::RowStaging``) overrides only
  the two copies.
* :class:`EntryFrame`, the base of the three solvers, holds the step
  pieces (a cycle and its residual norm, a defect-correction step, FCG's
  operator and preconditioner), the entry's opening and closing (stage
  ``b`` and ``x0``, read ``||b||``, the verbose header, the reference's
  zero-``b`` short circuit, the times, the download, all in one
  ``amg.solve`` span) and the one host loop of cycles, plain or with
  defect correction.  A solver gives the frame its placement: its
  ``staging``, its cycle ``_cycle(x, b)``, its level-0 product
  ``_spmv(a, x)`` and ``_psum`` for its norms.
* :func:`fcg_host_loop` is FCG's host loop, and :func:`print_itinfo` the
  reference's residual table.

The frame imports nothing from ``parallel/``: the ring solvers import it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import tracing
from ..ops.blas import norm2
from ..params import SolveInfo, StopType
from .krylov import fcg_init, fcg_refresh, fcg_step


def print_itinfo(stop_type, it, relres, absres, factor, log=print):
    """Residual-table row, byte-compatible with the reference
    (``SSS_print_itinfo``, amg/SSS_utils.c:104-133)."""
    if it > 0:
        log("%6d | %13.6e   | %13.6e  | %10.4f" % (it, relres, absres, factor))
    else:
        log("-----------------------------------------------------------")
        if stop_type == StopType.REL_RES:
            log("It Num |   ||r||/||b||   |     ||r||      |  Conv. Factor")
        elif stop_type == StopType.REL_PRECRES:
            log("It Num | ||r||_B/||b||_B |    ||r||_B     |  Conv. Factor")
        else:
            log("It Num |   ||r||/||x||   |     ||r||      |  Conv. Factor")
        log("-----------------------------------------------------------")
        log("%6d | %13.6e   | %13.6e  |     -.-- " % (it, relres, absres))


def _flat(step_out):
    """``(state, absres)`` -> ``(*state, absres)``."""
    state, absres = step_out
    return (*state, absres)


def fcg_host_loop(pars, sumb, amul, prec, b, x0, info, steps, psum=None,
                  eager=False, log=print):
    """FCG host loop: batched residual fetches, replacement of the
    recursive residual every 10 iterations, and a truth check on the exact
    stopping iterate before convergence is accepted (reference
    false-convergence Check III, amg/Solve/SSS_cycle.cu:311-355); the
    loop of ``amg_tpu.solve.driver.fcg_host_loop``.

    FCG of ``amul`` preconditioned by ``prec`` on ``b`` from ``x0``
    (``psum``: row-sharded vectors, every dot and norm the mesh's): the
    initial state is made once, eagerly; the step, the residual
    replacement (``r = b - A x``) and the true residual norm run as the
    steps ``fcg``, ``fcg_refresh`` and ``fcg_true`` of ``steps`` (the
    solver's :class:`~.loop_graph.StepGraphs`; ``eager``: as they are),
    over the state ``(x, r, z, p, rho)``.  Appends ``||r0||`` to
    ``info.residuals`` and fills ``info``; returns the device solution.
    """
    st = fcg_init(amul, prec, b, x0, psum)
    with tracing.span("amg.read"):
        absres0 = float(norm2(st[1], psum))
    info.residuals.append(absres0)
    step = steps.step(
        "fcg", lambda *s: _flat(fcg_step(amul, prec, s, psum)), 5, pars,
        eager)
    refresh = steps.step(
        "fcg_refresh",
        lambda *s: _flat(fcg_refresh(amul, prec, s[5], s[:5], psum)), 5,
        pars, eager)
    truenorm = steps.step(
        "fcg_true", lambda x, bb: (norm2(bb - amul(x), psum),), 0, pars,
        eager)
    check_every = 1 if pars.verbose else 4
    refresh_every = 10
    false_conv_left = 3
    pending: list = []  # (it, device x, device absres)
    xd = st[0]
    stop = False
    it = 0
    while it < pars.max_it:
        it += 1
        *st, absres_d = step(*st)
        if it % refresh_every == 0:
            *st, absres_d = refresh(*st, b)
        pending.append((it, st[0], absres_d))
        if len(pending) >= check_every or it == pars.max_it:
            # one device-to-host copy for the whole batch
            with tracing.span("amg.read"):
                vals = torch.stack([r for _, _, r in pending]).cpu().numpy()
            converged = False
            for (it_i, x_i, _), absres in zip(pending, vals):
                absres = float(absres)
                relres = absres / sumb
                factor = absres / absres0 if absres0 > 0 else 0.0
                absres0 = absres
                if pars.verbose:
                    print_itinfo(pars.stop_type, it_i, relres, absres,
                                 factor, log=log)
                if not np.isfinite(absres):
                    if pars.verbose:
                        log("### WARNING: residual diverged "
                            f"(iteration {it_i}); stopping.")
                    stop = True
                    break
                info.ares, info.rres, info.nits = absres, relres, it_i
                info.residuals.append(absres)
                xd = x_i
                if relres < pars.tol:
                    converged = True
                    break
            pending = []
            if converged and not stop:
                # verify on the exact stopping iterate: the recursive
                # residual can flatter the truth by eps*kappa
                with tracing.span("amg.read"):
                    true_abs = float(truenorm(xd, b)[0])
                true_rel = true_abs / sumb
                if true_rel < pars.tol or false_conv_left == 0:
                    info.ares, info.rres = true_abs, true_rel
                    stop = True
                else:
                    false_conv_left -= 1
                    # report the measured truth even if max_it exhausts
                    # before the next check
                    info.ares, info.rres = true_abs, true_rel
                    absres0 = true_abs
                    *st, _ = refresh(*st, b)
                    if pars.verbose:
                        log("### WARNING: false convergence "
                            f"(true relres {true_rel:.3e}); "
                            "residual replaced, continuing.")
        if stop:
            break
    return xd


def level0_perm(hh):
    """A host hierarchy's level-0 similarity permutation (an RCM-ordered
    WEll level 0), or None."""
    return hh.perms[0] if hh.perms is not None else None


class Staging:
    """Host vectors into a solver's padded device layout, and its solutions
    back, in the caller's ordering: the whole-vector form.

    Built once per solver from the number of rows ``n``, level 0's
    ``pad``, the ``device`` and level 0's similarity permutation ``perm``
    (None when level 0 keeps the caller's ordering): b and x0 map in
    through it, x maps out through its inverse, and every residual norm is
    invariant.  The permutation goes to the device here, once.
    """

    def __init__(self, n: int, pad: int, device, perm=None):
        self.n, self.pad, self.device = n, pad, torch.device(device)
        self.perm, self.iperm = perm, None
        if perm is not None:
            self.iperm = np.empty_like(perm)
            self.iperm[perm] = np.arange(len(perm))
        self.perm_d = self._device_perm()

    def _device_perm(self):
        if self.perm is None:
            return None
        return torch.from_numpy(self.perm).to(self.device)

    def upload(self, v, dtype) -> torch.Tensor:
        """Host ``(n,)`` or columns ``(n, k)`` -> the padded device vector
        ``(pad,)`` or batch ``(k, pad)`` in ``dtype``."""
        with tracing.span("amg.upload") as sp:
            vd, sp.nbytes = self._put(v, dtype)
        return vd

    def _put(self, v, dtype):
        """One copy as given; permutation, cast and padding on the device
        (on the host they cost ~0.4 s at 1M rows x 16).  Returns the
        device vector and the bytes copied."""
        host = np.ascontiguousarray(np.asarray(v)[: self.n])
        vt = torch.from_numpy(host).to(self.device)
        if self.perm_d is not None:
            vt = vt[self.perm_d]
        vt = vt.movedim(0, -1)
        out = torch.zeros((*vt.shape[:-1], self.pad), dtype=dtype,
                          device=self.device)
        out[..., : self.n] = vt
        return out, host.nbytes

    def download(self, xd) -> np.ndarray:
        """A device solution -> host ``(n,)`` or ``(n, k)`` in the
        caller's ordering: one pageable copy, the inverse permutation on
        the host."""
        with tracing.span("amg.download") as sp:
            x = self._fetch(xd)
            sp.nbytes = x.nbytes
            x = x[..., : self.n].T
            return x[self.iperm] if self.iperm is not None else x

    def _fetch(self, xd) -> np.ndarray:
        return xd[..., : self.n].cpu().numpy()


class EntryFrame:
    """The entries of a solver around its cycle.

    A solver derives from it and sets ``pars``, ``log``, ``dtype``,
    ``mg``, ``a0_hi`` (the f64 level-0 operator of defect correction and
    FCG, or None), ``steps`` (its :class:`~.loop_graph.StepGraphs`),
    ``host_hierarchy``, ``staging`` and ``_psum`` (the mesh's psum when
    level 0 is row-sharded), and defines ``_cycle(x, b)`` and the level-0
    product ``_spmv(a, x)``.  The step pieces below are the bodies that
    the step graphs ``"cycle"``, ``"refine"``, ``"batched"`` and FCG's
    capture.
    """

    _psum = None
    # amg_tpu's ring loops: every relative residual over ||b||, and no
    # ||b|| at the head of a plain loop's history
    _ring_loop = False

    @property
    def _accel_dtype(self):
        """FCG and GMRES run in f64 around the cycle when refining."""
        return torch.float64 if self.a0_hi is not None else self.dtype

    def _norm(self, v):
        return norm2(v, self._psum)

    def _pad_vec(self, v, dtype=None) -> torch.Tensor:
        """A host vector into the solver's device layout (``dtype``: the
        cycle's by default)."""
        return self.staging.upload(v, dtype or self.dtype)

    def _unpad_vec(self, xd) -> np.ndarray:
        """A device solution back to the host: every entry's answer leaves
        through here."""
        return self.staging.download(xd)

    # -- step pieces -----------------------------------------------------

    def _step(self, x, b):
        """One cycle and the norm of the new residual (on the device)."""
        x = self._cycle(x, b)
        return x, self._norm(b - self._spmv(self.mg.levels[0].a, x))

    def _refine_step(self, x_hi, b_hi):
        """One defect-correction iteration: the f64 residual,
        ``refine_inner_cycles`` cycles in the solve dtype on the scaled
        defect, the f64 update and its residual norm."""
        r_hi = b_hi - self._spmv(self.a0_hi, x_hi)
        rn = self._norm(r_hi)
        scale = torch.where(rn > 0, rn, torch.ones_like(rn))
        r_lo = (r_hi / scale).to(self.dtype)
        e = torch.zeros_like(r_lo)
        for _ in range(max(self.pars.refine_inner_cycles, 1)):
            e = self._cycle(e, r_lo)
        x_hi = x_hi + e.to(torch.float64) * scale
        return x_hi, self._norm(b_hi - self._spmv(self.a0_hi, x_hi))

    def _amul(self, v):
        """The Krylov wrap's operator: the f64 level 0 when refining."""
        a0 = self.a0_hi if self.a0_hi is not None else self.mg.levels[0].a
        return self._spmv(a0, v)

    def _prec(self, r):
        """One cycle in the solve dtype on the scaled residual."""
        rn = self._norm(r)
        scale = torch.where(rn > 0, rn, torch.ones_like(rn))
        r_lo = (r / scale).to(self.dtype)
        e = self._cycle(torch.zeros_like(r_lo), r_lo)
        return e.to(self._accel_dtype) * scale

    # -- the entry's opening and closing ---------------------------------

    def _stage(self, b, x0, dtype):
        """``b`` on the device, and ``x0``, or zeros made on the device."""
        bd = self._pad_vec(b, dtype)
        return bd, (torch.zeros_like(bd) if x0 is None
                    else self._pad_vec(x0, dtype))

    def _close(self, xd, info, t0):
        info.solve_seconds = time.perf_counter() - t0
        info.setup_seconds = self.host_hierarchy.setup_seconds
        if self.pars.verbose:
            self.log(f"AMG solve time: {info.solve_seconds:g} s")
        return self._unpad_vec(xd), info

    @tracing.spanned("amg.solve")
    def _entry(self, b, x0, dtype, loop, *args, header=True):
        """An entry on one right-hand side: stage ``b`` and ``x0`` in
        ``dtype``, read ``||b||``, print the table's header (``header``),
        return zeros for a zero ``b`` (the reference's short circuit,
        amg/Solve/SSS_SOLVE.c:41-46), else run ``loop(bd, xd, sumb, info,
        *args) -> xd`` and close."""
        pars = self.pars
        bd, xd = self._stage(b, x0, dtype)
        info = SolveInfo()
        with tracing.span("amg.read"):
            sumb = float(self._norm(bd))
        t0 = time.perf_counter()
        if pars.verbose and header:
            print_itinfo(pars.stop_type, 0, 1.0, sumb, 0.0, log=self.log)
        if sumb == 0.0:
            return np.zeros(self.staging.n), info
        return self._close(loop(bd, xd, sumb, info, *args), info, t0)

    # -- the loops -------------------------------------------------------

    def _cycles(self, bd, xd, sumb, info, refined, eager):
        """The host loop of cycles: one step (``refined``: a
        defect-correction step of ``k = refine_inner_cycles`` cycles, else
        one cycle) per outer iteration, as step ``"refine"`` or
        ``"cycle"`` of ``steps`` (``eager``: as they are).  The residuals
        are read once per step with the live table (``pars.verbose``),
        else in one batch per 2 defect-correction steps or per 4 cycles.
        Stops at ``tol``, at ``max_it`` cycles, or at a non-finite
        residual, keeping the last finite iterate.  ``info.nits`` counts
        cycles.  Returns the last accepted x."""
        pars = self.pars
        if refined:
            k = max(pars.refine_inner_cycles, 1)
            step = self.steps.step("refine", self._refine_step, 1, pars,
                                   eager)
        else:
            k = 1
            step = self.steps.step("cycle", self._step, 1, pars, eager)
        every = 1 if pars.verbose else 2 if refined else 4
        # stop_type semantics (reference SSS_STOP_TYPE,
        # amg/Solve/SSS_cycle.cu:101-130): MOD_REL_RES divides by ||x||;
        # REL_PRECRES with B=I equals REL_RES (the reference's
        # preconditioner B is identity)
        mod_rel = (not refined and not self._ring_loop
                   and pars.stop_type == StopType.MOD_REL_RES)
        if refined or not self._ring_loop:
            info.residuals.append(sumb)
        max_outer = max(pars.max_it // k, 1)
        absres0, x = sumb, xd
        pending: list = []  # (cycles, device x, device absres)
        for outer in range(1, max_outer + 1):
            xd, absres_d = step(xd, bd)
            pending.append((outer * k, xd, absres_d))
            if len(pending) < every and outer != max_outer:
                continue
            # one device-to-host copy for the whole batch
            with tracing.span("amg.read"):
                vals = torch.stack([r for _, _, r in pending]).cpu().numpy()
            if mod_rel:
                with tracing.span("amg.read"):
                    xnorms = torch.stack(
                        [norm2(xv) for _, xv, _ in pending]).cpu().numpy()
            for j, ((it, x_j, _), absres) in enumerate(zip(pending, vals)):
                absres = float(absres)
                relres = absres / (max(float(xnorms[j]), 1e-300) if mod_rel
                                   else sumb)
                factor = (absres / absres0) ** (1.0 / k) if absres0 > 0 \
                    else 0.0
                absres0 = absres
                if pars.verbose:
                    print_itinfo(pars.stop_type, it, relres, absres, factor,
                                 log=self.log)
                if not np.isfinite(absres):
                    if pars.verbose:
                        self.log("### WARNING: residual diverged ("
                                 f"{'cycle' if refined else 'iteration'} "
                                 f"{it}); stopping.")
                    return x
                info.ares, info.rres, info.nits = absres, relres, it
                info.residuals.append(absres)
                x = x_j
                if relres < pars.tol:
                    return x
            pending = []
        return x

    def _fcg(self, bd, xd, sumb, info, eager):
        """FCG preconditioned by one cycle (:func:`fcg_host_loop`)."""
        return fcg_host_loop(self.pars, sumb, self._amul, self._prec, bd,
                             xd, info, self.steps, self._psum, eager,
                             log=self.log)
