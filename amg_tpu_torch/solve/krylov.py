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
* :class:`CoarsestKrylov` — the reference's coarsest solve: CG, then
  GMRES from zero where CG did not converge (amg/Solve/SSS_cycle.cu:
  819-846);
* :func:`fcg` (:class:`FCGLoop`) and its steps :func:`fcg_init`,
  :func:`fcg_step`, :func:`fcg_refresh` — Notay's flexible CG, which
  ``AMGSolver.solve_pcg`` runs with one AMG cycle as the preconditioner.

``amg_tpu`` runs ``cg``, ``gmres`` and ``fcg`` under ``lax.while_loop``
and the coarsest solve's fallback and FCG's residual replacement under
``lax.cond``.  Here each loop is a body that updates fixed state tensors
in place and leaves a device flag saying whether to go on
(:class:`CGLoop`, :class:`GMRESLoop`, :class:`FCGLoop`), and the loops
form a program of :mod:`.loop_graph`: on the card one CUDA graph of while
and if nodes, built at first use, with no host read inside; on the CPU
the same bodies under a host ``while`` (one read of the flag per
iteration, counted in ``counts["syncs"]``).  The bodies follow
``amg_tpu``'s order and semantics in the vectors' dtype:

* a CG iteration is masked by a ``running`` flag, so a batch ``(k, pad)``
  runs every column to its own stop, as ``vmap`` of ``amg_tpu``'s loop
  does, and the true residual ``b - A x`` is computed every iteration and
  selected with ``torch.where`` (the ``lax.cond`` of ``amg_tpu``);
* a GMRES restart is a program of its own: a begin, a while loop of
  Arnoldi steps and an end.  A step reads its index ``j`` from the device
  (the basis row ``V[j]`` by ``index_select``, the new one by
  ``index_copy_``), runs modified Gram-Schmidt over every basis row with
  the coefficients of rows past ``j`` set to 0, as ``amg_tpu`` does, and
  ends in the Givens kernel of :mod:`..ops.krylov_small`, which advances
  ``j`` and sets the loop's flag: the loop stops at the step that set
  ``done`` (``amg_tpu``'s masked steps after it change nothing).  The end
  is the back-substitution kernel and ``x += M(V y)``;
* an FCG iteration is a step, then an if node that replaces the residual
  every 10 iterations, then the test of ``||r|| / ||b||``.

``cg``, ``gmres``, ``fcg`` and the FCG steps take ``psum`` for one
row-sharded ``(S, m)`` vector (``amg_tpu``'s ``axis_name``): every dot and
norm is the global one, so the loops' flags hold the same value on every
shard and process, and every process runs the same iterations.  The route
(:func:`_route`) follows the ``psum``'s process group, never its size:
one CUDA graph with no psum, with that of a mesh whose shards all sit in
this process (a local sum) and with that of an NCCL group (its
``all_reduce`` and the ring's ``batch_isend_irecv`` captured inside the
while bodies, NCCL's event nodes taken out of them:
:meth:`.loop_graph.LoopGraph`); the host loop with a gloo group, whose
collectives cannot be captured, and with any other callable.

``counts`` holds the Krylov layer's host reads (``syncs``, a host integer)
and its work, which the bodies add to on the device: CG and GMRES solves
and iterations and the CG solves that did not converge (read once, when
the caller reads them).
"""

from __future__ import annotations

from collections.abc import MutableMapping

import torch

from .. import tracing
from ..params import SMALLFLOAT, MAX_STAG, MAX_RESTART, ErrorCode, StopType
from ..sparse import Ell, Dia, Dense, BandedBlocks
from ..ops import krylov_small
from ..ops.spmv import spmv
from ..ops.blas import dot, norm2, norminf
from .loop_graph import Copy, If, LoopGraph, While, run_plain

_SMALLFLOAT2 = 1e-40  # breakdown tolerance (reference SMALLFLOAT2)

# status values for the CG state machine
_RUNNING = 0
_CONVERGED = 1
_BREAKDOWN = 2


class _Counts(MutableMapping):
    """The Krylov layer's counters: ``syncs`` (host reads of the host
    loops) on the host; ``cg_solves``, ``cg_iters``, ``cg_failed``,
    ``gmres_solves`` and ``gmres_iters`` on each device the loops ran on,
    added to by the bodies.  Reading one of these reads the devices; a
    key set to a value sets it on the host's counter and 0 elsewhere."""

    WORK = ("cg_solves", "cg_iters", "cg_failed", "gmres_solves",
            "gmres_iters")

    def __init__(self):
        self._syncs = 0
        self._work: dict = {}

    def work(self, device) -> torch.Tensor:
        """The int64 counters ``(len(WORK),)`` of ``device``."""
        device = torch.device(device)
        if device not in self._work:
            self._work[device] = torch.zeros(len(self.WORK),
                                             dtype=torch.int64,
                                             device=device)
        return self._work[device]

    def __getitem__(self, key):
        if key == "syncs":
            return self._syncs
        i = self.WORK.index(key)
        return sum(int(t[i]) for t in self._work.values())

    def __setitem__(self, key, value):
        if key == "syncs":
            self._syncs = value
            return
        i = self.WORK.index(key)
        for t in self._work.values():
            t[i] = 0
        if value:
            self.work("cpu")[i] = value

    def __delitem__(self, key):
        raise TypeError("the Krylov counters cannot be removed")

    def __iter__(self):
        return iter(("syncs",) + self.WORK)

    def __len__(self):
        return 1 + len(self.WORK)


# host reads and work of the Krylov loops, over every call (set to 0 by
# callers)
counts = _Counts()
_W = {k: i for i, k in enumerate(_Counts.WORK)}
# the graph of the last loop run on the graph route: its nodes, build
# seconds and the NCCL event nodes taken out of its loop bodies
last_graph: dict = {}


def _read(flag) -> bool:
    """One host read of a loop flag."""
    counts["syncs"] += 1
    with tracing.span("amg.read"):
        return bool(flag)


def _run(prog, device, psum=None, graph: bool = True):
    """Run a program on :func:`_route`'s route: one CUDA graph built for
    this call and closed after it, its kernel launches added to the
    counters (one host read), or the host loop."""
    if _route(device, psum, graph) == "graph":
        g = LoopGraph(prog, device, restore=(counts.work(device),))
        try:
            g.launch()
            g.settle()
        finally:
            last_graph.update(nodes=g.nodes, build_s=g.build_seconds,
                              events=g.events)
            g.close()
    else:
        run_plain(prog, _read)


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


class CGLoop:
    """The CG state machine of :func:`cg` on fixed buffers.

    The caller fills ``b`` and ``x0`` (shaped like ``like``: one vector, a
    ``(k, pad)`` batch or, with ``psum``, one row-sharded ``(S, m)``
    vector); :meth:`start`, then :meth:`body` while ``go``, then
    :meth:`finish` leave the solution in ``xout`` and each column's
    ``status`` and iterations ``it`` (``()`` per vector, ``(k, 1)`` for a
    batch).  No method reads the host."""

    def __init__(self, a, like, tol, maxit, M=None, stop_type=None,
                 psum=None):
        self.amul = _as_op(a)
        self.prec = M if M is not None else _identity
        self.st = StopType.REL_RES if stop_type is None else stop_type
        self.tol, self.maxit, self.psum = tol, maxit, psum
        self.maxdiff = tol * 1e-4       # stagnation tolerance (reference :27)
        kw = dict(dtype=like.dtype, device=like.device)
        scalar = (() if like.dim() == 1 or psum is not None
                  else (like.shape[0], 1))

        def vec():
            return torch.zeros(like.shape, **kw)

        def sc(dtype=like.dtype):
            return torch.zeros(scalar, dtype=dtype, device=like.device)

        i32 = torch.int32
        self.b, self.x0, self.xout = vec(), vec(), vec()
        # x, r, z, p, rho, it, best_x, best_res, stag, more_step, status
        self.state = (vec(), vec(), vec(), vec(), sc(), sc(i32), vec(), sc(),
                      sc(i32), sc(i32), sc(i32))
        self.it, self.status = self.state[5], self.state[10]
        self.normr0 = sc()
        self.go = torch.zeros((), dtype=torch.bool, device=like.device)
        self.work = counts.work(like.device)

    @property
    def program(self) -> tuple:
        return (self.start, While(self.go, (self.body,)), self.finish)

    def _absres(self, r, z):
        if self.st == StopType.REL_PRECRES:
            return torch.sqrt(torch.abs(dot(z, r, self.psum)))
        return norm2(r, self.psum)

    def _relres(self, x, absres):
        if self.st == StopType.MOD_REL_RES:
            return absres / torch.clamp(norm2(x, self.psum), min=SMALLFLOAT)
        return absres / self.normr0

    def _near_zero(self, x):
        # Check I's ||x||_inf <= tol (reference :28); row-sharded: no entry
        # above tol on any shard (a psum of counts)
        if self.psum is None:
            return norminf(x) <= SMALLFLOAT
        return self.psum(torch.sum(torch.abs(x) > SMALLFLOAT, dim=-1)
                         .to(x.dtype)) == 0

    def _set_go(self):
        self.go.copy_(torch.any((self.status == _RUNNING)
                                & (self.it < self.maxit)))

    def start(self):
        b, x0, psum = self.b, self.x0, self.psum
        r0 = b - self.amul(x0)
        z0 = self.prec(r0)
        absres0 = norm2(r0, psum)
        self.normr0.copy_(torch.clamp(absres0, min=SMALLFLOAT))
        rho0 = dot(z0, r0, psum)
        one = torch.ones_like(absres0, dtype=torch.int32)
        for t, v in zip(self.state, (x0, r0, z0, z0, rho0, 0 * one, x0,
                                     absres0, one, one, 0 * one)):
            t.copy_(v)
        self._set_go()

    def body(self):
        """One iteration, masked by each column's ``running`` flag: a
        finished column keeps its state, where ``amg_tpu``'s loop has
        stopped."""
        amul, prec, psum, tol = self.amul, self.prec, self.psum, self.tol
        b, maxdiff = self.b, self.maxdiff
        (x, r, z, p, rho, it, best_x, best_res, stag, more_step,
         status) = self.state
        running = (status == _RUNNING) & (it < self.maxit)
        t = amul(p)
        denom = dot(p, t, psum)
        breakdown = torch.abs(denom) <= _SMALLFLOAT2
        alpha = torch.where(breakdown, 0.0,
                            rho / torch.where(breakdown, 1.0, denom))
        x_n = x + alpha * p
        r_n = r - alpha * t
        z_n = prec(r_n)
        absres = self._absres(r_n, z_n)
        relres = self._relres(x_n, absres)

        # best-solution tracking (reference :238-242)
        better = absres < best_res - maxdiff
        best_x_n = torch.where(better, x_n, best_x)
        best_res_n = torch.where(better, absres, best_res)

        # Check I: solution close to zero (reference :245-249)
        sol_stag = self._near_zero(x_n)

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
        abs_true = self._absres(r_true, z_true)
        rel_true = self._relres(x_n, abs_true)

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
        for t_, n_ in zip(self.state, new):
            t_.copy_(torch.where(running, n_, t_))
        self._set_go()

    def finish(self):
        """Restore the best solution where the final iterate is worse
        (reference best-solution net, amg/Solve/SSS_cycle.cu:381-419) into
        ``xout``; add the solve to the device counters."""
        x, r, z = self.state[:3]
        best_x, best_res = self.state[6], self.state[7]
        absres = self._absres(r, z)
        self.xout.copy_(torch.where(absres <= best_res + self.maxdiff, x,
                                    best_x))
        w = self.work
        w[_W["cg_solves"]].add_(self.status.numel())
        w[_W["cg_iters"]].add_(self.it.sum())
        w[_W["cg_failed"]].add_((self.status != _CONVERGED).sum())


def _route(device, psum=None, graph: bool = True) -> str:
    """The route of a Krylov loop on ``device`` with ``psum``: ``"graph"``
    (one :class:`~.loop_graph.LoopGraph`, no host read inside) on the card
    with no ``psum``, the ``psum`` of a mesh without a process group
    (``parallel.dist.Mesh.psum``: a local sum) or that of an NCCL group,
    whose ``all_reduce`` and halo messages the graph captures; ``"host"``
    (the host reads each loop flag) on the CPU, for a gloo group (its
    collectives are not captured), any other callable, and the plain
    versions (``graph`` False).  The route follows the backend, never the
    number of processes."""
    if device.type != "cuda" or not graph:
        return "host"
    if psum is None:
        return "graph"
    mesh = getattr(psum, "__self__", None)
    return ("graph" if getattr(mesh, "backend", "") in (None, "nccl")
            else "host")


def _cg(a, b, x0, tol, maxit, M, stop_type, return_info, psum, graph):
    loop = CGLoop(a, b, tol, maxit, M, stop_type, psum)
    loop.b.copy_(b)
    loop.x0.copy_(x0)
    _run(loop.program, b.device, psum, graph)
    status, it = loop.status, loop.it
    if b.dim() == 2 and psum is None:
        status, it = status.reshape(-1), it.reshape(-1)
    converged = status == _CONVERGED
    if return_info:
        return loop.xout, converged, (status, it)
    return loop.xout, converged


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

    On the card the loop is one CUDA graph (a while node), built for the
    call: that build runs the start, one iteration and the finish twice
    eagerly (the second time under ``torch.cuda.set_sync_debug_mode(
    "error")``), captures and instantiates, so ``a`` and ``M`` must run
    without a host read or synchronisation, and a single call pays the
    build (PERF.md gives its cost against :func:`cg_plain`); the route of
    a ``psum`` is :func:`_route`'s (one graph for a mesh of this process
    or an NCCL group).  On the CPU, and with a gloo group's ``psum`` or
    another callable, the host reads the flag once per iteration.
    Returns ``(x, converged)``, or ``(x, converged, info)`` with
    ``return_info`` where ``info = (status_code, iters)`` and
    ``status_code`` is 1 on convergence, ``ErrorCode.ERROR_SOLVER_*`` on a
    safety-net exit, 2 on breakdown and 0 when ``maxit`` was exhausted;
    device tensors, ``()`` for one vector and ``(k,)`` for a batch.
    """
    return _cg(a, b, x0, tol, maxit, M, stop_type, return_info, psum, True)


def cg_plain(a, b, x0, tol=1e-7, maxit=250, M=None, stop_type=None,
             return_info=False, psum=None):
    """:func:`cg` with its host loop on any device (the plain version of
    the graph, which tests and ``chip_smoke.py`` hold it against)."""
    return _cg(a, b, x0, tol, maxit, M, stop_type, return_info, psum, False)


class GMRESLoop:
    """Restarted GMRES(m) of :func:`gmres` on fixed buffers, for one
    vector or, with ``psum``, one row-sharded ``(S, m)`` vector.

    The caller fills ``b`` and ``x0``; :attr:`program` (:meth:`start`,
    then :attr:`restart` while ``go``) leaves the solution in ``x``, the
    Arnoldi steps kept in ``it`` and the verdict in ``conv``.  A restart
    is :meth:`restart_begin`, :meth:`step` while ``step_go`` (at most m
    times), and :meth:`restart_end`.  The basis ``V`` is ``(m + 1,
    *like.shape)``, zeroed by each restart, so that the Gram-Schmidt terms
    of rows not built yet subtract exact zeros, as ``amg_tpu``'s fresh
    basis does.  With ``psum`` every dot and norm is the global one
    (``amg_tpu``'s ``axis_name``), so ``H``, ``g``, the rotations and the
    flags hold the same numbers on every shard and process.  No method
    reads the host."""

    def __init__(self, a, like, tol, maxit, restart=30, M=None, psum=None):
        self.amul = _as_op(a)
        self.prec = M if M is not None else _identity
        self.tol, self.maxit, self.m, self.psum = tol, maxit, restart, psum
        kw = dict(dtype=like.dtype, device=like.device)
        shape, m = tuple(like.shape), restart
        self.b, self.x0, self.x = (torch.zeros(shape, **kw) for _ in range(3))
        self.V = torch.zeros((m + 1, *shape), **kw)
        self.hcol = torch.zeros(m + 1, **kw)       # a step's MGS coefficients
        self.hraw = torch.zeros((m, m + 1), **kw)  # columns before rotation
        self.H = torch.zeros((m + 1, m), **kw)
        self.cs, self.sn = torch.zeros(m, **kw), torch.zeros(m, **kw)
        self.g = torch.zeros(m + 1, **kw)
        self.normr0, self.zero = (torch.zeros((), **kw) for _ in range(2))
        flag = dict(dtype=torch.bool, device=like.device)
        self.done, self.conv, self.go, self.step_go = (
            torch.zeros((), **flag) for _ in range(4))
        i32 = dict(dtype=torch.int32, device=like.device)
        self.k_eff, self.it, self.j = (torch.zeros((), **i32)
                                       for _ in range(3))
        self.rows = torch.arange(m + 1, device=like.device)
        self.work = counts.work(like.device)

    @property
    def restart(self) -> tuple:
        return (self.restart_begin, While(self.step_go, (self.step,)),
                self.restart_end)

    @property
    def program(self) -> tuple:
        return (self.start, While(self.go, self.restart))

    def _set_go(self):
        self.go.copy_((self.it < self.maxit) & ~self.conv)

    def start(self):
        self.x.copy_(self.x0)
        beta0 = norm2(self.b - self.amul(self.x0), self.psum)
        self.normr0.copy_(torch.clamp(beta0, min=SMALLFLOAT))
        self.it.zero_()
        self.conv.copy_(beta0 / self.normr0 < self.tol)
        self._set_go()
        self.work[_W["gmres_solves"]].add_(1)

    def restart_begin(self):
        r = self.b - self.amul(self.x)
        beta = norm2(r, self.psum)
        self.V[1:].zero_()
        self.V[0].copy_(r / torch.clamp(beta, min=SMALLFLOAT))
        for t in (self.H, self.cs, self.sn, self.g, self.done, self.k_eff,
                  self.j):
            t.zero_()
        self.g[0].copy_(beta)
        self.step_go.fill_(True)

    def step(self):
        """Arnoldi step ``j`` (read on the device): modified Gram-Schmidt
        against every basis row (coefficients past ``j`` are 0), ``V[j +
        1]``, then the Givens kernel (``j += 1``, ``step_go``)."""
        V, j, psum = self.V, self.j, self.psum
        jl = j.reshape(1).long()
        w = self.amul(self.prec(V.index_select(0, jl)[0]))
        built = self.rows <= j
        for i in range(self.m + 1):
            torch.where(built[i], dot(V[i], w, psum), self.zero,
                        out=self.hcol[i])
            w = w - self.hcol[i] * V[i]
        hj1 = norm2(w, psum)
        V.index_copy_(0, jl + 1, torch.where(
            hj1 > SMALLFLOAT, w / torch.clamp(hj1, min=SMALLFLOAT), w)[None])
        krylov_small.givens(self.hcol, hj1, j, self.hraw, self.H, self.cs,
                            self.sn, self.g, self.done, self.k_eff,
                            self.step_go, self.normr0, self.tol)

    def restart_end(self):
        y = krylov_small.backsub(self.H, self.g, self.k_eff)
        # V y: a contraction over the basis rows, each shard's rows as
        # amg_tpu's V[:m].T @ y runs per shard
        vy = (self.V[: self.m].reshape(self.m, -1).T @ y).reshape(
            self.x.shape)
        self.x.copy_(self.x + self.prec(vy))
        self.it.add_(self.k_eff)
        res = torch.abs(self.g.index_select(
            0, torch.clamp(self.k_eff, max=self.m).reshape(1).long()))[0]
        self.conv.copy_(res / self.normr0 < self.tol)
        self._set_go()
        self.work[_W["gmres_iters"]].add_(self.k_eff)


def _gmres(a, b, x0, tol, maxit, restart, M, return_iters, psum, graph):
    loop = GMRESLoop(a, b, tol, maxit, restart, M, psum)
    loop.b.copy_(b)
    loop.x0.copy_(x0)
    _run(loop.program, b.device, psum, graph)
    if return_iters:
        return loop.x, loop.conv, loop.it
    return loop.x, loop.conv


def gmres(a, b, x0, tol=1e-7, maxit=1000, restart=30, M=None,
          return_iters=False, psum=None):
    """Restarted GMRES(m) with MGS + Givens (``amg_tpu.solve.krylov.gmres``).
    Returns ``(x, converged)`` (or ``(x, converged, iters)`` with
    ``return_iters``; 0-d device tensors).  ``M`` is applied as a RIGHT
    preconditioner (e.g. one AMG cycle), so the residual being driven down
    is the true residual; as in ``amg_tpu``, convergence is accepted on
    the Givens estimate ``|g|`` and the step is ``x += M(V y)``; a
    restart ends at the Arnoldi step that met the estimate (``amg_tpu``
    runs its ``m`` steps, those after the stop masked to change nothing).
    ``iters`` counts the steps kept, summed over restarts.  ``b`` is one
    vector or, with ``psum`` (:meth:`~amg_tpu_torch.parallel.dist.Mesh.
    psum`), one row-sharded vector's ``(S, m)`` block with ``a`` its
    row-sharded product (a callable): every dot and norm is the global one
    (``m + 2`` psums per Arnoldi step, as ``amg_tpu``'s).  On the card
    the restarts and their Arnoldi steps run in one CUDA graph (a while
    node over restarts, each holding a while node over one captured
    step), built for the call: that build runs the start, a restart's
    begin, one step and its end twice eagerly (the second time under
    ``torch.cuda.set_sync_debug_mode("error")``: 6 applications of ``a``
    and 4 of ``M``), captures and instantiates, so ``a`` and ``M`` must
    run without a host read or synchronisation, and a single call pays
    the build (PERF.md gives its cost against :func:`gmres_plain`); the
    route of a ``psum`` is :func:`_route`'s.  On the CPU the host reads a
    flag before each restart and each step."""
    return _gmres(a, b, x0, tol, maxit, restart, M, return_iters, psum, True)


def gmres_plain(a, b, x0, tol=1e-7, maxit=1000, restart=30, M=None,
                return_iters=False, psum=None):
    """:func:`gmres` with its host loop on any device (the plain version
    of the graph)."""
    return _gmres(a, b, x0, tol, maxit, restart, M, return_iters, psum,
                  False)


class CoarsestKrylov:
    """The reference's KRYLOV coarsest solve on one operator ``a``: CG to
    ``tol`` (at most ``maxit`` iterations), then GMRES(``restart``) from
    zero on every column where CG did not converge
    (amg/Solve/SSS_cycle.cu:819-846; ``amg_tpu`` takes the branch with
    ``lax.cond``, per column under ``vmap``).

    ``like`` is one vector or a ``(k, pad)`` batch: one CG runs over the
    batch, then for each column an if node on its status copies the column
    into a one-vector GMRES's buffers, runs it and copies it back, as the
    one-vector call would.  :meth:`solve` runs the program as one CUDA
    graph on the card (built at first use; inside another capture, added
    to it) and as host loops on the CPU; :meth:`solve_plain` runs the host
    loops on any device.  ``gm_its`` keeps, per column, the last solve's
    GMRES iterations (-1 where GMRES did not run)."""

    def __init__(self, a, like, tol, maxit, restart=30):
        self.cg = CGLoop(a, like, tol, maxit)
        one = like if like.dim() == 1 else like[0]
        self.gm = GMRESLoop(a, one, tol, maxit, restart)
        self.b, self.x = self.cg.b, self.cg.xout
        batch = like.dim() == 2
        self.failed = torch.zeros(like.shape[:1] if batch else (),
                                  dtype=torch.bool, device=like.device)
        self.gm_its = torch.zeros(like.shape[0] if batch else 1,
                                  dtype=torch.int32, device=like.device)
        gm, status, failed, gm_its = self.gm, self.cg.status, self.failed, \
            self.gm_its

        def mark_failed():
            # a closure, not a method: the program holds no reference back
            # to the solve, which is then freed as soon as a cache drops it
            # (not by the cyclic collector, whose frees may land inside a
            # CUDA graph capture)
            failed.copy_((status != _CONVERGED).reshape(failed.shape))
            gm_its.fill_(-1)

        prog = [*self.cg.program, mark_failed]
        for c in range(like.shape[0]) if batch else (None,):
            at = (lambda t: t) if c is None else (lambda t: t[c])
            prog.append(If(at(self.failed), (
                Copy(gm.b, at(self.b)), gm.start, While(gm.go, gm.restart),
                Copy(at(self.x), gm.x), Copy(self.gm_its[c or 0], gm.it))))
        self.program = tuple(prog)
        self.graph = None

    def solve(self, b) -> torch.Tensor:
        if not b.is_cuda:
            return self.solve_plain(b)
        if self.graph is None:
            self.graph = LoopGraph(self.program, b.device,
                                   restore=(counts.work(b.device),))
        self.b.copy_(b)
        if torch.cuda.is_current_stream_capturing():
            self.graph.add_to_capture()
        else:
            self.graph.launch()
        return self.x.clone()

    def solve_plain(self, b) -> torch.Tensor:
        self.b.copy_(b)
        run_plain(self.program, _read)
        return self.x.clone()


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


class FCGLoop:
    """Flexible CG of :func:`fcg` on fixed buffers: one vector or, with
    ``psum``, one row-sharded ``(S, m)`` vector.

    The caller fills ``b`` and ``x0``; :attr:`program` (:meth:`start`,
    then :meth:`step`, the residual replacement :meth:`refresh` where
    ``refresh_due``, and :meth:`set_go` while ``go``) leaves the state
    ``(x, r, z, p, rho)`` in ``state``, the iterations in ``it`` and the
    last residual norm in ``absres``: ``amg_tpu``'s ``lax.while_loop``,
    its ``lax.cond`` every 10 iterations an if node.  No method reads the
    host."""

    def __init__(self, a, like, tol, maxit, M=None, psum=None):
        self.amul = _as_op(a)
        self.prec = M if M is not None else _identity
        self.tol, self.maxit, self.psum = tol, maxit, psum
        kw = dict(dtype=like.dtype, device=like.device)
        self.b, self.x0 = torch.zeros_like(like), torch.zeros_like(like)
        self.state = (*(torch.zeros_like(like) for _ in range(4)),
                      torch.zeros((), **kw))
        self.absres, self.sumb = (torch.zeros((), **kw) for _ in range(2))
        self.it = torch.zeros((), dtype=torch.int32, device=like.device)
        self.go, self.refresh_due = (torch.zeros((), dtype=torch.bool,
                                                 device=like.device)
                                     for _ in range(2))

    @property
    def program(self) -> tuple:
        return (self.start, While(self.go, (
            self.step, If(self.refresh_due, (self.refresh,)), self.set_go)))

    def _keep(self, st, absres):
        for t, v in zip(self.state, st):
            t.copy_(v)
        self.absres.copy_(absres)

    def start(self):
        psum = self.psum
        self.sumb.copy_(torch.clamp(norm2(self.b, psum), min=SMALLFLOAT))
        st = fcg_init(self.amul, self.prec, self.b, self.x0, psum)
        self._keep(st, norm2(st[1], psum))
        self.it.zero_()
        self._set_go()

    def step(self):
        self._keep(*fcg_step(self.amul, self.prec, self.state, self.psum))
        self.refresh_due.copy_((self.it + 1) % 10 == 0)

    def refresh(self):
        self._keep(*fcg_refresh(self.amul, self.prec, self.b, self.state,
                                self.psum))

    def _set_go(self):
        self.go.copy_((self.it < self.maxit)
                      & (self.absres / self.sumb >= self.tol))

    def set_go(self):
        self.it.add_(1)
        self._set_go()


def _fcg(a, b, x0, tol, maxit, M, psum, graph):
    loop = FCGLoop(a, b, tol, maxit, M, psum)
    loop.b.copy_(b)
    loop.x0.copy_(x0)
    _run(loop.program, b.device, psum, graph)
    return loop.state[0], loop.it, loop.absres


def fcg(a, b, x0, tol=1e-7, maxit=100, M=None, psum=None):
    """Flexible preconditioned CG in one loop (``amg_tpu``'s
    ``lax.while_loop`` version), with the residual replaced every 10
    iterations.

    Returns ``(x, nits, absres)`` (``nits`` and ``absres`` 0-d device
    tensors).  Stopping: ``||r|| / ||b|| < tol`` (the AMG outer-loop
    criterion, amg/Solve/SSS_SOLVE.c:64-79, not the coarsest-CG
    criterion).  With ``psum`` ``b`` and ``x0`` are one row-sharded
    vector's ``(S, m)`` block and ``a`` its row-sharded product, as for
    :func:`cg`.  On the card the loop is one CUDA graph (a while node
    whose body holds the iteration and an if node around the residual
    replacement), built for the call as :func:`cg`'s is, so ``a`` and
    ``M`` must run without a host read; the route of a ``psum`` is
    :func:`_route`'s.  On the CPU the host reads two flags per
    iteration."""
    return _fcg(a, b, x0, tol, maxit, M, psum, True)


def fcg_plain(a, b, x0, tol=1e-7, maxit=100, M=None, psum=None):
    """:func:`fcg` with its host loop on any device (the plain version of
    the graph)."""
    return _fcg(a, b, x0, tol, maxit, M, psum, False)
