"""Outer AMG solve driver.

Replicates the reference's two-layer driver:

* ``SSS_solver_amg`` (amg/SSS_AMG.c:9-59): zero-rhs short circuit, sanity
  checks, setup + solve + total-time print.
* ``SSS_amg_solve`` (amg/Solve/SSS_SOLVE.c:4-87): cycle until
  ``||r||/||b|| < tol`` or ``max_it``, printing the per-iteration residual
  table (``SSS_print_itinfo``, amg/SSS_utils.c:104-133) with identical
  formatting.

The cycle is plain Python over device tensors on the solver's ``device``
(the card unless the caller asks for the CPU).  ``amg_tpu`` compiles each
step of a host loop (a cycle and its residual norm, a defect-correction
step, an FCG iteration, a batched cycle) into one XLA program; here each
is a :class:`~.loop_graph.StepGraph`, on the card a CUDA graph captured
at an entry's first call and replayed by every step of later calls, on
the CPU the same static buffers run eagerly.
:meth:`AMGSolver.solve` is the host loop of the reference; with
``pars.accel == "cg"`` it runs :meth:`AMGSolver.solve_pcg` (flexible CG
preconditioned by one cycle, in f64 with ``pars.refine``), with
``pars.accel == "gmres"`` :meth:`AMGSolver.solve_pgmres` (GMRES right-
preconditioned by one cycle, likewise; on the card one CUDA graph, built
on the first call and replayed), and with
``pars.refine`` and a float32 cycle otherwise
:meth:`AMGSolver.solve_refined` (f32 cycles, f64 outer residual).
Their staging, step pieces, opening and closing and the host loop of
cycles are the entry frame's (:mod:`.entry`), which the ring solvers
share; residual norms are fetched to the host in batches when the live
table is off.  :meth:`AMGSolver.solve_batched` runs the cycle on a ``(k, pad)``
batch of right-hand sides.  :meth:`AMGSolver.solve_jit` keeps the loop's
state on the device and runs masked steps (:class:`JitLoop`), on the card
as replays of a CUDA graph of one step.
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import numpy as np
import torch

from .. import tracing
from ..params import AMGParams, SolveInfo, StopType, MAX_RESTART
from ..sparse import CSR, Dia, Dense, Ell, WEll, torch_dtype
from ..hierarchy import setup, _pick_format, resolve_device
from ..ops.spmv import spmv
from ..ops.blas import norm2
from .cycle import cycle
from . import krylov
from .entry import EntryFrame, Staging, level0_perm, print_itinfo
from .krylov import GMRESLoop
from .loop_graph import LoopGraph, StepGraph, StepGraphs, run_plain, settle


# masked steps per host read in solve_jit's loop: the quiet cadence of
# AMGSolver.solve (one residual fetch per 4 cycles)
JIT_BLOCK = 4


class JitLoop:
    """The loop of :meth:`AMGSolver.solve_jit` with its state on the
    device: the counterpart of ``amg_tpu``'s ``lax.while_loop``
    (``amg_tpu/solve/driver.py:168-191``).

    Static buffers hold ``x``, ``b``, the iteration ``it`` (int32), the
    last residual ``absres``, ``sumb = ||b||`` and the history ``hist``
    (``max_it + 1`` entries, NaN where unused).  One masked step runs
    ``step(x, b) -> (x, ||b - A x||)`` (the solver's ``_step``, a cycle
    and its residual norm; passed per call, so that the loop, which the
    solver holds, holds no reference back to it) and keeps its results
    only while ``it < max_it and absres / sumb >= tol``, so a step past
    the stop changes nothing; it leaves that condition for the next step
    in ``cont``.  The host runs steps in blocks of :data:`JIT_BLOCK` and
    reads ``cont`` once per block.

    With ``graph`` (a CUDA device) the masked step is a
    :class:`~.loop_graph.StepGraph` on the loop's buffers (in ``pool``),
    captured once, and every step is one replay; otherwise the same
    masked step runs eagerly.
    """

    def __init__(self, device, dtype, pad: int, max_it: int, tol: float,
                 graph: bool, pool=None):
        self.max_it = max_it
        self.tol = tol
        kw = dict(dtype=dtype, device=device)
        self.x = torch.zeros(pad, **kw)
        self.b = torch.zeros(pad, **kw)
        self.it = torch.zeros((), dtype=torch.int32, device=device)
        self.absres = torch.zeros((), **kw)
        self.sumb = torch.zeros((), **kw)
        self.hist = torch.full((max_it + 1,), float("nan"), **kw)
        self.cont = torch.zeros((), dtype=torch.bool, device=device)
        self.step_graph = StepGraph(self.state, 0, pool) if graph else None
        self.blocks = 0             # of the last run
        self.host_reads = 0         # of the last run

    @property
    def state(self):
        return (self.x, self.b, self.it, self.absres, self.sumb, self.hist,
                self.cont)

    @property
    def graph(self):
        """The captured ``torch.cuda.CUDAGraph`` (None before the first
        run, and on the eager route)."""
        return self.step_graph.graph if self.step_graph else None

    @property
    def per_step(self):
        """Kernel launches of one replay."""
        return self.step_graph.per_step

    @property
    def capture_seconds(self) -> float:
        return self.step_graph.build_seconds if self.step_graph else 0.0

    def _go_on(self, it, absres, sumb):
        return (it < self.max_it) & (absres / sumb >= self.tol)

    def masked_step(self, step, x, b, it, absres, sumb, hist, cont):
        """One step on the state tensors given, in place."""
        active = self._go_on(it, absres, sumb)
        x_new, r = step(x, b)
        x.copy_(torch.where(active, x_new, x))
        absres.copy_(torch.where(active, r, absres))
        at = (it.long() + 1).clamp_(max=self.max_it).reshape(1)
        hist.index_put_((at,), torch.where(active, r, hist.index_select(
            0, at)[0]).reshape(1))
        it.add_(active.to(it.dtype))
        cont.copy_(self._go_on(it, absres, sumb))

    def load(self, xd, bd):
        """Start a solve from ``xd`` with right-hand side ``bd``."""
        self.x.copy_(xd)
        self.b.copy_(bd)
        self.sumb.copy_(norm2(self.b))
        self.it.zero_()
        self.absres.copy_(self.sumb)
        self.hist.fill_(float("nan"))
        self.hist[:1].copy_(self.sumb.reshape(1))
        self.cont.copy_(self._go_on(self.it, self.absres, self.sumb))

    def run(self, step):
        """Blocks of :data:`JIT_BLOCK` steps until the stop condition,
        one host read of ``cont`` before each block."""
        def masked(*state):
            self.masked_step(step, *state)

        self.blocks = self.host_reads = 0
        for _ in range(-(-self.max_it // JIT_BLOCK) + 1):
            self.host_reads += 1
            with tracing.span("amg.read"):
                cont = bool(self.cont)
            if not cont:
                break
            for _ in range(JIT_BLOCK):
                if self.step_graph is not None:
                    self.step_graph.run(masked, *self.state)
                else:
                    masked(*self.state)
            self.blocks += 1


class AMGSolver(EntryFrame):
    """Setup once, solve many times, on one ``device`` (default the CUDA
    card; pass ``device="cpu"`` for the CPU).

    ``host_hierarchy`` takes a pre-built host hierarchy, e.g. one built by
    ``amg_tpu`` and carried over with ``amg_tpu_torch.io.load_hierarchy``.
    The entries' staging, step pieces and host loop of cycles are the
    entry frame's (:class:`~.entry.EntryFrame`).
    """

    def __init__(self, a: CSR, pars: AMGParams = AMGParams(), log=print,
                 host_hierarchy=None, device="cuda"):
        if a.n_rows != a.n_cols:
            raise ValueError("AMG requires a square matrix")
        if a.nnz <= 0:
            raise ValueError("matrix has no nonzeros")
        if pars.accel not in ("none", "cg", "gmres"):
            raise ValueError(f"accel={pars.accel!r}: 'none', 'cg' (flexible "
                             "CG) or 'gmres'")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the dense levels and the coarse-inverse apply are matmuls;
            # TF32 would cost an f32 cycle about four digits
            torch.backends.cuda.matmul.allow_tf32 = False
        self.a = a
        self.pars = pars
        self.log = log
        self.mg, self.host_hierarchy = setup(a, pars, log=log,
                                             hh=host_hierarchy,
                                             device=self.device)
        self.pad = self.mg.levels[0].pad
        self.dtype = torch_dtype(pars.dtype)
        # level 0 may be RCM-ordered for the WEll format: the staging
        # permutes b/x0 on entry and the solution back on exit
        self.staging = Staging(a.n_rows, self.pad, self.device,
                               level0_perm(self.host_hierarchy))

        # -- mixed-precision defect correction: the f64 level-0 operator
        self.a0_hi = None
        if pars.refine and self.dtype != torch.float64:
            with tracing.span("amg.setup.refine_op"):
                self._make_a0_hi()
        # the step graphs of solve, solve_refined, solve_pcg and
        # solve_batched, each made on its entry's first call
        self.steps = StepGraphs(self.device)
        # solve_jit's loop, made on its first call
        self.jit_loop = None
        self._jit_key = None
        # solve_pgmres's loop and, on the card, its graph (built on the
        # first call, counted in pgmres_builds)
        self.pgmres_loop = self.pgmres_graph = None
        self._pgmres_key = None
        self.pgmres_builds = 0

    def _make_a0_hi(self):
        """The f64 level-0 operator of defect correction, on the internal
        (possibly level-0-permuted) operator: device vectors live in that
        ordering, so the f64 operator must too."""
        a_int = self.host_hierarchy.a[0]
        fmt = _pick_format(a_int, self.pars)
        kw = dict(dtype=torch.float64, pad_rows_to=self.pad,
                  device=self.device)
        if fmt == "dia":
            self.a0_hi = Dia.from_csr(a_int, **kw)
        elif fmt == "dense":
            self.a0_hi = Dense.from_csr(a_int, pad_cols_to=self.pad, **kw)
        elif fmt == "well":
            # two f32 planes whose sum is the f64 operator (kernel B3),
            # rows grouped by level 0's GS classes as level 0's are
            self.a0_hi = WEll.from_csr_df64(
                a_int, pad_rows_to=self.pad, pad_cols_to=self.pad,
                device=self.device, classes=self.mg.levels[0].gid)
            self._share_level0_plane()
        else:
            self.a0_hi = Ell.from_csr(a_int, **kw)

    def _share_level0_plane(self):
        """The df64 hi plane IS the f32 pack of level 0 (same packer, same
        slots, the same f64 -> f32 rounding): the cycle's level-0 operator
        takes it over, with the df64 operator's row-slice structure and hi
        plane, so level 0 sits on the card once, not twice."""
        w0 = self.mg.levels[0].a
        hi = self.a0_hi
        if isinstance(w0, WEll) and w0.vals.dtype == hi.vals.dtype \
                and w0.vals.shape == hi.vals.shape \
                and w0.rows.segments == hi.rows.segments:
            shared = WEll(hi.vals, hi.loc, hi.base, w0.shape, w0.nnz,
                          w0.pad_cols,
                          rows=dataclasses.replace(hi.rows, vals_lo=None))
            lv0 = dataclasses.replace(self.mg.levels[0], a=shared)
            self.mg = dataclasses.replace(
                self.mg, levels=(lv0,) + self.mg.levels[1:])

    # -- the frame's placement: the cycle and the level-0 product ---------

    def _cycle(self, x, b):
        return cycle(self.mg, x, b, self.pars)

    def _spmv(self, a, x):
        return spmv(a, x)[..., : x.shape[-1]]

    # -- entries -----------------------------------------------------------

    def solve(self, b, x0=None, eager=False) -> tuple[np.ndarray, SolveInfo]:
        """Host-loop solve with live residual table (reference parity).

        Each step (a cycle and its residual norm) is one replay of the
        step's CUDA graph on the card, built on the first call and
        replayed by later calls with the same ``pars`` and shapes; on the
        CPU it runs eagerly on the same static buffers; ``eager`` runs it
        as it is, on fresh tensors.  The three routes give the same
        iterations, residuals and x bit for bit."""
        if self.pars.accel == "cg":
            return self.solve_pcg(b, x0, eager)
        if self.pars.accel == "gmres":
            return self.solve_pgmres(b, x0)
        if self.a0_hi is not None:
            return self.solve_refined(b, x0, eager)
        return self._entry(b, x0, self.dtype, self._cycles, False, eager)

    def solve_refined(self, b, x0=None, eager=False
                      ) -> tuple[np.ndarray, SolveInfo]:
        """Mixed-precision defect correction: k low-precision cycles per
        f64 residual update, iterated until the f64 relative residual
        meets ``tol``.  ``info.nits`` counts cycles for comparability with
        :meth:`solve`.  Each outer step is a step graph on the card (see
        :meth:`solve`; ``eager`` as there)."""
        return self._entry(b, x0, torch.float64, self._cycles, True, eager)

    def solve_pcg(self, b, x0=None, eager=False
                  ) -> tuple[np.ndarray, SolveInfo]:
        """AMG-preconditioned flexible CG (``pars.accel == "cg"``).

        Each iteration applies one AMG cycle (in ``pars.dtype``) as the
        preconditioner inside an FCG iteration running in f64 when
        ``pars.refine`` is set (mixed precision), else in ``pars.dtype``.
        ``info.nits`` counts FCG iterations (= cycles).  The FCG step, the
        residual replacement and the true residual norm are step graphs
        on the card (:func:`~.entry.fcg_host_loop`; ``eager`` as in
        :meth:`solve`).
        """
        return self._entry(b, x0, self._accel_dtype, self._fcg, eager)

    def solve_pgmres(self, b, x0=None, host_loops=False
                     ) -> tuple[np.ndarray, SolveInfo]:
        """AMG-right-preconditioned restarted GMRES (``pars.accel ==
        "gmres"``), the Krylov wrap for nonsymmetric operators where CG's
        short recurrence does not apply (``amg_tpu``'s ``solve_pgmres``).

        One AMG cycle (in ``pars.dtype``) preconditions each Arnoldi step
        of GMRES(``min(MAX_RESTART, max_it)``), which runs in f64 when
        ``pars.refine`` is set, else in ``pars.dtype``.  The whole GMRES
        is one program of device loops (:class:`~.krylov.GMRESLoop`: a
        while loop over restarts, each a while loop over Arnoldi steps
        that index the basis through a device step counter), which stops
        a restart at the step where the residual estimate passes ``tol``.
        On the card it is one CUDA graph (``pgmres_graph``), built on the
        first call and replayed by later calls with the same device,
        dtype, pad, ``max_it``, ``tol`` and restart, with no host read
        from its start to its end; a KRYLOV coarsest solve inside the
        cycle adds its own while and if nodes to the step.  On the CPU,
        and on the card with ``host_loops``, the host runs the same
        program (one read per loop test).  ``info.nits`` counts the
        Arnoldi steps (= cycles); ``info.ares``/``rres`` are the true
        residual ``b - A x`` of the returned solution.  As in ``amg_tpu``
        the stop is taken on the Givens estimate, so an f32 cycle can
        stop short of ``tol`` in the true residual.
        """
        return self._entry(b, x0, self._accel_dtype, self._gmres,
                           host_loops, header=False)

    def _gmres(self, bd, xd, sumb, info, host_loops):
        """:meth:`solve_pgmres`'s device loops and their final reads."""
        pars = self.pars
        restart = min(MAX_RESTART, pars.max_it)
        key = (self.device, bd.dtype, self.pad, pars.max_it, pars.tol,
               restart)
        if self.pgmres_loop is None or self._pgmres_key != key:
            # the loop reaches the solver through a weak reference: the
            # solver holds the loop
            solver = weakref.ref(self)
            self.pgmres_loop = GMRESLoop(
                lambda v: solver()._amul(v), bd, pars.tol, pars.max_it,
                restart, M=lambda r: solver()._prec(r))
            self.pgmres_graph, self._pgmres_key = None, key
        loop = self.pgmres_loop
        loop.b.copy_(bd)
        loop.x0.copy_(xd)
        if self.device.type == "cuda" and not host_loops:
            if self.pgmres_graph is None:
                graph = LoopGraph(loop.program, self.device,
                                  restore=(loop.work,))
                graph.build()
                self.pgmres_graph = graph
                self.pgmres_builds += 1
                if pars.verbose:
                    self.log(f"AMG-GMRES graph: {graph.nodes} nodes, "
                             f"{len(graph.direct)} segment(s) captured in "
                             f"place, built in {graph.build_seconds:g} s")
            self.pgmres_graph.launch()
        else:
            run_plain(loop.program, krylov._read)
        xd = loop.x
        with tracing.span("amg.read"):
            info.nits = int(loop.it)
        settle()
        with tracing.span("amg.read"):
            info.ares = float(self._norm(bd - self._amul(xd)))
        info.rres = info.ares / sumb
        if pars.verbose:
            self.log(f"AMG-GMRES: {info.nits} its, relres {info.rres:g}")
        return xd

    @tracing.spanned("amg.solve")
    def solve_batched(self, bs, x0s=None, tol=None, eager=False
                      ) -> tuple[np.ndarray, SolveInfo]:
        """Solve ``A X = B`` for many right-hand sides with ONE hierarchy
        (``amg_tpu.solve.driver.AMGSolver.solve_batched``).

        ``bs``: ``(n, k)`` columns, on the device as one ``(k, pad)`` batch
        in ``pars.dtype``, so every cycle runs once for all k systems and
        each Dia product streams its values once (kernel B4).  One host
        fetch per iteration: the per-column residual norms.  Iterates until
        EVERY column's ``||r|| / ||b||`` is below ``tol`` (default
        ``pars.tol``), ``max_it``, or a non-finite residual.  No defect
        correction and no Krylov wrap (``pars.refine``/``accel`` are
        ignored, as in ``amg_tpu``).  Returns ``(X (n, k), SolveInfo)``
        with ``info.residuals`` the per-iteration worst column and
        ``info.rres``/``ares`` the worst column at the end.  Each
        iteration is a step graph on the card (see :meth:`solve`; ``eager``
        as there), made anew for another k.
        """
        pars = self.pars
        tol = pars.tol if tol is None else tol
        bs = np.asarray(bs)
        if bs.ndim != 2:
            raise ValueError("bs must be (n, k)")
        k = bs.shape[1]
        if x0s is not None and (np.ndim(x0s) != 2 or np.shape(x0s)[1] != k):
            raise ValueError("x0s must be (n, k) like bs")
        bd, xd = self._stage(bs, x0s, self.dtype)

        info = SolveInfo()
        # ||b_c|| in pars.dtype, as amg_tpu takes it from the cast columns
        with tracing.span("amg.read"):
            sumb = np.maximum(self._norm(bd).reshape(k).cpu().numpy()
                              .astype(np.float64), 1e-300)
        t0 = time.perf_counter()
        nits = 0
        step = self.steps.step("batched", self._step, 1, pars, eager)
        for it in range(1, pars.max_it + 1):
            xd, res_d = step(xd, bd)
            with tracing.span("amg.read"):
                res = res_d.reshape(k).cpu().numpy().astype(np.float64)
            rel = res / sumb
            nits = it
            info.residuals.append(float(res.max()))
            if not np.all(np.isfinite(res)):
                if pars.verbose:
                    self.log("### WARNING: batched residual diverged; "
                             "stopping.")
                break
            if float(rel.max()) < tol:
                break
        info.nits = nits
        info.ares = float(res.max())
        info.rres = float(rel.max())
        if pars.verbose:
            self.log(f"AMG batched solve: k={k}, {nits} its, worst "
                     f"relres {info.rres:g}")
        return self._close(xd, info, t0)

    @tracing.spanned("amg.solve")
    def solve_jit(self, b, x0=None) -> tuple[np.ndarray, SolveInfo]:
        """The solve with its loop on the device (``amg_tpu``'s
        ``solve_jit``, ``amg_tpu/solve/driver.py:621-641``): cycles while
        ``it < max_it`` and ``||r|| / ||b|| >= tol``, no host read per
        iteration, no defect correction or Krylov acceleration and no stop
        type but the relative residual, whatever ``pars`` say.
        ``info.residuals`` is ``||b||`` and then each cycle's residual.

        On the card the masked step is a CUDA graph, captured on the first
        call and replayed by every later one (:class:`JitLoop`), in the
        pool of the solver's step graphs; a KRYLOV coarsest solve is its
        own graph of while and if nodes, added to the step's.  On the CPU
        the loop runs eagerly."""
        pars = self.pars
        key = (self.device, self.dtype, self.pad, pars.max_it, pars.tol)
        loop = self.jit_loop
        if loop is None or self._jit_key != key:
            loop = JitLoop(self.device, self.dtype, self.pad, pars.max_it,
                           pars.tol, self.device.type == "cuda",
                           self.steps.memory_pool())
            self.jit_loop, self._jit_key = loop, key
        bd, xd = self._stage(b, x0, self.dtype)
        t0 = time.perf_counter()
        loop.load(xd, bd)
        loop.run(self._step)
        info = SolveInfo()
        with tracing.span("amg.read"):   # the loop's final state
            info.nits = int(loop.it)
            info.ares = float(loop.absres)
            sumb = float(loop.sumb)
            h = loop.hist.cpu().numpy()
        info.rres = info.ares / max(sumb, 1e-300)
        info.residuals = [float(v) for v in h[~np.isnan(h)]]
        return self._close(loop.x, info, t0)


def solver_amg(a: CSR, x, b, pars: AMGParams = AMGParams(), log=print,
               device="cuda"):
    """One-shot functional API mirroring ``SSS_solver_amg`` (amg/SSS_AMG.c:9).

    Returns ``(x, SolveInfo)``.
    """
    # zero-rhs short circuit before any setup (amg/SSS_AMG.c:23-30)
    sumb = float(np.linalg.norm(np.asarray(b, dtype=np.float64)))
    if sumb == 0.0:
        if pars.verbose:
            print_itinfo(StopType.REL_RES, 0, 0.0, sumb, 0.0, log=log)
        return np.zeros(a.n_rows), SolveInfo()
    t0 = time.perf_counter()
    solver = AMGSolver(a, pars, log=log, device=device)
    x, info = solver.solve(b, x0=x)
    if pars.verbose:
        log(f"AMG totally time: {time.perf_counter() - t0:g} s")
    return x, info
