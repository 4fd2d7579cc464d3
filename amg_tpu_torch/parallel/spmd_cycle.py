"""The SPMD V-cycle on a ring of row shards, and its solver.

Port of ``amg_tpu/parallel/spmd_cycle.py``, both of its modes.  The
embedded mode, for a fine-grid-embedded hierarchy, where every hot
operator is a Dia stencil over level 0's index space:

* levels ``0..E`` are row-sharded (:mod:`.dist`); every operator
  application is the ring product of :mod:`.halo` (B1's window entry);
* the embedded -> compact boundary gathers the residual's entries at
  their global positions (each from the one shard that holds it) and
  ``psum`` s them, so the compact vector is exact and the same on every
  process; the correction scatters back the same way;
* compact levels ``> E`` are replicated: each process runs the
  single-device cycle (``solve/cycle.py``) on them;
* dots and norms ``psum`` over the mesh.

The general mode (``:328-445``), for a hierarchy without embedding (an
unstructured one): levels ``0..Es`` (:func:`general_shard_depth`) are
row-sharded WEll, Dia or BandedBlocks levels whose products, P and R
included, are ring products (B2's window entry on WEll, the batched
cuBLAS product on BandedBlocks); below ``Es`` the tail is replicated.  At
level ``Es`` the coarse vector becomes replicated through one of two
boundaries, decided once at setup from the operators
(:func:`ring_boundary`):

* **ring R** (R a WEll operator with a ring plan, P a WEll operator): R's
  ring product, one ``all_gather`` of the small coarse vector, and P's
  rows against the whole coarse correction (``well_spmv_local_full``);
* **all-gather**: the fine residual is all-gathered, the replicated R and
  P (Ell, Dense or WEll) run on whole vectors, and each process keeps its
  rows of the correction.

FCG runs in f64 against the groups-sharded df64 WEll operator (B3's
window entry).

The GSPMD solver (:class:`~.dist.DistAMGSolver`) runs the general cycle
with its own product (:func:`gspmd_spmv`: all-gather products on WEll, Ell
and Dense) and its boundary always sharded: level ``Es``'s R and P
row-sharded, R's coarse rows all-gathered, P's rows against the whole
coarse correction (:func:`~.halo.spmv_local_full`).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import tracing
from ..hierarchy import Hierarchy, setup
from ..params import AMGParams, SmootherType
from ..sparse import BandedBlocks, Dia, WEll, torch_dtype
from ..ops.spmv import spmv
from ..solve.cycle import _cycle_level
from ..solve.entry import EntryFrame, level0_perm
from ..solve.loop_graph import StepGraphs
from ..solve.smoothers import _order, _cg_smooth
from .dist import (Mesh, RowStaging, local_rows, make_mesh, shard_dia,
                   shard_hierarchy)
from .halo import (banded_spmv_ring_local, dia_spmv_ring_local,
                   spmv_gather_local, spmv_local_full, well_spmv_ring_local)


def num_embedded(mg: Hierarchy) -> int:
    """Deepest fine-grid-embedded level: the one carrying the boundary
    (``compact_idx`` / ``member_idx``); 0 when the hierarchy is compact."""
    for l, lvl in enumerate(mg.levels):
        if lvl.compact_idx is not None or lvl.member_idx is not None:
            return l
    return 0


# ---------------------------------------------------------------------------
# Per-shard building blocks: (S, m) blocks of row-sharded vectors
# ---------------------------------------------------------------------------


def _ring_spmv(a, x, mesh: Mesh):
    """The ring product of a row-sharded operator, by format
    (``spmd_cycle.py:125-142``); a df64 WEll operator with an f64 ``x``
    takes B3's window entry."""
    if isinstance(a, Dia):
        return dia_spmv_ring_local(a, x, mesh)
    if isinstance(a, WEll):
        return well_spmv_ring_local(a, x, mesh)
    if isinstance(a, BandedBlocks):
        return banded_spmv_ring_local(a, x, mesh)
    raise TypeError(f"no ring product for {type(a).__name__}")


def gspmd_spmv(a, x, mesh: Mesh):
    """The product of a row-sharded operator where ``amg_tpu``'s GSPMD
    solver leaves the communication to XLA (``dist.py:93-101``): halo
    exchanges on Dia and BandedBlocks (the ring products), an all-gather of
    x on WEll, Ell and Dense (:func:`~.halo.spmv_gather_local`)."""
    if isinstance(a, (Dia, BandedBlocks)):
        return _ring_spmv(a, x, mesh)
    return spmv_gather_local(a, x, mesh)


def _chebyshev_local(level, x, b, degree, mesh, spmv_fn=_ring_spmv):
    """Chebyshev smoothing with ring products (the math of
    ``solve/smoothers.py::_chebyshev``)."""
    rho = level.rho_dinv_a
    theta = 0.5 * (rho + rho / 4.0)
    delta = 0.5 * (rho - rho / 4.0)
    sigma = theta / delta
    rho_old = 1.0 / sigma

    r = level.inv_diag * (b - spmv_fn(level.a, x, mesh))
    d = r / theta
    x = x + d
    for _ in range(max(degree - 1, 0)):
        rho_new = 1.0 / (2.0 * sigma - rho_old)
        r = level.inv_diag * (b - spmv_fn(level.a, x, mesh))
        d = rho_new * rho_old * d + 2.0 * rho_new / delta * r
        x = x + d
        rho_old = rho_new
    return x


def _gs_sweep_local(level, x, b, order, mesh, relax=None,
                    spmv_fn=_ring_spmv):
    """One masked GS sweep over colour groups with ring products
    (``spmd_cycle.py:167-177``): per group a ring product, then the group's
    rows take the exact GS value."""
    for g in order:
        ax = spmv_fn(level.a, x, mesh)
        t = (b - ax + level.diag * x) * level.inv_diag
        if relax is not None:
            t = (1.0 - relax) * x + relax * t
        upd = (level.gid == g) & (level.inv_diag != 0)
        x = torch.where(upd, t, x)
    return x


def _smooth_local(level, x, b, pars, nsweeps, pre, mesh, spmv_fn=_ring_spmv):
    """The whole ``SmootherType`` surface of ``solve/smoothers.py::smooth``
    on a row-sharded level: every operator application ``spmv_fn`` (the
    ring product; the GSPMD solver's :func:`gspmd_spmv`), every dot a
    ``psum``."""
    sm = pars.smoother
    if sm in (SmootherType.POLY, SmootherType.CHEBYSHEV):
        return _chebyshev_local(level, x, b, pars.poly_deg, mesh, spmv_fn)
    if sm == SmootherType.CG:
        return _cg_smooth(level, x, b, nsweeps, psum=mesh.psum,
                          spmv_fn=lambda v: spmv_fn(level.a, v, mesh))
    if sm in (SmootherType.JACOBI, SmootherType.WJACOBI):
        w = 1.0 if sm == SmootherType.JACOBI else pars.relax
        for _ in range(nsweeps):
            x = x + w * level.inv_diag * (b - spmv_fn(level.a, x, mesh))
        return x
    if sm == SmootherType.L1DIAG:
        for _ in range(nsweeps):
            x = x + level.l1_inv * (b - spmv_fn(level.a, x, mesh))
        return x

    relax = pars.relax

    def sweep(x, order, rlx=None):
        return _gs_sweep_local(level, x, b, order, mesh, relax=rlx,
                               spmv_fn=spmv_fn)

    fwd = _order(level, True, 0, True)
    bwd = _order(level, False, 0, False)
    own = _order(level, pre, pars.cf_order, pre)
    for _ in range(nsweeps):
        if sm == SmootherType.GS:
            x = sweep(x, own)
        elif sm == SmootherType.SOR:
            x = sweep(x, own, relax)
        elif sm == SmootherType.SGS:
            x = sweep(sweep(x, fwd), bwd)
        elif sm == SmootherType.SSOR:
            x = sweep(sweep(x, fwd, relax), bwd, relax)
        elif sm == SmootherType.GSOR:
            x = sweep(sweep(x, own), own, relax)
        elif sm == SmootherType.SGSOR:
            x = sweep(sweep(x, fwd), bwd)
            x = sweep(sweep(x, fwd, relax), bwd, relax)
        else:
            raise ValueError(f"unsupported smoother {sm}")
    return x


def _owned(idx, x, mesh):
    """(positions in this process's flattened block, mask) of the global
    positions ``idx``: the mask marks those this process holds; the
    others are clamped into range and masked out."""
    n_local = x.shape[0] * x.shape[1]
    loc = idx - mesh.first * x.shape[1]
    inr = (loc >= 0) & (loc < n_local)
    return loc.clamp(0, n_local - 1), inr


def _gather_global(v, idx, mesh):
    """``v[idx]`` of a row-sharded ``v`` at global positions ``idx``, on
    every process: each entry from the shard that holds it, zeros from the
    others, summed over the mesh (one owner each, so exact)."""
    loc, inr = _owned(idx, v, mesh)
    part = torch.where(inr, v.reshape(-1)[loc], torch.zeros((), dtype=v.dtype,
                                                           device=v.device))
    return mesh.psum(part[None])


def _scatter_add_global(x, idx, src, mesh):
    """``x`` with ``src`` added at the global positions ``idx`` it holds."""
    loc, inr = _owned(idx, x, mesh)
    add = torch.where(inr, src.to(x.dtype), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
    return x.reshape(-1).index_add(0, loc, add).reshape(x.shape)


def _cycle_local(mg, l, x, b, pars, ctol, E, mesh):
    """One V/W-cycle on the sharded embedded levels, the replicated
    compact recursion below the boundary (``spmd_cycle.py:234-310``, in the
    order of the single-device ``solve/cycle.py``)."""
    level = mg.levels[l]
    repeats = 1 if l == 0 else max(pars.cycle_type, 1)
    pars_l = pars if (l == 0 or pars.coarse_smoother is None) \
        else pars.replace(smoother=pars.coarse_smoother)
    if pars.poly_deg_schedule is not None:
        sched = pars.poly_deg_schedule
        pars_l = pars_l.replace(poly_deg=sched[min(l, len(sched) - 1)])

    for _ in range(repeats):
        x = _smooth_local(level, x, b, pars_l, pars.pre_iter, True, mesh)
        r = b - _ring_spmv(level.a, x, mesh)
        if l < E:
            bc = _ring_spmv(level.r, r, mesh)
            xc = _cycle_local(mg, l + 1, torch.zeros_like(bc), bc, pars,
                              ctol, E, mesh)
            x = x + _ring_spmv(level.p, xc, mesh)
        elif level.member_idx is not None:
            # compact boundary: this level's rows gathered from their
            # embedded positions, the compact Ell R, the replicated
            # correction, the compact P, added back at the same positions
            midx = level.member_idx
            rc = r.new_zeros(level.p.padded_rows)
            rc[: midx.shape[0]] = _gather_global(r, midx, mesh)
            bc = spmv(level.r, rc)
            xc = _cycle_level(mg, l + 1, torch.zeros_like(bc), bc, pars,
                              ctol)
            xe = spmv(level.p, xc)[: midx.shape[0]]
            x = _scatter_add_global(x, midx, xe, mesh)
        else:
            # embedded boundary: the embedded R, the next level's rows
            # gathered from their embedded positions, the replicated
            # correction scattered back, the embedded P
            cidx = level.compact_idx
            rr = _ring_spmv(level.r, r, mesh)
            bc = rr.new_zeros(mg.levels[l + 1].pad)
            bc[: cidx.shape[0]] = _gather_global(rr, cidx, mesh)
            xc = _cycle_level(mg, l + 1, torch.zeros_like(bc), bc, pars,
                              ctol)
            xe = _scatter_add_global(torch.zeros_like(x), cidx,
                                     xc[: cidx.shape[0]], mesh)
            x = x + _ring_spmv(level.p, xe, mesh)
        x = _smooth_local(level, x, b, pars_l, pars.post_iter, False, mesh)
    return x


def cycle_spmd(mg, x, b, pars, E, mesh):
    """One cycle on the sharded level-0 block ``(S, m)``."""
    if E < 1:
        raise ValueError("the SPMD cycle needs an embedded hierarchy "
                         "(E >= 1)")
    ctol = min(pars.ctol, pars.tol * 0.1) if pars.ctol > pars.tol \
        else pars.ctol
    return _cycle_local(mg, 0, x, b, pars, ctol, E, mesh)


# ---------------------------------------------------------------------------
# General mode: unstructured hierarchies without embedding
# ---------------------------------------------------------------------------


def _ring_capable(m, ndev: int) -> bool:
    """Can this operator be row-sharded for the ring product?
    (``spmd_cycle.py:408-418``)"""
    if isinstance(m, Dia):
        return m.vals.shape[1] % ndev == 0
    if isinstance(m, WEll):
        return m.ring_plan is not None
    if isinstance(m, BandedBlocks):
        return m.vals.shape[0] % ndev == 0
    return False


def general_shard_depth(mg: Hierarchy, ndev: int) -> int:
    """Longest sharded prefix ``0..Es`` of the general cycle, or -1 when
    level 0 cannot shard (``spmd_cycle.py:421-439``): interior levels need
    WEll P and R with ring plans and a ring-capable next A; the boundary
    level needs a ring-capable A (its transfers may take the all-gather
    boundary)."""
    nl = mg.num_levels
    if nl < 2 or not _ring_capable(mg.levels[0].a, ndev):
        return -1
    Es = 0
    while Es < nl - 2:
        lvl = mg.levels[Es]
        if (isinstance(lvl.p, WEll) and lvl.p.ring_plan is not None
                and isinstance(lvl.r, WEll) and lvl.r.ring_plan is not None
                and _ring_capable(mg.levels[Es + 1].a, ndev)):
            Es += 1
        else:
            break
    return Es


def ring_boundary(level) -> bool:
    """The boundary of the general cycle at ``level`` (level ``Es``): True
    for the ring-R boundary (R a WEll operator with a ring plan, P a WEll
    operator), False for the all-gather one (``spmd_cycle.py:656-658``).
    ``amg_tpu`` infers it inside shard_map from local shapes
    (``_transfer_sharded``, ``:337-343``); here it is decided once, from
    the operators every process packed alike."""
    return (isinstance(level.r, WEll) and level.r.ring_plan is not None
            and isinstance(level.p, WEll))


def _cycle_general(mg, l, x, b, pars, ctol, Es, ring_r, mesh,
                   spmv_fn=_ring_spmv):
    """One V/W-cycle on the sharded levels ``0..Es``, the replicated
    recursion below the boundary (``spmd_cycle.py:346-399``).  ``ring_r``:
    level ``Es``'s R and P are row-sharded (the ring-R boundary, and every
    GSPMD boundary), else replicated (the all-gather boundary); every
    product on a sharded level is ``spmv_fn``."""
    level = mg.levels[l]
    repeats = 1 if l == 0 else max(pars.cycle_type, 1)
    pars_l = pars if (l == 0 or pars.coarse_smoother is None) \
        else pars.replace(smoother=pars.coarse_smoother)
    if pars.poly_deg_schedule is not None:
        sched = pars.poly_deg_schedule
        pars_l = pars_l.replace(poly_deg=sched[min(l, len(sched) - 1)])

    for _ in range(repeats):
        x = _smooth_local(level, x, b, pars_l, pars.pre_iter, True, mesh,
                          spmv_fn)
        r = b - spmv_fn(level.a, x, mesh)
        if l < Es:
            bc = spmv_fn(level.r, r, mesh)
            xc = _cycle_general(mg, l + 1, torch.zeros_like(bc), bc, pars,
                                ctol, Es, ring_r, mesh, spmv_fn)
            x = x + spmv_fn(level.p, xc, mesh)
        else:
            coarse = mg.levels[l + 1]
            if ring_r:
                # R's sharded product, then the small coarse vector gathered
                bc = mesh.all_gather(spmv_fn(level.r, r, mesh))
            else:
                # the fine residual gathered, the replicated R applied
                bc = spmv(level.r, mesh.all_gather(r).reshape(-1))
            bc = bc.reshape(-1)[: coarse.pad]
            bc = torch.where(torch.arange(bc.shape[0], device=bc.device)
                             < coarse.n, bc, torch.zeros_like(bc))
            xc = _cycle_level(mg, l + 1, torch.zeros_like(bc), bc, pars,
                              ctol)
            if ring_r:
                xe = spmv_local_full(level.p, xc, mesh).view(x.shape)
            else:
                xe = local_rows(spmv(level.p, xc)[: x.numel()
                                                  * mesh.world], mesh)
            x = x + xe.to(x.dtype)
        x = _smooth_local(level, x, b, pars_l, pars.post_iter, False, mesh,
                          spmv_fn)
    return x


def cycle_general(mg, x, b, pars, Es, ring_r, mesh, spmv_fn=_ring_spmv):
    """One general-mode cycle on the sharded level-0 block ``(S, m)``."""
    ctol = min(pars.ctol, pars.tol * 0.1) if pars.ctol > pars.tol \
        else pars.ctol
    return _cycle_general(mg, 0, x, b, pars, ctol, Es, ring_r, mesh, spmv_fn)


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


class SpmdAMGSolver(EntryFrame):
    """AMG on a ring of row shards (``amg_tpu``'s ``SpmdAMGSolver``).

    Setup runs on the host as for :class:`~amg_tpu_torch.AMGSolver`, with
    ``dist_devices`` set to the mesh's shard count (pads that split into
    the shards, WEll ring plans, "auto" formats on) and ``embed_levels`` 8
    where it is "auto" (-1).  An embedded hierarchy (``E >= 1``) runs the
    embedded mode, levels ``0..E`` row-sharded; one without embedding the
    general mode, levels ``0..Es`` row-sharded (``Es`` from
    :func:`general_shard_depth`; ``ValueError`` when level 0 cannot be
    sharded).  The rest is replicated.  The sharding of the packed
    hierarchy and of the f64 level-0 operator is one ``amg.setup.shard``
    span.  The mesh defaults to one shard per process on the card; pass
    ``mesh=make_mesh(D, device="cpu")`` for the CPU.

    The route of the steps (``steps``) is fixed by the mesh's device and
    its group's backend (:class:`~amg_tpu_torch.solve.loop_graph.
    StepGraphs`): on the card each cycle step and FCG step is a step graph
    (a CUDA graph replayed), with its psums and halos local when every
    shard sits in this process, and NCCL's ``all_reduce``, all-gather and
    halo messages captured in it in an NCCL group; on the CPU the steps
    run on static buffers; a gloo group on the card runs them eagerly.
    The entries are the entry frame's (:class:`~amg_tpu_torch.solve.
    entry.EntryFrame`), with the row form of its staging
    (:class:`~.dist.RowStaging`).
    """

    _ring_loop = True

    def __init__(self, a, pars: AMGParams = AMGParams(),
                 mesh: Mesh | None = None, log=print):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.ndev = self.mesh.n_shards
        self.a = a
        self.log = log
        if pars.embed_levels < 0:
            # this solver is the embedded hierarchy's distribution path
            pars = pars.replace(embed_levels=8)
        if pars.dist_devices != self.ndev:
            pars = pars.replace(dist_devices=self.ndev)
        self.pars = pars
        if self.mesh.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        mg, hh = setup(a, pars, log=log, device=self.mesh.device)
        self.host_hierarchy = hh
        self.E = num_embedded(mg)
        self.Es = -1
        self.ring_r = None
        if self.E == 0:
            self.Es = general_shard_depth(mg, self.ndev)
            if self.Es < 0:
                raise ValueError(
                    "SpmdAMGSolver requires either a fine-grid-embedded "
                    "hierarchy or a ring-capable (WEll/Dia/BandedBlocks) "
                    "level 0; use DistAMGSolver instead")
        self.pad = mg.levels[0].pad
        if self.pad % self.ndev != 0:
            raise ValueError(f"padded rows {self.pad} not divisible by mesh "
                             f"size {self.ndev}")
        self.m_local = self.pad // self.ndev
        # level 0 may be RCM-ordered (a WEll level 0): b/x0 map in, x back
        self.staging = RowStaging(a.n_rows, self.pad, self.mesh,
                                  level0_perm(hh))
        self._psum = self.mesh.psum
        self.dtype = torch_dtype(pars.dtype)
        hi = pars.accel == "cg" and pars.refine \
            and self.dtype != torch.float64
        self.a0_hi = None
        with tracing.span("amg.setup.shard"):
            if self.E == 0:
                self._init_general(mg, hh, hi)
            else:
                self.mg = shard_hierarchy(mg, self.mesh, pars,
                                          replicate_from_level=self.E + 1)
                # FCG (accel "cg"): f64 outer iteration against the exact
                # row-sharded level-0 operator when refining
                if hi:
                    self.a0_hi = shard_dia(Dia.from_csr(
                        hh.a[0], dtype=torch.float64, pad_rows_to=self.pad,
                        device=self.mesh.device), self.mesh)
        self.steps = StepGraphs(self.mesh.device, self.mesh.backend)
        if pars.verbose:
            if self.E:
                log(f"{self.mesh.describe()}; levels 0..{self.E} "
                    f"row-sharded, {self.m_local} rows per shard; steps: "
                    f"{self.steps.describe()}")
            else:
                log(f"{self.mesh.describe()}; levels 0..{self.Es} "
                    f"row-sharded (general mode, "
                    f"{'ring-R' if self.ring_r else 'all-gather'} "
                    f"boundary), {self.m_local} rows per shard; steps: "
                    f"{self.steps.describe()}")

    def _init_general(self, mg, hh, hi: bool):
        """The general mode's placement (``spmd_cycle.py:635-750``): levels
        ``0..Es`` row-sharded; at an all-gather boundary level ``Es``'s
        transfers stay replicated.  With ``hi`` FCG runs in f64 against the
        df64 WEll operator of this process's row groups (B3's window entry),
        whose row-slice structure and hi plane level 0's f32 operator shares
        where their entries agree.  Without a ring plan for it (or a level-0
        pad of whole row groups per shard) a Dia level 0 gives FCG the
        row-sharded f64 Dia (B1's window entry), as the embedded mode does;
        any other level 0 keeps FCG in the solve dtype, as ``amg_tpu``
        falls back (``:708-710``), and says so under ``verbose``."""
        Es, mesh = self.Es, self.mesh
        self.ring_r = ring_boundary(mg.levels[Es])
        sharded = shard_hierarchy(mg, mesh, self.pars,
                                  replicate_from_level=Es + 1)
        levels = list(sharded.levels)
        if not self.ring_r:
            levels[Es] = dataclasses.replace(levels[Es], p=mg.levels[Es].p,
                                             r=mg.levels[Es].r)
        D = self.ndev
        if hi and self.pad % (1024 * D) == 0:
            gps = self.pad // 1024 // D
            w_hi = WEll.from_csr_df64(
                hh.a[0], pad_rows_to=self.pad, pad_cols_to=self.pad,
                ring_devices=D, device=mesh.device,
                groups=(mesh.first * gps, (mesh.first + mesh.local) * gps))
            if w_hi.ring_plan is not None:
                self.a0_hi = w_hi
                a0 = levels[0].a
                if isinstance(a0, WEll) and a0.vals.dtype == w_hi.vals.dtype \
                        and a0.rows.nnz == w_hi.rows.nnz:
                    # the same kept entries (the f32 ones are a subset of
                    # the df64 ones): the same layout, the same hi plane
                    levels[0] = dataclasses.replace(levels[0], a=WEll(
                        w_hi.vals, w_hi.loc, w_hi.base, a0.shape, a0.nnz,
                        a0.pad_cols, rows=dataclasses.replace(
                            w_hi.rows, vals_lo=None),
                        ring_plan=a0.ring_plan))
        if hi and self.a0_hi is None:
            if isinstance(mg.levels[0].a, Dia):
                self.a0_hi = shard_dia(Dia.from_csr(
                    hh.a[0], dtype=torch.float64, pad_rows_to=self.pad,
                    device=mesh.device), mesh)
            elif self.pars.verbose:
                self.log(f"# no f64 ring operator for the "
                         f"{type(mg.levels[0].a).__name__} level 0: FCG "
                         f"runs in {self.pars.dtype}")
        self.mg = Hierarchy(levels=tuple(levels),
                            coarse_inv=sharded.coarse_inv)

    # -- the frame's placement: the cycle and the level-0 product ---------

    def _cycle(self, x, b):
        if self.E:
            return cycle_spmd(self.mg, x, b, self.pars, self.E, self.mesh)
        return cycle_general(self.mg, x, b, self.pars, self.Es, self.ring_r,
                             self.mesh)

    def _spmv(self, a, x):
        return _ring_spmv(a, x, self.mesh)

    def _shard(self, v, dtype):
        """A host vector in the caller's ordering -> this process's padded
        ``(S, m)`` block."""
        return self._pad_vec(v, dtype)

    def _unshard(self, xd):
        return self._unpad_vec(xd)

    # -- entries -----------------------------------------------------------

    def solve(self, b, x0=None, eager=False):
        """Host loop over SPMD cycles (``AMGSolver.solve``'s stopping
        rules); runs :meth:`solve_pcg` when ``pars.accel == "cg"``.
        ``eager`` runs the steps as they are on any mesh."""
        pars = self.pars
        if pars.accel == "cg":
            return self.solve_pcg(b, x0, eager)
        if pars.accel != "none":
            raise NotImplementedError(f"accel={pars.accel!r} on the SPMD "
                                      "solver (amg_tpu has none either)")
        return self._entry(b, x0, self.dtype, self._cycles, False, eager)

    def solve_pcg(self, b, x0=None, eager=False):
        """Flexible CG preconditioned by one SPMD cycle: ``psum`` dots, and
        in f64 against the row-sharded f64 level-0 operator when
        ``pars.refine`` (``amg_tpu``'s robust multi-chip mode).  ``eager``
        runs the steps as they are on any mesh."""
        return self._entry(b, x0, self._accel_dtype, self._fcg, eager)
