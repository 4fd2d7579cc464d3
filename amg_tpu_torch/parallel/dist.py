"""The ring of row shards: mesh, collectives, sharded vectors and
hierarchies, and the GSPMD solver.

Port of ``amg_tpu/parallel/dist.py``: ``make_mesh``, ``shard_vector``,
``shard_hierarchy`` (``:39-270``) and ``DistAMGSolver`` (``:273-436``),
the solver whose communication ``amg_tpu`` leaves to XLA's GSPMD
partitioner.  Here each format takes the product XLA would place for it:
the ring products of :mod:`.halo` on Dia and BandedBlocks (collective
permutes there), the all-gather product on WEll, Ell and Dense.

A :class:`Mesh` is an ordered ring of ``D`` shards.  Each process owns a
contiguous run of ``S = D / world`` of them, all on the process's device,
so a row-sharded vector of ``pad = D * m`` entries is one ``(S, m)`` tensor
per process (``amg_tpu``'s ``vmap`` over shards written out as a batch
dimension): elementwise code runs on every local shard at once.  A sharded
Dia operator keeps the values of its process's shards as one ``(nd, S*m)``
tensor, the whole ``(nd, pad)`` when one process holds every shard (no
copy), and a shard's values are a column slice of it.  A sharded WEll
operator is the block of its process's row groups (:meth:`~amg_tpu_torch.
sparse.WEll.block`: the pack a host view, the layout on the card in row
order), a sharded BandedBlocks one its process's block rows.  Replicated
levels and vectors exist once per process, and the compact tail runs once
per process: its results are the same on every shard by construction, as
on every device under ``amg_tpu``'s shard_map.

The collectives treat the local shards in the process and the remote ones
through ``torch.distributed``: :meth:`Mesh.psum` sums per-shard partials
over axis 0 and then ``all_reduce``s across processes;
:meth:`Mesh.all_gather` collects every process's shards into one tensor;
the ring's halo exchange is in :mod:`.halo`.  Neither reads the host, so
on an NCCL group they are captured into the solvers' step graphs.
``counts`` adds up the collectives; those that cross processes also go to
the span table's ``amg.ring.all_reduce`` and ``amg.ring.all_gather``
rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..hierarchy import (Hierarchy, Level, _pick_format, resolve_device,
                         setup)
from ..ops import launch_counts
from ..ops.spmv import spmv
from ..params import AMGParams
from ..solve.cycle import cycle
from ..solve.entry import EntryFrame, Staging, level0_perm
from ..solve.loop_graph import StepGraphs
from ..sparse import BandedBlocks, Dense, Dia, Ell, WEll, torch_dtype
from .multihost import fetch

# collectives over every call: psum calls, all_gather calls
counts = {"psum": 0, "all_gather": 0}
# a captured step's replays add its collectives to the counts
launch_counts.COUNTERS.append(counts)
# one tensor gathered from every process (torch 2.13 renames
# all_gather_into_tensor and deprecates the old name)
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_shards`` row shards in ring order; this process (``rank`` of
    ``world``) holds shards ``[first, first + local)`` on ``device``.
    ``group`` is the process group, None outside ``torch.distributed``;
    ``backend`` its backend (``"nccl"``, ``"gloo"``), None without one.
    The solvers' step route follows the device and the backend
    (:class:`~amg_tpu_torch.solve.loop_graph.StepGraphs`)."""

    n_shards: int
    device: torch.device
    rank: int = 0
    world: int = 1
    group: object = None
    backend: str | None = None

    def __post_init__(self):
        if (self.group is None) != (self.backend is None):
            raise ValueError("a mesh names its process group's backend, "
                             "and only with a group")

    @property
    def local(self) -> int:
        return self.n_shards // self.world

    @property
    def first(self) -> int:
        return self.rank * self.local

    def describe(self) -> str:
        procs = f"{self.world} process" + ("es" if self.world > 1 else "")
        group = "" if self.backend is None else f" ({self.backend})"
        return f"mesh: {self.n_shards} shards, {procs}, {self.device}{group}"

    def psum(self, partials: torch.Tensor) -> torch.Tensor:
        """Sum of per-shard partials ``(S, ...)`` over every shard of the
        mesh: the local ones in shard order, then across processes."""
        counts["psum"] += 1
        total = partials.sum(0)
        if self.group is not None:
            dist.all_reduce(total, group=self.group)
            if self.world > 1:
                tracing.count("amg.ring.all_reduce",
                              total.numel() * total.element_size())
        return total

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's ``(S, ...)`` shards as ``(D, ...)``, in ring
        order: one buffer that the collective writes in place."""
        counts["all_gather"] += 1
        if self.group is None:
            return x
        out = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
        _gather_into(out, x.contiguous(), group=self.group)
        if self.world > 1:
            tracing.count("amg.ring.all_gather", x.numel() * x.element_size())
        return out


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A ring of ``n_devices`` shards (default: one per process) on
    ``device``: the card (``cuda:<local rank>``) unless the caller asks
    for the CPU.  Inside a ``torch.distributed`` process group the shards
    split evenly over its processes; a count that does not split raises
    (never fewer shards than asked)."""
    device = resolve_device(device)
    world, rank, group, backend = 1, 0, None, None
    if dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), \
            dist.group.WORLD
        backend = str(dist.get_backend(group))
    n = world if n_devices is None else int(n_devices)
    if n < 1 or n % world:
        raise ValueError(f"{n} shards do not split over {world} processes")
    if device.type == "cuda" and device.index is None:
        from .multihost import local_rank

        device = torch.device("cuda", local_rank())
    return Mesh(n, device, rank, world, group, backend)


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def _pad_vec_multiple(v: torch.Tensor, multiple: int) -> torch.Tensor:
    n = v.shape[0]
    target = _round_up(n, multiple)
    if target == n:
        return v
    return torch.cat([v, v.new_zeros((target - n,) + tuple(v.shape[1:]))])


def _pad_dia_multiple(d: Dia, multiple: int) -> Dia:
    pr = d.padded_rows
    target = _round_up(pr, multiple)
    if target == pr:
        return d
    vals = torch.nn.functional.pad(d.vals, (0, target - pr))
    return Dia(vals, d.offsets, d.shape, d.nnz)


def local_rows(v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's ``(S, m)`` block of a global vector whose length
    splits into the mesh's shards (a view when one process holds them
    all); ``(S, m, ...)`` for a tensor of rows."""
    m = v.shape[0] // mesh.n_shards
    return v.view(mesh.n_shards, m, *v.shape[1:])[
        mesh.first: mesh.first + mesh.local]


def shard_vector(v, mesh: Mesh, pad_to: int | None = None,
                 dtype=None) -> torch.Tensor:
    """A global vector (numpy or torch) as this process's ``(S, m)`` block
    on the mesh's device, zero-padded to ``pad_to`` and to a multiple of
    the shard count.  Only this process's rows are read, converted and
    copied: on a ring of processes each one moves its ``1 / world`` of
    the vector, never a padded copy of all of it."""
    if not torch.is_tensor(v):
        v = np.asarray(v)
    n = v.shape[0]
    m = _round_up(max(n, pad_to or 0), mesh.n_shards) // mesh.n_shards
    lo = mesh.first * m
    hi = lo + mesh.local * m
    v = torch.as_tensor(v[lo:min(hi, n)])
    if dtype is not None:
        v = v.to(dtype)
    if v.shape[0] < hi - lo:
        v = torch.cat([v, v.new_zeros((hi - lo - v.shape[0],)
                                      + tuple(v.shape[1:]))])
    return v.view(mesh.local, m, *v.shape[1:]).to(mesh.device).contiguous()


def shard_dia(d: Dia, mesh: Mesh) -> Dia:
    """A Dia operator's values for this process's shards, ``(nd, S*m)``: a
    column slice (no copy when one process holds every shard), padded to
    a multiple of the shard count.  ``shape`` and ``nnz`` stay global."""
    d = _pad_dia_multiple(d, mesh.n_shards)
    m = d.padded_rows // mesh.n_shards
    vals = d.vals.to(mesh.device)
    if mesh.world > 1:
        vals = vals[:, mesh.first * m:(mesh.first + mesh.local) * m] \
            .contiguous()
    return Dia(vals, d.offsets, d.shape, d.nnz)


def shard_well(w: WEll, mesh: Mesh) -> WEll:
    """A WEll operator's row groups of this process's shards, ``[first *
    gps, (first + S) * gps)`` with ``gps = ngroups / D``
    (:meth:`~amg_tpu_torch.sparse.WEll.block`, on the mesh's device).  When
    one process holds every shard and the layout is already in row order
    the operator is its own block (no copy)."""
    ngroups = w.vals.shape[0]
    if ngroups % mesh.n_shards:
        raise ValueError(f"ngroups {ngroups} not divisible by "
                         f"{mesh.n_shards}")
    if mesh.world == 1 and not w.rows.classes \
            and w.rows.vals.device == mesh.device:
        return w
    gps = ngroups // mesh.n_shards
    return w.block(mesh.first * gps, (mesh.first + mesh.local) * gps,
                   device=mesh.device)


def shard_banded(a: BandedBlocks, mesh: Mesh) -> BandedBlocks:
    """A BandedBlocks operator's block rows of this process's shards (a
    view when one process holds every shard), or the whole operator,
    replicated, when its block rows do not split into the shards
    (``amg_tpu/parallel/dist.py:168-177``)."""
    nbr = a.vals.shape[0]
    if nbr % mesh.n_shards:
        return a
    bps = nbr // mesh.n_shards
    vals = a.vals.to(mesh.device)
    if mesh.world > 1:
        vals = vals[mesh.first * bps:(mesh.first + mesh.local) * bps] \
            .contiguous()
    return BandedBlocks(vals, a.nb, a.shape, a.nnz)


def shard_rows(m, mesh: Mesh):
    """An Ell or Dense operator's rows of this process's shards, padded to
    a multiple of the shard count (``amg_tpu``'s ``_pad_rows_multiple``,
    ``dist.py:58-75``, and the Dense padding of ``:159-166``: padded Ell
    slots point at their own row, clipped to the columns, with value 0);
    a view when one process holds every shard and no padding is needed.
    ``shape`` and ``nnz`` stay global."""
    if isinstance(m, Ell):
        pr = m.padded_rows
        extra = _round_up(pr, mesh.n_shards) - pr
        cols, vals = m.cols, m.vals
        if extra:
            pad_cols = torch.arange(pr, pr + extra, device=cols.device) \
                .clamp(0, max(m.n_cols - 1, 0))[:, None]
            cols = torch.cat([cols, pad_cols.expand(extra, m.width)])
            vals = torch.cat([vals, vals.new_zeros(extra, m.width)])
        rows = (cols, vals)
    elif isinstance(m, Dense):
        rows = (_pad_vec_multiple(m.vals, mesh.n_shards),)
    else:
        raise TypeError(f"no row sharding for {type(m).__name__}")
    rows = tuple(local_rows(t.to(mesh.device), mesh).flatten(0, 1)
                 for t in rows)
    if mesh.world > 1:
        rows = tuple(t.contiguous() for t in rows)
    return Ell(*rows, m.shape, m.nnz) if isinstance(m, Ell) \
        else Dense(*rows, m.shape, m.nnz)


def shard_matrix(m, mesh: Mesh, gspmd: bool = False):
    """This process's share of a level operator: Dia, WEll and BandedBlocks
    row-sharded (:func:`shard_dia`, :func:`shard_well`,
    :func:`shard_banded`).  Ell and Dense stay whole (replicated: the
    all-gather boundary of the general mode applies them to the gathered
    vector), unless ``gspmd``: then they are row-sharded too
    (:func:`shard_rows`, ``amg_tpu``'s ``shard_mat``, ``dist.py:145-233``),
    and a WEll operator stays whole within one process (the all-gather
    product reads it with x whole, so its GS-class layout serves as is)."""
    if isinstance(m, Dia):
        return shard_dia(m, mesh)
    if isinstance(m, WEll):
        return m if gspmd and mesh.world == 1 else shard_well(m, mesh)
    if isinstance(m, BandedBlocks):
        return shard_banded(m, mesh)
    return shard_rows(m, mesh) if gspmd else m


def _gid_from_groups(level: Level) -> torch.Tensor | None:
    """A GS group id per padded row (-1 for none), from a level's row
    ranges or index groups: the masked GS of a row-sharded level reads it
    where the single-device level runs range or gather updates."""
    if level.gid is not None or not (level.ranges or level.groups):
        return level.gid
    dev = level.diag.device
    gid = torch.full((level.pad,), -1, dtype=torch.int32, device=dev)
    if level.ranges:
        for g, (start, size) in enumerate(level.ranges):
            gid[start:start + size] = g
    else:
        for g, idx in enumerate(level.groups):
            gid[idx] = g
    return gid


def _shard_level(level: Level, mesh: Mesh, gspmd: bool = False) -> Level:
    """A row-sharded level: its operators (:func:`shard_matrix`) and
    per-row vectors as this process's shards; the boundary index tensors
    stay whole (they hold global positions), and so do the compact P and R
    of a compact boundary (``member_idx``: they act on the short
    replicated vectors).  ``gs_w`` (the single-device fused GS weights) is
    dropped: the sharded GS is a ring product and a masked select (with
    ``gspmd`` over a group id derived from the level's row ranges or
    groups where it has none)."""
    def mat(m):
        return None if m is None else shard_matrix(m, mesh, gspmd)

    def rows(v):
        if v is None:
            return None
        v = _pad_vec_multiple(v.to(mesh.device), mesh.n_shards)
        return local_rows(v, mesh) if mesh.world == 1 \
            else local_rows(v, mesh).contiguous()

    compact = level.member_idx is not None
    gid = _gid_from_groups(level) if gspmd else level.gid
    return dataclasses.replace(
        level, a=mat(level.a), p=level.p if compact else mat(level.p),
        r=level.r if compact else mat(level.r),
        diag=rows(level.diag), inv_diag=rows(level.inv_diag),
        l1_inv=rows(level.l1_inv), gid=rows(gid), gs_w=None,
        diag_mask=None, groups=None)


def replicated(level: Level, mesh: Mesh, pars: AMGParams | None) -> bool:
    """``amg_tpu``'s replication rule (``dist.py:252-256``): a level is
    replicated when its nnz is at most ``pars.coarse_replicate_nnz`` or its
    pad under 8 rows per shard."""
    thresh = pars.coarse_replicate_nnz if pars is not None else 65536
    return level.a.nnz <= thresh or level.pad < 8 * mesh.n_shards


def shard_hierarchy(mg: Hierarchy, mesh: Mesh, pars: AMGParams | None = None,
                    replicate_from_level: int | None = None,
                    gspmd: bool = False) -> Hierarchy:
    """Levels row-sharded on the mesh, the rest replicated (as they are,
    on the mesh's device).  ``replicate_from_level`` sets the cut (the
    SPMD cycle: sharded embedded levels ``0..E``, replicated compact
    tail); without it each level follows :func:`replicated`.  ``gspmd``
    places a sharded level as ``amg_tpu``'s GSPMD solver does, Ell and
    Dense operators row-sharded too (:func:`shard_matrix`)."""
    levels = []
    for l, lvl in enumerate(mg.levels):
        if replicate_from_level is not None:
            replicate = l >= replicate_from_level
        else:
            replicate = replicated(lvl, mesh, pars)
        levels.append(lvl if replicate else _shard_level(lvl, mesh, gspmd))
    return Hierarchy(levels=tuple(levels), coarse_inv=mg.coarse_inv)


class RowStaging(Staging):
    """The entry frame's staging (:class:`~amg_tpu_torch.solve.entry.
    Staging`) of a row-sharded level 0: a host vector is permuted on the
    host, where level 0 has a permutation, and only this process's rows
    are converted and copied (:func:`shard_vector`); a solution comes back
    through :func:`~.multihost.fetch`, every process's rows."""

    def __init__(self, n: int, pad: int, mesh: Mesh, perm=None):
        self.mesh = mesh
        super().__init__(n, pad, mesh.device, perm)

    def _device_perm(self):
        return None

    def _put(self, v, dtype):
        v = np.asarray(v, dtype=np.float64)[: self.n]
        if self.perm is not None:
            v = v[self.perm]
        vd = shard_vector(v, self.mesh, pad_to=self.pad, dtype=dtype)
        return vd, vd.numel() * vd.element_size()

    def _fetch(self, xd) -> np.ndarray:
        return fetch(xd, self.mesh)


def gspmd_depth(mg: Hierarchy, mesh: Mesh, pars: AMGParams | None) -> int:
    """The last row-sharded level ``Es`` of the GSPMD solver (-1: every
    level replicated).  Levels follow :func:`replicated` (``amg_tpu``'s
    rule) from level 0 down to the first replicated one; below it every
    level is replicated, and so are the coarsest level (its dense inverse
    is replicated) and, in a fine-grid-embedded hierarchy, the boundary
    level ``E`` and those below it (the single-device cycle crosses that
    boundary).  ``amg_tpu`` lets XLA move vectors between any placements;
    here a sharded prefix needs one boundary."""
    from .spmd_cycle import num_embedded

    last = mg.num_levels - 1
    E = num_embedded(mg)
    if E:
        last = min(last, E)
    for l in range(last):
        if replicated(mg.levels[l], mesh, pars):
            return l - 1
    return last - 1


class DistAMGSolver(EntryFrame):
    """AMG on a ring of row shards with ``amg_tpu``'s GSPMD placement
    (``amg_tpu``'s ``DistAMGSolver``, ``dist.py:273-436``).

    Setup runs on the host as for :class:`~amg_tpu_torch.AMGSolver`, with
    ``dist_devices`` set to the mesh's shard count (pads that split into
    the shards, whole WEll row groups and BandedBlocks block rows per
    shard; ``amg_tpu``'s ``device_put`` fails where WEll groups do not
    split).  Levels ``0..Es`` (:func:`gspmd_depth`) are row-sharded with
    every operator, Ell and Dense included (``shard_hierarchy(...,
    gspmd=True)``); the rest is replicated.  A sharded level smooths with
    the whole ``SmootherType`` surface (masked GS per colour), every
    product the one XLA places (:func:`~.spmd_cycle.gspmd_spmv`: ring
    products on Dia and BandedBlocks, all-gather products on WEll, Ell and
    Dense); replicated levels run the single-device cycle.

    :meth:`solve` is the host loop over one cycle and its ``psum``-reduced
    residual norm; with ``pars.refine`` and a dtype other than f64 it runs
    :meth:`solve_refined`, f64 defect correction against the row-sharded
    f64 level-0 operator ``a0_hi`` (Dia through B1's window entry, else
    Ell through the all-gather product).  Like ``amg_tpu``'s, this solver
    runs no Krylov acceleration: ``pars.accel`` is not read.  The mesh
    defaults to one shard per process on the card; pass
    ``mesh=make_mesh(D, device="cpu")`` for the CPU.  The steps' route
    (``steps``) follows :class:`~.spmd_cycle.SpmdAMGSolver`'s: step graphs
    on the card, alone or in an NCCL group, static buffers on the CPU.
    The entries are the entry frame's (:class:`~amg_tpu_torch.solve.
    entry.EntryFrame`); a row-sharded level 0 stages its vectors through
    :class:`RowStaging`, a replicated one whole.
    """

    _ring_loop = True

    def __init__(self, a, pars: AMGParams = AMGParams(),
                 mesh: Mesh | None = None, log=print):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.ndev = self.mesh.n_shards
        self.a = a
        self.log = log
        if pars.dist_devices != self.ndev:
            pars = pars.replace(dist_devices=self.ndev)
        self.pars = pars
        if self.mesh.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        mg, hh = setup(a, pars, log=log, device=self.mesh.device)
        self.host_hierarchy = hh
        self.Es = gspmd_depth(mg, self.mesh, pars)
        self.mg = shard_hierarchy(mg, self.mesh, pars,
                                  replicate_from_level=self.Es + 1,
                                  gspmd=True)
        # level-0 vectors: (S, m) blocks of pad rows when sharded
        self.pad = _round_up(mg.levels[0].pad, self.ndev) \
            if self.Es >= 0 else mg.levels[0].pad
        perm = level0_perm(hh)
        if self.Es >= 0:
            self.staging = RowStaging(a.n_rows, self.pad, self.mesh, perm)
            self._psum = self.mesh.psum
        else:
            self.staging = Staging(a.n_rows, self.pad, self.mesh.device,
                                   perm)
        self.dtype = torch_dtype(pars.dtype)
        self.a0_hi = None
        if pars.refine and self.dtype != torch.float64:
            kw = dict(dtype=torch.float64, pad_rows_to=mg.levels[0].pad,
                      device=self.mesh.device)
            if _pick_format(hh.a[0], pars) == "dia":
                hi = Dia.from_csr(hh.a[0], **kw)
            else:
                hi = Ell.from_csr(hh.a[0], **kw)
            self.a0_hi = hi if self.Es < 0 else shard_matrix(hi, self.mesh,
                                                             gspmd=True)
        self.steps = StepGraphs(self.mesh.device, self.mesh.backend)
        if pars.verbose:
            if self.Es < 0:
                log(f"{self.mesh.describe()}; every level replicated "
                    f"(GSPMD); steps: {self.steps.describe()}")
            else:
                log(f"{self.mesh.describe()}; levels 0..{self.Es} "
                    f"row-sharded (GSPMD), {self.pad // self.ndev} rows "
                    f"per shard; steps: {self.steps.describe()}")

    # -- the frame's placement: the cycle and the level-0 product ---------

    # the sharded pieces come from .spmd_cycle, which imports this module

    def _spmv(self, a, x):
        if self.Es < 0:
            return spmv(a, x)[..., : x.shape[-1]]
        from .spmd_cycle import gspmd_spmv

        return gspmd_spmv(a, x, self.mesh)

    def _cycle(self, x, b):
        if self.Es < 0:
            return cycle(self.mg, x, b, self.pars)
        from .spmd_cycle import cycle_general, gspmd_spmv

        return cycle_general(self.mg, x, b, self.pars, self.Es, True,
                             self.mesh, gspmd_spmv)

    # -- entries -----------------------------------------------------------

    def solve_refined(self, b, x0=None, eager=False):
        """Sharded mixed-precision defect correction (``dist.py:340-394``):
        ``refine_inner_cycles`` cycles in the solve dtype per f64 residual
        update until the f64 relative residual meets ``tol``;
        ``info.nits`` counts cycles.  ``eager`` runs the steps as they
        are on any mesh."""
        return self._entry(b, x0, torch.float64, self._cycles, True, eager)

    def solve(self, b, x0=None, eager=False):
        """Host loop over cycles (``dist.py:396-436``); runs
        :meth:`solve_refined` when the solver holds ``a0_hi``.  ``eager``
        runs the steps as they are on any mesh."""
        if self.a0_hi is not None:
            return self.solve_refined(b, x0, eager)
        return self._entry(b, x0, self.dtype, self._cycles, False, eager)
