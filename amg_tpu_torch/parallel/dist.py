"""The ring of row shards: mesh, collectives, sharded vectors and
hierarchies.

Port of the mesh and placement half of ``amg_tpu/parallel/dist.py``
(``make_mesh``, ``shard_vector``, ``shard_hierarchy``, ``:39-270``); its
``DistAMGSolver`` (the GSPMD path, an all-gather per product in a port) is
not ported yet.

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
:meth:`Mesh.all_gather` collects every process's shards; the ring's halo
exchange is in :mod:`.halo`.  ``counts`` adds up the collectives.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..hierarchy import Hierarchy, Level, resolve_device
from ..params import AMGParams
from ..sparse import BandedBlocks, Dia, WEll

# collectives over every call: psum calls, all_gather calls
counts = {"psum": 0, "all_gather": 0}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_shards`` row shards in ring order; this process (``rank`` of
    ``world``) holds shards ``[first, first + local)`` on ``device``.
    ``group`` is the process group, None outside ``torch.distributed``."""

    n_shards: int
    device: torch.device
    rank: int = 0
    world: int = 1
    group: object = None

    @property
    def local(self) -> int:
        return self.n_shards // self.world

    @property
    def first(self) -> int:
        return self.rank * self.local

    def describe(self) -> str:
        procs = f"{self.world} process" + ("es" if self.world > 1 else "")
        return f"mesh: {self.n_shards} shards, {procs}, {self.device}"

    def psum(self, partials: torch.Tensor) -> torch.Tensor:
        """Sum of per-shard partials ``(S, ...)`` over every shard of the
        mesh: the local ones in shard order, then across processes."""
        counts["psum"] += 1
        total = partials.sum(0)
        if self.group is not None:
            dist.all_reduce(total, group=self.group)
        return total

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's ``(S, ...)`` shards as ``(D, ...)``, in ring
        order."""
        counts["all_gather"] += 1
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A ring of ``n_devices`` shards (default: one per process) on
    ``device``: the card (``cuda:<local rank>``) unless the caller asks
    for the CPU.  Inside a ``torch.distributed`` process group the shards
    split evenly over its processes; a count that does not split raises
    (never fewer shards than asked)."""
    device = resolve_device(device)
    world, rank, group = 1, 0, None
    if dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), \
            dist.group.WORLD
    n = world if n_devices is None else int(n_devices)
    if n < 1 or n % world:
        raise ValueError(f"{n} shards do not split over {world} processes")
    if device.type == "cuda" and device.index is None:
        from .multihost import local_rank

        device = torch.device("cuda", local_rank())
    return Mesh(n, device, rank, world, group)


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
    all)."""
    m = v.shape[0] // mesh.n_shards
    return v.view(mesh.n_shards, m)[mesh.first: mesh.first + mesh.local]


def shard_vector(v, mesh: Mesh, pad_to: int | None = None,
                 dtype=None) -> torch.Tensor:
    """A global vector (numpy or torch) as this process's ``(S, m)`` block
    on the mesh's device, zero-padded to ``pad_to`` and to a multiple of
    the shard count."""
    v = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
    if dtype is not None:
        v = v.to(dtype)
    if pad_to is not None and v.shape[0] < pad_to:
        v = _pad_vec_multiple(v, pad_to)
    v = _pad_vec_multiple(v, mesh.n_shards)
    return local_rows(v, mesh).to(mesh.device).contiguous()


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


def shard_matrix(m, mesh: Mesh):
    """This process's share of a level operator: Dia, WEll and BandedBlocks
    row-sharded (:func:`shard_dia`, :func:`shard_well`,
    :func:`shard_banded`); Ell and Dense stay whole (replicated: the
    all-gather boundary of the general mode applies them to the gathered
    vector)."""
    if isinstance(m, Dia):
        return shard_dia(m, mesh)
    if isinstance(m, WEll):
        return shard_well(m, mesh)
    if isinstance(m, BandedBlocks):
        return shard_banded(m, mesh)
    return m


def _shard_level(level: Level, mesh: Mesh) -> Level:
    """A row-sharded level: its operators (:func:`shard_matrix`) and
    per-row vectors as this process's shards; the boundary index tensors
    stay whole (they hold global positions), and so do the compact P and R
    of a compact boundary (``member_idx``: they act on the short
    replicated vectors).  ``gs_w`` (the single-device fused GS weights) is
    dropped: the sharded GS is a ring product and a masked select."""
    def mat(m):
        return None if m is None else shard_matrix(m, mesh)

    def rows(v):
        if v is None:
            return None
        v = _pad_vec_multiple(v.to(mesh.device), mesh.n_shards)
        return local_rows(v, mesh) if mesh.world == 1 \
            else local_rows(v, mesh).contiguous()

    compact = level.member_idx is not None
    return dataclasses.replace(
        level, a=mat(level.a), p=level.p if compact else mat(level.p),
        r=level.r if compact else mat(level.r),
        diag=rows(level.diag), inv_diag=rows(level.inv_diag),
        l1_inv=rows(level.l1_inv), gid=rows(level.gid), gs_w=None,
        diag_mask=None, groups=None)


def shard_hierarchy(mg: Hierarchy, mesh: Mesh, pars: AMGParams | None = None,
                    replicate_from_level: int | None = None) -> Hierarchy:
    """Levels row-sharded on the mesh, the rest replicated (as they are,
    on the mesh's device).  ``replicate_from_level`` sets the cut (the
    SPMD cycle: sharded embedded levels ``0..E``, replicated compact
    tail); without it a level replicates when its nnz is at most
    ``pars.coarse_replicate_nnz`` or its pad under 8 rows per shard."""
    thresh = pars.coarse_replicate_nnz if pars is not None else 65536
    D = mesh.n_shards
    levels = []
    for l, lvl in enumerate(mg.levels):
        if replicate_from_level is not None:
            replicate = l >= replicate_from_level
        else:
            replicate = lvl.a.nnz <= thresh or lvl.pad < 8 * D
        levels.append(lvl if replicate else _shard_level(lvl, mesh))
    return Hierarchy(levels=tuple(levels), coarse_inv=mg.coarse_inv)
