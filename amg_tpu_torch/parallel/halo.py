"""Ring halo exchange and the row-sharded products.

Port of ``amg_tpu/parallel/halo.py``: each shard owns a contiguous block
of ``m`` rows; an operator whose rows read x from ``lo`` entries before
their block to ``hi`` after it needs those entries of the neighbouring
shards, and the local product then runs on the haloed window:

* Dia (``:38-236``): halos from the band's offsets, B1's window entry
  (:func:`amg_tpu_torch.ops.dia_kernel.spmv_window`);
* WEll (``:239-359``): halos ``lo128·128``, ``hi128·128`` from the
  operator's ``ring_plan``, one launch of B2's window entry
  (:func:`amg_tpu_torch.ops.well_kernel.spmv_window`) over the process's
  row groups with columns rebased to its window; B3's window entry for
  the df64 operator of FCG (``:450-516``); the boundary prolongation
  against a replicated coarse vector (``well_spmv_local_full``);
* BandedBlocks (``:362-424``): halos of ``nb`` 128-blocks, the batched
  cuBLAS product of ``ops/spmv.py`` over the window (an XLA einsum in
  ``amg_tpu``, not a Pallas kernel).

The GSPMD solver (``amg_tpu``'s ``DistAMGSolver``, where XLA places the
communication) adds the **all-gather product** for the formats whose
product gathers x (``dist.py:93-101``): WEll, Ell and Dense operators
row-sharded by :func:`~.dist.shard_matrix` (``gspmd=True``) multiply
this process's rows by the whole vector, one ``Mesh.all_gather`` of the
``(S, m)`` block (:func:`spmv_gather_local`; WEll through B2's window
entry with ``col0 = 0``).  Within one process the gather is a view of the
flattened block.

Each runs its plain version on CPU tensors.

Halo rule (``halo.py:78-140``): a halo wider than one block takes several
hops, and positions outside the mesh read 0 (edge shards get zeros, never
wrap-around).  Within a process the shards are rows of one ``(S, m)``
tensor: the process's block is haloed once, ``[lo | S*m | hi]``, and the S
windows are overlapping views of it (shard stride ``m``), so the shards
exchange nothing and one launch computes all of them.  Across a process
boundary the halo slabs come from the neighbouring processes by
``dist.batch_isend_irecv``, one message per hop and direction.

``amg_tpu`` splits each product into an interior and two boundary bands
(``halo.py:171-196``) so that XLA can overlap the transfers with compute;
the split changes no number and is left out here (ROADMAP: overlap of ring
transfers).

``counts`` adds up, over every call: ring products (``products``, of
them ``well_products`` and ``banded_products``), all-gather products
(``gather_products``), the x bytes that shard
windows take from other shards (``halo_bytes``, 0 at the mesh edges) and
the messages and bytes sent between processes (``p2p``, ``p2p_bytes``;
also the span table's ``amg.ring.send`` row); a replayed CUDA graph adds
those of its capture.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .. import tracing
from ..ops import dia_kernel, launch_counts, well_kernel
from ..ops.spmv import banded_window_product, spmv
from ..sparse import BandedBlocks, Dense, Dia, WEll
from .dist import (Mesh, local_rows, shard_banded, shard_dia, shard_vector,
                   shard_well)

counts = {"products": 0, "well_products": 0, "banded_products": 0,
          "gather_products": 0, "halo_bytes": 0, "p2p": 0, "p2p_bytes": 0}
# a captured step's replays add its products to the counts
launch_counts.COUNTERS.append(counts)


def dia_halo_widths(offsets) -> tuple[int, int]:
    lo = max(-min(offsets), 0) if offsets else 0
    hi = max(max(offsets), 0) if offsets else 0
    return lo, hi


def _remote_halos(flat: torch.Tensor, lo: int, hi: int, mesh: Mesh):
    """The ``lo`` entries before and the ``hi`` entries after this
    process's block of a row-sharded vector, from the neighbouring
    processes (multi-hop; zeros beyond the mesh).  One
    ``batch_isend_irecv`` per call, and no host read: on an NCCL group a
    step graph captures it (NCCL's batched p2p uses the group's
    communicator, which the step's eager warm-up made), its receive
    buffers come from the graph's pool, the send slabs are views of
    ``flat``, and each ``wait`` makes the current stream wait for NCCL's.
    The message counts (``counts``, and the span table's ``amg.ring.send``
    row) are host counts of the call; a replayed graph adds those of its
    capture."""
    M = flat.shape[0]
    left = flat.new_zeros(lo)
    right = flat.new_zeros(hi)
    ops = []
    # hop j: the slab of process rank -/+ j inside the halo
    for j in range(1, -(-max(lo, hi) // M) + 1):
        nl = min(lo - (j - 1) * M, M)   # entries of the left halo at hop j
        nr = min(hi - (j - 1) * M, M)
        if nl > 0:
            if mesh.rank - j >= 0:
                ops.append(dist.P2POp(dist.irecv, left[lo - (j - 1) * M - nl:
                                                       lo - (j - 1) * M],
                                      mesh.rank - j, mesh.group))
            if mesh.rank + j < mesh.world:
                ops.append(dist.P2POp(dist.isend, flat[M - nl:],
                                      mesh.rank + j, mesh.group))
        if nr > 0:
            if mesh.rank + j < mesh.world:
                ops.append(dist.P2POp(dist.irecv,
                                      right[(j - 1) * M:(j - 1) * M + nr],
                                      mesh.rank + j, mesh.group))
            if mesh.rank - j >= 0:
                ops.append(dist.P2POp(dist.isend, flat[:nr],
                                      mesh.rank - j, mesh.group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        sent = [op for op in ops if op.op is dist.isend]
        nbytes = sum(op.tensor.numel() for op in sent) * flat.element_size()
        counts["p2p"] += len(sent)
        counts["p2p_bytes"] += nbytes
        tracing.count("amg.ring.send", nbytes, len(sent))
    return left, right


def haloed_block(x: torch.Tensor, lo: int, hi: int, mesh: Mesh):
    """``(ext, lo)``: this process's block of ``x`` ``(S, m)`` as one
    vector ``[lo left halo | S*m entries | hi right halo]`` (multi-hop
    halos from the other processes, zeros beyond the mesh).  The halos
    are rounded up to 16 bytes so that windows in it stay aligned for the
    DIA kernel's vector loads (the extra entries are never read)."""
    S, m = x.shape
    # in-mesh halo entries of every local shard (edges excluded)
    first, D = mesh.first, mesh.n_shards
    n = sum(min(lo, (first + s) * m) + min(hi, (D - 1 - first - s) * m)
            for s in range(S))
    counts["halo_bytes"] += n * x.element_size()
    q = 16 // x.element_size()
    lo = -(-lo // q) * q
    hi = -(-hi // q) * q
    flat = x.reshape(-1)
    if mesh.world > 1:
        left, right = _remote_halos(flat, lo, hi, mesh)
    else:
        left, right = flat.new_zeros(lo), flat.new_zeros(hi)
    return torch.cat([left, flat, right]), lo


def ring_windows(x: torch.Tensor, lo: int, hi: int, mesh: Mesh):
    """``(windows, lo)``: the ``(S, lo + m + hi)`` haloed windows of this
    process's shards of ``x`` ``(S, m)``, as overlapping views of one
    :func:`haloed_block` (halos rounded up to 16 bytes)."""
    S, m = x.shape
    ext, lo = haloed_block(x, lo, hi, mesh)
    return ext.as_strided((S, ext.shape[0] - (S - 1) * m), (m, 1)), lo


def dia_spmv_ring_local(a: Dia, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's ``y = (A x)_local`` ``(S, m)`` for a row-sharded Dia
    operator (values ``(nd, S*m)``): the ring's halo windows, then one
    launch of B1's window entry for every local shard (its plain version
    for CPU tensors).  Per row the diagonals are summed in offsets order,
    as the single-device product sums them."""
    counts["products"] += 1
    lo, hi = dia_halo_widths(a.offsets)
    xw, lo = ring_windows(x, lo, hi, mesh)
    return dia_kernel.spmv_window(a, xw, lo)


def spmv_dia_ring(d: Dia, x, mesh: Mesh) -> torch.Tensor:
    """``y = A @ x`` with a global Dia operator row-sharded over the mesh:
    shards the values (``padded_rows`` must split into the mesh's shards)
    and ``x``, runs the ring product, and returns this process's ``(S,
    m)`` block of y (all of it, as ``(D, m)``, when one process holds every
    shard; :func:`~amg_tpu_torch.parallel.multihost.fetch` gathers it)."""
    if d.padded_rows % mesh.n_shards:
        raise ValueError(f"padded_rows {d.padded_rows} not divisible by "
                         f"{mesh.n_shards}")
    xs = shard_vector(x, mesh, pad_to=d.padded_rows)
    return dia_spmv_ring_local(shard_dia(d, mesh), xs, mesh)


# ---------------------------------------------------------------------------
# WEll and BandedBlocks rings (the general SPMD mode)
# ---------------------------------------------------------------------------


def well_shard_plan(w: WEll, n_shards: int,
                    in_m128: int | None = None) -> tuple[int, int]:
    """``(lo128, hi128)``: the halo widths, in 128-column units, of a
    groups-sharded WEll operator on an ``n_shards`` ring: its
    ``ring_plan``, else computed from its pack (``amg_tpu``'s
    ``halo.py:242-260``; ``in_m128``: the input block per shard, default
    the square operator's)."""
    if w.ring_plan is not None:
        return w.ring_plan
    base = w.base.numpy()
    if in_m128 is None:
        in_m128 = base.shape[0] // n_shards * 8
    active = w.vals.reshape(base.shape[0], base.shape[1], -1).ne(0) \
        .any(dim=2).numpy()
    return WEll.ring_plan_host(base, active, n_shards, in_m128)


def well_ring_window(a: WEll, x: torch.Tensor, mesh: Mesh):
    """``(ext, col0)``: this process's haloed block of the input vector
    ``x`` ``(S, m_in)`` for the groups-sharded ``a``, and the global
    column of its first entry."""
    if a.ring_plan is None:
        raise ValueError("WEll operator packed without a ring plan (set "
                         "pars.dist_devices at setup)")
    S, m_in = x.shape
    if m_in * mesh.n_shards != a.pad_cols:
        # P and R read the other level's vector: a block of the wrong
        # level would rebase every column wrongly
        raise ValueError(f"x has {m_in} rows per shard; the operator's "
                         f"{a.pad_cols} columns split into "
                         f"{a.pad_cols // mesh.n_shards}")
    lo128, hi128 = a.ring_plan
    ext, lo = haloed_block(x, lo128 * 128, hi128 * 128, mesh)
    return ext, mesh.first * m_in - lo


def well_spmv_ring_local(a: WEll, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's ``y = (A x)_local`` ``(S, m_out)`` for a
    groups-sharded WEll operator (:func:`~.dist.shard_well`; ``amg_tpu``'s
    ``well_spmv_ring_local``, ``halo.py:263-297``): the input block with
    its ``ring_plan`` halos, then one launch of B2's window entry over the
    process's rows, columns rebased to the window.  A df64 operator with
    an f64 ``x`` takes B3's window entry (``well_spmv_ring_local_df64``,
    ``:450-516``: the f64 vector crosses the ring, the same bytes as
    ``amg_tpu``'s two f32 planes)."""
    counts["products"] += 1
    counts["well_products"] += 1
    ext, col0 = well_ring_window(a, x, mesh)
    if a.vals_lo is not None and x.dtype == torch.float64:
        y = well_kernel.spmv_df64_window(a, ext, col0)
    else:
        y = well_kernel.spmv_window(a, ext, col0)
    return y.view(x.shape[0], -1)


def well_spmv_local_full(a: WEll, x_full: torch.Tensor) -> torch.Tensor:
    """The rows of a groups-sharded WEll operator against the whole
    (replicated) input vector (``halo.py:348-359``): the boundary
    prolongation of the general cycle, where the coarse correction is the
    same on every process, so no exchange is needed.  B2's window entry
    with ``col0 = 0``; returns the process's ``a.padded_rows`` rows."""
    return well_kernel.spmv_window(a, x_full[: a.pad_cols], 0)


def spmv_local_full(a, x_full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's rows of a row-sharded operator (flat, ``S * m_out``)
    against the whole input vector ``x_full`` (replicated, or gathered from
    the ring; it may run past the operator's columns): B2's window entry
    with ``col0 = 0`` for WEll (:func:`well_spmv_local_full`), the gather of
    ``ops/spmv.py`` for Ell, one matvec per shard's row block for Dense,
    and for Dia (the square P of an embedded level) the ring product of
    this process's block of ``x_full``.  cuBLAS picks its gemv by the
    rows, so one matvec over S shards' rows sums them in another order
    than S processes of one shard each; per shard, every layout of the
    same ring computes the same rows alike."""
    if isinstance(a, WEll):
        return well_spmv_local_full(a, x_full)
    if isinstance(a, Dia):
        return dia_spmv_ring_local(a, local_rows(x_full, mesh), mesh) \
            .reshape(-1)
    if isinstance(a, Dense) and mesh.local > 1:
        return torch.cat([spmv(Dense(v, a.shape, a.nnz), x_full)
                          for v in a.vals.chunk(mesh.local)])
    return spmv(a, x_full)


def spmv_gather_local(a, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This process's ``y = (A x)_local`` ``(S, m_out)`` for a row-sharded
    WEll, Ell or Dense operator, as XLA computes it under GSPMD: x's
    ``(S, m_in)`` shards all-gathered (a view within one process), then
    :func:`spmv_local_full`."""
    counts["gather_products"] += 1
    full = mesh.all_gather(x).reshape(-1)
    return spmv_local_full(a, full, mesh).view(x.shape[0], -1)


def banded_spmv_ring_local(a: BandedBlocks, x: torch.Tensor,
                           mesh: Mesh) -> torch.Tensor:
    """This process's ``y = (A x)_local`` ``(S, m)`` for a block-row-sharded
    BandedBlocks operator (``halo.py:398-424``): halos of ``nb``
    128-blocks each way (zeros beyond the mesh, as the global operator's
    zero padding), then the batched product of :func:`~amg_tpu_torch.ops.
    spmv.spmv_banded` over the process's block rows."""
    counts["products"] += 1
    counts["banded_products"] += 1
    halo = a.nb * 128
    ext, lo = haloed_block(x, halo, halo, mesh)
    if lo != halo:
        raise ValueError(f"halo of {halo} entries rounded to {lo}")
    if mesh.local == 1:
        return banded_window_product(a, ext[None], x.dtype).view(x.shape)
    # one batched product per shard, as a process holding only that
    # shard runs it: cuBLAS's f32 batched product sums in another order
    # for another batch count
    S, m = x.shape
    q = a.vals.shape[0] // S
    return torch.cat([banded_window_product(
        dataclasses.replace(a, vals=a.vals[s * q:(s + 1) * q]),
        ext[None, s * m:(s + 1) * m + 2 * halo], x.dtype)
        for s in range(S)])


def spmv_well_ring(w: WEll, x, mesh: Mesh) -> torch.Tensor:
    """``y = A @ x`` with a global WEll operator groups-sharded over the
    mesh (``amg_tpu``'s ``spmv_well_ring``): shards the operator (which
    needs its ``ring_plan``) and ``x`` (zero-padded to ``pad_cols``) and
    returns this process's ``(S, m)`` block of y."""
    xs = shard_vector(x[: w.pad_cols], mesh, pad_to=w.pad_cols)
    return well_spmv_ring_local(shard_well(w, mesh), xs, mesh)


def spmv_banded_ring(a: BandedBlocks, x, mesh: Mesh) -> torch.Tensor:
    """``y = A @ x`` with a BandedBlocks operator block-row-sharded over the
    mesh (``amg_tpu``'s ``spmv_banded_ring``; its block rows must split
    into the shards)."""
    nbr = a.vals.shape[0]
    if nbr % mesh.n_shards:
        raise ValueError(f"block rows {nbr} not divisible by "
                         f"{mesh.n_shards}")
    xs = shard_vector(x[: nbr * 128], mesh, pad_to=nbr * 128)
    return banded_spmv_ring_local(shard_banded(a, mesh), xs, mesh)
