"""Ring halo exchange and the row-sharded Dia product.

Port of the Dia half of ``amg_tpu/parallel/halo.py`` (``:38-236``): each
shard owns a contiguous block of ``m`` rows; a band of half-widths
``lo``/``hi`` needs the ``lo`` entries of x before the block and the
``hi`` after it, and the local product then runs on the haloed window
through B1's window entry (:func:`amg_tpu_torch.ops.dia_kernel.
spmv_window`, its plain version on the CPU).

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

``counts`` adds up, over every call: ring products (``products``), the x
bytes that shard windows take from other shards (``halo_bytes``, 0 at the
mesh edges) and the messages and bytes sent between processes
(``p2p``, ``p2p_bytes``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import dia_kernel
from ..sparse import Dia
from .dist import Mesh, shard_dia, shard_vector

counts = {"products": 0, "halo_bytes": 0, "p2p": 0, "p2p_bytes": 0}


def dia_halo_widths(offsets) -> tuple[int, int]:
    lo = max(-min(offsets), 0) if offsets else 0
    hi = max(max(offsets), 0) if offsets else 0
    return lo, hi


def _remote_halos(flat: torch.Tensor, lo: int, hi: int, mesh: Mesh):
    """The ``lo`` entries before and the ``hi`` entries after this
    process's block of a row-sharded vector, from the neighbouring
    processes (multi-hop; zeros beyond the mesh)."""
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
                ops.append(dist.P2POp(dist.isend, flat[M - nl:].contiguous(),
                                      mesh.rank + j, mesh.group))
        if nr > 0:
            if mesh.rank + j < mesh.world:
                ops.append(dist.P2POp(dist.irecv,
                                      right[(j - 1) * M:(j - 1) * M + nr],
                                      mesh.rank + j, mesh.group))
            if mesh.rank - j >= 0:
                ops.append(dist.P2POp(dist.isend, flat[:nr].contiguous(),
                                      mesh.rank - j, mesh.group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        sent = [op for op in ops if op.op is dist.isend]
        counts["p2p"] += len(sent)
        counts["p2p_bytes"] += sum(op.tensor.numel() for op in sent) \
            * flat.element_size()
    return left, right


def ring_windows(x: torch.Tensor, lo: int, hi: int, mesh: Mesh):
    """``(windows, lo)``: the ``(S, lo + m + hi)`` haloed windows of this
    process's shards of ``x`` ``(S, m)``, as overlapping views of one
    haloed copy of the block.  The halos are rounded up to 16 bytes so
    that every window stays aligned for the kernel's vector loads (the
    extra entries are never read)."""
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
    ext = torch.cat([left, flat, right])
    return ext.as_strided((S, lo + m + hi), (m, 1)), lo


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
