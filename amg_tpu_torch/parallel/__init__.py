"""Multi-device solve on a ring of row shards (``torch.distributed``).

Port of ``amg_tpu.parallel``'s embedded SPMD mode: :class:`SpmdAMGSolver`
on a :func:`make_mesh` ring, the ring Dia product :func:`spmv_dia_ring`
(B1's window entry), the sharded placement (:func:`shard_hierarchy`,
:func:`shard_vector`) and multi-process wiring (:func:`initialize`,
:func:`is_multiprocess`, :func:`fetch`).  Imported on demand, as
``amg_tpu`` imports its own.  Not ported yet: the general SPMD mode,
``DistAMGSolver`` and ``make_host_mesh``.
"""

from .dist import make_mesh, shard_hierarchy, shard_vector
from .halo import spmv_dia_ring
from .spmd_cycle import SpmdAMGSolver
from .multihost import initialize, is_multiprocess, fetch

__all__ = ["make_mesh", "shard_hierarchy", "shard_vector", "spmv_dia_ring",
           "SpmdAMGSolver", "initialize", "is_multiprocess", "fetch"]
