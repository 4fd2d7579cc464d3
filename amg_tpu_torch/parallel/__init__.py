"""Multi-device solve on a ring of row shards (``torch.distributed``).

Port of ``amg_tpu.parallel``'s SPMD solver, both modes:
:class:`SpmdAMGSolver` on a :func:`make_mesh` ring, embedded (Dia levels,
B1's window entry) or general (unstructured WEll, Dia and BandedBlocks
levels: B2's and B3's window entries, the BandedBlocks ring and the
ring-R or all-gather coarse boundary); the ring products
:func:`spmv_dia_ring`, :func:`spmv_well_ring`, :func:`spmv_banded_ring`;
the sharded placement (:func:`shard_hierarchy`, :func:`shard_vector`) and
multi-process wiring (:func:`initialize`, :func:`is_multiprocess`,
:func:`fetch`, :func:`make_host_mesh`); and the GSPMD solver
:class:`DistAMGSolver` (``amg_tpu``'s sharding-annotated solver: ring
products where XLA exchanges halos, all-gather products where it gathers
x).  Imported on demand, as ``amg_tpu`` imports its own.
"""

from .dist import DistAMGSolver, make_mesh, shard_hierarchy, shard_vector
from .halo import spmv_banded_ring, spmv_dia_ring, spmv_well_ring
from .spmd_cycle import SpmdAMGSolver
from .multihost import initialize, is_multiprocess, fetch, make_host_mesh

__all__ = ["make_mesh", "shard_hierarchy", "shard_vector", "spmv_dia_ring",
           "spmv_well_ring", "spmv_banded_ring", "SpmdAMGSolver",
           "DistAMGSolver", "initialize", "is_multiprocess", "fetch",
           "make_host_mesh"]
