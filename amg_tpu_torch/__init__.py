"""amg_tpu_torch — the PyTorch/CUDA port of ``amg_tpu``.

Classical Ruge-Stueben algebraic multigrid (the capabilities of the
reference solver txthpc/amg): the host setup (strength, RS/PMIS/SA
coarsening, DIR/STD interpolation, Galerkin RAP, coloring) is the same
numpy and native C++ code as ``amg_tpu``; the solve phase runs on torch
tensors on the CUDA card (or, when the caller passes ``device="cpu"``, on
the CPU): banded levels go through a hand-written CUDA DIA kernel and
large unstructured levels through hand-written WEll kernels on an NVIDIA
Hopper card.  ``amg_tpu`` stays the reference this package is tested
against; this package never imports ``jax``.

Quick start::

    import amg_tpu_torch as amg

    a = amg.poisson2d(128)
    solver = amg.AMGSolver(a, amg.AMGParams(tol=1e-8))   # on the card
    x, info = solver.solve(b=np.ones(a.n_rows))
"""

from .params import (
    AMGParams,
    SolveInfo,
    SmootherType,
    InterpType,
    CoarsenType,
    StopType,
    CoarsestSolver,
)
from .sparse import CSR, Ell, Dia, Dense, WEll, BandedBlocks
from .io.matrix_market import read_mtx, write_mtx
from .io.generators import poisson2d, poisson3d, random_spd, fem2d
from .io.checkpoint import save_hierarchy, load_hierarchy
from .hierarchy import setup, setup_host, Hierarchy, HostHierarchy, Level
from .solve.driver import AMGSolver, solver_amg
from .solve.krylov import cg, gmres

__version__ = "0.1.0"

__all__ = [
    "AMGParams",
    "SolveInfo",
    "SmootherType",
    "InterpType",
    "CoarsenType",
    "StopType",
    "CoarsestSolver",
    "CSR",
    "Ell",
    "Dia",
    "Dense",
    "WEll",
    "BandedBlocks",
    "read_mtx",
    "write_mtx",
    "poisson2d",
    "poisson3d",
    "random_spd",
    "fem2d",
    "save_hierarchy",
    "load_hierarchy",
    "setup",
    "setup_host",
    "Hierarchy",
    "HostHierarchy",
    "Level",
    "AMGSolver",
    "solver_amg",
    "cg",
    "gmres",
]
