"""The one place where the benchmark calls the program under test,
``amg_tpu_torch``: its solver, its entries, and the counters and level-0
operator that the per-layer metrics and the level-0 check read.  A
rename in the program touches this file only.
"""

from __future__ import annotations

import amg_tpu_torch as amg
import numpy as np


def params(spec: dict):
    """``AMGParams`` from a configuration's ``params``: enumerations by
    member name, everything else as written."""
    enums = {"smoother": amg.SmootherType, "coarse_smoother": amg.SmootherType,
             "interp_type": amg.InterpType, "coarsen_type": amg.CoarsenType,
             "stop_type": amg.StopType, "coarsest_solver": amg.CoarsestSolver}
    kw = {k: (enums[k][v] if k in enums else v) for k, v in spec.items()}
    return amg.AMGParams(**kw)


def join_group(address: str, world: int, rank: int, device: str) -> None:
    """Join this process to the run's process group (NCCL on the card,
    gloo on the CPU) as ``rank`` of ``world``."""
    from amg_tpu_torch.parallel import multihost

    multihost.initialize(address, world, rank, device=device)


def make_solver(indptr, indices, data, pars, device, kind: str = "amg"):
    """The solver under test, set up on ``device`` for the CSR arrays:
    ``AMGSolver`` (``kind`` "amg"), or ``SpmdAMGSolver`` (``kind``
    "spmd") on a ring of one row shard per process of the group."""
    n = len(indptr) - 1
    a = amg.CSR(np.asarray(indptr), np.asarray(indices), np.asarray(data),
                (n, n))
    quiet = lambda *_: None  # noqa: E731
    if kind == "spmd":
        from amg_tpu_torch.parallel.dist import make_mesh
        from amg_tpu_torch.parallel.spmd_cycle import SpmdAMGSolver

        return SpmdAMGSolver(a, pars, mesh=make_mesh(device=device),
                             log=quiet)
    if kind != "amg":
        raise ValueError(f"unknown solver {kind!r}")
    return amg.AMGSolver(a, pars, log=quiet, device=device)


def entry(solver, name: str, tol):
    """The entry a traffic mix drives: ``f(b) -> (x, info)`` on host
    arrays (``b`` of shape ``(n,)`` for ``solve``, ``(n, k)`` for
    ``solve_batched``)."""
    if name == "solve":
        return solver.solve
    if name == "solve_batched":
        return lambda b: solver.solve_batched(b, tol=tol)
    raise ValueError(f"unknown entry {name!r}")


def info_numbers(info) -> tuple[int, float]:
    """``(iterations, reported relative residual)`` of one call."""
    return int(info.nits), float(info.rres)


def hierarchy_seconds(solver) -> float:
    return float(solver.host_hierarchy.setup_seconds)


def graph_builds(solver) -> int:
    """Step graphs made so far (each made once, then replayed)."""
    return int(solver.steps.builds)


def level0_product(solver):
    """``(prepare, apply)`` for the solver's own packed level-0 operator of
    the cycle: ``prepare(x)`` uploads host ``x`` (``(n,)``, or ``(n, k)``
    for a batch) into the program's padded, internal layout and the
    cycle's dtype; ``apply(xd)`` is the product the cycle launches."""
    op = solver.mg.levels[0].a
    if hasattr(solver, "mesh"):
        # this process's rows of the ring product (collective: every rank
        # applies it together)
        from amg_tpu_torch.parallel.spmd_cycle import _ring_spmv

        return (lambda x: solver._shard(x, solver.dtype),
                lambda xd: _ring_spmv(op, xd, solver.mesh))
    from amg_tpu_torch.ops.spmv import spmv

    return solver._pad_vec, lambda xd: spmv(op, xd)


def to_host(solver, yd) -> np.ndarray:
    """A level-0 product of :func:`level0_product` on the host, in the
    caller's ordering (a ring's rows gathered from every rank)."""
    unmap = solver._unshard if hasattr(solver, "mesh") else \
        solver._unpad_vec
    return np.asarray(unmap(yd), dtype=np.float64)
