"""Worker of the port's multi-process tests (tests/test_torch_spmd.py,
tests/test_torch_spmd_general.py, tests/test_torch_gspmd.py,
tests/test_torch_step_graph.py): one of N
gloo processes, each holding its run of the ring's shards on the CPU.

    python tests/_torch_mh_worker.py PORT RANK NPROC SHARDS OUT [MATRIX]

Solves :func:`problem` ``MATRIX`` (default ``poisson3d``) on SHARDS shards,
with ``SpmdAMGSolver`` or, for ``dist``, ``DistAMGSolver``, and writes the
fetched solution, the iterations, the relative residual and the route of
the solver's steps to ``OUT.<rank>.npz``.
"""

import sys

import numpy as np
import torch


def problem(kind="poisson3d"):
    """``(a, b, pars)`` of a test solve: ``poisson3d``, FCG in f64 on
    poisson3d(12) (the embedded mode); ``fem2d``, bench_dist.py's fem2d
    parameters on fem2d(6000, seed=11) (the general mode: f32 cycles, FCG
    in f64 against the df64 operator), ``dense_level_bytes`` lowered so
    that the small problem keeps WEll levels; ``dist``, the GSPMD solver's
    GS cycles in f64 on poisson2d(24) with ``coarse_replicate_nnz`` low
    enough that levels 0-1 shard (Ell P and R: all-gather products)."""
    import amg_tpu_torch as amg

    if kind == "dist":
        a = amg.poisson2d(24)
        pars = amg.AMGParams(verbose=0, coarse_replicate_nnz=200)
        seed = 19
    elif kind == "fem2d":
        a = amg.fem2d(6000, seed=11)
        pars = amg.AMGParams(
            verbose=0, tol=1e-8, dtype="float32", refine=True, accel="cg",
            coarse_smoother=amg.SmootherType.CHEBYSHEV,
            coarse_op_dtype="float32", use_well="on", well_min_rows=1024,
            dense_level_bytes=1 << 20)
        seed = 17
    else:
        a = amg.poisson3d(12)
        pars = amg.AMGParams(verbose=0, tol=1e-10, accel="cg",
                             coarse_smoother=amg.SmootherType.CHEBYSHEV)
        seed = 43
    b = np.random.default_rng(seed).standard_normal(a.n_rows)
    return a, b, pars


def main():
    port, rank, nproc, shards, out = sys.argv[1:6]
    kind = sys.argv[6] if len(sys.argv) > 6 else "poisson3d"
    rank, nproc, shards = int(rank), int(nproc), int(shards)
    torch.set_num_threads(1)
    from amg_tpu_torch.parallel import (DistAMGSolver, SpmdAMGSolver,
                                        initialize, is_multiprocess,
                                        make_mesh)

    assert initialize(f"localhost:{port}", nproc, rank, device="cpu")
    assert is_multiprocess()
    a, b, pars = problem(kind)
    mesh = make_mesh(shards, device="cpu")
    assert mesh.local == shards // nproc
    solver = DistAMGSolver if kind == "dist" else SpmdAMGSolver
    s = solver(a, pars, mesh=mesh, log=lambda *x: None)
    x, info = s.solve(b)
    np.savez(f"{out}.{rank}.npz", x=x, nits=info.nits, rres=info.rres,
             route=s.steps.route)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
