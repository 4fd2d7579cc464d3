"""Worker of tests/test_torch_spmd.py's multi-process test: one of N gloo
processes, each holding its run of the ring's shards on the CPU.

    python tests/_torch_mh_worker.py PORT RANK NPROC SHARDS OUT

Solves poisson3d(12) with FCG in f64 on SHARDS shards and writes the
fetched solution, the iterations and the relative residual to
``OUT.<rank>.npz``.
"""

import sys

import numpy as np
import torch


def main():
    port, rank, nproc, shards, out = sys.argv[1:6]
    rank, nproc, shards = int(rank), int(nproc), int(shards)
    torch.set_num_threads(1)
    import amg_tpu_torch as amg
    from amg_tpu_torch.parallel import (SpmdAMGSolver, initialize,
                                        is_multiprocess, make_mesh)

    assert initialize(f"localhost:{port}", nproc, rank, device="cpu")
    assert is_multiprocess()
    a = amg.poisson3d(12)
    b = np.random.default_rng(43).standard_normal(a.n_rows)
    pars = amg.AMGParams(verbose=0, tol=1e-10, accel="cg",
                         coarse_smoother=amg.SmootherType.CHEBYSHEV)
    mesh = make_mesh(shards, device="cpu")
    assert mesh.local == shards // nproc
    s = SpmdAMGSolver(a, pars, mesh=mesh, log=lambda *x: None)
    x, info = s.solve(b)
    np.savez(f"{out}.{rank}.npz", x=x, nits=info.nits, rres=info.rres)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
