"""The entry frame of the three solvers (``amg_tpu_torch/solve/entry.py``)
on the CPU: a missing ``x0`` is zeros made on the device, so every entry
gives with ``x0=None`` what it gives with ``x0=np.zeros(n)``, bit for bit
(x, iterations, residual history), and uploads b alone.

The entries: ``AMGSolver``'s six (and ``solve`` on an RCM-ordered WEll
level 0, whose permutation the staging holds on the device), and those of
the two ring solvers on a one-process CPU mesh of 2 shards:
``SpmdAMGSolver.solve`` and ``solve_pcg``, ``DistAMGSolver.solve`` and
``solve_refined`` with level 0 row-sharded (the row form of the staging)
and ``solve`` with level 0 replicated (the whole-vector form).
"""

import numpy as np
import pytest

import amg_tpu_torch as tamg
from amg_tpu_torch import tracing
from amg_tpu_torch.parallel import DistAMGSolver, SpmdAMGSolver, make_mesh
from amg_tpu_torch.parallel.dist import RowStaging

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

QUIET = dict(log=lambda *a, **k: None)
CHEB = tamg.SmootherType.CHEBYSHEV


@pytest.fixture(scope="module")
def solvers():
    """poisson3d(10) to 1e-8, Chebyshev below level 0: f64 cycles, f32
    cycles with f64 defect correction (and FCG), fem2d(6000) on an
    RCM-ordered WEll level 0 with FCG, and the ring solvers."""
    a = tamg.poisson3d(10)
    f64 = tamg.AMGParams(verbose=0, tol=1e-8, coarse_smoother=CHEB)
    f32 = f64.replace(dtype="float32", refine=True)
    fem = tamg.fem2d(6000, seed=11)
    fem_pars = f32.replace(accel="cg", coarse_op_dtype="float32",
                           use_well="on", well_min_rows=1024,
                           dense_level_bytes=1 << 20)
    mesh = make_mesh(2, device="cpu")
    ss = {
        "f64": (a, tamg.AMGSolver(a, f64, device="cpu", **QUIET)),
        "f32": (a, tamg.AMGSolver(a, f32, device="cpu", **QUIET)),
        "fem_rcm": (fem, tamg.AMGSolver(fem, fem_pars, device="cpu",
                                        **QUIET)),
        "spmd": (a, SpmdAMGSolver(a, f64, mesh=mesh, **QUIET)),
        "spmd_cg": (a, SpmdAMGSolver(a, f32.replace(accel="cg"), mesh=mesh,
                                     **QUIET)),
        "gspmd": (a, DistAMGSolver(a, f64.replace(coarse_replicate_nnz=200),
                                   mesh=mesh, **QUIET)),
        "gspmd32": (a, DistAMGSolver(
            a, f32.replace(coarse_replicate_nnz=200), mesh=mesh, **QUIET)),
        "gspmd_whole": (a, DistAMGSolver(a, f64, mesh=mesh, **QUIET)),
    }
    assert ss["fem_rcm"][1].staging.perm is not None
    assert ss["gspmd"][1].Es >= 0 and ss["gspmd_whole"][1].Es < 0
    return ss


CASES = ["f64-solve", "f32-solve_refined", "f32-solve_pcg",
         "f32-solve_pgmres", "f64-solve_batched", "f64-solve_jit",
         "fem_rcm-solve", "spmd-solve", "spmd_cg-solve_pcg", "gspmd-solve",
         "gspmd32-solve_refined", "gspmd_whole-solve"]


@pytest.mark.parametrize("case", CASES)
def test_missing_x0_is_zeros_on_the_device(solvers, case):
    kind, entry = case.split("-")
    a, s = solvers[kind]
    n = a.n_rows
    b = np.random.default_rng(3).standard_normal(n)
    zeros = np.zeros(n)
    if entry == "solve_batched":
        b, zeros = np.stack([b, -2.0 * b], axis=1), np.zeros((n, 2))
    run = getattr(s, entry)
    tracing.reset()
    x, info = run(b, None)
    t = tracing.totals()
    tracing.reset()
    # one upload, of b: the whole form copies b as given, the row form
    # this process's padded rows (f64 here: every staged b is f64)
    row_form = isinstance(s.staging, RowStaging)
    assert t["amg.solve"]["n"] == 1
    assert t["amg.upload"]["n"] == 1 and t["amg.download"]["n"] == 1
    assert t["amg.upload"]["bytes"] == (8 * s.pad if row_form else b.nbytes)
    xz, iz = run(b, zeros)
    # converged (GMRES stops on its Givens estimate: 1.3e-7 here)
    assert 0 < info.nits and info.rres < 1e-6
    assert np.array_equal(x, xz)
    assert info.nits == iz.nits
    assert info.residuals == iz.residuals
    assert (info.ares, info.rres) == (iz.ares, iz.rres)
