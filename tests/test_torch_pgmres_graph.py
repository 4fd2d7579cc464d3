"""``AMGSolver.solve_pgmres`` as one program of device loops, on the CPU.

The port runs AMG-preconditioned GMRES as a while loop over restarts, each
a while loop over Arnoldi steps that index the basis through a step
counter on the device (``solve.krylov.GMRESLoop``); on the card the
program is one CUDA graph (tests/test_torch_gpu.py, chip_smoke.py phase
16), here the host driver of ``solve.loop_graph`` runs it.  Against
amg_tpu's ``solve_pgmres`` (one jitted ``lax.while_loop``) on the 24 x 24
convection-diffusion system of tests/test_solve.py:613, with the Dense
and the KRYLOV coarsest solver: equal iterations, x to ``1e-8`` relative
(tests/test_torch_krylov.py's bar for this solve: f64 summation order,
XLA against torch, through every cycle).  The program itself reads
nothing on the host but its loop flags (torch's host reads patched to
raise, as tests/test_torch_krylov_loop.py does), and the back-
substitution's plain version sums each row in the column order the
kernel keeps (bit for bit against a numpy transcription of that order).
"""

import numpy as np
import pytest
import torch

import amg_tpu as jamg

import amg_tpu_torch as tamg
from amg_tpu_torch.ops import krylov_small
from amg_tpu_torch.params import SMALLFLOAT
from amg_tpu_torch.solve import krylov as tk
from amg_tpu_torch.solve.loop_graph import run_plain

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_krylov import CPU, FLAGS, QUIET, _rel, convection_diffusion
from test_torch_krylov_loop import no_host_reads

COARSEST = {"dense": "DENSE", "krylov": "KRYLOV"}


def _pars(pkg, coarsest, **kw):
    return pkg.AMGParams(accel="gmres", tol=1e-8, coarsest_solver=getattr(
        pkg.CoarsestSolver, COARSEST[coarsest]), **FLAGS, **kw)


def _rhs():
    return np.random.default_rng(17).standard_normal(576)


@pytest.mark.parametrize("coarsest", ["dense", "krylov"])
def test_pgmres_program_matches_amg_tpu(coarsest):
    """solve_pgmres on the CPU against amg_tpu's jitted GMRES, Dense and
    KRYLOV coarsest solves: equal iterations, true residual below 1e-8,
    x to 1e-8; the host reads each loop flag once per test (one GMRES
    solve, one restart: before and after it, before each step and after
    the last)."""
    ja, ta = convection_diffusion(jamg, 24), convection_diffusion(tamg, 24)
    b = _rhs()
    xj, ji = jamg.AMGSolver(ja, _pars(jamg, coarsest), **QUIET).solve(b)
    solver = tamg.AMGSolver(ta, _pars(tamg, coarsest), **QUIET, **CPU)
    before = dict(tk.counts)
    xt, ti = solver.solve_pgmres(b)
    after = dict(tk.counts)
    assert after["gmres_solves"] - before["gmres_solves"] >= 1
    assert ti.nits == ji.nits <= 30
    true_rel = np.linalg.norm(b - ta.matvec(xt)) / np.linalg.norm(b)
    assert ti.rres < 1e-8 and true_rel < 1e-8
    assert _rel(xt, xj) < 1e-8
    if coarsest == "dense":
        assert after["syncs"] - before["syncs"] == 2 + ti.nits + 1
    assert solver.pgmres_graph is None and solver.pgmres_builds == 0


def test_pgmres_program_reads_only_flags():
    """The solver's GMRES program (a cycle per Arnoldi step, Dense
    coarsest) run again under the host driver with torch's host reads
    patched to raise: it reads nothing but its flags, and ends on the
    solution solve_pgmres returned, bit for bit."""
    ta = convection_diffusion(tamg, 24)
    solver = tamg.AMGSolver(ta, _pars(tamg, "dense"), **QUIET, **CPU)
    b = _rhs()
    x, info = solver.solve_pgmres(b)
    loop = solver.pgmres_loop
    x_dev = loop.x.clone()
    loop.x.zero_()
    with no_host_reads() as (read, reads):
        run_plain(loop.program, read)
    assert len(reads) == 2 + info.nits + 1
    assert int(loop.it) == info.nits and bool(loop.conv)
    assert torch.equal(loop.x, x_dev)


def test_pgmres_loop_is_kept_per_key():
    """The solver keeps one GMRES loop per (device, dtype, pad, max_it,
    tol, restart): a second solve reuses it and gives what a fresh solver
    gives, bit for bit; another tolerance makes a new loop."""
    ta = convection_diffusion(tamg, 24)
    pars = _pars(tamg, "dense")
    solver = tamg.AMGSolver(ta, pars, **QUIET, **CPU)
    b = _rhs()
    solver.solve_pgmres(-b)
    loop = solver.pgmres_loop
    x2, i2 = solver.solve_pgmres(b)
    assert solver.pgmres_loop is loop
    x1, i1 = tamg.AMGSolver(ta, pars, **QUIET, **CPU).solve_pgmres(b)
    assert i1.nits == i2.nits and np.array_equal(x1, x2)
    solver.pars = pars.replace(tol=1e-6)
    x3, i3 = solver.solve_pgmres(b)
    assert solver.pgmres_loop is not loop and i3.nits < i2.nits
    assert loop.m == solver.pgmres_loop.m == 30


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_backsub_plain_sums_in_column_order(dtype):
    """The back-substitution's plain version, which the kernel matches bit
    for bit, sums row jj's products from column jj + 1 up to m - 1, rows
    at and past k_eff give 0: equal, bit for bit, to a numpy scalar
    transcription of that order (each operation rounded once) on a seeded
    30-column triangle stopped at k_eff = 29."""
    m, k = 30, 29
    nd = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(11)
    H = np.triu(rng.standard_normal((m + 1, m)) + 3 * np.eye(m + 1, m))
    H[:, k:] = 0
    H = H.astype(nd)
    g = rng.standard_normal(m + 1).astype(nd)
    y = np.zeros(m, nd)
    for jj in range(k - 1, -1, -1):
        acc = nd(0)
        for c in range(jj + 1, m):
            acc = nd(acc + nd(H[jj, c] * y[c]))
        y[jj] = nd(nd(g[jj] - acc) / H[jj, jj]) \
            if abs(H[jj, jj]) > SMALLFLOAT else nd(0)
    with no_host_reads():
        yt = krylov_small.backsub_plain(torch.from_numpy(H),
                                        torch.from_numpy(g),
                                        torch.tensor(k, dtype=torch.int32))
    np.testing.assert_array_equal(yt.numpy(), y)
