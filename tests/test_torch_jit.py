"""The port's ``AMGSolver.solve_jit`` against amg_tpu's, on the CPU.

amg_tpu runs the solve in one ``lax.while_loop``
(``amg_tpu/solve/driver.py:168-191``); the port keeps the same state on the
device and runs masked steps (``solve/driver.py::JitLoop``), eagerly on the
CPU and as replays of a CUDA graph on the card (``tests/test_torch_gpu.py``).

Tolerances: in f64 the iterations are equal and x and the history agree
to rtol 1e-10 (summation order only: XLA against torch); the port's
``solve_jit`` equals its own ``solve`` to rtol 1e-12, amg_tpu's own bar
(``tests/test_solve.py:194``).  The f32 cycles of the "auto" layout agree
as the port's other f32 solves do (``tests/test_torch_solve.py``):
iterations within 1, histories at rtol 1e-3 plus atol 1e-6 * ||b||.
"""

import numpy as np
import pytest

import amg_tpu as jamg

import amg_tpu_torch as tamg
from amg_tpu_torch.solve.driver import JIT_BLOCK

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

QUIET = dict(log=lambda *a, **k: None)
CPU = dict(device="cpu")


def _pair(make, **kw):
    """amg_tpu's and the port's solver of the same matrix and parameters."""
    sj = jamg.AMGSolver(make(jamg), jamg.AMGParams(**kw), **QUIET)
    st = tamg.AMGSolver(make(tamg), tamg.AMGParams(**kw), **QUIET, **CPU)
    return sj, st


def _assert_f64_match(ij, it, xj, xt, atol=0.0):
    """Equal iterations, x and history within rtol 1e-10 (plus ``atol``
    on the history)."""
    assert it.nits == ij.nits
    np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=0)
    np.testing.assert_allclose(it.residuals, ij.residuals, rtol=1e-10,
                               atol=atol)
    assert it.ares == pytest.approx(ij.ares, rel=1e-10, abs=atol)


def test_solve_jit_matches_amg_tpu_f64():
    """tests/test_solve.py:194's case: poisson2d(16), default parameters.
    Equal iterations to amg_tpu's solve_jit, x and history within rtol
    1e-10; equal to the port's own solve to rtol 1e-12."""
    sj, st = _pair(lambda m: m.poisson2d(16), verbose=0)
    b = np.ones(256)
    xj, ij = sj.solve_jit(b)
    xt, it = st.solve_jit(b)
    _assert_f64_match(ij, it, xj, xt)
    xs, i_s = st.solve(b)
    assert i_s.nits == it.nits
    np.testing.assert_allclose(xt, xs, rtol=1e-12)
    np.testing.assert_allclose(it.residuals, i_s.residuals, rtol=1e-12)
    assert it.residuals[0] == pytest.approx(16.0, rel=1e-14)   # ||b||


def test_solve_jit_f32_auto_matches_amg_tpu():
    """poisson3d(20) in f32 on the one-device "auto" layout (the port's
    "auto", amg_tpu's flags given as "on"; Dia, Dia, WEll levels) with
    chip_smoke.py phase 22's smoothers (GS on level 0, Chebyshev below):
    iterations within 1, histories at rtol 1e-3 plus 1e-6 * ||b||; x
    solves the system on the host to tol plus the f32 residual's floor."""
    kw = dict(dtype="float32", coarse_op_dtype="bfloat16", tol=1e-6,
              max_it=60, embed_levels=0, dense_level_bytes=1e5,
              well_min_rows=500, verbose=0)
    b = np.random.default_rng(22).standard_normal(8000)
    sj = jamg.AMGSolver(jamg.poisson3d(20), jamg.AMGParams(
        use_well="on", use_banded="on",
        coarse_smoother=jamg.SmootherType.CHEBYSHEV, **kw), **QUIET)
    a = tamg.poisson3d(20)
    st = tamg.AMGSolver(a, tamg.AMGParams(
        coarse_smoother=tamg.SmootherType.CHEBYSHEV, **kw), **QUIET, **CPU)
    kinds = [type(l.a).__name__ for l in st.mg.levels]
    assert kinds == [type(l.a).__name__ for l in sj.mg.levels]
    assert {"Dia", "WEll"} <= set(kinds)
    xj, ij = sj.solve_jit(b)
    xt, it = st.solve_jit(b)
    assert abs(it.nits - ij.nits) <= 1
    n = min(len(it.residuals), len(ij.residuals))
    np.testing.assert_allclose(it.residuals[:n], ij.residuals[:n],
                               rtol=1e-3, atol=1e-6 * np.linalg.norm(b))
    true_rel = np.linalg.norm(b - a.matvec(xt.astype(np.float64))) \
        / np.linalg.norm(b)
    assert it.rres < 1e-6 and true_rel < 1.5e-6


def test_solve_jit_stops_at_max_it():
    """max_it = 3 stops the loop before tol: nits == max_it and the
    history holds ||b|| and 3 residuals, as amg_tpu's."""
    sj, st = _pair(lambda m: m.poisson2d(16), verbose=0, max_it=3)
    b = np.ones(256)
    xj, ij = sj.solve_jit(b)
    xt, it = st.solve_jit(b)
    assert it.nits == ij.nits == 3
    assert len(it.residuals) == len(ij.residuals) == 4
    _assert_f64_match(ij, it, xj, xt)
    assert it.rres > 1e-6


def test_solve_jit_given_x0_and_zero_b():
    """A given x0 (amg_tpu starts the loop at absres = ||b|| whatever x0
    is), and b = 0: the condition is NaN, so 0 iterations and x0 comes
    back, with residuals [0], as amg_tpu returns them."""
    sj, st = _pair(lambda m: m.poisson2d(16), verbose=0)
    rng = np.random.default_rng(3)
    b, x0 = rng.standard_normal(256), rng.standard_normal(256)
    xj, ij = sj.solve_jit(b, x0=x0)
    xt, it = st.solve_jit(b, x0=x0)
    _assert_f64_match(ij, it, xj, xt)
    zero = np.zeros(256)
    xj, ij = sj.solve_jit(zero, x0=x0)
    xt, it = st.solve_jit(zero, x0=x0)
    assert it.nits == ij.nits == 0
    assert it.residuals == ij.residuals == [0.0]
    assert it.ares == ij.ares == 0.0 and it.rres == ij.rres == 0.0
    np.testing.assert_array_equal(xt, x0)
    np.testing.assert_array_equal(xj, x0)


def test_solve_jit_converged_mid_block_keeps_x():
    """poisson2d(16) converges at cycle 7, inside the second block of
    JIT_BLOCK steps: the masked steps after it change nothing, so x is
    solve's x at the converged cycle, bit for bit."""
    st = tamg.AMGSolver(tamg.poisson2d(16), tamg.AMGParams(verbose=0),
                        **QUIET, **CPU)
    b = np.ones(256)
    xs, i_s = st.solve(b)
    xt, it = st.solve_jit(b)
    loop = st.jit_loop
    assert it.nits == i_s.nits and it.nits % JIT_BLOCK != 0
    assert loop.blocks * JIT_BLOCK > it.nits and loop.graph is None
    assert loop.host_reads == loop.blocks + 1
    np.testing.assert_array_equal(xt, xs)
    assert it.residuals == i_s.residuals
    # a second solve reuses the loop
    xt2, it2 = st.solve_jit(b)
    assert st.jit_loop is loop
    np.testing.assert_array_equal(xt2, xt)


def test_solve_jit_well_level0_permutation():
    """A WEll level 0 with its RCM permutation (fem2d(5000), f64): x comes
    back in the caller's ordering, equal to amg_tpu's, and solves the
    system.  The history near tol 1e-8 is a difference of nearly equal
    f64 vectors, so it also takes an atol of 1e-12 * ||b|| (the WEll
    products sum in another order than XLA's: 7e-14 apart there)."""
    kw = dict(use_well="on", well_min_rows=1024, dense_level_bytes=2e7,
              embed_levels=0, use_banded="off", verbose=0, tol=1e-8)
    sj, st = _pair(lambda m: m.fem2d(5000, seed=9), **kw)
    assert type(st.mg.levels[0].a).__name__ == "WEll"
    assert st.staging.perm is not None
    b = np.random.default_rng(5).standard_normal(5000)
    xj, ij = sj.solve_jit(b)
    xt, it = st.solve_jit(b)
    _assert_f64_match(ij, it, xj, xt, atol=1e-12 * np.linalg.norm(b))
    a = tamg.fem2d(5000, seed=9)
    assert np.linalg.norm(b - a.matvec(xt)) / np.linalg.norm(b) \
        == pytest.approx(it.rres, rel=1e-6)


def test_solve_jit_krylov_coarsest_matches_solve():
    """The KRYLOV coarsest solve (CG then GMRES; on the CPU their host
    loops, on the card a graph inside the step's, tests/test_torch_gpu.py):
    the masked loop equals the port's solve."""
    st = tamg.AMGSolver(tamg.poisson2d(16), tamg.AMGParams(
        verbose=0, coarsest_solver=tamg.CoarsestSolver.KRYLOV), **QUIET,
        **CPU)
    b = np.ones(256)
    xs, i_s = st.solve(b)
    xt, it = st.solve_jit(b)
    assert it.nits == i_s.nits
    np.testing.assert_allclose(xt, xs, rtol=1e-12)
    np.testing.assert_allclose(it.residuals, i_s.residuals, rtol=1e-12)
