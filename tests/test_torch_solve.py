"""The port's solve path against amg_tpu: the reference-protocol goldens, a
live run of the mixed-precision slice configuration, a hierarchy carried
over from amg_tpu, the CLI, and the port's independence from jax.

Tolerances: the goldens and amg_tpu's own test hold residual histories to
``rtol=1e-3`` (test_golden.py:130-136); iteration counts are exact.  The
f32 cycles of the slice configuration sum in different orders in the two
packages (XLA against torch; one cycle agrees to ~2e-7 relative), so they
are held to the same ``rtol=1e-3`` and equal iteration counts, plus
``atol=1e-6 * ||b||``: the f64 residual after a defect-correction step is
computed from an f32 correction, whose rounding leaves ~1e-7 * ||b|| of
order-dependent noise in it (measured 1.05e-7 * ||b|| after 4 cycles at
poisson3d(20), 2.1e-3 of that residual).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import amg_tpu as jamg
from amg_tpu.io import checkpoint as jck

import amg_tpu_torch as tamg

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
GOLD = os.path.join(DATA, "golden")
FLAGS = dict(use_well="off", use_banded="off", embed_levels=0, verbose=0)
QUIET = dict(log=lambda *a, **k: None)
CPU = dict(device="cpu")   # the port's entry points default to the card


def _golden_matrix(name):
    return {
        "1138_bus": lambda: tamg.read_mtx(os.path.join(DATA, "1138_bus.mtx")),
        "p2d32": lambda: tamg.poisson2d(32),
        "p2d64": lambda: tamg.poisson2d(64),
        "p3d16": lambda: tamg.poisson3d(16),
    }[name]()


def _check_golden(name, device):
    with open(os.path.join(GOLD, f"resid_{name}.json")) as f:
        gold = json.load(f)
    a = _golden_matrix(name)
    assert gold["n_rows"] == a.n_rows
    ones = np.ones(a.n_rows)
    _, info = tamg.solver_amg(a, ones, ones, tamg.AMGParams(verbose=0),
                              device=device, **QUIET)
    assert info.nits == gold["nits"]
    np.testing.assert_allclose(info.residuals, gold["residuals"], rtol=1e-3)
    assert info.rres == pytest.approx(gold["rres"], rel=1e-3)
    assert info.rres < 1e-6


@pytest.mark.parametrize("name", ["1138_bus", "p2d32", "p2d64", "p3d16"])
def test_residual_history_golden(name):
    """Reference protocol (f64, GS everywhere, tol 1e-6, b = x0 = 1)."""
    _check_golden(name, "cpu")


def _slice_pars(pkg):
    """The main-path configuration (bench defaults without the formats
    not ported yet), scaled to a test-sized grid."""
    return pkg.AMGParams(
        dtype="float32", refine=True, accel="none",
        smoother=pkg.SmootherType.GS,
        coarse_smoother=pkg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="bfloat16", coarse_sparsify=0.005,
        sparsify_from_level=2, coarse_stop_rows=3500, tol=1e-8, max_it=60,
        **FLAGS)


@pytest.fixture(scope="module")
def jax_slice_run(tmp_path_factory):
    """amg_tpu's solve of the slice configuration at poisson3d(20), and its
    host hierarchy saved as a checkpoint."""
    a = jamg.poisson3d(20)
    solver = jamg.AMGSolver(a, _slice_pars(jamg), **QUIET)
    _, info = solver.solve(np.ones(a.n_rows))
    path = tmp_path_factory.mktemp("hh") / "p3d20.npz"
    jck.save_hierarchy(path, solver.host_hierarchy)
    return info, path


def _check_slice_run(info, jinfo, a, x):
    assert info.nits == jinfo.nits
    np.testing.assert_allclose(info.residuals, jinfo.residuals, rtol=1e-3,
                               atol=1e-6 * jinfo.residuals[0])
    true_rel = np.linalg.norm(np.ones(a.n_rows) - a.matvec(
        x.astype(np.float64))) / np.sqrt(a.n_rows)
    assert info.rres < 1e-8 and true_rel < 1e-8


def test_slice_matches_amg_tpu(jax_slice_run):
    jinfo, _ = jax_slice_run
    a = tamg.poisson3d(20)
    solver = tamg.AMGSolver(a, _slice_pars(tamg), **QUIET, **CPU)
    fmts = [type(l.a).__name__ for l in solver.mg.levels]
    assert fmts[0] == "Dia" and solver.mg.levels[0].gs_w is not None
    assert solver.a0_hi is not None and solver.a0_hi.vals.dtype == \
        torch.float64
    x, info = solver.solve(np.ones(a.n_rows))
    _check_slice_run(info, jinfo, a, x)


def test_carried_hierarchy(jax_slice_run):
    """A hierarchy built by amg_tpu, carried over through its checkpoint,
    solves like amg_tpu's own run."""
    jinfo, path = jax_slice_run
    a = tamg.poisson3d(20)
    hh = tamg.load_hierarchy(path)
    solver = tamg.AMGSolver(a, _slice_pars(tamg), host_hierarchy=hh,
                            **QUIET, **CPU)
    assert solver.host_hierarchy is hh
    x, info = solver.solve(np.ones(a.n_rows))
    _check_slice_run(info, jinfo, a, x)


SMOOTHERS = ["GS", "SGS", "SOR", "SSOR", "GSOR", "SGSOR", "JACOBI",
             "WJACOBI", "L1DIAG", "POLY", "CHEBYSHEV", "CG"]


@pytest.fixture(scope="module")
def packed_pairs():
    """Both packages' device hierarchies of the same host hierarchies, f64,
    GS-family groups on every level: 1138_bus with the Dense format off
    (level 0 an unpermuted Ell level: the gather group path; coarse levels
    color-permuted Ell: the range path), 1138_bus as is (Dense levels: the
    masked path on level 0, the dense range path below), poisson2d(24)
    (Dia levels: masked and fused group updates) and fem2d(5000) with
    WEll on (RCM level 0 and barycentric level 1 as f64 WEll: the masked
    path through the WEll product)."""
    from amg_tpu import hierarchy as jh
    from amg_tpu_torch import hierarchy as th

    out = {}
    path = os.path.join(DATA, "1138_bus.mtx")
    for name, aj, at, kw in (
            ("1138_bus-ell", jamg.read_mtx(path), tamg.read_mtx(path),
             dict(dense_level_bytes=0)),
            ("1138_bus", jamg.read_mtx(path), tamg.read_mtx(path), {}),
            ("p2d24", jamg.poisson2d(24), tamg.poisson2d(24), {}),
            ("fem2d-well", jamg.fem2d(5000, seed=9),
             tamg.fem2d(5000, seed=9),
             dict(use_well="on", well_min_rows=1024,
                  dense_level_bytes=2e7))):
        pj = jamg.AMGParams(relax=0.9, **{**FLAGS, **kw})
        pt = tamg.AMGParams(relax=0.9, **{**FLAGS, **kw})
        mj, _ = jh.setup(aj, pj, **QUIET)
        mt, _ = th.setup(at, pt, **QUIET, **CPU)
        out[name] = (mj, mt, pj, pt)
    return out


@pytest.mark.parametrize("smoother", SMOOTHERS)
@pytest.mark.parametrize("matrix", ["1138_bus-ell", "1138_bus", "p2d24",
                                    "fem2d-well"])
def test_smoothers_match_amg_tpu(packed_pairs, matrix, smoother):
    """Every smoother branch, pre and post, on levels 0 and 1 of the same
    packed hierarchy in both packages (amg_tpu's smoother run eagerly, no
    jit).  f64: ``atol = 1e-12 * max|result|`` (summation order only)."""
    import jax.numpy as jnp
    from amg_tpu.solve import smoothers as js
    from amg_tpu_torch.solve import smoothers as ts

    mj, mt, pj, pt = packed_pairs[matrix]
    pj = pj.replace(smoother=jamg.SmootherType[smoother])
    pt = pt.replace(smoother=tamg.SmootherType[smoother])
    rng = np.random.default_rng(7)
    kinds = set()
    for l in (0, 1):
        lj, lt = mj.levels[l], mt.levels[l]
        kinds.add(type(lt.a).__name__)
        x, b = (rng.standard_normal(lt.pad) for _ in range(2))
        x[lt.n:] = b[lt.n:] = 0.0
        for pre in (True, False):
            want = np.asarray(js.smooth(lj, jnp.asarray(x), jnp.asarray(b),
                                        pj, 2, pre))
            xt = torch.from_numpy(x)
            got = ts.smooth(lt, xt, torch.from_numpy(b), pt, 2, pre)
            assert np.array_equal(xt.numpy(), x)   # input left untouched
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-12 * np.abs(want).max())
    assert kinds == {"1138_bus-ell": {"Ell"}, "1138_bus": {"Dense"},
                     "p2d24": {"Dia"}, "fem2d-well": {"WEll"}}[matrix]


def _well_pars(pkg):
    """The unstructured main path (chip_smoke.py phase 8, bench.py's
    matrix-class defaults) at test size: fem2d(20000) with well_min_rows
    and the Dense budget lowered so that every level is WEll."""
    return pkg.AMGParams(
        dtype="float32", refine=True, accel="cg",
        smoother=pkg.SmootherType.GS,
        coarse_smoother=pkg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="float32", coarse_sparsify=0, coarse_stop_rows=3500,
        tol=1e-8, max_it=60, use_well="on", use_banded="off",
        embed_levels=0, well_min_rows=1024, dense_level_bytes=2e7,
        verbose=0)


def test_unstructured_slice_matches_amg_tpu():
    """The whole unstructured slice on the CPU against a live amg_tpu run:
    RCM level 0, WEll A/P/R on every level, masked GS on level 0 and
    Chebyshev below in f32, FCG in f64 through the df64 level-0 operator.
    FCG iteration counts equal within 1; residual histories at rtol 1e-3
    plus atol 1e-6 * ||b|| (the f32 rounding floor of the correction, as
    for the structured slice); both true residuals below 1e-8."""
    from amg_tpu_torch.ops import well_kernel

    ja = jamg.fem2d(20000, seed=17)
    b = np.random.default_rng(23).standard_normal(ja.n_rows)
    jsolver = jamg.AMGSolver(ja, _well_pars(jamg), **QUIET)
    jx, jinfo = jsolver.solve(b)

    a = tamg.fem2d(20000, seed=17)
    solver = tamg.AMGSolver(a, _well_pars(tamg), **QUIET, **CPU)
    assert all(isinstance(l.a, tamg.WEll) for l in solver.mg.levels)
    assert isinstance(solver.mg.levels[0].p, tamg.WEll)
    assert isinstance(solver.mg.levels[0].r, tamg.WEll)
    assert solver.staging.perm is not None
    np.testing.assert_array_equal(solver.staging.perm, jsolver._perm0)
    # level 0's f32 operator is the df64 operator's hi plane
    assert solver.a0_hi.vals_lo is not None
    assert solver.mg.levels[0].a.vals is solver.a0_hi.vals
    counts = dict(well_kernel.launches)
    x, info = solver.solve(b)
    assert well_kernel.launches == counts   # CPU: plain versions only

    assert abs(info.nits - jinfo.nits) <= 1
    n = min(len(info.residuals), len(jinfo.residuals))
    np.testing.assert_allclose(info.residuals[:n], jinfo.residuals[:n],
                               rtol=1e-3, atol=1e-6 * np.linalg.norm(b))
    for xv in (x, jx):
        true_rel = np.linalg.norm(b - a.matvec(np.asarray(
            xv, dtype=np.float64))) / np.linalg.norm(b)
        assert true_rel < 1e-8
    assert info.rres < 1e-8


def test_level0_permutation_round_trip():
    """A carried hierarchy whose level 0 was reordered (amg_tpu does this
    for WEll levels) solves in the caller's ordering: b is permuted on the
    way in and x un-permuted on the way out."""
    a = tamg.poisson2d(24)
    pars = tamg.AMGParams(verbose=0, tol=1e-10)
    hh = tamg.setup_host(a, pars, log=QUIET["log"])
    perm = np.random.default_rng(0).permutation(a.n_rows)
    inv = np.argsort(perm)
    hh.a[0] = hh.a[0].permute(perm)
    hh.p[0] = hh.p[0].permute_rows(perm)
    hh.r[0] = hh.r[0].permute_cols(inv)
    hh.cfmark[0] = hh.cfmark[0][perm]
    from amg_tpu_torch.hierarchy import reorder_for_gs

    reorder_for_gs(hh, pars)
    hh.perms[0] = perm
    b = np.random.default_rng(1).standard_normal(a.n_rows)
    x, info = tamg.AMGSolver(a, pars, host_hierarchy=hh, **QUIET,
                             **CPU).solve(b)
    assert info.rres < 1e-10
    assert np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b) < 1e-10


def _cli_lines(module, *flags):
    # one (virtual) device: amg_tpu then resolves use_well / use_banded on
    # "auto" as the port does
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    out = subprocess.run(
        [sys.executable, "-m", module, os.path.join(DATA, "1138_bus.mtx"),
         *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    # timing lines differ from run to run
    return [ln for ln in out.stdout.splitlines()
            if not ln.startswith(("AMG setup time", "AMG solve time",
                                  "AMG totally time"))]


def _assert_cli_match(got, want, numeric=("AMG residual:",
                                           "AMG relative residual:")):
    """The port's CLI lines against amg_tpu's: equal, but for the numbers
    of the residual rows and of the lines starting with ``numeric``, held
    to the goldens' rtol 1e-3."""
    assert len(got) == len(want)
    row = re.compile(r"^\s*\d+ \|")
    for g, w in zip(got, want):
        if g == w:
            continue
        assert row.match(w) or w.startswith(numeric), (g, w)
        gf, wf = g.replace("|", " ").split(), w.replace("|", " ").split()
        assert len(gf) == len(wf), (g, w)
        for a_, b_ in zip(gf, wf):
            try:
                np.testing.assert_allclose(float(a_), float(b_), rtol=1e-3)
            except ValueError:
                assert a_ == b_, (g, w)


def test_cli_matches_amg_tpu():
    """Same parameter echo, complexity table and residual table, both
    packages on their default flags ("auto").  Only the
    numbers of the residual rows and of the final residual lines may
    differ, in their last digits: both packages run the dense 1138_bus
    levels through a matmul, and XLA:CPU and torch sum in different orders
    (drift 1.8e-5 relative by iteration 12 on the machine the tests were
    written on).  Those numbers are held to the goldens' rtol 1e-3."""
    want = _cli_lines("amg_tpu")
    got = _cli_lines("amg_tpu_torch", "--device", "cpu")
    _assert_cli_match(got, want)
    assert got[-1] == "AMG iterations: 12"


@pytest.mark.parametrize("flags", [("--accel", "gmres"),
                                   ("--coarsest", "KRYLOV")])
def test_cli_krylov_matches_amg_tpu(flags):
    """``--accel gmres`` (GMRES preconditioned by one cycle; its summary
    line ``AMG-GMRES: N its, relres R``) and ``--coarsest KRYLOV`` (the
    reference's CG -> GMRES coarsest solver) on 1138_bus print amg_tpu's
    lines, to the bar of :func:`test_cli_matches_amg_tpu`."""
    want = _cli_lines("amg_tpu", *flags)
    got = _cli_lines("amg_tpu_torch", *flags, "--device", "cpu")
    _assert_cli_match(got, want, numeric=("AMG residual:",
                                          "AMG relative residual:",
                                          "AMG-GMRES:"))
    assert got[-1] == want[-1]


def test_cli_unstructured(monkeypatch, capsys):
    """README's unstructured example at the least size whose level 0 is
    WEll (``well_min_rows`` 65,536): ``--use-well on --accel cg`` packs
    level 0 as WEll and FCG reaches the tolerance; ``--accel gmres`` runs
    GMRES around the same f32 cycles."""
    from amg_tpu_torch import cli
    from amg_tpu_torch.solve import driver

    made = []

    class Recording(driver.AMGSolver):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(driver, "AMGSolver", Recording)
    flags = ["--use-well", "on", "--refine", "--dtype", "float32",
             "--device", "cpu", "--quiet", "--tol", "1e-8"]
    assert cli.main(["fem2d:66000", "--accel", "cg", *flags]) == 0
    out = capsys.readouterr().out
    rres = float(re.search(r"AMG relative residual: (\S+)", out).group(1))
    assert rres < 1e-8
    (solver,) = made
    assert solver.pars.accel == "cg"
    assert isinstance(solver.mg.levels[0].a, tamg.WEll)
    assert cli.main(["poisson2d:16", "--accel", "gmres", *flags]) == 0
    out = capsys.readouterr().out
    assert made[-1].pars.accel == "gmres"
    assert re.search(r"AMG iterations: [1-9]", out)


def test_port_never_imports_jax():
    """A solve, and a 2-shard SPMD solve through ``amg_tpu_torch.parallel``,
    on the CPU with no ``jax`` or ``amg_tpu`` module loaded."""
    code = ("import sys, numpy as np, amg_tpu_torch as amg\n"
            "a = amg.poisson2d(24)\n"
            "x, info = amg.solver_amg(a, None, np.ones(a.n_rows),\n"
            "    amg.AMGParams(verbose=0), log=lambda *a: None,\n"
            "    device='cpu')\n"
            "assert info.rres < 1e-6, info.rres\n"
            "from amg_tpu_torch.parallel import SpmdAMGSolver, make_mesh\n"
            "s = SpmdAMGSolver(a, amg.AMGParams(verbose=0),\n"
            "    mesh=make_mesh(2, device='cpu'), log=lambda *a: None)\n"
            "x, info = s.solve(np.ones(a.n_rows))\n"
            "assert info.rres < 1e-6 and s.E >= 1, info.rres\n"
            "assert 'jax' not in sys.modules\n"
            "assert not any(m.startswith('amg_tpu.') or m == 'amg_tpu'\n"
            "               for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_device_selection():
    """Every entry point runs on the card unless the caller asks for the
    CPU; without a card the default raises instead of falling back.  On
    the CPU, GMRES acceleration and the KRYLOV coarsest solver run."""
    from amg_tpu_torch import cli
    from amg_tpu_torch import hierarchy as th

    from amg_tpu_torch import parallel

    a = tamg.poisson2d(16)
    pars = tamg.AMGParams(verbose=0)
    b = np.ones(a.n_rows)
    default = {
        "AMGSolver": lambda: tamg.AMGSolver(a, pars),
        "solver_amg": lambda: tamg.solver_amg(a, None, b, pars),
        "setup": lambda: tamg.setup(a, pars),
        "to_device": lambda: th.to_device(tamg.setup_host(a, pars), pars),
        "cli": lambda: cli.main(["poisson2d:16", "--quiet"]),
        "SpmdAMGSolver": lambda: parallel.SpmdAMGSolver(a, pars),
        "make_mesh": lambda: parallel.make_mesh(2),
        "spmv_dia_ring": lambda: parallel.spmv_dia_ring(
            tamg.Dia.from_csr(a), np.ones(a.n_rows), parallel.make_mesh(2)),
        "initialize": lambda: parallel.initialize("localhost:1", 1, 0),
        "cli --devices": lambda: cli.main(["poisson2d:16", "--quiet",
                                           "--devices", "2"]),
    }
    if torch.cuda.is_available():
        assert tamg.AMGSolver(a, pars).device.type == "cuda"
        assert parallel.make_mesh(2).device.type == "cuda"
    else:
        for name, call in default.items():
            with pytest.raises(RuntimeError, match="cuda"):
                call()
    solver = tamg.AMGSolver(a, pars, device="cpu")
    assert solver.device == torch.device("cpu")
    assert all(l.a.vals.device.type == "cpu" for l in solver.mg.levels)
    for kw in (dict(accel="gmres"),
               dict(coarsest_solver=tamg.CoarsestSolver.KRYLOV)):
        _, info = tamg.AMGSolver(a, pars.replace(**kw), device="cpu",
                                 **QUIET).solve(b)
        assert info.rres < 1e-6, kw
