"""The port's SPMD solve on a ring of row shards against amg_tpu's.

* Smoothers: ``_smooth_local`` on 4 shards for every ``SmootherType``
  against amg_tpu's single-device ``smooth`` on the same level 0 (amg_tpu's
  own test holds its shard_map smoother to that at rtol 1e-11).
* Solvers: the port's ``SpmdAMGSolver`` against amg_tpu's on its 8 virtual
  devices in the configurations of tests/test_dist.py: the cycle (equal
  iterations, x at rtol 1e-10: no dot in the cycle, and the boundary psum
  has one owner per entry), FCG (psum dots sum the shards' partials in
  another order, so iterations within 1 and x at rtol 1e-9, as amg_tpu
  holds its own), Chebyshev everywhere on the port alone.
* Multi-process: 2 gloo processes of 2 shards against the in-process 4
  shards (equal iterations, x within 1e-12 relative) and ``fetch``.
* CLI: ``--devices 4`` against amg_tpu's CLI; ``--dist gspmd`` and a
  hierarchy whose level 0 cannot be sharded run the GSPMD solver, as
  amg_tpu's CLI does; an unstructured hierarchy runs the general mode
  (tests/test_torch_spmd_general.py holds that mode against amg_tpu).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import amg_tpu as jamg
from amg_tpu import hierarchy as jh
from amg_tpu.parallel import make_mesh as jmake_mesh
from amg_tpu.parallel.spmd_cycle import SpmdAMGSolver as JSpmd
from amg_tpu.solve.smoothers import smooth as jsmooth

import amg_tpu_torch as tamg
from amg_tpu_torch import hierarchy as th
from amg_tpu_torch.parallel import (SpmdAMGSolver, fetch, make_mesh,
                                    shard_hierarchy, shard_vector)
from amg_tpu_torch.parallel import dist as tdist
from amg_tpu_torch.parallel.spmd_cycle import _smooth_local, num_embedded

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_solve import _assert_cli_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log=lambda *a, **k: None)


def _mesh(n):
    return make_mesh(n, device="cpu")


# ---------------------------------------------------------------------------
# smoothers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def p3d12_level0():
    """Level 0 of poisson3d(12) with embed_levels=8 in both packages (the
    port packed for 4 shards, whose pads here equal amg_tpu's)."""
    kw = dict(verbose=0, embed_levels=8, relax=0.9)
    mj, _ = jh.setup(jamg.poisson3d(12), jamg.AMGParams(**kw), **QUIET)
    pt = tamg.AMGParams(dist_devices=4, **kw)
    mt, _ = th.setup(tamg.poisson3d(12), pt, **QUIET, device="cpu")
    assert num_embedded(mt) >= 1
    assert mt.levels[0].pad == mj.levels[0].pad
    smg = shard_hierarchy(mt, _mesh(4), pt, replicate_from_level=1)
    return mj.levels[0], smg.levels[0], mt.levels[0].pad


@pytest.mark.parametrize("name", ["GS", "SOR", "SGS", "SSOR", "GSOR", "SGSOR",
                                  "CG", "JACOBI", "WJACOBI", "L1DIAG",
                                  "CHEBYSHEV"])
def test_smoother_matches_amg_tpu(p3d12_level0, name):
    """Every smoother, 2 sweeps, relax 0.9, on the sharded level 0."""
    lj, lt, pad = p3d12_level0
    rng = np.random.default_rng(41)
    x0, b0 = rng.standard_normal(pad), rng.standard_normal(pad)
    pj = jamg.AMGParams(verbose=0, embed_levels=8, relax=0.9,
                        smoother=jamg.SmootherType[name])
    want = np.asarray(jsmooth(lj, jnp.asarray(x0), jnp.asarray(b0), pj, 2,
                              pre=True))
    assert lt.rho_dinv_a == float(lj.rho_dinv_a)   # Chebyshev's estimate
    pt = tamg.AMGParams(verbose=0, embed_levels=8, relax=0.9,
                        smoother=tamg.SmootherType[name])
    mesh = _mesh(4)
    got = _smooth_local(lt, shard_vector(x0, mesh), shard_vector(b0, mesh),
                        pt, 2, True, mesh)
    np.testing.assert_allclose(got.reshape(-1).numpy(), want, rtol=1e-11,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------


def test_spmd_cycle_matches_amg_tpu():
    """tests/test_dist.py::test_spmd_cycle_matches_single_device's
    configuration: poisson3d(16), 8 shards, f64 cycles."""
    kw = dict(verbose=0, tol=1e-8, embed_levels=8)
    b = np.random.default_rng(29).standard_normal(4096)
    sj = JSpmd(jamg.poisson3d(16), jamg.AMGParams(
        coarse_smoother=jamg.SmootherType.CHEBYSHEV, **kw),
        mesh=jmake_mesh(8), **QUIET)
    xj, ij = sj.solve(b)
    a = tamg.poisson3d(16)
    st = SpmdAMGSolver(a, tamg.AMGParams(
        coarse_smoother=tamg.SmootherType.CHEBYSHEV, **kw), mesh=_mesh(8),
        **QUIET)
    assert st.E == sj.E >= 1 and st.pad == sj.pad
    xt, it = st.solve(b)
    assert it.rres < 1e-8 and it.nits == ij.nits
    np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-12)
    # the single-device port on the same hierarchy
    x1, i1 = tamg.AMGSolver(a, st.pars.replace(dist_devices=0),
                            device="cpu", **QUIET).solve(b)
    assert i1.nits == it.nits
    np.testing.assert_allclose(xt, x1, rtol=1e-10, atol=1e-12)


def test_spmd_fcg_matches_amg_tpu():
    """tests/test_dist.py::test_spmd_fcg_matches_single_device's
    configuration: FCG around f64 cycles on 8 shards, psum dots."""
    kw = dict(verbose=0, tol=1e-10, embed_levels=8, accel="cg",
              refine=True, coarse_sparsify=0.005, sparsify_from_level=2)
    b = np.random.default_rng(31).standard_normal(4096)
    sj = JSpmd(jamg.poisson3d(16), jamg.AMGParams(
        coarse_smoother=jamg.SmootherType.CHEBYSHEV, **kw),
        mesh=jmake_mesh(8), **QUIET)
    xj, ij = sj.solve(b)
    a = tamg.poisson3d(16)
    st = SpmdAMGSolver(a, tamg.AMGParams(
        coarse_smoother=tamg.SmootherType.CHEBYSHEV, **kw), mesh=_mesh(8),
        **QUIET)
    tdist.counts["psum"] = 0
    xt, it = st.solve(b)
    assert it.rres < 1e-10 and abs(it.nits - ij.nits) <= 1
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-12)
    r = b - a.matvec(xt)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-9
    assert tdist.counts["psum"] > 0


def test_spmd_chebyshev_everywhere():
    """tests/test_dist.py::test_spmd_cycle_chebyshev_everywhere on the port
    alone: Chebyshev on level 0 too, 4 shards, embedding forced on."""
    a = tamg.poisson2d(32)
    b = np.ones(a.n_rows)
    pars = tamg.AMGParams(verbose=0, smoother=tamg.SmootherType.CHEBYSHEV,
                          max_it=60)
    s = SpmdAMGSolver(a, pars, mesh=_mesh(4), **QUIET)
    assert s.pars.embed_levels == 8 and s.pars.dist_devices == 4
    x, info = s.solve(b)
    assert info.rres < 1e-6
    r = b - a.matvec(np.asarray(x, dtype=np.float64))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-6


@pytest.mark.parametrize("boundary", ["embedded", "compact"])
def test_spmd_boundaries_match_single_device(boundary):
    """Both embedded -> compact boundaries on 4 shards against the port's
    single-device solve: ``compact_idx`` (the embedded P/R sharded) and
    ``member_idx`` (the compact P/R replicated, applied to the gathered
    short vector); f64 cycles, equal iterations, x at rtol 1e-10."""
    a = tamg.poisson3d(14)
    b = np.random.default_rng(7).standard_normal(a.n_rows)
    pars = tamg.AMGParams(verbose=0, tol=1e-8, embed_levels=2,
                          embed_boundary=boundary,
                          coarse_smoother=tamg.SmootherType.CHEBYSHEV)
    s = SpmdAMGSolver(a, pars, mesh=_mesh(4), **QUIET)
    lv = s.mg.levels[s.E]
    assert (lv.compact_idx is not None) == (boundary == "embedded")
    assert (lv.member_idx is not None) == (boundary == "compact")
    x, info = s.solve(b)
    x1, i1 = tamg.AMGSolver(a, s.pars.replace(dist_devices=0), device="cpu",
                            **QUIET).solve(b)
    assert info.nits == i1.nits and info.rres < 1e-8
    np.testing.assert_allclose(x, x1, rtol=1e-10, atol=1e-12)


def test_general_mode_is_not_ported():
    """A hierarchy without fine-grid embedding (E = 0) runs amg_tpu's
    general mode: level 0 a row-sharded WEll operator, Es >= 1
    (tests/test_torch_spmd_general.py holds it against amg_tpu); one whose
    level 0 cannot be sharded (fem2d(3000) at the defaults: Dense) raises
    amg_tpu's ValueError."""
    pars = tamg.AMGParams(verbose=0, well_min_rows=1024,
                          dense_level_bytes=1 << 20)
    s = SpmdAMGSolver(tamg.fem2d(6000, seed=1), pars, mesh=_mesh(4), **QUIET)
    assert s.E == 0 and s.Es >= 1
    assert isinstance(s.mg.levels[0].a, tamg.WEll)
    assert s.mg.levels[0].gid.shape == (4, s.m_local)
    with pytest.raises(ValueError, match="ring-capable"):
        SpmdAMGSolver(tamg.fem2d(3000, seed=1), tamg.AMGParams(verbose=0),
                      mesh=_mesh(4), **QUIET)


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_match_one(tmp_path):
    """2 gloo processes x 2 shards against 4 shards in one process, FCG in
    f64 on poisson3d(12): equal iterations, x within 1e-12 relative, and
    ``fetch`` gives every rank the whole vector."""
    port, out = _free_port(), str(tmp_path / "x")
    env = dict(os.environ, PYTHONPATH=REPO)
    worker = os.path.join(REPO, "tests", "_torch_mh_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(port), str(r),
                               "2", "4", out], env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    got = [np.load(f"{out}.{r}.npz") for r in range(2)]

    a = tamg.poisson3d(12)
    b = np.random.default_rng(43).standard_normal(a.n_rows)
    pars = tamg.AMGParams(verbose=0, tol=1e-10, accel="cg",
                          coarse_smoother=tamg.SmootherType.CHEBYSHEV)
    x, info = SpmdAMGSolver(a, pars, mesh=_mesh(4), **QUIET).solve(b)
    for g in got:
        assert g["x"].shape == (a.n_rows,)
        assert int(g["nits"]) == info.nits
        np.testing.assert_allclose(g["x"], x, rtol=0,
                                   atol=1e-12 * np.abs(x).max())
    np.testing.assert_array_equal(got[0]["x"], got[1]["x"])


def test_fetch_in_one_process():
    mesh = _mesh(4)
    v = shard_vector(np.arange(12.0), mesh)
    np.testing.assert_array_equal(fetch(v, mesh), np.arange(12.0))
    np.testing.assert_array_equal(fetch(torch.arange(3.0)), [0.0, 1.0, 2.0])


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _cli(module, *flags, devices=1):
    return _python("-m", module, *flags, devices=devices)


def _python(*args, devices=1):
    # one OpenMP thread: the suite's workers share the machine's cores
    # (tests/_torch_threads.py)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    out = subprocess.run([sys.executable, *args], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    return out


# the port's CLI with use_banded="on" (amg_tpu's band rule), set through
# its Python API: the CLI has no flag for it
_CLI_BANDED_ON = (
    "import sys; from amg_tpu_torch import cli; "
    "f = cli.params_from_args; "
    "cli.params_from_args = lambda a: f(a).replace(use_banded='on'); "
    "sys.exit(cli.main(sys.argv[1:]))")


def _cli_banded_on(*flags):
    return _python("-c", _CLI_BANDED_ON, *flags)


def test_cli_devices_matches_amg_tpu():
    """``--devices 4 --device cpu`` on poisson3d:16 prints amg_tpu's lines
    (``--devices 4`` on 4 virtual devices) under the rule of
    test_torch_solve.py::test_cli_matches_amg_tpu; the port adds one line,
    its mesh (shards, processes, device)."""
    want = _cli("amg_tpu", "poisson3d:16", "--devices", "4", devices=4)
    got = _cli("amg_tpu_torch", "poisson3d:16", "--devices", "4",
               "--device", "cpu")
    assert want.returncode == 0, want.stderr
    assert got.returncode == 0, got.stderr
    skip = ("AMG setup time", "AMG solve time", "AMG totally time")
    w = [ln for ln in want.stdout.splitlines() if not ln.startswith(skip)]
    g = [ln for ln in got.stdout.splitlines() if not ln.startswith(skip)]
    mesh = [ln for ln in g if ln.startswith("mesh: ")]
    assert mesh == ["mesh: 4 shards, 1 process, cpu; levels 0..1 "
                    "row-sharded, 1024 rows per shard; steps: static "
                    "buffers, run eagerly"]
    _assert_cli_match([ln for ln in g if ln not in mesh], w)
    assert g[-1] == w[-1]


def test_cli_dist_paths_not_ported():
    """The multi-device paths of amg_tpu/cli.py:221-240: ``--dist gspmd``
    solves with the GSPMD solver (poisson2d:16); ``--dist auto`` on
    fem2d:3000 (Dense level 0, which the SPMD solver cannot shard) prints
    amg_tpu's fallback line and solves with it, printing amg_tpu's lines
    under the rule of test_torch_solve.py::test_cli_matches_amg_tpu
    (amg_tpu on one virtual device, where its "auto" packs what the port
    packs with ``use_banded="on"``, set through the port's Python API: on
    four it resolves BandedBlocks off and its table drifts 3e-3 from the
    port's, as the port's "auto", which keeps fewer bands, drifts
    1.7e-3); ``--dist spmd`` there raises
    SpmdAMGSolver's ValueError; fem2d:70000 (WEll level 0) with ``--dist
    auto`` solves in the general mode."""
    out = _cli("amg_tpu_torch", "poisson2d:16", "--dist", "gspmd",
               "--devices", "4", "--device", "cpu", "--quiet")
    assert out.returncode == 0, out.stderr
    assert "AMG iterations" in out.stdout
    want = _cli("amg_tpu", "fem2d:3000", "--devices", "4", devices=1)
    got = _cli_banded_on("fem2d:3000", "--devices", "4", "--device", "cpu")
    assert want.returncode == 0, want.stderr
    assert got.returncode == 0, got.stderr
    skip = ("AMG setup time", "AMG solve time", "AMG totally time")
    w = [ln for ln in want.stdout.splitlines() if not ln.startswith(skip)]
    g = [ln for ln in got.stdout.splitlines() if not ln.startswith(skip)]
    fallback = [ln for ln in g if ln.startswith("# spmd path unavailable")]
    assert fallback == [ln for ln in w
                        if ln.startswith("# spmd path unavailable")]
    assert fallback[0].endswith("; using the GSPMD solver")
    mesh = [ln for ln in g if ln.startswith("mesh: ")]
    assert mesh == ["mesh: 4 shards, 1 process, cpu; every level "
                    "replicated (GSPMD); steps: static buffers, run "
                    "eagerly"]
    _assert_cli_match([ln for ln in g if ln not in mesh], w)
    out = _cli("amg_tpu_torch", "fem2d:3000", "--devices", "4", "--dist",
               "spmd", "--device", "cpu", "--quiet")
    assert out.returncode != 0
    assert "ValueError: SpmdAMGSolver requires" in out.stderr
    out = _cli("amg_tpu_torch", "fem2d:70000", "--devices", "4", "--dist",
               "auto", "--device", "cpu", "--smoother", "CHEBYSHEV",
               "--tol", "1e-3")
    assert out.returncode == 0, out.stderr
    assert "general mode" in out.stdout
    rres = [ln for ln in out.stdout.splitlines()
            if ln.startswith("AMG relative residual: ")]
    assert len(rres) == 1 and float(rres[0].split(": ")[1]) < 1e-3
