"""The port's general SPMD mode against amg_tpu's: unstructured
hierarchies on a ring of row shards.

* Ring products, on the CPU (each kernel's plain version), on fem2d(6000,
  seed=7) after RCM and 4 shards: B2's window entry on a square operator
  and on rectangular P- and R-shaped ones against amg_tpu's
  ``well_spmv_ring_local`` (its XLA path, and its Pallas kernel in
  interpret mode) at 2e-6 (f32), 1e-5 (bf16) and 1e-13 (f64) of max|Ax|,
  and equal bit for bit to the port's single-device product (the same
  kernel with col0 = 0, the same row sums in the same order); B3's window
  entry against ``well_spmv_ring_local_df64`` (exact f64 off a TPU: 1e-13;
  interpret mode 1e-5, ROADMAP queue C item 6); ``well_spmv_local_full``;
  the BandedBlocks ring against ``spmv_banded_ring`` on poisson2d(32) and
  8 shards.
* Placement: ``general_shard_depth`` and the boundary kind equal
  amg_tpu's, with ``use_banded`` on and off, on 4 and 8 shards.
* Solver: ``SpmdAMGSolver`` on 4 shards against amg_tpu's on both
  boundaries (ring R with ``use_banded="off"``, all-gather with "on"): in
  f64 equal iterations and x within 1e-10; in bench_dist.py's fem2d
  parameters (f32 cycles, FCG in f64 against the df64 operator)
  iterations within 1 and residual histories within rtol 1e-3 plus atol
  1e-6 * ||b|| (ROADMAP queue C items 3 and 7).  ``dense_level_bytes``
  is lowered in both packages so that the small problem keeps WEll
  levels (at its default fem2d(6000) would pack level 0 Dense).
* 2 gloo processes of 2 shards against 4 shards in one process.
* The CLI with ``--devices 4`` on fem2d:70000 (the least fem2d whose
  level 0 is WEll at the CLI's defaults) against amg_tpu's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

import amg_tpu as jamg
from amg_tpu import hierarchy as jh
from amg_tpu.parallel import halo as jhalo, make_mesh as jmake_mesh
from amg_tpu.parallel.spmd_cycle import (SpmdAMGSolver as JSpmd,
                                         general_shard_depth as jdepth)
from amg_tpu.sparse import (BandedBlocks as JBanded, CSR as JCSR,
                            WEll as JWEll)

import amg_tpu_torch as tamg
from amg_tpu_torch import hierarchy as th
from amg_tpu_torch.ops import spmv as tspmv, well_kernel
from amg_tpu_torch.parallel import SpmdAMGSolver, make_mesh
from amg_tpu_torch.parallel import halo as thalo
from amg_tpu_torch.parallel.dist import shard_well
from amg_tpu_torch.parallel.spmd_cycle import (general_shard_depth,
                                               ring_boundary)
from amg_tpu_torch.sparse import BandedBlocks, WEll

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_solve import _assert_cli_match
from test_torch_spmd import _cli, _free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log=lambda *a, **k: None)
TOL = {"float32": 2e-6, "bfloat16": 1e-5, "float64": 1e-13}
D = 4
PAD = 8 * 1024          # fem2d(6000)'s rows, padded to 2 groups per shard


def _mesh(n=D):
    return make_mesh(n, device="cpu")


@pytest.fixture(scope="module")
def fem_ops():
    """fem2d(6000, seed=7) after RCM (both packages' CSR), and its P- and
    R-shaped neighbours: every other column of it (6000 x 3000) and the
    transpose."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = jamg.fem2d(6000, seed=7)
    m = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    perm = np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True),
                      dtype=np.int64)
    m = m[perm][:, perm].tocsr()
    mats = {"A": m, "P": m[:, ::2].tocsr(), "R": m[:, ::2].T.tocsr()}
    return {k: JCSR(v.indptr, v.indices, v.data, v.shape)
            for k, v in mats.items()}


def _pads(op):
    """(pad_rows_to, pad_cols_to): 2 groups per shard on the A-sized side,
    1 on the other."""
    return {"A": (PAD, PAD), "P": (PAD, PAD // 2),
            "R": (PAD // 2, PAD)}[op]


def _packs(aj, op, kind):
    pr, pc = _pads(op)
    at = tamg.CSR(aj.indptr, aj.indices, aj.data, aj.shape)
    if kind == "df64":
        wj = JWEll.from_csr_df64(aj, pad_rows_to=pr, pad_cols_to=pc,
                                 ring_devices=D)
        wt = WEll.from_csr_df64(at, pad_rows_to=pr, pad_cols_to=pc,
                                ring_devices=D)
    else:
        wj = JWEll.from_csr(aj, dtype=jnp.dtype(kind), pad_rows_to=pr,
                            pad_cols_to=pc, ring_devices=D)
        wt = WEll.from_csr(at, dtype=getattr(torch, kind), pad_rows_to=pr,
                           pad_cols_to=pc, ring_devices=D)
    assert wt.ring_plan is not None and wt.ring_plan == wj.ring_plan
    return wj, wt


def _jax_ring(wj, x, df64=False, full=False, interpret=False):
    """amg_tpu's ring product under shard_map on its virtual devices: x
    (length pad_cols) sharded, or whole (``full``: the boundary
    prolongation)."""
    gspec = P("x", None, None, None)
    specs = JWEll(gspec, gspec, P("x", None), wj.shape, wj.nnz, wj.pad_cols,
                  None if wj.vals_lo is None else gspec, wj.ring_plan)
    lo128, hi128 = wj.ring_plan
    if full:
        fn = lambda wl, xl: jhalo.well_spmv_local_full(  # noqa: E731
            wl, xl, interpret=interpret)
    elif df64:
        fn = lambda wl, xl: jhalo.well_spmv_ring_local_df64(  # noqa: E731
            wl, xl, "x", D, lo128, hi128, interpret=interpret)
    else:
        fn = lambda wl, xl: jhalo.well_spmv_ring_local(  # noqa: E731
            wl, xl, "x", D, lo128, hi128, interpret=interpret)
    return np.asarray(shard_map(fn, mesh=jmake_mesh(D),
                                in_specs=(specs, P() if full else P("x")),
                                out_specs=P("x"), check_vma=False)(
        wj, jnp.asarray(x))).astype(np.float64)


def _x(n, kind, seed):
    dt = np.float64 if kind in ("float64", "df64") else np.float32
    return np.random.default_rng(seed).standard_normal(n).astype(dt)


# ---------------------------------------------------------------------------
# ring products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,op", [
    ("float32", "A"), ("float32", "P"), ("float32", "R"),
    ("bfloat16", "A"), ("float64", "A")])
def test_well_ring_matches_amg_tpu(fem_ops, kind, op):
    """B2's window entry (plain) on 4 shards against amg_tpu's ring product
    (XLA; the Pallas kernel in interpret mode on the square operator), and
    bit for bit against the port's single-device product: one launch over
    the process's row groups, x read at ``c - col0`` from the haloed
    block.  The rectangular P- and R-shaped operators (input blocks of
    another length than the output's) in f32."""
    wj, wt = _packs(fem_ops[op], op, kind)
    x = _x(wt.pad_cols, kind, seed=3)
    mesh = _mesh()
    well_kernel.launches["window"] = 0
    got = thalo.spmv_well_ring(wt, torch.from_numpy(x), mesh)
    assert got.shape == (D, wt.padded_rows // D)
    assert well_kernel.launches["window"] == 0      # plain on the CPU
    got = got.reshape(-1).double().numpy()
    single = well_kernel.spmv(wt, torch.from_numpy(x)).double().numpy()
    np.testing.assert_array_equal(got, single)
    xla = _jax_ring(wj, x)
    scale = np.abs(xla).max()
    np.testing.assert_allclose(got / scale, xla / scale, rtol=0,
                               atol=TOL[kind])
    if op == "A":
        pallas = _jax_ring(wj, x, interpret=True)
        np.testing.assert_allclose(got / scale, pallas / scale, rtol=0,
                                   atol=TOL[kind])


def test_well_ring_blocks_of_two_processes(fem_ops):
    """The blocks a process holds on a 2-process ring (rows numbered from
    the block's first, columns rebased to its haloed window) give the
    rows of the single-device product: each process's block is run
    against a window of x made as the ring makes it."""
    wj, wt = _packs(fem_ops["P"], "P", "float64")
    x = torch.from_numpy(_x(wt.pad_cols, "float64", seed=4))
    want = well_kernel.spmv(wt, x)
    lo128, hi128 = wt.ring_plan
    m_in, m_out = wt.pad_cols // D, wt.padded_rows // D
    for rank in range(2):
        mesh = make_mesh(D, device="cpu")
        mesh = type(mesh)(D, mesh.device, rank=rank, world=2)
        blk = shard_well(wt, mesh)
        assert blk.padded_rows == 2 * m_out and blk.rows.classes is False
        first = mesh.first * m_in
        lo, hi = lo128 * 128, hi128 * 128
        xp = torch.nn.functional.pad(x, (lo, hi))
        ext = xp[first:first + lo + 2 * m_in + hi]
        got = well_kernel.spmv_window(blk, ext, first - lo)
        np.testing.assert_array_equal(
            got.numpy(),
            want[rank * 2 * m_out:(rank + 1) * 2 * m_out].numpy())


def test_window_entries_check_their_inputs(fem_ops):
    """The window entries reject what B2/B3 do not take (as the
    single-device entries do); a ring product rejects an x block of
    another level (P and R read the other level's vector: a wrong col0
    would read the wrong x silently); an operator packed without a ring
    plan cannot take the ring, and ``well_shard_plan`` computes the plan
    amg_tpu's computes for it."""
    from amg_tpu.parallel.halo import well_shard_plan as jplan

    wj, wt = _packs(fem_ops["P"], "P", "float32")
    x = torch.zeros(wt.pad_cols)
    with pytest.raises(TypeError):
        well_kernel.spmv_window(wt, x.double(), 0)
    with pytest.raises(ValueError):
        well_kernel.spmv_window(wt, x[None], 0)
    with pytest.raises(ValueError, match="vals_lo"):
        well_kernel.spmv_df64_window(wt, x.double(), 0)
    with pytest.raises(ValueError, match="rows per shard"):
        thalo.well_spmv_ring_local(wt, torch.zeros(D, wt.padded_rows // D),
                                   _mesh())
    at = tamg.CSR(fem_ops["A"].indptr, fem_ops["A"].indices,
                  fem_ops["A"].data, fem_ops["A"].shape)
    w0 = WEll.from_csr(at, pad_rows_to=PAD, pad_cols_to=PAD)
    assert w0.ring_plan is None
    with pytest.raises(ValueError, match="ring plan"):
        thalo.well_spmv_ring_local(w0, torch.zeros(D, PAD // D), _mesh())
    plan = thalo.well_shard_plan(w0, D)
    assert plan == jplan(JWEll.from_csr(fem_ops["A"], dtype=jnp.float32,
                                        pad_rows_to=PAD, pad_cols_to=PAD), D)
    assert plan == _packs(fem_ops["A"], "A", "float32")[1].ring_plan


def test_df64_ring_matches_amg_tpu(fem_ops):
    """B3's window entry (plain) against amg_tpu's
    ``well_spmv_ring_local_df64``: its off-TPU path (exact f64) at 1e-13
    of max|Ax|, its Pallas df64 kernel in interpret mode at 1e-5; bit for
    bit against the port's single-device B3."""
    wj, wt = _packs(fem_ops["A"], "A", "df64")
    x = _x(wt.pad_cols, "df64", seed=5)
    mesh = _mesh()
    got = thalo.spmv_well_ring(wt, torch.from_numpy(x), mesh)
    assert got.dtype == torch.float64
    got = got.reshape(-1).numpy()
    np.testing.assert_array_equal(
        got, well_kernel.spmv_df64(wt, torch.from_numpy(x)).numpy())
    exact = _jax_ring(wj, x, df64=True)
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-13 * scale)
    pallas = _jax_ring(wj, x, df64=True, interpret=True)
    np.testing.assert_allclose(got / scale, pallas / scale, rtol=0,
                               atol=1e-5)


def test_well_local_full_matches_amg_tpu(fem_ops):
    """The boundary prolongation: P's sharded rows against the whole
    coarse vector (B2's window entry at col0 = 0), against amg_tpu's
    ``well_spmv_local_full``; x one coarse pad long and shorter."""
    wj, wt = _packs(fem_ops["P"], "P", "float32")
    blk = shard_well(wt, _mesh())
    for n_x in (wt.pad_cols, fem_ops["P"].shape[1]):
        x = _x(n_x, "float32", seed=6)
        got = thalo.well_spmv_local_full(blk, torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(
            got, well_kernel.spmv(wt, torch.from_numpy(x)).numpy())
        want = _jax_ring(wj, x, full=True)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_banded_ring_matches_amg_tpu(dtype):
    """tests/test_dist.py::test_banded_ring_spmv_matches_global's case:
    poisson2d(32) (8 block rows, nb = 1) on 8 shards, against amg_tpu's
    ``spmv_banded_ring`` and bit for bit against the port's single-device
    product."""
    from amg_tpu.parallel.halo import spmv_banded_ring as jring

    aj = jamg.poisson2d(32)
    at = tamg.poisson2d(32)
    bj = JBanded.from_csr(aj, dtype=jnp.dtype(dtype))
    bt = BandedBlocks.from_csr(at, dtype=getattr(torch, dtype))
    x = _x(bt.padded_rows, dtype, seed=7)
    got = thalo.spmv_banded_ring(bt, torch.from_numpy(x), _mesh(8))
    assert got.shape == (8, 128)
    got = got.reshape(-1).numpy()
    np.testing.assert_array_equal(
        got, tspmv.spmv_banded(bt, torch.from_numpy(x)).numpy())
    want = np.asarray(jring(bj, jnp.asarray(x), jmake_mesh(8)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=TOL[dtype])


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _fem_pars(pkg, **kw):
    return pkg.AMGParams(verbose=0, well_min_rows=1024,
                         dense_level_bytes=1 << 20,
                         coarse_smoother=pkg.SmootherType.CHEBYSHEV, **kw)


@pytest.mark.parametrize("ndev", [4, 8])
@pytest.mark.parametrize("banded", ["off", "on"])
def test_shard_depth_and_boundary_match_amg_tpu(banded, ndev):
    """Es and the boundary kind of fem2d(6000)'s hierarchy packed for an
    ``ndev`` ring equal amg_tpu's (amg_tpu's boundary test of
    ``_init_general``, ``spmd_cycle.py:656-658``)."""
    kw = dict(use_banded=banded, dist_devices=ndev)
    mj, _ = jh.setup(jamg.fem2d(6000, seed=11), _fem_pars(jamg, **kw),
                     **QUIET)
    mt, _ = th.setup(tamg.fem2d(6000, seed=11), _fem_pars(tamg, **kw),
                     **QUIET, device="cpu")
    es = general_shard_depth(mt, ndev)
    assert es == jdepth(mj, ndev) >= 1
    lj = mj.levels[es]
    assert ring_boundary(mt.levels[es]) == (
        isinstance(lj.r, JWEll) and lj.r.ring_plan is not None
        and isinstance(lj.p, JWEll))
    assert ring_boundary(mt.levels[es]) == (banded == "off")
    assert [type(lv.a).__name__ for lv in mt.levels] \
        == [type(lv.a).__name__ for lv in mj.levels]


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------


def _bench_dist_fem(pkg, banded):
    """bench_dist.py's fem2d parameters (``:136-145``)."""
    return _fem_pars(pkg, tol=1e-8, dtype="float32", refine=True,
                     coarse_op_dtype="float32", use_well="on",
                     accel="cg", use_banded=banded)


@pytest.mark.parametrize("prec", ["float64", "float32"])
@pytest.mark.parametrize("banded", ["off", "on"])
def test_general_solver_matches_amg_tpu(banded, prec):
    """The general mode on 4 shards against amg_tpu's on its virtual
    devices, on both boundaries (ring R with BandedBlocks off, all-gather
    with it on)."""
    b = np.random.default_rng(13).standard_normal(6000)
    if prec == "float64":
        pj, pt = (_fem_pars(pkg, tol=1e-10, use_banded=banded)
                  for pkg in (jamg, tamg))
    else:
        pj, pt = (_bench_dist_fem(pkg, banded) for pkg in (jamg, tamg))
    sj = JSpmd(jamg.fem2d(6000, seed=11), pj, mesh=jmake_mesh(D), **QUIET)
    xj, ij = sj.solve(b)
    st = SpmdAMGSolver(tamg.fem2d(6000, seed=11), pt, mesh=_mesh(), **QUIET)
    assert st.E == sj.E == 0 and st.Es == sj.Es >= 1
    assert st.ring_r == (banded == "off")
    lv0 = st.mg.levels[0]
    assert isinstance(lv0.a, WEll) and lv0.a.ring_plan is not None
    assert lv0.gid.shape == (D, st.m_local)
    if prec == "float32":
        # FCG against the df64 block; level 0 shares its structure
        assert st.a0_hi is not None and st.a0_hi.vals_lo is not None
        assert lv0.a.rows.cols is st.a0_hi.rows.cols
    xt, it = st.solve(b)
    if prec == "float64":
        assert it.nits == ij.nits and it.rres < 1e-10
        np.testing.assert_allclose(xt, xj, rtol=0,
                                   atol=1e-10 * np.abs(xj).max())
    else:
        assert abs(it.nits - ij.nits) <= 1 and it.rres < 1e-8
        n = min(len(it.residuals), len(ij.residuals))
        np.testing.assert_allclose(
            it.residuals[:n], ij.residuals[:n], rtol=1e-3,
            atol=1e-6 * np.linalg.norm(b))
        a = tamg.fem2d(6000, seed=11)
        r = b - a.matvec(xt)
        assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8


def test_two_gloo_processes_match_one(tmp_path):
    """2 gloo processes x 2 shards against 4 shards in one process, the
    general mode on fem2d(6000) in bench_dist.py's fem2d parameters:
    equal iterations, x within 1e-12 relative, every rank the whole x."""
    port, out = _free_port(), str(tmp_path / "x")
    env = dict(os.environ, PYTHONPATH=REPO)
    worker = os.path.join(REPO, "tests", "_torch_mh_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(port), str(r),
                               "2", str(D), out, "fem2d"], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
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
    from _torch_mh_worker import problem

    a, b, pars = problem("fem2d")
    s = SpmdAMGSolver(a, pars, mesh=_mesh(), **QUIET)
    assert s.E == 0 and s.Es >= 1
    x, info = s.solve(b)
    for g in got:
        assert g["x"].shape == (a.n_rows,)
        assert int(g["nits"]) == info.nits
        np.testing.assert_allclose(g["x"], x, rtol=0,
                                   atol=1e-12 * np.abs(x).max())
    np.testing.assert_array_equal(got[0]["x"], got[1]["x"])


def test_cli_general_mode_matches_amg_tpu():
    """``--devices 4 --dist auto`` on fem2d:70000 (Chebyshev smoothing, 4
    iterations: amg_tpu's program compiles for each smoother sweep) prints
    amg_tpu's lines under the rule of
    test_torch_solve.py::test_cli_matches_amg_tpu, plus the port's mesh
    line, which names the general mode and its boundary."""
    flags = ("fem2d:70000", "--devices", "4", "--dist", "auto",
             "--smoother", "CHEBYSHEV", "--max-it", "4")
    want = _cli("amg_tpu", *flags, devices=4)
    got = _cli("amg_tpu_torch", *flags, "--device", "cpu")
    assert want.returncode == 0, want.stderr
    assert got.returncode == 0, got.stderr
    assert "spmd path unavailable" not in want.stdout
    skip = ("AMG setup time", "AMG solve time", "AMG totally time")
    w = [ln for ln in want.stdout.splitlines() if not ln.startswith(skip)]
    g = [ln for ln in got.stdout.splitlines() if not ln.startswith(skip)]
    mesh = [ln for ln in g if ln.startswith("mesh: ")]
    assert len(mesh) == 1 and "general mode" in mesh[0], mesh
    _assert_cli_match([ln for ln in g if ln not in mesh], w)
    assert g[-1] == w[-1]
