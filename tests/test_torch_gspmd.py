"""The port's GSPMD solver (``DistAMGSolver``), ``make_host_mesh`` and the
device PMIS splitter against amg_tpu's, on the CPU.

* Products: the port's product of a GSPMD row-sharded operator
  (``gspmd_spmv``: the ring on Dia and BandedBlocks, the all-gather
  product on Ell, Dense and WEll) on 4 and 8 shards, square and P/R-shaped
  operators, f32, bf16 and f64 values, pads that the shard count does not
  divide included: equal bit for bit to the port's single-device plain
  product, and to amg_tpu's sharded ``spmv`` (its operator placed as its
  ``shard_hierarchy`` places it, on its virtual devices) within 2e-6 /
  1e-5 / 1e-13 of max|Ax|.
* Placement: ``shard_hierarchy(..., gspmd=True)`` shards and replicates
  the levels amg_tpu's ``shard_hierarchy`` does (poisson2d, poisson3d,
  fem2d), at a ``coarse_replicate_nnz`` low enough that levels shard at
  these sizes (at the default of 65,536 every level here replicates).
* Solvers: the cases of tests/test_dist.py:50-122 and an Ell, a WEll and
  a Dense level 0, each against amg_tpu's ``DistAMGSolver`` with levels
  really sharded; the kept behaviour that neither runs Krylov
  acceleration; an embedded hierarchy against the port's one device.
* ``krylov.cg`` with ``psum`` on a row-sharded Ell (tests/test_dist.py:
  79-104); two gloo processes against one; ``make_host_mesh``;
  ``pmis_split_device`` bit for bit against amg_tpu's given amg_tpu's
  permutation, valid on its own stream, and taken by ``setup_host`` from
  262,144 rows.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import amg_tpu as jamg
from amg_tpu import hierarchy as jh
from amg_tpu.ops.spmv import spmv as jspmv
from amg_tpu.parallel import (DistAMGSolver as JDist, make_mesh as jmake_mesh,
                              shard_hierarchy as jshard_hierarchy,
                              shard_vector as jshard_vector)
from amg_tpu.parallel.dist import (_pad_dia_multiple, _pad_rows_multiple,
                                   _row_sharding)
from amg_tpu.parallel.multihost import make_host_mesh as jmake_host_mesh
from amg_tpu.setup_phase import cf_split as jcf
from amg_tpu.setup_phase.strength import strength_matrix as jstrength
from amg_tpu import sparse as jsp

import amg_tpu_torch as tamg
from amg_tpu_torch import hierarchy as th
from amg_tpu_torch.ops.spmv import spmv as tspmv
from amg_tpu_torch.params import CGPT, FGPT, ISPT, UNPT
from amg_tpu_torch.parallel import (DistAMGSolver, make_host_mesh, make_mesh,
                                    shard_hierarchy, shard_vector)
from amg_tpu_torch.parallel.dist import gspmd_depth, shard_matrix
from amg_tpu_torch.parallel.spmd_cycle import gspmd_spmv
from amg_tpu_torch.setup_phase import cf_split as tcf
from amg_tpu_torch.setup_phase.strength import strength_matrix
from amg_tpu_torch.solve.krylov import cg

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_spmd import _free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log=lambda *a, **k: None)
TOL = {"float32": 2e-6, "bfloat16": 1e-5, "float64": 1e-13}


def _mesh(n):
    return make_mesh(n, device="cpu")


def _jpars(**kw):
    """amg_tpu's AMGParams of the port's keyword arguments."""
    return jamg.AMGParams(**{k: (jamg.SmootherType[v.name]
                                 if isinstance(v, tamg.SmootherType) else v)
                             for k, v in kw.items()})


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def _csr_pair(m):
    """A scipy matrix as (amg_tpu CSR, port CSR)."""
    return (jsp.CSR(m.indptr, m.indices, m.data, m.shape),
            tamg.CSR(m.indptr, m.indices, m.data, m.shape))


@pytest.fixture(scope="module")
def operators():
    """Host matrices of the product cases: poisson2d(10) and its every-other
    column P (100 x 50) and R (50 x 100) for Ell, Dense and Dia (packed
    with row_multiple 1: pads of 100 and 50, which 8 shards do not
    divide); poisson2d(32) for BandedBlocks; fem2d(16000, seed=2) with its
    P- and R-shaped neighbours for WEll (16, 16 and 8 row groups)."""
    import scipy.sparse as sp

    def mats(a):
        m = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
        return {"A": m, "P": m[:, ::2].tocsr(), "R": m[:, ::2].T.tocsr()}

    return {"small": mats(jamg.poisson2d(10)),
            "banded": {"A": mats(jamg.poisson2d(32))["A"]},
            "well": mats(jamg.fem2d(16000, seed=2))}


def _pack(fmt, m, dtype):
    """(amg_tpu operator, port operator, x length) of one case."""
    aj, at = _csr_pair(m)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    if fmt in ("ell", "dense", "dia"):
        kw = dict(row_multiple=1)
        if fmt == "dense":
            kw["pad_cols_to"] = m.shape[1]
        cls = {"ell": (jsp.Ell, tamg.Ell), "dense": (jsp.Dense, tamg.Dense),
               "dia": (jsp.Dia, tamg.Dia)}[fmt]
        mt = cls[1].from_csr(at, dtype=tdt, **kw)
        # a Dense operator reads x up to its 128-padded columns
        n_x = mt.padded_cols if fmt == "dense" else m.shape[1]
        return cls[0].from_csr(aj, dtype=jdt, **kw), mt, n_x
    if fmt == "banded":
        return (jsp.BandedBlocks.from_csr(aj, dtype=jdt),
                tamg.BandedBlocks.from_csr(at, dtype=tdt), m.shape[1])
    pr, pc = (-(-n // 1024) * 1024 for n in m.shape)
    return (jsp.WEll.from_csr(aj, dtype=jdt, pad_rows_to=pr, pad_cols_to=pc),
            tamg.WEll.from_csr(at, dtype=tdt, pad_rows_to=pr, pad_cols_to=pc),
            pc)


def _jax_sharded_spmv(mj, x, D):
    """amg_tpu's product of ``mj`` placed as its ``shard_hierarchy`` places
    a sharded level's operator (``dist.py:145-233``), x row-sharded."""
    mesh = jmake_mesh(D)
    if isinstance(mj, jsp.Dia):
        d = _pad_dia_multiple(mj, D)
        ms = jsp.Dia(jax.device_put(d.vals, NamedSharding(mesh, P(None, "x"))),
                      d.offsets, d.shape, d.nnz)
    elif isinstance(mj, jsp.Dense):
        vals = jnp.pad(mj.vals, ((0, -mj.padded_rows % D), (0, 0)))
        ms = jsp.Dense(jax.device_put(vals, _row_sharding(mesh, 2)),
                        mj.shape, mj.nnz)
    elif isinstance(mj, jsp.BandedBlocks):
        spec = P("x", None, None, None) if mj.vals.shape[0] % D == 0 else P()
        ms = jsp.BandedBlocks(jax.device_put(mj.vals,
                                              NamedSharding(mesh, spec)),
                               mj.nb, mj.shape, mj.nnz)
    elif isinstance(mj, jsp.WEll):
        g = NamedSharding(mesh, P("x", None, None, None))
        ms = jsp.WEll(jax.device_put(mj.vals, g), jax.device_put(mj.loc, g),
                       jax.device_put(mj.base, NamedSharding(mesh, P("x", None))),
                       mj.shape, mj.nnz, mj.pad_cols)
    else:
        e = _pad_rows_multiple(mj, D)
        ms = jsp.Ell(jax.device_put(e.cols, _row_sharding(mesh, 2)),
                      jax.device_put(e.vals, _row_sharding(mesh, 2)),
                      e.shape, e.nnz)
    return np.asarray(jax.jit(jspmv)(ms, jshard_vector(x, mesh)))


PRODUCTS = [(f, s) for f in ("ell", "dense", "well") for s in "APR"] \
    + [("dia", "A"), ("banded", "A")]


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("fmt,shape", PRODUCTS)
def test_gspmd_product(operators, fmt, shape, dtype, D):
    """The GSPMD product of one row-sharded operator: bit for bit the
    single-device plain product, within TOL of amg_tpu's sharded spmv."""
    group = {"well": "well", "banded": "banded"}.get(fmt, "small")
    mj, mt, n_x = _pack(fmt, operators[group][shape], dtype)
    xdt = np.float64 if dtype == "float64" else np.float32
    n_in = -(-n_x // D) * D
    x = np.zeros(n_in, dtype=xdt)
    x[:operators[group][shape].shape[1]] = \
        np.random.default_rng(len(PRODUCTS) * D).standard_normal(
            operators[group][shape].shape[1])
    mesh = _mesh(D)
    xt = torch.from_numpy(x)
    got = gspmd_spmv(shard_matrix(mt, mesh, gspmd=True),
                     shard_vector(xt, mesh), mesh).reshape(-1)
    pad = mt.padded_rows
    want = tspmv(mt, xt[: n_x] if fmt != "ell" else xt)
    assert got.shape[0] == -(-pad // D) * D
    assert torch.equal(got[:pad], want)
    assert not got[pad:].any()
    jwant = _jax_sharded_spmv(mj, x, D)[:pad].astype(np.float64)
    scale = np.abs(jwant).max()
    np.testing.assert_allclose(got[:pad].double().numpy(), jwant, rtol=0,
                               atol=TOL[dtype] * scale)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


CUT_CASES = {
    "poisson2d": (lambda m: m.poisson2d(48), 8, 2000),
    "poisson3d": (lambda m: m.poisson3d(14), 4, 20000),
    "fem2d": (lambda m: m.fem2d(4000, seed=1), 4, 8000),
}


@pytest.mark.parametrize("name", sorted(CUT_CASES))
def test_replication_cut_matches_amg_tpu(name):
    """The levels ``shard_hierarchy(..., gspmd=True)`` shards, and those it
    replicates, are amg_tpu's (its rule, ``dist.py:252-256``); the GSPMD
    solver's sharded prefix is the leading run of them above the coarsest
    level."""
    mk, D, thresh = CUT_CASES[name]
    kw = dict(verbose=0, use_well="off", use_banded="off",
              coarse_replicate_nnz=thresh)
    mj, _ = jh.setup(mk(jamg), _jpars(**kw), **QUIET)
    pt = tamg.AMGParams(**kw)
    mt, _ = th.setup(mk(tamg), pt, **QUIET, device="cpu")
    want = [not jax.tree_util.tree_leaves(lv.a)[0].sharding
            .is_fully_replicated
            for lv in jshard_hierarchy(mj, jmake_mesh(D), _jpars(**kw)).levels]
    sh = shard_hierarchy(mt, _mesh(D), pt, gspmd=True)
    got = [s is not lv for s, lv in zip(sh.levels, mt.levels)]
    assert got == want
    assert True in got and False in got
    lead = next(i for i, s in enumerate(got + [False]) if not s)
    assert gspmd_depth(mt, _mesh(D), pt) == min(lead, mt.num_levels - 1) - 1


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------


def _solve_both(mk, D, kw, b=None, jb_perm=False):
    """amg_tpu's DistAMGSolver and the port's on D shards of the same
    matrix.  amg_tpu's solver ignores a level-0 permutation (an RCM-ordered
    WEll level 0): with ``jb_perm`` it gets b in that order and its x is
    mapped back (the port maps both itself)."""
    at = mk(tamg)
    b = np.ones(at.n_rows) if b is None else b
    st = DistAMGSolver(at, tamg.AMGParams(**kw), mesh=_mesh(D), **QUIET)
    xt, it = st.solve(b)
    sj = JDist(mk(jamg), _jpars(**kw), mesh=jmake_mesh(D), **QUIET)
    perm = st.host_hierarchy.perms[0] if jb_perm else None
    xj, ij = sj.solve(b[perm] if jb_perm else b)
    if jb_perm:
        x = np.empty_like(xj)
        x[perm] = xj
        xj = x
    rres = np.linalg.norm(b - at.matvec(xt)) / np.linalg.norm(b)
    return st, xt, it, xj, ij, rres


def test_l1diag_4_shards_no_krylov():
    """tests/test_dist.py:50-62: L1DIAG on 4 shards, iterations within 1
    and x within rtol 1e-8 of amg_tpu's; with ``accel="cg"`` both
    packages run plain cycles (neither DistAMGSolver has a Krylov
    wrapper), so the port's x equals its ``accel="none"`` solve."""
    kw = dict(verbose=0, smoother=tamg.SmootherType.L1DIAG,
              coarse_replicate_nnz=200, accel="cg")
    st, xt, it, xj, ij, rres = _solve_both(lambda m: m.poisson2d(24), 4, kw)
    assert st.Es >= 1 and rres < 1e-6
    assert abs(it.nits - ij.nits) <= 1
    np.testing.assert_allclose(xt, xj, rtol=1e-8, atol=1e-10)
    x2, i2 = DistAMGSolver(tamg.poisson2d(24), tamg.AMGParams(
        **dict(kw, accel="none")), mesh=_mesh(4), **QUIET).solve(
        np.ones(576))
    assert i2.nits == it.nits and np.array_equal(x2, xt)
    assert not hasattr(DistAMGSolver, "solve_pcg")
    assert not hasattr(JDist, "solve_pcg")


def test_gs_8_shards():
    """tests/test_dist.py:65-76: GS on 8 shards (masked per colour on the
    sharded levels), equal iterations, x within rtol 1e-8."""
    kw = dict(verbose=0, coarse_replicate_nnz=200)
    st, xt, it, xj, ij, rres = _solve_both(lambda m: m.poisson2d(16), 8, kw)
    assert st.Es >= 1 and rres < 1e-6
    assert it.nits == ij.nits
    np.testing.assert_allclose(xt, xj, rtol=1e-8, atol=1e-10)


def test_refine_f32_8_shards():
    """tests/test_dist.py:107-122: f32 cycles with f64 defect correction on
    poisson3d(10), 8 shards: ``a0_hi`` row-sharded, equal iterations, a
    true rres below 1e-10."""
    kw = dict(verbose=0, tol=1e-10, dtype="float32", refine=True,
              coarse_smoother=tamg.SmootherType.CHEBYSHEV,
              coarse_replicate_nnz=500)
    b = np.random.default_rng(4).standard_normal(1000)
    st, xt, it, xj, ij, rres = _solve_both(lambda m: m.poisson3d(10), 8, kw,
                                           b=b)
    assert st.Es >= 0 and isinstance(st.a0_hi, tamg.Dia)
    assert st.a0_hi.vals.shape[1] == st.pad
    assert rres < 1e-10 and it.nits == ij.nits


@pytest.mark.parametrize("case", ["ell", "well", "dense"])
def test_level0_formats(case):
    """An Ell level 0 (fem2d, WEll and dense levels off), a WEll level 0
    (fem2d after RCM, 2 shards: amg_tpu's groups sharding needs every
    sharded WEll operator's row groups to split), a Dense level 0
    (1138_bus): sharded, equal iterations, x within rtol 1e-8 of
    amg_tpu's."""
    mk, D, kw = {
        "ell": (lambda m: m.fem2d(2000, seed=3), 4, dict(
            use_well="off", use_banded="off", dense_level_bytes=1 << 16,
            smoother=tamg.SmootherType.CHEBYSHEV,
            coarse_replicate_nnz=3000)),
        "well": (lambda m: m.fem2d(8000, seed=3), 2, dict(
            use_well="on", use_banded="off", well_min_rows=1024,
            dense_level_bytes=1 << 20,
            smoother=tamg.SmootherType.CHEBYSHEV,
            coarse_replicate_nnz=35000)),
        "dense": (lambda m: m.read_mtx(os.path.join(REPO, "tests", "data",
                                                    "1138_bus.mtx")), 4,
                  dict(coarse_replicate_nnz=1000)),
    }[case]
    st, xt, it, xj, ij, rres = _solve_both(mk, D, dict(verbose=0, **kw),
                                           jb_perm=case == "well")
    fmt = {"ell": tamg.Ell, "well": tamg.WEll, "dense": tamg.Dense}[case]
    assert isinstance(st.mg.levels[0].a, fmt) and st.Es >= 1
    assert rres < 1e-6 and it.nits == ij.nits
    np.testing.assert_allclose(xt, xj, rtol=1e-8,
                               atol=1e-10 * np.abs(xj).max())


def test_embedded_hierarchy_matches_single_device():
    """An explicit fine-grid-embedded hierarchy (``embed_levels=8``): the
    levels above the boundary level shard, Dia P at the boundary runs
    against the whole coarse vector; f64 equal iterations and x within
    1e-10 of the port's one device on the same packing."""
    a = tamg.poisson3d(12)
    pars = tamg.AMGParams(verbose=0, embed_levels=8, coarse_replicate_nnz=0,
                          coarse_smoother=tamg.SmootherType.CHEBYSHEV)
    b = np.random.default_rng(7).standard_normal(a.n_rows)
    st = DistAMGSolver(a, pars, mesh=_mesh(4), **QUIET)
    assert st.Es >= 0
    x, info = st.solve(b)
    x1, i1 = tamg.AMGSolver(a, st.pars, device="cpu", **QUIET).solve(b)
    assert info.nits == i1.nits
    np.testing.assert_allclose(x, x1, rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# cg, processes, host mesh
# ---------------------------------------------------------------------------


def test_cg_psum_row_sharded_ell():
    """tests/test_dist.py:79-104: ``krylov.cg`` over a row-sharded Ell of
    poisson2d(16) on 8 shards (all-gather products, psum dots) reaches
    x_true within 1e-6."""
    a = tamg.poisson2d(16)
    mesh = _mesh(8)
    e = shard_matrix(tamg.Ell.from_csr(a), mesh, gspmd=True)
    rng = np.random.default_rng(1)
    x_true = rng.standard_normal(a.n_rows)
    bs = shard_vector(a.matvec(x_true), mesh, pad_to=256)
    x, conv = cg(lambda v: gspmd_spmv(e, v, mesh), bs, torch.zeros_like(bs),
                 tol=1e-10, maxit=800, psum=mesh.psum)
    assert bool(conv)
    np.testing.assert_allclose(x.reshape(-1)[: a.n_rows].numpy(), x_true,
                               rtol=1e-6, atol=1e-7)


def test_two_gloo_processes_match_one(tmp_path):
    """The port's analog of tests/test_multihost.py:73-100: 2 gloo
    processes x 2 shards run DistAMGSolver as 4 shards in one process do:
    equal iterations, x within 1e-12 relative."""
    from _torch_mh_worker import problem

    port, out = _free_port(), str(tmp_path / "x")
    env = dict(os.environ, PYTHONPATH=REPO)
    worker = os.path.join(REPO, "tests", "_torch_mh_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(port), str(r),
                               "2", "4", out, "dist"], env=env, cwd=REPO,
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
    a, b, pars = problem("dist")
    s = DistAMGSolver(a, pars, mesh=_mesh(4), **QUIET)
    assert s.Es >= 1
    x, info = s.solve(b)
    for g in got:
        assert int(g["nits"]) == info.nits
        np.testing.assert_allclose(g["x"], x, rtol=0,
                                   atol=1e-12 * np.abs(x).max())


def test_make_host_mesh_matches_amg_tpu():
    """``(processes, shards per process)``, axes ("host", "chip"): amg_tpu's
    shape at 8 virtual devices, (1, 8)."""
    want = jmake_host_mesh()
    got = make_host_mesh(_mesh(8))
    assert tuple(got.shape.items()) == tuple(want.shape.items()) \
        == (("host", 1), ("chip", 8))
    assert got.ids.tolist() == [list(range(8))]


# ---------------------------------------------------------------------------
# device PMIS
# ---------------------------------------------------------------------------


def _isolated_graph():
    """poisson2d(12) with rows 5 and 40 decoupled (no strong links) and row
    77 with only a strong dependent: ISPT and FGPT starts."""
    import scipy.sparse as sp

    a = jamg.poisson2d(12)
    m = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape).tolil()
    for i in (5, 40):
        for j in m.rows[i][:]:
            if j != i:
                m[i, j] = 0.0
                m[j, i] = 0.0
    for j in m.rows[77][:]:
        if j != 77:
            m[77, j] = 0.0
    m = m.tocsr()
    m.eliminate_zeros()
    return m


PMIS_CASES = {
    "poisson2d": lambda: jamg.poisson2d(64),
    "fem2d": lambda: jamg.fem2d(20000, seed=0),
    "isolated": lambda: _csr_pair(_isolated_graph())[0],
}


@pytest.mark.parametrize("name", sorted(PMIS_CASES))
def test_pmis_device_matches_amg_tpu(name, monkeypatch):
    """With amg_tpu's ``jax.random.permutation(PRNGKey(42), n)`` in place
    of the port's stream, the partition equals amg_tpu's
    ``pmis_split_device`` bit for bit."""
    aj = PMIS_CASES[name]()
    at = tamg.CSR(aj.indptr, aj.indices, aj.data, aj.shape)
    want, col_j = jcf.pmis_split_device(jstrength(aj))
    monkeypatch.setattr(tcf, "pmis_permutation", lambda n, seed: np.asarray(
        jax.random.permutation(jax.random.PRNGKey(seed), n)))
    got, col_t = tcf.pmis_split_device(strength_matrix(at), device="cpu")
    assert col_t == col_j
    np.testing.assert_array_equal(got, want)
    if name == "isolated":
        assert got[[5, 40, 77]].tolist() == [ISPT, ISPT, FGPT]


def test_pmis_device_valid_on_its_own_stream():
    """tests/test_setup.py:362's checks on the port's permutation: every
    point decided, every F point with strong dependencies has a C point
    among them, a coarse fraction within 2x of the host splitter's."""
    for a in (tamg.poisson2d(24), tamg.fem2d(1500, seed=5)):
        s = strength_matrix(a)
        vec, col = tcf.pmis_split_device(s, device="cpu")
        assert col == (vec == CGPT).sum() > 0
        assert not (vec == UNPT).any()
        rows, cols = s.row_indices, s.indices.astype(np.int64)
        covered = np.zeros(s.n_rows, dtype=bool)
        covered[rows[vec[cols] == CGPT]] = True
        f = vec == FGPT
        assert covered[f & (s.row_degrees > 0)].all()
        assert 0.5 < col / max(tcf.pmis_split(s)[1], 1) < 2.0


def test_setup_host_takes_device_pmis_from_262144_rows(monkeypatch):
    """``setup_host`` with PMIS calls ``pmis_split_device`` (on its
    ``device``) at 262,144 rows (poisson2d(512)) and the host splitter at
    261,121 (poisson2d(511)), as amg_tpu/hierarchy.py:211-217."""
    calls = []
    real = tcf.pmis_split_device

    def spy(s, seed=42, device="cuda"):
        calls.append((s.n_rows, str(device)))
        return real(s, seed, device=device)

    monkeypatch.setattr(tcf, "pmis_split_device", spy)
    pars = tamg.AMGParams(verbose=0, cs_type=tamg.CoarsenType.PMIS,
                          max_levels=2)
    th.setup_host(tamg.poisson2d(511), pars, device="cpu")
    assert calls == []
    hh = th.setup_host(tamg.poisson2d(512), pars, device="cpu")
    assert calls == [(262144, "cpu")] and hh.num_levels == 2
