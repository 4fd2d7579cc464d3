"""The port's batched multi-rhs path against amg_tpu's: the multi-rhs DIA
product (kernel B4, ``amg_tpu_torch.ops.dia_kernel.spmv_multi``), the
batched products of every format, the smoothers on a batch, and
``AMGSolver.solve_batched``.

On the CPU the wrapper runs its plain version; amg_tpu's Pallas multi-rhs
kernel runs in interpret mode, as tests/test_sparse.py runs it.  Inputs
are made from seeds with numpy and handed to both packages.  Tolerances,
and why they are not zero:

* B4 against the Pallas kernel, as B1 in tests/test_torch_dia.py (the
  Pallas kernel sums the diagonals grouped by lane remainder, the port in
  offsets order): f32 ``2e-6 * max|AX|``; bf16 values with nd >= 32 (bf16
  operands, exact f32 products, in both) ``1e-5 * max|AX|``; bf16 values
  with nd < 32 (widened, f32 products) ``2e-6 * max|AX|``.  f64 against
  amg_tpu's XLA ``spmv_dia`` per column (offsets order in both):
  ``rtol=1e-13`` with ``atol=1e-13 * max|AX|``.
* Batched products against per-column products of the port: equal for
  Dia and WEll (the same elementwise arithmetic per column); Ell and Dense
  ``1e-13 * max|AX|`` in f64 (torch reduces a batch in another order).
* Smoothers on a batch against per-column calls: ``1e-12 * max|result|``
  (the Dense levels' matmuls sum in another order).
* ``solve_batched`` in f64 (poisson3d(10), k = 5): equal iterations, X to
  ``rtol=1e-8`` (tests/test_solve.py:708-725 holds amg_tpu's own columns
  to a 1e-8 residual).  In f32 with bf16 coarse operators: iterations
  within 1 and X to ``rtol=1e-3`` plus ``atol=1e-6 * ||b||``, the f32
  rounding floor of ROADMAP queue C item 3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import amg_tpu as jamg
from amg_tpu.ops import pallas_dia
from amg_tpu.ops.spmv import spmv_dia as jax_spmv_dia
from amg_tpu.sparse import CSR, Dia as JDia

import amg_tpu_torch as tamg
from amg_tpu_torch import hierarchy as th
from amg_tpu_torch.ops import dia_kernel, spmv as tspmv
from amg_tpu_torch.solve import smoothers as ts
from amg_tpu_torch.sparse import (Dense as TDense, Dia as TDia, Ell as TEll,
                                  WEll as TWEll)

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

FLAGS = dict(use_well="off", use_banded="off", embed_levels=0, verbose=0)
QUIET = dict(log=lambda *a, **k: None)
CPU = dict(device="cpu")
PAD = 4096


def _band_csr(n, nd, seed):
    """n x n operator with ~nd random diagonals in [-300, 300] and the
    main diagonal."""
    rng = np.random.default_rng(seed)
    offs = np.unique(np.concatenate([[0], rng.integers(-300, 300, nd - 1)]))
    rows_l, cols_l, vals_l = [], [], []
    for o in offs:
        i = np.arange(max(0, -o), min(n, n - o))
        rows_l.append(i)
        cols_l.append(i + o)
        vals_l.append(rng.standard_normal(len(i)))
    return CSR.from_coo(np.concatenate(rows_l), np.concatenate(cols_l),
                        np.concatenate(vals_l), (n, n))


def _operator(kind):
    """poisson3d(16) (nd = 7) or a 40-diagonal band, both PAD rows."""
    return _band_csr(PAD, 40, seed=0) if kind == "band40" \
        else jamg.poisson3d(16)


def _both(a, jdtype, tdtype):
    """The same packed operator in both packages."""
    jd = JDia.from_csr(a, dtype=jdtype, pad_rows_to=PAD)
    vals = np.asarray(jd.vals.astype(jnp.float32) if jdtype == jnp.bfloat16
                      else jd.vals)
    td = TDia.from_numpy(vals, jd.offsets, jd.shape, jd.nnz, dtype=tdtype)
    return jd, td


def _batch(k, dtype, seed, pad=PAD):
    return np.random.default_rng(seed).standard_normal((k, pad)).astype(dtype)


MULTI_CASES = [
    # (operator, values dtype, tolerance of max|AX|)
    ("p3d16", "float32", 2e-6),
    ("band40", "float32", 2e-6),
    ("p3d16", "bfloat16", 2e-6),    # nd = 7: widened, f32 products
    ("band40", "bfloat16", 1e-5),   # nd >= 32: bf16 operands
]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind,vdtype,tol", MULTI_CASES,
                         ids=[f"{o}-{v}" for o, v, _ in MULTI_CASES])
def test_multi_plain_matches_pallas(kind, vdtype, tol, k):
    jd, td = _both(_operator(kind), jnp.dtype(vdtype), getattr(torch, vdtype))
    assert dia_kernel.bf16_products(td.n_diags, td.vals.dtype,
                                    torch.float32) == \
        (kind == "band40" and vdtype == "bfloat16")
    xb = _batch(k, np.float32, seed=11)
    want = np.asarray(pallas_dia.spmv_multi(jd, jnp.asarray(xb),
                                            interpret=True))
    counts = dict(dia_kernel.launches)
    got = dia_kernel.spmv_multi(td, torch.from_numpy(xb))
    assert dia_kernel.launches == counts   # CPU tensors: no launch counted
    assert got.dtype == torch.float32 and got.shape == (k, PAD)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0,
                               atol=tol)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind", ["p3d16", "band40"])
def test_multi_plain_f64_matches_xla(kind, k):
    jd, td = _both(_operator(kind), jnp.float64, torch.float64)
    xb = _batch(k, np.float64, seed=12)
    want = np.stack([np.asarray(jax_spmv_dia(jd, jnp.asarray(x)))
                     for x in xb])
    got = dia_kernel.spmv_multi(td, torch.from_numpy(xb)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())


@pytest.mark.parametrize("vdtype", ["float32", "bfloat16", "float64"])
def test_multi_equals_single_per_column(vdtype):
    """Per column, the plain B4 is the plain B1 product exactly."""
    _, td = _both(_operator("band40"), jnp.dtype(vdtype),
                  getattr(torch, vdtype))
    xdt = np.float64 if vdtype == "float64" else np.float32
    xb = torch.from_numpy(_batch(3, xdt, seed=13))
    ys = dia_kernel.spmv_multi(td, xb)
    for c in range(3):
        assert torch.equal(ys[c], dia_kernel.spmv(td, xb[c]))


def test_multi_rejects_what_the_kernel_does_not_take():
    _, td = _both(_operator("p3d16"), jnp.float32, torch.float32)
    with pytest.raises(ValueError):
        dia_kernel.spmv_multi(td, torch.zeros(PAD))            # 1-D
    with pytest.raises(ValueError):
        dia_kernel.spmv_multi(td, torch.zeros(2, PAD + 8))     # wrong length
    with pytest.raises(ValueError):
        dia_kernel.spmv_multi(td, torch.zeros(0, PAD))         # k = 0
    with pytest.raises(TypeError):
        dia_kernel.spmv_multi(td, torch.zeros(2, PAD, dtype=torch.float64))


def _formats():
    """One operator of each device format, f64 (and a bf16 Dense, widened
    to the vector type like the bf16 coarse levels)."""
    a = tamg.random_spd(300, density=0.05, seed=3)
    p = tamg.poisson2d(24)
    f = tamg.fem2d(5000, seed=9)
    return {
        "Ell": TEll.from_csr(a, dtype=torch.float64),
        "Dense": TDense.from_csr(a, dtype=torch.float64),
        "Dense-bf16": TDense.from_csr(a, dtype=torch.bfloat16),
        "Dia": TDia.from_csr(p, dtype=torch.float64),
        "WEll": TWEll.from_csr(f, dtype=torch.float64),
        "WEll-df64": TWEll.from_csr_df64(f),
    }


@pytest.mark.parametrize("fmt", ["Ell", "Dense", "Dense-bf16", "Dia", "WEll",
                                 "WEll-df64"])
def test_batched_spmv_matches_per_column(fmt):
    op = _formats()[fmt]
    n_x = op.pad_cols if isinstance(op, TWEll) else (
        op.padded_cols if isinstance(op, TDense) else op.padded_rows)
    xb = torch.from_numpy(_batch(3, np.float64, seed=14, pad=n_x))
    got = tspmv.spmv(op, xb)
    want = torch.stack([tspmv.spmv(op, x) for x in xb])
    assert got.shape == want.shape == (3, op.padded_rows)
    if fmt in ("Dia", "WEll", "WEll-df64"):
        assert torch.equal(got, want)
    else:
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-13 * scale
    # the residual helpers slice rows on the last axis
    b = torch.from_numpy(_batch(3, np.float64, seed=15, pad=op.padded_rows))
    if n_x == op.padded_rows:
        r = tspmv.residual_fused(op, xb, b)
        for c in range(3):
            r1 = tspmv.residual_fused(op, xb[c], b[c])
            assert (r[c] - r1).abs().max().item() <= \
                1e-13 * want.abs().max().item()


@pytest.fixture(scope="module")
def packed():
    """Device hierarchies (f64, GS groups on every level) whose levels 0
    and 1 take every smoother path: 1138_bus with Dense off (the Ell
    gather path, then the Ell range path), 1138_bus (masked Dense, then
    the dense range path), poisson2d(24) (Dia, the fused update) and
    fem2d(5000) with WEll on (masked WEll)."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "1138_bus.mtx")
    out = {}
    for name, a, kw in (
            ("1138_bus-ell", tamg.read_mtx(path), dict(dense_level_bytes=0)),
            ("1138_bus", tamg.read_mtx(path), {}),
            ("p2d24", tamg.poisson2d(24), {}),
            ("fem2d-well", tamg.fem2d(5000, seed=9),
             dict(use_well="on", well_min_rows=1024, dense_level_bytes=2e7))):
        pars = tamg.AMGParams(relax=0.9, **{**FLAGS, **kw})
        out[name] = (th.setup(a, pars, **QUIET, **CPU)[0], pars)
    return out


SMOOTHERS = ["GS", "SGS", "SOR", "SSOR", "GSOR", "SGSOR", "JACOBI",
             "WJACOBI", "L1DIAG", "POLY", "CHEBYSHEV", "CG"]


@pytest.mark.parametrize("smoother", SMOOTHERS)
@pytest.mark.parametrize("matrix", ["1138_bus-ell", "1138_bus", "p2d24",
                                    "fem2d-well"])
def test_smoothers_on_a_batch(packed, matrix, smoother):
    """Every smoother branch on a (3, pad) batch equals the branch run on
    each column (the batch is left untouched)."""
    mg, pars = packed[matrix]
    pars = pars.replace(smoother=tamg.SmootherType[smoother])
    for l in (0, 1):
        lv = mg.levels[l]
        x, b = (_batch(3, np.float64, seed=16 + s, pad=lv.pad)
                for s in range(2))
        x[:, lv.n:] = b[:, lv.n:] = 0.0
        xt, bt = torch.from_numpy(x), torch.from_numpy(b)
        for pre in (True, False):
            got = ts.smooth(lv, xt, bt, pars, 2, pre)
            assert np.array_equal(xt.numpy(), x)
            want = torch.stack([ts.smooth(lv, xt[c], bt[c], pars, 2, pre)
                                for c in range(3)])
            scale = want.abs().max().item()
            assert (got - want).abs().max().item() <= 1e-12 * scale


def test_solve_batched_f64_matches_amg_tpu():
    """Default parameters (f64), tol 1e-8, as tests/test_solve.py:708."""
    rng = np.random.default_rng(31)
    k = 5
    ja = jamg.poisson3d(10)
    B = rng.standard_normal((ja.n_rows, k))
    jx, jinfo = jamg.AMGSolver(ja, jamg.AMGParams(tol=1e-8, **FLAGS),
                               **QUIET).solve_batched(B)
    a = tamg.poisson3d(10)
    solver = tamg.AMGSolver(a, tamg.AMGParams(tol=1e-8, **FLAGS), **QUIET,
                            **CPU)
    x, info = solver.solve_batched(B)
    assert x.shape == (a.n_rows, k) and x.dtype == np.float64
    assert info.nits == jinfo.nits
    np.testing.assert_allclose(x, jx, rtol=1e-8)
    np.testing.assert_allclose(info.residuals, jinfo.residuals, rtol=1e-6)
    assert info.rres < 1e-8
    for c in range(k):
        r = B[:, c] - a.matvec(x[:, c])
        assert np.linalg.norm(r) / np.linalg.norm(B[:, c]) < 1e-8


def _structured_pars(pkg):
    """chip_smoke.py's structured main path (f32 cycles, bf16 coarse
    operators, GS on level 0, Chebyshev below) at test size."""
    return pkg.AMGParams(
        dtype="float32", refine=True, accel="none",
        smoother=pkg.SmootherType.GS,
        coarse_smoother=pkg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="bfloat16", coarse_sparsify=0.005,
        sparsify_from_level=2, coarse_stop_rows=3500, tol=1e-8, max_it=60,
        **FLAGS)


@pytest.fixture(scope="module")
def structured_run():
    rng = np.random.default_rng(5)
    ja = jamg.poisson3d(20)
    B = rng.standard_normal((ja.n_rows, 3))
    jx, jinfo = jamg.AMGSolver(ja, _structured_pars(jamg),
                               **QUIET).solve_batched(B, tol=1e-6)
    solver = tamg.AMGSolver(tamg.poisson3d(20), _structured_pars(tamg),
                            **QUIET, **CPU)
    return B, jx, jinfo, solver


def test_solve_batched_f32_matches_amg_tpu(structured_run):
    """f32 cycles with bf16 coarse operators and Chebyshev below level 0;
    the refinement the parameters ask for is ignored, as in amg_tpu."""
    B, jx, jinfo, solver = structured_run
    fmts = [(type(l.a).__name__, l.a.vals.dtype) for l in solver.mg.levels]
    assert fmts[0] == ("Dia", torch.float32)
    assert fmts[1] == ("Dia", torch.bfloat16)
    counts = dict(dia_kernel.launches)
    x, info = solver.solve_batched(B, tol=1e-6)
    assert dia_kernel.launches == counts   # CPU: plain versions only
    assert x.dtype == np.float32 and x.shape == B.shape
    assert abs(info.nits - jinfo.nits) <= 1
    nb = np.linalg.norm(B, axis=0)
    np.testing.assert_allclose(x, jx, rtol=1e-3, atol=1e-6 * nb.max())
    assert info.rres < 1e-6
    for c in range(B.shape[1]):
        r = B[:, c] - solver.a.matvec(x[:, c].astype(np.float64))
        assert np.linalg.norm(r) / nb[c] < 1e-6


def test_one_column_is_the_single_solve(structured_run):
    """k = 1 runs the single-rhs solve's arithmetic: on the CPU the plain
    B4 and B1 agree bit for bit, so iterations and iterates are equal."""
    B, _, _, solver = structured_run
    single = tamg.AMGSolver(
        solver.a, _structured_pars(tamg).replace(refine=False, tol=1e-6),
        host_hierarchy=solver.host_hierarchy, **QUIET, **CPU)
    x1, i1 = single.solve(B[:, 0])
    xb, ib = solver.solve_batched(B[:, :1], tol=1e-6)
    assert ib.nits == i1.nits
    np.testing.assert_array_equal(xb[:, 0], x1)
    np.testing.assert_allclose(ib.residuals, i1.residuals[1:], rtol=1e-6)


def test_solve_batched_permuted_level0_and_x0():
    """A level-0 permutation (the RCM order of WEll levels) is applied to B
    and X0 on entry and undone on exit; a 1-D B raises as in amg_tpu."""
    a = tamg.poisson2d(24)
    pars = tamg.AMGParams(verbose=0, tol=1e-10)
    hh = tamg.setup_host(a, pars, log=QUIET["log"])
    perm = np.random.default_rng(0).permutation(a.n_rows)
    inv = np.argsort(perm)
    hh.a[0] = hh.a[0].permute(perm)
    hh.p[0] = hh.p[0].permute_rows(perm)
    hh.r[0] = hh.r[0].permute_cols(inv)
    hh.cfmark[0] = hh.cfmark[0][perm]
    th.reorder_for_gs(hh, pars)
    hh.perms[0] = perm
    solver = tamg.AMGSolver(a, pars, host_hierarchy=hh, **QUIET, **CPU)
    rng = np.random.default_rng(1)
    B = rng.standard_normal((a.n_rows, 2))
    X0 = rng.standard_normal((a.n_rows, 2))
    x, info = solver.solve_batched(B, x0s=X0)
    assert info.rres < 1e-10
    for c in range(2):
        assert np.linalg.norm(B[:, c] - a.matvec(x[:, c])) \
            / np.linalg.norm(B[:, c]) < 1e-10
    with pytest.raises(ValueError):
        solver.solve_batched(B[:, 0])
    with pytest.raises(ValueError):
        solver.solve_batched(B, x0s=X0[:, 0])
    # column views with negative strides upload like copies
    xr, _ = solver.solve_batched(B[:, ::-1], x0s=X0[:, ::-1])
    np.testing.assert_allclose(xr, x[:, ::-1], rtol=1e-12, atol=1e-14)


def _pallas_epilogue(jd, epilogue, xb, bb, w):
    """amg_tpu's single-vector Pallas epilogue (interpret mode), column by
    column."""
    if epilogue == "resid":
        return np.stack([np.asarray(pallas_dia.resid(
            jd, jnp.asarray(x), jnp.asarray(b), interpret=True))
            for x, b in zip(xb, bb)])
    return np.stack([np.asarray(pallas_dia.gs_update(
        jd, jnp.asarray(x), jnp.asarray(b), jnp.asarray(w), interpret=True))
        for x, b in zip(xb, bb)])


def _multi_epilogue(td, epilogue, xb, bb, w):
    X, B, W = (torch.from_numpy(v) for v in (xb, bb, w))
    if epilogue == "resid":
        return dia_kernel.resid_multi(td, X, B)
    return dia_kernel.gs_update_multi(td, X, B, W)


@pytest.mark.parametrize("epilogue", ["resid", "update"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind,vdtype,tol", MULTI_CASES,
                         ids=[f"{o}-{v}" for o, v, _ in MULTI_CASES])
def test_multi_epilogues_plain_match_pallas(kind, vdtype, tol, k, epilogue):
    """B4's resid and update epilogues (plain version) against amg_tpu's
    B1 epilogues in interpret mode, one column at a time."""
    jd, td = _both(_operator(kind), jnp.dtype(vdtype), getattr(torch, vdtype))
    xb, bb = _batch(k, np.float32, seed=21), _batch(k, np.float32, seed=22)
    w = _batch(1, np.float32, seed=23)[0]
    want = _pallas_epilogue(jd, epilogue, xb, bb, w)
    counts = dict(dia_kernel.launches)
    got = _multi_epilogue(td, epilogue, xb, bb, w)
    assert dia_kernel.launches == counts   # CPU tensors: no launch counted
    assert got.dtype == torch.float32 and got.shape == (k, PAD)
    scale = np.abs(np.stack([np.asarray(pallas_dia.spmv(
        jd, jnp.asarray(x), interpret=True)) for x in xb])).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0,
                               atol=tol)


@pytest.mark.parametrize("epilogue", ["resid", "update"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind", ["p3d16", "band40"])
def test_multi_epilogues_plain_f64_matches_xla(kind, k, epilogue):
    jd, td = _both(_operator(kind), jnp.float64, torch.float64)
    xb, bb = _batch(k, np.float64, seed=24), _batch(k, np.float64, seed=25)
    w = _batch(1, np.float64, seed=26)[0]
    ax = np.stack([np.asarray(jax_spmv_dia(jd, jnp.asarray(x))) for x in xb])
    want = bb - ax if epilogue == "resid" else xb + w * (bb - ax)
    got = _multi_epilogue(td, epilogue, xb, bb, w).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-13,
                               atol=1e-13 * np.abs(ax).max())


@pytest.mark.parametrize("path", ["gs_update", "residual"])
def test_batched_epilogues_equal_the_unfused_expressions(packed, path):
    """On the CPU the batched GS group update and the batched fused
    residual give exactly what the unfused torch expressions gave
    (``X + w_g * (B - A X)`` and ``B - A X`` from one multi-rhs product)."""
    mg, _ = packed["p2d24"]
    lv = mg.levels[0]
    assert isinstance(lv.a, TDia) and lv.gs_w is not None
    X, B = (torch.from_numpy(_batch(3, np.float64, seed=27 + s, pad=lv.pad))
            for s in range(2))
    if path == "residual":
        got = tspmv.residual_fused(lv.a, X, B)
        assert torch.equal(got, B - dia_kernel.spmv_multi(lv.a, X))
        return
    for g in range(len(lv.group_cf)):
        got = ts._masked_group_update(lv, X, B, g)
        want = X + lv.gs_w[g] * (B - dia_kernel.spmv_multi(lv.a, X))
        assert torch.equal(got, want)


def test_multi_epilogues_reject_what_the_kernel_does_not_take():
    _, td = _both(_operator("p3d16"), jnp.float32, torch.float32)
    X, B, w = torch.zeros(2, PAD), torch.zeros(2, PAD), torch.zeros(PAD)
    for fn, args in ((dia_kernel.resid_multi, (X,)),
                     (dia_kernel.gs_update_multi, (X, w))):
        bad_b = (torch.zeros(PAD), torch.zeros(3, PAD), torch.zeros(2, PAD + 8))
        for b in bad_b:                                  # B not (k, pad)
            with pytest.raises(ValueError):
                fn(td, X, b, *args[1:])
        with pytest.raises(TypeError):                   # B's dtype
            fn(td, X, B.double(), *args[1:])
        with pytest.raises(ValueError):                  # B's device
            fn(td, X, torch.zeros(2, PAD, device="meta"), *args[1:])
    for bad_w in (torch.zeros(2, PAD), torch.zeros(PAD + 8)):   # w not (pad,)
        with pytest.raises(ValueError):
            dia_kernel.gs_update_multi(td, X, B, bad_w)
    with pytest.raises(TypeError):
        dia_kernel.gs_update_multi(td, X, B, w.double())
    with pytest.raises(ValueError):
        dia_kernel.gs_update_multi(td, X, B, torch.zeros(PAD, device="meta"))
    no_main = TDia(td.vals[[k for k, o in enumerate(td.offsets) if o != 0]],
                   tuple(o for o in td.offsets if o != 0), td.shape, td.nnz)
    with pytest.raises(ValueError, match="main diagonal"):
        dia_kernel.gs_update_multi(no_main, X, B, w)
