"""The row-slice layout of WEll operators (amg_tpu_torch.sparse.RowSlices)
and the plain versions of the WEll kernels that read it
(amg_tpu_torch.ops.well_kernel: spmv, spmv_df64, gs_update_), on the CPU.

The layout is derived from the WEll pack, which tests/test_torch_well.py
holds equal to amg_tpu's array for array; here it must give back the
pack's operator exactly (``to_csr``), cover every padded row once, and
its products must agree with the pack's own operator (its ``to_csr``,
applied by scipy in f64) and with amg_tpu's XLA product.  Operators: fem2d(20000) (level 0 in RCM order with
its GS classes, as the unstructured solve packs it, and its P/R,
rectangular), and a random rectangular operator whose WEll slots are under
5% filled.  Tolerances, and why they are not zero (the row-slice sums run
in column order and in x's type, XLA's in slot order, scipy's in f64):

* B2, f32 values: ``2e-6 * max|Ax|``; bf16 values: ``1e-5 * max|Ax|``;
  f64 values and B3 (df64 pair, f64 x): ``1e-13 * max|Ax|``.
* The GS class update against ``_masked_group_update``'s masked path (a
  full product, then the class's rows): ``1e-6 * max|x|`` in f32,
  ``1e-13 * max|x|`` in f64 (the rows' products only differ).

The CUDA kernels are compared with these plain versions on the card in
tests/test_torch_gpu.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import amg_tpu as jamg
from amg_tpu.ops.spmv import spmv as jax_spmv
from amg_tpu.sparse import CSR as JCSR, WEll as JWEll

import amg_tpu_torch as tamg
from amg_tpu_torch import hierarchy as th
from amg_tpu_torch.ops import well_kernel
from amg_tpu_torch.solve import smoothers as ts
from amg_tpu_torch.sparse import RowSlices, WEll as TWEll

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

KINDS = ("float32", "bfloat16", "float64", "df64")
TOL = {"float32": 2e-6, "bfloat16": 1e-5, "float64": 1e-13, "df64": 1e-13}


def _pars(dtype):
    """The unstructured main path at test size (as in
    tests/test_torch_solve.py), in ``dtype``."""
    return tamg.AMGParams(
        dtype=dtype, refine=dtype == "float32", accel="cg",
        smoother=tamg.SmootherType.GS,
        coarse_smoother=tamg.SmootherType.CHEBYSHEV,
        coarse_op_dtype=dtype, coarse_sparsify=0, coarse_stop_rows=3500,
        tol=1e-8, max_it=60, use_well="on", use_banded="off",
        embed_levels=0, well_min_rows=1024, dense_level_bytes=2e7,
        verbose=0)


@pytest.fixture(scope="module")
def fem():
    """fem2d(20000)'s hierarchy on the CPU, f32 and f64: (device
    hierarchy, host hierarchy) per dtype."""
    a = tamg.fem2d(20000, seed=17)
    return {dt: th.setup(a, _pars(dt), log=lambda *_: None, device="cpu")
            for dt in ("float32", "float64")}


def _low_fill():
    """A random 2048 x 65536 operator whose WEll slots are under 5% filled
    (four scattered columns per row: entries of a row group share few
    windows)."""
    import scipy.sparse as sp

    m = sp.random(2048, 65536, density=4 / 65536, random_state=5,
                  format="csr")
    return tamg.CSR.from_scipy(m)


def _operators(fem):
    """(tag, host CSR, pad rows, pad cols, classes) of the test operators:
    level 0 with its GS classes, every P and R of the f32 hierarchy, and
    the low-fill operator."""
    mg, hh = fem["float32"]
    lv0 = mg.levels[0]
    out = [("A0", hh.a[0], lv0.a.padded_rows, lv0.a.pad_cols, lv0.gid)]
    for l, lv in enumerate(mg.levels):
        for name, ops in (("P", hh.p), ("R", hh.r)):
            op = getattr(lv, name.lower())
            if isinstance(op, TWEll):
                out.append((f"{name}{l}", ops[l], op.padded_rows,
                            op.pad_cols, None))
    out.append(("lowfill", _low_fill(), 3072, 65536, None))
    return out


def _pack(a, kind, pad_r, pad_c, classes=None):
    kw = dict(pad_rows_to=pad_r, pad_cols_to=pad_c, classes=classes)
    if kind == "df64":
        return TWEll.from_csr_df64(a, **kw)
    return TWEll.from_csr(a, dtype=getattr(torch, kind), **kw)


def test_fixture_operators(fem):
    """The fixtures are what the tests claim: level 0 grouped by class, P
    and R rectangular, one operator under 5% slot fill."""
    ops = _operators(fem)
    tags = [o[0] for o in ops]
    assert {"A0", "P0", "R0", "lowfill"} <= set(tags)
    assert any(o[1].shape[0] != o[1].shape[1] for o in ops)
    assert fem["float32"][0].levels[0].a.rows.classes
    low = _pack(_low_fill(), "float32", 3072, 65536)
    assert low.nnz / low.vals.numel() < 0.05


@pytest.mark.parametrize("kind", KINDS)
def test_layout_to_csr_equals_pack(fem, kind):
    """The derived layout's ``to_csr`` is the pack's ``to_csr``, exactly,
    for every dtype and operator (class-grouped level 0 included)."""
    for tag, a, pad_r, pad_c, classes in _operators(fem):
        w = _pack(a, kind, pad_r, pad_c, classes)
        want, got = w.to_csr(), w.rows.to_csr(w.shape)
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{tag} {kind} {f}")
        assert w.rows.nnz == want.nnz == a.nnz, tag
        assert (w.rows.vals_lo is not None) == (kind == "df64")
        assert w.rows.vals.dtype == w.vals.dtype


@pytest.mark.parametrize("grouped", [True, False], ids=["classes", "rows"])
def test_segments_cover_every_row_once(fem, grouped):
    """Every padded row lies in exactly one segment; with classes, segment
    g holds class g's rows in ascending order and the last segment the
    rows of no class; without, one segment holds all rows in row order.
    Slices are as wide as their longest row, and each row's entries are
    its CSR row, sorted by column."""
    mg, hh = fem["float32"]
    lv0 = mg.levels[0]
    w = _pack(hh.a[0], "float32", lv0.pad, lv0.pad,
              lv0.gid if grouped else None)
    s = w.rows
    gid = lv0.gid.long()
    row_idx = s.row_idx.long()
    assert s.classes == grouped
    assert len(s.segments) == (int(gid.max()) + 2 if grouped else 1)
    seen = []
    next_slice = 0
    for k, (first, n) in enumerate(s.segments):
        assert first == next_slice
        next_slice += n
        rows = row_idx[first * 32:(first + n) * 32]
        # unused lanes only at the segment's end
        used = int((rows >= 0).sum())
        assert torch.all(rows[:used] >= 0) and torch.all(rows[used:] < 0)
        assert used > n * 32 - 32
        rows = rows[:used]
        assert torch.all(rows[1:] > rows[:-1])
        if grouped:
            want = k if k < len(s.segments) - 1 else -1
            assert torch.all(gid[rows] == want)
        seen.append(rows)
    assert next_slice == s.n_slices
    assert torch.equal(torch.sort(torch.cat(seen)).values,
                       torch.arange(w.padded_rows))
    # widths and entries
    width = (s.slice_ptr[1:] - s.slice_ptr[:-1]) // 32
    assert torch.equal(width, s.row_len.reshape(-1, 32).amax(1).long())
    deg = np.zeros(w.padded_rows, dtype=np.int64)
    deg[: hh.a[0].n_rows] = hh.a[0].row_degrees
    used = row_idx >= 0
    np.testing.assert_array_equal(s.row_len[used].numpy(),
                                  deg[row_idx[used].numpy()])
    csr = hh.a[0]
    for t in (0, 1, 31, 32, 1000, int(used.sum()) - 1):
        r, n = int(row_idx[t]), int(s.row_len[t])
        if r < 0 or r >= csr.n_rows:
            continue
        place = int(s.slice_ptr[t // 32]) + t % 32 + 32 * np.arange(n)
        cols = s.cols[place].numpy()
        lo, hi = csr.indptr[r], csr.indptr[r + 1]
        np.testing.assert_array_equal(cols, np.sort(csr.indices[lo:hi]))


@pytest.mark.parametrize("kind", KINDS)
def test_plain_products_match_pack_and_amg_tpu(fem, kind):
    """The row-slice plain ``spmv``/``spmv_df64`` against the pack's own
    operator (``WEll.to_csr``, decoded on the host from the pack, applied
    in f64) and amg_tpu's XLA product of amg_tpu's own pack, with x of
    length pad_cols and of n_cols (reads past its end are 0)."""
    rng = np.random.default_rng(11)
    df64 = kind == "df64"
    xdt = np.float64 if kind in ("float64", "df64") else np.float32
    fn = well_kernel.spmv_df64 if df64 else well_kernel.spmv
    for tag, a, pad_r, pad_c, classes in _operators(fem):
        w = _pack(a, kind, pad_r, pad_c, classes)
        packed = w.to_csr().to_scipy()
        aj = JCSR(a.indptr, a.indices, a.data, a.shape)
        if df64:
            wj = JWEll.from_csr_df64(aj, pad_rows_to=pad_r, pad_cols_to=pad_c)
        else:
            wj = JWEll.from_csr(aj, dtype=jnp.dtype(kind), pad_rows_to=pad_r,
                                pad_cols_to=pad_c)
        for n_x in (w.pad_cols, a.n_cols):
            x = rng.standard_normal(n_x).astype(xdt)
            got = fn(w, torch.from_numpy(x)).numpy()
            want = np.zeros(w.padded_rows)
            want[: a.n_rows] = packed @ x[: a.n_cols].astype(np.float64)
            xla = np.asarray(jax_spmv(wj, jnp.asarray(x)))
            scale = np.abs(want).max()
            assert got.shape == (w.padded_rows,) and got.dtype == xdt
            for ref in (want, xla):
                np.testing.assert_allclose(got, ref, rtol=0,
                                           atol=TOL[kind] * scale,
                                           err_msg=f"{tag} n_x={n_x}")
            assert np.all(got[a.n_rows:] == 0), tag
            if kind in ("float64", "df64"):
                np.testing.assert_allclose(
                    got[: a.n_rows], a.to_scipy() @ x[: a.n_cols], rtol=0,
                    atol=1e-13 * scale, err_msg=tag)


def _row_order(level):
    """The level with its operator's layout in row order (no classes):
    ``_masked_group_update`` then takes its masked path."""
    a = level.a
    return dataclasses.replace(
        level, a=dataclasses.replace(a, rows=RowSlices.from_well(a)))


@pytest.mark.parametrize("relax", [None, 0.9], ids=["gs", "sor"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gs_entry_matches_masked_path(fem, dtype, relax):
    """The plain ``gs`` entry, per class of level 0, against
    ``_masked_group_update``'s masked path (one full product, then the
    class's rows), with and without ``relax``."""
    mg, _ = fem[dtype]
    lv = mg.levels[0]
    assert lv.a.rows.classes and lv.a.vals.dtype == getattr(torch, dtype)
    plain_lv = _row_order(lv)
    tol = {"float32": 1e-6, "float64": 1e-13}[dtype]
    rng = np.random.default_rng(12)
    n_cls = len(lv.group_cf)
    assert len(lv.a.rows.segments) == n_cls + 1
    for g in range(n_cls):
        x, b = (torch.from_numpy(rng.standard_normal(lv.pad))
                .to(lv.diag.dtype) for _ in range(2))
        x[lv.n:] = 0
        want = ts._masked_group_update(plain_lv, x, b, g, relax=relax)
        got = x.clone()
        out = well_kernel.gs_update_(lv.a, got, b, g, lv.diag, lv.inv_diag,
                                     relax=relax)
        assert out is got   # in place
        scale = want.abs().max().item()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=tol * scale, err_msg=f"class {g}")
        # only class g's rows moved
        moved = (got != x).nonzero().squeeze(1)
        assert torch.all(lv.gid[moved] == g)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gs_sweep_takes_the_class_entry(fem, dtype, monkeypatch):
    """A GS sweep on level 0 launches the class update once per class and
    no full-operator product, leaves its input untouched and agrees with
    the masked path's sweep (f32: 1e-6, f64: 1e-12 of max|x|)."""
    mg, _ = fem[dtype]
    lv = mg.levels[0]
    calls = []
    real = well_kernel.gs_update_plain_

    def counted(*args, **kw):
        calls.append(args[3])
        return real(*args, **kw)

    def no_product(*args, **kw):
        raise AssertionError("full product during a class-grouped GS sweep")

    rng = np.random.default_rng(13)
    x, b = (torch.from_numpy(rng.standard_normal(lv.pad)).to(lv.diag.dtype)
            for _ in range(2))
    x[lv.n:] = b[lv.n:] = 0
    x0 = x.clone()
    order = tuple(range(len(lv.group_cf)))
    want = ts.gs_sweep(_row_order(lv), x, b, order)
    monkeypatch.setattr(well_kernel, "gs_update_plain_", counted)
    monkeypatch.setattr(well_kernel, "spmv_plain", no_product)
    got = ts.gs_sweep(lv, x, b, order)
    assert calls == list(order)
    assert torch.equal(x, x0)
    tol = {"float32": 1e-6, "float64": 1e-12}[dtype]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=tol * want.abs().max().item())


def test_solver_shares_level0_structure():
    """With defect correction, level 0's f32 operator and the df64
    operator of FCG share one class-grouped structure and the hi plane."""
    a = tamg.fem2d(20000, seed=17)
    solver = tamg.AMGSolver(a, _pars("float32"), log=lambda *_: None,
                            device="cpu")
    w0, hi = solver.mg.levels[0].a.rows, solver.a0_hi.rows
    assert w0.classes and hi.classes and w0.segments == hi.segments
    for f in ("cols", "slice_ptr", "row_len", "row_idx", "vals"):
        assert getattr(w0, f) is getattr(hi, f), f
    assert w0.vals_lo is None and hi.vals_lo is not None


def test_gs_entry_rejects_what_it_does_not_take(fem):
    mg, _ = fem["float32"]
    lv = mg.levels[0]
    x = torch.zeros(lv.pad)
    n_cls = len(lv.group_cf)
    with pytest.raises(ValueError, match="no GS class"):
        well_kernel.gs_update_(lv.a, x, x, n_cls, lv.diag, lv.inv_diag)
    with pytest.raises(ValueError, match="no GS class"):
        well_kernel.gs_update_(_row_order(lv).a, x, x, 0, lv.diag,
                               lv.inv_diag)
    with pytest.raises(ValueError):
        well_kernel.gs_update_(lv.a, x, x[:-1], 0, lv.diag, lv.inv_diag)
    with pytest.raises(ValueError):
        well_kernel.gs_update_(lv.a, x, x.double(), 0, lv.diag,
                               lv.inv_diag)
    with pytest.raises(ValueError, match="classes"):
        TWEll(lv.a.vals, lv.a.loc, lv.a.base, lv.a.shape, lv.a.nnz,
              lv.a.pad_cols, rows=lv.a.rows, classes=lv.gid)
    counts = dict(well_kernel.launches)
    well_kernel.gs_update_(lv.a, x, x, 0, lv.diag, lv.inv_diag)
    well_kernel.spmv(lv.a, x)
    assert well_kernel.launches == counts   # CPU tensors: no launch
