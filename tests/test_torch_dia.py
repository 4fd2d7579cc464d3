"""The port's DIA kernel wrapper (amg_tpu_torch.ops.dia_kernel) against
amg_tpu's Pallas DIA kernel.

On the CPU the wrapper runs its plain PyTorch version; the Pallas kernel
runs in interpret mode, as tests/test_sparse.py runs it.  Both packages get
the same packed values: amg_tpu's ``Dia.vals`` as numpy, handed to the port
through ``Dia.from_numpy``.

Tolerances, and why they are not zero: the Pallas kernel sums the
diagonals grouped by lane remainder (pallas_dia.py:147-157) while the
plain version (like XLA's shifted-slice path and the CUDA kernel, which
also contracts multiply-adds into FMAs) sums in offsets order.

* f32: ``2e-6 * max|Ax|``, the bar of test_sparse.py:423-428.
* bf16 values, nd >= 32: ``1e-5 * max|Ax|``; both round x to bf16 and
  form each product identically, only the f32 summation order differs.
* f64 against ``amg_tpu.ops.spmv.spmv_dia`` (XLA, offsets order):
  ``rtol=1e-13`` (with ``atol=1e-13 * max|Ax|`` for entries that cancel).

The CUDA kernel itself is compared with the plain version on the card in
tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import amg_tpu as amg
from amg_tpu.ops import pallas_dia
from amg_tpu.ops.spmv import spmv_dia as jax_spmv_dia
from amg_tpu.sparse import CSR, Dia as JDia

import amg_tpu_torch as tamg
from amg_tpu_torch.ops import dia_kernel
from amg_tpu_torch.sparse import Dia as TDia, Dense as TDense, Ell as TEll

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EPILOGUES = ("spmv", "resid", "update")


def _band_csr(n, nd, seed):
    """n x n operator with ~nd random diagonals in [-300, 300] (and the
    main diagonal, which the update epilogue needs)."""
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
    if kind == "band40":
        return _band_csr(8192, 40, seed=0), 8192
    return amg.poisson3d(16), 4096


def _both(a, pad, jdtype, tdtype):
    """The same packed operator in both packages."""
    jd = JDia.from_csr(a, dtype=jdtype, pad_rows_to=pad)
    vals = np.asarray(jd.vals.astype(jnp.float32) if jdtype == jnp.bfloat16
                      else jd.vals)
    td = TDia.from_numpy(vals, jd.offsets, jd.shape, jd.nnz, dtype=tdtype)
    return jd, td


def _vectors(pad, dtype, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(pad).astype(dtype) for _ in range(3)]


def _port(td, epilogue, x, b, w):
    xt, bt, wt = (torch.from_numpy(v) for v in (x, b, w))
    if epilogue == "spmv":
        return dia_kernel.spmv(td, xt).numpy()
    if epilogue == "resid":
        return dia_kernel.resid(td, xt, bt).numpy()
    return dia_kernel.gs_update(td, xt, bt, wt).numpy()


def _pallas(jd, epilogue, x, b, w):
    xj, bj, wj = (jnp.asarray(v) for v in (x, b, w))
    if epilogue == "spmv":
        return np.asarray(pallas_dia.spmv(jd, xj, interpret=True))
    if epilogue == "resid":
        return np.asarray(pallas_dia.resid(jd, xj, bj, interpret=True))
    return np.asarray(pallas_dia.gs_update(jd, xj, bj, wj, interpret=True))


CASES = [
    # (operator, values dtype, relative tolerance)
    ("band40", "float32", 2e-6),
    ("p3d16", "float32", 2e-6),
    ("band40", "bfloat16", 1e-5),   # nd >= 32: bf16 products
    ("p3d16", "bfloat16", 2e-6),    # nd = 7: widened, f32 products
]


@pytest.mark.parametrize("kind,vdtype,tol", CASES,
                         ids=[f"{k}-{v}" for k, v, _ in CASES])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_plain_matches_pallas(kind, vdtype, tol, epilogue):
    a, pad = _operator(kind)
    jd, td = _both(a, pad, jnp.dtype(vdtype), getattr(torch, vdtype))
    x, b, w = _vectors(pad, np.float32, seed=1)
    got = _port(td, epilogue, x, b, w)
    want = _pallas(jd, epilogue, x, b, w)
    scale = np.abs(np.asarray(pallas_dia.spmv(jd, jnp.asarray(x),
                                              interpret=True))).max()
    assert got.dtype == np.float32 and got.shape == (pad,)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def test_bf16_product_rule():
    """The nd >= 32 rule of pallas_dia.py:140-141: bf16 products only for
    bf16 values applied to f32 vectors on wide bands."""
    assert dia_kernel.bf16_products(32, torch.bfloat16, torch.float32)
    assert not dia_kernel.bf16_products(31, torch.bfloat16, torch.float32)
    assert not dia_kernel.bf16_products(40, torch.float32, torch.float32)
    # the rule changes results: on the wide band x is rounded to bf16, so
    # the products differ from f32 products of the same (bf16-exact)
    # values; on the 7-point band the bf16 operator multiplies in f32 and
    # matches them exactly
    for kind, wide in (("band40", True), ("p3d16", False)):
        a, pad = _operator(kind)
        _, td = _both(a, pad, jnp.bfloat16, torch.bfloat16)
        widened = TDia(td.vals.float(), td.offsets, td.shape, td.nnz)
        x = torch.from_numpy(_vectors(pad, np.float32, seed=2)[0])
        y16 = dia_kernel.spmv(td, x)
        y32 = dia_kernel.spmv(widened, x)
        if wide:
            assert not torch.equal(y16, y32)
            scale = y32.abs().max()
            assert ((y16 - y32).abs().max() / scale).item() < 1e-2
        else:
            assert torch.equal(y16, y32)


@pytest.mark.parametrize("kind", ["band40", "p3d16"])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_plain_f64_matches_xla(kind, epilogue):
    a, pad = _operator(kind)
    jd, td = _both(a, pad, jnp.float64, torch.float64)
    x, b, w = _vectors(pad, np.float64, seed=3)
    ax = np.asarray(jax_spmv_dia(jd, jnp.asarray(x)))
    want = {"spmv": ax, "resid": b - ax, "update": x + w * (b - ax)}[epilogue]
    got = _port(td, epilogue, x, b, w)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-13,
                               atol=1e-13 * np.abs(ax).max())
    # and the host CSR product agrees with the padded operator
    np.testing.assert_allclose(
        dia_kernel.spmv(td, torch.from_numpy(x)).numpy()[: a.n_rows],
        a.matvec(x[: a.n_cols]), rtol=1e-13, atol=1e-13 * np.abs(ax).max())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a, pad = _operator("p3d16")
    _, td = _both(a, pad, jnp.float32, torch.float32)
    x = torch.zeros(pad)
    with pytest.raises(TypeError):
        dia_kernel.spmv(td, x.double())            # (f32, f64)
    with pytest.raises(ValueError):
        dia_kernel.spmv(td, torch.zeros(pad + 8))  # wrong length
    with pytest.raises(TypeError):
        dia_kernel.resid(td, x, torch.zeros(pad, dtype=torch.float64))
    no_main = TDia(td.vals[[k for k, o in enumerate(td.offsets) if o != 0]],
                   tuple(o for o in td.offsets if o != 0), td.shape, td.nnz)
    with pytest.raises(ValueError, match="main diagonal"):
        dia_kernel.gs_update(no_main, x, x, x)
    counts = dict(dia_kernel.launches)
    by_shape = dict(dia_kernel.launches_by_shape)
    dia_kernel.spmv(td, x)   # CPU tensors: plain version, no launch counted
    assert dia_kernel.launches == counts
    assert dia_kernel.launches_by_shape == by_shape


def test_containers_round_trip():
    """Each device container gives back the host CSR it was built from."""
    for a in (amg.poisson3d(6), amg.random_spd(120, density=0.05, seed=1)):
        ta = tamg.CSR(a.indptr, a.indices, a.data, a.shape)
        for cls in (TDia, TEll, TDense):
            m = cls.from_csr(ta, dtype=torch.float64).to_csr()
            np.testing.assert_array_equal(m.to_dense(), a.to_dense())


def _band40_offsets():
    """chip_smoke.py's 40-diagonal band: 39 random offsets in +-20000 and
    the main diagonal, here drawn with numpy."""
    rng = np.random.default_rng(0)
    offs = {0}
    while len(offs) < 40:
        offs.add(int(rng.integers(-20000, 20001)))
    return tuple(sorted(offs))


PLAN_CASES = {
    # poisson3d(100) level 0 and the shape of its level-1 offsets
    "p3d100-L0": (-10000, -100, -1, 0, 1, 100, 10000),
    "p3d100-L1": (-10000, -5050, -5000, -4950, -101, -100, -99, -1, 0, 1,
                  99, 100, 101, 4950, 5000, 5050, 10000),
    "band40": _band40_offsets(),
    "run-wider-than-window": tuple(range(-300, 301, 3)),
    "offsets-beyond-pad": (-9000, -8999, 0, 8999, 9000),
    "unsorted": (5, -3, 0, 400, 401, -700),
    "many-runs": tuple(o for r in range(60) for o in (1000 * r, 1000 * r + 1)),
    "empty": (),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_covers_offsets_in_order(name):
    """The kernels' read plan: segments cover every diagonal once, in
    offsets order; a windowed segment is a run of >= 2 diagonals whose span
    fits WINDOW_SPAN, a single diagonal reads x directly, and no plan has
    more than MAX_SEGMENTS segments."""
    offs = PLAN_CASES[name]
    segs = dia_kernel.plan(offs)
    assert len(segs) <= dia_kernel.MAX_SEGMENTS
    end = 0
    for s, (first, stop, lo, span) in enumerate(segs):
        assert first == end and stop > first
        end = stop
        run = offs[first:stop]
        if span >= 0:
            assert len(run) >= 2 and lo == min(run)
            assert span == max(run) - min(run) <= dia_kernel.WINDOW_SPAN
        else:
            assert (lo, span) == (0, -1)
            assert s == 0 or segs[s - 1][3] >= 0   # direct runs merge
    assert end == len(offs)
    if name == "p3d100-L0":
        # x crosses from L2 3 times per row instead of 7
        assert segs == ((0, 1, 0, -1), (1, 6, -100, 200), (6, 7, 0, -1))
    if name == "p3d100-L1":
        assert [s[3] for s in segs] == [-1, 100, 202, 100, -1]
    if name == "band40":
        # scattered offsets: pairs closer than the window, the rest direct
        assert all(s[1] - s[0] == 2 for s in segs if s[3] >= 0)
        assert sum(s[1] - s[0] for s in segs if s[3] < 0) >= 10
    if name == "many-runs":
        assert sum(s[3] >= 0 for s in segs) == \
            (dia_kernel.MAX_SEGMENTS - 1) // 2
