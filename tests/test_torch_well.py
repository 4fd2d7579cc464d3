"""The port's WEll container and WEll kernel wrappers
(amg_tpu_torch.sparse.WEll, amg_tpu_torch.ops.well_kernel) against
amg_tpu's.

Packs: the port packs with its own copy of the native slot packer and
must give amg_tpu's arrays exactly (vals, loc, base, vals_lo).  Products,
on the CPU where the wrappers run their plain versions; the Pallas kernels
run in interpret mode, as tests/test_sparse.py runs them.  Tolerances, and
why they are not zero (the plain version sums the slots in another order
than the Pallas kernel and the XLA gather):

* B2, f32 values: ``2e-6 * max|Ax|``; bf16 values (widened exactly, f32
  products): ``1e-5 * max|Ax|``.
* B3 (two f32 planes, f64 x): ``1e-13 * max|Ax|`` against amg_tpu's XLA
  path ``spmv(WEll_df64, x64)`` and against scipy in f64.  Against the
  Pallas df64 kernel in interpret mode only ``1e-5``: interpret mode does
  not keep its Dekker-split exactness (tests/test_sparse.py:373-379).

The CUDA kernels themselves are compared with the plain versions on the
card in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import amg_tpu as jamg
from amg_tpu.ops import pallas_well
from amg_tpu.ops.spmv import spmv as jax_spmv
from amg_tpu.sparse import CSR as JCSR, WEll as JWEll

import amg_tpu_torch as tamg
from amg_tpu_torch.ops import spmv as tspmv, well_kernel
from amg_tpu_torch.sparse import WEll as TWEll

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

MATRICES = {"fem2d-2500": (2500, 2), "fem2d-5000": (5000, 9)}
KINDS = ("float32", "bfloat16", "df64")


def _fem(name):
    n, seed = MATRICES[name]
    aj = jamg.fem2d(n, seed=seed)
    return aj, tamg.CSR(aj.indptr, aj.indices, aj.data, aj.shape)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jpack(a, kind):
    if kind == "df64":
        return JWEll.from_csr_df64(a)
    return JWEll.from_csr(a, dtype=jnp.dtype(kind))


def _tpack(a, kind):
    if kind == "df64":
        return TWEll.from_csr_df64(a)
    return TWEll.from_csr(a, dtype=getattr(torch, kind))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(MATRICES))
def test_pack_matches_amg_tpu(name, kind):
    """vals, loc, base (and vals_lo) array-equal to amg_tpu's pack, and
    ``to_csr`` gives back the operator."""
    aj, at = _fem(name)
    wj, wt = _jpack(aj, kind), _tpack(at, kind)
    assert wt.shape == wj.shape and wt.nnz == wj.nnz
    assert wt.pad_cols == wj.pad_cols and wt.n_slots == wj.n_slots
    assert wt.loc.dtype == torch.int16 and wt.base.dtype == torch.int32
    vj = np.asarray(wj.vals.astype(jnp.float32) if kind == "bfloat16"
                    else wj.vals)
    np.testing.assert_array_equal(_np(wt.vals), vj)
    np.testing.assert_array_equal(wt.loc.numpy(), np.asarray(wj.loc))
    np.testing.assert_array_equal(wt.base.numpy(), np.asarray(wj.base))
    assert (wt.vals_lo is None) == (wj.vals_lo is None)
    if kind == "df64":
        np.testing.assert_array_equal(wt.vals_lo.numpy(),
                                      np.asarray(wj.vals_lo))
    back = wt.to_csr().to_scipy() - at.to_scipy()
    tol = {"float32": 1e-7, "bfloat16": 1e-2, "df64": 1e-13}[kind]
    if back.nnz:
        assert np.abs(back.data).max() <= tol * np.abs(at.data).max()
    # every entry of the operator is in the pack (no entry dropped)
    assert wt.to_csr().nnz == at.nnz


def test_pack_f64_round_trip_exact():
    _, at = _fem("fem2d-2500")
    back = TWEll.from_csr(at, dtype=torch.float64).to_csr()
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(back, field),
                                      getattr(at, field))


def test_windows_use_q_above_zero():
    """The test operators have slot entries whose column block Q is not 0,
    so a port that read Q at the entry's own lane would be caught."""
    _, at = _fem("fem2d-2500")
    w = TWEll.from_csr(at)
    loc = w.loc.numpy().astype(np.int64)
    g, k, s, l = np.nonzero(w.vals.numpy())
    r = loc[g, k, s, l] & 127
    q_right = loc[g, k, s, r] >> 7
    q_own = loc[g, k, s, l] >> 7
    assert (q_right > 0).sum() > 1000
    assert (q_right != q_own).sum() > 1000


def test_pack_without_compiler_matches_native(monkeypatch):
    """The pure-Python packer (used when no compiler is available) gives
    the native packer's arrays."""
    from amg_tpu_torch import native

    a = tamg.CSR.from_scipy(_fem("fem2d-2500")[1].to_scipy()[:1500, :1500])
    want = TWEll.pack_host(a, dtype=np.float64)
    monkeypatch.setattr(native, "lib", None)
    got = TWEll.pack_host(a, dtype=np.float64)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def _x(n, dtype, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


@pytest.mark.parametrize("kind,tol", [("float32", 2e-6), ("bfloat16", 1e-5)])
@pytest.mark.parametrize("name", list(MATRICES))
def test_b2_plain_matches_pallas_and_xla(name, kind, tol):
    aj, at = _fem(name)
    wj, wt = _jpack(aj, kind), _tpack(at, kind)
    x = _x(wj.pad_cols, np.float32, seed=1)
    got = well_kernel.spmv(wt, torch.from_numpy(x)).numpy()
    pallas = np.asarray(pallas_well.spmv(wj, jnp.asarray(x), interpret=True))
    xla = np.asarray(jax_spmv(wj, jnp.asarray(x)))
    scale = np.abs(xla).max()
    assert got.dtype == np.float32 and got.shape == (wt.padded_rows,)
    np.testing.assert_allclose(got / scale, pallas / scale, rtol=0, atol=tol)
    np.testing.assert_allclose(got / scale, xla / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("name", list(MATRICES))
def test_b2_short_x_reads_zero(name):
    """An x shorter than pad_cols reads 0 past its end, as amg_tpu's
    zero-padded copy does (the level vectors of a P whose coarse pad is
    not a multiple of 1024)."""
    aj, at = _fem(name)
    wj, wt = _jpack(aj, "float32"), _tpack(at, "float32")
    x = _x(at.n_cols, np.float32, seed=2)
    assert x.shape[0] < wt.pad_cols
    got = well_kernel.spmv(wt, torch.from_numpy(x)).numpy()
    want = np.asarray(jax_spmv(wj, jnp.asarray(x)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[: at.n_rows], at.to_scipy() @ x,
                               rtol=0, atol=2e-6 * scale)


@pytest.mark.parametrize("name", list(MATRICES))
def test_b3_plain_matches_xla_scipy_and_pallas(name):
    aj, at = _fem(name)
    wj, wt = _jpack(aj, "df64"), _tpack(at, "df64")
    x = _x(at.n_cols, np.float64, seed=3)
    got = well_kernel.spmv_df64(wt, torch.from_numpy(x)).numpy()
    xla = np.asarray(jax_spmv(wj, jnp.asarray(x)))
    want = at.to_scipy() @ x
    scale = np.abs(want).max()
    assert got.dtype == np.float64 and got.shape == (wt.padded_rows,)
    np.testing.assert_allclose(got, xla, rtol=0, atol=1e-13 * scale)
    np.testing.assert_allclose(got[: at.n_rows], want, rtol=0,
                               atol=1e-13 * scale)
    assert np.all(got[at.n_rows:] == 0)
    pallas = np.asarray(pallas_well.spmv_df64(wj, jnp.asarray(x),
                                              interpret=True))
    np.testing.assert_allclose(got / scale, pallas / scale, rtol=0,
                               atol=1e-5)
    # the spmv dispatch takes B3 for a df64 pack and an f64 vector
    np.testing.assert_array_equal(
        tspmv.spmv(wt, torch.from_numpy(x)).numpy(), got)


def test_rectangular_transfer_shapes():
    """P/R shapes: rectangular operators with pads from a level pair."""
    import scipy.sparse as sp

    rng = np.random.default_rng(4)
    m = sp.random(3000, 1400, density=0.004, random_state=5, format="csr")
    aj = JCSR.from_scipy(m)
    at = tamg.CSR.from_scipy(m)
    for rows, cols, pad_r, pad_c in ((3000, 1400, 3072, 1500),
                                     (3000, 1400, 3072, 2048)):
        wj = JWEll.from_csr(aj, dtype=jnp.float32, pad_rows_to=pad_r,
                            pad_cols_to=pad_c)
        wt = TWEll.from_csr(at, dtype=torch.float32, pad_rows_to=pad_r,
                            pad_cols_to=pad_c)
        assert wt.pad_cols == wj.pad_cols and wt.padded_rows == pad_r
        np.testing.assert_array_equal(wt.loc.numpy(), np.asarray(wj.loc))
        x = rng.standard_normal(pad_c).astype(np.float32)
        got = well_kernel.spmv(wt, torch.from_numpy(x)).numpy()
        want = np.asarray(jax_spmv(wj, jnp.asarray(x)))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=2e-6)


def test_from_numpy_wraps_amg_tpu_pack():
    aj, at = _fem("fem2d-2500")
    for kind in KINDS:
        wj = _jpack(aj, kind)
        vals = np.asarray(wj.vals.astype(jnp.float32)
                          if kind == "bfloat16" else wj.vals)
        wt = TWEll.from_numpy(
            vals, np.asarray(wj.loc), np.asarray(wj.base), wj.shape, wj.nnz,
            wj.pad_cols,
            vals_lo=None if wj.vals_lo is None else np.asarray(wj.vals_lo),
            dtype=getattr(torch, kind) if kind == "bfloat16" else None)
        ref = _tpack(at, kind)
        for f in ("vals", "loc", "base"):
            assert torch.equal(getattr(wt, f), getattr(ref, f)), (kind, f)
        assert (wt.shape, wt.nnz, wt.pad_cols) == (ref.shape, ref.nnz,
                                                   ref.pad_cols)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    _, at = _fem("fem2d-2500")
    w = TWEll.from_csr(at)
    x32 = torch.zeros(w.pad_cols)
    with pytest.raises(TypeError):
        well_kernel.spmv(w, x32.double())              # (f32, f64)
    with pytest.raises(ValueError, match="vals_lo"):
        well_kernel.spmv_df64(w, x32.double())         # no lo plane
    with pytest.raises(TypeError):
        well_kernel.spmv_df64(TWEll.from_csr_df64(at), x32)   # f32 x
    with pytest.raises(ValueError):
        well_kernel.spmv(w, torch.zeros(4, w.pad_cols))
    counts = dict(well_kernel.launches)
    by_shape = dict(well_kernel.launches_by_shape)
    well_kernel.spmv(w, x32)   # CPU tensors: plain version, no launch
    assert well_kernel.launches == counts
    assert well_kernel.launches_by_shape == by_shape


def test_fcg_steps_match_amg_tpu():
    """The port's flexible-CG steps against amg_tpu's, f64, Jacobi
    preconditioner, on the same operator: ``rtol=1e-12``."""
    from amg_tpu.solve import krylov as jk
    from amg_tpu_torch.solve import krylov as tk

    aj, at = _fem("fem2d-2500")
    m = at.to_scipy()
    dinv = 1.0 / m.diagonal()
    b = _x(at.n_rows, np.float64, seed=6)
    jam = lambda v: jnp.asarray(m @ np.asarray(v))
    jpr = lambda r: jnp.asarray(dinv) * r
    tam = lambda v: torch.from_numpy(m @ v.numpy())
    tpr = lambda r: torch.from_numpy(dinv) * r
    sj = jk.fcg_init(jam, jpr, jnp.asarray(b), jnp.zeros(at.n_rows))
    st = tk.fcg_init(tam, tpr, torch.from_numpy(b),
                     torch.zeros(at.n_rows, dtype=torch.float64))
    for it in range(8):
        if it == 5:
            sj, rj = jk.fcg_refresh(jam, jpr, jnp.asarray(b), sj)
            st, rt = tk.fcg_refresh(tam, tpr, torch.from_numpy(b), st)
        else:
            sj, rj = jk.fcg_step(jam, jpr, sj)
            st, rt = tk.fcg_step(tam, tpr, st)
        assert float(rt) == pytest.approx(float(rj), rel=1e-12)
        for vj, vt in zip(sj, st):
            np.testing.assert_allclose(vt.numpy(), np.asarray(vj),
                                       rtol=1e-12,
                                       atol=1e-12 * np.abs(np.asarray(vj))
                                       .max())
