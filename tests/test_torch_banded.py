"""The port's BandedBlocks format against amg_tpu's: the pack, the block
product, the RCM branch of ``reorder_for_gs`` (with and without clipping),
the device pack, solves on BandedBlocks levels, and the one-device
resolution of ``use_well`` / ``use_banded`` on "auto": "on" is amg_tpu's
rule, and "auto" keeps a band only where it reads fewer bytes than the
level's sparse pack, sending the declined levels to WEll.

amg_tpu runs here under the repo's conftest with 8 virtual devices, where
its "auto" resolves to off, so amg_tpu is always given the flags
explicitly ("on" where the port runs "on" or "auto").  Inputs are made
from seeds with numpy and handed to both packages.  Tolerances, and why they are not
zero:

* packs: none (``array_equal``).  amg_tpu rounds f64 -> bf16 directly, the
  port through f32 (ROADMAP queue C item 4); a double-rounding tie would
  fail here.
* the product against amg_tpu's XLA einsum (the packages sum the 128 x
  (2 nb + 1) products of a row in other orders): f32 ``2e-6``, bf16
  values ``1e-5`` (x rounded to bf16 in both, exact products summed in
  f32), f64 ``1e-13``, each of ``max|Ax|``.
* solves in f64: equal iterations and X to ``1e-10`` relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import amg_tpu as jamg
from amg_tpu import hierarchy as jh
from amg_tpu.ops.spmv import spmv_banded as jax_spmv_banded
from amg_tpu.sparse import BandedBlocks as JBanded

import amg_tpu_torch as tamg
from amg_tpu_torch import hierarchy as th, tracing
from amg_tpu_torch.io import checkpoint as tck
from amg_tpu_torch.ops import spmv as tspmv
from amg_tpu_torch.sparse import BandedBlocks as TBanded, WEll as TWEll

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

QUIET = dict(log=lambda *a, **k: None)
CPU = dict(device="cpu")
# every level Ell below level 0 unless banded: amg_tpu's own
# test_banded_level_solve_matches_ell (tests/test_solve.py:646)
ELL = dict(max_diags=0, embed_levels=0, dense_level_bytes=0, verbose=0)
TOL = {"float32": 2e-6, "bfloat16": 1e-5, "float64": 1e-13}


def _pars(pkg, **kw):
    for key in ("smoother", "coarse_smoother"):
        if key in kw:
            kw[key] = pkg.SmootherType[kw[key]]
    return pkg.AMGParams(**kw)


def _host_pair(mk, **kw):
    """amg_tpu's and the port's reordered host hierarchies of the same
    matrix under the same flags."""
    pj, pt = _pars(jamg, **kw), _pars(tamg, **kw)
    hj = jh.reorder_for_gs(jh.setup_host(mk(jamg), pj), pj)
    ht = th.reorder_for_gs(th.setup_host(mk(tamg), pt), pt)
    return hj, ht, pj, pt


@pytest.fixture(scope="module")
def banded_pair():
    """poisson3d(12) with every level Ell and BandedBlocks on."""
    return _host_pair(lambda p: p.poisson3d(12), use_banded="on",
                      use_well="off", **ELL)


def _np(t):
    return t.cpu().float().numpy() if t.dtype == torch.bfloat16 \
        else t.cpu().numpy()


def _jnp(v):
    return np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                      else v)


def _assert_csr_equal(mj, mt, what):
    assert mj.shape == mt.shape, what
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(mj, field), getattr(mt, field),
                                      err_msg=f"{what}.{field}")


def test_fixture_has_banded_levels(banded_pair):
    hj, ht, _, _ = banded_pair
    assert ht.banded_nb == hj.banded_nb
    assert sum(nb is not None for nb in ht.banded_nb) >= 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_pack_matches_amg_tpu(banded_pair, dtype):
    """``BandedBlocks.from_csr`` on every banded level (and with the band
    given wider than the level's own) equals amg_tpu's array for array;
    ``block_bandwidth`` and ``to_csr`` agree."""
    hj, ht, _, _ = banded_pair
    for l, nb in enumerate(ht.banded_nb):
        if nb is None:
            continue
        aj, at = hj.a[l], ht.a[l]
        assert TBanded.block_bandwidth(at) == JBanded.block_bandwidth(aj)
        for nb_, pad in ((nb, None), (nb + 1, 128 * 9)):
            bj = JBanded.from_csr(aj, dtype=getattr(jnp, dtype), nb=nb_,
                                  pad_rows_to=pad)
            bt = TBanded.from_csr(at, dtype=getattr(torch, dtype), nb=nb_,
                                  pad_rows_to=pad, **CPU)
            assert bt.vals.dtype == getattr(torch, dtype)
            assert (bt.nb, bt.shape, bt.nnz, bt.padded_rows) == \
                (bj.nb, bj.shape, bj.nnz, bj.padded_rows)
            np.testing.assert_array_equal(_np(bt.vals), _jnp(bj.vals))
            _assert_csr_equal(bj.to_csr(), bt.to_csr(), f"to_csr[{l}]")
        if dtype == "float64":
            np.testing.assert_array_equal(bt.to_csr().to_dense(),
                                          at.to_dense())
    with pytest.raises(ValueError, match="band"):
        TBanded.from_csr(at, nb=0, **CPU)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_spmv_banded_matches_amg_tpu(banded_pair, dtype, k):
    """One vector and a ``(k, pad)`` batch through ``spmv`` against
    amg_tpu's XLA product (per column), x in f64 for f64 values and f32
    otherwise; the output takes x's dtype."""
    _, ht, _, _ = banded_pair
    l = next(l for l, nb in enumerate(ht.banded_nb) if nb is not None)
    at, nb = ht.a[l], ht.banded_nb[l]
    bj = JBanded.from_csr(jamg.CSR(at.indptr, at.indices, at.data,
                                   at.shape),
                          dtype=getattr(jnp, dtype), nb=nb)
    bt = TBanded.from_csr(at, dtype=getattr(torch, dtype), nb=nb, **CPU)
    xdt = np.float64 if dtype == "float64" else np.float32
    x = np.random.default_rng(3).standard_normal(
        (k, bt.padded_rows)).astype(xdt)
    want = np.stack([np.asarray(jax_spmv_banded(bj, jnp.asarray(xc)))
                     for xc in x])
    got = tspmv.spmv(bt, torch.from_numpy(x if k > 1 else x[0]))
    assert got.dtype == torch.from_numpy(x).dtype
    assert got.shape == ((k, bt.padded_rows) if k > 1
                         else (bt.padded_rows,))
    got = got.numpy().reshape(k, -1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype] * scale)


@pytest.mark.parametrize("clip", [False, True], ids=["fits", "clipped"])
def test_reorder_for_gs_banded_matches_amg_tpu(clip):
    """The RCM branch of ``reorder_for_gs``: identical permutations,
    ``banded_nb`` and A/P/R.  ``clipped``: a byte budget one block column
    short of level 1's band, so the band is clipped to it and the
    out-of-band entries lumped into the diagonal."""
    kw = dict(use_banded="on", use_well="off", **ELL)
    mk = lambda p: p.poisson3d(14)   # noqa: E731  (level 1: nb 2)
    if clip:
        hj = _host_pair(mk, **kw)[0]
        nb = hj.banded_nb[1]
        nbr = -(-hj.a[1].n_rows // 128)
        kw["banded_level_bytes"] = nbr * (2 * nb - 1) * 128 * 128 * 8
        kw["banded_clip_frac"] = 0.05
    hj, ht, _, _ = _host_pair(mk, **kw)
    assert ht.banded_nb == hj.banded_nb
    assert ht.banded_nb[1] is not None
    if clip:
        assert ht.banded_nb[1] == nb - 1
        assert TBanded.block_bandwidth(ht.a[1]) == nb - 1
    for name in ("a", "p", "r"):
        for l, (mj, mt) in enumerate(zip(getattr(hj, name),
                                         getattr(ht, name))):
            _assert_csr_equal(mj, mt, f"{name}[{l}]")
    for l, (vj, vt) in enumerate(zip(hj.perms, ht.perms)):
        assert (vj is None) == (vt is None), l
        if vj is not None:
            np.testing.assert_array_equal(vj, vt, err_msg=f"perms[{l}]")


def test_clip_to_band_matches_amg_tpu(banded_pair):
    hj, ht, _, _ = banded_pair
    for nb in (0, 1, 2):
        _assert_csr_equal(jh.clip_to_band(hj.a[1], nb),
                          th.clip_to_band(ht.a[1], nb), f"nb={nb}")


def test_device_pack_matches_amg_tpu(banded_pair):
    """``to_device``: same formats, pads, BandedBlocks values, Ell P/R,
    diagonals and GS group ids (masked GS on BandedBlocks levels)."""
    hj, ht, pj, pt = banded_pair
    mj = jh.to_device(hj, pj)
    mt = th.to_device(ht, pt, **CPU)
    kinds = [type(l.a).__name__ for l in mt.levels]
    assert kinds == [type(l.a).__name__ for l in mj.levels]
    assert "BandedBlocks" in kinds
    for l, (lj, lt) in enumerate(zip(mj.levels, mt.levels)):
        assert lj.pad == lt.pad, l
        for op in ("a", "p", "r"):
            oj, ot = getattr(lj, op), getattr(lt, op)
            assert (oj is None) == (ot is None)
            if oj is not None:
                assert type(oj).__name__ == type(ot).__name__
                np.testing.assert_array_equal(_np(ot.vals), _jnp(oj.vals),
                                              err_msg=f"{op}[{l}]")
        for v in ("diag", "inv_diag", "l1_inv", "gid"):
            vj, vt = getattr(lj, v), getattr(lt, v)
            assert (vj is None) == (vt is None), f"{v}[{l}]"
            if vj is not None:
                np.testing.assert_array_equal(_np(vt), _jnp(vj),
                                              err_msg=f"{v}[{l}]")
        assert lj.group_cf == lt.group_cf
        if kinds[l] == "BandedBlocks":
            assert lt.gid is not None and lt.ranges is None


def test_banded_level_solve_matches_ell():
    """The port's tests/test_solve.py:646: BandedBlocks on the coarse
    levels reproduces the Ell solve (same numerics, other storage)."""
    a = tamg.poisson3d(12)
    b = np.random.default_rng(19).standard_normal(a.n_rows)
    base = tamg.AMGParams(tol=1e-8, use_well="off", **ELL)
    s_ell = tamg.AMGSolver(a, base.replace(use_banded="off"), **QUIET, **CPU)
    s_bb = tamg.AMGSolver(a, base.replace(use_banded="on"), **QUIET, **CPU)
    assert any(isinstance(l.a, TBanded) for l in s_bb.mg.levels[1:])
    assert all(isinstance(l.a, tamg.Ell) for l in s_ell.mg.levels)
    x1, i1 = s_ell.solve(b)
    x2, i2 = s_bb.solve(b)
    assert i1.rres < 1e-8 and i2.rres < 1e-8
    assert abs(i1.nits - i2.nits) <= 1
    assert np.linalg.norm(b - a.matvec(x2)) / np.linalg.norm(b) < 1e-8


def test_banded_solve_matches_amg_tpu():
    """f64 solves and batched solves (k = 3) on the BandedBlocks layout,
    both packages on "on": equal iterations, X to 1e-10 relative."""
    b = np.random.default_rng(5).standard_normal((1728, 3))
    kw = dict(tol=1e-10, use_banded="on", use_well="on", **ELL)
    sj = jamg.AMGSolver(jamg.poisson3d(12), jamg.AMGParams(**kw), **QUIET)
    st = tamg.AMGSolver(tamg.poisson3d(12), tamg.AMGParams(**kw), **QUIET,
                        **CPU)
    assert [type(l.a).__name__ for l in st.mg.levels] == \
        [type(l.a).__name__ for l in sj.mg.levels]
    assert any(isinstance(l.a, TBanded) for l in st.mg.levels)
    xj, ij = sj.solve(b[:, 0])
    xt, it = st.solve(b[:, 0])
    assert it.nits == ij.nits
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-10 * np.abs(xj).max())
    Xj, bij = sj.solve_batched(b, tol=1e-10)
    Xt, bit = st.solve_batched(b, tol=1e-10)
    assert bit.nits == bij.nits
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-10 * np.abs(Xj).max())


def _fem_pars(pkg, **kw):
    """The unstructured main path (chip_smoke.py phase 15) at test size:
    fem2d(20000) with well_min_rows and the Dense budget lowered, so that
    the top levels are WEll and the RCM band of the levels below fits."""
    return pkg.AMGParams(
        dtype="float32", refine=True, accel="cg",
        smoother=pkg.SmootherType.GS,
        coarse_smoother=pkg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="float32", coarse_sparsify=0, coarse_stop_rows=500,
        tol=1e-8, max_it=60, embed_levels=0, well_min_rows=4096,
        dense_level_bytes=2e6, verbose=0, **kw)


VALUE_BYTES = {"bfloat16": 2, "float32": 4, "float64": 8}


def _well_bytes(a, value_bytes):
    """Bytes of one B2 product on ``a``'s WEll pack, counted here: per
    nonzero its value and 4 B column, 8 B per row of whole 32-row slices,
    an 8 B pointer per slice and one more, x and y once in f32."""
    n, slices = a.n_rows, -(-a.n_rows // 32)
    return (a.nnz * (value_bytes + 4) + slices * 32 * 8 + (slices + 1) * 8
            + (a.n_cols + n) * 4)


def _declined(ht_on, pars):
    """Levels of a hierarchy reordered under "on" that "auto" sends to
    WEll (``use_well`` on), with their band's bytes: the band reads at
    least the bytes of the level's WEll pack, and no row of the level
    holds more than 128 entries (B2 reads a row with one thread)."""
    vb = VALUE_BYTES[pars.coarse_op_dtype]
    out = {}
    for l, nb in enumerate(ht_on.banded_nb):
        if nb is None:
            continue
        a = ht_on.a[l]
        band = -(-a.n_rows // 128) * (2 * nb + 1) * 128 * 128 * vb
        if band >= _well_bytes(a, vb) and np.diff(a.indptr).max() <= 128:
            out[l] = band
    return out


@pytest.mark.parametrize("case", ["structured", "unstructured"])
def test_auto_formats_match_amg_tpu_on(case):
    """The port's "on" is amg_tpu's "on": equal formats, ``banded_nb`` and
    pads.  The port's "auto" equals it on every level but those whose band
    reads at least the bytes of the level's WEll pack, on rows of at most
    128 entries: those pack as WEll (``formats``), each counted with its
    band's bytes in ``amg.setup.banded_declined``; "off" keeps no band."""
    if case == "structured":
        mk = lambda p: p.poisson3d(14)   # noqa: E731
        kw = dict(verbose=0, embed_levels=0, dense_level_bytes=1e5,
                  coarse_op_dtype="bfloat16", dtype="float32")
        pj, pt = jamg.AMGParams(**kw), tamg.AMGParams(**kw)
    else:
        mk = lambda p: p.fem2d(20000, seed=17)   # noqa: E731
        pj, pt = _fem_pars(jamg), _fem_pars(tamg)
    assert (pt.use_well, pt.use_banded) == ("auto", "auto")
    pj = pj.replace(use_well="on", use_banded="on")
    mj, hj = jh.setup(mk(jamg), pj, **QUIET)
    on, h_on = th.setup(mk(tamg), pt.replace(use_banded="on"), **QUIET,
                        **CPU)
    kinds = [type(l.a).__name__ for l in on.levels]
    assert kinds == [type(l.a).__name__ for l in mj.levels]
    assert h_on.banded_nb == hj.banded_nb
    assert [l.pad for l in on.levels] == [l.pad for l in mj.levels]
    assert "BandedBlocks" in kinds
    if case == "unstructured":
        assert "WEll" in kinds
    declined = _declined(h_on, pt)
    tracing.reset()
    auto, h_auto = th.setup(mk(tamg), pt, **QUIET, **CPU)
    row = tracing.totals()["amg.setup.banded_declined"]
    assert (row["n"], row["bytes"]) == (len(declined),
                                        sum(declined.values()))
    for l, lt in enumerate(auto.levels):
        if l in declined:
            assert isinstance(lt.a, TWEll), l
            assert h_auto.banded_nb[l] is None
            assert h_auto.formats[l] == "well"
        else:
            assert type(lt.a).__name__ == kinds[l], l
            assert h_auto.banded_nb[l] == h_on.banded_nb[l]
            assert h_auto.formats[l] == h_on.formats[l]
    if case == "unstructured":
        assert len(declined) >= 1
    off, _ = th.setup(mk(tamg), pt.replace(use_well="off", use_banded="off"),
                      **QUIET, **CPU)
    assert "BandedBlocks" not in [type(l.a).__name__ for l in off.levels]


def _block_diagonal_hierarchy(density, blk=128, seed=0):
    """A three-level host hierarchy whose level 1 is 2,048 rows in
    symmetric ``blk`` x ``blk`` blocks on the diagonal, each holding
    ``density`` of its entries (RCM keeps each block whole, so the band
    is the blocks' diagonal), below a level 0 of 8,192 rows, with
    aggregation transfers of 4 and 8 rows per coarse row."""
    from amg_tpu_torch.sparse import CSR

    rng = np.random.default_rng(seed)
    n1 = 2048
    rows, cols = [], []
    for b in range(n1 // blk):
        m = np.triu(rng.random((blk, blk)) < density, 1)
        m = m | m.T | np.eye(blk, dtype=bool)
        r, c = np.nonzero(m)
        rows.append(r + b * blk)
        cols.append(c + b * blk)
    r, c = np.concatenate(rows), np.concatenate(cols)
    deg = np.bincount(r, minlength=n1)
    v = np.where(r == c, deg[r] + 1.0, -1.0)
    a1 = CSR.from_coo(r, c, v, (n1, n1))

    def agg(n_fine, k):
        i = np.arange(n_fine)
        return CSR.from_coo(i, i // k, np.ones(n_fine), (n_fine, n_fine // k))

    p0, p1 = agg(4 * n1, 4), agg(n1, 8)
    a0 = tamg.poisson2d(64, 128)
    a2 = p1.transpose().to_scipy() @ a1.to_scipy() @ p1.to_scipy()
    return th.HostHierarchy(a=[a0, a1, CSR.from_scipy(a2.tocsr())],
                            p=[p0, p1], r=[p0.transpose(), p1.transpose()],
                            cfmark=[])


@pytest.mark.parametrize("fmt", ["ell", "dense"])
@pytest.mark.parametrize("density,blk,banded", [
    (0.9, 128, True), (0.3, 128, False), (0.6, 256, True)],
    ids=["full-blocks", "sparse-blocks", "long-rows"])
def test_auto_keeps_a_band_that_reads_fewer_bytes(density, blk, banded,
                                                  fmt):
    """A level of nearly full 128 x 128 blocks keeps its band under
    "auto" (f32: 4 B a stored entry against WEll's 8 B a nonzero), one
    of blocks 30% full goes to WEll, whether the level would be Ell or
    Dense without a band, and one of 256 x 256 blocks 60% full (~150
    entries a row, past the 128 that B2's one thread a row reads at the
    pace of its bytes) keeps a band that reads more bytes than its WEll
    pack would; "on" keeps every band."""
    pars = tamg.AMGParams(verbose=0, dtype="float32", max_diags=0,
                          dense_level_bytes=0 if fmt == "ell" else 2e8,
                          embed_levels=0)
    hh = _block_diagonal_hierarchy(density, blk)
    a1 = hh.a[1]
    assert th._pick_format(a1, pars) == fmt
    tracing.reset()
    th.reorder_for_gs(hh, pars)
    row = tracing.totals()["amg.setup.banded_declined"]
    nb = 0 if blk == 128 else hh.banded_nb[1]
    band = 16 * (2 * nb + 1) * 128 * 128 * 4
    assert (row["n"], row["bytes"]) == ((0, 0) if banded else (1, band))
    assert (hh.banded_nb[1] == nb) == banded
    assert hh.formats[1] == ("banded" if banded else "well")
    if blk == 256:
        assert np.diff(a1.indptr).max() > 128
        assert band > _well_bytes(a1, 4)
    mg = th.to_device(hh, pars, **CPU)
    assert isinstance(mg.levels[1].a, TBanded if banded else TWEll)
    on = _block_diagonal_hierarchy(density, blk)
    th.reorder_for_gs(on, pars.replace(use_banded="on"))
    assert on.banded_nb[1] is not None and on.formats[1] == "banded"


@pytest.mark.parametrize("written", ["before", "round-trip"])
def test_checkpoint_packs_as_written(tmp_path, written):
    """``before``: a hierarchy that carries no formats (as written before
    they were kept, here by amg_tpu's writer, with "on"'s bands) restores
    and packs under "auto" as it did: its bands stay BandedBlocks.
    ``round-trip``: the port's "auto" hierarchy saved and restored keeps
    its formats and packs its WEll levels again."""
    pt = _fem_pars(tamg)
    a = tamg.fem2d(20000, seed=17)
    path = tmp_path / "hh.npz"
    if written == "before":
        pj = _fem_pars(jamg, use_well="on", use_banded="on")
        hj = jh.setup_host(jamg.fem2d(20000, seed=17), pj)
        jh.reorder_for_gs(hj, pj)
        from amg_tpu.io import checkpoint as jck

        jck.save_hierarchy(path, hj)
        want = [type(l.a).__name__ for l in jh.to_device(hj, pj).levels]
    else:
        want_mg, hw = th.setup(a, pt, **QUIET, **CPU)
        assert "well" in hw.formats[1:]
        tck.save_hierarchy(path, hw)
        want = [type(l.a).__name__ for l in want_mg.levels]
    ht = tck.load_hierarchy(path)
    assert any(nb is not None for nb in ht.banded_nb) == (written
                                                          == "before")
    assert ht.formats == (None if written == "before" else hw.formats)
    mg, _ = th.setup(None, pt, hh=ht, **QUIET, **CPU)
    assert [type(l.a).__name__ for l in mg.levels] == want


def test_unstructured_auto_solve_matches_amg_tpu():
    """fem2d(20000) with FCG, the port on its "auto" layout (WEll where
    amg_tpu's "on" keeps BandedBlocks) against amg_tpu on "on": FCG
    iterations within 1, residual histories at rtol 1e-3 plus atol
    1e-6 * ||b|| (the f32 rounding floor of ROADMAP queue C item 3), both
    true residuals below 1e-8."""
    b = np.random.default_rng(23).standard_normal(20000)
    ja, ta = jamg.fem2d(20000, seed=17), tamg.fem2d(20000, seed=17)
    sj = jamg.AMGSolver(ja, _fem_pars(jamg, use_well="on", use_banded="on"),
                        **QUIET)
    st = tamg.AMGSolver(ta, _fem_pars(tamg), **QUIET, **CPU)
    kinds = [(type(lj.a).__name__, type(lt.a).__name__)
             for lj, lt in zip(sj.mg.levels, st.mg.levels)]
    assert ("BandedBlocks", "WEll") in kinds
    xj, ij = sj.solve(b)
    xt, it = st.solve(b)
    assert abs(it.nits - ij.nits) <= 1
    n = min(len(it.residuals), len(ij.residuals))
    np.testing.assert_allclose(it.residuals[:n], ij.residuals[:n],
                               rtol=1e-3, atol=1e-6 * np.linalg.norm(b))
    for xv in (xt, xj):
        assert np.linalg.norm(b - ta.matvec(np.asarray(
            xv, dtype=np.float64))) / np.linalg.norm(b) < 1e-8
