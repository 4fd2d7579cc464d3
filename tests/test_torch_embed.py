"""The port's fine-grid embedding against amg_tpu's: the embedding plan,
the embedded device packs (Dia operators over level 0's pad, the boundary
index arrays), the port's versions of amg_tpu's embedding tests
(tests/test_solve.py:408, 431, 445, 548), and solves on the embedded
layout against amg_tpu's.

amg_tpu runs here with 8 virtual devices, where its "auto" resolves to
off, so both packages get ``embed_levels``, ``use_well`` and
``use_banded`` explicitly.  amg_tpu pads ``compact_idx``/``member_idx``
with the out-of-range value ``pad0``; the port keeps only the valid
prefix, so the prefixes are compared.  Tolerances: packs and plans exact;
f64 solves equal iterations and X to ``1e-10`` relative; the bench
configuration in f32 (bf16 embedded operators) equal iterations and
residual histories at ``rtol=1e-3`` plus ``atol=1e-6 * ||b||``, the f32
rounding floor of ROADMAP queue C item 3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import amg_tpu as jamg
from amg_tpu import hierarchy as jh
from amg_tpu.io import checkpoint as jck
from amg_tpu.ops import pallas_dia

import amg_tpu_torch as tamg
from amg_tpu_torch import hierarchy as th
from amg_tpu_torch.ops import spmv as tspmv

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

QUIET = dict(log=lambda *a, **k: None)
CPU = dict(device="cpu")
ON = dict(use_well="on", use_banded="on", verbose=0)
CHEB = "CHEBYSHEV"


def _pars(pkg, **kw):
    for key in ("smoother", "coarse_smoother"):
        if key in kw:
            kw[key] = pkg.SmootherType[kw[key]]
    return pkg.AMGParams(**{**ON, **kw})


def _bench_pars(pkg, **kw):
    """The structured main path (chip_smoke.py phase 14) at test size."""
    return _pars(pkg, dtype="float32", refine=True, smoother="GS",
                 coarse_smoother=CHEB, coarse_op_dtype="bfloat16",
                 coarse_sparsify=0.005, sparsify_from_level=2,
                 coarse_stop_rows=100, tol=1e-8, max_it=60, embed_levels=8,
                 **kw)


CASES = {
    "p3d14": (lambda p: p.poisson3d(14), dict(embed_levels=8)),
    "p3d14-compact": (lambda p: p.poisson3d(14),
                      dict(embed_levels=2, coarse_smoother=CHEB,
                           embed_boundary="compact")),
    "p3d14-forced": (lambda p: p.poisson3d(14),
                     dict(embed_levels=2, coarse_smoother=CHEB,
                          embed_boundary="embedded", embed_max_diags=60)),
    "p3d12-bench": (lambda p: p.poisson3d(12), None),
}


def _case_pars(pkg, name):
    kw = CASES[name][1]
    return _bench_pars(pkg) if kw is None else _pars(pkg, **kw)


def _host_pair(name):
    mk = CASES[name][0]
    pj, pt = _case_pars(jamg, name), _case_pars(tamg, name)
    return jh.setup_host(mk(jamg), pj), th.setup_host(mk(tamg), pt), pj, pt


def _np(t):
    return t.cpu().float().numpy() if t.dtype == torch.bfloat16 \
        else t.cpu().numpy()


def _jnp(v):
    return np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                      else v)


def test_good_pad_matches_amg_tpu():
    for n in (0, 1, 4095, 65536, 88174, 1_000_000, 1_000_001, 10_648_000):
        assert th.good_pad(n) == pallas_dia.good_pad(n), n
    assert th.good_pad(1_000_000) == 1_024_000


@pytest.mark.parametrize("name", list(CASES))
def test_embedding_plan_matches_amg_tpu(name):
    """(E, emb, boundary) equal, and E as each case expects."""
    hj, ht, pj, pt = _host_pair(name)
    Ej, embj, bj = jh.embedding_plan(hj, pj)
    Et, embt, bt = th.embedding_plan(ht, pt)
    assert (Et, bt) == (Ej, bj)
    assert len(embt) == len(embj)
    for l, (ej, et) in enumerate(zip(embj, embt)):
        np.testing.assert_array_equal(et, ej, err_msg=f"emb[{l}]")
    want = {"p3d14": (1, "embedded"), "p3d14-compact": (2, "compact"),
            "p3d14-forced": (1, "embedded"), "p3d12-bench": (2, "embedded")}
    assert (Et, bt) == want[name]


def _assert_level_equal(lj, lt, l, pad0):
    for op in ("a", "p", "r"):
        oj, ot = getattr(lj, op), getattr(lt, op)
        assert (oj is None) == (ot is None), f"{op}[{l}]"
        if oj is None:
            continue
        assert type(oj).__name__ == type(ot).__name__, f"{op}[{l}]"
        if type(ot).__name__ == "Dia":
            assert tuple(oj.offsets) == ot.offsets, f"{op}[{l}]"
            assert ot.padded_rows == pad0
        assert (ot.vals.dtype == torch.bfloat16) == \
            (oj.vals.dtype == jnp.bfloat16)
        np.testing.assert_array_equal(_np(ot.vals), _jnp(oj.vals),
                                      err_msg=f"{op}[{l}]")
        if type(ot).__name__ == "Ell":
            np.testing.assert_array_equal(ot.cols.numpy(),
                                          np.asarray(oj.cols))
    for v in ("diag", "inv_diag", "l1_inv", "gid", "gs_w"):
        vj, vt = getattr(lj, v), getattr(lt, v)
        assert (vj is None) == (vt is None), f"{v}[{l}]"
        if vj is not None:
            np.testing.assert_array_equal(_np(vt), _jnp(vj),
                                          err_msg=f"{v}[{l}]")
    assert lj.group_cf == lt.group_cf
    assert float(lj.rho_dinv_a) == lt.rho_dinv_a
    for v in ("compact_idx", "member_idx"):
        vj, vt = getattr(lj, v), getattr(lt, v)
        assert (vj is None) == (vt is None), f"{v}[{l}]"
        if vj is not None:
            vj = np.asarray(vj)
            # the padding amg_tpu appends is out of range; the port keeps
            # the valid prefix only
            assert np.all(vj[len(vt):] == pad0)
            assert vt.dtype == torch.int64 and int(vt.max()) < pad0
            np.testing.assert_array_equal(vt.numpy(), vj[: len(vt)])


@pytest.mark.parametrize("name", list(CASES))
def test_embedded_pack_matches_amg_tpu(name):
    """``setup`` (plan, reorder below the embedded levels, pack) gives the
    same host hierarchy and device pack as amg_tpu: every embedded A/P/R
    Dia at level 0's pad with the same offsets and values, the compact
    levels below, the boundary index arrays, pads, diagonals, group ids,
    level 0's fused-GS weights and the coarse inverse."""
    mk = CASES[name][0]
    pj, pt = _case_pars(jamg, name), _case_pars(tamg, name)
    mj, hj = jh.setup(mk(jamg), pj, **QUIET)
    mt, ht = th.setup(mk(tamg), pt, **QUIET, **CPU)
    E = th.embedding_plan(ht, pt)[0]
    pad0 = mt.levels[0].pad
    assert [l.pad for l in mt.levels] == [l.pad for l in mj.levels]
    assert all(mt.levels[l].pad == pad0 for l in range(E + 1))
    assert [type(l.a).__name__ for l in mt.levels] == \
        [type(l.a).__name__ for l in mj.levels]
    for l, (pj_, pt_) in enumerate(zip(hj.perms, ht.perms)):
        assert (pj_ is None) == (pt_ is None)
        if pj_ is not None:
            np.testing.assert_array_equal(pt_, pj_)
    for l, (lj, lt) in enumerate(zip(mj.levels, mt.levels)):
        _assert_level_equal(lj, lt, l, pad0)
    np.testing.assert_array_equal(_np(mt.coarse_inv), _jnp(mj.coarse_inv))
    if name == "p3d12-bench":
        assert mt.levels[0].gs_w is not None
        assert all(mt.levels[l].gs_w is None for l in range(1, E + 1))
        assert mt.levels[0].p.vals.dtype == torch.bfloat16
        assert mt.levels[E].compact_idx is not None


def test_embedded_levels_match_compact():
    """The port's tests/test_solve.py:408: the embedded hierarchy
    reproduces the compact one's convergence."""
    a = tamg.poisson3d(14)
    b = np.random.default_rng(11).standard_normal(a.n_rows)
    s_e = tamg.AMGSolver(a, _pars(tamg, tol=1e-10, embed_levels=8),
                         **QUIET, **CPU)
    assert s_e.mg.levels[1].pad == s_e.mg.levels[0].pad
    s_c = tamg.AMGSolver(a, _pars(tamg, tol=1e-10, embed_levels=0),
                         **QUIET, **CPU)
    assert s_c.mg.levels[1].pad != s_c.mg.levels[0].pad
    x_e, info_e = s_e.solve(b)
    x_c, info_c = s_c.solve(b)
    assert np.linalg.norm(b - a.matvec(x_e)) / np.linalg.norm(b) < 1e-10
    assert abs(info_e.nits - info_c.nits) <= 1
    np.testing.assert_allclose(x_e, x_c, rtol=1e-6, atol=1e-9)


def test_embedded_chebyshev_coarse():
    """The port's tests/test_solve.py:431."""
    a = tamg.poisson3d(14)
    b = np.ones(a.n_rows)
    s = tamg.AMGSolver(a, _pars(tamg, tol=1e-8, embed_levels=8,
                                coarse_smoother=CHEB), **QUIET, **CPU)
    x, info = s.solve(b)
    assert np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b) < 1e-8
    assert info.nits <= 20


def test_embedded_spmv_matches_compact():
    """The port's tests/test_solve.py:445: embedded A_1 and P_0 products
    equal the compact host products, and non-member rows stay zero."""
    a = tamg.poisson3d(10)
    pars = _pars(tamg, embed_levels=8)
    hh = th.setup_host(a, pars, **QUIET)
    plan = th.embedding_plan(hh, pars)
    E, emb = plan[0], plan[1]
    assert E >= 1
    mg = th.to_device(hh, pars, plan=plan, **CPU)
    rng = np.random.default_rng(0)
    n0, pad0 = a.n_rows, mg.levels[0].pad
    x1 = rng.standard_normal(hh.a[1].n_rows)
    xe = np.zeros(pad0)
    xe[emb[1]] = x1
    ye = tspmv.spmv(mg.levels[1].a, torch.from_numpy(xe)).numpy()
    np.testing.assert_allclose(ye[emb[1]], hh.a[1].matvec(x1), rtol=1e-12,
                               atol=1e-13)
    mask = np.ones(pad0, bool)
    mask[emb[1]] = False
    assert np.abs(ye[mask]).max() == 0.0
    ype = tspmv.spmv(mg.levels[0].p, torch.from_numpy(xe)).numpy()
    np.testing.assert_allclose(ype[:n0], hh.p[0].matvec(x1), rtol=1e-12,
                               atol=1e-13)


def test_compact_boundary_matches_embedded():
    """The port's tests/test_solve.py:548: embed_boundary="compact" (Ell
    P_E/R_E and member_idx) converges as the embedded boundary does, for
    one vector and for a batch."""
    a = tamg.poisson3d(14)
    b = np.random.default_rng(11).standard_normal(a.n_rows)
    base = dict(embed_levels=2, coarse_smoother=CHEB)
    s_emb = tamg.AMGSolver(a, _pars(tamg, embed_boundary="embedded", **base),
                           **QUIET, **CPU)
    s_cmp = tamg.AMGSolver(a, _pars(tamg, embed_boundary="compact", **base),
                           **QUIET, **CPU)
    assert s_emb.mg.levels[0].compact_idx is None
    lb_emb = next(l for l in s_emb.mg.levels if l.compact_idx is not None)
    lb_cmp = next(l for l in s_cmp.mg.levels if l.member_idx is not None)
    assert isinstance(lb_emb.p, tamg.Dia) and isinstance(lb_cmp.p, tamg.Ell)
    x1, i1 = s_emb.solve(b)
    x2, i2 = s_cmp.solve(b)
    assert i1.rres < 1e-6 and i2.rres < 1e-6
    assert abs(i1.nits - i2.nits) <= 1
    assert np.linalg.norm(b - a.matvec(x2)) / np.linalg.norm(b) < 1e-6
    B = np.stack([b, np.ones(a.n_rows)], axis=1)
    X, ib = s_cmp.solve_batched(B)
    assert ib.rres < 1e-6
    np.testing.assert_allclose(X[:, 0], x2, rtol=0,
                               atol=1e-10 * np.abs(x2).max())


@pytest.mark.parametrize("boundary", ["embedded", "compact"])
def test_embedded_solve_matches_amg_tpu(boundary):
    """f64 solves on the embedded layout with Chebyshev below level 0:
    equal iterations, X to 1e-10 relative; and a batched solve (k = 2)."""
    kw = dict(tol=1e-10, embed_levels=2, coarse_smoother=CHEB,
              embed_boundary=boundary)
    B = np.random.default_rng(13).standard_normal((1000, 2))
    sj = jamg.AMGSolver(jamg.poisson3d(10), _pars(jamg, **kw), **QUIET)
    st = tamg.AMGSolver(tamg.poisson3d(10), _pars(tamg, **kw), **QUIET,
                        **CPU)
    assert st.mg.levels[1].pad == st.mg.levels[0].pad
    xj, ij = sj.solve(B[:, 0])
    xt, it = st.solve(B[:, 0])
    assert it.nits == ij.nits
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-10 * np.abs(xj).max())
    Xj, bij = sj.solve_batched(B, tol=1e-10)
    Xt, bit = st.solve_batched(B, tol=1e-10)
    assert bit.nits == bij.nits
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-10 * np.abs(Xj).max())


def test_bench_config_matches_amg_tpu():
    """The bench configuration (f32 cycles with defect correction, bf16
    embedded operators, E = 2) at poisson3d(12), the port on "auto"
    against amg_tpu on "on": equal iterations, residual histories at rtol
    1e-3 plus atol 1e-6 * ||b||, true residual below 1e-8."""
    b = np.ones(1728)
    sj = jamg.AMGSolver(jamg.poisson3d(12), _bench_pars(jamg), **QUIET)
    pt = _bench_pars(tamg).replace(use_well="auto", use_banded="auto")
    st = tamg.AMGSolver(tamg.poisson3d(12), pt, **QUIET, **CPU)
    assert st.mg.levels[2].pad == st.mg.levels[0].pad
    assert st.mg.levels[1].a.vals.dtype == torch.bfloat16
    _, ij = sj.solve(b)
    a = tamg.poisson3d(12)
    x, it = st.solve(b)
    assert it.nits == ij.nits
    np.testing.assert_allclose(it.residuals, ij.residuals, rtol=1e-3,
                               atol=1e-6 * np.linalg.norm(b))
    assert np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b) < 1e-8


def test_restored_hierarchy_takes_the_setup_order(tmp_path):
    """A hierarchy saved by amg_tpu before any reordering goes through the
    port's ``setup`` in amg_tpu's order (plan, reorder below the embedded
    levels, pack) and packs as amg_tpu packs it."""
    pj, pt = _case_pars(jamg, "p3d12-bench"), _case_pars(tamg, "p3d12-bench")
    hj = jh.setup_host(jamg.poisson3d(12), pj)
    path = tmp_path / "hh.npz"
    jck.save_hierarchy(path, hj)
    ht = tamg.load_hierarchy(path)
    assert ht.perms is None
    mj, _ = jh.setup(None, pj, hh=hj, **QUIET)
    mt, _ = th.setup(None, pt, hh=ht, **QUIET, **CPU)
    pad0 = mt.levels[0].pad
    for l, (lj, lt) in enumerate(zip(mj.levels, mt.levels)):
        _assert_level_equal(lj, lt, l, pad0)


def test_embedded_bf16_layout_without_jax():
    """The bench configuration's embedded bf16 layout (and BandedBlocks
    under "auto") sets up and solves in a process that never imports jax:
    the coarse operators' byte counts cannot lean on JAX's bfloat16
    numpy type."""
    import os
    import subprocess
    import sys

    code = ("import sys, numpy as np, amg_tpu_torch as amg\n"
            "a = amg.poisson3d(12)\n"
            "p = amg.AMGParams(dtype='float32', refine=True,\n"
            "    smoother=amg.SmootherType.GS,\n"
            "    coarse_smoother=amg.SmootherType.CHEBYSHEV,\n"
            "    coarse_op_dtype='bfloat16', coarse_stop_rows=100,\n"
            "    tol=1e-8, embed_levels=8, verbose=0)\n"
            "s = amg.AMGSolver(a, p, log=lambda *a: None, device='cpu')\n"
            "assert s.mg.levels[2].pad == s.mg.levels[0].pad\n"
            "x, info = s.solve(np.ones(a.n_rows))\n"
            "assert info.rres < 1e-8, info.rres\n"
            "assert 'jax' not in sys.modules and 'ml_dtypes' not in "
            "sys.modules\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
