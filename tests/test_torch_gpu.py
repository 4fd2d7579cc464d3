"""Tests of amg_tpu_torch that need a CUDA card (marker ``gpu``).

Each skips on a machine without a card.  The file imports neither jax nor
amg_tpu, so on the card's machine (which has no JAX) it runs as::

    python -m pytest --noconftest tests/test_torch_gpu.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the rest of the
suite).  Tolerances are those of tests/test_torch_dia.py,
tests/test_torch_well.py and tests/test_torch_solve.py.
"""

import json
import os

import numpy as np
import pytest
import torch

import amg_tpu_torch as amg
from amg_tpu_torch.ops import dense_kernel, dia_kernel, well_kernel
from amg_tpu_torch.sparse import CSR, Dense, Dia, WEll

pytestmark = pytest.mark.gpu

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TOL = {torch.float32: 2e-6, torch.bfloat16: 1e-5, torch.float64: 1e-13}
EPILOGUES = dia_kernel.EPILOGUES   # B1's counters (B4's: dia_kernel.MULTI)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _band_csr(n, nd, seed):
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


@pytest.mark.parametrize("vdtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("kind", ["band40", "p3d16"])
def test_dia_kernel_matches_plain(kind, vdtype):
    """CUDA kernel against its plain version on the card, every epilogue
    (the same check chip_smoke.py makes at 1M rows)."""
    _needs_card()
    a, pad = ((_band_csr(8192, 40, seed=0), 8192) if kind == "band40"
              else (amg.poisson3d(16), 4096))
    vdt = getattr(torch, vdtype)
    xdt = torch.float64 if vdt == torch.float64 else torch.float32
    cpu = Dia.from_csr(a, dtype=vdt, pad_rows_to=pad)
    gpu = Dia(cpu.vals.cuda(), cpu.offsets, cpu.shape, cpu.nnz)
    g = torch.Generator().manual_seed(5)
    x, b, w = (torch.randn(pad, generator=g, dtype=xdt) for _ in range(3))
    scale = dia_kernel.spmv(cpu, x).abs().max().item()
    for ep, fn, args in (("spmv", dia_kernel.spmv, (x,)),
                         ("resid", dia_kernel.resid, (x, b)),
                         ("update", dia_kernel.gs_update, (x, b, w))):
        key = (ep, vdt, xdt, len(cpu.offsets), pad)
        before = dia_kernel.launches[ep]
        before_shape = dia_kernel.launches_by_shape.get(key, 0)
        got = fn(gpu, *(t.cuda() for t in args))
        torch.cuda.synchronize()
        assert dia_kernel.launches[ep] == before + 1
        assert dia_kernel.launches_by_shape[key] == before_shape + 1
        assert got.is_cuda and got.dtype == xdt and got.shape == (pad,)
        err = (got.cpu() - fn(cpu, *args)).abs().max().item() / scale
        assert err <= TOL[vdt], (kind, vdtype, ep, err)


@pytest.mark.parametrize("k", [1, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("vdtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("kind", ["band40", "p3d16"])
def test_dia_multi_kernel_matches_plain(kind, vdtype, k):
    """Kernel B4 against its plain version on the card, every epilogue
    (spmv, resid, update over the batch), every dtype pair (band40 bf16:
    the nd >= 32 product rule) and every column block: k = 1 and 3 (blocks
    of 1), 6 (of 2), 4, 8 and 16 (the batched solve's)."""
    _needs_card()
    a, pad = ((_band_csr(8192, 40, seed=0), 8192) if kind == "band40"
              else (amg.poisson3d(16), 4096))
    vdt = getattr(torch, vdtype)
    xdt = torch.float64 if vdt == torch.float64 else torch.float32
    cpu = Dia.from_csr(a, dtype=vdt, pad_rows_to=pad)
    gpu = Dia(cpu.vals.cuda(), cpu.offsets, cpu.shape, cpu.nnz)
    g = torch.Generator().manual_seed(6)
    xb, bb = (torch.randn(k, pad, generator=g, dtype=xdt) for _ in range(2))
    w = torch.randn(pad, generator=g, dtype=xdt)
    scale = dia_kernel.spmv_multi_plain(cpu, xb).abs().max().item()
    for ep, fn, args in (("multi", dia_kernel.spmv_multi, (xb,)),
                         ("multi_resid", dia_kernel.resid_multi, (xb, bb)),
                         ("multi_update", dia_kernel.gs_update_multi,
                          (xb, bb, w))):
        key = (ep, vdt, xdt, len(cpu.offsets), pad, k)
        before = dia_kernel.launches[ep]
        before_shape = dia_kernel.launches_by_shape.get(key, 0)
        got = fn(gpu, *(t.cuda() for t in args))
        torch.cuda.synchronize()
        assert dia_kernel.launches[ep] == before + 1
        assert dia_kernel.launches_by_shape[key] == before_shape + 1
        assert got.is_cuda and got.dtype == xdt and got.shape == (k, pad)
        err = (got.cpu() - fn(cpu, *args)).abs().max().item() / scale
        assert err <= TOL[vdt], (kind, vdtype, k, ep, err)


def _flat_view(t, shift):
    """A contiguous copy of ``t`` whose data pointer lies ``shift`` elements
    past a 16-byte boundary."""
    buf = torch.zeros(t.numel() + shift, dtype=t.dtype, device=t.device)
    v = buf[shift:].view(t.shape)
    v.copy_(t)
    return v


EDGE_CASES = {
    # (offsets, pad, shift of the data pointers in elements)
    "pad-not-multiple-of-8": ((-64, -8, -1, 0, 1, 8, 64), 4099, 0),
    "misaligned-pointers": ((-64, -8, -1, 0, 1, 8, 64), 4096, 1),
    "run-wider-than-window": (tuple(range(-300, 301, 3)), 5000, 0),
    "offsets-beyond-pad": ((-1500, -1499, -3, 0, 3, 1499, 1500), 1000, 0),
    "pad-under-one-block": ((-7, -1, 0, 1, 7), 100, 0),
}


@pytest.mark.parametrize("vdtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_dia_kernels_at_the_design_edges(case, vdtype):
    """B1 (every epilogue) and B4 (every epilogue, k = 1, 3, 16) against
    their plain versions where the design takes its other paths: per-entry
    loads for a pad that is not a multiple of the rows per thread or for
    misaligned pointers, runs split for the window budget, windows and
    direct reads past both ends of x, a single partial block.  bf16 runs
    once more with offsets added up to nd >= 32 (bf16 products).  B4
    at k = 1 agrees with B1 to the dtype's tolerance (the same sums in
    offsets order; the two kernels' instructions differ)."""
    _needs_card()
    offs, pad, shift = EDGE_CASES[case]
    vdt = getattr(torch, vdtype)
    xdt = torch.float64 if vdt == torch.float64 else torch.float32
    variants = [offs]
    if vdt == torch.bfloat16 and len(offs) < 32:
        variants.append(tuple(sorted(set(offs) | set(range(-90, 91, 6)))))
        assert len(variants[-1]) >= 32
    g = torch.Generator().manual_seed(8)
    for offsets in variants:
        vals = torch.randn(len(offsets), pad, generator=g,
                           dtype=torch.float64).to(vdt)
        cpu = Dia(vals, offsets, (pad, pad), vals.numel())
        gpu = Dia(_flat_view(vals.cuda(), shift), offsets, (pad, pad),
                  vals.numel())
        x, b, w = (torch.randn(pad, generator=g, dtype=xdt) for _ in range(3))
        scale = dia_kernel.spmv_plain(cpu, x).abs().max().item()
        for fn, args in ((dia_kernel.spmv, (x,)), (dia_kernel.resid, (x, b)),
                         (dia_kernel.gs_update, (x, b, w))):
            got = fn(gpu, *(_flat_view(t.cuda(), shift) for t in args))
            err = (got.cpu() - fn(cpu, *args)).abs().max().item() / scale
            assert err <= TOL[vdt], (case, vdtype, fn.__name__, err)
        for k in (1, 3, 16):
            xb, bb = (torch.randn(k, pad, generator=g, dtype=xdt)
                      for _ in range(2))
            scale = dia_kernel.spmv_multi_plain(cpu, xb).abs().max().item()
            for fn, one, args in (
                    (dia_kernel.spmv_multi, dia_kernel.spmv, (xb,)),
                    (dia_kernel.resid_multi, dia_kernel.resid, (xb, bb)),
                    (dia_kernel.gs_update_multi, dia_kernel.gs_update,
                     (xb, bb, w))):
                dev = [_flat_view(t.cuda(), shift) for t in args]
                got = fn(gpu, *dev)
                err = (got.cpu() - fn(cpu, *args)).abs().max().item() / scale
                assert err <= TOL[vdt], (case, vdtype, fn.__name__, k, err)
                if k == 1:   # B1's arithmetic: the same sums and epilogue
                    single = one(gpu, *(t[0] if t.dim() == 2 else t
                                        for t in dev))
                    gap = (got[0] - single).abs().max().item() / scale
                    assert gap <= TOL[vdt], (case, fn.__name__, gap)


def test_cuda_tensor_never_falls_back():
    """A CUDA tensor reaches the kernel or raises."""
    _needs_card()
    a = amg.poisson3d(6)
    d = Dia.from_csr(a, dtype=torch.float32, device="cuda")
    with pytest.raises(TypeError):
        dia_kernel.spmv(d, torch.zeros(d.padded_rows, dtype=torch.float64,
                                       device="cuda"))
    with pytest.raises(ValueError):
        dia_kernel.spmv(d, torch.zeros(d.padded_rows))   # CPU x
    X = torch.zeros(2, d.padded_rows, device="cuda")
    w = torch.zeros(d.padded_rows, device="cuda")
    with pytest.raises(ValueError):
        dia_kernel.resid_multi(d, X, X.cpu())            # CPU B
    with pytest.raises(ValueError):
        dia_kernel.resid_multi(d, X, w)                  # B not (k, pad)
    with pytest.raises(TypeError):
        dia_kernel.gs_update_multi(d, X, X, w.double())
    with pytest.raises(ValueError):
        dia_kernel.gs_update_multi(d, X, X, w.cpu())     # CPU w
    with pytest.raises(ValueError):
        dia_kernel.gs_update_multi(d, X, X[:, 1:].contiguous(), w)
    with pytest.raises(ValueError, match="contiguous"):
        dia_kernel.gs_update_multi(d, X.T.contiguous().T, X, w)


@pytest.mark.parametrize("name", ["p2d32", "p3d16"])
def test_golden_on_card(name):
    """Reference protocol (f64) on the card: the f64 kernel instantiation."""
    _needs_card()
    with open(os.path.join(DATA, "golden", f"resid_{name}.json")) as f:
        gold = json.load(f)
    a = amg.poisson2d(32) if name == "p2d32" else amg.poisson3d(16)
    ones = np.ones(a.n_rows)
    before = dia_kernel.launches["update"]
    _, info = amg.solver_amg(a, ones, ones, amg.AMGParams(verbose=0),
                             log=lambda *_: None, device="cuda")
    assert dia_kernel.launches["update"] > before
    assert info.nits == gold["nits"]
    np.testing.assert_allclose(info.residuals, gold["residuals"], rtol=1e-3)


def test_slice_on_card():
    """The main-path configuration at test size on the card: converges to
    1e-8 (host-verified) through every kernel epilogue."""
    _needs_card()
    a = amg.poisson3d(20)
    pars = amg.AMGParams(
        dtype="float32", refine=True, smoother=amg.SmootherType.GS,
        coarse_smoother=amg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="bfloat16", coarse_sparsify=0.005,
        sparsify_from_level=2, coarse_stop_rows=3500, tol=1e-8, max_it=60,
        verbose=0, embed_levels=0, use_well="off", use_banded="off")
    before = dict(dia_kernel.launches)
    solver = amg.AMGSolver(a, pars, device="cuda", log=lambda *_: None)
    assert solver.mg.levels[0].a.vals.is_cuda
    x, info = solver.solve(np.ones(a.n_rows))
    true_rel = np.linalg.norm(1.0 - a.matvec(x.astype(np.float64))) \
        / np.sqrt(a.n_rows)
    assert info.rres < 1e-8 and true_rel < 1e-8
    assert all(dia_kernel.launches[e] > before[e] for e in EPILOGUES)


@pytest.mark.parametrize("kw", [
    dict(coarsest_solver=amg.CoarsestSolver.KRYLOV),
    dict(coarsest_solver=amg.CoarsestSolver.KRYLOV, dtype="float32",
         refine=True),
    dict(accel="gmres")], ids=["krylov", "krylov-f32", "gmres"])
def test_krylov_on_card(kw):
    """The Krylov layer on the card against the CPU, poisson2d(32) to
    1e-8: the KRYLOV coarsest solver (f64 cycles, and f32 cycles with f64
    defect correction, where CG cannot reach ctol 1e-9 and GMRES runs on
    every coarsest solve) and GMRES acceleration.  Equal iterations, final
    residuals at the goldens' rtol 1e-3 (the f32 cycles with atol 1e-6 *
    ||b||, tests/test_torch_solve.py's bar); B1 launched on the card."""
    _needs_card()
    from amg_tpu_torch.solve import krylov

    a = amg.poisson2d(32)
    b = np.ones(a.n_rows)
    pars = amg.AMGParams(verbose=0, tol=1e-8, **kw)
    _, ic = amg.AMGSolver(a, pars, device="cpu",
                          log=lambda *_: None).solve(b)
    before = sum(dia_kernel.launches[e] for e in EPILOGUES)
    runs = krylov.counts["cg_solves" if "coarsest_solver" in kw
                         else "gmres_solves"]
    x, ig = amg.AMGSolver(a, pars, device="cuda",
                          log=lambda *_: None).solve(b)
    assert sum(dia_kernel.launches[e] for e in EPILOGUES) > before
    assert krylov.counts["cg_solves" if "coarsest_solver" in kw
                         else "gmres_solves"] > runs
    assert ig.nits == ic.nits
    atol = 1e-6 * np.sqrt(a.n_rows) if "dtype" in kw else 0.0
    np.testing.assert_allclose(ig.ares, ic.ares, rtol=1e-3, atol=atol)
    true_rel = np.linalg.norm(b - a.matvec(x.astype(np.float64))) \
        / np.linalg.norm(b)
    assert true_rel < 1e-8 and ig.rres < 1e-8


def test_batched_slice_on_card():
    """solve_batched on the card at test size: every column below the
    tolerance (host-verified), every B4 epilogue launched, B1 not."""
    _needs_card()
    a = amg.poisson3d(20)
    pars = amg.AMGParams(
        dtype="float32", smoother=amg.SmootherType.GS,
        coarse_smoother=amg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="bfloat16", coarse_sparsify=0.005,
        sparsify_from_level=2, coarse_stop_rows=3500, max_it=60, verbose=0,
        embed_levels=0, use_well="off", use_banded="off")
    solver = amg.AMGSolver(a, pars, device="cuda", log=lambda *_: None)
    B = np.random.default_rng(7).standard_normal((a.n_rows, 5))
    before = dict(dia_kernel.launches)
    x, info = solver.solve_batched(B, tol=1e-6)
    assert all(dia_kernel.launches[e] > before[e] for e in dia_kernel.MULTI)
    assert all(dia_kernel.launches[e] == before[e] for e in EPILOGUES)
    for c in range(B.shape[1]):
        r = B[:, c] - a.matvec(x[:, c].astype(np.float64))
        assert np.linalg.norm(r) / np.linalg.norm(B[:, c]) < 1e-6


def _rcm_fem(n=5000, seed=9):
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = amg.fem2d(n, seed=seed)
    return a.permute(np.asarray(reverse_cuthill_mckee(
        a.to_scipy(), symmetric_mode=True), dtype=np.int64))


def _gs_classes(a, pad):
    """GS classes of ``a`` (colour classes split by C/F, as the hierarchy
    builds them), one id per padded row."""
    from amg_tpu_torch.setup_phase.coloring import build_groups

    _, group_cf, gid = build_groups(a, None, pad_to=pad)
    return torch.from_numpy(gid), len(group_cf)


def _well_pack(a, kind, device, classes=None):
    if kind == "df64":
        return WEll.from_csr_df64(a, device=device, classes=classes)
    return WEll.from_csr(a, dtype=getattr(torch, kind), device=device,
                         classes=classes)


@pytest.mark.parametrize("short_x", [False, True])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "float64", "df64"])
def test_well_kernel_matches_plain(kind, short_x):
    """Kernels B2 (f32, bf16, f64 values) and B3 (df64) on the row-slice
    layout against their plain versions on the card, on an RCM-ordered
    fem2d operator (rows in row order, and grouped by GS class), with x of
    length pad_cols and shorter (reads past its end are 0)."""
    _needs_card()
    a = _rcm_fem()
    cpu, gpu = _well_pack(a, kind, "cpu"), _well_pack(a, kind, "cuda")
    gid, _ = _gs_classes(a, cpu.padded_rows)
    grouped = _well_pack(a, kind, "cuda", classes=gid.cuda())
    df64 = kind == "df64"
    xdt = torch.float64 if kind in ("float64", "df64") else torch.float32
    n_x = a.n_cols if short_x else cpu.pad_cols
    x = torch.randn(n_x, generator=torch.Generator().manual_seed(5),
                    dtype=xdt)
    fn = well_kernel.spmv_df64 if df64 else well_kernel.spmv
    entry = "df64" if df64 else "spmv"
    key = (entry, gpu.vals.dtype, gpu.n_rows, gpu.nnz)
    before = well_kernel.launches[entry]
    before_shape = well_kernel.launches_by_shape.get(key, 0)
    got = fn(gpu, x.cuda())
    torch.cuda.synchronize()
    assert well_kernel.launches[entry] == before + 1
    assert well_kernel.launches_by_shape[key] == before_shape + 1
    assert got.is_cuda and got.dtype == xdt and got.shape == \
        (cpu.padded_rows,)
    want = fn(cpu, x)
    tol = {"float32": 2e-6, "bfloat16": 1e-5, "float64": 1e-13,
           "df64": 1e-13}[kind]
    err = (got.cpu() - want).abs().max().item() / want.abs().max().item()
    assert err <= tol, (kind, short_x, err)
    got = fn(grouped, x.cuda())
    err = (got.cpu() - want).abs().max().item() / want.abs().max().item()
    assert err <= tol, (kind, short_x, "classes", err)


@pytest.mark.parametrize("relax", [None, 0.9], ids=["gs", "sor"])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "float64"])
def test_well_gs_kernel_matches_plain(kind, relax):
    """The gs entry (B2's Gauss-Seidel class update, in place) against its
    plain version on the card, every class of an RCM-ordered fem2d
    operator: x updated by the kernel against x updated by the plain
    entry, at the vector type's tolerance of max|x| (only the rows'
    products are summed in another order)."""
    _needs_card()
    a = _rcm_fem()
    pad = WEll._pads(a, None, None)[0]
    gid, n_cls = _gs_classes(a, pad)
    cpu = _well_pack(a, kind, "cpu", classes=gid)
    gpu = _well_pack(a, kind, "cuda", classes=gid.cuda())
    xdt = torch.float64 if kind == "float64" else torch.float32
    diag = torch.zeros(pad, dtype=xdt)
    diag[: a.n_rows] = torch.from_numpy(a.diagonal_fast())
    inv = torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, 1.0),
                      torch.zeros((), dtype=xdt))
    gen = torch.Generator().manual_seed(7)
    x, b = (torch.randn(pad, generator=gen, dtype=xdt) for _ in range(2))
    tol = {torch.float32: 2e-6, torch.float64: 1e-13}[xdt]
    key = ("gs", gpu.vals.dtype, gpu.n_rows, gpu.nnz)
    for g in range(n_cls):
        want = well_kernel.gs_update_(cpu, x.clone(), b, g, diag, inv, relax)
        before = well_kernel.launches_by_shape.get(key, 0)
        xg = x.cuda()
        out = well_kernel.gs_update_(gpu, xg, b.cuda(), g, diag.cuda(),
                                     inv.cuda(), relax)
        torch.cuda.synchronize()
        assert out is xg and well_kernel.launches_by_shape[key] == before + 1
        err = (xg.cpu() - want).abs().max().item() / want.abs().max().item()
        assert err <= tol, (kind, relax, g, err)
        x = want


def test_well_cuda_tensor_never_falls_back():
    """A CUDA tensor reaches the WEll kernels or raises."""
    _needs_card()
    w = WEll.from_csr(amg.fem2d(2500, seed=2), device="cuda")
    with pytest.raises(TypeError):
        well_kernel.spmv(w, torch.zeros(w.pad_cols, dtype=torch.float64,
                                        device="cuda"))
    with pytest.raises(ValueError):
        well_kernel.spmv(w, torch.zeros(w.pad_cols))   # CPU x
    with pytest.raises(ValueError, match="vals_lo"):
        well_kernel.spmv_df64(w, torch.zeros(w.pad_cols, dtype=torch.float64,
                                             device="cuda"))
    z = torch.zeros(w.padded_rows, device="cuda")
    with pytest.raises(ValueError, match="no GS class"):   # row order
        well_kernel.gs_update_(w, z, z, 0, z, z)
    a = amg.fem2d(2500, seed=2)
    gid, _ = _gs_classes(a, w.padded_rows)
    wc = WEll.from_csr(a, device="cuda", classes=gid.cuda())
    with pytest.raises(ValueError):
        well_kernel.gs_update_(wc, z, z.cpu(), 0, z, z)   # CPU b


def test_unstructured_slice_on_card():
    """The unstructured main-path configuration at test size on the card:
    WEll levels, FCG in f64 through B3, converges to 1e-8 (host-verified)
    through the row-slice entries (spmv, df64, and gs on level 0's
    classes); the card holds the WEll operators' row-slice layouts, their
    packs stay on the host."""
    _needs_card()
    a = amg.fem2d(20000, seed=17)
    pars = amg.AMGParams(
        dtype="float32", refine=True, accel="cg",
        smoother=amg.SmootherType.GS,
        coarse_smoother=amg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="float32", coarse_sparsify=0, coarse_stop_rows=3500,
        tol=1e-8, max_it=60, use_well="on", use_banded="off",
        embed_levels=0, well_min_rows=1024, dense_level_bytes=2e7,
        verbose=0)
    before = dict(well_kernel.launches)
    solver = amg.AMGSolver(a, pars, log=lambda *_: None)   # the card
    assert solver.device.type == "cuda"
    assert isinstance(solver.mg.levels[0].a, WEll)
    a0 = solver.mg.levels[0].a
    assert a0.rows.vals is solver.a0_hi.rows.vals and a0.rows.vals.is_cuda
    for lv in solver.mg.levels:
        for op in (lv.a, lv.p, lv.r):
            if isinstance(op, WEll):
                assert op.rows.cols.is_cuda and not op.vals.is_cuda
    b = np.random.default_rng(23).standard_normal(a.n_rows)
    x, info = solver.solve(b)
    true_rel = np.linalg.norm(b - a.matvec(x.astype(np.float64))) \
        / np.linalg.norm(b)
    assert info.rres < 1e-8 and true_rel < 1e-8 and info.nits <= 20
    assert solver.mg.levels[0].a.rows.classes
    for e in ("spmv", "df64", "gs"):
        assert well_kernel.launches[e] > before[e], e


def _embedded_bench(n_side=20, **kw):
    """poisson3d(n_side) with the structured main path's parameters on
    amg_tpu's one-device layout and fine-grid embedding (bf16 embedded
    operators)."""
    a = amg.poisson3d(n_side)
    pars = amg.AMGParams(
        dtype="float32", refine=True, smoother=amg.SmootherType.GS,
        coarse_smoother=amg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="bfloat16", coarse_sparsify=0.005,
        sparsify_from_level=2, coarse_stop_rows=100, tol=1e-8, max_it=60,
        verbose=0, embed_levels=8, **kw)
    return a, pars


@pytest.mark.parametrize("k", [1, 16])
def test_dia_kernels_at_an_embedded_wide_shape(k):
    """B1 (k = 1, every epilogue) and B4 (every epilogue) against their
    plain versions on the widest embedded level operator of
    poisson3d(20)'s embedded hierarchy: bf16 values with bf16 products
    (nd >= 32)."""
    _needs_card()
    a, pars = _embedded_bench()
    mg, _ = amg.setup(a, pars, log=lambda *_: None, device="cpu")
    cpu = max((lv.a for lv in mg.levels[1:] if isinstance(lv.a, Dia)
               and lv.pad == mg.levels[0].pad), key=lambda op: op.n_diags)
    assert cpu.vals.dtype == torch.bfloat16 and 0 in cpu.offsets
    assert dia_kernel.bf16_products(cpu.n_diags, cpu.vals.dtype,
                                    torch.float32)
    gpu = Dia(cpu.vals.cuda(), cpu.offsets, cpu.shape, cpu.nnz)
    pad = cpu.padded_rows
    g = torch.Generator().manual_seed(31)
    shape = (k, pad) if k > 1 else (pad,)
    x, b = (torch.randn(shape, generator=g) for _ in range(2))
    w = torch.randn(pad, generator=g)
    cases = ((dia_kernel.spmv_multi, (x,)), (dia_kernel.resid_multi, (x, b)),
             (dia_kernel.gs_update_multi, (x, b, w))) if k > 1 else (
        (dia_kernel.spmv, (x,)), (dia_kernel.resid, (x, b)),
        (dia_kernel.gs_update, (x, b, w)))
    scale = dia_kernel.spmv_multi_plain(cpu, x.reshape(-1, pad)) \
        .abs().max().item()
    for fn, args in cases:
        want = getattr(dia_kernel, fn.__name__ + "_plain")(cpu, *args)
        before = dict(dia_kernel.launches)
        got = fn(gpu, *(t.cuda() for t in args))
        torch.cuda.synchronize()
        assert dia_kernel.launches != before
        err = (got.cpu() - want).abs().max().item()
        assert err <= TOL[torch.bfloat16] * scale, (fn.__name__, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_spmv_banded_on_card(dtype):
    """The BandedBlocks product on the card (cuBLAS; bf16 values with f32
    output through ``out_dtype``) against the CPU path, one vector and a
    batch, f32 ``2e-6``, bf16 ``1e-5``, f64 ``1e-13`` of max|Ax|."""
    _needs_card()
    from amg_tpu_torch.ops.spmv import spmv
    from amg_tpu_torch.sparse import BandedBlocks

    a = _band_csr(3000, 40, 5)
    vdt = getattr(torch, dtype)
    cpu = BandedBlocks.from_csr(a, dtype=vdt, device="cpu")
    gpu = BandedBlocks.from_csr(a, dtype=vdt, device="cuda")
    assert torch.equal(gpu.vals.cpu(), cpu.vals) and cpu.nb >= 2
    xdt = torch.float64 if dtype == "float64" else torch.float32
    x = torch.randn(4, cpu.padded_rows, generator=torch.Generator()
                    .manual_seed(2), dtype=xdt)
    for xc in (x[0], x):
        want = spmv(cpu, xc)
        got = spmv(gpu, xc.cuda())
        torch.cuda.synchronize()
        assert got.dtype == xdt and got.shape == want.shape
        scale = want.abs().max().item()
        assert (got.cpu() - want).abs().max().item() <= TOL[vdt] * scale


@pytest.mark.parametrize("coarse", ["float32", "bfloat16"])
def test_auto_declined_levels_on_card(coarse):
    """``use_banded="auto"`` on the card: fem2d(20000) at the unstructured
    main path's parameters (well_min_rows and the Dense budget lowered,
    as tests/test_torch_banded.py's ``_fem_pars``), f32 or bf16 coarse
    operators.  Every level that "on" stores as BandedBlocks and "auto"
    declines packs as WEll, B2 on it matches its plain version (f32
    ``2e-6``, bf16 ``1e-5`` of max|Ax|), and the FCG solve on "auto" takes
    the iterations of "on" within 1, to a true residual below 1e-8."""
    _needs_card()
    from amg_tpu_torch import tracing

    a = amg.fem2d(20000, seed=17)
    pars = amg.AMGParams(
        dtype="float32", refine=True, accel="cg",
        smoother=amg.SmootherType.GS,
        coarse_smoother=amg.SmootherType.CHEBYSHEV, coarse_op_dtype=coarse,
        coarse_sparsify=0, coarse_stop_rows=500, tol=1e-8, max_it=60,
        embed_levels=0, well_min_rows=4096, dense_level_bytes=2e6,
        verbose=0)
    quiet = dict(log=lambda *_: None)
    on = amg.AMGSolver(a, pars.replace(use_banded="on"), **quiet)
    tracing.reset()
    auto = amg.AMGSolver(a, pars, **quiet)
    declined = [l for l, (lo, la) in enumerate(zip(on.mg.levels,
                                                   auto.mg.levels))
                if isinstance(lo.a, amg.BandedBlocks)
                and not isinstance(la.a, amg.BandedBlocks)]
    assert declined and \
        tracing.totals()["amg.setup.banded_declined"]["n"] == len(declined)
    g = torch.Generator().manual_seed(4)
    for l in declined:
        op = auto.mg.levels[l].a
        assert isinstance(op, WEll) and op.rows.vals.is_cuda
        x = torch.randn(op.padded_rows, generator=g).cuda()
        got, want = well_kernel.spmv(op, x), well_kernel.spmv_plain(op, x)
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= \
            TOL[op.rows.vals.dtype] * scale, l
    b = np.random.default_rng(23).standard_normal(a.n_rows)
    (_, i_on), (x, i_auto) = on.solve(b), auto.solve(b)
    assert abs(i_auto.nits - i_on.nits) <= 1
    assert np.linalg.norm(b - a.matvec(np.asarray(x, dtype=np.float64))) \
        / np.linalg.norm(b) < 1e-8


@pytest.mark.parametrize("boundary", ["embedded", "compact"])
def test_embedded_solve_on_card(boundary):
    """A small embedded solve on the card with "auto" formats, for one
    vector and a batch: every index of the embedded/compact boundary is in
    range (a device-side assert would fail the synchronise and poison the
    context), and the solves reach their tolerances (host-verified)
    through B1 and, for the batch, B4 alone."""
    _needs_card()
    a, pars = _embedded_bench(embed_boundary=boundary)
    solver = amg.AMGSolver(a, pars, log=lambda *_: None)
    lv = solver.mg.levels
    assert lv[1].pad == lv[0].pad
    idx = [t for l in lv for t in (l.compact_idx, l.member_idx)
           if t is not None]
    assert len(idx) == 1 and idx[0].is_cuda
    assert int(idx[0].min()) >= 0 and int(idx[0].max()) < solver.pad
    before = dict(dia_kernel.launches)
    x, _ = solver.solve(np.ones(a.n_rows))
    torch.cuda.synchronize()
    assert all(dia_kernel.launches[e] > before[e] for e in EPILOGUES)
    assert np.linalg.norm(1.0 - a.matvec(x.astype(np.float64))) \
        / np.sqrt(a.n_rows) < 1e-8
    B = np.random.default_rng(3).standard_normal((a.n_rows, 4))
    before = dict(dia_kernel.launches)
    X, _ = solver.solve_batched(B, tol=1e-6)
    torch.cuda.synchronize()
    assert all(dia_kernel.launches[e] == before[e] for e in EPILOGUES)
    assert all(dia_kernel.launches[e] > before[e] for e in dia_kernel.MULTI)
    for c in range(B.shape[1]):
        r = B[:, c] - a.matvec(X[:, c].astype(np.float64))
        assert np.linalg.norm(r) / np.linalg.norm(B[:, c]) < 1e-6


def _window_dia(nd, n_cols, vdt, seed, span=300):
    """A Dia of nd random diagonals (offsets within +/-span, 0 among them)
    over n_cols value columns, on the card."""
    rng = np.random.default_rng(seed)
    offs = {0}
    while len(offs) < nd:
        offs.add(int(rng.integers(-span, span + 1)))
    offs = tuple(sorted(offs))
    vals = torch.from_numpy(rng.standard_normal((nd, n_cols))).to(vdt)
    return Dia(vals.cuda(), offs, (n_cols, n_cols), nd * n_cols)


WINDOW_CASES = {
    # (S, m): one shard; four shards of 4096 rows (the halo of +/-300 is
    # one hop); four shards of 256 rows (two hops); rows not a multiple of
    # a thread's run (the entry-by-entry path)
    "S1": (1, 8192), "S4": (4, 4096), "S4-multihop": (4, 256),
    "S4-odd": (4, 1001)}


@pytest.mark.parametrize("nd", [7, 19, 199])
@pytest.mark.parametrize("vdtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_dia_window_kernel_matches_plain(case, vdtype, nd):
    """B1's window entry against its plain version on the card, on the
    ring's overlapping windows (``halo.ring_windows``: zeros at the mesh
    edges), one launch for every shard, the values read in place through
    their row stride and, as a column slice of a wider tensor, through a
    stride other than S * m."""
    _needs_card()
    from amg_tpu_torch.parallel import halo, make_mesh

    S, m = WINDOW_CASES[case]
    vdt = getattr(torch, vdtype)
    xdt = torch.float64 if vdt == torch.float64 else torch.float32
    d = _window_dia(nd, 2 * S * m, vdt, seed=nd)
    x = torch.randn(S, m, generator=torch.Generator().manual_seed(6),
                    dtype=xdt).cuda()
    lo, hi = halo.dia_halo_widths(d.offsets)
    xw, lo_w = halo.ring_windows(x, lo, hi, make_mesh(S))
    assert xw.stride(0) == m
    for vals in (d.vals[:, : S * m].contiguous(), d.vals[:, : S * m]):
        op = Dia(vals, d.offsets, d.shape, d.nnz)
        key = ("window", vdt, xdt, nd, m, S)
        before = dia_kernel.launches_by_shape.get(key, 0)
        got = dia_kernel.spmv_window(op, xw, lo_w)
        torch.cuda.synchronize()
        assert dia_kernel.launches_by_shape[key] == before + 1
        want = dia_kernel.spmv_window_plain(op, xw, lo_w)
        assert got.shape == (S, m) and got.dtype == xdt
        scale = want.abs().max().item()
        err = (got - want).abs().max().item() / scale
        assert err <= TOL[vdt], (case, vdtype, nd, err)
    assert vals.stride(0) == 2 * S * m


def test_spmd_solve_on_card():
    """``SpmdAMGSolver`` on 4 shards of poisson3d(20) on the card against
    the port's single-device solve of the same parameters: iterations
    within 1 (the psum dots sum in another order), every sharded product
    through B1's window entry, and no single-device B1 launch on a level
    of level 0's pad."""
    _needs_card()
    from amg_tpu_torch.parallel import SpmdAMGSolver, make_mesh

    a = amg.poisson3d(20)
    pars = amg.AMGParams(verbose=0, tol=1e-8, dtype="float32", refine=True,
                         accel="cg", coarse_smoother=amg.SmootherType.CHEBYSHEV,
                         coarse_op_dtype="bfloat16", embed_levels=8)
    b = np.ones(a.n_rows)
    single = amg.AMGSolver(a, pars, log=lambda *_: None)
    _, i1 = single.solve(b)
    s = SpmdAMGSolver(a, pars, mesh=make_mesh(4), log=lambda *_: None)
    assert s.E >= 1 and s.mesh.device.type == "cuda"
    dia_kernel.launches_by_shape.clear()
    x, i2 = s.solve(b)
    torch.cuda.synchronize()
    assert abs(i1.nits - i2.nits) <= 1
    r = b - a.matvec(x.astype(np.float64))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8
    keys = dia_kernel.launches_by_shape
    assert any(k[0] == "window" and k[2] == torch.float64 for k in keys)
    assert not [k for k in keys if k[0] in EPILOGUES and k[4] == s.pad]


def test_spmd_one_rank_nccl_on_card():
    """The SPMD solve inside a one-rank NCCL process group
    (``multihost.initialize``) equals the in-process run bit for bit: a
    one-rank all_reduce is the identity.  The group is destroyed after."""
    _needs_card()
    import socket
    import torch.distributed as tdist
    from amg_tpu_torch.parallel import SpmdAMGSolver, make_mesh, multihost

    a = amg.poisson3d(20)
    pars = amg.AMGParams(verbose=0, tol=1e-8, dtype="float32", refine=True,
                         accel="cg", embed_levels=8)
    b = np.ones(a.n_rows)
    x, info = SpmdAMGSolver(a, pars, mesh=make_mesh(4),
                            log=lambda *_: None).solve(b)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    assert multihost.initialize(f"localhost:{port}", 1, 0)
    try:
        assert tdist.get_backend() == "nccl"
        mesh = make_mesh(4)
        assert mesh.group is not None and mesh.device.type == "cuda"
        x2, info2 = SpmdAMGSolver(a, pars, mesh=mesh,
                                  log=lambda *_: None).solve(b)
    finally:
        tdist.destroy_process_group()
    assert info2.nits == info.nits and np.array_equal(x2, x)


# the window entries of B2/B3 (the general SPMD mode)
WELL_WINDOW_CASES = ("middle", "edges", "short")


@pytest.mark.parametrize("case", WELL_WINDOW_CASES)
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "float64", "df64"])
def test_well_window_kernel_matches_plain(kind, case):
    """B2's and B3's window entries against their plain versions on the
    card, on the groups-sharded block of an RCM-ordered fem2d operator
    with its ring plan: ``middle``, the block of rank 1 of 2 processes on
    a 4-shard ring (col0 > 0, a window inside x); ``edges``, one process
    holding every shard (col0 = -lo, the window's halos zero beyond the
    mesh edges); ``short``, rank 0's window one entry short (its last
    column, a real entry of x, reads 0)."""
    _needs_card()
    from amg_tpu_torch.parallel import halo, make_mesh
    from amg_tpu_torch.parallel.dist import shard_well

    a = _rcm_fem()
    pad = 8 * 1024
    if kind == "df64":
        w = WEll.from_csr_df64(a, pad_rows_to=pad, pad_cols_to=pad,
                               ring_devices=4, device="cuda")
    else:
        w = WEll.from_csr(a, dtype=getattr(torch, kind), pad_rows_to=pad,
                          pad_cols_to=pad, ring_devices=4, device="cuda")
    assert w.ring_plan is not None
    mesh = make_mesh(4)
    if case != "edges":
        mesh = type(mesh)(4, mesh.device, rank=int(case == "middle"),
                          world=2)
    blk = shard_well(w, mesh)
    xdt = torch.float64 if kind in ("float64", "df64") else torch.float32
    x = torch.randn(pad, generator=torch.Generator().manual_seed(8),
                    dtype=xdt).cuda()
    lo128, hi128 = w.ring_plan
    lo, hi = lo128 * 128, hi128 * 128
    m = pad // 4
    first = mesh.first * m
    xp = torch.nn.functional.pad(x, (lo, hi))
    ext = xp[first:first + lo + mesh.local * m + hi]
    if case == "short":
        ext = ext[:-1]
    col0 = first - lo
    assert (col0 > 0) == (case == "middle")
    df64 = kind == "df64"
    fn, plain = ((well_kernel.spmv_df64_window,
                  well_kernel.spmv_df64_window_plain) if df64 else
                 (well_kernel.spmv_window, well_kernel.spmv_window_plain))
    entry = "df64_window" if df64 else "window"
    before = well_kernel.launches[entry]
    got = fn(blk, ext.contiguous(), col0)
    torch.cuda.synchronize()
    assert well_kernel.launches[entry] == before + 1
    want = plain(blk, ext.contiguous(), col0)
    assert got.shape == (mesh.local * m,) and got.dtype == xdt
    tol = {"float32": 2e-6, "bfloat16": 1e-5, "float64": 1e-13,
           "df64": 1e-13}[kind]
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err <= tol, (kind, case, err)
    # the block's rows of the single-device product (the short window
    # drops the operator's last column)
    xs = x.clone()
    if case == "short":
        xs[first + mesh.local * m + hi - 1:] = 0
    single = (well_kernel.spmv_df64 if df64 else well_kernel.spmv)(w, xs)
    rows = single[first:first + mesh.local * m]
    err = (got - rows).abs().max().item() / rows.abs().max().item()
    assert err <= tol, (kind, case, "single", err)


def test_spmd_general_solve_on_card():
    """The general SPMD mode on 4 shards of fem2d(20000) on the card, in
    bench_dist.py's fem2d parameters, against the port's single-device
    ``solve_pcg``: iterations within 1, a host-checked 1e-8; B2's window
    entry launched, B3's window entry launched, and no single-device B2/B3
    product on a row-sharded operator."""
    _needs_card()
    from amg_tpu_torch.parallel import SpmdAMGSolver, make_mesh

    a = amg.fem2d(20000, seed=17)
    pars = amg.AMGParams(
        verbose=0, tol=1e-8, dtype="float32", refine=True, accel="cg",
        coarse_smoother=amg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="float32", use_well="on", well_min_rows=1024,
        dense_level_bytes=2e7)
    b = np.ones(a.n_rows)
    _, i1 = amg.AMGSolver(a, pars.replace(dist_devices=4),
                          log=lambda *_: None).solve(b)
    s = SpmdAMGSolver(a, pars, mesh=make_mesh(4), log=lambda *_: None)
    assert s.E == 0 and s.Es >= 1 and s.mesh.device.type == "cuda"
    well_kernel.launches_by_shape.clear()
    x, i2 = s.solve(b)
    torch.cuda.synchronize()
    assert abs(i1.nits - i2.nits) <= 1
    r = b - a.matvec(x.astype(np.float64))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8
    keys = well_kernel.launches_by_shape
    assert any(k[0] == "window" for k in keys)
    assert any(k[0] == "df64_window" for k in keys)
    sharded = {(op.vals.dtype, op.n_rows, op.nnz)
               for lv in s.mg.levels[: s.Es + 1]
               for op in (lv.a, lv.p, lv.r) if isinstance(op, WEll)}
    assert not [k for k in keys if k[0] in ("spmv", "df64")
                and k[1:] in sharded]


def test_pmis_device_card_equals_cpu():
    """``pmis_split_device`` on the card and on the CPU: the same
    permutation (drawn on the CPU), the same rounds, equal partitions."""
    _needs_card()
    from amg_tpu_torch.setup_phase.cf_split import pmis_split_device
    from amg_tpu_torch.setup_phase.strength import strength_matrix

    s = strength_matrix(amg.fem2d(20000, seed=0))
    vc, cc = pmis_split_device(s, device="cuda")
    vh, ch = pmis_split_device(s, device="cpu")
    assert cc == ch > 0
    np.testing.assert_array_equal(vc, vh)


def test_gspmd_solve_on_card():
    """DistAMGSolver on 4 shards of the card in bench_dist.py's gspmd
    parameters (f32 cycles, f64 defect correction, bf16 coarse operators),
    poisson3d(24): the single-device solve_refined's iterations within 1,
    a true rres below 1e-8, B1's window entry launched."""
    _needs_card()
    from amg_tpu_torch.parallel import DistAMGSolver, make_mesh

    a = amg.poisson3d(24)
    pars = amg.AMGParams(
        verbose=0, tol=1e-8, dtype="float32", refine=True,
        coarse_smoother=amg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="bfloat16", coarse_replicate_nnz=2000)
    b = np.ones(a.n_rows)
    _, i1 = amg.AMGSolver(a, pars.replace(dist_devices=4),
                          log=lambda *_: None).solve(b)
    s = DistAMGSolver(a, pars, mesh=make_mesh(4), log=lambda *_: None)
    assert s.Es >= 1 and s.mesh.device.type == "cuda"
    dia_kernel.launches_by_shape.clear()
    x, i2 = s.solve(b)
    torch.cuda.synchronize()
    assert abs(i1.nits - i2.nits) <= 1
    r = b - a.matvec(x.astype(np.float64))
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8
    assert any(k[0] == dia_kernel.WINDOW for k in dia_kernel.launches_by_shape)


def _jit_solver(case, **kw):
    """chip_smoke.py phase 22's parameters at test size: f32 cycles to
    1e-6 without defect correction on poisson3d(32)'s one-device "auto"
    layout (Dia, Dia, WEll levels: B1 and B2 in the step) or on
    fem2d(20000)'s WEll levels (B2's product and its GS class update)."""
    common = dict(dtype="float32", smoother=amg.SmootherType.GS,
                  coarse_smoother=amg.SmootherType.CHEBYSHEV, tol=1e-6,
                  max_it=60, embed_levels=0, verbose=0)
    if case == "structured":
        a = amg.poisson3d(32)
        pars = amg.AMGParams(coarse_op_dtype="bfloat16", well_min_rows=2000,
                             dense_level_bytes=1e6, **common)
    else:
        a = amg.fem2d(20000, seed=17)
        pars = amg.AMGParams(coarse_op_dtype="float32", use_well="on",
                             use_banded="off", well_min_rows=1024,
                             dense_level_bytes=2e7, **common)
    solver = amg.AMGSolver(a, pars.replace(**kw), log=lambda *_: None)
    b = a.matvec(np.random.default_rng(31).standard_normal(a.n_rows))
    return a, solver, b


@pytest.mark.parametrize("case", ["structured", "unstructured"])
def test_solve_jit_graph_equals_eager_loop_on_card(case):
    """solve_jit replays a captured CUDA graph holding B1/B2 launches; its
    iterations equal the eager masked loop's on the card, histories within
    rtol 1e-5, x within 1e-6 * ||x||, and a warm call replays the same
    graph with the same result.  Launch counts: capture x replays."""
    _needs_card()
    from amg_tpu_torch.solve.driver import JIT_BLOCK, JitLoop

    a, solver, b = _jit_solver(case)
    x, info = solver.solve_jit(b)
    loop = solver.jit_loop
    assert loop.graph is not None and info.rres < 1e-6
    per_dia, per_well = loop.per_step[dia_kernel][0], \
        loop.per_step[well_kernel][0]
    if case == "structured":
        assert all(per_dia.get(e, 0) > 0 for e in EPILOGUES)
        assert per_well.get("spmv", 0) > 0
    else:
        assert per_well.get("spmv", 0) > 0 and per_well.get("gs", 0) > 0
    eager = JitLoop(solver.device, solver.dtype, solver.pad,
                    solver.pars.max_it, solver.pars.tol, graph=False)
    eager.load(solver._pad_vec(np.zeros(a.n_rows)), solver._pad_vec(b))
    eager.run(solver._step)
    assert int(eager.it) == info.nits and eager.graph is None
    h = eager.hist.cpu().numpy()
    np.testing.assert_allclose(info.residuals, h[~np.isnan(h)], rtol=1e-5)
    xe = solver._unpad_vec(eager.x)
    assert np.linalg.norm(x - xe) <= 1e-6 * np.linalg.norm(xe)
    before = dict(well_kernel.launches)
    x2, info2 = solver.solve_jit(b)
    assert solver.jit_loop is loop and info2.nits == info.nits
    np.testing.assert_array_equal(x2, x)
    assert well_kernel.launches["spmv"] - before["spmv"] \
        == per_well["spmv"] * loop.blocks * JIT_BLOCK


def test_solve_jit_capture_raises_on_a_host_read():
    """A step that reads the host cannot be captured: the warm-up under
    torch.cuda.set_sync_debug_mode("error") raises, and nothing falls
    back to an eager loop."""
    _needs_card()
    a, solver, b = _jit_solver("structured")
    step = solver._step

    def reading_step(x, b):
        x, r = step(x, b)
        float(r)    # a host read
        return x, r

    solver._step = reading_step
    with pytest.raises(RuntimeError):
        solver.solve_jit(b)
    assert torch.cuda.get_sync_debug_mode() == 0


def test_solve_jit_krylov_runs_as_a_graph_on_card():
    """A KRYLOV coarsest solve is a CUDA graph of while and if nodes: the
    solve_jit step captures it (its nodes are added to the step's graph),
    with solve's iterations, histories within rtol 1e-5 and x within
    1e-6 * ||x||; the Krylov loops read the host 0 times in either."""
    _needs_card()
    from amg_tpu_torch.solve import krylov

    a = amg.poisson3d(24)
    solver = amg.AMGSolver(a, amg.AMGParams(
        dtype="float32", coarsest_solver=amg.CoarsestSolver.KRYLOV,
        tol=1e-6, verbose=0), log=lambda *_: None)
    b = a.matvec(np.random.default_rng(32).standard_normal(a.n_rows))
    syncs = krylov.counts["syncs"]
    xs, i_s = solver.solve(b)
    x, info = solver.solve_jit(b)
    assert krylov.counts["syncs"] == syncs
    loop = solver.jit_loop
    assert loop.graph is not None and loop.x.is_cuda
    assert all(ks.graph is not None for ks in solver.mg.krylov.values())
    assert info.nits == i_s.nits
    np.testing.assert_allclose(info.residuals, i_s.residuals, rtol=1e-5)
    assert np.linalg.norm(x - xs) <= 1e-6 * np.linalg.norm(xs)


def _ulps(a, b):
    """Largest distance in units in the last place (float tensors of one
    dtype)."""
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    mask = (1 << ((32 if it == torch.int32 else 64) - 1)) - 1

    def line(t):
        i = t.contiguous().view(it).to(torch.int64)
        return torch.where(i < 0, -(i & mask), i)

    return int((line(a) - line(b)).abs().max())


def _arnoldi_columns(m, seed):
    """The raw Hessenberg columns (m, m + 1) and beta of m Arnoldi steps
    (f64 numpy, modified Gram-Schmidt) on a seeded nonsymmetric 200 x 200
    matrix near the identity."""
    rng = np.random.default_rng(seed)
    n = 200
    mat = np.eye(n) + 0.4 * rng.standard_normal((n, n)) / np.sqrt(n)
    r = rng.standard_normal(n)
    beta = np.linalg.norm(r)
    V, cols = [r / beta], np.zeros((m, m + 1))
    for j in range(m):
        w = mat @ V[j]
        for i in range(j + 1):
            cols[j, i] = V[i] @ w
            w = w - cols[j, i] * V[i]
        cols[j, j + 1] = np.linalg.norm(w)
        V.append(w / cols[j, j + 1])
    return cols, beta


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_krylov_small_kernels_match_plain(dtype):
    """krylov_small.cu's Givens step and back-substitution (one warp each)
    against their plain versions on the card: 4 seeded restarts of 30
    steps (120 columns, two restarts stopping inside), fed the columns of
    a real Arnoldi process, the step index on the device; rotations, g, H,
    the stored raw columns and y within 4 ulp, done, k_eff, j and the
    step flag equal; launches counted."""
    _needs_card()
    from amg_tpu_torch.ops import krylov_small as KS

    dt, m = getattr(torch, dtype), 30
    before = dict(KS.launches)
    for seed, tol in ((0, 1e-6), (1, 1e-12), (2, 1e-5), (3, 1e-12)):
        cols, beta = _arnoldi_columns(m, seed)
        hcol = torch.tensor(cols, dtype=dt, device="cuda")
        hnorm = hcol[torch.arange(m), torch.arange(1, m + 1)].clone()
        hcol[torch.arange(m), torch.arange(1, m + 1)] = 0
        st = []
        for _ in range(2):
            t = dict(hraw=torch.zeros((m, m + 1), dtype=dt, device="cuda"),
                     H=torch.zeros((m + 1, m), dtype=dt, device="cuda"),
                     cs=torch.zeros(m, dtype=dt, device="cuda"),
                     sn=torch.zeros(m, dtype=dt, device="cuda"),
                     g=torch.zeros(m + 1, dtype=dt, device="cuda"),
                     done=torch.zeros((), dtype=torch.bool, device="cuda"),
                     go=torch.ones((), dtype=torch.bool, device="cuda"),
                     j=torch.zeros((), dtype=torch.int32, device="cuda"),
                     k_eff=torch.zeros((), dtype=torch.int32, device="cuda"),
                     normr0=torch.tensor(beta, dtype=dt, device="cuda"))
            t["g"][0] = beta
            st.append(t)
        for j in range(m):
            for fn, t in ((KS.givens, st[0]), (KS.givens_plain, st[1])):
                fn(hcol[j], hnorm[j], t["j"], t["hraw"], t["H"], t["cs"],
                   t["sn"], t["g"], t["done"], t["k_eff"], t["go"],
                   t["normr0"], tol)
            torch.cuda.synchronize()
            for k in ("hraw", "H", "cs", "sn", "g"):
                assert _ulps(st[0][k], st[1][k]) <= 4, (seed, j, k)
            for k in ("done", "go", "j", "k_eff"):
                assert torch.equal(st[0][k], st[1][k]), (seed, j, k)
            assert int(st[0]["j"]) == j + 1
        k, p = st
        if tol > 1e-8:
            assert int(k["k_eff"]) < m, seed
        y = KS.backsub(k["H"], k["g"], k["k_eff"])
        assert y.is_cuda
        assert _ulps(y, KS.backsub_plain(k["H"], k["g"], k["k_eff"])) <= 4
    assert KS.launches["givens"] - before["givens"] == 4 * m
    assert KS.launches["backsub"] - before["backsub"] == 4


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cg_graph_equals_plain_on_card(dtype):
    """cg as one CUDA graph (a while node) against its host loop on the
    card, poisson2d(20) (Ell f64; Dense f32 at tol 1e-9, where CG ends on
    the Check III net) and a (3, pad) batch: equal statuses and
    iterations, x within 1e-12 (f64) or 1e-6 (f32) of ||x||."""
    _needs_card()
    from amg_tpu_torch.solve import krylov
    from amg_tpu_torch.sparse import Dense, Ell

    a = amg.poisson2d(20)
    dt = getattr(torch, dtype)
    op = (Ell.from_csr(a, device="cuda") if dtype == "float64" else
          Dense.from_csr(a, dtype=dt, pad_rows_to=512, device="cuda"))
    pad = op.padded_rows
    B = torch.zeros((3, pad), dtype=dt)
    B[:, :400] = torch.from_numpy(
        np.random.default_rng(2).standard_normal((3, 400)))
    tol = 1e-10 if dtype == "float64" else 1e-9
    for b in (B[0].cuda(), B.cuda()):
        syncs = krylov.counts["syncs"]
        xg, _, (sg, ig) = krylov.cg(op, b, torch.zeros_like(b), tol=tol,
                                    maxit=1000, return_info=True)
        assert krylov.counts["syncs"] == syncs
        xp, _, (sp, ip) = krylov.cg_plain(op, b, torch.zeros_like(b),
                                          tol=tol, maxit=1000,
                                          return_info=True)
        assert krylov.counts["syncs"] > syncs
        assert torch.equal(sg, sp) and torch.equal(ig, ip)
        gap = ((xg - xp).norm() / xp.norm()).item()
        assert gap <= (1e-12 if dtype == "float64" else 1e-6)


def test_gmres_graph_equals_plain_on_card():
    """gmres as one CUDA graph (a while node over restarts of at most 5
    steps, each a while node over one captured step) against its host
    loops on the card, on an upper-triangular nonsymmetric 24 x 24 system
    in f64: equal verdict and steps, x within 1e-12 of ||x||; the Givens
    kernel ran once per step, plus the build's two eager steps."""
    _needs_card()
    from amg_tpu_torch.ops import krylov_small as KS
    from amg_tpu_torch.solve import krylov
    from amg_tpu_torch.sparse import Ell

    n = 24
    d = np.diag(np.arange(2.0, 2.0 + n)) + 0.3 * np.triu(np.ones((n, n)), 1)
    op = Ell.from_csr(CSR.from_dense(d), device="cuda")
    b = torch.zeros(op.padded_rows, dtype=torch.float64)
    b[:n] = torch.from_numpy(d @ np.random.default_rng(7).standard_normal(n))
    b = b.cuda()
    before = KS.launches["givens"]
    xg, cg, ig = krylov.gmres(op, b, torch.zeros_like(b), tol=1e-10,
                              maxit=300, restart=5, return_iters=True)
    restarts = -(-int(ig) // 5)
    assert KS.launches["givens"] - before == int(ig) + 2
    xp, cp, ip = krylov.gmres_plain(op, b, torch.zeros_like(b), tol=1e-10,
                                    maxit=300, restart=5, return_iters=True)
    assert bool(cg) and bool(cp) and int(ig) == int(ip) and restarts > 1
    assert ((xg - xp).norm() / xp.norm()).item() <= 1e-12


def _krylov_solver(**kw):
    """The bench configuration with the KRYLOV coarsest solver at
    poisson3d(24) (f32 cycles, f64 defect correction, bf16 coarse
    operators: ctol 1e-9 is out of f32's reach, so every coarsest solve
    runs CG to the Check III net and then GMRES)."""
    a = amg.poisson3d(24)
    pars = amg.AMGParams(dtype="float32", refine=True,
                         coarse_op_dtype="bfloat16",
                         coarsest_solver=amg.CoarsestSolver.KRYLOV,
                         tol=1e-8, verbose=0, **kw)
    return a, amg.AMGSolver(a, pars, log=lambda *_: None)


@pytest.mark.parametrize("k", [1, 4])
def test_coarsest_graph_equals_plain_on_card(k):
    """The KRYLOV coarsest solve as one CUDA graph (CG's while node, an if
    node per column around GMRES's while node) against its host loops on
    the card, one vector and a (4, pad) batch: equal CG statuses and
    iterations and GMRES iterations per column, x within 1e-6 of ||x||;
    0 host reads on the graph route; the graph is cached per shape."""
    _needs_card()
    from amg_tpu_torch.solve import cycle, krylov

    a, solver = _krylov_solver()
    lv = solver.mg.levels[-1]
    g = torch.Generator().manual_seed(k)
    b = torch.zeros((k, lv.pad) if k > 1 else (lv.pad,))
    b[..., : lv.n] = torch.randn(b[..., : lv.n].shape, generator=g)
    b = b.cuda()
    ks = cycle.krylov_solver(solver.mg, b, 1e-9)

    def state():
        return (ks.cg.status.cpu(), ks.cg.it.cpu(), ks.gm_its.cpu())

    syncs = krylov.counts["syncs"]
    xg = ks.solve(b)
    torch.cuda.synchronize()
    assert krylov.counts["syncs"] == syncs and ks.graph.nodes > 0
    sg = state()
    xp = ks.solve_plain(b)
    sp = state()
    assert all(torch.equal(u, v) for u, v in zip(sg, sp))
    assert (sg[2] > 0).all()        # GMRES ran on every column
    assert ((xg - xp).norm() / xp.norm()).item() <= 1e-6
    assert cycle.krylov_solver(solver.mg, b, 1e-9) is ks


def test_krylov_graph_failures_raise_on_card(monkeypatch, tmp_path):
    """No fallback to the host loops on the card: a krylov_small.cu that
    does not build, and a conditional handle the CUDA runtime refuses,
    make the KRYLOV coarsest solve raise, with no host read made."""
    _needs_card()
    from amg_tpu_torch.ops import cuda_build, krylov_small as KS
    from amg_tpu_torch.solve import cycle, krylov

    a, solver = _krylov_solver()
    lv = solver.mg.levels[-1]
    b = torch.zeros(lv.pad, device="cuda")
    b[: lv.n] = 1.0
    lib = cuda_build.CudaLibrary("krylov_small.cu", KS._bind)
    lib.so = str(tmp_path / "libkrylov_small.so")
    monkeypatch.setattr(KS, "_LIB", lib)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "false")
    syncs = krylov.counts["syncs"]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cycle.krylov_solver(solver.mg, b, 1e-9).solve(b)
    monkeypatch.undo()

    call = KS._call

    def refuse(name, *args):
        if name == "ks_handle":
            raise RuntimeError("ks_handle failed: CUDA error 1")
        return call(name, *args)

    monkeypatch.setattr(KS, "_call", refuse)
    solver.mg.krylov.clear()
    with pytest.raises(RuntimeError, match="ks_handle"):
        cycle.krylov_solver(solver.mg, b, 1e-9).solve(b)
    assert krylov.counts["syncs"] == syncs


def _convection_diffusion(n_side, vel=20.0):
    """tests/test_torch_krylov.py's 2-D upwind convection-diffusion
    operator (nonsymmetric), n_side x n_side."""
    h = 1.0 / (n_side + 1)
    i, j = np.divmod(np.arange(n_side ** 2), n_side)
    rows, cols = [i * n_side + j], [i * n_side + j]
    vals = [np.full(n_side ** 2, 4.0 / h ** 2 + vel / h)]
    for di, dj, c in ((-1, 0, -1.0 / h ** 2 - vel / h), (1, 0, -1.0 / h ** 2),
                      (0, -1, -1.0 / h ** 2), (0, 1, -1.0 / h ** 2)):
        ok = (i + di >= 0) & (i + di < n_side) & (j + dj >= 0) & \
            (j + dj < n_side)
        rows.append((i * n_side + j)[ok])
        cols.append(((i + di) * n_side + j + dj)[ok])
        vals.append(np.full(int(ok.sum()), c))
    return CSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals), (n_side ** 2,) * 2)


def _pgmres_solver(coarsest):
    """GMRES around f64 cycles on the 32 x 32 convection-diffusion system,
    Dense or KRYLOV coarsest."""
    a = _convection_diffusion(32)
    pars = amg.AMGParams(accel="gmres", tol=1e-8, verbose=0,
                         coarsest_solver=getattr(amg.CoarsestSolver,
                                                 coarsest))
    return a, amg.AMGSolver(a, pars, log=lambda *_: None)


@pytest.mark.parametrize("coarsest", ["DENSE", "KRYLOV"])
def test_pgmres_graph_equals_host_loops_on_card(coarsest):
    """solve_pgmres as one CUDA graph against the same program's host
    loops on the card (``host_loops=True``), Dense and KRYLOV coarsest
    (whose while and if nodes the captured step holds): equal iterations,
    x bit-identical, 0 GMRES host reads on the graph route; the graph is
    built once and replayed by the second call, which gives the same x."""
    _needs_card()
    from amg_tpu_torch.solve import krylov

    a, solver = _pgmres_solver(coarsest)
    b = np.random.default_rng(17).standard_normal(a.n_rows)
    syncs = krylov.counts["syncs"]
    xg, ig = solver.solve_pgmres(b)
    assert krylov.counts["syncs"] == syncs
    graph = solver.pgmres_graph
    assert solver.pgmres_builds == 1 and graph.exec is not None
    assert bool(graph.direct) == (coarsest == "KRYLOV")
    x2, i2 = solver.solve_pgmres(b)
    assert solver.pgmres_graph is graph and solver.pgmres_builds == 1
    assert krylov.counts["syncs"] == syncs
    xp, ip = solver.solve_pgmres(b, host_loops=True)
    assert krylov.counts["syncs"] > syncs
    assert ig.nits == i2.nits == ip.nits
    assert np.array_equal(xg, x2) and np.array_equal(xg, xp)
    true_rel = np.linalg.norm(b - a.matvec(xg)) / np.linalg.norm(b)
    assert true_rel < 1e-8


def test_pgmres_graph_failure_raises_on_card(monkeypatch, tmp_path):
    """No fallback to the host loops on the card: a krylov_small.cu that
    does not build, and a capture the CUDA runtime refuses, make
    solve_pgmres raise, with no host read of its loops."""
    _needs_card()
    from amg_tpu_torch.ops import cuda_build, krylov_small as KS
    from amg_tpu_torch.solve import krylov

    a, solver = _pgmres_solver("KRYLOV")
    b = np.ones(a.n_rows)
    lib = cuda_build.CudaLibrary("krylov_small.cu", KS._bind)
    lib.so = str(tmp_path / "libkrylov_small.so")
    monkeypatch.setattr(KS, "_LIB", lib)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "false")
    syncs = krylov.counts["syncs"]
    with pytest.raises(RuntimeError, match="nvcc failed"):
        solver.solve_pgmres(b)
    monkeypatch.undo()
    call = KS._call

    def refuse(name, *args):
        if name == "ks_capture_begin":
            raise RuntimeError("ks_capture_begin failed: CUDA error 1")
        return call(name, *args)

    monkeypatch.setattr(KS, "_call", refuse)
    _, solver = _pgmres_solver("KRYLOV")
    with pytest.raises(RuntimeError, match="ks_capture_begin"):
        solver.solve_pgmres(b)
    assert krylov.counts["syncs"] == syncs
    assert solver.pgmres_graph is None


# ---------------------------------------------------------------------------
# step graphs: each step of the host loops one replayed CUDA graph
# ---------------------------------------------------------------------------


def _graphs_built(solver, names):
    g = solver.steps.graphs
    assert solver.steps.route == "graph" and set(g) == set(names)
    assert all(s.graph is not None and s.replays > 0 for s in g.values())
    return dict(g)


@pytest.mark.parametrize("kind", ["solve", "mod_rel", "refined", "pcg",
                                  "batched", "refined_dense",
                                  "refined_dense_gs"])
def test_step_graphs_equal_eager_steps_on_card(kind):
    """tests/test_torch_step_graph.py's single-device cases on the card:
    every step a replay of its CUDA graph, equal to the eager steps
    (``eager=True``) bit for bit: iterations, histories and x; a second
    solve replays the same graphs (built once) with the same result.  The
    bf16 Dense cases' step holds D1 launches."""
    _needs_card()
    from test_torch_step_graph import _same, _single

    solver, solve, b, names = _single(kind, "cuda")
    got = solve(b)
    graphs = _graphs_built(solver, names)
    if kind.startswith("refined_dense"):
        assert graphs["refine"].per_step[dense_kernel][0]["spmv"] > 0
    builds = solver.steps.builds
    _same(got, solve(b, eager=True))
    again = solve(b)
    assert solver.steps.builds == builds
    assert all(solver.steps.graphs[n] is g for n, g in graphs.items())
    _same(again, got)


@pytest.mark.parametrize("kind", ["embedded", "general", "general_cycle",
                                  "gspmd", "gspmd_refined"])
def test_ring_step_graphs_equal_eager_steps_on_card(kind):
    """The ring solvers on 4 shards of one card (no process group): each
    step a replayed CUDA graph, equal to the eager steps bit for bit."""
    _needs_card()
    from test_torch_step_graph import _ring, _same

    solver, b, names = _ring(kind, "cuda")
    got = solver.solve(b)
    _graphs_built(solver, names)
    _same(got, solver.solve(b, eager=True))


def test_step_graph_launches_per_replay_equal_an_eager_step():
    """The kernel launches a replay adds (``per_step``, taken back from
    the capture) are those of one eager step, B1 and B2 both."""
    _needs_card()
    from amg_tpu_torch.ops import launch_counts

    a, solver, b = _jit_solver("structured")
    solver.solve(b)
    per_step = solver.steps.graphs["cycle"].per_step
    assert per_step[dia_kernel][0] and per_step[well_kernel][0]
    xd, bd = solver._pad_vec(np.zeros(a.n_rows)), solver._pad_vec(b)
    before = launch_counts.snapshot()
    solver._step(xd, bd)
    torch.cuda.synchronize()
    eager = launch_counts.delta(before, launch_counts.snapshot())
    for K in launch_counts.MODULES:
        assert per_step[K] == eager[K]


def test_krylov_coarsest_in_the_solve_refined_graph_on_card():
    """A KRYLOV coarsest solve inside solve_refined's step graph: its
    while and if nodes are added to the captured step (the step graph
    keeps the coarsest LoopGraph alive), 0 host reads of the Krylov
    loops, equal to the eager steps bit for bit."""
    _needs_card()
    from amg_tpu_torch.solve import krylov

    a = amg.poisson3d(24)
    solver = amg.AMGSolver(a, amg.AMGParams(
        dtype="float32", refine=True, tol=1e-8,
        coarsest_solver=amg.CoarsestSolver.KRYLOV, verbose=0),
        log=lambda *_: None)
    b = a.matvec(np.random.default_rng(33).standard_normal(a.n_rows))
    syncs = krylov.counts["syncs"]
    got = solver.solve(b)
    assert krylov.counts["syncs"] == syncs
    g = _graphs_built(solver, {"refine"})["refine"]
    ks = list(solver.mg.krylov.values())
    assert ks and all(k.graph in g.embedded for k in ks)
    assert g.nested_nodes > 0
    from test_torch_step_graph import _same

    _same(got, solver.solve(b, eager=True))
    r = b - a.matvec(got[0])
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-8


def test_step_graph_capture_raises_on_a_host_read():
    """A step that reads the host cannot be captured: the second warm-up
    runs under torch.cuda.set_sync_debug_mode("error") and raises; no
    eager fallback."""
    _needs_card()
    a, solver, b = _jit_solver("structured", refine=True, tol=1e-8)
    step = solver._refine_step

    def reading_step(x, b):
        x, r = step(x, b)
        float(r)    # a host read
        return x, r

    solver._refine_step = reading_step
    with pytest.raises(RuntimeError):
        solver.solve(b)
    assert torch.cuda.get_sync_debug_mode() == 0
    assert solver.steps.graphs["refine"].graph is None


def test_cg_with_a_one_process_psum_is_a_graph_on_card():
    """``krylov.cg`` with a one-process mesh's ``psum``: one CUDA graph (0
    host reads), equal to ``cg_plain`` bit for bit."""
    _needs_card()
    from amg_tpu_torch.parallel import make_mesh
    from amg_tpu_torch.parallel.dist import shard_matrix, shard_vector
    from amg_tpu_torch.parallel.spmd_cycle import gspmd_spmv
    from amg_tpu_torch.solve import krylov

    mesh = make_mesh(8, device="cuda")
    a = amg.poisson2d(16)
    e = shard_matrix(amg.Ell.from_csr(a, device="cuda"), mesh, gspmd=True)
    bs = shard_vector(a.matvec(np.random.default_rng(5).standard_normal(256)),
                      mesh, pad_to=256)

    def amul(v):
        return gspmd_spmv(e, v, mesh)

    syncs = krylov.counts["syncs"]
    got, conv = krylov.cg(amul, bs, torch.zeros_like(bs), tol=1e-10,
                          maxit=200, psum=mesh.psum)
    assert krylov.counts["syncs"] == syncs and bool(conv)
    want, _ = krylov.cg_plain(amul, bs, torch.zeros_like(bs), tol=1e-10,
                              maxit=200, psum=mesh.psum)
    assert krylov.counts["syncs"] > syncs
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# a process group's steps: one-rank NCCL groups on the card
# ---------------------------------------------------------------------------


class _OneRankNccl:
    """Within: this process is a one-rank NCCL process group
    (``multihost.initialize``), destroyed on the way out."""

    def __enter__(self):
        import socket
        import torch.distributed as tdist
        from amg_tpu_torch.parallel import multihost

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        assert multihost.initialize(f"localhost:{port}", 1, 0)
        assert tdist.get_backend() == "nccl"

    def __exit__(self, *exc):
        import torch.distributed as tdist

        tdist.destroy_process_group()


@pytest.mark.parametrize("kind", ["embedded", "general", "gspmd"])
def test_ring_steps_in_a_one_rank_nccl_group_on_card(kind):
    """``SpmdAMGSolver`` (embedded and general modes) and
    ``DistAMGSolver`` inside a one-rank NCCL group take the graph route
    (NCCL's ``all_reduce`` and all-gathers captured in the step graphs),
    equal to their eager steps and to the run without a group bit for bit
    (a one-rank collective is the identity)."""
    _needs_card()
    from test_torch_step_graph import _ring, _same

    solver, b, names = _ring(kind, "cuda")
    want = solver.solve(b)
    del solver
    with _OneRankNccl():
        solver, _, _ = _ring(kind, "cuda")
        assert solver.mesh.backend == "nccl"
        got = solver.solve(b)
        _graphs_built(solver, names)
        _same(got, solver.solve(b, eager=True))
    _same(got, want)


def test_cg_with_an_nccl_psum_keeps_its_host_loop_on_card():
    """``krylov.cg`` with the ``psum`` of a one-rank NCCL group, on the
    ring product of a row-sharded Dia operator: the route follows the
    backend, so the group's loop is one CUDA graph as on four cards (its
    ``all_reduce`` and halo messages inside the while body, NCCL's event
    nodes taken out of it), 0 host reads, equal to ``cg_plain`` (the host
    loop, one read per iteration) bit for bit and to the run without a
    group."""
    _needs_card()
    from amg_tpu_torch.parallel import make_mesh
    from amg_tpu_torch.solve import krylov
    from chip_smoke import ring_krylov
    from _torch_mh_worker import problem

    a, b, _ = problem("cg")
    want = ring_krylov("cg", a, b, make_mesh(4))
    assert want["reads"] == 0
    with _OneRankNccl():
        mesh = make_mesh(4)
        assert krylov._route(mesh.device, mesh.psum) == "graph"
        got = ring_krylov("cg", a, b, mesh)
        plain = ring_krylov("cg", a, b, mesh, plain=True)
    assert got["reads"] == 0 and plain["reads"] >= plain["its"] > 0
    assert got["status"] == plain["status"] == want["status"] == 1
    assert got["its"] == plain["its"] == want["its"]
    np.testing.assert_array_equal(got["x"], plain["x"])
    np.testing.assert_array_equal(got["x"], want["x"])


@pytest.mark.parametrize("kind", ["cg", "gmres", "fcg"])
@pytest.mark.parametrize("group", [None, "nccl"])
def test_sharded_krylov_is_one_graph_on_card(kind, group):
    """``krylov.<kind>`` with the ``psum`` of 4 in-process shards (and of
    a one-rank NCCL group) on poisson3d(16)'s ring product: one CUDA
    graph, 0 host reads, equal to ``<kind>_plain`` bit for bit (status,
    iterations, x); gmres right-preconditioned by Jacobi."""
    _needs_card()
    import contextlib
    from amg_tpu_torch.parallel import make_mesh
    from chip_smoke import ring_krylov
    from _torch_mh_worker import problem

    a, b, _ = problem(kind)
    with _OneRankNccl() if group else contextlib.nullcontext():
        mesh = make_mesh(4)
        assert mesh.backend == group
        got = ring_krylov(kind, a, b, mesh)
        plain = ring_krylov(kind, a, b, mesh, plain=True)
    assert got["route"] == "graph" and got["graph"]["nodes"] > 0
    assert got["reads"] == 0 and plain["reads"] > plain["its"] > 0
    assert got["status"] == plain["status"] == 1
    assert got["its"] == plain["its"]
    np.testing.assert_array_equal(got["x"], plain["x"])


def test_fcg_graph_equals_plain_on_card():
    """``krylov.fcg`` on one vector as one CUDA graph (a while node whose
    body holds the iteration and an if node around the residual
    replacement every 10 iterations): 0 host reads, equal to
    ``fcg_plain`` bit for bit (x, iterations, residual norm)."""
    _needs_card()
    from amg_tpu_torch.solve import krylov

    a = amg.poisson3d(16)
    op = Dia.from_csr(a, dtype=torch.float64, device="cuda")
    b = torch.zeros(op.padded_rows, dtype=torch.float64)
    b[: a.n_rows] = torch.from_numpy(a.matvec(
        np.random.default_rng(3).standard_normal(a.n_rows)))
    b = b.cuda()
    syncs = krylov.counts["syncs"]
    xg, ig, rg = krylov.fcg(op, b, torch.zeros_like(b), tol=1e-10,
                            maxit=500)
    assert krylov.counts["syncs"] == syncs
    xp, ip, rp = krylov.fcg_plain(op, b, torch.zeros_like(b), tol=1e-10,
                                  maxit=500)
    assert krylov.counts["syncs"] > syncs
    assert 10 < int(ig) == int(ip) < 500
    assert torch.equal(xg, xp) and torch.equal(rg, rp)


def test_loop_graph_takes_event_nodes_out_of_loop_bodies_on_card():
    """A segment that waits on and records an external event (the nodes
    NCCL adds to a graph that captures one of its calls): captured at a
    program's top level it keeps both nodes; inside a while body the
    LoopGraph takes them out (``events`` 2) and the loop runs its 10
    trips."""
    _needs_card()
    from amg_tpu_torch.ops import krylov_small as KS
    from amg_tpu_torch.solve.loop_graph import LoopGraph, While

    ev = torch.cuda.Event(external=True)
    n = torch.zeros((), dtype=torch.int32, device="cuda")
    go = torch.ones((), dtype=torch.bool, device="cuda")

    def body():
        torch.cuda.current_stream().wait_event(ev)
        n.add_(1)
        go.copy_(n < 10)
        ev.record()

    top = LoopGraph((body,), "cuda", restore=(n, go))
    top.build()
    kinds = KS.graph_kinds(top.captured[body].raw_cuda_graph())
    assert kinds.get("event_wait") == kinds.get("event_record") == 1
    assert top.events == 0
    top.close()
    loop = LoopGraph((While(go, (body,)),), "cuda", restore=(n, go))
    loop.launch()
    torch.cuda.synchronize()
    assert loop.events == 2 and int(n) == 10
    assert not {"event_wait", "event_record"} & set(
        KS.graph_kinds(loop.captured[body].raw_cuda_graph()))
    loop.close()


# ---------------------------------------------------------------------------
# D1: a bf16 Dense operator times one f32 vector
# ---------------------------------------------------------------------------

# (logical rows, padded size, first row, rows launched, columns cut): the
# Dense levels 4 and 5 of poisson3d(100) in the structured cell, a row
# range of level 4 (a GS class), a logical size inside its padding, and
# columns cut to a width that is not a multiple of 8 (a row view: the
# kernel's value-by-value path)
DENSE_CASES = {"L4": (6400, 6400, 0, None, 0),
               "L5": (3328, 3328, 0, None, 0),
               "L4_rows": (6400, 6400, 1234, 777, 0),
               "ragged": (6389, 6400, 0, None, 0),
               "cut_cols": (3000, 3072, 5, 2900, 3)}


def _dense_bf16(n, pad, seed):
    """A random n x n operator, ~30% filled, packed as a bf16 Dense level
    of pad rows and columns on the card, and an f32 x of pad entries."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.3)
    rr, cc = np.nonzero(dense)
    csr = CSR.from_coo(rr, cc, dense[rr, cc], (n, n))
    a = Dense.from_csr(csr, dtype=torch.bfloat16, pad_rows_to=pad,
                       pad_cols_to=pad, device="cuda")
    x = torch.from_numpy(rng.standard_normal(pad)).float().cuda()
    return a, x


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_kernel_matches_plain(case):
    """D1 against its plain version (the values widened to f32, then
    cuBLAS's f32 gemv) and against an f64 product of the same values.

    Tolerances, per row, with s = sum_c |a_rc x_c|: two f32 sums of the
    same n products in any two orders differ by at most 2 n 2^-24 s (n up
    to 6,400 columns); D1 alone sums each of a row's 256 threads' at most
    8 ceil(n / 2048) products in order, then the 32 lanes of a warp in 5
    shuffle levels and the 8 warps' sums in order, so it lies within
    (8 ceil(n / 2048) + 13) 2^-24 s of the f64 product, which catches a
    dropped term (about s / n).  A row range gives the rows of the whole
    product bit for bit: the summation order depends on the columns
    only."""
    _needs_card()
    n, pad, start, size, cut = DENSE_CASES[case]
    a, x = _dense_bf16(n, pad, seed=len(case))
    if cut:
        a = Dense(a.vals[:, : pad - cut], a.shape, a.nnz)
        x = x[: pad - cut]
    counts = dense_kernel.launches["spmv"]
    got = dense_kernel.spmv(a, x, start, size)
    want = dense_kernel.spmv_plain(a, x, start, size)
    torch.cuda.synchronize()
    assert dense_kernel.launches["spmv"] == counts + 1
    rows = a.vals[start: start + got.shape[0]].double()
    xd = x[: a.padded_cols].double()
    s = rows.abs() @ xd.abs()
    exact = rows @ xd
    cols = a.padded_cols
    assert got.shape == want.shape
    assert torch.all((got.double() - want.double()).abs()
                     <= 2 * cols * 2.0 ** -24 * s)
    depth = 8 * -(-cols // 2048) + 13
    assert torch.all((got.double() - exact).abs() <= depth * 2.0 ** -24 * s)
    if size is not None:
        assert torch.equal(got, dense_kernel.spmv(a, x)[start: start + size])
    if case == "ragged":   # the padding rows are 0
        assert torch.all(dense_kernel.spmv(a, x)[n:] == 0)


def test_dense_cuda_tensor_never_falls_back(monkeypatch):
    """A CUDA tensor reaches D1 or raises; the plain version is not
    called."""
    _needs_card()
    a, x = _dense_bf16(300, 384, seed=3)

    def refuse(*args, **kw):
        raise AssertionError("plain version called on CUDA tensors")

    monkeypatch.setattr(dense_kernel, "spmv_plain", refuse)
    dense_kernel.spmv(a, x)
    with pytest.raises(TypeError):
        dense_kernel.spmv(a, x.double())
    with pytest.raises(ValueError):
        dense_kernel.spmv(a, x.cpu())                     # CPU x
    with pytest.raises(ValueError):
        dense_kernel.spmv(a, x[:-8])                      # short x
    with pytest.raises(ValueError, match="contiguous"):
        dense_kernel.spmv(a, torch.stack([x, x], 1)[:, 0])


def test_dense_kernel_launches_in_a_structured_solve_call():
    """One solve call of the structured cell (poisson3d(100), the
    parameters of benchmark/configs/p3d7_1m.json) launches D1 7 times per
    cycle on its bf16 Dense level 4 (Chebyshev of degree 3 before and after
    the coarse correction, and the residual): 56 launches in 8 cycles,
    through the replayed step graph.  Level 3 above it packs as WEll
    (its band declined by "auto"), so level 4's 6,396 rows pad to the
    WEll granule: 7,168 x 7,168."""
    _needs_card()
    a = amg.poisson3d(100)
    pars = amg.AMGParams(
        dtype="float32", refine=True, accel="none",
        smoother=amg.SmootherType.GS,
        coarse_smoother=amg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="bfloat16", coarse_sparsify=0.005,
        sparsify_from_level=2, coarse_stop_rows=3500, tol=1e-8, max_it=60,
        verbose=0, embed_levels=0, use_well="auto", use_banded="auto")
    solver = amg.AMGSolver(a, pars, log=lambda *_: None)
    levels = solver.mg.levels
    dense = [i for i, lv in enumerate(levels[:-1])
             if isinstance(lv.a, Dense) and lv.a.vals.dtype == torch.bfloat16]
    assert isinstance(levels[3].a, WEll)
    assert dense == [4] and levels[4].n == 6396
    assert levels[4].a.vals.shape == (7168, 7168)
    b = np.random.default_rng(5).uniform(-1.0, 1.0, a.n_rows)
    solver.solve(b)                      # builds the step graph
    for e in dense_kernel.launches:
        dense_kernel.launches[e] = 0
    dense_kernel.launches_by_shape.clear()
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    assert info.nits == 8 and info.rres < 1e-8
    assert dense_kernel.launches == {"spmv": 56}
    assert dense_kernel.launches_by_shape == {("spmv", 7168, 7168): 56}
