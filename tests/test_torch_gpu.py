"""Tests of amg_tpu_torch that need a CUDA card (marker ``gpu``).

Each skips on a machine without a card.  The file imports neither jax nor
amg_tpu, so on the card's machine (which has no JAX) it runs as::

    python -m pytest --noconftest tests/test_torch_gpu.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the rest of the
suite).  Tolerances are those of tests/test_torch_dia.py and
tests/test_torch_solve.py.
"""

import json
import os

import numpy as np
import pytest
import torch

import amg_tpu_torch as amg
from amg_tpu_torch.ops import dia_kernel
from amg_tpu_torch.sparse import CSR, Dia

pytestmark = pytest.mark.gpu

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TOL = {torch.float32: 2e-6, torch.bfloat16: 1e-5, torch.float64: 1e-13}


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
    assert all(dia_kernel.launches[e] > before[e] for e in before)
