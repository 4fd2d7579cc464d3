"""Two faults of the port's ring solvers, held on 4 CPU shards.

* The general SPMD mode (``embed_levels=0``) with f32 cycles, ``refine``
  and ``accel="cg"`` on a Dia level 0 whose pad is not whole row groups
  per shard (poisson3d(20): pad 8,000; (24): 13,824): FCG runs in f64
  against the row-sharded f64 Dia (B1's window entry), as the embedded
  mode does, and reaches tol 1e-8 within 1 iteration of the single-device
  ``solve_pcg``.  It used to run FCG in f32 and return at ~1.3e-7 without
  raising.  amg_tpu raises a ``TypeError`` on the same call
  (``amg_tpu/parallel/halo.py:329``), so the port is held against its own
  single device.
* The divergence guard of the entry frame's one host loop of cycles
  (``solve/entry.py::EntryFrame._cycles``): a cycle whose residual
  overflows (weighted Jacobi with weight 2, f32) stops the loop at the
  first non-finite residual and returns the last finite iterate, as each
  solver runs the loop: plain cycles in ``AMGSolver.solve``,
  ``SpmdAMGSolver.solve`` and ``DistAMGSolver.solve``, defect correction
  in ``AMGSolver.solve_refined`` and ``DistAMGSolver.solve_refined``
  (whose f64 outer iterate overflows later: more cycles allowed).
* A row-sharded Dense operator's all-gather product, and a BandedBlocks
  operator's ring product, compute each shard's rows as a process holding
  only that shard does (one matvec, one batched product per shard), so
  one process of 4 shards and 4 processes of one shard sum alike: on the
  card cuBLAS picks its f32 gemv by the rows and sums its f32 batched
  product in another order for another batch count (``drift_gspmd.py``,
  4 H100s).
"""

import numpy as np
import pytest
import torch

import amg_tpu_torch as tamg
from amg_tpu_torch.parallel import DistAMGSolver, SpmdAMGSolver, make_mesh
from amg_tpu_torch.ops.spmv import banded_window_product
from amg_tpu_torch.parallel.dist import shard_banded, shard_rows
from amg_tpu_torch.parallel.halo import banded_spmv_ring_local, spmv_local_full

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

QUIET = dict(log=lambda *a, **k: None)


@pytest.mark.parametrize("n", [20, 24])
def test_general_mode_fcg_in_f64_on_dia_level0(n):
    a = tamg.poisson3d(n)
    pars = tamg.AMGParams(
        dtype="float32", refine=True, accel="cg", tol=1e-8, max_it=60,
        embed_levels=0, smoother=tamg.SmootherType.GS,
        coarse_smoother=tamg.SmootherType.CHEBYSHEV, verbose=0)
    b = np.ones(a.n_rows)
    s = SpmdAMGSolver(a, pars, mesh=make_mesh(4, device="cpu"), **QUIET)
    assert s.E == 0 and isinstance(s.mg.levels[0].a, tamg.Dia)
    assert s.pad % (1024 * 4) != 0
    assert isinstance(s.a0_hi, tamg.Dia)
    assert s.a0_hi.vals.dtype == torch.float64
    x, info = s.solve(b)
    x1, i1 = tamg.AMGSolver(a, pars, device="cpu", **QUIET).solve_pcg(b)
    assert abs(info.nits - i1.nits) <= 1
    for xv in (x, x1):
        assert np.linalg.norm(b - a.matvec(xv)) / np.linalg.norm(b) < 1e-8


@pytest.mark.parametrize("solver,loop", [
    ("amg", "plain"), ("amg", "refined"), ("spmd", "plain"),
    ("gspmd", "plain"), ("gspmd", "refined")])
def test_divergence_guard_keeps_last_finite_x(solver, loop):
    a = tamg.poisson2d(32)
    b = np.ones(a.n_rows)
    refined = loop == "refined"
    kw = dict(dtype="float32", smoother=tamg.SmootherType.WJACOBI,
              relax=2.0, max_it=240 if refined else 60, refine=refined,
              verbose=0)
    mesh = make_mesh(4, device="cpu")
    if solver == "amg":
        s = tamg.AMGSolver(a, tamg.AMGParams(**kw), device="cpu", **QUIET)
    elif solver == "spmd":
        s = SpmdAMGSolver(a, tamg.AMGParams(embed_levels=0, **kw), mesh=mesh,
                          **QUIET)
    else:
        s = DistAMGSolver(a, tamg.AMGParams(coarse_replicate_nnz=200, **kw),
                          mesh=mesh, **QUIET)
    assert (s.a0_hi is not None) == refined
    x, info = s.solve(b)
    # it diverged: stopped before max_it, every kept residual finite and
    # growing, and x the iterate of the last kept one; the history counts
    # outer steps, headed by ||b|| but in the ring's plain loop
    k = s.pars.refine_inner_cycles if refined else 1
    head = 0 if solver != "amg" and not refined else 1
    assert 1 <= info.nits < s.pars.max_it
    assert len(info.residuals) == info.nits // k + head
    assert np.all(np.isfinite(info.residuals))
    assert info.residuals[-1] > 1e10 * info.residuals[0]
    assert np.all(np.isfinite(x))
    assert np.linalg.norm(b - a.matvec(x.astype(np.float64))) \
        == pytest.approx(info.ares, rel=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_dense_product_per_shard_block(dtype):
    rng = np.random.default_rng(8)
    m, n = 96, 300
    vals = torch.from_numpy(rng.standard_normal((4 * m, n))).to(dtype)
    a = tamg.Dense(vals, (4 * m, n), 4 * m * n)
    x = torch.from_numpy(rng.standard_normal(n)).float()
    sharded = shard_rows(a, make_mesh(4, device="cpu"))
    got = spmv_local_full(sharded, x, make_mesh(4, device="cpu"))
    blocks = [tamg.Dense(vals[s * m:(s + 1) * m].contiguous(), (m, n), m * n)
              for s in range(4)]
    want = torch.cat([spmv_local_full(blk, x, make_mesh(1, device="cpu"))
                      for blk in blocks])
    assert torch.equal(got, want)
    whole = spmv_local_full(a, x, make_mesh(1, device="cpu"))
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-5)


def test_sharded_banded_product_per_shard():
    """The ring product of a BandedBlocks operator on 4 shards in one
    process: shard s's rows are the batched product of its own block rows
    on its own haloed window, as a one-shard process computes them."""
    a = tamg.poisson2d(64)
    bb = tamg.BandedBlocks.from_csr(a, nb=2, dtype=torch.float32)
    mesh = make_mesh(4, device="cpu")
    nbr, nb = bb.vals.shape[0], bb.nb
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        nbr * 128)).float()
    got = banded_spmv_ring_local(shard_banded(bb, mesh),
                                 x.reshape(4, -1), mesh)
    q, m, halo = nbr // 4, nbr * 32, nb * 128
    xp = torch.nn.functional.pad(x, (halo, halo))
    for s in range(4):
        block = tamg.BandedBlocks(bb.vals[s * q:(s + 1) * q], nb, bb.shape,
                                  bb.nnz)
        want = banded_window_product(block, xp[None, s * m:(s + 1) * m
                                               + 2 * halo], torch.float32)
        assert torch.equal(got[s], want[0])
