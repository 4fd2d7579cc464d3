"""The sharded Krylov API on the CPU: ``gmres``, ``gmres_plain``, ``fcg``
and ``fcg_plain`` of ``amg_tpu_torch.solve.krylov`` with ``psum=``
(``amg_tpu``'s ``axis_name``), on a row-sharded vector and the ring
product of a row-sharded Dia operator.

* Against ``amg_tpu``'s ``gmres(axis_name=)`` and ``fcg(axis_name=)``
  under ``shard_map`` on the conftest's 8 virtual devices (its ring
  product ``halo.dia_spmv_ring_local``), with the port's ``make_mesh(8,
  device="cpu").psum``: the same numpy arrays (the Dia planes, b, the
  Jacobi scaling) go to both packages; f64, iterations within 1 and x
  within 1e-9 of ||x|| (the psums add the shards' partial sums in another
  order than XLA's all-reduce, so bit equality is not expected).
* The loop bodies (``GMRESLoop``, ``FCGLoop``) run by ``run_plain`` with
  torch's host reads patched to raise (tests/test_torch_krylov_loop.py)
  against ``gmres_plain`` / ``fcg_plain`` bit for bit, with and without
  ``psum``: the bodies the card's CUDA graph captures read nothing from
  the host.
* 2 gloo processes of 4 shards each (tests/_torch_mh_worker.py's
  ``gmres`` and ``fcg`` kinds) against 8 shards in one process: each
  process's graph entry equals its host loop bit for bit (status,
  iterations, x), and the one-process run's iterations and x within
  1e-12 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from amg_tpu.parallel import halo as jhalo, make_mesh as jmake_mesh
from amg_tpu.solve import krylov as jk

import amg_tpu_torch as tamg
from amg_tpu_torch.parallel import halo, make_mesh
from amg_tpu_torch.parallel.dist import shard_dia, shard_vector
from amg_tpu_torch.solve import krylov as tk
from amg_tpu_torch.sparse import Dia

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_krylov_loop import run_loops

D = 8                 # shards: the conftest's virtual devices
TOL, MAXIT, RESTART = 1e-10, 300, 30


def _problem():
    """poisson2d(16) (256 rows: 8 shards of 32 rows, halos of 16) as an
    f64 Dia, a seeded b and the Jacobi scaling, as numpy arrays."""
    a = tamg.poisson2d(16)
    d = Dia.from_csr(a, dtype=torch.float64, device="cpu")
    assert d.padded_rows % D == 0
    b = np.zeros(d.padded_rows)
    b[: a.n_rows] = np.random.default_rng(16).standard_normal(a.n_rows)
    diag = d.vals[list(d.offsets).index(0)].numpy()
    dinv = np.where(diag != 0, 1 / np.where(diag != 0, diag, 1), 0.0)
    return d, b, dinv


def _port(kind, d, b, dinv, jacobi, entry=""):
    """The port's ``krylov.<kind>`` (``entry`` ``"plain"``: its host
    loop; ``"loop"``: its loop object's program run by ``run_plain`` with
    host reads patched to raise) on ``make_mesh(8)``'s ring: ``(x (pad,),
    iterations)``."""
    mesh = make_mesh(D, device="cpu")
    ds = shard_dia(d, mesh)
    bs = shard_vector(b, mesh, pad_to=d.padded_rows)
    dv = shard_vector(dinv, mesh, pad_to=d.padded_rows)

    def amul(v):
        return halo.dia_spmv_ring_local(ds, v, mesh)

    M = (lambda r: dv * r) if jacobi else None
    if entry == "loop":
        loop = (tk.GMRESLoop(amul, bs, TOL, MAXIT, RESTART, M, mesh.psum)
                if kind == "gmres" else
                tk.FCGLoop(amul, bs, TOL, MAXIT, M, mesh.psum))
        loop.b.copy_(bs)
        run_loops(loop.program)
        x, its = (loop.x, loop.it) if kind == "gmres" else \
            (loop.state[0], loop.it)
    elif kind == "gmres":
        fn = tk.gmres_plain if entry == "plain" else tk.gmres
        x, _, its = fn(amul, bs, torch.zeros_like(bs), tol=TOL, maxit=MAXIT,
                       restart=RESTART, M=M, return_iters=True,
                       psum=mesh.psum)
    else:
        fn = tk.fcg_plain if entry == "plain" else tk.fcg
        x, its, _ = fn(amul, bs, torch.zeros_like(bs), tol=TOL, maxit=MAXIT,
                       M=M, psum=mesh.psum)
    return x.reshape(-1).numpy(), int(its)


def _jax(kind, d, b, dinv, jacobi):
    """amg_tpu's ``gmres`` / ``fcg`` with ``axis_name="x"`` under
    ``shard_map`` over 8 virtual devices: ``(x (pad,), iterations)``."""
    offsets = tuple(d.offsets)

    def fn(vl, bl, dl):
        def amul(v):
            return jhalo.dia_spmv_ring_local(offsets, D, "x", vl, v)

        M = (lambda r: dl * r) if jacobi else None
        x0 = jnp.zeros_like(bl)
        if kind == "gmres":
            x, _, its = jk.gmres(amul, bl, x0, tol=TOL, maxit=MAXIT,
                                 restart=RESTART, M=M, axis_name="x",
                                 return_iters=True)
        else:
            x, its, _ = jk.fcg(amul, bl, x0, tol=TOL, maxit=MAXIT, M=M,
                               axis_name="x")
        return x, its

    x, its = shard_map(fn, mesh=jmake_mesh(D),
                       in_specs=(P(None, "x"), P("x"), P("x")),
                       out_specs=(P("x"), P()), check_vma=False)(
        jnp.asarray(d.vals.numpy()), jnp.asarray(b), jnp.asarray(dinv))
    return np.asarray(x), int(its)


@pytest.mark.parametrize("kind,jacobi", [("gmres", True), ("gmres", False),
                                         ("fcg", False), ("fcg", True)])
def test_sharded_krylov_matches_amg_tpu(kind, jacobi):
    """``krylov.<kind>(psum=)`` on 8 row shards against amg_tpu's
    ``<kind>(axis_name=)`` under shard_map: iterations within 1, x within
    1e-9 of ||x||, the same answer as the unsharded port."""
    d, b, dinv = _problem()
    x, its = _port(kind, d, b, dinv, jacobi)
    xj, itj = _jax(kind, d, b, dinv, jacobi)
    assert 0 < its < MAXIT and abs(its - itj) <= 1
    assert np.linalg.norm(x - xj) <= 1e-9 * np.linalg.norm(xj)
    # one vector, no psum: the same solve
    bt, M = torch.from_numpy(b), torch.from_numpy(dinv)
    kw = dict(tol=TOL, maxit=MAXIT, M=(lambda r: M * r) if jacobi else None)
    if kind == "gmres":
        x1, _, it1 = tk.gmres(d, bt, torch.zeros_like(bt), restart=RESTART,
                              return_iters=True, **kw)
    else:
        x1, it1, _ = tk.fcg(d, bt, torch.zeros_like(bt), **kw)
    assert abs(int(it1) - its) <= 1
    assert np.linalg.norm(x - x1.numpy()) <= 1e-9 * np.linalg.norm(x)


@pytest.mark.parametrize("kind,sharded", [("gmres", True), ("fcg", True),
                                          ("fcg", False)])
def test_sharded_loop_bodies_read_no_host_and_equal_plain(kind, sharded):
    """The loop bodies run by ``run_plain`` with host reads patched to
    raise equal the entry and its plain host loop bit for bit (``fcg``
    also on one vector without ``psum``)."""
    d, b, dinv = _problem()
    if sharded:
        x, its = _port(kind, d, b, dinv, True, "loop")
        xg, itg = _port(kind, d, b, dinv, True)
        xp, itp = _port(kind, d, b, dinv, True, "plain")
    else:
        bt, dv = torch.from_numpy(b), torch.from_numpy(dinv)

        def M(r):
            return dv * r

        loop = tk.FCGLoop(d, bt, TOL, MAXIT, M)
        loop.b.copy_(bt)
        run_loops(loop.program)
        x, its = loop.state[0].numpy(), int(loop.it)
        out = [tk.fcg(d, bt, torch.zeros_like(bt), tol=TOL, maxit=MAXIT,
                      M=M),
               tk.fcg_plain(d, bt, torch.zeros_like(bt), tol=TOL,
                            maxit=MAXIT, M=M)]
        (xg, itg), (xp, itp) = ((o[0].numpy(), int(o[1])) for o in out)
        assert torch.equal(out[0][2], out[1][2])
    assert 0 < its < MAXIT and its == itg == itp
    np.testing.assert_array_equal(x, xp)
    np.testing.assert_array_equal(xg, xp)


@pytest.mark.parametrize("kind", ["gmres", "fcg"])
def test_sharded_krylov_in_two_gloo_processes(kind, tmp_path):
    """``krylov.<kind>`` with the ``psum`` of 2 gloo processes of 4 shards
    each (the host route: gloo's collectives are not captured), on
    poisson3d(16)'s ring product with halo messages between the
    processes: each process's entry equals its plain host loop bit for
    bit, and the 8-shard run in one process's iterations and x within
    1e-12 relative (the processes' partial sums add in another order)."""
    from chip_smoke import ring_krylov
    from _torch_mh_worker import problem
    from test_torch_step_graph import _workers

    got = _workers(tmp_path, kind, nproc=2, shards=8, timeout=120)
    a, b, _ = problem(kind)
    one = ring_krylov(kind, a, b, make_mesh(D, device="cpu"))
    assert one["status"] == 1 and one["reads"] > 0
    for g in got:
        assert str(g["backend"]) == "gloo"
        assert int(g["status"]) == int(g["status_plain"]) == 1
        assert int(g["its"]) == int(g["its_plain"]) == one["its"]
        np.testing.assert_array_equal(g["x"], g["x_plain"])
        np.testing.assert_allclose(g["x"], one["x"], rtol=0,
                                   atol=1e-12 * np.abs(one["x"]).max())
    np.testing.assert_array_equal(got[0]["x"], got[1]["x"])
