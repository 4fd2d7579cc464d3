"""The Krylov layer's device loops on the CPU: the loop bodies of
``amg_tpu_torch.solve.krylov`` (:class:`CGLoop`, :class:`GMRESLoop`,
:class:`CoarsestKrylov`) run by the host driver of ``solve.loop_graph``
(``run_plain``: a Python ``while``/``if`` on the device flag, the plain
version of the CUDA graph's while and if nodes) against amg_tpu's
``lax.while_loop``/``lax.cond`` versions, with every host read patched to
raise inside the bodies: ``torch.Tensor.__bool__``, ``item``, ``cpu``,
``tolist``, ``numpy``, ``__int__`` and ``__float__`` raise while a body
runs, and the driver reads its flags through the unpatched ``__bool__``.
The CUDA graphs of the same programs are held against these loops on the
card (tests/test_torch_gpu.py, chip_smoke.py phase 17).

Tolerances (those of tests/test_torch_krylov.py, for the same reasons):

* f64 ``cg`` and ``gmres``: equal statuses and iteration counts,
  solutions to ``1e-10`` relative (summation order: XLA against torch);
* f32 ``cg`` at the unreachable ``1e-9`` on the bench configuration's
  148-row coarsest level: the same ``ERROR_SOLVER_TOLSMALL`` status,
  iterations within 5 of amg_tpu's (where each of the 30 false-convergence
  restarts fires moves with the summation order);
* the KRYLOV coarsest solve of the indefinite 20 x 20 system: solutions
  to ``1e-8`` relative (condition ~11, CG stops at ctol 1e-10);
* a batch against its columns run alone: equal statuses and iterations,
  solutions to ``1e-10`` relative (a batch's dots reduce in another
  kernel than one vector's).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import amg_tpu as jamg
from amg_tpu.solve import cycle as jcycle, krylov as jk
from amg_tpu.sparse import CSR as JCSR, Ell as JEll

import amg_tpu_torch as tamg
from amg_tpu_torch import hierarchy as th
from amg_tpu_torch.ops import krylov_small
from amg_tpu_torch.params import ErrorCode
from amg_tpu_torch.solve import krylov as tk
from amg_tpu_torch.solve.loop_graph import Copy, If, While, run_plain
from amg_tpu_torch.sparse import CSR as TCSR, Ell as TEll

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

HOST_READS = ("__bool__", "item", "cpu", "tolist", "numpy", "__int__",
              "__float__")


@contextlib.contextmanager
def no_host_reads():
    """Patch torch's host reads to raise; yield the loop driver's flag
    reader (the unpatched ``__bool__``) and the list of its reads."""
    orig = {n: getattr(torch.Tensor, n) for n in HOST_READS}
    reads = []

    def boom(*_, **__):
        raise AssertionError("a loop body read the host")

    def read(flag):
        reads.append(flag)
        return orig["__bool__"](flag)

    for n in HOST_READS:
        setattr(torch.Tensor, n, boom)
    try:
        yield read, reads
    finally:
        for n, fn in orig.items():
            setattr(torch.Tensor, n, fn)


def run_loops(prog):
    """``prog`` under the host driver with host reads patched to raise;
    returns the number of flag reads."""
    with no_host_reads() as (read, reads):
        run_plain(prog, read)
    return len(reads)


def _ells(dense_or_csr):
    if isinstance(dense_or_csr, np.ndarray):
        ja, ta = (JCSR.from_dense(dense_or_csr),
                  TCSR.from_dense(dense_or_csr))
    else:
        ja, ta = dense_or_csr
    je, te = JEll.from_csr(ja), TEll.from_csr(ta)
    assert je.padded_rows == te.padded_rows
    return je, te, je.padded_rows


def _rel(x, y):
    x, y = np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    return np.abs(x - y).max() / max(np.abs(y).max(), 1e-300)


def _cg_loop(te, b, **kw):
    """The port's CG on ``b`` by its bodies: (x, status, iters, flag reads)."""
    tb = torch.from_numpy(b)
    loop = tk.CGLoop(te, tb, kw.pop("tol"), kw.pop("maxit"), **kw)
    loop.b.copy_(tb)
    reads = run_loops(loop.program)
    return loop.xout.numpy(), loop.status.numpy(), loop.it.numpy(), reads


def _p2d_rhs(n, seed):
    je, te, pad = _ells((jamg.poisson2d(n), tamg.poisson2d(n)))
    b = np.zeros(pad)
    b[: n * n] = jamg.poisson2d(n).matvec(
        np.random.default_rng(seed).standard_normal(n * n))
    return je, te, b


@pytest.mark.parametrize("stop", ["REL_RES", "REL_PRECRES", "MOD_REL_RES"])
def test_cg_body_matches_amg_tpu(stop):
    """f64 CG on poisson2d(12), each stop type: the masked body under the
    host driver reads nothing but its flag (once per iteration and once
    before the first), and ends where amg_tpu's while_loop ends."""
    je, te, b = _p2d_rhs(12, 23)
    st = getattr(tamg.StopType, stop)
    xj, _, (sj, ij) = jk.cg(je, jnp.asarray(b), jnp.zeros_like(b),
                            tol=1e-10, maxit=600, stop_type=st,
                            return_info=True)
    xt, s, it, reads = _cg_loop(te, b, tol=1e-10, maxit=600, stop_type=st)
    assert int(s) == int(sj) == 1 and int(it) == int(ij)
    assert reads == int(it) + 1
    assert _rel(xt, xj) < 1e-10


def _bench_pars(pkg):
    """tests/test_torch_krylov.py's bench configuration at a test-sized
    grid: f32 cycles, bf16 coarse operators, the KRYLOV coarsest solver."""
    return pkg.AMGParams(
        dtype="float32", refine=True, smoother=pkg.SmootherType.GS,
        coarse_smoother=pkg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="bfloat16", coarse_sparsify=0.005,
        sparsify_from_level=2, tol=1e-8, max_it=60, accel="none",
        coarsest_solver=pkg.CoarsestSolver.KRYLOV, use_well="off",
        use_banded="off", embed_levels=0, verbose=0)


def test_cg_body_f32_tolsmall():
    """f32 CG at tol 1e-9 on the bench configuration's 148-row coarsest
    Dense level (bf16 values): both packages end on the Check III net,
    iterations within 5."""
    quiet = dict(log=lambda *a, **k: None)
    js = jamg.AMGSolver(jamg.poisson3d(24), _bench_pars(jamg), **quiet)
    ts = tamg.AMGSolver(tamg.poisson3d(24), _bench_pars(tamg), **quiet,
                        device="cpu")
    ja, ta = js.mg.levels[-1].a, ts.mg.levels[-1].a
    assert type(ta).__name__ == "Dense" and ta.n_rows == 148
    b = np.zeros(ta.padded_rows, np.float32)
    b[:148] = np.random.default_rng(3).standard_normal(148)
    _, _, (sj, ij) = jk.cg(ja, jnp.asarray(b), jnp.zeros_like(b), tol=1e-9,
                           maxit=1000, return_info=True)
    _, s, it, _ = _cg_loop(ta, b, tol=1e-9, maxit=1000)
    tolsmall = int(ErrorCode.ERROR_SOLVER_TOLSMALL)
    assert int(sj) == int(s) == tolsmall
    assert abs(int(it) - int(ij)) <= 5, (int(it), int(ij))


def test_cg_body_batch_equals_columns():
    """A (3, pad) batch of poisson2d(10) right-hand sides, one of which
    meets its tolerance at once: one masked body over the batch stops
    every column where its one-vector loop stops."""
    je, te, pad = _ells((jamg.poisson2d(10), tamg.poisson2d(10)))
    B = np.zeros((3, pad))
    B[:, :100] = np.random.default_rng(4).standard_normal((3, 100))
    B[2] *= 1e-30
    xb, sb, ib, reads = _cg_loop(te, B, tol=1e-10, maxit=500)
    assert reads == int(ib.max()) + 1
    for c in range(3):
        xc, sc, ic, _ = _cg_loop(te, B[c], tol=1e-10, maxit=500)
        assert (int(sb[c, 0]), int(ib[c, 0])) == (int(sc), int(ic))
        assert _rel(xb[c], xc) < 1e-10


@pytest.mark.parametrize("restart", [20, 5])
def test_gmres_body_matches_amg_tpu(restart):
    """GMRES on the nonsymmetric 24 x 24 operator of
    tests/test_torch_krylov.py, in two restarts (m = 20) and in several (m
    = 5): the device-indexed Arnoldi step under the host driver reads
    nothing but the loops' flags, one read per test (before each restart
    and after the last, before each step and after a restart's last);
    equal verdict and steps, x to 1e-10 against amg_tpu's masked
    steps."""
    n = 24
    d = np.diag(np.arange(2.0, 2.0 + n)) + 0.3 * np.triu(np.ones((n, n)), 1)
    je, te, pad = _ells(d)
    b = np.zeros(pad)
    b[:n] = d @ np.random.default_rng(12345).standard_normal(n)
    xj, cj, ij = jk.gmres(je, jnp.asarray(b), jnp.zeros(pad), tol=1e-10,
                          maxit=300, restart=restart, return_iters=True)
    tb = torch.from_numpy(b)
    loop = tk.GMRESLoop(te, tb, 1e-10, 300, restart)
    loop.b.copy_(tb)
    reads = run_loops(loop.program)
    assert bool(cj) and bool(loop.conv) and int(loop.it) == int(ij)
    restarts = -(-int(ij) // restart)
    assert restarts > 1
    assert reads == (restarts + 1) + (int(ij) + restarts)
    assert _rel(loop.x.numpy(), xj) < 1e-10


def _indefinite_levels():
    """tests/test_torch_krylov.py's symmetric indefinite 20 x 20 coarsest
    system (CG breaks down on b = e_0 + e_10, GMRES takes over) as a
    one-level hierarchy of each package."""
    from amg_tpu.hierarchy import Hierarchy as JH, Level as JL

    n = 20
    d = np.diag(np.concatenate([np.arange(1.0, 11.0),
                                -np.arange(1.0, 11.0)]))
    d += 0.1 * (np.eye(n, k=1) + np.eye(n, k=-1))
    je, te, pad = _ells(d)
    diag = np.zeros(pad)
    diag[:n] = np.diag(d)
    inv = np.where(np.abs(diag) > 1e-300, 1.0 / np.where(diag == 0, 1, diag),
                   0.0)
    jl = JL(a=je, p=None, r=None, diag=jnp.asarray(diag),
            inv_diag=jnp.asarray(inv), l1_inv=jnp.zeros(pad),
            diag_mask=None, groups=None, gid=None, rho_dinv_a=jnp.ones(()),
            group_cf=())
    tl = th.Level(a=te, p=None, r=None, diag=torch.from_numpy(diag),
                  inv_diag=torch.from_numpy(inv), l1_inv=torch.zeros(pad,
                  dtype=torch.float64), diag_mask=None, groups=None,
                  gid=None, rho_dinv_a=1.0, group_cf=())
    return d, JH(levels=(jl,), coarse_inv=None), \
        th.Hierarchy(levels=(tl,), coarse_inv=None), pad


def test_coarsest_krylov_program_indefinite():
    """The KRYLOV coarsest solve as a program (CG while loop, then an if
    on each column's status around the GMRES while loop), one vector and
    a (4, pad) batch whose fourth column breaks CG down: x to 1e-8 against
    amg_tpu's lax.cond (one vector, vmapped); the batch equals its
    columns; GMRES ran on the failed column only."""
    d, jmg, tmg, pad = _indefinite_levels()
    n = 20
    jp = jamg.AMGParams(coarsest_solver=jamg.CoarsestSolver.KRYLOV,
                        verbose=0)
    B = np.zeros((4, pad))
    B[:3, :n] = np.random.default_rng(3).standard_normal((3, n)) @ d.T
    B[3, [0, 10]] = 1.0
    te = tmg.levels[0].a

    def solve(b):
        like = torch.from_numpy(b)
        ks = tk.CoarsestKrylov(te, like, 1e-10, 400)
        ks.b.copy_(like)
        run_loops(ks.program)
        return ks.x.numpy().copy(), ks.gm_its.numpy().copy()

    x3, its3 = solve(B[3])
    assert its3[0] > 0
    xj = np.asarray(jcycle.coarsest_solve(jmg, jnp.asarray(B[3]), jp,
                                          ctol=1e-10))
    assert _rel(x3, xj) < 1e-8
    xb, itsb = solve(B)
    assert list(itsb[:3]) == [-1, -1, -1] and itsb[3] == its3[0]
    jb = np.asarray(jax.vmap(lambda v: jcycle.coarsest_solve(
        jmg, v, jp, ctol=1e-10))(jnp.asarray(B)))
    for c in range(4):
        assert _rel(xb[c], solve(B[c])[0]) < 1e-8
        assert _rel(xb[c], jb[c]) < 1e-8


def test_coarsest_solve_route_on_the_cpu():
    """``cycle.coarsest_solve`` on CPU tensors runs the host loops of the
    hierarchy's cached CoarsestKrylov (one per right-hand side shape),
    which holds no graph; the Krylov counters add the work on the CPU."""
    from amg_tpu_torch.solve import cycle as tcycle

    _, _, tmg, pad = _indefinite_levels()
    tp = tamg.AMGParams(coarsest_solver=tamg.CoarsestSolver.KRYLOV,
                        verbose=0)
    b = torch.zeros(pad, dtype=torch.float64)
    b[[0, 10]] = 1.0
    before = dict(tk.counts)
    tcycle.coarsest_solve(tmg, b, tp, ctol=1e-10)
    tcycle.coarsest_solve(tmg, b.expand(2, pad).contiguous(), tp,
                          ctol=1e-10)
    assert len(tmg.krylov) == 2
    assert all(ks.graph is None for ks in tmg.krylov.values())
    after = dict(tk.counts)
    assert after["cg_solves"] - before["cg_solves"] == 3
    assert after["cg_failed"] - before["cg_failed"] == 3
    assert after["gmres_solves"] - before["gmres_solves"] == 3
    assert after["syncs"] > before["syncs"]


def test_coarsest_cache_keeps_one_solve_per_ndim():
    """The hierarchy caches one KRYLOV coarsest solve per number of
    dimensions of the right-hand side: a second batch width replaces the
    first, the one-vector solve stays, and each still solves as
    amg_tpu's coarsest solve does (x to 1e-8)."""
    from amg_tpu_torch.solve import cycle as tcycle

    d, jmg, tmg, pad = _indefinite_levels()
    tp = tamg.AMGParams(coarsest_solver=tamg.CoarsestSolver.KRYLOV,
                        verbose=0)
    jp = jamg.AMGParams(coarsest_solver=jamg.CoarsestSolver.KRYLOV,
                        verbose=0)
    rng = np.random.default_rng(12)
    one = tcycle.krylov_solver(tmg, torch.zeros(pad, dtype=torch.float64),
                               1e-10)
    for k in (3, 2):
        bn = np.zeros((k, pad))
        bn[:, :20] = rng.standard_normal((k, 20))
        x = tcycle.coarsest_solve(tmg, torch.from_numpy(bn), tp, ctol=1e-10)
        xj = np.asarray(jax.vmap(lambda v: jcycle.coarsest_solve(
            jmg, v, jp, 1e-10))(jnp.asarray(bn)))
        np.testing.assert_allclose(x.numpy(), xj, rtol=0,
                                   atol=1e-8 * np.abs(xj).max())
        batch = [key for key in tmg.krylov if len(key[0]) == 2]
        assert batch == [((k, pad), torch.float64, torch.device("cpu"),
                          1e-10)]
    assert len(tmg.krylov) == 2
    assert tcycle.krylov_solver(tmg, torch.zeros(pad, dtype=torch.float64),
                                1e-10) is one


def test_coarsest_solve_is_freed_without_the_collector():
    """A KRYLOV coarsest solve that the hierarchy's cache drops is freed
    at once, by reference counting: its program holds no reference back
    to it, so on the card its CUDA graphs are never destroyed by the
    cyclic collector in the middle of another graph's capture."""
    import gc
    import weakref

    from amg_tpu_torch.solve import cycle as tcycle

    _, _, tmg, pad = _indefinite_levels()
    tp = tamg.AMGParams(coarsest_solver=tamg.CoarsestSolver.KRYLOV,
                        verbose=0)
    enabled = gc.isenabled()
    gc.disable()
    try:
        for k in (3, 2):
            b = torch.zeros((k, pad), dtype=torch.float64)
            b[:, 0] = 1.0
            tcycle.coarsest_solve(tmg, b, tp, ctol=1e-10)
            if k == 3:
                old = weakref.ref(next(ks for key, ks in tmg.krylov.items()
                                       if len(key[0]) == 2))
        assert old() is None
    finally:
        if enabled:
            gc.enable()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_givens_backsub_plain_against_numpy(dtype):
    """The plain Givens step, with its step index ``j`` a 0-d int32 tensor
    it reads and advances on the device, and the back-substitution
    against a numpy transcription of amg_tpu's loops
    (amg_tpu/solve/krylov.py:336-379) in the same dtype, on a seeded (m +
    1) x m Hessenberg matrix fed column by column (the Gram-Schmidt
    coefficients and the norm apart, as an Arnoldi step gives them):
    rotations, g, H and the stored raw columns equal (each numpy scalar
    operation rounds once, as each torch one does; numpy's dot in the
    back-substitution sums in another order: y to 64 eps of max|y|); j
    advances, ``go`` is ``j < m and not done``; a step after ``done``
    changes nothing but recomputes ``done``; no host read."""
    m, tol = 8, 1e-3
    nd = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(7)
    hess = np.triu(rng.standard_normal((m + 1, m)), -1).astype(nd)
    normr0 = nd(2.5)
    H = torch.zeros((m + 1, m), dtype=dtype)
    hraw = torch.zeros((m, m + 1), dtype=dtype)
    cs, sn = torch.zeros(m, dtype=dtype), torch.zeros(m, dtype=dtype)
    g = torch.zeros(m + 1, dtype=dtype)
    g[0] = float(normr0)
    done, go = torch.zeros((), dtype=torch.bool), torch.ones((),
                                                             dtype=torch.bool)
    k_eff, j_dev = (torch.zeros((), dtype=torch.int32) for _ in range(2))
    Hn, csn, snn, gn = (np.zeros((m + 1, m), nd), np.zeros(m, nd),
                        np.zeros(m, nd), np.zeros(m + 1, nd))
    gn[0], tiny, done_n, k_n = normr0, nd(1e-20), False, 0
    for j in range(m):
        col = np.zeros(m + 1, nd)
        col[: j + 2] = hess[: j + 2, j]
        hcol = col.copy()
        hcol[j + 1] = 0
        with no_host_reads():
            krylov_small.givens_plain(
                torch.from_numpy(hcol), torch.tensor(col[j + 1]), j_dev,
                hraw, H, cs, sn, g, done, k_eff, go, torch.tensor(normr0),
                tol)
        h = col.copy()
        for i in range(j):
            h[i], h[i + 1] = (csn[i] * h[i] + snn[i] * h[i + 1],
                              -snn[i] * h[i] + csn[i] * h[i + 1])
        den = np.sqrt(h[j] * h[j] + h[j + 1] * h[j + 1])
        c = h[j] / den if den > tiny else nd(1)
        s = h[j + 1] / den if den > tiny else nd(0)
        h[j] = c * h[j] + s * h[j + 1]
        h[j + 1] = 0
        gj1, gj = -s * gn[j], c * gn[j]
        if not done_n:
            csn[j], snn[j], Hn[:, j], gn[j], gn[j + 1] = c, s, h, gj, gj1
            k_n = j + 1
        done_n = done_n or abs(gj1) / normr0 < tol or col[j + 1] <= tiny
        assert bool(done) == done_n and int(k_eff) == k_n
        assert int(j_dev) == j + 1 and bool(go) == (j + 1 < m and
                                                    not done_n)
        np.testing.assert_array_equal(hraw[j].numpy(), col)
    assert 0 < k_n < m     # the stop fell inside the restart
    for t, ref in ((H, Hn), (cs, csn), (sn, snn), (g, gn)):
        np.testing.assert_array_equal(t.numpy(), ref)
    y = np.zeros(m, nd)
    for jj in range(m - 1, -1, -1):
        y[jj] = ((gn[jj] - np.dot(Hn[jj], y)) / Hn[jj, jj]
                 if jj < k_n and abs(Hn[jj, jj]) > tiny else 0)
    with no_host_reads():
        yt = krylov_small.backsub_plain(H, g, k_eff)
    np.testing.assert_allclose(yt, y, rtol=0,
                               atol=64 * np.finfo(nd).eps * np.abs(y).max())


def test_run_plain_nodes_and_host_reads():
    """The plain version of the graph's nodes: a while loop counting to 3
    (4 reads of its flag), an if on a cleared flag (skipped, 1 read) and
    on a set one, and copies; each flag test is one counted host read."""
    n = torch.zeros((), dtype=torch.int64)
    go = torch.ones((), dtype=torch.bool)
    off = torch.zeros((), dtype=torch.bool)
    on = torch.ones((), dtype=torch.bool)
    src, dst = torch.arange(3.0), torch.zeros(3)
    ran = []

    def step():
        n.add_(1)
        go.copy_(n < 3)

    prog = (While(go, (step,)), If(off, (lambda: ran.append("off"),)),
            If(on, (Copy(dst, src),
                                  lambda: ran.append("on"))))
    before = tk.counts["syncs"]
    run_plain(prog, tk._read)
    assert int(n) == 3 and ran == ["on"] and torch.equal(dst, src)
    assert tk.counts["syncs"] - before == 4 + 1 + 1


def test_counts_are_device_counters():
    """``krylov.counts``: the work counters live on each device the loops
    ran on and are read as host integers; setting a key to 0 clears it
    everywhere; ``syncs`` stays a host integer."""
    tk.counts["cg_iters"] = 0
    je, te, b = _p2d_rhs(8, 1)
    _, _, it, _ = _cg_loop(te, b, tol=1e-10, maxit=200)
    assert isinstance(tk.counts["cg_iters"], int)
    assert tk.counts["cg_iters"] == int(it) > 0
    assert tk.counts.work("cpu").dtype == torch.int64
    tk.counts["cg_iters"] = 0
    assert tk.counts["cg_iters"] == 0
    assert set(tk.counts) == {"syncs", *tk.counts.WORK}
