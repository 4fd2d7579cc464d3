"""The step graphs of the port's host loops, on the CPU.

``amg_tpu`` compiles each step of a host loop into one ``jax.jit`` program;
the port runs it as a ``solve.loop_graph.StepGraph`` on static buffers: on
the card a CUDA graph captured once and replayed (tests/test_torch_gpu.py,
chip_smoke.py), on the CPU the same buffers with the step run eagerly.
These tests hold, for every entry that runs one (``AMGSolver.solve``,
``solve_refined``, ``solve_pcg`` with FCG's step, refresh and true norm,
``solve_batched``, ``SpmdAMGSolver`` in its embedded and general modes,
``DistAMGSolver.solve``/``solve_refined``):

* a step reads nothing from the host: every step body runs with
  ``torch.Tensor.__bool__``, ``item``, ``cpu``, ``tolist``, ``numpy``,
  ``__int__`` and ``__float__`` patched to raise (and so does the CG loop
  of ``krylov.cg`` with a one-process mesh's ``psum``, which is graphed on
  the card, as it is with an NCCL group's);
* the static-buffer route equals the eager route (``eager=True``: the
  steps on fresh tensors) bit for bit: iterations, residual histories and
  x, also where the stop falls inside a batch of 4 pending iterates and
  under ``MOD_REL_RES``;
* a solver makes each step graph once across solves and anew when its
  key (``pars``, the arguments' shapes) changes;
* the route follows the mesh's device and its group's backend: the card
  alone or in an NCCL group "graph", the CPU "static", gloo on the card
  "eager"; 2 gloo processes take the static route and equal their eager
  steps bit for bit, and ``krylov.cg`` with their ``psum`` (its host
  loop) equals ``cg_plain``.

Parity with ``amg_tpu`` is held by the other port tests, which run
through the same route.
"""

import contextlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import amg_tpu_torch as tamg
from amg_tpu_torch.parallel import DistAMGSolver, SpmdAMGSolver, make_mesh
from amg_tpu_torch.parallel.dist import Mesh
from amg_tpu_torch.solve import krylov
from amg_tpu_torch.solve.loop_graph import StepGraph, StepGraphs, run_plain
from amg_tpu_torch.sparse import RowSlices

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log=lambda *a, **k: None)
HOST_READS = ("__bool__", "item", "cpu", "tolist", "numpy", "__int__",
              "__float__")


ORIG = {n: getattr(torch.Tensor, n) for n in HOST_READS}


def _boom(*_, **__):
    raise AssertionError("a step read the host")


@contextlib.contextmanager
def host_reads(allowed: bool):
    """Within: torch's host reads raise (``allowed`` False) or work as
    they do (``allowed``), whatever they did outside."""
    saved = {n: getattr(torch.Tensor, n) for n in HOST_READS}
    for n in HOST_READS:
        setattr(torch.Tensor, n, ORIG[n] if allowed else _boom)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)


@pytest.fixture
def guarded_steps(monkeypatch):
    """Every step body of a StepGraph runs with host reads patched to
    raise, but for the WEll layout's entry walk of the B2/B3 plain
    versions (``RowSlices.entries``: slice bounds read on the host), which
    stand in on the CPU for the kernels that run on the card; yields the
    StepGraphs that ran, one entry per step."""
    ran = []
    apply = StepGraph._apply
    entries = RowSlices.entries

    def guarded(self, fn, args, results):
        with host_reads(False):
            out = apply(self, fn, args, results)
        ran.append(self)
        return out

    def plain_entries(self, *a, **k):
        with host_reads(True):
            return entries(self, *a, **k)

    monkeypatch.setattr(StepGraph, "_apply", guarded)
    monkeypatch.setattr(RowSlices, "entries", plain_entries)
    return ran


def _names(steps: StepGraphs, ran) -> dict:
    """Steps run per step name of ``steps``."""
    by_graph = {id(g): name for name, g in steps.graphs.items()}
    out: dict = {}
    for g in ran:
        if id(g) in by_graph:
            out[by_graph[id(g)]] = out.get(by_graph[id(g)], 0) + 1
    return out


def _same(a, b):
    """Equal iterations, residual histories and x, bit for bit."""
    (xa, ia), (xb, ib) = a, b
    assert ia.nits == ib.nits
    assert ia.residuals == ib.residuals
    assert ia.ares == ib.ares and ia.rres == ib.rres
    assert xa.dtype == xb.dtype
    np.testing.assert_array_equal(xa, xb)


def _single(kind, device="cpu"):
    """(solver, solve, b, the step names it runs) of a single-device case
    at test size on ``device`` (tests/test_torch_gpu.py: the card)."""
    rng = np.random.default_rng(7)
    if kind in ("solve", "mod_rel"):
        # converges at cycle 7: inside the second batch of 4 pending
        a = tamg.poisson2d(16)
        st = (tamg.StopType.MOD_REL_RES if kind == "mod_rel"
              else tamg.StopType.REL_RES)
        pars = tamg.AMGParams(verbose=0, stop_type=st)
        names = {"cycle"}
    elif kind == "refined":
        a = tamg.poisson3d(12)
        pars = tamg.AMGParams(verbose=0, dtype="float32", refine=True,
                              refine_inner_cycles=2, tol=1e-9)
        names = {"refine"}
    elif kind in ("refined_dense", "refined_dense_gs"):
        # the structured cell's parameters at test size: bf16 Dense levels
        # 2 (512 rows, not the coarsest) and 3, their products through the
        # Dense kernel's module; Chebyshev on them, or GS class ranges
        a = tamg.poisson3d(16)
        cs = (tamg.SmootherType.GS if kind == "refined_dense_gs"
              else tamg.SmootherType.CHEBYSHEV)
        pars = tamg.AMGParams(verbose=0, dtype="float32", refine=True,
                              tol=1e-8, coarse_smoother=cs,
                              coarse_op_dtype="bfloat16", embed_levels=0,
                              dense_level_bytes=4e6)
        names = {"refine"}
    elif kind == "pcg":
        # Jacobi everywhere: more than 10 FCG iterations, so the residual
        # replacement of iteration 10 runs
        a = tamg.poisson3d(12)
        pars = tamg.AMGParams(verbose=0, accel="cg", dtype="float32",
                              refine=True, tol=1e-11,
                              smoother=tamg.SmootherType.JACOBI,
                              coarse_smoother=tamg.SmootherType.JACOBI)
        names = {"fcg", "fcg_refresh", "fcg_true"}
    else:   # batched
        a = tamg.poisson3d(12)
        pars = tamg.AMGParams(verbose=0, dtype="float32", tol=1e-6)
        names = {"batched"}
    solver = tamg.AMGSolver(a, pars, device=device, **QUIET)
    if kind == "batched":
        b = rng.standard_normal((a.n_rows, 3))
        return solver, solver.solve_batched, b, names
    return solver, solver.solve, rng.standard_normal(a.n_rows), names


@pytest.mark.parametrize("kind", ["solve", "mod_rel", "refined", "pcg",
                                  "batched", "refined_dense",
                                  "refined_dense_gs"])
def test_single_device_steps(kind, guarded_steps):
    """Each step of the single-device entries runs on the static buffers
    without a host read, and the route equals the eager one bit for bit;
    ``solve`` stops inside a batch of 4 pending iterates (with REL_RES and
    with MOD_REL_RES, whose ||x|| the host loop takes from each kept
    copy)."""
    solver, solve, b, names = _single(kind)
    assert solver.steps.route == "static"
    got = solve(b)
    ran = _names(solver.steps, guarded_steps)
    assert set(ran) == names and set(solver.steps.graphs) == names
    assert ran[min(names)] >= 1
    _same(got, solve(b, eager=True))
    if kind in ("solve", "mod_rel"):
        # steps run ahead in batches of 4: the stop falls inside one
        assert got[1].nits % 4 != 0
        assert ran["cycle"] == -(-got[1].nits // 4) * 4
    if kind == "pcg":
        assert got[1].nits > 10
    if kind == "batched":
        assert got[1].nits == ran["batched"]


def _ring(kind, device="cpu"):
    """(solver, b, its step names) of a ring case on 4 shards in one
    process on ``device``: the embedded SPMD mode with FCG, the general
    SPMD mode (WEll levels, FCG in f64 against the df64 operator) and its
    cycle, the GSPMD solver's cycle and its defect correction."""
    mesh = make_mesh(4, device=device)
    if kind == "embedded":
        a = tamg.poisson3d(12)
        pars = tamg.AMGParams(verbose=0, tol=1e-10, accel="cg",
                              coarse_smoother=tamg.SmootherType.CHEBYSHEV)
        cls, names = SpmdAMGSolver, {"fcg", "fcg_true"}
    elif kind in ("general", "general_cycle"):
        a = tamg.fem2d(6000, seed=11)
        pars = tamg.AMGParams(
            verbose=0, tol=1e-8, dtype="float32", refine=True, accel="cg",
            coarse_smoother=tamg.SmootherType.CHEBYSHEV,
            coarse_op_dtype="float32", use_well="on", well_min_rows=1024,
            dense_level_bytes=1 << 20)
        names = {"fcg", "fcg_true"}
        if kind == "general_cycle":
            # 4 cycles (GS on level 0's classes is slow on the CPU)
            pars = pars.replace(accel="none", refine=False, max_it=4)
            names = {"cycle"}
        cls = SpmdAMGSolver
    else:
        a = tamg.poisson2d(24)
        pars = tamg.AMGParams(verbose=0, coarse_replicate_nnz=200)
        names = {"cycle"}
        if kind == "gspmd_refined":
            pars = pars.replace(dtype="float32", refine=True, tol=1e-9)
            names = {"refine"}
        cls = DistAMGSolver
    solver = cls(a, pars, mesh=mesh, **QUIET)
    b = np.random.default_rng(43).standard_normal(a.n_rows)
    return solver, b, names


@pytest.mark.parametrize("kind", ["embedded", "general", "general_cycle",
                                  "gspmd", "gspmd_refined"])
def test_ring_steps_in_one_process(kind, guarded_steps):
    """The ring solvers on a mesh held by one process (psums are local
    sums, halos local slices): each step runs on the static buffers
    without a host read, equal to the eager route bit for bit."""
    solver, b, names = _ring(kind)
    assert solver.mesh.group is None and solver.steps.route == "static"
    if kind.startswith("general"):
        assert solver.E == 0 and solver.Es >= 1
    if kind.startswith("gspmd"):
        assert solver.Es >= 0
    got = solver.solve(b)
    ran = _names(solver.steps, guarded_steps)
    assert set(ran) == names
    assert np.isfinite(got[1].rres) and got[1].nits > 0
    _same(got, solver.solve(b, eager=True))


def test_step_graph_made_once_and_anew_for_a_new_key():
    """Two solves with different b reuse the solver's step graph (the
    second equal to the eager route bit for bit); new ``pars`` or a new
    batch width make it anew."""
    solver = tamg.AMGSolver(tamg.poisson2d(16), tamg.AMGParams(verbose=0),
                            device="cpu", **QUIET)
    rng = np.random.default_rng(11)
    b1, b2 = rng.standard_normal(256), rng.standard_normal(256)
    x1, _ = solver.solve(b1)
    g = solver.steps.graphs["cycle"]
    got = solver.solve(b2)
    assert solver.steps.graphs["cycle"] is g and solver.steps.builds == 1
    _same(got, solver.solve(b2, eager=True))
    assert not np.array_equal(got[0], x1)
    solver.pars = solver.pars.replace(max_it=30)
    solver.solve(b1)
    assert solver.steps.graphs["cycle"] is not g and solver.steps.builds == 2
    B = rng.standard_normal((256, 2))
    solver.solve_batched(B)
    gb = solver.steps.graphs["batched"]
    solver.solve_batched(B[:, ::-1])
    assert solver.steps.graphs["batched"] is gb and solver.steps.builds == 3
    solver.solve_batched(np.hstack([B, B[:, :1]]))
    assert solver.steps.graphs["batched"] is not gb
    assert solver.steps.builds == 4


def test_step_graph_buffers():
    """StepGraph.run: the state written back in place, results in their
    own buffers, copies handed back; an argument that is the state handed
    back, or given again, is not copied in again."""
    x = torch.zeros(4, dtype=torch.float64)
    b = torch.arange(4, dtype=torch.float64)
    g = StepGraph([torch.empty_like(x), torch.empty_like(b)], 1)
    copies = []
    copy_ = torch.Tensor.copy_

    def step(x, b):
        return x + b, (x + b).sum()

    def counting(t, src, *a, **k):
        copies.append(t)
        return copy_(t, src, *a, **k)

    torch.Tensor.copy_ = counting
    try:
        x1, s1 = g.run(step, x, b)       # copies in x and b, writes x, s
        n_first = len(copies)
        x2, s2 = g.run(step, x1, b)      # x1 and b are in the buffers
    finally:
        torch.Tensor.copy_ = copy_
    assert n_first == 4 and len(copies) == n_first + 2
    assert x1.tolist() == [0, 1, 2, 3] and float(s1) == 6.0
    assert x2.tolist() == [0, 2, 4, 6] and float(s2) == 12.0
    assert x1.data_ptr() != g.args[0].data_ptr()
    assert g.args[0].tolist() == [0, 2, 4, 6] and float(g.results[0]) == 12
    x3, _ = g.run(step, x, b)            # another x: copied in
    assert x3.tolist() == [0, 1, 2, 3]


def test_cg_with_a_one_process_psum():
    """``krylov.cg`` with ``psum``: the route table (``krylov._route``: one
    CUDA graph on the card with no psum, a mesh held by this process or
    an NCCL group; the host loop on the CPU, for gloo groups, other
    callables and the plain entries); the loop bodies read nothing from
    the host and equal ``cg_plain``'s result bit for bit
    (tests/test_dist.py:79-104's case, a row-sharded Ell on 8 shards)."""
    from amg_tpu_torch.parallel.dist import shard_matrix, shard_vector
    from amg_tpu_torch.parallel.spmd_cycle import gspmd_spmv

    mesh = make_mesh(8, device="cpu")
    card, cpu = torch.device("cuda"), torch.device("cpu")
    for psum in (None, mesh.psum):
        assert krylov._route(card, psum) == "graph"
        assert krylov._route(card, psum, graph=False) == "host"
        assert krylov._route(cpu, psum) == "host"
    for backend, route in (("nccl", "graph"), ("gloo", "host")):
        group = Mesh(8, card, group=object(), backend=backend)
        assert krylov._route(card, group.psum) == route
    assert krylov._route(card, lambda t: t.sum(0)) == "host"

    a = tamg.poisson2d(16)
    e = shard_matrix(tamg.Ell.from_csr(a), mesh, gspmd=True)
    bs = shard_vector(a.matvec(np.random.default_rng(5).standard_normal(256)),
                      mesh, pad_to=256)

    def amul(v):
        return gspmd_spmv(e, v, mesh)

    loop = krylov.CGLoop(amul, bs, 1e-10, 200, psum=mesh.psum)
    loop.b.copy_(bs)
    with host_reads(False):
        run_plain(loop.program, ORIG["__bool__"])
    want, conv = krylov.cg_plain(amul, bs, torch.zeros_like(bs), tol=1e-10,
                                 maxit=200, psum=mesh.psum)
    assert bool(conv) and int(loop.status) == 1
    assert torch.equal(loop.xout, want)
    got, _ = krylov.cg(amul, bs, torch.zeros_like(bs), tol=1e-10, maxit=200,
                       psum=mesh.psum)
    assert torch.equal(got, want)


# the route table: (device, the group's backend or None, route)
ROUTES = {"card": ("cuda", None, "graph"),
          "nccl": ("cuda", "nccl", "graph"),
          "cpu": ("cpu", "gloo", "static"),
          "gloo_card": ("cuda", "gloo", "eager")}


@pytest.mark.parametrize("row", list(ROUTES))
def test_process_group_meshes_keep_eager_steps(row):
    """The route is fixed at setup from the mesh's device and its group's
    backend (meshes built with a stand-in group): the card alone or in an
    NCCL group replays step graphs, the CPU (no group, or gloo) runs the
    static buffers, and only gloo on the card keeps the eager steps; the
    ``verbose`` mesh line names the backend and the route."""
    device, backend, route = ROUTES[row]
    group = None if backend is None else object()
    mesh = Mesh(4, torch.device(device), group=group, backend=backend)
    steps = StepGraphs(mesh.device, mesh.backend)
    assert steps.route == route
    assert mesh.describe() == f"mesh: 4 shards, 1 process, {device}" + (
        "" if backend is None else f" ({backend})")
    if route == "eager":
        assert steps.describe() == ("eager (a gloo group on the card: its "
                                    "collectives are not captured)")
    if route == "graph":
        assert steps.describe() == "one CUDA graph per step{}, replayed" \
            .format("" if backend is None else " in a nccl group")
    if device == "cpu":
        # the CPU row: with a gloo group and without one
        assert StepGraphs("cpu").route == "static"
        lines = []
        s = SpmdAMGSolver(tamg.poisson3d(8), tamg.AMGParams(verbose=1),
                          mesh=mesh, log=lines.append)
        assert s.steps.route == "static"
        assert any(ln.startswith("mesh: 4 shards, 1 process, cpu (gloo); ")
                   and ln.endswith("steps: static buffers, run eagerly")
                   for ln in lines)
        d = DistAMGSolver(tamg.poisson2d(24), tamg.AMGParams(
            verbose=0, coarse_replicate_nnz=200), mesh=mesh, **QUIET)
        assert d.steps.route == "static"
    with pytest.raises(ValueError, match="backend"):
        Mesh(4, torch.device(device), group=object())


def _workers(tmp_path, kind, nproc=2, shards=4, timeout=240):
    """Run tests/_torch_mh_worker.py's ``kind`` in ``nproc`` gloo processes
    of ``shards / nproc`` shards each (stopped after ``timeout`` seconds);
    their outputs, rank by rank."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = str(tmp_path / "x")
    env = dict(os.environ, PYTHONPATH=REPO)
    worker = os.path.join(REPO, "tests", "_torch_mh_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(port), str(r),
                               str(nproc), str(shards), out, kind], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(nproc)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [np.load(f"{out}.{r}.npz") for r in range(nproc)]


@pytest.mark.parametrize("kind", ["poisson3d", "fem2d", "dist"])
def test_two_gloo_processes_run_eager_steps(kind, tmp_path):
    """2 gloo processes of 2 shards each (tests/_torch_mh_worker.py: the
    embedded SPMD mode's FCG, the general mode's FCG, the GSPMD solver):
    their solvers take the static route, each equal to its own eager steps
    bit for bit (iterations, histories, x), and the solution equals the
    one-process solve's in the same iterations, within 1e-12 relative (the
    psums add the processes' partial sums in another order)."""
    from _torch_mh_worker import problem, solver_class

    got = _workers(tmp_path, kind)
    a, b, pars = problem(kind)
    x, info = solver_class(kind)(a, pars, mesh=make_mesh(4, device="cpu"),
                                 **QUIET).solve(b)
    for g in got:
        assert str(g["route"]) == "static"
        assert int(g["nits"]) == int(g["nits_eager"]) == info.nits
        np.testing.assert_array_equal(g["residuals"], g["residuals_eager"])
        np.testing.assert_array_equal(g["x"], g["x_eager"])
        np.testing.assert_allclose(g["x"], x, rtol=0,
                                   atol=1e-12 * np.abs(x).max())
    np.testing.assert_array_equal(got[0]["x"], got[1]["x"])


def test_cg_with_the_psum_of_two_gloo_processes(tmp_path):
    """``krylov.cg`` with the ``psum`` of 2 gloo processes (its host loop:
    gloo's collectives are not captured), on poisson3d(16)'s ring product
    (B1's window entry over halo messages between the processes): the
    status, iterations and x of ``cg_plain`` bit for bit, and the
    one-process ``cg``'s iterations and x within 1e-12 relative."""
    from chip_smoke import ring_krylov
    from _torch_mh_worker import problem

    got = _workers(tmp_path, "cg")
    a, b, _ = problem("cg")
    one = ring_krylov("cg", a, b, make_mesh(4, device="cpu"))
    x, status, its = one["x"], one["status"], one["its"]
    assert status == 1
    for g in got:
        assert str(g["backend"]) == "gloo"
        assert int(g["status"]) == int(g["status_plain"]) == status
        assert int(g["its"]) == int(g["its_plain"]) == its
        np.testing.assert_array_equal(g["x"], g["x_plain"])
        np.testing.assert_allclose(g["x"], x, rtol=0,
                                   atol=1e-12 * np.abs(x).max())


def test_capture_counts_cover_the_ring_counters():
    """The counts a capture takes back and a replay adds again
    (``launch_counts``) hold the ring's host counters too (products, halo
    bytes, psums), so a replayed ring step counts what an eager one does."""
    from amg_tpu_torch.ops import launch_counts
    from amg_tpu_torch.parallel import dist as tdist, halo

    assert halo.counts in launch_counts.COUNTERS
    assert tdist.counts in launch_counts.COUNTERS
    mesh = make_mesh(4, device="cpu")
    d = tamg.Dia.from_csr(tamg.poisson2d(16), dtype=torch.float64)
    x = torch.ones(4, 64, dtype=torch.float64)
    before = launch_counts.snapshot()
    mesh.psum(halo.dia_spmv_ring_local(d, x, mesh).sum(1))
    step = launch_counts.delta(before, launch_counts.snapshot())
    ring = {k: v for k, v in step.items() if k not in launch_counts.MODULES}
    assert sorted(p for (part,) in ring.values() for p in part) == [
        "halo_bytes", "products", "psum"]
    launch_counts.add(step, -1)          # a capture takes them back
    assert launch_counts.delta(before, launch_counts.snapshot()) == {
        k: tuple({} for _ in v) for k, v in step.items()}
    launch_counts.add(step, 3)           # three replays
    after = launch_counts.snapshot()
    assert after[launch_counts.COUNTERS.index(tdist.counts)][0]["psum"] \
        == before[launch_counts.COUNTERS.index(tdist.counts)][0]["psum"] + 3
    assert not launch_counts.empty(step) and launch_counts.empty(
        launch_counts.delta(after, after))
