"""Worker of the port's multi-process runs: the CPU tests
(tests/test_torch_spmd.py, tests/test_torch_spmd_general.py,
tests/test_torch_gspmd.py, tests/test_torch_step_graph.py) and the check
on four cards.

    python tests/_torch_mh_worker.py PORT RANK NPROC SHARDS OUT [KIND]
    python tests/_torch_mh_worker.py PORT all NPROC SHARDS OUT [KINDS] \\
        --device cuda

On the CPU (the default) the process is one of NPROC gloo processes, each
holding its run of the ring's SHARDS shards.  It solves :func:`problem`
``KIND`` (default ``poisson3d``) with ``SpmdAMGSolver`` or, for ``dist``,
``DistAMGSolver``, on the solver's route and again on its eager steps
(``eager=True``), and writes the fetched solutions, iterations, residual
histories and the route to ``OUT.<rank>.npz``; for the Krylov kinds
``cg``, ``gmres`` and ``fcg`` it runs ``krylov.<kind>`` and
``krylov.<kind>_plain`` with the mesh's ``psum`` instead
(``chip_smoke.ring_krylov``).

With ``--device cuda`` the process is one of NPROC NCCL processes, one
card each (``cuda:RANK``), and ``KINDS`` a comma list of
``poisson3d,fem2d,dist,cg,gmres,fcg`` (the default: all) at
chip_smoke.py's sizes: poisson3d(100) in phase 18's embedded SPMD mode,
fem2d(1,000,000) in phase 19's general mode on "auto", poisson3d(100)
with phase 20's ``DistAMGSolver``, and ``krylov.cg``, ``gmres`` and
``fcg`` with the ``psum`` of the group (one CUDA graph each, the group's
``all_reduce`` and halo messages inside its while bodies) on
poisson3d(100)'s ring product (B1's window entry and the halo messages)
against their host loops (``*_plain``).
Rank 0 first solves each kind on SHARDS shards of its card alone (no
group), the reference.  Per solver kind each rank checks its route
("graph") and the graph route against its eager steps bit for bit
(iterations, histories, x); per Krylov kind each rank checks the graph
route with no host read against its host loop bit for bit (status,
iterations, x).  Rank 0 checks iterations within 1 of the reference and
a host f64 true relative residual below 1e-8, logs each step graph
(nodes, build seconds, pool MiB, p2p messages and bytes per replay),
each Krylov graph (nodes, build seconds, event nodes removed) and the
seconds of both routes (the graph's cold and warm call, each building
its graph), and writes every number to ``OUT.json``.  RANK
``all`` starts ranks 0 to NPROC - 1 of the same command, each logging
to ``OUT.rank<r>.log``, stops them all when one fails, and prints rank
0's log.  Exit status 0 when every check passed.
"""

import functools
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KRYLOV_KINDS = ("cg", "gmres", "fcg")
CUDA_KINDS = ("poisson3d", "fem2d", "dist") + KRYLOV_KINDS


def problem(kind="poisson3d"):
    """``(a, b, pars)`` of a test solve: ``poisson3d``, FCG in f64 on
    poisson3d(12) (the embedded mode); ``fem2d``, bench_dist.py's fem2d
    parameters on fem2d(6000, seed=11) (the general mode: f32 cycles, FCG
    in f64 against the df64 operator), ``dense_level_bytes`` lowered so
    that the small problem keeps WEll levels; ``dist``, the GSPMD solver's
    GS cycles in f64 on poisson2d(24) with ``coarse_replicate_nnz`` low
    enough that levels 0-1 shard (Ell P and R: all-gather products);
    the Krylov kinds, poisson3d(16) and a seeded b = A x (``pars``
    None)."""
    import amg_tpu_torch as amg

    if kind == "dist":
        a = amg.poisson2d(24)
        pars = amg.AMGParams(verbose=0, coarse_replicate_nnz=200)
        seed = 19
    elif kind == "fem2d":
        a = amg.fem2d(6000, seed=11)
        pars = amg.AMGParams(
            verbose=0, tol=1e-8, dtype="float32", refine=True, accel="cg",
            coarse_smoother=amg.SmootherType.CHEBYSHEV,
            coarse_op_dtype="float32", use_well="on", well_min_rows=1024,
            dense_level_bytes=1 << 20)
        seed = 17
    elif kind in KRYLOV_KINDS:
        a = amg.poisson3d(16)
        b = a.matvec(np.random.default_rng(23).standard_normal(a.n_rows))
        return a, b, None
    else:
        a = amg.poisson3d(12)
        pars = amg.AMGParams(verbose=0, tol=1e-10, accel="cg",
                             coarse_smoother=amg.SmootherType.CHEBYSHEV)
        seed = 43
    b = np.random.default_rng(seed).standard_normal(a.n_rows)
    return a, b, pars


@functools.cache
def problem_full(kind):
    """``(a, b, pars)`` of a kind at chip_smoke.py's size (b = ones, as
    phases 18-20 solve; the Krylov kinds: a seeded b = A x, ``pars``
    None)."""
    import amg_tpu_torch as amg
    import chip_smoke as cs

    if kind == "fem2d":
        a = amg.fem2d(cs.FEM_ROWS, seed=0)
        return a, np.ones(a.n_rows), cs.general_pars(amg).replace(
            use_banded="auto")
    a = amg.poisson3d(cs.N_SIDE)
    if kind in KRYLOV_KINDS:
        return a, a.matvec(np.random.default_rng(23).standard_normal(
            a.n_rows)), None
    pars = cs.gspmd_pars(amg) if kind == "dist" else cs.spmd_pars(amg)
    return a, np.ones(a.n_rows), pars


def solver_class(kind):
    from amg_tpu_torch.parallel import DistAMGSolver, SpmdAMGSolver

    return DistAMGSolver if kind == "dist" else SpmdAMGSolver


def run_cpu(kind, shards, out, rank):
    from amg_tpu_torch.parallel import make_mesh

    from chip_smoke import ring_krylov

    a, b, pars = problem(kind)
    mesh = make_mesh(shards, device="cpu")
    if kind in KRYLOV_KINDS:
        g, p = (ring_krylov(kind, a, b, mesh, plain) for plain in (0, 1))
        np.savez(f"{out}.{rank}.npz", x=g["x"], status=g["status"],
                 its=g["its"], x_plain=p["x"], status_plain=p["status"],
                 its_plain=p["its"], backend=mesh.backend)
        return
    s = solver_class(kind)(a, pars, mesh=mesh, log=lambda *x: None)
    x, info = s.solve(b)
    xe, ie = s.solve(b, eager=True)
    np.savez(f"{out}.{rank}.npz", x=x, nits=info.nits, rres=info.rres,
             residuals=info.residuals, route=s.steps.route, x_eager=xe,
             nits_eager=ie.nits, residuals_eager=ie.residuals)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------


def _log(msg):
    print(msg, flush=True)


def _true_rres(a, b, x):
    return float(np.linalg.norm(b - a.matvec(x.astype(np.float64)))
                 / np.linalg.norm(b))


def reference(kind, shards):
    """Rank 0's solve of ``kind`` on ``shards`` shards of its card, no
    process group: ``(x, iterations)``."""
    from amg_tpu_torch.parallel import make_mesh

    a, b, pars = problem_full(kind)
    mesh = make_mesh(shards, device="cuda")
    t0 = time.perf_counter()
    if kind in KRYLOV_KINDS:
        import chip_smoke as cs

        r = cs.ring_krylov(kind, a, b, mesh)
        x, its = r["x"], r["its"]
    else:
        s = solver_class(kind)(a, pars, mesh=mesh, log=lambda *_: None)
        x, info = s.solve(b)
        its = info.nits
        del s
    torch.cuda.synchronize()
    _log(f"[mh4 ref {kind}] {mesh.describe()}: {its} its in "
         f"{time.perf_counter() - t0:.1f} s with setup, true rres "
         f"{_true_rres(a, b, x):.3e}")
    return x, its


def run_cuda_kind(kind, shards, ref):
    """One kind in the NCCL group: the checks and numbers of the module's
    docstring for this rank (rank 0's with the reference's)."""
    import chip_smoke as cs
    from amg_tpu_torch.ops import launch_counts
    from amg_tpu_torch.parallel import halo, make_mesh

    rank = torch.distributed.get_rank()
    a, b, pars = problem_full(kind)
    mesh = make_mesh(shards, device="cuda")
    res = dict(kind=kind, mesh=mesh.describe())
    if kind in KRYLOV_KINDS:
        g, warm = (cs.ring_krylov(kind, a, b, mesh) for _ in range(2))
        p = cs.ring_krylov(kind, a, b, mesh, plain=True)
        x, its = g["x"], g["its"]
        same = (g["status"], its) == (p["status"], p["its"]) and \
            np.array_equal(x, p["x"]) and np.array_equal(x, warm["x"])
        res.update(route=g["route"], status=g["status"], its=its,
                   host_reads=g["reads"], plain_host_reads=p["reads"],
                   graph=g["graph"], graph_s=g["s"], warm_s=warm["s"],
                   warm_build_s=warm["graph"]["build_s"], plain_s=p["s"],
                   equals_plain=same, true_rres=_true_rres(a, b, x))
        cs.check(g["route"] == "graph" and g["reads"] == warm["reads"] == 0,
                 f"{kind}: route {g['route']}, {g['reads']} host reads")
        cs.check(same, f"{kind}: {kind} ({g['status']}, {its}) and "
                       f"{kind}_plain ({p['status']}, {p['its']}) differ")
    else:
        h = launch_counts.COUNTERS.index(halo.counts)
        t0 = time.perf_counter()
        s = solver_class(kind)(a, pars, mesh=mesh, log=lambda *_: None)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        x, info = s.solve(b)
        torch.cuda.synchronize()
        its = info.nits
        steps = cs._graph_vs_eager(f"mh4 {kind} r{rank}", s, s.solve, b,
                                   (x, info))
        for name, g in s.steps.graphs.items():
            ring = g.per_step.get(h, ({},))[0]
            steps["graphs"][name].update(p2p=ring.get("p2p", 0),
                                         p2p_bytes=ring.get("p2p_bytes", 0))
        res.update(route=s.steps.route, its=its, rres=info.rres,
                   setup_s=setup_s, cold_s=info.solve_seconds,
                   true_rres=_true_rres(a, b, x), **steps)
        del s
    if ref is not None:
        gap = float(np.linalg.norm(x - ref[0]) / np.linalg.norm(ref[0]))
        res.update(ref_its=ref[1], gap_to_ref=gap)
        cs.check(abs(its - ref[1]) <= 1,
                 f"{kind}: {its} its against {ref[1]} in one process")
        cs.check(res["true_rres"] < 1e-8,
                 f"{kind}: true rres {res['true_rres']:.3e}")
    return res


def run_cuda(port, rank, nproc, shards, out, kinds):
    from amg_tpu_torch.ops import launch_counts
    from amg_tpu_torch.parallel import initialize

    for m in launch_counts.MODULES:
        m.build()
    refs = {}
    for k in kinds:
        if rank == 0:
            refs[k] = reference(k, shards)
        else:
            problem_full(k)
    assert initialize(f"localhost:{port}", nproc, rank, device="cuda",
                      timeout_s=300.0)
    dist = torch.distributed
    try:
        results = []
        for kind in kinds:
            res = run_cuda_kind(kind, shards, refs.get(kind))
            every = [None] * nproc
            dist.all_gather_object(every, res)
            results.append(every)
            if rank == 0:
                _log(f"[mh4 {kind}] " + json.dumps(every[0], default=str))
                routes = [r.get("route", "graph") for r in every]
                _log(f"[mh4 {kind}] routes {routes}; graph = "
                     f"{'plain' if kind in KRYLOV_KINDS else 'eager'} on "
                     f"every rank")
        if rank == 0:
            with open(f"{out}.json", "w") as f:
                json.dump(results, f, indent=1, default=str)
    finally:
        dist.destroy_process_group()


def spawn(argv, nproc, out):
    """Ranks 0 to ``nproc - 1`` of this command (``argv`` with RANK
    ``all``), each logging to ``OUT.rank<r>.log``; when one fails the
    others are stopped.  Prints rank 0's log; returns the exit status."""
    import subprocess

    i = argv.index("all")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests"), os.environ.get("PYTHONPATH", "")]))
    procs = []
    for r in range(nproc):
        with open(f"{out}.rank{r}.log", "w") as f:
            cmd = [sys.executable, os.path.abspath(__file__), *argv[:i],
                   str(r), *argv[i + 1:]]
            procs.append(subprocess.Popen(cmd, stdout=f,
                                          stderr=subprocess.STDOUT, env=env))
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    with open(f"{out}.rank0.log") as f:
        print(f.read(), flush=True)
    bad = {r: p.returncode for r, p in enumerate(procs) if p.returncode}
    if bad:
        print(f"ranks failed (exit status): {bad}; see {out}.rank<r>.log",
              flush=True)
    return 1 if bad else 0


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for name in ("port", "rank", "nproc", "shards", "out"):
        p.add_argument(name)
    p.add_argument("kind", nargs="?")
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    args = p.parse_args()
    if args.device == "cuda":
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.rank == "all":
        sys.exit(spawn(sys.argv[1:], int(args.nproc), args.out))
    rank, nproc, shards = int(args.rank), int(args.nproc), int(args.shards)
    if args.device == "cuda":
        sys.path.insert(0, REPO)
        kinds = args.kind.split(",") if args.kind else list(CUDA_KINDS)
        run_cuda(args.port, rank, nproc, shards, args.out, kinds)
        return
    torch.set_num_threads(1)
    from amg_tpu_torch.parallel import initialize, is_multiprocess

    assert initialize(f"localhost:{args.port}", nproc, rank, device="cpu")
    assert is_multiprocess()
    try:
        run_cpu(args.kind or "poisson3d", shards, args.out, rank)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
