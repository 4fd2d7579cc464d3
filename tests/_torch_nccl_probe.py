"""Which device loops of an NCCL group finish on several cards: a CUDA
graph while node whose body holds a captured collective or p2p exchange,
against the same step replayed by the host.

    python tests/_torch_nccl_probe.py PORT NPROC EXP OUT

starts NPROC NCCL processes, one card each (``cuda:RANK``), runs
experiment EXP in each and reports on rank 0.  Experiments:

* ``a``: a :class:`~amg_tpu_torch.solve.loop_graph.LoopGraph` whose while
  body holds one ``Mesh.psum`` (``all_reduce``) of a 0-d tensor, with a
  trip count of 10 read from a device counter;
* ``b``: the same with only the ring's halo exchange
  (``halo._remote_halos``: one ``batch_isend_irecv``) of 16 entries each
  way;
* ``ab``: both in one body (the pattern of ``krylov.cg``'s iteration);
* ``c``: (a)'s and (b)'s steps as ``StepGraph`` s replayed 10 times by
  the host.

A suffix picks how NCCL's event record and wait nodes of a captured
segment are treated inside a while body: ``+raw`` keeps them (the
LoopGraph of the port before it stripped them), ``+nomix`` keeps them and
starts NCCL with ``NCCL_GRAPH_MIXING_SUPPORT=0`` (NCCL adds none); no
suffix runs the LoopGraph as it is.  Each rank checks the loop's count
and sums against the host's arithmetic and logs the node kinds of every
captured segment (``krylov_small.graph_kinds``).  The ranks are stopped
after ``--deadline`` seconds (default 45): the experiment then counts as
hung.  ``OUT.json`` gets rank 0's numbers, each rank logs to
``OUT.rank<r>.log``; exit status 0 when every rank finished and every
check passed, 3 on the deadline.
"""

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIPS = 10


def _log(msg):
    print(msg, flush=True)


def _kinds(raw) -> dict:
    from amg_tpu_torch.ops import krylov_small

    return krylov_small.graph_kinds(raw)


def _loop(body, state, dev):
    """``body`` under a while node, TRIPS times (a device counter): the
    LoopGraph, its segments' node kinds before the strip and the
    seconds of its launch."""
    from amg_tpu_torch.solve.loop_graph import LoopGraph, While

    n = torch.zeros((), dtype=torch.int32, device=dev)
    go = torch.ones((), dtype=torch.bool, device=dev)

    def step():
        body()
        n.add_(1)
        go.copy_(n < TRIPS)

    g = LoopGraph((While(go, (step,)),), dev, restore=(*state, n, go))
    g.build()
    kinds = {s.__name__: _kinds(c.raw_cuda_graph())
             for s, c in g.captured.items()}
    t0 = time.perf_counter()
    g.launch()
    torch.cuda.synchronize()
    return g, kinds, time.perf_counter() - t0, int(n)


def experiment(exp, rank, world):
    from amg_tpu_torch.ops import krylov_small
    from amg_tpu_torch.parallel import halo, make_mesh
    from amg_tpu_torch.solve.loop_graph import StepGraph

    kind, _, how = exp.partition("+")
    if how in ("raw", "nomix"):
        krylov_small.strip_events = lambda raw: 0
    mesh = make_mesh(device="cuda")
    dev = mesh.device
    f64 = dict(dtype=torch.float64, device=dev)
    x = torch.full((1,), float(rank + 1), **f64)
    flat = torch.arange(1024, **f64) + 1024 * rank
    lo = hi = 16
    total = torch.zeros((), **f64)
    acc = torch.zeros((), **f64)
    # one trip's sums: every rank's rank + 1; the halo entries read
    want_total = world * (world + 1) / 2
    want_acc = 0.0
    if rank > 0:
        want_acc += sum(1024 * (rank - 1) + i for i in range(1024 - lo, 1024))
    if rank < world - 1:
        want_acc += sum(1024 * (rank + 1) + i for i in range(hi))

    def reduce_():
        total.add_(mesh.psum(x))

    def exchange():
        left, right = halo._remote_halos(flat, lo, hi, mesh)
        acc.add_(left.sum() + right.sum())

    res = dict(exp=exp, rank=rank, world=world)
    if kind == "c":
        a = StepGraph((total,), 1)
        b = StepGraph((acc,), 1)
        t0 = time.perf_counter()
        t, s = total, acc
        for _ in range(TRIPS):
            (t,) = a.run(lambda v: (v + mesh.psum(x),), t)
            (s,) = b.run(lambda v: (v + sum(
                w.sum() for w in halo._remote_halos(flat, lo, hi, mesh)),), s)
        torch.cuda.synchronize()
        res.update(seconds=time.perf_counter() - t0, trips=TRIPS,
                   kinds={"reduce": _kinds(a.graph.raw_cuda_graph()),
                          "exchange": _kinds(b.graph.raw_cuda_graph())})
        got_total, got_acc = float(t), float(s)
    else:
        body = {"a": (reduce_,), "b": (exchange,),
                "ab": (reduce_, exchange)}[kind]

        def step_body():
            for f in body:
                f()

        g, kinds, seconds, trips = _loop(step_body, (total, acc), dev)
        res.update(seconds=seconds, trips=trips, kinds=kinds,
                   nodes=g.nodes, events_removed=g.events)
        got_total, got_acc = float(total), float(acc)
    checks = {"trips": res["trips"] == TRIPS}
    if kind in ("a", "ab", "c"):
        checks["psum"] = got_total == TRIPS * want_total
    if kind in ("b", "ab", "c"):
        checks["halo"] = got_acc == TRIPS * want_acc
    res.update(total=got_total, acc=got_acc, checks=checks,
               ok=all(checks.values()))
    return res


def run_rank(port, rank, world, exp, out):
    from amg_tpu_torch.parallel import initialize

    assert initialize(f"localhost:{port}", world, rank, device="cuda",
                      timeout_s=60.0)
    dist = torch.distributed
    try:
        _log(f"[probe {exp} r{rank}] start")
        res = experiment(exp, rank, world)
        _log(f"[probe {exp} r{rank}] " + json.dumps(res))
        every = [None] * world
        dist.all_gather_object(every, res)
        if rank == 0:
            with open(f"{out}.json", "w") as f:
                json.dump(every, f, indent=1)
        if not all(r["ok"] for r in every):
            sys.exit(1)
    finally:
        dist.destroy_process_group()


def spawn(port, world, exp, out, deadline):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    if exp.endswith("+nomix"):
        env["NCCL_GRAPH_MIXING_SUPPORT"] = "0"
    procs = []
    t0 = time.perf_counter()
    for r in range(world):
        with open(f"{out}.rank{r}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), port, str(world),
                 exp, out, "--rank", str(r)], stdout=f,
                stderr=subprocess.STDOUT, env=env))
    hung = False
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t0 > deadline:
                hung = True
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    with open(f"{out}.rank0.log") as f:
        print(f.read(), flush=True)
    codes = [p.returncode for p in procs]
    verdict = ("hung" if hung else "finished" if not any(codes)
               else "failed")
    _log(f"[probe {exp}] {verdict} after {time.perf_counter() - t0:.1f} s; "
         f"exit status per rank {codes}")
    return 3 if hung else (1 if any(codes) else 0)


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("port")
    p.add_argument("nproc", type=int)
    p.add_argument("exp")
    p.add_argument("out")
    p.add_argument("--rank", type=int)
    p.add_argument("--deadline", type=float, default=45.0)
    args = p.parse_args()
    if args.rank is None:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        sys.exit(spawn(args.port, args.nproc, args.exp, args.out,
                       args.deadline))
    sys.path.insert(0, REPO)
    run_rank(args.port, args.rank, args.nproc, args.exp, args.out)


if __name__ == "__main__":
    main()
