"""Worker of tests/test_torch_ring_trace.py: one of NPROC gloo processes
holding its run of a ring of SHARDS shards on the CPU.

    python tests/_torch_ring_worker.py PORT RANK NPROC SHARDS OUT

It sets up ``SpmdAMGSolver`` for the 7-point Poisson operator of
:func:`problem` with the parameters of ``benchmark/configs/
p3d7_4x1m.json`` (FCG in f64 around f32 cycles on embedded levels, bf16
coarse operators), the coarsest level brought down with the grid, and
records the span table's ring rows (``amg.ring.*``) around:

- one level-0 ring product of a seeded probe on the cycle's f32 operator
  and on FCG's f64 one (``a0_hi``), with this process's rows of each;
- one eager cycle step, its counts taken back and added three times as a
  capture and three replays do (``ops.launch_counts``);
- a solve without a profiler and a solve under a CPU ``torch.profiler``.

Everything goes to ``OUT.<rank>.npz``.
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = (12, 12, 48)


def problem():
    """``(a, pars)``: poisson3d on :data:`GRID` with the configuration's
    parameters, ``coarse_stop_rows`` 200."""
    import amg_tpu_torch as amg
    from benchmark import port_api

    with open(os.path.join(REPO, "benchmark", "configs",
                           "p3d7_4x1m.json")) as f:
        spec = dict(json.load(f)["params"], coarse_stop_rows=200)
    return amg.poisson3d(*GRID), port_api.params(spec)


def ring_rows(table):
    """``[[n, bytes], ...]`` of the ring rows of a span table."""
    from amg_tpu_torch.tracing import COUNTERS

    return [[table[k]["n"], table[k]["bytes"]] for k in COUNTERS]


def run(shards, out, rank):
    from torch.profiler import ProfilerActivity, profile

    from amg_tpu_torch import tracing
    from amg_tpu_torch.ops import launch_counts
    from amg_tpu_torch.parallel import SpmdAMGSolver, make_mesh
    from amg_tpu_torch.parallel.spmd_cycle import _ring_spmv

    a, pars = problem()
    mesh = make_mesh(shards, device="cpu")
    s = SpmdAMGSolver(a, pars, mesh=mesh, log=lambda *_: None)
    shard_spans = tracing.totals()["amg.setup.shard"]["n"]
    rows = s.m_local * mesh.local
    res = dict(lo=rank * rows, hi=(rank + 1) * rows, shard_spans=shard_spans)

    probe = np.random.default_rng(5).uniform(-1, 1, a.n_rows)
    probe = probe.astype(np.float32).astype(np.float64)
    for name, op, dtype in (("f32", s.mg.levels[0].a, s.dtype),
                            ("f64", s.a0_hi, torch.float64)):
        xd = s._shard(probe, dtype)
        before = ring_rows(tracing.totals())
        y = _ring_spmv(op, xd, mesh)
        after = ring_rows(tracing.totals())
        res[f"y_{name}"] = y.reshape(-1).double().numpy()
        res[f"sent_{name}"] = np.subtract(after, before)[0]
        res[f"itemsize_{name}"] = y.element_size()

    # a step counted eagerly, taken back by its capture and added by
    # three replays
    xd = s._shard(np.zeros(a.n_rows), s.dtype)
    bd = s._shard(probe, s.dtype)
    before = launch_counts.snapshot()
    rows0 = ring_rows(tracing.totals())
    s._step(xd, bd)
    step = launch_counts.delta(before, launch_counts.snapshot())
    res["step_eager"] = np.subtract(ring_rows(tracing.totals()), rows0)
    launch_counts.add(step, -1)
    res["step_taken_back"] = np.subtract(ring_rows(tracing.totals()), rows0)
    launch_counts.add(step, 3)
    res["step_replayed"] = np.subtract(ring_rows(tracing.totals()), rows0)

    b = np.random.default_rng(43).standard_normal(a.n_rows)
    t0, p0 = ring_rows(tracing.totals()), ring_rows(tracing.profiled())
    x, info = s.solve(b)
    res.update(x=x, nits=info.nits, rres=info.rres,
               solve_totals=np.subtract(ring_rows(tracing.totals()), t0),
               solve_profiled=np.subtract(ring_rows(tracing.profiled()), p0))
    t0, p0 = ring_rows(tracing.totals()), ring_rows(tracing.profiled())
    with profile(activities=[ProfilerActivity.CPU]):
        s.solve(b)
    res.update(prof_totals=np.subtract(ring_rows(tracing.totals()), t0),
               prof_profiled=np.subtract(ring_rows(tracing.profiled()), p0))
    np.savez(f"{out}.{rank}.npz", **res)


def main():
    port, rank, nproc, shards, out = sys.argv[1:6]
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from amg_tpu_torch.parallel import initialize

    assert initialize(f"localhost:{port}", int(nproc), int(rank),
                      device="cpu")
    try:
        run(int(shards), out, int(rank))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
