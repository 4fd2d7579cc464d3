"""``calibrate.py`` for a cell of several cards: the readings that the
limits of ``correct`` are set from, taken by that many rank processes of
this script in one process group (NCCL on the cards, gloo on the CPU),
as ``run.py`` starts a cell's ranks.

    python3 benchmark/calibrate_ranks.py --workload p3d7_4x1m.spmd \\
        --seeds 11,12,13,14,15,16,17,18,19,20,21,22 --seconds 3 --controls 3

Every rank runs ``calibrate.readings`` on its part of each run (each
call of the group is collective); rank 0 judges the answers against the
reference and prints one JSON line per reading, as ``calibrate.py``
does, for the sound runs and for the ``f32_outer`` control.  After the
sound runs two readings of the ring itself, on the first seed:

- ``ring_product``: each rank's rows of the level-0 ring product of a
  seeded probe, on the cycle's operator and on FCG's float64 one,
  against the plain reference of those rows
  (``reference/ring.block_product``), as ``check.product_gap``, one
  gap per rank;
- ``ring_counts``: the span table's ring rows (``amg.ring.*``) added by
  one solve on the step graphs and by the same solve on eager steps,
  with their iterations: a replay adds what its capture counted.

``port_api`` has no door to FCG's operator or to the eager steps, so
these two reach the solver directly.  The benchmark's own runs never run
this script.  ``--device cpu``, ``--data`` and ``--ranks`` run it on the
CPU at a test size.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from benchmark import calibrate, harness, port_api, run  # noqa: E402
from benchmark.reference import check, ring  # noqa: E402

def _ring_rows():
    from amg_tpu_torch import tracing

    t = tracing.totals()
    return {n: [t[n]["n"], t[n]["bytes"]] for n in tracing.COUNTERS}


def ring_readings(sess, seed, emit) -> None:
    """The ``ring_product`` and ``ring_counts`` readings (module
    docstring) of the session's solver, on every rank, rank 0 emitting."""
    from amg_tpu_torch.parallel.spmd_cycle import _ring_spmv

    s, ref = sess.solver, sess.ref
    rng = np.random.default_rng(seed)
    probe = check.probe_vector(rng, sess.n, 1)
    gaps = {}
    for name, op, dtype in (("cycle", s.mg.levels[0].a, s.dtype),
                            ("float64", s.a0_hi, torch.float64)):
        if op is None:
            continue
        y = _ring_spmv(op, s._shard(probe, dtype), s.mesh)
        y = y.reshape(-1).double().cpu().numpy()
        lo, hi = ring.blocks(sess.n, sess.world, y.shape[0])[sess.rank]
        want = ring.block_product(ref.indptr, ref.indices, ref.data, probe,
                                  lo, hi).numpy()
        gaps[name] = check.product_gap(y[: hi - lo], want)
    every = [None] * sess.world
    dist.all_gather_object(every, gaps)
    emit({"kind": "ring_product", "seed": seed,
          "gap": {k: [g[k] for g in every] for k in gaps}})

    b = rng.uniform(-1.0, 1.0, sess.n)
    counts = {}
    for route, eager in (("graph", False), ("eager", True)):
        before = _ring_rows()
        _, info = s.solve(b, eager=eager)
        after = _ring_rows()
        counts[route] = {"nits": int(info.nits), **{
            n: [a - b0 for a, b0 in zip(after[n], before[n])]
            for n in after}}
    emit({"kind": "ring_counts", "seed": seed, **counts})


def rank_main(args, world: int) -> int:
    rank = args.rank
    if args.device == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    port_api.join_group(f"127.0.0.1:{args.port}", world, rank, args.device)

    def emit(d):
        if rank == 0:
            print(json.dumps(dict(workload=args.workload, **d)), flush=True)

    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        args.workload, Path(args.data))
    seeds = [int(s) for s in args.seeds.split(",")]
    sess = harness.Session(cell, args.device)
    calibrate.readings(sess, seeds, args.seconds, "sound", emit,
                       torch.float32)
    ring_readings(sess, seeds[0], emit)
    sess.close()
    sess = harness.Session(cell, args.device, params={"refine": False})
    calibrate.readings(sess, seeds[:args.controls], args.seconds,
                       "f32_outer", emit)
    sess.close()
    dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds of the sound runs")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", type=int, default=3,
                   help="seeds (the first of --seeds) of the control run")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--data", default=str(ROOT / "benchmark"),
                   help="a directory laid out as benchmark/ (configs, "
                   "traffic, limits)")
    p.add_argument("--ranks", type=int,
                   help="processes of the group (default: the cell's cards)")
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        args.workload, Path(args.data))
    if not (cell.traffic["entry"] == "solve"
            and cell.config["params"]["refine"]):
        harness.log("error: the control needs a float64 outer loop")
        return 2
    world = args.ranks or cell.chips
    if args.device == "cuda" and torch.cuda.device_count() < world:
        harness.log(f"error: {world} CUDA card(s) needed")
        return 2
    if args.rank is not None:
        return rank_main(args, world)
    port = run.free_port()
    rest = list(argv if argv is not None else sys.argv[1:])
    rc, out = run.launch([[sys.executable, __file__, *rest, "--rank",
                           str(r), "--port", str(port)]
                          for r in range(world)])
    print(out, end="", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
