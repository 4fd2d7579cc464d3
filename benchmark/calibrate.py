"""Readings that the limits of ``correct`` are set from: the numbers
compared, for sound runs of the program on many seeds, and for the
lower-precision controls on a few, in one process (one set-up each).

    python3 benchmark/calibrate.py --workload p3d7_1m.solve \\
        --seeds 11,12,13,14,15,16,17,18,19,20,21,22 --seconds 3 --controls 3

Prints one JSON line per reading.  Controls, each one precision below
what the configuration states:

- ``bf16_product``: the reference's level-0 product with values and
  vector in bfloat16 in the program's place (the cycle's operator is
  float32), read by ``l0_op_gap``;
- ``low_residual``: the reference's residual of each sampled answer in
  the program's place, one precision below the program's own (float32
  under a float64 outer loop, else bfloat16), read by
  ``rres_report_gap``;
- ``f32_outer`` (a ``solve`` whose outer loop, defect correction or
  FCG, runs in float64): the program with its float32 outer loop
  switched on (``refine`` off), read by every number;
- ``tf32`` (entries without a float64 outer loop): the program with TF32
  switched on for its float32 matrix products after set-up.

The benchmark's own runs never run this.  Needs a CUDA card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import check  # noqa: E402


def readings(sess, seeds, seconds, kind, emit, below=None) -> None:
    """``below``: the dtype one step under the program's own residual, for
    the ``low_residual`` control of the sound runs."""
    for seed in seeds:
        rec = sess.drive(seed, seconds, False, time.time())
        inputs, sample, probe, y = rec.pop("_")
        nums = harness.numbers(sess.ref, inputs, sample, probe, y)
        emit({"kind": kind, "seed": seed, "numbers": nums,
              "calls": len(rec["calls"]),
              "failed": rec["rhs_attempted"] - rec["rhs_solved"],
              "iters": [c["nits"] for c in rec["calls"][:4]]})
        if kind == "sound":
            emit({"kind": "bf16_product", "seed": seed, "numbers": {
                "l0_op_gap": check.product_gap(
                    check.control_product(sess.ref, probe),
                    sess.ref.matvec(probe))}})
            gap = 0.0
            for j, x, _ in sample:
                x = np.asarray(x, dtype=np.float64)
                true = float(np.max(sess.ref.rel_residual(inputs[j], x)))
                low = check.control_residual(sess.ref, inputs[j], x, below)
                gap = max(gap, abs(low - true))
            emit({"kind": "low_residual", "seed": seed,
                  "dtype": str(below), "numbers": {"rres_report_gap": gap}})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds of the sound runs")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", type=int, default=3,
                   help="seeds (the first of --seeds) of each control run")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2

    def emit(d):
        print(json.dumps(dict(workload=args.workload, **d)), flush=True)

    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = seeds[:args.controls]
    # solve_batched has no float64 outer loop, whatever the parameters say
    outer64 = cell.traffic["entry"] == "solve" and \
        cell.config["params"]["refine"]
    sess = harness.Session(cell, "cuda")
    readings(sess, seeds, args.seconds, "sound", emit,
             torch.float32 if outer64 else torch.bfloat16)
    sess.close()
    if outer64:
        sess = harness.Session(cell, "cuda", params={"refine": False})
        readings(sess, ctl, args.seconds, "f32_outer", emit)
    else:
        sess = harness.Session(cell, "cuda")
        torch.backends.cuda.matmul.allow_tf32 = True
        readings(sess, ctl, args.seconds, "tf32", emit)
    sess.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
