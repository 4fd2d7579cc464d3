"""The benchmark of amg_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload p3d7_1m.solve --seed 7 \\
        --seconds 30 --trace 0

Prints as the last line of standard output one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit), and the numbers compared as the last lines of standard error.
Exits non-zero, and prints no result, without enough CUDA cards, or when
the process has loaded JAX or the JAX package.

A cell of more than one card runs as that many rank processes of this
script, one card each, in one NCCL group that meets at a free TCP port
of 127.0.0.1; this process starts them, stops them all when one fails,
and prints rank 0's result.  See README.md.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache a library may keep lives at a fixed place in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / "benchmark" / ".cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def card(chips: int) -> dict:
    """The card's name, the count used and its power limit (nvidia-smi)."""
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        dev["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        dev["power_limit_w"] = None
    return dev


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cmds: list, poll_s: float = 0.2) -> tuple[int, str]:
    """Run the rank processes ``cmds`` together; when one fails, stop the
    others.  Returns the first failing exit code (0 when all succeed) and
    rank 0's standard output; every rank's standard error passes through."""
    with tempfile.TemporaryFile() as out0:
        procs = [subprocess.Popen(cmd, stdout=out0 if r == 0 else
                                  subprocess.DEVNULL)
                 for r, cmd in enumerate(cmds)]
        try:
            while True:
                codes = [p.poll() for p in procs]
                rc = next((c for c in codes if c not in (None, 0)), 0)
                if rc or None not in codes:
                    break
                time.sleep(poll_s)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        out0.seek(0)
        return rc, out0.read().decode()


def loaded_forbidden() -> int:
    """3 (and the modules named on standard error) when this process has
    loaded JAX or the JAX package, else 0."""
    from benchmark import harness

    found = harness.forbidden_modules()
    if found:
        harness.log(f"error: the process loaded {', '.join(found)}")
    return 3 if found else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a multi-card cell, started by the run's first process
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    from benchmark import harness

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(manifest, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        harness.log(f"error: {cell.name} needs {cell.chips} CUDA card(s); "
                    f"this machine has {found}")
        return 2
    if cell.chips > 1 and args.rank is None:
        port = free_port()
        rc, out = launch([
            [sys.executable, __file__, "--workload", cell.name, "--seed",
             str(args.seed), "--seconds", str(args.seconds), "--trace",
             str(args.trace), "--rank", str(r), "--port", str(port),
             "--t0", repr(T_PROCESS)] for r in range(cell.chips)])
        rc = rc or loaded_forbidden()
        if rc == 0:
            print(out.strip().splitlines()[-1], flush=True)
        return rc

    rank = args.rank or 0
    torch.cuda.set_device(rank)
    if cell.chips > 1:
        from benchmark import port_api

        port_api.join_group(f"127.0.0.1:{args.port}", cell.chips, rank,
                            "cuda")
    torch.cuda.reset_peak_memory_stats()
    rec = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", args.t0 or T_PROCESS)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    out = (harness.result(cell, rec, bool(args.trace), card(cell.chips))
           if rank == 0 else None)
    # on every rank, once its window has closed: a rank's non-zero exit
    # stops the group and is the run's exit code
    rc = loaded_forbidden()
    if rc or out is None:
        return rc
    for name, c in out["checks"].items():
        harness.log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    harness.log(f"correct: {out['correct']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
