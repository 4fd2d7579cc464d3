"""Where the device time of a warm amg_tpu_torch solve goes, on one GPU.

    python3 profile_torch.py                  # fem2d(1,000,000), unstructured
    python3 profile_torch.py --structured     # poisson3d(100), structured
    python3 profile_torch.py --batched 16     # poisson3d(100), solve_batched
    python3 profile_torch.py --package DIR    # the port of another checkout
    python3 profile_torch.py --structured --layout embedded   # phase 14's
    python3 profile_torch.py --gmres          # phase 16: GMRES acceleration
    python3 profile_torch.py --structured --layout auto --coarsest KRYLOV
    python3 profile_torch.py --spmd 4         # phase 18: 4 row shards
    python3 profile_torch.py --spmd 4 --matrix fem2d   # phase 19
    python3 profile_torch.py --gspmd 4        # phase 20: GSPMD, 4 shards
    python3 profile_torch.py --gspmd 4 --single   # its one-device reference
    python3 profile_torch.py --spmd 4 --matrix fem2d --layout auto --nccl
    python3 profile_torch.py --structured --layout auto --jit   # phase 22
    python3 profile_torch.py --layout auto --jit   # phase 22's fem2d solve
    python3 profile_torch.py --layout auto --eager     # the eager steps

``--layout`` picks the format flags: ``compact`` (default; chip_smoke.py
phases 5 and 8), ``auto`` (``use_well`` and ``use_banded`` on "auto",
phases 13 and 15) or ``embedded`` (auto plus ``embed_levels=8``, with
``use_banded`` on "on" as in phase 14; poisson3d only).  ``--gmres`` solves phase 16's 1000 x 1000
convection-diffusion operator with ``accel="gmres"`` (f64 cycles, "auto"
formats); ``--coarsest KRYLOV`` takes the reference's CG -> GMRES
coarsest solver (phase 17 with ``--structured --layout auto``), each
coarsest solve one CUDA graph of while and if nodes, whose nodes, build
seconds and pool are printed after the profile.
``--spmd N`` solves poisson3d(100) in phase 18's mode (bench_dist.py's
spmd-cg parameters) with ``SpmdAMGSolver`` on a ring of N row shards on
the card; with ``--matrix fem2d`` fem2d(1,000,000) in phase 19's general
mode (bench_dist.py's fem2d parameters; ``--layout compact`` turns
``use_banded`` off: phase 19's ring-R solve).  ``--gspmd N`` solves
poisson3d(100) in phase 20's mode (bench_dist.py's gspmd parameters) with
``DistAMGSolver`` on a ring of N row shards on the card; with
``--single`` the single-device ``AMGSolver`` of the same parameters and
packing (``dist_devices=N``), phase 20's reference.  ``--nccl`` runs the
``--spmd``/``--gspmd`` solver inside a one-rank NCCL process group
(phases 18-20's second solve: the group's collectives captured in the
step graphs).  ``--jit`` takes
phase 22's parameters (``chip_smoke.jit_pars``: f32 cycles to 1e-6, no
defect correction or Krylov acceleration) and right-hand side
(``jit_rhs``) and profiles a warm ``solve`` and then a warm ``solve_jit``
(the masked cycle step replayed as a CUDA graph) on the same solver.
The solves run their steps as replayed CUDA graphs (the entries' default
on the card; the graphs' nodes, build seconds and pool are printed after
the profile); ``--eager`` runs the same steps eagerly (``eager=True``).

Builds the main-path configuration of ``chip_smoke.py`` (phase 8, or
phase 5 with ``--structured``; with ``--batched K`` phase 5's solver runs
``solve_batched`` on K seeded random right-hand sides to phase 11's
tolerance), runs a cold and a warm solve, then one
more warm solve under ``torch.profiler`` and prints: the setup seconds
and the device memory the solver holds after setup
(``torch.cuda.memory_allocated``), the wall time of the solves, the
device time of every kernel by name (sums over the profiled solve), the
same sums grouped by what the kernels do, and the device's busy share of
the profiled window.  ``--package DIR`` imports ``amg_tpu_torch`` from
the checkout at DIR (e.g. a parent commit unpacked with ``git archive``
into an ignored directory), so that two trees run in one call.  Prints
the card's name and power limit (nvidia-smi) first.  Needs a CUDA card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

# kernel-name fragments -> group (first match wins); the WEll kernels of
# older checkouts (a slot walk over the pack: well_kernel,
# well_df64_kernel) fall into the same B2/B3 groups under --package
GROUPS = (
    ("TwoPlanes", "B3 WEll df64 (well_spmv.cu)"),
    ("well_df64_kernel", "B3 WEll df64 (well_spmv.cu)"),
    ("rows_gs_kernel", "B2 WEll GS class update (well_spmv.cu)"),
    ("rows_spmv_kernel", "B2 WEll (well_spmv.cu)"),
    ("well_kernel", "B2 WEll (well_spmv.cu)"),
    ("dia_multi_kernel", "B4 DIA multi-rhs (dia_spmv.cu)"),
    ("dia_kernel", "B1 DIA, and its window entry (dia_spmv.cu)"),
    ("CatArrayBatchedCopy", "concatenation (ring windows, gathers)"),
    ("nccl", "NCCL collectives"),
    ("gemv", "dense matvec, BandedBlocks (cuBLAS)"),
    ("gemm", "dense matvec, BandedBlocks (cuBLAS)"),
    ("nvjet", "dense matvec, BandedBlocks (cuBLAS)"),
    ("reduce", "reductions (dot, norm)"),
    ("index", "gathers / index (Ell, GS groups)"),
    ("gather", "gathers / index (Ell, GS groups)"),
    ("Memcpy", "memcpy host<->device"),
    ("Memset", "memset / fill"),
    ("fill", "memset / fill"),
    ("elementwise", "elementwise (vector updates)"),
)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--structured", action="store_true",
                    help="poisson3d(100) instead of fem2d(1,000,000)")
    ap.add_argument("--batched", type=int, default=0, metavar="K",
                    help="poisson3d(100) through solve_batched with K "
                         "right-hand sides")
    ap.add_argument("--package", metavar="DIR",
                    help="import amg_tpu_torch from the checkout at DIR")
    ap.add_argument("--layout", choices=("compact", "auto", "embedded"),
                    default="compact", help="format flags (see above)")
    ap.add_argument("--gmres", action="store_true",
                    help="phase 16's convection-diffusion solve with "
                         "GMRES acceleration")
    ap.add_argument("--coarsest", choices=("DENSE", "KRYLOV"),
                    default="DENSE", help="coarsest-level solver")
    ap.add_argument("--spmd", type=int, default=0, metavar="N",
                    help="phase 18's SPMD solve on N row shards")
    ap.add_argument("--gspmd", type=int, default=0, metavar="N",
                    help="phase 20's GSPMD solve on N row shards")
    ap.add_argument("--single", action="store_true",
                    help="with --gspmd N: the single-device solve of the "
                         "same parameters and packing")
    ap.add_argument("--jit", action="store_true",
                    help="phase 22: profile solve and then solve_jit on "
                         "the same solver")
    ap.add_argument("--eager", action="store_true",
                    help="run each step eagerly instead of replaying its "
                         "CUDA graph")
    ap.add_argument("--nccl", action="store_true",
                    help="with --spmd/--gspmd: inside a one-rank NCCL "
                         "process group")
    ap.add_argument("--matrix", choices=("poisson3d", "fem2d"),
                    default="poisson3d",
                    help="--spmd's matrix: poisson3d(100) (phase 18) or "
                         "fem2d(1,000,000) (phase 19)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import (BATCH_TOL, CD_SIDE, FEM_ROWS,
                            convection_diffusion, general_pars, gspmd_pars,
                            jit_pars, jit_rhs, spmd_pars, structured_pars,
                            unstructured_pars)
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    import amg_tpu_torch as amg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"amg_tpu_torch from {os.path.dirname(amg.__file__)}")
    if args.gmres:
        a, pars, what = convection_diffusion(CD_SIDE), amg.AMGParams(
            accel="gmres", tol=1e-8, verbose=0), \
            f"convection-diffusion {CD_SIDE}^2, GMRES"
    elif args.spmd and args.matrix == "fem2d":
        a, pars, what = amg.fem2d(FEM_ROWS, seed=0), general_pars(amg), \
            f"fem2d({FEM_ROWS}), general mode on {args.spmd} row shards"
        if args.layout == "compact":
            pars = pars.replace(use_banded="off")
            what += ", use_banded off"
    elif args.spmd:
        a, pars, what = amg.poisson3d(100), spmd_pars(amg), \
            f"poisson3d(100), spmd-cg on {args.spmd} row shards"
    elif args.gspmd:
        a, pars, what = amg.poisson3d(100), gspmd_pars(amg), \
            f"poisson3d(100), gspmd on {args.gspmd} row shards"
    elif args.structured or args.batched:
        a, pars, what = amg.poisson3d(100), structured_pars(amg), \
            "poisson3d(100)"
    else:
        a, pars, what = amg.fem2d(FEM_ROWS, seed=0), \
            unstructured_pars(amg), f"fem2d({FEM_ROWS})"
    if args.layout != "compact" and not (args.spmd
                                         and args.matrix == "fem2d") \
            and not args.gspmd:
        pars = pars.replace(use_well="auto", use_banded="auto")
    if args.layout == "embedded":
        if not (args.structured or args.batched):
            ap.error("--layout embedded needs --structured or --batched")
        pars = pars.replace(embed_levels=8, use_banded="on")
        what += ", embedded"
    elif args.layout == "auto":
        what += ", auto formats"
    if args.coarsest == "KRYLOV":
        pars = pars.replace(coarsest_solver=amg.CoarsestSolver.KRYLOV)
        what += ", KRYLOV coarsest solver"
    if args.jit:
        if args.spmd or args.gspmd or args.batched or args.gmres:
            ap.error("--jit takes the one-device solve of poisson3d or "
                     "fem2d")
        pars = jit_pars(pars)
        what += ", f32 cycles to 1e-6 (phase 22)"
    if args.nccl:
        if not (args.spmd or args.gspmd) or args.single:
            ap.error("--nccl takes the --spmd or --gspmd solver")
        import socket
        from amg_tpu_torch.parallel import multihost

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        multihost.initialize(f"localhost:{port}", 1, 0, device="cuda")
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    if args.spmd:
        from amg_tpu_torch.parallel import SpmdAMGSolver, make_mesh

        solver = SpmdAMGSolver(a, pars, mesh=make_mesh(args.spmd),
                               log=lambda *_: None)
        what += f" ({solver.mesh.describe()}, E = {solver.E}"
        if solver.E == 0:
            what += (f", Es = {solver.Es}, "
                     f"{'ring-R' if solver.ring_r else 'all-gather'} "
                     "boundary")
        what += ")"
    elif args.gspmd and args.single:
        solver = amg.AMGSolver(a, pars.replace(dist_devices=args.gspmd),
                               log=lambda *_: None)
        what += ", single device"
    elif args.gspmd:
        from amg_tpu_torch.parallel import DistAMGSolver, make_mesh

        solver = DistAMGSolver(a, pars, mesh=make_mesh(args.gspmd),
                               log=lambda *_: None)
        what += f" ({solver.mesh.describe()}, Es = {solver.Es})"
    else:
        solver = amg.AMGSolver(a, pars, log=lambda *_: None)
    torch.cuda.synchronize()
    print(f"{what}: setup {time.perf_counter() - t0:.2f} s, device memory "
          f"held after setup "
          f"{(torch.cuda.memory_allocated() - mem0) / 2**20:.1f} MiB")
    kw = dict(eager=True) if args.eager else {}
    if args.eager:
        what += ", eager steps"
    if args.batched:
        what += f", solve_batched k={args.batched}"
        B = np.random.default_rng(6).standard_normal((a.n_rows, args.batched))
        _report(what, lambda: solver.solve_batched(B, tol=BATCH_TOL, **kw))
    elif args.jit:
        b = jit_rhs(a)
        _report(what + ", solve", lambda: solver.solve(b, **kw))
        _report(what + ", solve_jit", lambda: solver.solve_jit(b))
        loop = solver.jit_loop
        print(f"solve_jit: capture {loop.capture_seconds:.3f} s, "
              f"{loop.blocks} blocks, {loop.host_reads} host reads of the "
              f"stop flag per solve; device MiB held "
              f"{torch.cuda.memory_allocated() / 2**20:.1f}, reserved "
              f"{torch.cuda.memory_reserved() / 2**20:.1f}")
    else:
        b = (np.random.default_rng(16).standard_normal(a.n_rows)
             if args.gmres else np.ones(a.n_rows))
        _report(what, lambda: solver.solve(b, **kw))
    for name, g in getattr(getattr(solver, "steps", None), "graphs",
                           {}).items():
        if g.graph is not None:
            print(f"step graph {name!r}: {g.nodes} nodes, {g.replays} "
                  f"replays, built in {g.build_seconds:.3f} s, pool "
                  f"+{g.pool_bytes / 2**20:.1f} MiB")
    for key, ks in getattr(solver.mg, "krylov", {}).items():
        g = ks.graph
        if g is not None:
            print(f"KRYLOV coarsest graph for b {key[0]}: {g.nodes} nodes, "
                  f"{g.captures} captured segments, built in "
                  f"{g.build_seconds:.3f} s, pool "
                  f"{g.pool_bytes / 2**20:.1f} MiB")
    if args.nccl:
        torch.distributed.destroy_process_group()
    return 0


def _report(what, run):
    """Wall seconds of a cold and two warm calls of ``run``, then one more
    warm call under ``torch.profiler``: device time by kernel and by
    group, and the device's busy share of the profiled window."""
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, info = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"{what}: {info.nits} iterations, rres {info.rres:.3e}; solve "
          f"wall s (cold, warm, warm): {times}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profiled warm solve: wall {wall * 1e3:.2f} ms (profiler on), "
          f"device time {total / 1e3:.2f} ms, device busy "
          f"{100 * total / 1e3 / (wall * 1e3):.1f}%")
    print("device time by kernel (ms, calls, name):")
    for us, count, key in rows[:25]:
        print(f"  {us / 1e3:9.3f} {count:6d}  {key[:110]}")
    groups: dict = {}
    for us, count, key in rows:
        g = next((name for frag, name in GROUPS if frag in key), "other")
        t, c = groups.get(g, (0.0, 0))
        groups[g] = (t + us, c + count)
    print("device time by group (ms, share, calls):")
    for g, (us, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us / 1e3:9.3f} {100 * us / total:5.1f}% {c:6d}  {g}")


if __name__ == "__main__":
    sys.exit(main())
