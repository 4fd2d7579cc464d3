"""Command-line interface.

``python -m amg_tpu_torch matrix.mtx`` reproduces the reference binary's
behavior (``main``, amg/SSS_main.c:121-159): read the matrix, echo
parameters, solve ``A x = b`` with ``b = x0 = 1``, print the residual table
and final summary.  The parameter echo and the residual table are
byte-identical to ``python -m amg_tpu``'s.

``--device cuda|cpu`` picks the device (default the CUDA card; there is
no fall to the CPU when none is present).  ``--accel cg`` runs flexible CG
and ``--accel gmres`` GMRES, each preconditioned by one cycle;
``--coarsest KRYLOV`` solves the coarsest level with the reference's CG
and GMRES fallback; ``--use-well on`` packs large unstructured levels as
WEll, e.g. ``python -m amg_tpu_torch fem2d:1000000 --use-well on --accel
cg --refine --dtype float32``.  ``--profile DIR`` writes a
``torch.profiler`` trace of the solve to ``DIR/trace.json`` and prints
the program's spans recorded under it (``amg_tpu_torch.tracing``: name,
count, host seconds, MiB).

``--devices N`` solves on a ring of N row shards: all N on the one device
of a single process, or split over the processes of a ``torchrun`` launch
(gloo with ``--device cpu``, NCCL between cards; only rank 0 prints).
``--dist spmd`` runs the SPMD solver (``amg_tpu_torch.parallel.
SpmdAMGSolver``), ``--dist gspmd`` the GSPMD one (``DistAMGSolver``), and
``--dist auto`` (the default) the SPMD solver, or the GSPMD one with a
``# spmd path unavailable`` line where the SPMD solver cannot shard level
0 (a Dense or Ell level 0), as ``amg_tpu``'s CLI does.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .params import (
    AMGParams,
    CoarsenType,
    CoarsestSolver,
    ErrorCode,
    InterpType,
    SmootherType,
)


def pars_print(pars: AMGParams, log=print) -> None:
    """Parameter echo matching ``SSS_amg_pars_print`` (amg/SSS_main.c:67-119)."""
    log("")
    log("               AMG Parameters ")
    log("-----------------------------------------------------------")
    log(f"AMG max num of iter:               {pars.max_it}")
    log(f"AMG tol:                           {pars.tol:g}")
    log(f"AMG ctol:                          {pars.ctol:g}")
    log(f"AMG max levels:                    {pars.max_levels}")
    log(f"AMG cycle type:                    {pars.cycle_type}")
    log(f"AMG smoother type:                 {int(pars.smoother)}")
    log(f"AMG smoother order:                {pars.cf_order}")
    log(f"AMG num of presmoothing:           {pars.pre_iter}")
    log(f"AMG num of postsmoothing:          {pars.post_iter}")
    if pars.smoother in (SmootherType.SOR, SmootherType.SSOR,
                         SmootherType.GSOR, SmootherType.SGSOR):
        log("AMG relax factor:                  %.4f" % pars.relax)
    elif pars.smoother == SmootherType.POLY:
        log(f"AMG polynomial smoother degree:    {pars.poly_deg}")
    log(f"AMG coarsening type:               {int(pars.cs_type)}")
    if pars.interp_type == InterpType.DIR:
        log("AMG interPolation type:            Dir")
    elif pars.interp_type == InterpType.STD:
        log("AMG interPolation type:            STD")
    log(f"AMG dof on coarsest grid:          {pars.coarse_dof}")
    log("AMG strong threshold:              %.4f" % pars.strong_threshold)
    log("AMG truncation threshold:          %.4f" % pars.trunc_threshold)
    log("AMG max row sum:                   %.4f" % pars.max_row_sum)
    log("-----------------------------------------------------------")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="amg_tpu_torch",
        description="algebraic multigrid solver (PyTorch/CUDA port of amg_tpu)",
    )
    ap.add_argument("matrix", help=".mtx MatrixMarket file, or poisson2d:N / "
                                   "poisson3d:N / anisotropic:N[:eps] / "
                                   "fem2d:N[:graded] synthetic problem")
    d = AMGParams()
    ap.add_argument("--max-it", type=int, default=d.max_it)
    ap.add_argument("--tol", type=float, default=d.tol)
    ap.add_argument("--ctol", type=float, default=d.ctol)
    ap.add_argument("--max-levels", type=int, default=d.max_levels)
    ap.add_argument("--coarse-dof", type=int, default=d.coarse_dof)
    ap.add_argument("--cycle-type", type=int, default=d.cycle_type,
                    help="1=V, 2=W")
    ap.add_argument("--cf-order", type=int, default=d.cf_order)
    ap.add_argument("--pre-iter", type=int, default=d.pre_iter)
    ap.add_argument("--post-iter", type=int, default=d.post_iter)
    ap.add_argument("--relax", type=float, default=d.relax)
    ap.add_argument("--poly-deg", type=int, default=d.poly_deg)
    ap.add_argument("--smoother", type=str, default="GS",
                    choices=[s.name for s in SmootherType])
    ap.add_argument("--coarsen", type=str, default="RS",
                    choices=[c.name for c in CoarsenType])
    ap.add_argument("--interp", type=str, default="DIR",
                    choices=[i.name for i in InterpType])
    ap.add_argument("--coarsest", type=str, default="DENSE",
                    choices=[c.name for c in CoarsestSolver])
    ap.add_argument("--max-row-sum", type=float, default=d.max_row_sum)
    ap.add_argument("--strong-threshold", type=float, default=d.strong_threshold)
    ap.add_argument("--trunc-threshold", type=float, default=d.trunc_threshold)
    ap.add_argument("--dtype", type=str, default=d.dtype,
                    choices=["float32", "float64"])
    ap.add_argument("--refine", action="store_true",
                    help="mixed-precision defect correction: cycles in "
                         "--dtype, f64 outer residual")
    ap.add_argument("--refine-inner", type=int, default=d.refine_inner_cycles)
    ap.add_argument("--accel", type=str, default=d.accel,
                    choices=["none", "cg", "gmres"],
                    help="Krylov acceleration: cg = AMG-preconditioned "
                         "flexible CG (one cycle per iteration); gmres = "
                         "AMG-right-preconditioned GMRES (nonsymmetric)")
    ap.add_argument("--devices", type=int, default=0,
                    help="solve on a ring of N row shards (0 = one device)")
    ap.add_argument("--dist", type=str, default="auto",
                    choices=["auto", "spmd", "gspmd"],
                    help="multi-device path: spmd = the SPMD ring solver "
                         "(needs a ring-capable level 0); gspmd = the "
                         "sharding-annotated solver; auto = spmd, else "
                         "gspmd")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="torch device for the solve (cuda, the default, "
                         "raises when no card is available)")
    ap.add_argument("--use-well", type=str, default=d.use_well,
                    choices=["auto", "on", "off"],
                    help="windowed-gather WEll format for large "
                         "unstructured levels")
    ap.add_argument("--transfer-dtype", type=str,
                    default=d.transfer_op_dtype,
                    choices=["same", "bfloat16"],
                    help="P/R value-plane storage on WEll levels "
                         "(bfloat16 halves them)")
    ap.add_argument("--profile", type=str, default=None, metavar="DIR",
                    help="write a torch.profiler trace of the solve to "
                         "DIR/trace.json and print its span table")
    ap.add_argument("--quiet", action="store_true")
    return ap


def params_from_args(args) -> AMGParams:
    return AMGParams(
        smoother=SmootherType[args.smoother],
        max_it=args.max_it,
        tol=args.tol,
        ctol=args.ctol,
        max_levels=args.max_levels,
        coarse_dof=args.coarse_dof,
        cycle_type=args.cycle_type,
        cf_order=args.cf_order,
        pre_iter=args.pre_iter,
        post_iter=args.post_iter,
        relax=args.relax,
        poly_deg=args.poly_deg,
        cs_type=CoarsenType[args.coarsen],
        interp_type=InterpType[args.interp],
        coarsest_solver=CoarsestSolver[args.coarsest],
        max_row_sum=args.max_row_sum,
        strong_threshold=args.strong_threshold,
        trunc_threshold=args.trunc_threshold,
        dtype=args.dtype,
        refine=args.refine,
        refine_inner_cycles=args.refine_inner,
        accel=args.accel,
        use_well=args.use_well,
        transfer_op_dtype=args.transfer_dtype,
        verbose=0 if args.quiet else 1,
    )


def load_matrix(spec: str):
    from .io import read_mtx, poisson2d, poisson3d

    if spec.startswith("poisson2d:"):
        return poisson2d(int(spec.split(":", 1)[1]))
    if spec.startswith("poisson3d:"):
        return poisson3d(int(spec.split(":", 1)[1]))
    if spec.startswith("fem2d:"):
        # fem2d:N or fem2d:N:graded — unstructured Delaunay FEM stiffness
        from .io.generators import fem2d

        parts = spec.split(":")
        return fem2d(int(parts[1]), graded=len(parts) > 2 and
                     parts[2] == "graded")
    if spec.startswith("anisotropic:"):
        # anisotropic:N or anisotropic:N:eps (epsilon-scaled y-coupling)
        parts = spec.split(":")
        eps = float(parts[2]) if len(parts) > 2 else 1e-3
        return poisson2d(int(parts[1]), epsilon=eps)
    return read_mtx(spec)


def _profiler(device: str):
    """A ``torch.profiler`` context over the host and, on the card, the
    device (``amg_tpu`` traces the solve with ``jax.profiler``)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _dist_solver(a, pars, args, out):
    """The multi-device solver on ``--devices`` shards, as
    ``amg_tpu/cli.py:221-240`` picks it: the SPMD solver unless ``--dist
    gspmd``; with ``--dist auto`` the GSPMD solver where the SPMD one
    raises ``ValueError`` (``--dist spmd`` re-raises)."""
    from .parallel import DistAMGSolver, make_mesh
    from .parallel.spmd_cycle import SpmdAMGSolver

    mesh = make_mesh(args.devices, device=args.device)
    if args.dist in ("auto", "spmd"):
        try:
            return SpmdAMGSolver(a, pars, mesh=mesh, log=out)
        except ValueError as exc:
            if args.dist == "spmd":
                raise
            out(f"# spmd path unavailable ({exc}); using the GSPMD solver")
    return DistAMGSolver(a, pars, mesh=mesh, log=out)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.devices > 1:
        import torch.distributed as dist
        from .parallel import initialize

        # under torchrun (or AMG_COORDINATOR) every process joins and runs
        # the same loop (the same pars: its host decisions must agree);
        # only rank 0 prints
        joined = not dist.is_initialized() and initialize(device=args.device)
        try:
            return _main(args, print if not dist.is_initialized()
                         or dist.get_rank() == 0
                         else (lambda *a, **k: None))
        finally:
            if joined:
                dist.destroy_process_group()
    return _main(args, print)


def _main(args, out) -> int:
    pars = params_from_args(args)

    out(f"filename: {args.matrix}")
    try:
        a = load_matrix(args.matrix)
    except FileNotFoundError:
        # reference exits with ERROR_OPEN_FILE (amg/SSS_main.c:131-137)
        print(f"amg_tpu_torch: cannot open matrix file '{args.matrix}'",
              file=sys.stderr)
        return int(-ErrorCode.ERROR_OPEN_FILE)
    except ValueError as exc:
        print(f"amg_tpu_torch: bad matrix input: {exc}", file=sys.stderr)
        return int(-ErrorCode.ERROR_WRONG_FILE)
    out(f"A: m = {a.n_rows}, n = {a.n_cols}, nnz = {a.nnz}")

    if pars.verbose:
        pars_print(pars, log=out)

    # b = x0 = ones, like the reference CLI (amg/SSS_main.c:141-145)
    b = np.ones(a.n_rows)
    x0 = np.ones(a.n_rows)

    from .solve.driver import solver_amg

    def run():
        if args.devices > 1:
            return _dist_solver(a, pars, args, out).solve(b, x0=x0)
        return solver_amg(a, x0, b, pars, device=args.device)

    if args.profile:
        with _profiler(args.device) as prof:
            result = run()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        from .tracing import profiled, table_lines

        for line in table_lines(profiled()):
            out(line)
    else:
        result = run()
    x, info = result

    out(f"AMG residual: {info.ares:g}")
    out(f"AMG relative residual: {info.rres:g}")
    out(f"AMG iterations: {info.nits}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
