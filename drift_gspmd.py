"""Where DistAMGSolver's f32 defect-correction solve drifts between one
process and four.

    python3 drift_gspmd.py DIR                 # 1 process, 4 shards, cuda:0
    torchrun --nproc-per-node 4 --master-addr localhost \\
        --master-port 29611 drift_gspmd.py DIR  # 4 processes, a card each
    python3 drift_gspmd.py DIR --compare

Each run sets up poisson3d(100) with chip_smoke.py's gspmd parameters
(phase 20: f32 cycles, f64 defect correction, Chebyshev below level 0,
bf16 coarse operators; ``--n`` sets the side, ``--cli`` takes the CLI's
parameters for ``--dtype float32 --refine`` instead, with one cycle per
step) on a ring of 4 row
shards and runs one defect-correction step from x = 0 on b = ones.  It records, in call order, every
product the step makes: the f64 outer products and the cycle's sharded
products (``gspmd_spmv``), the products of the replicated levels and the
boundary (``spmv``, ``residual_fused``, ``spmv_local_full``), the
coarsest solve and every ``psum``-reduced norm, each with a hash of its
input and its output fetched whole to the host.  Rank 0 writes
``DIR/world<N>.npz``.  ``--device cpu`` runs the same on the CPU (gloo).

``--compare`` walks the two records side by side and prints one line per
call: the operator (level, A/P/R, format), whether the inputs are equal
bit for bit, and the max |difference| of the outputs over max |output|.
The first call whose inputs agree and whose outputs do not is where the
two layouts first compute something else.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys

import numpy as np
import torch

SHARDS = 4


def _host(t, mesh):
    """A tensor as one host vector, the same on every process (sharded
    ``(S, m)`` blocks gathered over the mesh)."""
    from amg_tpu_torch.parallel.multihost import fetch

    if t.dim() == 2 and mesh.world > 1:
        return fetch(t, mesh)
    return t.reshape(-1).cpu().numpy()


def _record(solver, mesh):
    """Wrap the products and norms of ``solver``'s cycle to append
    ``(label, input hash, output)`` to the returned list."""
    import amg_tpu_torch.parallel.spmd_cycle as SC
    import amg_tpu_torch.solve.cycle as C
    import amg_tpu_torch.solve.smoothers as SM

    names = {}
    for l, lv in enumerate(solver.mg.levels):
        for n in ("a", "p", "r"):
            op = getattr(lv, n)
            if op is not None:
                names[id(op)] = f"L{l} {n.upper()} {type(op).__name__}"
    if solver.a0_hi is not None:
        names[id(solver.a0_hi)] = f"a0_hi {type(solver.a0_hi).__name__}"
    calls = []

    def note(kind, op, x, y, local=False):
        xh = hashlib.sha1(np.ascontiguousarray(_host(x, mesh))).hexdigest()
        label = f"{kind} {names.get(id(op), type(op).__name__)}"
        # local: this process's rows of a sharded output, flat
        yv = y.reshape(mesh.local, -1) if local else y
        calls.append((label, xh, _host(yv, mesh)))
        return y

    def wrap(mod, name, kind, local=False):
        fn = getattr(mod, name)

        def inner(op, x, *rest):
            return note(kind, op, x, fn(op, x, *rest), local)

        setattr(mod, name, inner)

    wrap(SC, "gspmd_spmv", "sharded")
    wrap(SC, "spmv", "boundary")
    wrap(SC, "spmv_local_full", "boundary-full", local=True)
    wrap(C, "spmv", "replicated")
    wrap(C, "residual_fused", "replicated-resid")
    wrap(SM, "spmv", "replicated-smooth")
    coarsest = C.coarsest_solve

    def coarsest_solve(mg, b, pars, ctol):
        return note("coarsest", mg.coarse_inv, b,
                    coarsest(mg, b, pars, ctol))

    C.coarsest_solve = coarsest_solve
    norm = solver._norm

    def traced_norm(v):
        return note("norm", v, v, norm(v).reshape(1))

    solver._norm = traced_norm
    return calls


def run(out_dir, device, n_side, cli_pars):
    import amg_tpu_torch as amg
    from amg_tpu_torch import cli
    from amg_tpu_torch.parallel import DistAMGSolver, make_mesh, multihost
    from chip_smoke import gspmd_pars

    multihost.initialize(device=device)
    mesh = make_mesh(SHARDS, device=device)
    a = amg.poisson3d(n_side)
    # the CLI's parameters with one cycle per defect-correction step:
    # GS on every level makes ~10x the products of phase 20's
    pars = (cli.params_from_args(cli.build_argparser().parse_args(
        [f"poisson3d:{n_side}", "--dtype", "float32", "--refine",
         "--refine-inner", "1", "--quiet"])) if cli_pars
        else gspmd_pars(amg))
    solver = DistAMGSolver(a, pars, mesh=mesh, log=lambda *_: None)
    calls = _record(solver, mesh)
    b = solver._pad_vec(np.ones(a.n_rows), torch.float64)
    x = torch.zeros_like(b)
    solver._refine_step(x, b)
    if device != "cpu":
        torch.cuda.synchronize()
    if mesh.rank == 0:
        os.makedirs(out_dir, exist_ok=True)
        np.savez(os.path.join(out_dir, f"world{mesh.world}.npz"),
                 labels=np.array([c[0] for c in calls]),
                 hashes=np.array([c[1] for c in calls]),
                 **{f"y{i}": c[2] for i, c in enumerate(calls)})
        print(f"{mesh.describe()}: Es = {solver.Es}, {len(calls)} calls "
              f"recorded")


def compare(out_dir):
    one = np.load(os.path.join(out_dir, "world1.npz"))
    four = np.load(os.path.join(out_dir, f"world{SHARDS}.npz"))
    n = len(one["labels"])
    if list(one["labels"]) != list(four["labels"]):
        print("the two runs made different calls")
    first = first_in = None
    for i in range(min(n, len(four["labels"]))):
        y1, y4 = (v[f"y{i}"].astype(np.float64) for v in (one, four))
        same_in = one["hashes"][i] == four["hashes"][i]
        rel = float(np.abs(y1 - y4).max() / max(np.abs(y1).max(), 1e-300))
        print(f"{i:4d} {one['labels'][i]:32s} inputs "
              f"{'equal' if same_in else 'differ'}, outputs "
              f"{'equal' if rel == 0 else f'differ by {rel:.3e}'}")
        if first is None and same_in and rel != 0:
            first = (i, one["labels"][i], rel)
        if first_in is None and not same_in:
            first_in = (i, one["labels"][i])
    print(f"first call whose inputs differ: {first_in}")
    print(f"first product that differs on equal inputs: {first}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=100,
                    help="poisson3d's side (default 100: 1,000,000 rows)")
    ap.add_argument("--cli", action="store_true",
                    help="the CLI's parameters for --dtype float32 "
                         "--refine (GS on every level) instead of phase "
                         "20's")
    args = ap.parse_args()
    if args.compare:
        compare(args.dir)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("drift_gspmd: needs a CUDA card (or --device cpu)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    run(args.dir, args.device, args.n, args.cli)
    return 0


if __name__ == "__main__":
    sys.exit(main())
