"""B1 and B4 of one checkout of amg_tpu_torch, timed on the structured main
path's operators, on one GPU.

    python3 ab_dia_kernels.py DIR LABEL

Imports ``amg_tpu_torch`` from the checkout at DIR (``.`` for this one; a
parent commit unpacked with ``git archive`` into an ignored directory for
the other), builds phase 5's solver of ``chip_smoke.py`` (poisson3d(100),
1,000,000 rows), and prints one ``[ab] LABEL <kernel> <ms> ms`` line per
case: B1's epilogues on level 0 (f32, nd=7), level 1 (bf16, nd=23), the
f64 level-0 operator and chip_smoke's 40-diagonal band in bf16; B4's
product and, where the checkout has them, its ``resid`` and ``update``
epilogues at k = 16 and 4 on the same operators (for a checkout without
them, the unfused torch expressions the batched solve used:
``X + w * (B - A X)`` and ``B - A X``).  Each time is chip_smoke's
measure: the median device time of 21 calls from a flushed L2, beside
the error against the plain version.  Run two checkouts in turns in one
call (A, B, B, A) to compare them on one card.  Needs a CUDA card.
"""

import os
import sys

import torch

pkg, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.abspath(pkg))
sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
import amg_tpu_torch as amg  # noqa: E402
from amg_tpu_torch.ops import dia_kernel as K  # noqa: E402
import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_dia_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    K.build()
    a = amg.poisson3d(cs.N_SIDE)
    solver = amg.AMGSolver(a, cs.structured_pars(amg), log=lambda *_: None)
    ops = {"L0": solver.mg.levels[0].a, "L1": solver.mg.levels[1].a,
           "a0_hi": solver.a0_hi}
    offs, vals64 = cs._band40(solver.pad)
    ops["band40bf16"] = amg.Dia(vals64.to(torch.bfloat16).cuda(), offs,
                                (solver.pad, solver.pad), 40 * solver.pad)
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    g = torch.Generator().manual_seed(0)

    def vec(op, k=None):
        xdt = torch.float64 if op.vals.dtype == torch.float64 \
            else torch.float32
        shape = (op.padded_rows,) if k is None else (k, op.padded_rows)
        return torch.randn(shape, generator=g, dtype=xdt).cuda()

    def run(name, fn, args, plain=None):
        err = ""
        if plain is not None:
            got, want = fn(*args), plain(*args)
            err = (f"  rel err "
                   f"{((got - want).abs().max() / want.abs().max()).item():.2e}")
        ms = cs._time_ms(lambda: fn(*args), flush)
        print(f"[ab] {label:10s} {name:30s} {ms:.4f} ms{err}", flush=True)

    for opn, ep in (("L0", "update"), ("L0", "resid"), ("L1", "spmv"),
                    ("L1", "resid"), ("a0_hi", "spmv"),
                    ("band40bf16", "spmv")):
        op = ops[opn]
        fn = {"spmv": K.spmv, "resid": K.resid, "update": K.gs_update}[ep]
        n = {"spmv": 1, "resid": 2, "update": 3}[ep]
        run(f"B1 {opn} {ep}", fn, [op] + [vec(op) for _ in range(n)],
            getattr(K, fn.__name__ + "_plain"))
    for opn in ("L0", "L1", "band40bf16"):
        op = ops[opn]
        for k in (16, 4):
            X, B, w = vec(op, k), vec(op, k), vec(op)
            run(f"B4 {opn} k={k} multi", K.spmv_multi, [op, X],
                K.spmv_multi_plain)
            if hasattr(K, "resid_multi"):
                run(f"B4 {opn} k={k} resid", K.resid_multi, [op, X, B],
                    K.resid_multi_plain)
                run(f"B4 {opn} k={k} update", K.gs_update_multi,
                    [op, X, B, w], K.gs_update_multi_plain)
            else:
                run(f"B4 {opn} k={k} unfused resid",
                    lambda: B - K.spmv_multi(op, X), [])
                run(f"B4 {opn} k={k} unfused update",
                    lambda: X + w * (B - K.spmv_multi(op, X)), [])
    return 0


if __name__ == "__main__":
    sys.exit(main())
