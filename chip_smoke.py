"""Smoke run of amg_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):

1. device: a CUDA card, its name and power limit (nvidia-smi), torch and
   CUDA versions, the native host-setup library;
2. build: compiles the DIA kernel (amg_tpu_torch/csrc/dia_spmv.cu) with nvcc;
3. kernel against plain: every epilogue (spmv, resid, update) and dtype
   pair on the 1,000,000-row poisson3d(100) level-0 operator (7 diagonals)
   and a random 40-diagonal band of 1,000,000 rows, held to the tolerances
   of tests/test_torch_dia.py and timed with CUDA events (device time per
   call from a flushed L2);
4. reference protocol: the four residual goldens in tests/data/golden/, in
   float64 on the card;
5. main path: the bench configuration at poisson3d(100) (1M rows) solved
   to 1e-8 on the card, checked on the host in float64, with every DIA
   kernel epilogue launched and the launches counted per operator shape;
6. main-path shapes: kernel against plain, held to the same tolerances and
   timed, on each DIA operator the solve used (the float32 level 0, the
   bfloat16 level 1, the float64 level-0 operator of defect correction),
   for every epilogue the solve launched on it.

The last two lines of standard output are one JSON object describing the
kernels (one entry per epilogue and operator of phase 6, with its
main-path launch count) and one with the device.  Imports torch, numpy,
scipy and amg_tpu_torch only.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(REPO, "tests", "data", "golden")
N_SIDE = 100               # poisson3d(100): 1,000,000 rows, 6,940,000 nnz
REPS = 21                  # timed calls per measurement (median reported)
SLEEP_CYCLES = 4_000_000   # ~2 ms of device spin before each timed call
FLUSH_BYTES = 256 << 20    # written before each timed call: evicts the L2
# relative tolerances (of max|Ax|), as in tests/test_torch_dia.py: summation
# order differs (the kernel also contracts multiply-adds into FMAs)
TOL = {torch.float32: 2e-6, torch.bfloat16: 1e-5, torch.float64: 1e-13}


def log(msg=""):
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# 1-2. device and build
# ---------------------------------------------------------------------------


def phase_device():
    import amg_tpu_torch  # noqa: F401  (fails here outside the repo)
    from amg_tpu_torch import native

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] {name}; count {torch.cuda.device_count()}")
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    check(native.lib is not None, "native host-setup library did not build")
    return name, smi


def phase_build():
    from amg_tpu_torch.ops import dia_kernel

    t0 = time.perf_counter()
    so = dia_kernel.build()
    dt = time.perf_counter() - t0
    log(f"[build] {os.path.relpath(so, REPO)} in {dt:.2f} s (nvcc, sm_90a)")


# ---------------------------------------------------------------------------
# 3. kernel against plain
# ---------------------------------------------------------------------------


def _time_ms(fn, flush):
    """Median device milliseconds per call over REPS calls, after warm-up.

    Before each call the L2 is flushed (a 256 MB write), as a call in the
    cycle meets it after other levels' traffic, and the stream is held
    busy by a device spin while the host enqueues the call: otherwise the
    CUDA events around a ~20 us kernel time the Python wrapper's host
    latency instead of the device work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.fill_(0)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _operators():
    """(label, offsets, float64 values (nd, pad)) of the two 1M-row
    operators: poisson3d(100)'s level 0 and a random 40-diagonal band."""
    import amg_tpu_torch as amg
    from amg_tpu_torch.sparse import Dia

    a = amg.poisson3d(N_SIDE)
    d = Dia.from_csr(a, dtype=torch.float64)
    yield "p3d100", d.offsets, d.vals
    g = torch.Generator().manual_seed(0)
    pad = a.n_rows
    offs = {0}
    while len(offs) < 40:
        offs.add(int(torch.randint(-20000, 20001, (1,), generator=g)))
    offs = tuple(sorted(offs))
    yield "band40", offs, torch.randn(len(offs), pad, generator=g,
                                      dtype=torch.float64)


def _compare(tag, gpu, ep, g, flush):
    """Run epilogue ``ep`` of the kernel wrapper and of its plain version on
    the same random vectors on the card, hold them to TOL and time both.
    Returns one result row (the launches made here are not the main path's).
    """
    from amg_tpu_torch.ops import dia_kernel as K

    fn, nargs = {"spmv": (K.spmv, 1), "resid": (K.resid, 2),
                 "update": (K.gs_update, 3)}[ep]
    plain = getattr(K, fn.__name__ + "_plain")
    nd, pad = gpu.vals.shape
    vdt = gpu.vals.dtype
    xdt = torch.float64 if vdt == torch.float64 else torch.float32
    args = [torch.randn(pad, generator=g, dtype=xdt).cuda()
            for _ in range(nargs)]
    want = plain(gpu, *args)
    got = fn(gpu, *args)
    torch.cuda.synchronize()
    scale = K.spmv_plain(gpu, args[0]).abs().max().item()
    err = (got - want).abs().max().item()
    ok = err <= TOL[vdt] * scale
    ms = _time_ms(lambda: fn(gpu, *args), flush)
    plain_ms = _time_ms(lambda: plain(gpu, *args), flush)
    vb = torch.tensor([], dtype=vdt).element_size()
    xb = torch.tensor([], dtype=xdt).element_size()
    # values once, x once, y written, plus b (resid) and w (update)
    nbytes = pad * (nd * vb + (1 + nargs) * xb)
    row = dict(op=tag, nd=nd, pad=pad, vals=str(vdt)[6:], x=str(xdt)[6:],
               epilogue=ep, max_abs_err=err, rel_err=err / scale,
               tol=TOL[vdt], ok=ok, ms=ms, plain_ms=plain_ms,
               gbps=nbytes / ms / 1e6, plain_gbps=nbytes / plain_ms / 1e6)
    log(f"[kernel] {tag:8s} nd={nd:2d} pad={pad:7d} {row['vals']:8s}/"
        f"{row['x']:7s} {ep:6s} err {err:.3e} "
        f"(rel {err / scale:.2e} <= {TOL[vdt]:g}: {ok})  "
        f"kernel {ms:.4f} ms {row['gbps']:.1f} GB/s  "
        f"plain {plain_ms:.4f} ms {row['plain_gbps']:.1f} GB/s")
    return row


def phase_kernels():
    from amg_tpu_torch.sparse import Dia

    rows = []
    g = torch.Generator().manual_seed(1)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for label, offs, vals64 in _operators():
        nd, pad = vals64.shape
        for vdt in (torch.float32, torch.bfloat16, torch.float64):
            gpu = Dia(vals64.to(vdt).cuda(), offs, (pad, pad), nd * pad)
            for ep in ("spmv", "resid", "update"):
                rows.append(_compare(label, gpu, ep, g, flush))
            del gpu
    del flush
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with plain version: {bad}")
    return rows


# ---------------------------------------------------------------------------
# 4. reference protocol
# ---------------------------------------------------------------------------


def phase_goldens():
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import dia_kernel as K

    mats = {
        "1138_bus": lambda: amg.read_mtx(
            os.path.join(REPO, "tests", "data", "1138_bus.mtx")),
        "p2d32": lambda: amg.poisson2d(32),
        "p2d64": lambda: amg.poisson2d(64),
        "p3d16": lambda: amg.poisson3d(16),
    }
    for name, make in mats.items():
        with open(os.path.join(GOLD, f"resid_{name}.json")) as f:
            gold = json.load(f)
        a = make()
        before = dict(K.launches)
        ones = np.ones(a.n_rows)
        _, info = amg.solver_amg(a, ones, ones, amg.AMGParams(verbose=0),
                                 log=lambda *_: None, device="cuda")
        got, want = np.array(info.residuals), np.array(gold["residuals"])
        worst = float(np.max(np.abs(got - want) / np.abs(want))) \
            if got.size == want.size else float("inf")
        f64 = {e: K.launches[e] - before[e] for e in K.launches}
        log(f"[golden] {name}: nits {info.nits} (golden {gold['nits']}), "
            f"worst rel diff {worst:.2e}, rres {info.rres:.3e}, "
            f"f64 DIA launches {f64}")
        check(info.nits == gold["nits"] and worst <= 1e-3,
              f"golden {name} not reproduced")
        if name.startswith("p"):
            check(f64["update"] > 0 and f64["resid"] > 0,
                  f"golden {name} did not run the f64 DIA kernel")


# ---------------------------------------------------------------------------
# 5. main path
# ---------------------------------------------------------------------------


def phase_main_path():
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import dia_kernel as K

    a = amg.poisson3d(N_SIDE)
    pars = amg.AMGParams(
        dtype="float32", refine=True, accel="none",
        smoother=amg.SmootherType.GS,
        coarse_smoother=amg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="bfloat16", coarse_sparsify=0.005,
        sparsify_from_level=2, coarse_stop_rows=3500, tol=1e-8, max_it=60,
        verbose=0, embed_levels=0, use_well="off", use_banded="off")
    b = np.ones(a.n_rows)
    log(f"[main] poisson3d({N_SIDE}): {a.n_rows} rows, {a.nnz} nnz")

    for e in K.launches:
        K.launches[e] = 0
    K.launches_by_shape.clear()
    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, pars, device="cuda", log=lambda *_: None)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    launches = dict(K.launches)
    by_shape = dict(K.launches_by_shape)

    for l, lv in enumerate(solver.mg.levels):
        nd = f" nd={lv.a.n_diags}" if isinstance(lv.a, amg.Dia) else ""
        log(f"[main] level {l}: {lv.n} rows, pad {lv.pad}, "
            f"{type(lv.a).__name__} {str(lv.a.vals.dtype)[6:]}{nd}")
    true_rel = float(np.linalg.norm(b - a.matvec(x.astype(np.float64)))
                     / np.linalg.norm(b))
    log(f"[main] setup {setup_s:.2f} s (host hierarchy "
        f"{solver.host_hierarchy.setup_seconds:.2f} s), solve "
        f"{info.solve_seconds:.4f} s, nits {info.nits}, rres {info.rres:.3e}, "
        f"true rres (host f64) {true_rel:.3e}")
    log(f"[main] DIA kernel launches in the main path: {launches}")
    for (ep, vdt, xdt, nd, pad), n in sorted(by_shape.items(), key=str):
        log(f"[main]   {ep:6s} {str(vdt)[6:]}/{str(xdt)[6:]} nd={nd} "
            f"pad={pad}: {n}")
    check(np.all(np.isfinite(x)) and x.shape == (a.n_rows,),
          "solution not finite or wrong shape")
    check(true_rel < 1e-8 and info.nits <= pars.max_it,
          f"main path did not reach 1e-8 (true rres {true_rel:.3e})")
    check(all(launches[e] > 0 for e in ("update", "resid", "spmv")),
          f"main path missed a DIA kernel epilogue: {launches}")
    check(all(sum(n for k, n in by_shape.items() if k[0] == e) == launches[e]
              for e in launches), "per-shape launch counts do not add up")

    # a second, warm solve (not counted)
    _, info2 = solver.solve(b)
    torch.cuda.synchronize()
    log(f"[main] warm solve {info2.solve_seconds:.4f} s, nits {info2.nits}")
    return solver, by_shape, dict(setup_s=setup_s, solve_s=info.solve_seconds,
                                  warm_solve_s=info2.solve_seconds,
                                  nits=info.nits, true_rres=true_rel)


def phase_main_shapes(solver, by_shape):
    """Kernel against plain on the main path's own operators: every DIA
    operator the solve used (each DIA level, and the f64 level-0 operator
    of defect correction), at its own dtype and pad, for every epilogue the
    solve launched on it.  Returns one row per (epilogue, launch shape),
    with the main path's launch count."""
    from amg_tpu_torch.sparse import Dia

    ops = [(f"level{l}", lv.a) for l, lv in enumerate(solver.mg.levels)
           if isinstance(lv.a, Dia)]
    if isinstance(solver.a0_hi, Dia):
        ops.append(("a0_hi", solver.a0_hi))
    g = torch.Generator().manual_seed(2)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for (ep, vdt, xdt, nd, pad), n in sorted(by_shape.items(), key=str):
        match = [(tag, op) for tag, op in ops
                 if (op.vals.dtype, op.n_diags, op.padded_rows) == (vdt, nd, pad)
                 and (torch.float64 if vdt == torch.float64
                      else torch.float32) == xdt]
        check(match, f"no DIA operator of the solve has the launch shape "
                     f"{(ep, vdt, xdt, nd, pad)}")
        for tag, op in match:
            rows.append(dict(_compare(tag, op, ep, g, flush), launches=n))
    del flush
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with plain version on the main "
                   f"path's operators: {bad}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke run needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    phase_kernels()
    phase_goldens()
    solver, by_shape, _ = phase_main_path()
    rows = phase_main_shapes(solver, by_shape)
    del solver

    # one entry per (epilogue, operator) the main path launched the kernel
    # on: its launch count, error and times at that operator's own shape
    kernels = [{
        "name": f"dia_spmv.{r['epilogue']}[{r['op']} {r['vals']}/{r['x']} "
                f"nd={r['nd']} pad={r['pad']}]",
        "route": "cuda", "source": "amg_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "amg_tpu/ops/pallas_dia.py:117",
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"]} for r in rows]
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all; "
        f"card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
