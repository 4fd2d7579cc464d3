"""Smoke run of amg_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero):

1. device: a CUDA card, its name and power limit (nvidia-smi), torch and
   CUDA versions, the native host-setup library;
2. build: compiles the DIA kernel (amg_tpu_torch/csrc/dia_spmv.cu), the
   WEll kernels (amg_tpu_torch/csrc/well_spmv.cu) and the Krylov layer's
   scalar kernels and graph assembly (amg_tpu_torch/csrc/krylov_small.cu)
   and the bf16 Dense kernel D1 (amg_tpu_torch/csrc/dense_gemv.cu) with
   nvcc, in parallel;
3. kernel against plain: every epilogue (spmv, resid, update) of B1 and
   dtype pair on the 1,000,000-row poisson3d(100) level-0 operator (7
   diagonals) and a random 40-diagonal band of 1,000,000 rows, held to the
   tolerances of tests/test_torch_dia.py and timed with CUDA events
   (device time per call from a flushed L2);
4. reference protocol: the four residual goldens in tests/data/golden/, in
   float64 on the card;
5. main path: the bench configuration at poisson3d(100) (1M rows) solved
   to 1e-8 on the card, checked on the host in float64, with every DIA
   kernel epilogue launched and the launches counted per operator shape;
6. main-path shapes: kernel against plain, held to the same tolerances and
   timed, on each DIA operator the solve used (the float32 level 0, the
   bfloat16 level 1, the float64 level-0 operator of defect correction),
   for every epilogue the solve launched on it;
7. WEll kernels against plain: the level-0 operator of fem2d(1,000,000)
   after RCM, packed as WEll with f32 values, bf16 values and as the df64
   pair (its row-slice layout in row order), through B2 (f32, bf16) and
   B3 (df64), held to 2e-6, 1e-5 and 1e-13 of max|Ax| and timed beside
   the fastest of two torch sparse CSR products (int64 and int32
   indices; f32 values for B2, f64 for B3) on the same operator;
8. unstructured main path: fem2d(1,000,000) with bench.py's matrix-class
   defaults (f32 cycles, FCG in f64, GS on level 0 and Chebyshev below,
   f32 coarse operators, no sparsification) and WEll on, solved to 1e-8
   (host-verified in float64), with B2's ``spmv`` launched on level 0's A
   and on a WEll P/R, its ``gs`` class update on level 0, B3 launched,
   level 0 sharing the df64 operator's row-slice structure and hi plane,
   and every WEll pack kept on the host (the card holds the row-slice
   layouts only); logs the device memory the solver holds after setup,
   the layouts' share of it and the seconds to derive level 0's layout;
9. unstructured main-path shapes: kernel against plain, timed as in phase
   7, on every WEll operator of that solve the kernels were launched on,
   and the ``gs`` entry against its plain version on every GS class of
   level 0;
10. multi-rhs kernel B4 against plain: phase 5's level-0 (f32, nd=7) and
   level-1 (bf16, nd=23) operators and phase 3's 40-diagonal band in bf16
   (bf16 products) and f64, the product at k = 1, 4 and 16 right-hand
   sides and the ``resid`` and ``update`` epilogues at k = 1 and 16, held
   to the tolerances of phase 3 and timed beside a torch sparse CSR call
   on the same operator (product ``A @ X.T``, residual ``addmm(B.T, A,
   X.T, alpha=-1)``; the fastest of int64 and int32 indices, X.T column-
   or row-major; the update has no one call);
11. batched main path: phase 5's solver runs ``solve_batched`` on 16
   seeded random right-hand sides to 1e-6, every column checked on the
   host in float64, with B4's ``update`` epilogue launched on level 0,
   its ``resid`` on every DIA level, its product on every DIA level, and
   no B1 launch;
12. one column: ``solve_batched`` on the first column (B4 at k = 1)
   against the single-rhs f32 solve of the same hierarchy (B1's
   epilogues): iterations within 1, residual histories within rtol 1e-3
   plus 2e-8 * ||b||; B4 at k = 1 sums in B1's order and fuses B1's
   update, so the gap left comes from the Ell and Dense levels, which sum
   a batch in another order than one vector;
13. structured "auto": phase 5's parameters with ``use_well`` and
   ``use_banded`` on "auto", the port's layout of the benchmark's
   ``p3d7_1m`` (Dia, Dia, WEll, WEll, Dense at 7,168 x 7,168, Dense:
   level 3's band of nb 17, which amg_tpu keeps, declined and counted in
   ``amg.setup.banded_declined``), solved to 1e-8 (host-verified) through
   B1 and B2; levels 2-3's products (WEll) timed beside phase 5's Ell and
   Dense products on the same levels, and level 3's B2 beside the cuBLAS
   product of the band "on" keeps there; device memory and warm solve
   beside phase 5's; kernel against plain on every DIA and WEll launch
   shape of its solve;
14. structured embedded: phase 13's parameters with ``embed_levels=8``
   and ``use_banded`` on "on", amg_tpu's layout (levels 0-2 as Dia over one pad of 1,024,000 rows, bf16 embedded
   operators of 19 and 199 diagonals, P/R of 7, 19 and 156, then
   BandedBlocks, Dense, Dense) solved to 1e-8, B1 against plain on every
   embedded operator and epilogue the solve launched (timed beside the
   torch sparse CSR call); ``solve_batched`` of 16 seeded columns to 1e-6
   through B4 alone, B4 against plain at its launch shapes (the torch
   CSR yardstick holds the embedded operators' nonzero entries); one solve with
   ``embed_boundary="compact"`` (the member_idx gather and scatter);
15. unstructured "auto": phase 8's parameters with ``use_well`` and
   ``use_banded`` on "auto", the port's layout of the benchmark's
   ``fem2d_1m`` (WEll levels 0-7, Dense: the bands of levels 4-7, nb 9,
   7, 5, 3, which amg_tpu keeps, declined and counted), FCG to 1e-8;
   each of levels 4-7's B2 product timed beside phase 8's Ell or Dense
   product on the same level and beside the cuBLAS product of the band
   "on" keeps there; kernel against plain on every WEll launch shape of
   its solve;
16. nonsymmetric GMRES: the 2-D upwind convection-diffusion operator of
   tests/test_solve.py:618-636 (vel 20) on a 1000 x 1000 grid (1,000,000
   rows, 4,996,000 nnz), ``AMGParams(accel="gmres", tol=1e-8)`` with the
   defaults otherwise (f64 cycles, "auto" formats), solved to a
   host-checked true residual below 1e-8 in at most 40 GMRES iterations,
   with B1's three epilogues and the f64 Givens and back-substitution
   kernels launched; the whole GMRES one CUDA graph (while nodes over
   restarts and over Arnoldi steps, the step indexing the basis through a
   device counter), built by the cold solve and replayed by the warm one,
   0 host reads of its loops (gated), against the same program's host
   loops on the card (equal its, x bit for bit); logs the graph's nodes,
   build seconds and pool MiB, cold and warm seconds, the Arnoldi steps
   and the MiB of the GMRES basis; kernel against plain on every launch
   shape of the solve;
17. the reference's coarsest solver: phase 13's parameters and host
   hierarchy with ``coarsest_solver=KRYLOV`` (CG to ctol = 1e-9, out of
   f32's reach, then GMRES), solved to 1e-8 (host-checked) through B1 and
   B2 in 8 cycles (within 1), each coarsest solve one CUDA graph of
   while and if nodes (``krylov.CoarsestKrylov``; CG's while node, then
   an if node on its status around GMRES's while node) built at first
   use: per coarsest solve its CG iterations and status, GMRES's
   iterations, ms and host reads (0: gated), one cycle under
   ``torch.cuda.set_sync_debug_mode("error")``, the graph against the
   plain host loops on the card on one coarsest right-hand side (equal
   statuses and iterations, x within 1e-6 of ||x||, bit identity
   logged), the graph's nodes, build seconds and pool MiB, warm solve
   seconds against the host loops'; the public ``cg``, ``gmres`` and
   ``fcg`` (one graph built per call, no host read) timed against their
   host loops on that right-hand side (``fcg`` gated bit for bit);
   ``solve_pgmres`` on the same hierarchy (f64 GMRES
   around the f32 cycles: its Arnoldi step, holding the coarsest solve's
   while and if nodes, is captured in place in the GMRES graph), 0 host
   reads, graph = host loops bit for bit, cold and warm seconds;
   krylov_small.cu's Givens step and back-substitution against their
   plain versions on 120 seeded Arnoldi columns in f32 and f64 (within 4
   ulp) and timed beside an empty one-warp launch (the latency floor),
   the back-substitution also against ``torch.linalg.solve_triangular``
   (gated: the kernel is faster); then ``solve_batched`` of 16
   seeded columns to 1e-6 through B4 in 6 cycles (within 1; one CG while
   node over the columns, then per column an if node around GMRES),
   gated the same way, every column checked on the host, per-column
   coarsest statuses logged, and one of 4 columns, whose coarsest solve
   replaces the first in the hierarchy's cache; kernel against plain at
   every launch shape of both solves;
18. the SPMD solve on a ring of row shards: poisson3d(100) in
   bench_dist.py's spmd-cg mode (f32 cycles, FCG in f64, Chebyshev below
   level 0, bf16 coarse operators; ``embed_levels`` 8) with
   ``SpmdAMGSolver`` on ``make_mesh(4)``: 4 shards of 256,000 rows on the
   one card, solved to a host-checked 1e-8 in FCG iterations within 1 of
   the single-device ``solve_pcg`` of the same parameters; B1's window
   entry launched on every sharded operator (A, P and R of the embedded
   levels, the f64 level-0 operator) and no single-device B1 launch on a
   sharded level; the window entry against its plain version at every
   launch shape, timed beside the whole ring product, the single-device
   B1 product of the same operator, the torch sparse CSR product and its
   bound; then the same solve inside a one-rank NCCL process group
   (``multihost.initialize``): its steps replayed CUDA graphs with the
   NCCL ``all_reduce`` captured (route "graph"), equal to its eager steps
   bit for bit, and the same iterations and x as the in-process run bit
   for bit; nodes, build s, pool MiB and warm s of both routes logged.
   Then the sharded Krylov path on the same ring (``ring_krylov``): the
   public ``cg``, ``gmres`` (GMRES(30), Jacobi-preconditioned) and
   ``fcg`` with the mesh's ``psum`` on poisson3d(100)'s f64 ring product
   at full width (B1's window entry), each one CUDA graph built by its
   call, gated against its host loop (``*_plain``): route "graph", 0
   host reads, status, iterations and x bit for bit, a host f64 true
   rres below 1e-8; the counts set to 0 before the three graph solves
   and read after (the window entry on the f64 operator,
   K1 and K2 on gmres's steps and restart ends); the window entry
   against plain on that operator; the same three in the one-rank NCCL
   group (its ``all_reduce`` inside the while bodies), bit for bit with
   the in-process run; route, host reads, nodes, build s and seconds of
   both routes logged;
19. the general SPMD mode: fem2d(1,000,000) (phases 7-9's matrix) in
   bench_dist.py's fem2d parameters (f32 cycles, FCG in f64, Chebyshev
   below level 0, f32 coarse operators, WEll from 1,024 rows) with
   ``SpmdAMGSolver`` on ``make_mesh(4)``, twice: ``use_banded`` on "on"
   (WEll levels 0-5, BandedBlocks 6 with Ell transfers: Es = 6 and the
   all-gather boundary, which only a band below the sharded levels
   gives; "auto" declines that band) and "off" (Es = 5, the ring-R boundary); each
   solved to a host-checked 1e-8 in FCG iterations within 1 of the
   single-device ``solve_pcg`` with ``dist_devices=4`` packing, with B2's
   window entry launched on every sharded WEll operator (A, P, R of levels
   0..Es), B3's on the df64 operator of FCG and no single-device B2/B3
   launch on a sharded operator; logs Es, the boundary, each level's
   format and placement, the halo widths per operator, window launches,
   ring products, halo MiB, all-gathers and psums per FCG iteration,
   setup, device MiB and cold and warm solves beside the single-device
   ones; each window entry against its plain version at every launch
   shape, timed beside the whole ring product, the single-device B2/B3 on
   the same operator, the fastest torch sparse CSR product of its rows
   and its bound (B2/B3's bytes with x as the haloed window); then the
   "on" solve inside a one-rank NCCL group, gated as phase 18's (route
   "graph" with its ``all_reduce`` and all-gathers captured, graph =
   eager steps, x = the in-process run's, bit for bit);
20. the GSPMD solver: poisson3d(100) in bench_dist.py's gspmd parameters
   (f32 cycles with f64 defect correction, Chebyshev below level 0, bf16
   coarse operators, WEll on "auto" from 65,536 rows, no Krylov
   acceleration) with ``DistAMGSolver`` on ``make_mesh(4)``, beside the
   single-device ``solve_refined`` with ``dist_devices=4`` packing: a
   host-checked true rres below 1e-8 in its cycles within 1; logs each
   level's formats and placement, the launches per solve of B1's window
   entry and of B2's ``col0 = 0`` entry (the all-gather product), ring
   and all-gather products, all-gathers and psums per cycle, device MiB,
   cold and warm seconds; B1's window entry launched on every sharded Dia
   level and on ``a0_hi``, B2's on every sharded WEll operator, no
   single-device B1/B2 launch on a sharded operator; each window entry
   against its plain version at every launch shape, timed beside the
   single-device kernel on the same operator (``_compare_window``,
   ``_compare_well_window`` with the whole vector); then the same solve
   in a one-rank NCCL group, gated as phase 18's;
21. the device PMIS splitter: ``pmis_split_device`` on the strength graph
   of fem2d(1,000,000, seed=0)'s level 0 on the card and on the CPU
   (partitions equal bit for bit) beside the host ``pmis_split``, each
   with no undecided point and a C point among the strong links of every
   F point that has them (the strongly linked C-C pairs, which PMIS
   admits across rounds, are logged); then phase 8's setup with
   ``cs_type=PMIS``, which takes the device splitter from 262,144 rows,
   solved with FCG beside the same setup on the host splitter: both
   converged, iterations within 20%;
22. ``solve_jit``, the solve whose loop stays on the card: phase 13's
   host hierarchy (poisson3d(100), "auto": Dia, Dia, WEll, WEll, Dense,
   Dense) and phase 15's (fem2d(1,000,000), WEll 0-7, Dense) with f32 cycles to 1e-6 and no defect
   correction or Krylov acceleration (``jit_pars``; b = A x for a seeded
   x, ``jit_rhs``), each ``solve_jit`` a CUDA graph of one masked cycle
   step replayed in blocks (B1's update, resid and spmv and B2's spmv in
   the structured graph; B2's spmv and its ``gs`` class update on level
   0's 14 classes in the unstructured one); gates against ``solve`` on
   the same solver: equal iterations, histories within rtol 1e-5 (and
   whether they are bit-identical), x within 1e-6 * ||x||, a host f64
   true rres below 1.5e-6, one replay from a fixed x equal to one eager
   step; logs capture seconds, device MiB after the cold call against
   before, blocks and host reads per solve, warm seconds of both entries
   (median of 3); kernel against plain at every launch shape of both
   graphs (tags ``j-``, ``jf-``; a graph's launches are counted as the
   capture's times the replays).  Then phase 17's KRYLOV hierarchy with
   the same gates: its step graph holds the coarsest solve's while and
   if nodes.
23. the bf16 Dense kernel D1, run just after phase 13 on its solver: one
   warm solve with the counts reset gives D1's main-path launches, on
   the bf16 Dense levels that are not the coarsest only (level 4, padded
   to 7,168 x 7,168 below the WEll level 3), 7 per cycle
   (Chebyshev of degree 3 before and after the coarse correction, and
   the residual); then at every bf16 Dense level's shape, D1 against its
   plain version (values widened to f32, cuBLAS's f32 gemv) within the
   f32 summation bound (2 n 2^-24 sum_c |a_rc x_c| per row, n columns),
   timed beside its bound, the plain version and one PyTorch call, the
   f32 gemv on an f32 copy made beforehand (the library yardstick, which
   reads twice D1's bytes);

The solves of phases 5, 8, 11-15, 17-20 and 22 run each step of their
host loops (a cycle and its residual norm, a defect-correction step, an
FCG iteration with its residual replacement and true norm, a batched
cycle) as a CUDA graph captured at the entry's first call and replayed
(``solver.steps``; the rings on the one card take this route, alone and
in an NCCL group): each main path's launch counts hold the graphs'
warm-up steps and their replays.  Phases 5, 8, 11, 13-15 and 18-20 gate
the graph route against the same solve's eager steps (``eager=True``):
equal iterations, histories and x bit for bit; they log each step
graph's nodes, kernel launches per replay, replays, build seconds and
pool MiB, and the warm seconds of both routes.  Phase 17 times its
coarsest solves on the eager steps, gated equal to the graph route.

Each kernel result carries its bound: the larger of the bytes it must
move (each input read once, each output written once) over the H100's
3.35 TB/s and its flops over the card's peak for their type (67 TFLOP/s
f32, 34 TFLOP/s f64, NVIDIA's H100 SXM data sheet).  The last three lines
of standard output are the card's name and power limit as nvidia-smi
gives them, one JSON object describing the kernels (one entry per
epilogue and operator of phases 6 and 9, per launch shape of phase 11,
and per launch shape and operator of phases 13-20 and 22, and one per
krylov_small.cu kernel and dtype (f32 from phase 17, f64 from phases 16
and 18), each with its main-path launch count;
phase 20's rows join those of phases 18 and 19) and one with the
device.  Imports
torch, numpy, scipy and amg_tpu_torch only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(REPO, "tests", "data", "golden")
N_SIDE = 100               # poisson3d(100): 1,000,000 rows, 6,940,000 nnz
REPS = 21                  # timed calls per measurement (median reported)
SLEEP_CYCLES = 4_000_000   # ~2 ms of device spin before each timed call
FLUSH_BYTES = 256 << 20    # written before each timed call: evicts the L2
FEM_ROWS = 1_000_000       # fem2d(1,000,000): the unstructured main path
N_RHS = 16                 # right-hand sides of the batched main path
BATCH_TOL = 1e-6           # its tolerance (f32 cycles, no defect correction)
# phase 12's history atol, of ||b||: the Ell and Dense levels sum a batch
# in another order than one vector (on the DIA levels B4 at k = 1 sums and
# updates as B1 does).  The gap measured on an H100 80GB HBM3 (700 W) was
# 5.5e-9 while the batched update was unfused; phase 12 logs it
ONE_COL_ATOL = 2e-8
# relative tolerances (of max|Ax|), as in tests/test_torch_dia.py and
# tests/test_torch_well.py: summation order differs (the kernels also
# contract multiply-adds into FMAs)
TOL = {torch.float32: 2e-6, torch.bfloat16: 1e-5, torch.float64: 1e-13}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def log(msg=""):
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _settle_counts():
    """Add the kernel launches that the Krylov loops' CUDA graphs made
    since they were last settled to the counters (just after the run
    whose counts are read)."""
    from amg_tpu_torch.solve import loop_graph

    loop_graph.settle()


def _reset_counts():
    """Set every kernel launch count, and the Krylov solvers' counts of
    host reads and iterations, to 0 (just before a main path runs); the
    graphs' launches before it are settled first, so none of them lands
    in the run that follows."""
    from amg_tpu_torch.ops import launch_counts
    from amg_tpu_torch.solve import krylov

    _settle_counts()
    for K in launch_counts.MODULES:
        for e in K.launches:
            K.launches[e] = 0
        K.launches_by_shape.clear()
    for e in krylov.counts:
        krylov.counts[e] = 0


# ---------------------------------------------------------------------------
# step graphs: each step of a host loop one replayed CUDA graph
# ---------------------------------------------------------------------------


def _step_graphs(tag, solver, names=None):
    """Log each step graph of ``solver`` (``solver.steps``; ``names``: those
    steps only): nodes, kernel
    launches per replay, replays, build seconds (two eager warm-ups, the
    second under ``set_sync_debug_mode("error")``, capture and
    instantiation) and the MiB the capture took from the solver's pool;
    every step must have been captured (a step that read the host would
    have raised in its second warm-up, and a replay reads nothing)."""
    from amg_tpu_torch.ops import launch_counts

    out = {}
    for name, g in solver.steps.graphs.items():
        if names is not None and name not in names:
            continue
        check(g.graph is not None and g.replays > 0,
              f"{tag}: step {name} did not run as a replayed CUDA graph")
        kernels = sum(sum(g.per_step.get(K, ({},))[0].values())
                      for K in launch_counts.MODULES)
        out[name] = dict(nodes=g.nodes, kernels=kernels, replays=g.replays,
                         build_s=g.build_seconds,
                         pool_mib=g.pool_bytes / 2**20)
        log(f"[{tag}] step graph {name!r}: {g.nodes} nodes, {kernels} "
            f"port kernel launches per replay, {g.replays} replays, built "
            f"in {g.build_seconds:.3f} s, pool +{g.pool_bytes / 2**20:.1f} "
            f"MiB; 0 host reads inside a step")
    return out


def _graph_vs_eager(tag, solver, solve, b, got, names=None, **kw):
    """The graph route of ``solve`` (its cold result ``got = (x, info)``,
    which built the step graphs) against the eager route on the card
    (``eager=True``: the same steps on fresh tensors): equal iterations,
    histories and x bit for bit (the same kernels in the same order);
    logs the step graphs and the warm seconds of both routes (median of
    JIT_REPS each).  The launches of these runs land after the main
    path's counts were read."""
    check(solver.steps.route == "graph",
          f"{tag}: step route {solver.steps.route}")
    eager = solve(b, eager=True, **kw)
    torch.cuda.synchronize()
    _same_solve(tag, got, eager)
    graphs = _step_graphs(tag, solver, names)
    warm_graph = _median_s(lambda: solve(b, **kw))
    warm_eager = _median_s(lambda: solve(b, eager=True, **kw))
    log(f"[{tag}] warm (median of {JIT_REPS}) graph {warm_graph:.4f} s, "
        f"eager {warm_eager:.4f} s ({warm_eager / warm_graph:.2f}x); pool "
        f"{sum(g['pool_mib'] for g in graphs.values()):.1f} MiB")
    return dict(graphs=graphs, warm_graph_s=warm_graph,
                warm_eager_s=warm_eager)


def _same_solve(tag, got, eager):
    """A graph-route solve ``got = (x, info)`` and an eager one of the
    same right-hand side: equal iterations, histories and x bit for bit."""
    (x, info), (xe, ie) = got, eager
    same = (info.nits == ie.nits and info.residuals == ie.residuals
            and np.array_equal(x, xe))
    gap = float(np.abs(x - xe).max() / max(np.abs(xe).max(), 1e-300))
    log(f"[{tag}] graph route against the eager steps on the card: its "
        f"{info.nits} / {ie.nits}; histories and x bit-identical: {same} "
        f"(max |dx| {gap:.3e} of max|x|)")
    check(same, f"{tag}: graph route ({info.nits} its) and eager steps "
                f"({ie.nits} its) differ, x gap {gap:.3e}")


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
    """Every kernel source, one nvcc each, started together."""
    from amg_tpu_torch.ops import launch_counts

    t0 = time.perf_counter()
    mods = launch_counts.MODULES
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        futures = [pool.submit(m.build) for m in mods]
        sos = [f.result() for f in futures]
    dt = time.perf_counter() - t0
    log(f"[build] {', '.join(os.path.relpath(so, REPO) for so in sos)} in "
        f"{dt:.2f} s (nvcc, sm_90a)")


def _bound(nbytes, nflops, flop_dtype):
    """(bound_ms, bound_by): the least time for the work on an H100."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nflops / PEAK_FLOPS[flop_dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _csr_on_card(a, dtype):
    """A host CSR as a torch sparse CSR tensor on the card (the library
    yardstick; the port never calls it)."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(np.asarray(a.indptr, dtype=np.int64)),
        torch.from_numpy(np.asarray(a.indices, dtype=np.int64)),
        torch.from_numpy(np.asarray(a.data)).to(dtype),
        size=a.shape).cuda()


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
    yield ("band40",) + _band40(a.n_rows)


def _band40(pad):
    """(offsets, float64 values (40, pad)) of a random 40-diagonal band,
    offsets in [-20000, 20000]."""
    g = torch.Generator().manual_seed(0)
    offs = {0}
    while len(offs) < 40:
        offs.add(int(torch.randint(-20000, 20001, (1,), generator=g)))
    offs = tuple(sorted(offs))
    return offs, torch.randn(len(offs), pad, generator=g, dtype=torch.float64)


def _compare(tag, gpu, ep, g, flush, make_lib=None):
    """Run epilogue ``ep`` of the kernel wrapper and of its plain version on
    the same random vectors on the card, hold them to TOL and time both;
    with ``make_lib`` (the operator as a torch sparse CSR tensor on the card
    in a given dtype), also time the torch sparse CSR call that computes
    the same function (spmv: ``A @ x``; resid: ``addmv(b, A, x,
    alpha=-1)``; update: none).  Returns one result row (the launches made
    here are not the main path's)."""
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
    lib_ms = None
    if make_lib is not None and ep != "update":
        lib = make_lib(xdt)
        n, m = lib.shape
        if ep == "spmv":
            lib_ms = _time_ms(lambda: lib @ args[0][:m], flush)
        else:
            lib_ms = _time_ms(lambda: torch.addmv(args[1][:n], lib,
                                                  args[0][:m], alpha=-1),
                              flush)
        del lib
    vb = torch.tensor([], dtype=vdt).element_size()
    xb = torch.tensor([], dtype=xdt).element_size()
    # values once, x once, y written, plus b (resid) and w (update)
    nbytes = pad * (nd * vb + (1 + nargs) * xb)
    bound_ms, bound_by = _bound(nbytes, pad * (2 * nd + 2 * (nargs - 1)),
                                xdt)
    row = dict(op=tag, nd=nd, pad=pad, vals=str(vdt)[6:], x=str(xdt)[6:],
               epilogue=ep, max_abs_err=err, rel_err=err / scale,
               tol=TOL[vdt], ok=ok, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               gbps=nbytes / ms / 1e6, plain_gbps=nbytes / plain_ms / 1e6)
    lib_txt = f"  torch CSR {lib_ms:.4f} ms" if lib_ms is not None else ""
    log(f"[kernel] {tag:8s} nd={nd:3d} pad={pad:7d} {row['vals']:8s}/"
        f"{row['x']:7s} {ep:6s} err {err:.3e} "
        f"(rel {err / scale:.2e} <= {TOL[vdt]:g}: {ok})  "
        f"kernel {ms:.4f} ms {row['gbps']:.1f} GB/s  "
        f"plain {plain_ms:.4f} ms {row['plain_gbps']:.1f} GB/s  "
        f"bound {bound_ms:.4f} ms ({bound_by}){lib_txt}")
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


def structured_pars(amg):
    """bench.py's defaults (bench.py:44, :106-184) at 1M rows with WEll,
    BandedBlocks and embedding off, as phases 5-12 have run them since the
    first port (phases 13-14 turn them on)."""
    return amg.AMGParams(
        dtype="float32", refine=True, accel="none",
        smoother=amg.SmootherType.GS,
        coarse_smoother=amg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="bfloat16", coarse_sparsify=0.005,
        sparsify_from_level=2, coarse_stop_rows=3500, tol=1e-8, max_it=60,
        verbose=0, embed_levels=0, use_well="off", use_banded="off")


def phase_main_path():
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import dia_kernel as K

    a = amg.poisson3d(N_SIDE)
    pars = structured_pars(amg)
    b = np.ones(a.n_rows)
    log(f"[main] poisson3d({N_SIDE}): {a.n_rows} rows, {a.nnz} nnz")

    _reset_counts()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, pars, device="cuda", log=lambda *_: None)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mem = torch.cuda.memory_allocated() - mem0
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
        f"{solver.host_hierarchy.setup_seconds:.2f} s), device memory held "
        f"after setup {mem / 2**20:.1f} MiB, solve "
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
    steps = _graph_vs_eager("main", solver, solver.solve, b, (x, info))
    return solver, by_shape, dict(setup_s=setup_s, solve_s=info.solve_seconds,
                                  warm_solve_s=info2.solve_seconds,
                                  nits=info.nits, true_rres=true_rel,
                                  mib=mem / 2**20, steps=steps)


def _one_row(rows, launches):
    """One result row per launch shape: the counts are kept per shape, and
    operators of one dtype, nd and pad (an embedded level's A, P and R
    often match) share them.  Every operator was compared; the row names
    them all, takes the worst error and the slowest operator's times, and
    carries the shape's main-path launch count."""
    row = dict(max(rows, key=lambda r: r["ms"]),
               op="+".join(r["op"] for r in rows), launches=launches)
    row.update(max_abs_err=max(r["max_abs_err"] for r in rows),
               rel_err=max(r["rel_err"] for r in rows),
               ok=all(r["ok"] for r in rows))
    return row


def _dia_ops(solver):
    """(tag, Dia operator, maker of its torch sparse CSR twin on the card)
    of every DIA operator of a solver: each level's A, P and R (P and R
    are Dia on fine-grid-embedded levels) and the f64 level-0 operator of
    defect correction.  A compact level's twin comes from its host CSR,
    an embedded operator's from its nonzero diagonal entries.  Tags start
    with "level" for a level's A, the one operator the residual and
    update epilogues run on."""
    from amg_tpu_torch.sparse import Dia

    hh = solver.host_hierarchy
    ops = []
    for l, lv in enumerate(solver.mg.levels):
        for name in ("a", "p", "r"):
            op = getattr(lv, name)
            if not isinstance(op, Dia):
                continue
            embedded = l > 0 and lv.pad == solver.pad
            if name == "a" and not embedded:
                make = (lambda xdt, m=hh.a[l]: _csr_on_card(m, xdt))
            else:
                make = (lambda xdt, op=op: _dia_csr_on_card(op, xdt))
            ops.append((f"level{l}" if name == "a" else f"{name.upper()}{l}",
                        op, make))
    if isinstance(solver.a0_hi, Dia):
        ops.append(("a0_hi", solver.a0_hi,
                    lambda xdt: _csr_on_card(hh.a[0], xdt)))
    return ops


def phase_main_shapes(solver, by_shape, prefix=""):
    """Kernel against plain on the main path's own operators: every DIA
    operator the solve used (each DIA level's A, and P/R where they are
    Dia, and the f64 level-0 operator of defect correction), at its own
    dtype and pad, for every epilogue the solve launched on it.  Returns
    one row per (epilogue, launch shape) with its main-path launch count
    (:func:`_one_row`); ``prefix`` starts every operator's tag."""
    ops = _dia_ops(solver)
    g = torch.Generator().manual_seed(2)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for (ep, vdt, xdt, nd, pad), n in sorted(by_shape.items(), key=str):
        match = [(tag, op, make) for tag, op, make in ops
                 if (op.vals.dtype, op.n_diags, op.padded_rows) == (vdt, nd, pad)
                 and (torch.float64 if vdt == torch.float64
                      else torch.float32) == xdt
                 and (ep == "spmv" or tag.startswith("level"))]
        check(match, f"no DIA operator of the solve has the launch shape "
                     f"{(ep, vdt, xdt, nd, pad)}")
        rows.append(_one_row([_compare(prefix + tag, op, ep, g, flush,
                                       make_lib=make)
                              for tag, op, make in match], n))
    del flush
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with plain version on the main "
                   f"path's operators: {bad}")
    return rows


# ---------------------------------------------------------------------------
# 7-9. the unstructured path: WEll kernels B2, B3 and FCG
# ---------------------------------------------------------------------------


def unstructured_pars(amg):
    """bench.py's matrix-class defaults (bench.py:115-184) with WEll on and
    BandedBlocks off, as phases 7-9 have run them (phase 15 turns both to
    "auto")."""
    return amg.AMGParams(
        dtype="float32", refine=True, accel="cg",
        smoother=amg.SmootherType.GS,
        coarse_smoother=amg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="float32", coarse_sparsify=0, coarse_stop_rows=3500,
        tol=1e-8, max_it=60, verbose=0, use_well="on", use_banded="off",
        embed_levels=0)


def _lib_variants(csr, xdt):
    """The operator's host ``csr`` as torch sparse CSR tensors on the card
    with int64 and with int32 indices (the library yardstick)."""
    lib = _csr_on_card(csr, xdt)
    return {"int64": lib, "int32": _int32_csr(lib)}


def _layout_bytes(op, df64, n_x, xb, first=0, n=None):
    """Bytes the row-slice kernel must move over slices ``[first, first +
    n)`` (default all): per nonzero its value(s) and 4 B column, per slot
    row its length and output row (4 B each), the slices' pointers, x
    once (``n_x`` entries) and y once (one per slot row with a row)."""
    from amg_tpu_torch.sparse import row_slices_bytes

    s = op.rows
    n = s.n_slices - first if n is None else n
    nnz = int(s.row_len[first * 32:(first + n) * 32].sum())
    vb = 8 if df64 else s.vals.element_size()
    rows = int((s.row_idx[first * 32:(first + n) * 32] >= 0).sum())
    return row_slices_bytes(nnz, vb, n, n_x, rows, xb), nnz


def _compare_well(tag, op, entry, n_x, csr, g, flush):
    """The row-slice kernel B2 (``entry="spmv"``) or B3 (``"df64"``)
    against its plain version on one WEll operator, on a random x of
    length ``n_x`` (the length the solve gives it), held to TOL of
    max|Ax|; timed beside its plain version and the torch sparse CSR
    product of the operator's host ``csr`` with int64 and int32 indices
    (f32 values for B2, f64 for B3; the fastest is the library time).
    Returns one result row."""
    from amg_tpu_torch.ops import well_kernel as K

    df64 = entry == "df64"
    fn, plain = ((K.spmv_df64, K.spmv_df64_plain) if df64
                 else (K.spmv, K.spmv_plain))
    vdt = op.vals.dtype
    xdt = torch.float64 if (df64 or vdt == torch.float64) else torch.float32
    tol = TOL[torch.float64 if df64 else vdt]
    x = torch.randn(n_x, generator=g, dtype=xdt).cuda()
    want = plain(op, x)
    got = fn(op, x)
    torch.cuda.synchronize()
    check(got.dtype == xdt and got.shape == want.shape,
          f"{tag}: kernel output {got.dtype} {tuple(got.shape)}")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    ok = err <= tol * scale
    ms = _time_ms(lambda: fn(op, x), flush)
    plain_ms = _time_ms(lambda: plain(op, x), flush)
    xs = x[: csr.shape[1]]
    lib_variants = {idx: _time_ms(lambda lib=lib: lib @ xs, flush)
                    for idx, lib in _lib_variants(csr, xdt).items()}
    lib_ms = min(lib_variants.values())
    xb = x.element_size()
    n_xr = min(n_x, op.pad_cols)
    nbytes, nnz = _layout_bytes(op, df64, n_xr, xb)
    bound_ms, bound_by = _bound(nbytes, 2 * nnz, xdt)
    s = op.rows
    row = dict(op=tag, entry=entry, vals=str(vdt)[6:], x=str(xdt)[6:],
               rows=op.n_rows, nnz=nnz, n_x=n_x, classes=s.classes,
               slices=s.n_slices, fill=nnz / max(s.n_stored, 1),
               slot_fill=nnz / op.vals.numel(), max_abs_err=err,
               rel_err=err / scale, tol=tol, ok=ok, ms=ms, plain_ms=plain_ms,
               lib_ms=lib_ms, lib_variants=lib_variants, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, gbps=nbytes / ms / 1e6)
    log(f"[well] {tag:10s} {entry:4s} {row['vals']:8s}/{row['x']:7s} "
        f"rows={op.n_rows} nnz={nnz} slices={s.n_slices} fill "
        f"{row['fill']:.3f} ({nbytes / 1e6:.1f} MB; WEll pack S="
        f"{op.n_slots} fill {row['slot_fill']:.3f}) err {err:.3e} (rel "
        f"{err / scale:.2e} <= {tol:g}: {ok})  kernel {ms:.4f} ms "
        f"{row['gbps']:.1f} GB/s  plain {plain_ms:.4f} ms  torch CSR "
        f"{lib_ms:.4f} ms (int64 {lib_variants['int64']:.4f}, int32 "
        f"{lib_variants['int32']:.4f})  bound {bound_ms:.4f} ms "
        f"({bound_by})")
    return row


def _compare_gs(tag, lv, g, gen, flush):
    """The ``gs`` entry (B2's Gauss-Seidel class update) against its plain
    version on class ``g`` of a class-grouped WEll level, on random x and
    b: x updated by the kernel against x updated by the plain entry, held
    to the f32 TOL of max|x|; both timed (in place on a scratch copy; no
    single library call computes the update).  Returns one result row."""
    from amg_tpu_torch.ops import well_kernel as K

    op = lv.a
    xdt = lv.diag.dtype
    x = torch.randn(lv.pad, generator=gen, dtype=xdt).cuda()
    b = torch.randn(lv.pad, generator=gen, dtype=xdt).cuda()
    want = K.gs_update_plain_(op, x.clone(), b, g, lv.diag, lv.inv_diag)
    got = K.gs_update_(op, x.clone(), b, g, lv.diag, lv.inv_diag)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    tol = TOL[xdt]
    ok = err <= tol * scale
    scratch = x.clone()
    ms = _time_ms(lambda: K.gs_update_(op, scratch, b, g, lv.diag,
                                       lv.inv_diag), flush)
    plain_ms = _time_ms(lambda: K.gs_update_plain_(op, scratch, b, g,
                                                   lv.diag, lv.inv_diag),
                        flush)
    first, n = op.rows.class_segment(g)
    s = op.rows
    place, _ = s.entries(first, n)
    n_cols = int(torch.unique(s.cols[place]).numel())
    xb = x.element_size()
    nbytes, nnz = _layout_bytes(op, False, n_cols, xb, first, n)
    # and per row b, diag and inv_diag (its own x is one of the columns)
    rows = int((s.row_idx[first * 32:(first + n) * 32] >= 0).sum())
    nbytes += 3 * rows * xb
    bound_ms, bound_by = _bound(nbytes, 2 * nnz + 6 * rows, xdt)
    row = dict(op=f"{tag} class {g}", entry="gs", vals=str(op.vals.dtype)[6:],
               x=str(xdt)[6:], rows=rows, nnz=nnz, slices=n,
               fill=nnz / max(int(s.slice_ptr[first + n] - s.slice_ptr[first]),
                              1),
               max_abs_err=err, rel_err=err / scale, tol=tol, ok=ok, ms=ms,
               plain_ms=plain_ms, lib_ms=None, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, gbps=nbytes / ms / 1e6)
    log(f"[gs] {tag} class {g:2d}: rows={rows} nnz={nnz} slices={n} fill "
        f"{row['fill']:.3f} x columns read {n_cols}, err {err:.3e} (rel "
        f"{err / scale:.2e} <= {tol:g}: {ok})  kernel {ms:.4f} ms "
        f"{row['gbps']:.1f} GB/s  plain {plain_ms:.4f} ms  bound "
        f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.2f} MB)")
    return row


def phase_well_kernels(a):
    """7. B2 and B3 against plain on fem2d's level 0 after RCM (the
    ordering the solve packs), its layout in row order."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from amg_tpu_torch.sparse import WEll

    perm = reverse_cuthill_mckee(a.to_scipy(), symmetric_mode=True)
    a0 = a.permute(np.asarray(perm, dtype=np.int64))
    g = torch.Generator().manual_seed(3)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for kind in ("float32", "bfloat16", "df64"):
        if kind == "df64":
            w = WEll.from_csr_df64(a0, device="cuda")
        else:
            w = WEll.from_csr(a0, dtype=getattr(torch, kind), device="cuda")
        if kind == "float32":
            # a port reading Q at the entry's own lane would be right only
            # where Q == 0: the operator must have entries with Q > 0
            loc = w.loc.long()
            r = loc & 127
            q_at_r = torch.gather(loc, 3, r) >> 7
            n_q = int(((q_at_r > 0) & (w.vals != 0)).sum())
            log(f"[well] level 0 after RCM: {a0.n_rows} rows, {a0.nnz} nnz, "
                f"{n_q} slot entries with Q > 0")
            check(n_q > 0, "no slot entry with Q > 0")
        rows.append(_compare_well("fem2d-L0", w, "df64" if kind == "df64"
                                  else "spmv", w.pad_cols, a0, g, flush))
        del w
    del flush
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"WEll kernel disagrees with plain version: {bad}")
    return rows


def phase_unstructured(a):
    """8. The unstructured main path, driven through AMGSolver."""
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import dia_kernel as D, well_kernel as W
    from amg_tpu_torch.sparse import RowSlices

    pars = unstructured_pars(amg)
    b = np.ones(a.n_rows)
    log(f"[fem] fem2d({FEM_ROWS}): {a.n_rows} rows, {a.nnz} nnz")

    _reset_counts()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, pars, device="cuda", log=lambda *_: None)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mem = torch.cuda.memory_allocated() - mem0
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    launches = dict(W.launches)
    by_shape = dict(W.launches_by_shape)
    dia_launches = dict(D.launches)

    mg = solver.mg
    for l, lv in enumerate(mg.levels):
        desc = [f"{type(lv.a).__name__} {str(lv.a.vals.dtype)[6:]}"]
        if isinstance(lv.a, amg.WEll):
            s = lv.a.rows
            desc.append(f"n_slots {lv.a.n_slots}, {s.n_slices} slices "
                        f"(fill {s.nnz / max(s.n_stored, 1):.3f}), "
                        f"{len(s.segments) - 1 if s.classes else 0} GS "
                        f"class segments")
        for name in ("p", "r"):
            op = getattr(lv, name)
            if op is not None:
                s_txt = (f" S={op.n_slots}" if isinstance(op, amg.WEll)
                         else "")
                desc.append(f"{name.upper()} {type(op).__name__} "
                            f"{str(op.vals.dtype)[6:]}{s_txt}")
        log(f"[fem] level {l}: {lv.n} rows, pad {lv.pad}, {', '.join(desc)}")
    a0, hi = mg.levels[0].a, solver.a0_hi
    shared = (a0.vals is hi.vals and a0.rows.vals is hi.rows.vals
              and a0.rows.cols is hi.rows.cols)
    log(f"[fem] f64 operator: {type(hi).__name__} df64 (hi plane and "
        f"row-slice structure shared with level 0: {shared})")
    # the derived layout's construction, timed once on the card (the
    # largest: the df64 operator's, grouped by level 0's classes; the
    # copy of its host pack to the card included)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    RowSlices.from_well(hi, mg.levels[0].gid, device="cuda")
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t1
    wells = [op for lv in mg.levels for op in (lv.a, lv.p, lv.r)
             if isinstance(op, amg.WEll)] + [hi]
    planes = {t.data_ptr(): t.numel() * t.element_size()
              for op in wells for f in dataclasses.fields(op.rows)
              if isinstance(t := getattr(op.rows, f.name), torch.Tensor)}
    layout_mib = sum(planes.values()) / 2**20
    true_rel = float(np.linalg.norm(b - a.matvec(x.astype(np.float64)))
                     / np.linalg.norm(b))
    log(f"[fem] setup {setup_s:.2f} s (host hierarchy "
        f"{solver.host_hierarchy.setup_seconds:.2f} s; level 0's df64 "
        f"row-slice layout {layout_s:.3f} s to derive), device memory held "
        f"after setup {mem / 2**20:.1f} MiB (WEll row-slice layouts "
        f"{layout_mib:.1f} MiB), cold solve "
        f"{info.solve_seconds:.4f} s, FCG its {info.nits}, rres "
        f"{info.rres:.3e}, true rres (host f64) {true_rel:.3e}")
    log(f"[fem] WEll kernel launches in the main path: {launches}; DIA: "
        f"{dia_launches}")
    for (entry, vdt, n_rows, nnz), n in sorted(by_shape.items(), key=str):
        log(f"[fem]   {entry:9s} {str(vdt)[6:]} rows={n_rows} nnz={nnz}: "
            f"{n}")
    check(np.all(np.isfinite(x)) and x.shape == (a.n_rows,),
          "solution not finite or wrong shape")
    check(true_rel < 1e-8 and info.nits <= pars.max_it,
          f"unstructured path did not reach 1e-8 (true rres {true_rel:.3e})")
    check(shared, "level 0 does not share the df64 hi plane and structure")

    def key(op, entry):
        return (entry, op.vals.dtype, op.n_rows, op.nnz)

    check(isinstance(a0, amg.WEll) and a0.rows.classes,
          "level 0 is not a class-grouped WEll operator")
    check(by_shape.get(key(a0, "spmv"), 0) > 0,
          "B2 was not launched on level 0's A")
    check(by_shape.get(key(a0, "gs"), 0) > 0,
          "the gs entry was not launched on level 0")
    transfers = [op for lv in mg.levels for op in (lv.p, lv.r)
                 if isinstance(op, amg.WEll)]
    check(any(by_shape.get(key(op, "spmv"), 0) > 0 for op in transfers),
          "B2 was not launched on a WEll P/R")
    check(launches["df64"] > 0, "B3 was not launched")
    check(all(op.rows.cols.is_cuda and not op.vals.is_cuda for op in wells),
          "a WEll operator's pack is on the card or its layout is not")
    check(sum(by_shape.values()) == sum(launches.values()),
          "per-shape launch counts do not add up")

    _, info2 = solver.solve(b)
    torch.cuda.synchronize()
    log(f"[fem] warm solve {info2.solve_seconds:.4f} s, FCG its "
        f"{info2.nits}")
    steps = _graph_vs_eager("fem", solver, solver.solve, b, (x, info))
    return solver, by_shape, dict(mib=mem / 2**20,
                                  warm_solve_s=info2.solve_seconds,
                                  steps=steps)


def phase_unstructured_shapes(solver, by_shape, prefix=""):
    """9. Kernel against plain on every WEll operator of the solve the
    kernels were launched on, with x of the length the cycle gives it
    (``spmv``, ``df64``), and the ``gs`` entry on every class of each
    class-grouped level it was launched on.  Returns one row per (launch
    shape, operator) and per class, with the main path's launch count
    (per class: the level's gs launches over its classes, as every sweep
    visits every class once); ``prefix`` starts every operator's tag."""
    import amg_tpu_torch as amg

    mg, hh = solver.mg, solver.host_hierarchy
    ops = []   # (tag, op, entry, n_x, host csr, level)
    for l, lv in enumerate(mg.levels):
        if isinstance(lv.a, amg.WEll):
            ops.append((f"A{l}", lv.a, "spmv", lv.pad, hh.a[l], lv))
            if lv.a.rows.classes:
                ops.append((f"A{l}", lv.a, "gs", lv.pad, hh.a[l], lv))
        if isinstance(lv.p, amg.WEll):
            ops.append((f"P{l}", lv.p, "spmv", mg.levels[l + 1].pad,
                        hh.p[l], lv))
        if isinstance(lv.r, amg.WEll):
            ops.append((f"R{l}", lv.r, "spmv", lv.pad, hh.r[l], lv))
    ops.append(("a0_hi", solver.a0_hi, "df64", solver.pad, hh.a[0], None))
    g = torch.Generator().manual_seed(4)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for (entry, vdt, n_rows, nnz), n in sorted(by_shape.items(), key=str):
        match = [o for o in ops if o[2] == entry
                 and (o[1].vals.dtype, o[1].n_rows, o[1].nnz)
                 == (vdt, n_rows, nnz)]
        check(match, f"no WEll operator of the solve has the launch shape "
                     f"{(entry, vdt, n_rows, nnz)}")
        for tag, op, entry_, n_x, csr, lv in match:
            tag = prefix + tag
            if entry_ == "gs":
                n_cls = len(op.rows.segments) - 1
                check(n % n_cls == 0, f"{tag}: {n} gs launches over "
                                      f"{n_cls} classes")
                rows += [dict(_compare_gs(tag, lv, c, g, flush),
                              launches=n // n_cls) for c in range(n_cls)]
            else:
                rows.append(dict(_compare_well(tag, op, entry_, n_x, csr, g,
                                               flush), launches=n))
    del flush
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"WEll kernel disagrees with plain version on the "
                   f"unstructured path's operators: {bad}")
    return rows


# ---------------------------------------------------------------------------
# 10-12. the batched path: B4 and solve_batched
# ---------------------------------------------------------------------------


def _dia_csr_on_card(d, dtype):
    """A Dia operator on the card as a torch sparse CSR tensor of its
    nonzero in-range entries (the library yardstick for an operator with no
    host CSR; the port never calls it).  An embedded operator stores zeros
    at every row outside its level (A2 at poisson3d(100): 88,174 of
    1,024,000 rows): the CSR holds the operator's real entries only."""
    nd, pad = d.vals.shape
    cols = torch.arange(pad, device="cuda")[:, None] + d.offs.long()[None]
    keep = (cols >= 0) & (cols < pad) & (d.vals.T != 0)
    crow = torch.zeros(pad + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    return torch.sparse_csr_tensor(crow, cols[keep],
                                   d.vals.T[keep].to(dtype), size=(pad, pad))


def _int32_csr(lib):
    """The same torch sparse CSR tensor with int32 row and column indices."""
    return torch.sparse_csr_tensor(lib.crow_indices().int(),
                                   lib.col_indices().int(), lib.values(),
                                   size=lib.shape)


# B4's epilogues: (wrapper, batch arguments besides X, extra vectors read
# per column, elementwise flops per entry besides the product)
MULTI_EPILOGUES = {"multi": ("spmv_multi", 0, 0),
                   "multi_resid": ("resid_multi", 1, 1),
                   "multi_update": ("gs_update_multi", 1, 3)}


def _compare_multi(tag, op, k, g, flush, libs, ep="multi"):
    """Kernel B4 (epilogue ``ep``) against its plain version on one Dia
    operator at k right-hand sides, held to TOL of max|AX| and timed beside
    the torch sparse CSR call that computes the same function: ``lib @
    X.T`` for the product, ``addmm(B.T, lib, X.T, alpha=-1)`` for the
    residual, none for the update.  The library time is the fastest of
    int64 and int32 indices (``libs``), each with X.T (and B.T) as
    column-major views and made row-major beforehand.  Returns one result
    row."""
    from amg_tpu_torch.ops import dia_kernel as K

    name, n_b, ew_flops = MULTI_EPILOGUES[ep]
    fn, plain = getattr(K, name), getattr(K, name + "_plain")
    nd, pad = op.vals.shape
    vdt = op.vals.dtype
    xdt = torch.float64 if vdt == torch.float64 else torch.float32
    x = torch.randn(k, pad, generator=g, dtype=xdt).cuda()
    args = [x]
    if n_b:
        args.append(torch.randn(k, pad, generator=g, dtype=xdt).cuda())
    if ep == "multi_update":
        args.append(torch.randn(pad, generator=g, dtype=xdt).cuda())
    want = plain(op, *args)
    got = fn(op, *args)
    torch.cuda.synchronize()
    check(got.dtype == xdt and got.shape == (k, pad),
          f"{tag}: B4 {ep} output {got.dtype} {tuple(got.shape)}")
    scale = K.spmv_multi_plain(op, x).abs().max().item()
    err = (got - want).abs().max().item()
    ok = err <= TOL[vdt] * scale
    ms = _time_ms(lambda: fn(op, *args), flush)
    plain_ms = _time_ms(lambda: plain(op, *args), flush)
    lib_variants = {}
    if ep != "multi_update":
        # the library operator may be the compact (n, m) one of a level
        # whose vectors are padded further
        n, m = next(iter(libs.values())).shape
        xs, bs = x[:, :m], args[-1][:, :n]
        layouts = (("col-major", xs.T, bs.T),
                   ("row-major", xs.T.contiguous(), bs.T.contiguous()))
        for idx, lib in libs.items():
            for lay, xv, bv in layouts:
                call = ((lambda lib=lib, xv=xv: lib @ xv) if ep == "multi"
                        else (lambda lib=lib, xv=xv, bv=bv: torch.addmm(
                            bv, lib, xv, alpha=-1)))
                lib_variants[f"{idx} {lay}"] = _time_ms(call, flush)
    lib_ms = min(lib_variants.values()) if lib_variants else None
    vb = op.vals.element_size()
    xb = x.element_size()
    # values once, X (and B) read once, Y written once (and w read once)
    nbytes = nd * pad * vb + (2 + n_b) * k * pad * xb
    if ep == "multi_update":
        nbytes += pad * xb
    bound_ms, bound_by = _bound(nbytes, (2 * nd + ew_flops) * pad * k, xdt)
    row = dict(op=tag, epilogue=ep, nd=nd, pad=pad, k=k, vals=str(vdt)[6:],
               x=str(xdt)[6:], max_abs_err=err, rel_err=err / scale,
               tol=TOL[vdt], ok=ok, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
               lib_variants=lib_variants, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, gbps=nbytes / ms / 1e6)
    lib_txt = (f"{lib_ms:.4f} ms (" + ", ".join(
        f"{v} {t:.4f}" for v, t in lib_variants.items()) + ")"
               if lib_variants else "none (no one call)")
    log(f"[multi] {tag:8s} {ep:12s} nd={nd:2d} pad={pad:7d} k={k:2d} "
        f"{row['vals']:8s}/{row['x']:7s} err {err:.3e} "
        f"(rel {err / scale:.2e} <= {TOL[vdt]:g}: {ok})  kernel {ms:.4f} ms "
        f"{row['gbps']:.1f} GB/s  plain {plain_ms:.4f} ms  torch CSR "
        f"{lib_txt}  bound {bound_ms:.4f} ms ({bound_by})")
    return row


def phase_multi_kernels(solver):
    """10. B4 against plain on the structured solve's DIA levels and on
    the 40-diagonal band (bf16 and f64): the product at k = 1, 4, 16, the
    resid and update epilogues at k = 1 and 16 (the batched solves' own
    launch shapes are compared by :func:`_multi_shapes`)."""
    from amg_tpu_torch.sparse import Dia

    hh = solver.host_hierarchy
    ops = [(f"level{l}", lv.a, lambda l=l, lv=lv: _csr_on_card(
                hh.a[l], torch.float64 if lv.a.vals.dtype == torch.float64
                else torch.float32))
           for l, lv in enumerate(solver.mg.levels) if isinstance(lv.a, Dia)]
    offs, vals64 = _band40(solver.pad)
    pad = vals64.shape[1]
    for vdt in (torch.bfloat16, torch.float64):
        d = Dia(vals64.to(vdt).cuda(), offs, (pad, pad), len(offs) * pad)
        ops.append(("band40", d, lambda d=d, vdt=vdt: _dia_csr_on_card(
            d, torch.float64 if vdt == torch.float64 else torch.float32)))
    g = torch.Generator().manual_seed(5)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for tag, op, make_lib in ops:
        lib = make_lib()
        libs = {"int64": lib, "int32": _int32_csr(lib)}
        for ep, ks in (("multi", (1, 4, N_RHS)), ("multi_resid", (1, N_RHS)),
                       ("multi_update", (1, N_RHS))):
            for k in ks:
                rows.append(_compare_multi(tag, op, k, g, flush, libs, ep))
        del lib, libs
    del flush, ops
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"B4 disagrees with its plain version: {bad}")


def _multi_shapes(solver, by_shape, prefix=""):
    """B4 against plain on a batched solve's own operators: for every
    launch shape in ``by_shape`` (epilogue, dtypes, nd, pad, k), every DIA
    operator of the solver with that shape (:func:`_dia_ops`; the resid
    and update epilogues run on a level's A only), timed beside the
    fastest torch CSR SpMM.  Returns one row per launch shape with its
    main-path launch count (:func:`_one_row`); ``prefix`` starts every
    operator's tag."""
    ops = _dia_ops(solver)
    g = torch.Generator().manual_seed(10)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for (ep, vdt, _, nd, pad, k), n in sorted(by_shape.items(), key=str):
        match = [(tag, op, make) for tag, op, make in ops
                 if (op.vals.dtype, op.n_diags, op.padded_rows)
                 == (vdt, nd, pad)
                 and (ep == "multi" or tag.startswith("level"))]
        check(match, f"no DIA operator has the B4 shape {(ep, vdt, nd, pad)}")
        shape_rows = []
        for tag, op, make in match:
            lib = make(torch.float64 if vdt == torch.float64
                       else torch.float32)
            libs = {"int64": lib, "int32": _int32_csr(lib)}
            shape_rows.append(_compare_multi(prefix + tag, op, k, g, flush,
                                             libs, ep))
            del lib, libs
        rows.append(_one_row(shape_rows, n))
    del flush
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"B4 disagrees with its plain version: {bad}")
    return rows


def phase_batched(solver, B):
    """11. The batched main path: ``solve_batched`` on the (n, N_RHS)
    right-hand sides B with phase 5's solver.  Returns B4's launches by
    shape and the timings."""
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import dia_kernel as D, well_kernel as W

    a = solver.a
    _reset_counts()
    t0 = time.perf_counter()
    x, info = solver.solve_batched(B, tol=BATCH_TOL)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(D.launches)
    by_shape = dict(D.launches_by_shape)
    well_launches = dict(W.launches)

    nb = np.linalg.norm(B, axis=0)
    true_rel = np.array([np.linalg.norm(B[:, c] - a.matvec(
        x[:, c].astype(np.float64))) / nb[c] for c in range(B.shape[1])])
    log(f"[batch] poisson3d({N_SIDE}), k={B.shape[1]}: cold "
        f"{cold_s:.4f} s (solve_seconds {info.solve_seconds:.4f}), "
        f"its {info.nits}, worst rres {info.rres:.3e}, true rres (host "
        f"f64) worst {true_rel.max():.3e} best {true_rel.min():.3e}")
    log(f"[batch] history (worst column / ||b||): "
        f"{[f'{r / nb.max():.3e}' for r in info.residuals]}")
    log(f"[batch] DIA kernel launches: {launches}; WEll: {well_launches}")
    for key, n in sorted(by_shape.items(), key=str):
        ep, vdt, xdt, nd, pad = key[:5]
        k_txt = f" k={key[5]}" if ep in D.MULTI else ""
        log(f"[batch]   {ep:12s} {str(vdt)[6:]}/{str(xdt)[6:]} nd={nd} "
            f"pad={pad}{k_txt}: {n}")
    check(np.all(np.isfinite(x)) and x.shape == B.shape,
          "batched solution not finite or wrong shape")
    check(np.all(true_rel < BATCH_TOL) and info.nits < solver.pars.max_it,
          f"batched path did not reach {BATCH_TOL:g} in every column "
          f"(true rres {true_rel})")
    check(all(launches[e] == 0 for e in D.EPILOGUES),
          f"B1 launched during the batched solve: {launches}")
    check(sum(well_launches.values()) == 0, "WEll kernel launched")
    for l, lv in enumerate(solver.mg.levels):
        if not isinstance(lv.a, amg.Dia):
            continue
        # the update epilogue on level 0 (its GS sweeps), the residual on
        # every Dia level, the product on every Dia level (level 0: the
        # iteration's residual norm; level 1: Chebyshev)
        for ep in (D.MULTI if l == 0 else ("multi", "multi_resid")):
            key = (ep, lv.a.vals.dtype, torch.float32, lv.a.n_diags, lv.pad,
                   B.shape[1])
            check(by_shape.get(key, 0) > 0,
                  f"B4 {ep} was not launched on level {l}'s shape {key}")
    check(sum(by_shape.values()) == sum(launches[e] for e in D.MULTI),
          "per-shape launch counts do not add up")

    t0 = time.perf_counter()
    _, info2 = solver.solve_batched(B, tol=BATCH_TOL)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"[batch] warm {warm_s:.4f} s (solve_seconds "
        f"{info2.solve_seconds:.4f}), its {info2.nits}; per right-hand "
        f"side {warm_s / B.shape[1]:.4f} s")
    steps = _graph_vs_eager("batch", solver, solver.solve_batched, B,
                            (x, info), names=("batched",), tol=BATCH_TOL)
    return by_shape, dict(cold_s=cold_s, warm_s=warm_s, nits=info.nits,
                          true_rres=float(true_rel.max()), steps=steps)


def phase_batched_one_column(solver, b):
    """12. ``solve_batched`` on one column (B4 at k = 1) against the
    single-rhs f32 solve of the same hierarchy (B1's epilogues)."""
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import dia_kernel as D

    single = amg.AMGSolver(
        solver.a, structured_pars(amg).replace(refine=False, tol=BATCH_TOL),
        host_hierarchy=solver.host_hierarchy, device="cuda",
        log=lambda *_: None)
    before = dict(D.launches)
    x1, i1 = single.solve(b)
    torch.cuda.synchronize()
    mid = dict(D.launches)
    xb, ib = solver.solve_batched(b[:, None], tol=BATCH_TOL)
    torch.cuda.synchronize()
    after = dict(D.launches)
    nb = float(np.linalg.norm(b))
    hb, hs = np.array(ib.residuals), np.array(i1.residuals[1:])
    m = min(len(hb), len(hs))
    rel = np.abs(hb[:m] - hs[:m]) / hs[:m]
    gap = np.abs(hb[:m] - hs[:m]).max() / nb
    log(f"[one] single-rhs f32: its {i1.nits}, rres {i1.rres:.3e}; batched "
        f"k=1: its {ib.nits}, rres {ib.rres:.3e}; history rel diff "
        f"{[f'{v:.1e}' for v in rel]}, max abs diff {gap:.3e} ||b|| "
        f"(allowed {ONE_COL_ATOL:g} ||b|| + rtol 1e-3); max |x_b - x_s| / "
        f"max|x_s| {np.abs(xb[:, 0] - x1).max() / np.abs(x1).max():.3e}")
    check(all(mid[e] == before[e] for e in D.MULTI) and
          all(mid[e] > before[e] for e in D.EPILOGUES),
          "the single-rhs solve did not run through B1 alone")
    check(all(after[e] > mid[e] for e in D.MULTI) and
          all(after[e] == mid[e] for e in D.EPILOGUES),
          "the one-column batched solve did not run through B4 alone")
    check(abs(ib.nits - i1.nits) <= 1,
          f"iterations differ: batched {ib.nits}, single {i1.nits}")
    check(np.allclose(hb[:m], hs[:m], rtol=1e-3, atol=ONE_COL_ATOL * nb),
          f"residual histories differ beyond rtol 1e-3 + {ONE_COL_ATOL:g} "
          f"||b||")
    # the single-rhs solve warm, beside the batched one of phase 11
    t0 = time.perf_counter()
    _, i2 = single.solve(b)
    torch.cuda.synchronize()
    log(f"[one] warm single-rhs f32 solve {time.perf_counter() - t0:.4f} s, "
        f"its {i2.nits}")


# ---------------------------------------------------------------------------
# 13-15. the port's "auto" layouts (WEll where amg_tpu keeps a band the
# port declines) and amg_tpu's fine-grid embedding
# ---------------------------------------------------------------------------


# what the port packs on "auto": amg_tpu's one-device layout (its
# setup_host, embedding_plan and reorder_for_gs on the same matrices with
# both flags on), but WEll on the levels whose band "auto" declines;
# *_DECLINED: those levels and the nb of the band amg_tpu keeps there
STRUCTURED_AUTO = ["Dia", "Dia", "WEll", "WEll", "Dense", "Dense"]
STRUCTURED_DECLINED = {3: 17}
STRUCTURED_DENSE_PAD = 7168        # level 4 (6,396 rows) below WEll level 3
EMBEDDED = ["Dia", "Dia", "Dia", "BandedBlocks", "Dense", "Dense"]
EMBEDDED_PAD = 1_024_000           # good_pad(1,000,000), shared by levels 0-2
# diagonals of the embedded operators: (level, operator) -> nd
EMBEDDED_NDS = {(1, "a"): 19, (2, "a"): 199, (0, "p"): 7, (0, "r"): 7,
                (1, "p"): 19, (1, "r"): 19, (2, "p"): 156, (2, "r"): 156}
FEM_AUTO = ["WEll"] * 8 + ["Dense"]
FEM_DECLINED = {4: 9, 5: 7, 6: 5, 7: 3}


def _formats(solver):
    return [type(lv.a).__name__ for lv in solver.mg.levels]


def _auto_solver(a, pars, tag, b):
    """Set up ``pars`` on ``a`` (counts reset just before), solve ``b``
    cold and warm, verify the cold solution on the host in f64.  Returns
    the solver, the cold run's DIA and WEll launches by shape, and a
    summary."""
    from amg_tpu_torch.ops import (dia_kernel as D, krylov_small as KS,
                                   well_kernel as W)
    from amg_tpu_torch.solve import krylov
    from amg_tpu_torch import tracing
    import amg_tpu_torch as amg

    _reset_counts()
    mem0 = torch.cuda.memory_allocated()
    row0 = tracing.totals()["amg.setup.banded_declined"]
    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, pars, device="cuda", log=lambda *_: None)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    row = tracing.totals()["amg.setup.banded_declined"]
    declined = (row["n"] - row0["n"], row["bytes"] - row0["bytes"])
    mib = (torch.cuda.memory_allocated() - mem0) / 2**20
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    dia, well = dict(D.launches_by_shape), dict(W.launches_by_shape)
    small = dict(KS.launches_by_shape)
    launches = (dict(D.launches), dict(W.launches))
    krylov_counts = dict(krylov.counts)
    true_rel = float(np.linalg.norm(b - a.matvec(x.astype(np.float64)))
                     / np.linalg.norm(b))
    for l, lv in enumerate(solver.mg.levels):
        desc = [f"{type(lv.a).__name__} {str(lv.a.vals.dtype)[6:]}"]
        if isinstance(lv.a, amg.Dia):
            desc.append(f"nd={lv.a.n_diags}")
        if isinstance(lv.a, amg.BandedBlocks):
            desc.append(f"nb={lv.a.nb} ({lv.a.vals.numel() * lv.a.vals.element_size() / 1e6:.1f} MB)")
        for name in ("p", "r"):
            op = getattr(lv, name)
            if op is not None:
                nd = f" nd={op.n_diags}" if isinstance(op, amg.Dia) else ""
                desc.append(f"{name.upper()} {type(op).__name__} "
                            f"{str(op.vals.dtype)[6:]}{nd}")
        for name in ("compact_idx", "member_idx"):
            if getattr(lv, name) is not None:
                desc.append(f"{name} ({getattr(lv, name).numel()})")
        log(f"[{tag}] level {l}: {lv.n} rows, pad {lv.pad}, "
            f"{', '.join(desc)}")
    _, info2 = solver.solve(b)
    torch.cuda.synchronize()
    log(f"[{tag}] setup {setup_s:.2f} s, device memory held after setup "
        f"{mib:.1f} MiB, cold solve {info.solve_seconds:.4f} s, warm "
        f"{info2.solve_seconds:.4f} s, its {info.nits}, rres "
        f"{info.rres:.3e}, true rres (host f64) {true_rel:.3e}")
    log(f"[{tag}] launches: DIA {launches[0]}, WEll {launches[1]}; "
        f"amg.setup.banded_declined {declined[0]} levels, "
        f"{declined[1] / 1e6:.1f} MB")
    check(np.all(np.isfinite(x)) and x.shape == (a.n_rows,),
          f"{tag}: solution not finite or wrong shape")
    check(true_rel < 1e-8 and info.nits <= pars.max_it,
          f"{tag}: did not reach 1e-8 (true rres {true_rel:.3e})")
    steps = (_graph_vs_eager(tag, solver, solver.solve, b, (x, info))
             if solver.steps.graphs else None)
    return solver, dia, well, dict(mib=mib, warm_solve_s=info2.solve_seconds,
                                   nits=info.nits, true_rres=true_rel,
                                   setup_s=setup_s, declined=declined,
                                   solve_s=info.solve_seconds,
                                   krylov=krylov_counts, krylov_small=small,
                                   steps=steps)


def _product_ms(op, n_x, g, flush):
    """Device ms of one ``spmv`` of ``op`` on a random f32 x of length
    ``n_x`` (median of REPS from a flushed L2)."""
    from amg_tpu_torch.ops.spmv import spmv

    x = torch.randn(n_x, generator=g, dtype=torch.float32).cuda()
    return _time_ms(lambda: spmv(op, x), flush)


def _compare_products(tag, levels, new, old):
    """Each of ``levels``' product in the ``new`` solver's format beside the
    ``old`` solver's on the same level (the same host operator, in another
    ordering and format).  BandedBlocks is a cuBLAS batched product, not a
    kernel of the port: its bound (bytes of the values, x and y over the
    card's rate) is logged beside it."""
    from amg_tpu_torch.sparse import BandedBlocks

    g = torch.Generator().manual_seed(8)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = []
    for l in levels:
        ln, lo = new.mg.levels[l], old.mg.levels[l]
        ms_new = _product_ms(ln.a, ln.pad, g, flush)
        ms_old = _product_ms(lo.a, lo.pad, g, flush)
        txt = ""
        if isinstance(ln.a, BandedBlocks):
            v = ln.a.vals
            nbytes = v.numel() * v.element_size() + 2 * ln.pad * 4
            txt = (f" ({nbytes / 1e6:.1f} MB, bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
                   f"{nbytes / ms_new / 1e6:.1f} GB/s)")
        log(f"[{tag}] level {l} product: {type(ln.a).__name__} "
            f"{str(ln.a.vals.dtype)[6:]} {ms_new:.4f} ms{txt}; "
            f"{type(lo.a).__name__} {str(lo.a.vals.dtype)[6:]} "
            f"{ms_old:.4f} ms")
        out.append(dict(level=l, new=type(ln.a).__name__, ms=ms_new,
                        old=type(lo.a).__name__, old_ms=ms_old))
    del flush
    return out


def _declined_bands(tag, solver, declined):
    """B2 on each level that "auto" sent to WEll (``declined``: level ->
    the nb of the band amg_tpu keeps there) beside the cuBLAS product of
    that band, rebuilt from the level's host operator in RCM order (its
    nb logged beside amg_tpu's); bytes and share of the bound of each,
    B2 against its plain version.  Returns one row per level."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from amg_tpu_torch.ops import well_kernel as W
    from amg_tpu_torch.ops.spmv import spmv
    from amg_tpu_torch.sparse import BandedBlocks

    g = torch.Generator().manual_seed(22)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for l, nb_on in declined.items():
        well = solver.mg.levels[l].a
        al = solver.host_hierarchy.a[l]
        m = sp.csr_matrix((al.data, al.indices, al.indptr), shape=al.shape)
        rcm = np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True),
                         dtype=np.int64)
        al_rcm = al.permute(rcm)
        nb = BandedBlocks.block_bandwidth(al_rcm)
        band = BandedBlocks.from_csr(al_rcm, dtype=well.rows.vals.dtype,
                                     nb=nb, device="cuda")
        xb = torch.randn(band.padded_rows, generator=g).cuda()
        band_bytes = (band.vals.numel() * band.vals.element_size()
                      + 2 * band.padded_rows * 4)
        band_ms = _time_ms(lambda: spmv(band, xb), flush)
        del band, xb
        n_x = min(well.padded_rows, well.pad_cols)
        xw = torch.randn(well.padded_rows, generator=g).cuda()
        got, want = W.spmv(well, xw), W.spmv_plain(well, xw)
        err = ((got - want).abs().max() / want.abs().max()).item()
        check(err <= TOL[well.rows.vals.dtype],
              f"{tag}: B2 on declined level {l} disagrees with its plain "
              f"version, rel err {err:.3e}")
        well_bytes, nnz = _layout_bytes(well, False, n_x, 4)
        well_ms = _time_ms(lambda: W.spmv(well, xw), flush)
        row = dict(level=l, rows=well.n_rows, nnz=nnz,
                   max_row=int(np.diff(al.indptr).max()),
                   dtype=str(well.rows.vals.dtype)[6:], nb=nb, nb_on=nb_on,
                   band_bytes=band_bytes, band_ms=band_ms,
                   band_bound_ms=band_bytes / HBM_BYTES_PER_S * 1e3,
                   well_bytes=well_bytes, well_ms=well_ms,
                   well_bound_ms=well_bytes / HBM_BYTES_PER_S * 1e3,
                   rel_err=err)
        rows.append(row)
        log(f"[{tag}] declined level {l} {row['dtype']} rows={well.n_rows} "
            f"nnz={nnz} max row {row['max_row']}: B2 "
            f"{well_bytes / 1e6:.2f} MB {well_ms:.4f} ms (bound "
            f"{row['well_bound_ms']:.4f}, "
            f"{100 * row['well_bound_ms'] / well_ms:.0f}%), rel err "
            f"{err:.2e}; band nb {nb} (amg_tpu's {nb_on}) "
            f"{band_bytes / 1e6:.1f} MB {band_ms:.4f} ms (bound "
            f"{row['band_bound_ms']:.4f}, "
            f"{100 * row['band_bound_ms'] / band_ms:.0f}%); band / B2 "
            f"{band_ms / well_ms:.2f}x")
    del flush
    return rows


def _check_declined(tag, solver, summary, declined):
    """No level of ``solver`` is BandedBlocks, the levels "auto" declined
    are ``declined``'s, packed as WEll, and ``amg.setup.banded_declined``
    counted each of them."""
    import amg_tpu_torch as amg

    check(not any(isinstance(lv.a, amg.BandedBlocks)
                  for lv in solver.mg.levels),
          f"{tag}: a band was kept")
    check(summary["declined"][0] == len(declined)
          and all(isinstance(solver.mg.levels[l].a, amg.WEll)
                  for l in declined),
          f"{tag}: amg.setup.banded_declined {summary['declined']}, "
          f"expected levels {sorted(declined)} as WEll")


def phase_structured_auto(old, old_summary):
    """13. poisson3d(100) with phase 5's parameters and ``use_well`` and
    ``use_banded`` on "auto": the port's layout of ``p3d7_1m``, solved to
    1e-8 through B1 and B2; products per level beside phase 5's
    (``old``), level 3's B2 beside the band amg_tpu keeps there.  Returns
    the kernel rows of every DIA and WEll launch shape of its solve (tags
    "a-")."""
    import amg_tpu_torch as amg

    pars = structured_pars(amg).replace(use_well="auto", use_banded="auto")
    b = np.ones(old.a.n_rows)
    solver, dia, well, summary = _auto_solver(old.a, pars, "auto", b)
    fmts = _formats(solver)
    check(fmts == STRUCTURED_AUTO, f"auto formats {fmts}")
    _check_declined("auto", solver, summary, STRUCTURED_DECLINED)
    dense = solver.mg.levels[4].a
    check(tuple(dense.vals.shape) == (STRUCTURED_DENSE_PAD,) * 2,
          f"auto level 4 Dense {tuple(dense.vals.shape)}, expected "
          f"{STRUCTURED_DENSE_PAD} x {STRUCTURED_DENSE_PAD}")
    wells = [lv.a for lv in solver.mg.levels if isinstance(lv.a, amg.WEll)]
    check(sum(dia.values()) > 0 and wells and all(
        well.get(("spmv", op.vals.dtype, op.n_rows, op.nnz), 0) > 0
        for op in wells), "B1 or B2 (on the WEll level's A) was not launched")
    log(f"[auto] device memory {summary['mib']:.1f} MiB (phase 5: "
        f"{old_summary['mib']:.1f}), warm solve {summary['warm_solve_s']:.4f} "
        f"s (phase 5: {old_summary['warm_solve_s']:.4f})")
    _compare_products("auto", [l for l, f in enumerate(fmts)
                               if f in ("WEll", "BandedBlocks")], solver, old)
    summary["bands"] = _declined_bands("auto", solver, STRUCTURED_DECLINED)
    rows = (phase_main_shapes(solver, dia, prefix="a-"),
            phase_unstructured_shapes(solver, well, prefix="a-"))
    return solver, rows, summary


def phase_dense_kernel(solver):
    """23. D1 on phase 13's solver: its main-path launches in one warm
    solve, then D1 against its plain version and timed at every bf16
    Dense level's shape.  Returns one kernel row per level."""
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import dense_kernel as DK

    levels = solver.mg.levels
    dense = [(l, lv.a) for l, lv in enumerate(levels)
             if isinstance(lv.a, amg.Dense)
             and lv.a.vals.dtype == torch.bfloat16]
    check(dense, "no bf16 Dense level")
    b = np.ones(solver.a.n_rows)
    _reset_counts()
    _, info = solver.solve(b)
    torch.cuda.synchronize()
    _settle_counts()
    by_shape = dict(DK.launches_by_shape)
    cycled = {("spmv", op.padded_rows, op.padded_cols)
              for l, op in dense if l < len(levels) - 1}
    log(f"[dense] D1 launches in one warm solve ({info.nits} cycles): "
        f"{by_shape}")
    check(by_shape and set(by_shape) <= cycled
          and sum(by_shape.values()) == 7 * info.nits * len(cycled),
          f"D1 launches {by_shape}: expected 7 per cycle on each of "
          f"{sorted(cycled)}")
    g = torch.Generator().manual_seed(23)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for l, op in dense:
        pr, pc = op.vals.shape
        x = torch.randn(pc, generator=g, dtype=torch.float32).cuda()
        got, want = DK.spmv(op, x), DK.spmv_plain(op, x)
        torch.cuda.synchronize()
        s = op.vals.double().abs() @ x.double().abs()
        diff = (got.double() - want.double()).abs()
        err = diff.max().item()
        ok = bool(torch.all(diff <= 2 * pc * 2.0 ** -24 * s))
        check(ok, f"D1 level {l}: max error {err:.3e} above the f32 "
              f"summation bound")
        ms = _time_ms(lambda: DK.spmv(op, x), flush)
        plain_ms = _time_ms(lambda: DK.spmv_plain(op, x), flush)
        v32 = op.vals.float()
        lib_ms = _time_ms(lambda: v32 @ x, flush)
        del v32
        # each value read once, x read and y written once
        nbytes = pr * pc * 2 + (pr + pc) * 4
        bound_ms, bound_by = _bound(nbytes, 2 * pr * pc, torch.float32)
        launches = by_shape.get(("spmv", pr, pc), 0)
        log(f"[dense] level {l} bf16 {pr} x {pc} [{launches}]: err "
            f"{err:.3e} (ok {ok})  D1 {ms:.4f} ms "
            f"{nbytes / ms / 1e6:.1f} GB/s  bound {bound_ms:.4f} ms "
            f"({bound_by}, {nbytes / 1e6:.1f} MB) "
            f"[{100 * bound_ms / ms:.1f}%]  plain (widen + gemv) "
            f"{plain_ms:.4f} ms  f32 gemv on a widened copy {lib_ms:.4f} ms")
        rows.append(dict(op=f"L{l}", rows=pr, cols=pc, launches=launches,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         lib_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
    del flush
    return rows


def _embedded_depth(solver):
    """(E, boundary) read off a packed hierarchy: levels 1..E share level
    0's pad; level E carries compact_idx (embedded boundary) or member_idx
    (compact boundary)."""
    lv = solver.mg.levels
    E = max(l for l in range(len(lv) - 1) if lv[l].pad == solver.pad)
    boundary = ("embedded" if lv[E].compact_idx is not None else
                "compact" if lv[E].member_idx is not None else None)
    return E, boundary


def phase_embedded(a):
    """14. poisson3d(100) with phase 13's parameters, ``embed_levels=8``
    and ``use_banded`` on "on" (amg_tpu's embedded layout, with level 3's
    band): levels 0-2 as Dia over one pad (bf16 embedded operators), B1
    checked against plain on every embedded operator and epilogue the
    solve launched; ``solve_batched`` on 16 columns through B4 (checked against
    plain at those shapes); one solve with ``embed_boundary="compact"``
    (the member_idx path).  Returns the B1 and B4 rows and the solve's B1
    launches and cycles."""
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import dia_kernel as D, well_kernel as W

    pars = structured_pars(amg).replace(use_well="auto", use_banded="on",
                                        embed_levels=8)
    b = np.ones(a.n_rows)
    solver, dia, well, summary = _auto_solver(a, pars, "embed", b)
    emb_summary = dict(b1=sum(dia.values()), cycles=summary["nits"])
    fmts = _formats(solver)
    E, boundary = _embedded_depth(solver)
    check((E, boundary) == (2, "embedded"), f"embedding {(E, boundary)}")
    check(solver.pad == EMBEDDED_PAD, f"pad0 {solver.pad}")
    check(fmts == EMBEDDED, f"embedded formats {fmts}")
    emb_ops = {(l, n): getattr(solver.mg.levels[l], n)
               for l in range(E + 1) for n in ("a", "p", "r") if l or n != "a"}
    nds = {k: getattr(op, "n_diags", None) for k, op in emb_ops.items()}
    check(nds == EMBEDDED_NDS, f"embedded diagonals {nds}")
    check(all(op.vals.dtype == torch.bfloat16 for op in emb_ops.values()),
          "embedded operators not bf16")
    check(sum(well.values()) == 0, "WEll kernel launched")
    dia_rows = phase_main_shapes(solver, dia, prefix="e-")
    embedded = {(op.vals.dtype, op.n_diags) for op in emb_ops.values()}
    check(embedded <= {(k[1], k[3]) for k in dia},
          "B1 was not launched on every embedded operator")

    # batched: B4 on the embedded operators, no B1
    B = np.random.default_rng(9).standard_normal((a.n_rows, N_RHS))
    _reset_counts()
    t0 = time.perf_counter()
    X, info = solver.solve_batched(B, tol=BATCH_TOL)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    multi = dict(D.launches_by_shape)
    launches = dict(D.launches)
    nb = np.linalg.norm(B, axis=0)
    true_rel = np.array([np.linalg.norm(B[:, c] - a.matvec(
        X[:, c].astype(np.float64))) / nb[c] for c in range(N_RHS)])
    t0 = time.perf_counter()
    solver.solve_batched(B, tol=BATCH_TOL)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"[embed] batched k={N_RHS}: cold {cold_s:.4f} s, warm {warm_s:.4f} "
        f"s, its {info.nits}, true rres worst {true_rel.max():.3e}; DIA "
        f"launches {launches}")
    check(np.all(np.isfinite(X)) and np.all(true_rel < BATCH_TOL),
          f"embedded batched solve: true rres {true_rel}")
    check(all(launches[e] == 0 for e in D.EPILOGUES),
          f"B1 launched during the batched solve: {launches}")
    check(embedded <= {(k[1], k[3]) for k in multi},
          "B4 was not launched on every embedded operator")
    multi_rows = _multi_shapes(solver, multi, prefix="e-")

    # the compact boundary: member_idx on the card
    del solver
    cmp, _, _, _ = _auto_solver(a, pars.replace(embed_boundary="compact"),
                                "embed-compact", b)
    E, boundary = _embedded_depth(cmp)
    check(boundary == "compact" and E >= 1, f"compact boundary {(E, boundary)}")
    del cmp
    return dia_rows, multi_rows, emb_summary


def phase_fem_auto(a, old, old_summary):
    """15. fem2d(1,000,000) with phase 8's parameters and ``use_well`` and
    ``use_banded`` on "auto": the port's layout of ``fem2d_1m``, WEll
    levels 0-7, FCG to 1e-8; levels 4-7's B2 products beside phase 8's
    (``old``) Ell or Dense on the same level and beside the bands amg_tpu
    keeps there.  Returns the kernel rows of every WEll launch shape of
    its solve (tags "fa-": level 4's barycentric ordering rewrites P3 and
    R3, so their layouts are not phase 9's), its summary and its host
    hierarchy (phase 22's)."""
    import amg_tpu_torch as amg

    pars = unstructured_pars(amg).replace(use_well="auto",
                                          use_banded="auto")
    b = np.ones(a.n_rows)
    solver, _, well, summary = _auto_solver(a, pars, "fem-auto", b)
    fmts = _formats(solver)
    check(fmts == FEM_AUTO, f"fem2d auto formats {fmts}")
    _check_declined("fem-auto", solver, summary, FEM_DECLINED)
    log(f"[fem-auto] device memory {summary['mib']:.1f} MiB (phase 8: "
        f"{old_summary['mib']:.1f}), warm solve {summary['warm_solve_s']:.4f} "
        f"s (phase 8: {old_summary['warm_solve_s']:.4f})")
    _compare_products("fem-auto", sorted(FEM_DECLINED), solver, old)
    summary["bands"] = _declined_bands("fem-auto", solver, FEM_DECLINED)
    rows = phase_unstructured_shapes(solver, well, prefix="fa-")
    hh = solver.host_hierarchy
    del solver
    return rows, summary, hh


# ---------------------------------------------------------------------------
# 16-17. the Krylov layer: GMRES acceleration and the KRYLOV coarsest solver
# ---------------------------------------------------------------------------


CD_SIDE = 1000             # convection-diffusion grid: 1,000,000 rows
CD_VEL = 20.0              # its upwind convection strength
GMRES_MAX_ITS = 40         # tests/test_solve.py:638's bound


def convection_diffusion(n_side, vel=CD_VEL):
    """The 2-D upwind convection-diffusion operator of
    tests/test_solve.py:618-636 on an n_side x n_side grid (nonsymmetric:
    first-order upwind convection along the slow index), built with
    scipy."""
    import scipy.sparse as sp
    import amg_tpu_torch as amg

    n = n_side * n_side
    h = 1.0 / (n_side + 1)
    i, j = np.divmod(np.arange(n), n_side)
    rows, cols = [np.arange(n)], [np.arange(n)]
    vals = [np.full(n, 4.0 / h ** 2 + vel / h)]
    for di, dj, c in ((-1, 0, -1.0 / h ** 2 - vel / h), (1, 0, -1.0 / h ** 2),
                      (0, -1, -1.0 / h ** 2), (0, 1, -1.0 / h ** 2)):
        k = np.flatnonzero((i + di >= 0) & (i + di < n_side)
                           & (j + dj >= 0) & (j + dj < n_side))
        rows.append(k)
        cols.append(k + di * n_side + dj)
        vals.append(np.full(k.size, c))
    m = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(n, n))
    return amg.CSR.from_scipy(m.tocsr())


# phase 16 with a host read after every Arnoldi step (PERF.md): warm s
HOST_LOOPS_PGMRES = dict(warm_s=(0.266, 0.381))


def _pgmres_graph_vs_host(tag, solver, b, xg, info):
    """solve_pgmres's graph route (``xg``, ``info``) against the same
    program's host loops on the card: equal iterations and x bit for bit
    (both run the same kernels in the same order); logs the host route's
    reads and seconds."""
    from amg_tpu_torch.solve import krylov as K

    syncs = K.counts["syncs"]
    t0 = time.perf_counter()
    xp, ip = solver.solve_pgmres(b, host_loops=True)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    reads = K.counts["syncs"] - syncs
    same = np.array_equal(xg, xp)
    gap = float(np.abs(xg - xp).max() / max(np.abs(xp).max(), 1e-300))
    log(f"[{tag}] graph against host loops on the card: its {info.nits} / "
        f"{ip.nits}; x bit-identical: {same} (max gap {gap:.3e} of "
        f"max|x|); host route {host_s:.4f} s, {reads} host reads of its "
        f"loops")
    check(info.nits == ip.nits and same,
          f"{tag}: graph ({info.nits} its) and host loops ({ip.nits} its) "
          f"differ, x gap {gap:.3e}")
    return dict(host_s=host_s, host_reads=reads, same=same)


def _log_pgmres_graph(tag, solver):
    """The GMRES graph of ``solver``: nodes, segments captured as child
    graphs and in place, build seconds, pool MiB, builds."""
    g = solver.pgmres_graph
    check(g is not None and g.exec is not None,
          f"{tag}: solve_pgmres has no CUDA graph")
    log(f"[{tag}] GMRES graph: {g.nodes} nodes ({g.captures} segments as "
        f"child graphs, {len(g.direct)} captured in place), warm-up, "
        f"capture and instantiate {g.build_seconds:.3f} s, graph pool "
        f"{g.pool_bytes / 2**20:.1f} MiB; builds {solver.pgmres_builds}")
    check(solver.pgmres_builds == 1,
          f"{tag}: the GMRES graph was built {solver.pgmres_builds} times")
    return dict(nodes=g.nodes, build_s=g.build_seconds,
                pool_mib=g.pool_bytes / 2**20, direct=len(g.direct))


def phase_gmres():
    """16. AMG-preconditioned GMRES on the 1M-row convection-diffusion
    operator, f64 cycles on the "auto" layout: true residual below 1e-8 in
    at most 40 iterations through B1's f64 epilogues and the f64 Givens
    and back-substitution kernels, the whole GMRES one CUDA graph (built
    by the cold solve, replayed by the warm one) with 0 host reads of its
    loops, equal to the same program's host loops bit for bit.  Returns
    the kernel rows of every DIA and WEll launch shape of its solve (tags
    "g-") and the krylov_small launches by shape."""
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import krylov_small as KS
    from amg_tpu_torch.params import MAX_RESTART

    a = convection_diffusion(CD_SIDE)
    log(f"[gmres] convection-diffusion {CD_SIDE} x {CD_SIDE} (vel "
        f"{CD_VEL:g}): {a.n_rows} rows, {a.nnz} nnz")
    check(a.n_rows == 1_000_000 and a.nnz == 4_996_000,
          f"convection-diffusion size {a.n_rows} rows, {a.nnz} nnz")
    pars = amg.AMGParams(accel="gmres", tol=1e-8, verbose=0)
    b = np.random.default_rng(16).standard_normal(a.n_rows)
    solver, dia, well, summary = _auto_solver(a, pars, "gmres", b)
    small = summary.pop("krylov_small")
    kc = summary["krylov"]
    m = min(MAX_RESTART, pars.max_it)
    basis_mib = (m + 1) * solver.pad * 8 / 2 ** 20
    log(f"[gmres] formats {_formats(solver)}; GMRES its {summary['nits']} "
        f"(Arnoldi steps {kc['gmres_iters']}, restart {m}); host reads of "
        f"the GMRES loops per solve: {kc['syncs']} (+ 2 by the driver "
        f"before and after); setup {summary['setup_s']:.2f} s, cold solve "
        f"(graph built in it) {summary['solve_s']:.4f} s, warm (a replay) "
        f"{summary['warm_solve_s']:.4f} s against the host-read steps' "
        f"{HOST_LOOPS_PGMRES['warm_s']} s (PERF.md); device memory held "
        f"after setup {summary['mib']:.1f} MiB, GMRES basis V ({m + 1} x "
        f"{solver.pad} f64) {basis_mib:.1f} MiB; krylov_small launches "
        f"{small}")
    check(summary["nits"] <= GMRES_MAX_ITS,
          f"GMRES took {summary['nits']} > {GMRES_MAX_ITS} iterations")
    check(kc["gmres_solves"] == 1 and kc["gmres_iters"] == summary["nits"],
          f"GMRES counts {kc}")
    check(kc["syncs"] == 0, f"the GMRES loops read the host {kc['syncs']} "
                            f"times on the graph route")
    check(all(small.get((e, torch.float64, m), 0) > 0 for e in KS.ENTRIES),
          f"the f64 Givens and back-substitution kernels were not "
          f"launched: {small}")
    f64 = {k[0] for k in dia if k[1] == k[2] == torch.float64}
    check(f64 >= {"spmv", "resid", "update"},
          f"B1 did not run its three epilogues in f64: {sorted(dia, key=str)}")
    summary["graph"] = _log_pgmres_graph("gmres", solver)
    xg, info = solver.solve_pgmres(b)
    torch.cuda.synchronize()
    summary.update(_pgmres_graph_vs_host("gmres", solver, b, xg, info))
    rows = phase_main_shapes(solver, dia, prefix="g-")
    well_rows = (phase_unstructured_shapes(solver, well, prefix="g-")
                 if well else [])
    log(f"[gmres] summary: {summary}")
    del solver
    return rows, well_rows, small


@contextlib.contextmanager
def _trace_coarsest():
    """Record every coarsest solve of the cycles run inside: its ms
    (synchronised on both sides), the Krylov layer's host reads during it,
    CG's per-column statuses and iterations and GMRES's iterations per
    column (-1 where it did not run), read from the solve's state after
    it; the first solve's right-hand side and tolerance are kept.  The
    synchronisations and reads added here are not counted."""
    from amg_tpu_torch.solve import cycle as C, krylov as K

    calls = []
    orig = C.coarsest_solve

    def coarsest(mg, b, pars, ctol):
        torch.cuda.synchronize()
        syncs = K.counts["syncs"]
        t0 = time.perf_counter()
        out = orig(mg, b, pars, ctol)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ks = C.krylov_solver(mg, b, ctol)
        calls.append(dict(
            ms=ms, syncs=K.counts["syncs"] - syncs,
            status=ks.cg.status.reshape(-1).tolist(),
            cg_its=ks.cg.it.reshape(-1).tolist(),
            gmres_its=[i for i in ks.gm_its.tolist() if i >= 0],
            first=(mg, b.clone(), ctol) if not calls else None))
        return out

    C.coarsest_solve = coarsest
    try:
        yield calls
    finally:
        C.coarsest_solve = orig


def _log_coarsest(tag, calls):
    """One line per coarsest solve, each held to 0 host reads (the graph
    route); returns the median ms per coarsest solve."""
    for i, c in enumerate(calls):
        stat = {s: c["status"].count(s) for s in sorted(set(c["status"]))}
        cg_its = c["cg_its"] if len(c["cg_its"]) > 1 else c["cg_its"][0]
        log(f"[{tag}] coarsest solve {i}: CG its {cg_its}, status {stat}; "
            f"GMRES on {len(c['gmres_its'])} column(s), its "
            f"{c['gmres_its']}; {c['ms']:.2f} ms; host reads {c['syncs']}")
        check(c["syncs"] == 0,
              f"{tag}: coarsest solve {i} read the host {c['syncs']} times")
    med = statistics.median(c["ms"] for c in calls)
    log(f"[{tag}] {len(calls)} coarsest solves: median {med:.2f} ms, "
        f"min {min(c['ms'] for c in calls):.2f}, max "
        f"{max(c['ms'] for c in calls):.2f}")
    return med


def _log_graph(tag, ks):
    """The KRYLOV coarsest solve's CUDA graph: nodes, captures, build
    seconds, pool MiB."""
    g = ks.graph
    check(g is not None and g.exec is not None,
          f"{tag}: the coarsest solve has no CUDA graph")
    log(f"[{tag}] coarsest graph for b {tuple(ks.b.shape)}: {g.nodes} nodes "
        f"({g.captures} captured segments as child graphs, while and if "
        f"nodes by the CUDA runtime); warm-up, capture and instantiate "
        f"{g.build_seconds:.3f} s; graph pool {g.pool_bytes / 2**20:.1f} "
        f"MiB")
    return dict(nodes=g.nodes, build_s=g.build_seconds,
                pool_mib=g.pool_bytes / 2**20)


def _cached_krylov(solver, ndim):
    """The KRYLOV coarsest solve ``solver`` made for right-hand sides of
    ``ndim`` dimensions (one vector: 1, a batch: 2)."""
    found = [ks for key, ks in solver.mg.krylov.items()
             if len(key[0]) == ndim]
    check(len(found) == 1, f"{len(found)} KRYLOV coarsest solves for "
                           f"{ndim}-d right-hand sides")
    return found[0]


def _graph_vs_plain(tag, call):
    """The graph route and the plain host loops on the card on one
    coarsest right-hand side of the solve: the same CG statuses and
    iterations, the same GMRES iterations, x within 1e-6 (f32) or 1e-12
    (f64) of ||x||; logs whether x is bit-identical and the plain route's
    host reads."""
    from amg_tpu_torch.solve import cycle as C, krylov as K

    mg, b, ctol = call["first"]
    ks = C.krylov_solver(mg, b, ctol)

    def state():
        return (ks.cg.status.reshape(-1).tolist(),
                ks.cg.it.reshape(-1).tolist(), ks.gm_its.tolist())

    xg = ks.solve(b)
    torch.cuda.synchronize()
    g = state()
    syncs = K.counts["syncs"]
    xp = ks.solve_plain(b)
    torch.cuda.synchronize()
    p = state()
    reads = K.counts["syncs"] - syncs
    gap = ((xg - xp).norm() / xp.norm()).item()
    same = torch.equal(xg, xp)
    tol = 1e-12 if b.dtype == torch.float64 else 1e-6
    log(f"[{tag}] graph against plain host loops on the card, one coarsest "
        f"rhs {tuple(b.shape)}: CG status {g[0]} / {p[0]}, its {g[1]} / "
        f"{p[1]}; GMRES its {g[2]} / {p[2]}; x gap {gap:.3e} of ||x|| "
        f"(<= {tol:g}); bit-identical: {same}; plain route host reads "
        f"{reads}")
    check(g == p, f"{tag}: graph {g} against plain {p}")
    check(gap <= tol, f"{tag}: graph and plain x {gap:.3e} apart")
    return dict(gap=gap, same=same, plain_reads=reads)


def _ulps(a, b):
    """Largest distance in units in the last place between two float
    tensors of one dtype."""
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    mask = (1 << (32 if it == torch.int32 else 64) - 1) - 1

    def line(t):
        i = t.contiguous().view(it).to(torch.int64)
        return torch.where(i < 0, -(i & mask), i)

    return int((line(a) - line(b)).abs().max()) if a.numel() else 0


def _arnoldi_columns(n, m, seed):
    """Raw Hessenberg columns (m, m + 1) and beta of m Arnoldi steps (f64
    numpy, modified Gram-Schmidt) on a seeded nonsymmetric matrix near
    the identity, the kind of column the coarsest GMRES feeds the
    Givens step."""
    rng = np.random.default_rng(seed)
    a = np.eye(n) + 0.4 * rng.standard_normal((n, n)) / np.sqrt(n)
    r = rng.standard_normal(n)
    beta = np.linalg.norm(r)
    V = [r / beta]
    cols = np.zeros((m, m + 1))
    for j in range(m):
        w = a @ V[j]
        for i in range(j + 1):
            cols[j, i] = V[i] @ w
            w = w - cols[j, i] * V[i]
        cols[j, j + 1] = np.linalg.norm(w)
        V.append(w / cols[j, j + 1])
    return cols, beta


def phase_krylov_kernels(launches, m=30):
    """krylov_small.cu's two kernels against their plain versions on the
    card, f32 and f64: 4 seeded restarts of m Givens steps each (120
    columns; two restarts stop inside, so masked steps are included) fed
    the same Arnoldi columns, the step index on the device; rotations, g,
    H and the raw columns held within 4 ulp after every step, done, k_eff,
    j and the step flag equal; the back-substitution of each restart
    within 4 ulp.  Times, in each dtype, one Givens launch (averaged over
    a restart's m steps and the reset of j before them) and one back-
    substitution, each against its plain version (a chain of small torch
    operations) and against an empty one-warp kernel launched the same
    way (the launch's latency floor, ``floor_ms``), the back-substitution
    also against ``torch.linalg.solve_triangular`` on the restart's k_eff
    triangle (its library yardstick).  Returns the kernel rows, f32 (the
    KRYLOV coarsest solve's) and f64 (phase 16's GMRES), with the main
    paths' ``launches``."""
    from amg_tpu_torch.ops import krylov_small as KS

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for dt in (torch.float32, torch.float64):
        worst = dict(givens=0, backsub=0)
        err = dict(givens=0.0, backsub=0.0)
        steps = 0
        for seed, tol in ((0, 1e-6), (1, 1e-12), (2, 1e-5), (3, 1e-12)):
            cols, beta = _arnoldi_columns(200, m, seed)
            hcol = torch.tensor(cols, dtype=dt, device="cuda")
            diag = (torch.arange(m), torch.arange(1, m + 1))
            hnorm = hcol[diag].clone()
            hcol[diag] = 0

            def fresh():
                z = dict(dtype=dt, device="cuda")
                st = dict(hraw=torch.zeros((m, m + 1), **z),
                          H=torch.zeros((m + 1, m), **z),
                          cs=torch.zeros(m, **z), sn=torch.zeros(m, **z),
                          g=torch.zeros(m + 1, **z),
                          done=torch.zeros((), dtype=torch.bool,
                                           device="cuda"),
                          go=torch.ones((), dtype=torch.bool, device="cuda"),
                          j=torch.zeros((), dtype=torch.int32, device="cuda"),
                          k_eff=torch.zeros((), dtype=torch.int32,
                                            device="cuda"),
                          normr0=torch.tensor(beta, **z))
                st["g"][0] = beta
                return st

            def step(fn, st, j, tol):
                fn(hcol[j], hnorm[j], st["j"], st["hraw"], st["H"], st["cs"],
                   st["sn"], st["g"], st["done"], st["k_eff"], st["go"],
                   st["normr0"], tol)

            kst, pst = fresh(), fresh()
            for j in range(m):
                step(KS.givens, kst, j, tol)
                step(KS.givens_plain, pst, j, tol)
                torch.cuda.synchronize()
                steps += 1
                for k in ("hraw", "H", "cs", "sn", "g"):
                    worst["givens"] = max(worst["givens"],
                                          _ulps(kst[k], pst[k]))
                    err["givens"] = max(err["givens"], (kst[k] - pst[k])
                                        .abs().max().item())
                check(all(torch.equal(kst[k], pst[k])
                          for k in ("done", "go", "j", "k_eff")),
                      f"givens {dt} seed {seed} step {j}: done/go/j/k_eff "
                      f"differ")
            yk = KS.backsub(kst["H"], kst["g"], kst["k_eff"])
            yp = KS.backsub_plain(kst["H"], kst["g"], kst["k_eff"])
            worst["backsub"] = max(worst["backsub"], _ulps(yk, yp))
            err["backsub"] = max(err["backsub"],
                                 (yk - yp).abs().max().item())
            log(f"[krylov-small] {str(dt)[6:]} seed {seed} (tol {tol:g}): "
                f"stopped at k_eff {int(kst['k_eff'])} of {m}")
        log(f"[krylov-small] {str(dt)[6:]}: {steps} Givens columns, worst "
            f"{worst['givens']} ulp (max |diff| {err['givens']:.3e}); "
            f"back-substitution worst {worst['backsub']} ulp (max |diff| "
            f"{err['backsub']:.3e})")
        check(worst["givens"] <= 4 and worst["backsub"] <= 4,
              f"krylov_small {dt} kernel against plain: {worst} ulp")
        st = fresh()

        def restart(fn):
            st["j"].zero_()
            for j in range(m):
                step(fn, st, j, 1e-12)

        def floor_restart():
            st["j"].zero_()
            for _ in range(m):
                KS.launch_floor(dev)

        sz = torch.tensor([], dtype=dt).element_size()
        giv = (_time_ms(lambda: restart(KS.givens), flush) / m,
               _time_ms(lambda: restart(KS.givens_plain), flush) / m)
        torch.cuda.synchronize()
        k = int(st["k_eff"])
        check(k > 0, f"the timed restart stopped at k_eff {k}")
        hk, gk = st["H"][:k, :k], st["g"][:k, None]

        def library():
            return torch.linalg.solve_triangular(hk, gk, upper=True)

        bsub = (_time_ms(lambda: KS.backsub(st["H"], st["g"], st["k_eff"]),
                         flush),
                _time_ms(lambda: KS.backsub_plain(st["H"], st["g"],
                                                  st["k_eff"]), flush))
        floor = dict(givens=_time_ms(floor_restart, flush) / m,
                     backsub=_time_ms(lambda: KS.launch_floor(dev), flush))
        # the back-substitution's staging alone: k_eff = 0 runs no row
        no_rows = torch.zeros((), dtype=torch.int32, device="cuda")
        stage_ms = _time_ms(lambda: KS.backsub(st["H"], st["g"], no_rows),
                            flush)
        # the library yardstick of the back-substitution: one triangular
        # solve (cuBLAS) of the first k_eff rows; the Givens step has none
        lib = dict(givens=None, backsub=_time_ms(library, flush))
        lib_gap = (library()[:, 0] - KS.backsub(st["H"], st["g"],
                                                st["k_eff"])[:k]).abs()
        log(f"[krylov-small] {str(dt)[6:]} torch.linalg.solve_triangular on "
            f"the timed restart's {k} x {k} triangle: {lib['backsub']:.4f} "
            f"ms, max |y - backsub| {lib_gap.max().item():.3e}; "
            f"back-substitution {bsub[0]:.4f} ms "
            f"({lib['backsub'] / bsub[0]:.2f}x faster; its launch and "
            f"staging alone, k_eff = 0: {stage_ms:.4f} ms)")
        check(bsub[0] < lib["backsub"],
              f"{dt} back-substitution {bsub[0]:.4f} ms is not below "
              f"solve_triangular's {lib['backsub']:.4f} ms")
        for entry, (ms, plain_ms), nbytes, nflops in (
                # per step on average: the column, its norm, j cs and sn
                # read, hraw's row, H's column, cs, sn, g written
                ("givens", giv, sz * (3 * (m + 1) + (m - 1) + 8) + 16,
                 6 * (m - 1) / 2 + 12),
                # the k_eff triangle and g read, y written
                ("backsub", bsub, sz * (k * (k + 1) / 2 + k + m) + 4,
                 k * (k - 1) + 2 * k)):
            bound_ms, bound_by = _bound(nbytes, nflops, dt)
            n = launches.get((entry, dt, m), 0)
            rows.append(dict(entry=entry, dtype=str(dt)[6:], m=m,
                             launches=n, max_abs_err=err[entry],
                             ulps=worst[entry], ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             floor_ms=floor[entry], lib_ms=lib[entry]))
            lib_s = ("none" if lib[entry] is None
                     else f"{lib[entry]:.4f} ms")
            log(f"[krylov-small] {entry} {str(dt)[6:]} m={m}: kernel "
                f"{ms:.4f} ms, empty one-warp launch {floor[entry]:.4f} ms, "
                f"plain {plain_ms:.4f} ms, library {lib_s}, bound "
                f"{bound_ms:.2e} ms ({bound_by}; latency-bound); main-path "
                f"launches {n}")
    return rows


def _one_shot_vs_plain(tag, op, b, tol):
    """The public ``cg``, ``gmres`` and ``fcg`` on the card, each call one
    CUDA graph built, launched and closed, against ``cg_plain``,
    ``gmres_plain`` and ``fcg_plain`` (the host loops) on the coarsest
    operator ``op`` and one coarsest right-hand side ``b`` from zero at
    ``tol``: wall seconds per call (median of JIT_REPS, synchronised on
    both sides), the same statuses and iterations, x within 1e-6 of
    ||x|| (``fcg``: x, iterations and residual norm bit for bit), no host
    read on the graph route."""
    from amg_tpu_torch.solve import krylov as K

    x0 = torch.zeros_like(b)
    out = {}
    for name, graph, plain, kw in (
            ("cg", K.cg, K.cg_plain, dict(maxit=1000, return_info=True)),
            ("gmres", K.gmres, K.gmres_plain,
             dict(maxit=1000, restart=30, return_iters=True)),
            ("fcg", K.fcg, K.fcg_plain, dict(maxit=1000))):
        res, reads = {}, {}

        def call(f):
            syncs = K.counts["syncs"]
            res[f] = f(op, b, x0, tol=tol, **kw)
            reads[f] = K.counts["syncs"] - syncs

        times = {f: _median_s(lambda f=f: call(f)) for f in (graph, plain)}
        xg, xp = res[graph][0], res[plain][0]
        if name == "cg":
            its = [tuple(int(v) for v in res[f][2]) for f in (graph, plain)]
        elif name == "gmres":
            its = [(bool(res[f][1]), int(res[f][2])) for f in (graph, plain)]
        else:
            its = [(int(res[f][1]), float(res[f][2])) for f in (graph, plain)]
        gap = ((xg - xp).norm() / xp.norm()).item()
        same = torch.equal(xg, xp)
        log(f"[{tag}] public {name} (one graph per call) {times[graph]:.4f} "
            f"s against {name}_plain (host loop) {times[plain]:.4f} s per "
            f"call (median of {JIT_REPS}); status/its {its[0]} / {its[1]}; "
            f"x gap {gap:.3e} of ||x||, bit-identical: {same}; host reads "
            f"{reads[graph]} / {reads[plain]}")
        check(its[0] == its[1] and gap <= 1e-6 and reads[graph] == 0,
              f"{tag}: public {name} {its[0]} against plain {its[1]}, x "
              f"gap {gap:.3e}, {reads[graph]} host reads")
        check(name != "fcg" or same, f"{tag}: fcg differs from fcg_plain")
        out[f"{name}_s"], out[f"{name}_plain_s"] = times[graph], times[plain]
    return out


def _krylov_pgmres(a, hh, pars):
    """solve_pgmres on phase 17's KRYLOV hierarchy (f32 cycles, GMRES in
    f64 around them): the Arnoldi step's cycle runs the coarsest solve's
    while and if nodes, so the step is captured in place in the GMRES
    graph; 0 host reads of the GMRES and coarsest loops, the graph built
    once, the graph against the host loops (equal its, x bit for bit);
    cold and warm seconds."""
    import amg_tpu_torch as amg
    from amg_tpu_torch.solve import krylov as K

    solver = amg.AMGSolver(a, pars.replace(accel="gmres"), host_hierarchy=hh,
                           device="cuda", log=lambda *_: None)
    b = np.ones(a.n_rows)
    syncs = K.counts["syncs"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = solver.solve_pgmres(b)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    reads = K.counts["syncs"] - syncs
    out = _log_pgmres_graph("krylov-gmres", solver)
    check(reads == 0, f"KRYLOV solve_pgmres read the host {reads} times")
    check(out["direct"] == 2, f"KRYLOV GMRES graph: {out['direct']} "
                              f"segments captured in place, not 2")
    warm = _median_s(lambda: solver.solve_pgmres(b))
    true_rel = float(np.linalg.norm(b - a.matvec(x)) / np.linalg.norm(b))
    log(f"[krylov-gmres] solve_pgmres, KRYLOV coarsest: {info.nits} its, "
        f"rres {info.rres:.3e}, true rres (host f64) {true_rel:.3e}; cold "
        f"{cold:.4f} s (graph built in it), warm {warm:.4f} s (median of "
        f"{JIT_REPS}); host reads {reads}")
    check(np.all(np.isfinite(x)) and info.nits <= pars.max_it,
          f"KRYLOV solve_pgmres: {info.nits} its, finite {np.isfinite(x).all()}")
    out.update(its=info.nits, cold_s=cold, warm_s=warm, true_rres=true_rel)
    xg, ig = solver.solve_pgmres(b)
    torch.cuda.synchronize()
    out.update(_pgmres_graph_vs_host("krylov-gmres", solver, b, xg, ig))
    del solver
    return out


# phase 17 with the Krylov loops on the host (PERF.md): cycles and warm s
HOST_LOOPS_KRYLOV = dict(cycles=8, batched_cycles=6, warm_s=3.13,
                         warm_batched_s=5.48)


def phase_krylov_coarsest(a, hh, auto_summary, gmres_launches):
    """17. Phase 13's parameters and host hierarchy ``hh`` with the KRYLOV
    coarsest solver: the solve to 1e-8 through B1 and B2, each coarsest
    solve one CUDA graph of while and if nodes with no host read (its
    ms, statuses and iterations logged), a cycle under
    ``set_sync_debug_mode("error")``, the graph against the plain host
    loops on one coarsest right-hand side, the public ``cg`` and
    ``gmres`` (a graph per call) against their host loops on it,
    krylov_small.cu's kernels against their plain versions; then
    ``solve_batched`` of 16 columns through B4, gated the same way, and
    one of 4 columns, whose coarsest solve replaces the 16 columns' in
    the hierarchy's cache.  Returns the DIA, WEll and B4 kernel
    rows of both solves (tags "k-", "kb-") and the krylov_small rows."""
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import (dia_kernel as D, krylov_small as KS,
                                   well_kernel as W)
    from amg_tpu_torch.solve import cycle as C, krylov as K

    pars = structured_pars(amg).replace(
        use_well="auto", use_banded="auto",
        coarsest_solver=amg.CoarsestSolver.KRYLOV)
    ctol = min(pars.ctol, pars.tol * 0.1)
    b = np.ones(a.n_rows)
    _reset_counts()
    t0 = time.perf_counter()
    solver = amg.AMGSolver(a, pars, host_hierarchy=hh, device="cuda",
                           log=lambda *_: None)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(_formats(solver) == STRUCTURED_AUTO,
          f"KRYLOV formats {_formats(solver)}")
    coarse = solver.mg.levels[-1]
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    _settle_counts()
    dia, well = dict(D.launches_by_shape), dict(W.launches_by_shape)
    small = dict(KS.launches_by_shape)
    kc = dict(K.counts)
    true_rel = float(np.linalg.norm(b - a.matvec(x.astype(np.float64)))
                     / np.linalg.norm(b))
    n_cs = max(kc["cg_solves"], 1)
    log(f"[krylov] coarsest level: {coarse.n} rows, "
        f"{type(coarse.a).__name__} {str(coarse.a.vals.dtype)[6:]}; ctol "
        f"{ctol:g}")
    log(f"[krylov] setup {setup_s:.2f} s (host hierarchy of phase 13), cold "
        f"solve {info.solve_seconds:.4f} s (the coarsest graph built in "
        f"it), cycles {info.nits} (host loops: "
        f"{HOST_LOOPS_KRYLOV['cycles']}; phase 13, dense coarsest inverse: "
        f"{auto_summary['nits']}), rres "
        f"{info.rres:.3e}, true rres (host f64) {true_rel:.3e}")
    log(f"[krylov] per coarsest solve ({kc['cg_solves']} solves): CG its "
        f"{kc['cg_iters'] / n_cs:.1f}, not converged {kc['cg_failed']}; GMRES "
        f"runs {kc['gmres_solves']}, its {kc['gmres_iters'] / n_cs:.1f}; "
        f"host reads of the Krylov loops {kc['syncs']}; krylov_small "
        f"launches {dict(KS.launches)}")
    check(np.all(np.isfinite(x)) and true_rel < 1e-8,
          f"KRYLOV solve did not reach 1e-8 (true rres {true_rel:.3e})")
    check(abs(info.nits - HOST_LOOPS_KRYLOV["cycles"]) <= 1,
          f"KRYLOV solve took {info.nits} cycles")
    check(kc["cg_solves"] > 0, "the KRYLOV coarsest solver did not run")
    check(kc["syncs"] == 0, f"the Krylov loops read the host {kc['syncs']} "
                            f"times on the graph route")
    check(all(small.get((e, torch.float32, 30), 0) > 0 for e in KS.ENTRIES),
          f"krylov_small's kernels were not launched: {small}")
    wells = [lv.a for lv in solver.mg.levels if isinstance(lv.a, amg.WEll)]
    check(sum(dia.values()) > 0 and all(
        well.get(("spmv", op.vals.dtype, op.n_rows, op.nnz), 0) > 0
        for op in wells), "B1 or B2 (on the WEll level's A) was not launched")
    summary = dict(cycles=info.nits, true_rres=true_rel)
    summary["graph"] = _log_graph("krylov", _cached_krylov(solver, 1))
    summary["steps"] = _step_graphs("krylov", solver)
    # the coarsest solves timed one by one: the eager steps (a replayed
    # step graph runs them inside), equal to the graph route bit for bit
    with _trace_coarsest() as calls:
        traced = solver.solve(b, eager=True)
    _same_solve("krylov", (x, info), traced)
    summary["ms_per_solve"] = _log_coarsest("krylov", calls)
    bd = solver._pad_vec(b)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        C.cycle(solver.mg, torch.zeros_like(bd), bd, solver.pars)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    log("[krylov] one cycle under torch.cuda.set_sync_debug_mode('error'): "
        "no synchronizing call")
    warm = _median_s(lambda: solver.solve(b))
    summary["warm_s"] = warm
    log(f"[krylov] warm solve (median of {JIT_REPS}) {warm:.4f} s against "
        f"the host loops' {HOST_LOOPS_KRYLOV['warm_s']} s; coarsest solves "
        f"{sum(c['ms'] for c in calls):.1f} ms of the traced solve")
    summary.update(_graph_vs_plain("krylov", calls[0]))
    summary.update(_one_shot_vs_plain("krylov", coarse.a,
                                      calls[0]["first"][1], ctol))
    dia_rows = phase_main_shapes(solver, dia, prefix="k-")
    well_rows = phase_unstructured_shapes(solver, well, prefix="k-")
    summary["pgmres"] = _krylov_pgmres(a, hh, pars)
    small_rows = phase_krylov_kernels({**small, **gmres_launches})

    # batched: one CG over the columns per coarsest solve, GMRES per
    # failed column
    B = np.random.default_rng(17).standard_normal((a.n_rows, N_RHS))
    _reset_counts()
    t0 = time.perf_counter()
    X, binfo = solver.solve_batched(B, tol=BATCH_TOL)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    _settle_counts()
    multi, wellb = dict(D.launches_by_shape), dict(W.launches_by_shape)
    launches = dict(D.launches)
    kcb = dict(K.counts)
    nb = np.linalg.norm(B, axis=0)
    true_b = np.array([np.linalg.norm(B[:, c] - a.matvec(
        X[:, c].astype(np.float64))) / nb[c] for c in range(N_RHS)])
    summary["batched_graph"] = _log_graph("krylov-batch",
                                          _cached_krylov(solver, 2))
    summary["batched_steps"] = _step_graphs("krylov-batch", solver,
                                            ("batched",))
    with _trace_coarsest() as calls:
        traced = solver.solve_batched(B, tol=BATCH_TOL, eager=True)
    _same_solve("krylov-batch", (X, binfo), traced)
    summary["batched_ms_per_solve"] = _log_coarsest("krylov-batch", calls)
    per_col = [{s: sum(c["status"][col] == s for c in calls)
                for s in sorted({c["status"][col] for c in calls})}
               for col in range(N_RHS)]
    log(f"[krylov-batch] k={N_RHS}: cold {cold_s:.4f} s (graph built in "
        f"it), its {binfo.nits} (host loops: "
        f"{HOST_LOOPS_KRYLOV['batched_cycles']}), "
        f"true rres worst {true_b.max():.3e} best {true_b.min():.3e}; "
        f"coarsest CG statuses per column over {len(calls)} solves: "
        f"{per_col}; host reads of the Krylov loops {kcb['syncs']}; DIA "
        f"launches {launches}")
    check(np.all(np.isfinite(X)) and np.all(true_b < BATCH_TOL),
          f"KRYLOV batched solve: true rres {true_b}")
    check(abs(binfo.nits - HOST_LOOPS_KRYLOV["batched_cycles"]) <= 1,
          f"KRYLOV batched solve took {binfo.nits} cycles")
    check(kcb["syncs"] == 0, f"the batched Krylov loops read the host "
                             f"{kcb['syncs']} times")
    check(all(launches[e] == 0 for e in D.EPILOGUES) and
          launches["multi_update"] > 0,
          f"the batched solve did not run through B4 alone: {launches}")
    summary.update({f"batched_{k}": v for k, v in _graph_vs_plain(
        "krylov-batch", calls[0]).items()})
    warm_b = _median_s(lambda: solver.solve_batched(B, tol=BATCH_TOL))
    summary["warm_batched_s"] = warm_b
    log(f"[krylov-batch] warm (median of {JIT_REPS}) {warm_b:.4f} s against "
        f"the host loops' {HOST_LOOPS_KRYLOV['warm_batched_s']} s")
    multi_rows = _multi_shapes(solver, multi, prefix="kb-")
    well_rows += phase_unstructured_shapes(solver, wellb, prefix="kb-")
    # a second batch width replaces the first one's coarsest solve, graph
    # and pool in the hierarchy's cache
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    X4, info4 = solver.solve_batched(B[:, :4], tol=BATCH_TOL)
    torch.cuda.synchronize()
    ks4 = _cached_krylov(solver, 2)
    check(tuple(ks4.b.shape)[0] == 4 and np.all(np.isfinite(X4)),
          f"KRYLOV batch of 4 after 16: cached {tuple(ks4.b.shape)}")
    summary["batched4_graph"] = _log_graph("krylov-batch4", ks4)
    log(f"[krylov-batch4] k=4 after k={N_RHS}: its {info4.nits}; one "
        f"batched coarsest solve cached, device MiB allocated after "
        f"against before "
        f"{(torch.cuda.memory_allocated() - mem0) / 2**20:+.1f}")
    log(f"[krylov] summary: {summary}")
    del solver
    return dia_rows, well_rows, multi_rows, small_rows


# ---------------------------------------------------------------------------
# 18. the SPMD solve on a ring of row shards
# ---------------------------------------------------------------------------


SPMD_SHARDS = 4            # row shards on the one card


def spmd_pars(amg):
    """bench_dist.py's production mode ``spmd-cg`` for poisson3d
    (bench_dist.py:136-145): f32 cycles, FCG in f64 against the exact
    row-sharded level-0 operator, Chebyshev below level 0, bf16 coarse
    operators, WEll on "auto" from 65,536 rows."""
    return amg.AMGParams(
        tol=1e-8, dtype="float32", refine=True, verbose=0,
        coarse_smoother=amg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="bfloat16", use_well="auto", well_min_rows=65536,
        accel="cg")


def _sharded_ops(solver):
    """(tag, sharded Dia operator) of every operator of the ring: A, P and
    R of the sharded levels 0..E and the f64 level-0 operator of FCG."""
    ops = []
    for l in range(solver.E + 1):
        for name in ("a", "p", "r"):
            op = getattr(solver.mg.levels[l], name)
            if op is not None:
                ops.append((f"{name.upper()}{l}", op))
    if solver.a0_hi is not None:
        ops.append(("a0_hi", solver.a0_hi))
    return ops


def _compare_window(tag, op, mesh, g, flush):
    """B1's window entry against its plain version on one sharded operator,
    on random x shards haloed by the ring (``halo.ring_windows``), held to
    TOL of max|Ax|; timed beside the whole ring product (windows and
    launch), the single-device B1 ``spmv`` of the same operator and the
    fastest torch sparse CSR product of its nonzero entries over the
    shards' rows (int64 or int32 indices).  Returns one result row."""
    from amg_tpu_torch.ops import dia_kernel as K
    from amg_tpu_torch.parallel import halo

    nd, cols = op.vals.shape
    S = mesh.local
    m = cols // S
    vdt = op.vals.dtype
    xdt = torch.float64 if vdt == torch.float64 else torch.float32
    x = torch.randn(S, m, generator=g, dtype=xdt).cuda()
    lo, hi = halo.dia_halo_widths(op.offsets)
    xw, lo_w = halo.ring_windows(x, lo, hi, mesh)
    want = K.spmv_window_plain(op, xw, lo_w)
    got = K.spmv_window(op, xw, lo_w)
    torch.cuda.synchronize()
    check(got.dtype == xdt and got.shape == (S, m),
          f"{tag}: window output {got.dtype} {tuple(got.shape)}")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    ok = err <= TOL[vdt] * scale
    ms = _time_ms(lambda: K.spmv_window(op, xw, lo_w), flush)
    plain_ms = _time_ms(lambda: K.spmv_window_plain(op, xw, lo_w), flush)
    ring_ms = _time_ms(lambda: halo.dia_spmv_ring_local(op, x, mesh), flush)
    xg = x.reshape(-1)
    single_ms = _time_ms(lambda: K.spmv(op, xg), flush)
    lib = _dia_csr_on_card(op, xdt)
    lib_ms = min(_time_ms(lambda v=v: v @ xg, flush)
                 for v in (lib, _int32_csr(lib)))
    del lib
    # values once, the haloed x once, y written once
    nbytes = nd * cols * op.vals.element_size() \
        + (lo + cols + hi + cols) * x.element_size()
    bound_ms, bound_by = _bound(nbytes, 2 * nd * cols, xdt)
    row = dict(op=tag, nd=nd, m=m, S=S, lo=lo, hi=hi, vals=str(vdt)[6:],
               x=str(xdt)[6:], max_abs_err=err, rel_err=err / scale,
               tol=TOL[vdt], ok=ok, ms=ms, plain_ms=plain_ms,
               ring_ms=ring_ms, single_ms=single_ms, lib_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               gbps=nbytes / ms / 1e6)
    log(f"[spmd] {tag:6s} nd={nd:3d} m={m} S={S} lo={lo} hi={hi} "
        f"{row['vals']:8s}/{row['x']:7s} err {err:.3e} (rel "
        f"{err / scale:.2e} <= {TOL[vdt]:g}: {ok})  window {ms:.4f} ms "
        f"{row['gbps']:.1f} GB/s, ring product {ring_ms:.4f} ms; "
        f"single-device B1 {single_ms:.4f} ms; torch CSR {lib_ms:.4f} ms; "
        f"bound {bound_ms:.4f} ms ({bound_by}); plain {plain_ms:.4f} ms")
    return row


# the sharded Krylov solves of phase 18 and of tests/_torch_mh_worker.py:
# the f64 ring product of poisson3d from zero, GMRES right-preconditioned
# by Jacobi
RING_KRYLOV = {"cg": dict(tol=1e-10, maxit=1000),
               "gmres": dict(tol=1e-10, maxit=1000, restart=30),
               "fcg": dict(tol=1e-10, maxit=1000)}


def ring_krylov(kind, a, b, mesh, plain=False):
    """``krylov.<kind>`` (``plain``: ``<kind>_plain``, its host loop) of
    ``a`` row-sharded as f64 Dia on ``mesh``, the product the ring's (B1's
    window entry and the halo messages), every dot and norm the mesh's
    ``psum``, from zero at ``RING_KRYLOV[kind]``.  Returns a dict: ``x`` (fetched, the same on every
    process), ``status`` (cg: its status code; gmres: converged; fcg:
    ||r|| / ||b|| below tol), ``its``, ``reads`` (host reads of the Krylov
    loops), ``s`` (wall seconds to a synchronised end; a graph is built by
    its call) and the route's graph (``krylov.last_graph``: nodes, build
    seconds, NCCL event nodes taken out of its loop bodies) or None."""
    from amg_tpu_torch.parallel import halo, multihost
    from amg_tpu_torch.parallel.dist import shard_dia, shard_vector
    from amg_tpu_torch.solve import krylov
    from amg_tpu_torch.sparse import Dia

    kw = dict(RING_KRYLOV[kind])
    d = shard_dia(Dia.from_csr(a, dtype=torch.float64, device=mesh.device),
                  mesh)
    bs = shard_vector(b, mesh, pad_to=d.padded_rows)
    x0 = torch.zeros_like(bs)

    def amul(v):
        return halo.dia_spmv_ring_local(d, v, mesh)

    if kind == "gmres":
        diag = d.vals[list(d.offsets).index(0)].reshape(bs.shape)
        dinv = torch.where(diag != 0, 1 / diag, torch.zeros_like(diag))
        kw["M"] = lambda r: dinv * r
        kw["return_iters"] = True
    elif kind == "cg":
        kw["return_info"] = True
    fn = getattr(krylov, kind + ("_plain" if plain else ""))
    route = krylov._route(bs.device, mesh.psum, not plain)
    krylov.last_graph.clear()
    syncs = krylov.counts["syncs"]
    t0 = time.perf_counter()
    out = fn(amul, bs, x0, psum=mesh.psum, **kw)
    if bs.is_cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    reads = krylov.counts["syncs"] - syncs
    if kind == "cg":
        x, _, (status, its) = out
    elif kind == "gmres":
        x, status, its = out
    else:
        x, its, absres = out
        normb = krylov.norm2(bs, mesh.psum)
        status = absres / normb < kw["tol"]
    return dict(x=multihost.fetch(x, mesh)[: a.n_rows], status=int(status),
                its=int(its), reads=reads, s=seconds, route=route,
                graph=dict(krylov.last_graph) if route == "graph" else None)


def _sharded_krylov(a, mesh, tag, ref=None):
    """The sharded Krylov path: ``cg``, ``gmres`` and ``fcg`` with the
    mesh's ``psum`` on ``a``'s f64 ring product at full width
    (:func:`ring_krylov`, b = A x of a seeded x), the counts set to 0
    just before the three graph-route solves and read just after; then
    each again (warm) and on its host loop (``<kind>_plain``).  Gates:
    route "graph", 0 host reads, equal to the host loop bit for bit
    (status, iterations, x), the host f64 true relative residual below
    1e-8 and, with ``ref`` (the in-process run's results), x equal to it
    bit for bit.  Returns the results by kind and the cold
    runs' launches of B1 and of the Krylov kernels by shape."""
    from amg_tpu_torch.ops import dia_kernel as D, krylov_small as KS

    b = a.matvec(np.random.default_rng(23).standard_normal(a.n_rows))
    _reset_counts()
    cold = {k: ring_krylov(k, a, b, mesh) for k in RING_KRYLOV}
    _settle_counts()
    launches = (dict(D.launches_by_shape), dict(KS.launches_by_shape))
    out = {}
    for kind, g in cold.items():
        warm = ring_krylov(kind, a, b, mesh)
        p = ring_krylov(kind, a, b, mesh, plain=True)
        same = (g["status"], g["its"]) == (p["status"], p["its"]) and \
            np.array_equal(g["x"], p["x"]) and np.array_equal(warm["x"],
                                                              g["x"])
        rres = float(np.linalg.norm(b - a.matvec(g["x"]))
                     / np.linalg.norm(b))
        gr = g["graph"] or {}
        log(f"[{tag}] {kind} ({mesh.describe()}): route {g['route']!r}, "
            f"status {g['status']}, {g['its']} its, host reads {g['reads']} "
            f"(host loop {p['reads']}); graph {gr.get('nodes')} nodes, "
            f"built in {gr.get('build_s', 0):.3f} s, {gr.get('events')} "
            f"NCCL event nodes taken out of its loop bodies; cold "
            f"{g['s']:.4f} s, warm {warm['s']:.4f} s (each call builds "
            f"its graph), host loop {p['s']:.4f} s; true rres {rres:.3e}; "
            f"= host loop bit for bit: {same}")
        check(g["route"] == "graph" and g["reads"] == 0 and warm["reads"]
              == 0, f"{tag} {kind}: route {g['route']}, {g['reads']} reads")
        check(same, f"{tag} {kind}: graph ({g['status']}, {g['its']}) and "
                    f"host loop ({p['status']}, {p['its']}) differ")
        check(g["status"] == 1 and rres < 1e-8,
              f"{tag} {kind}: status {g['status']}, true rres {rres:.3e}")
        if ref is not None:
            check(g["its"] == ref[kind]["its"]
                  and np.array_equal(g["x"], ref[kind]["x"]),
                  f"{tag} {kind}: differs from the in-process run")
        out[kind] = dict(g, warm_s=warm["s"], plain_s=p["s"],
                         plain_reads=p["reads"], true_rres=rres)
    return out, launches


def _spmd_solver(a, pars, mesh, b, solver_cls=None, tag="ring"):
    """An SpmdAMGSolver (or ``solver_cls``) on ``mesh`` (counts reset just
    before), solved cold and warm; its step graphs against its eager steps
    (:func:`_graph_vs_eager`) on a mesh of this process alone and in an
    NCCL group alike (route "graph": the group's collectives are captured).
    Returns the solver, the cold solution and info, the cold run's DIA and
    WEll launches by shape, the ring and collective counts, and the setup
    seconds, device MiB, warm solve seconds and step graphs."""
    from amg_tpu_torch.ops import dia_kernel as D, well_kernel as W
    from amg_tpu_torch.parallel import SpmdAMGSolver, dist as pdist, halo

    _reset_counts()
    for c in (halo.counts, pdist.counts):
        for k in c:
            c[k] = 0
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    solver = (solver_cls or SpmdAMGSolver)(a, pars, mesh=mesh,
                                           log=lambda *_: None)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mib = (torch.cuda.memory_allocated() - mem0) / 2**20
    x, info = solver.solve(b)
    torch.cuda.synchronize()
    by_shape = (dict(D.launches_by_shape), dict(W.launches_by_shape))
    counts = dict(halo.counts, **pdist.counts)
    _, info2 = solver.solve(b)
    torch.cuda.synchronize()
    log(f"[{tag}] {mesh.describe()}: steps {solver.steps.describe()} "
        f"(route {solver.steps.route!r})")
    steps = _graph_vs_eager(tag, solver, solver.solve, b, (x, info))
    return solver, x, info, by_shape, counts, dict(
        setup_s=setup_s, mib=mib, warm_s=info2.solve_seconds, steps=steps)


def phase_spmd(a, emb_summary):
    """18. poisson3d(100) in bench_dist.py's spmd-cg mode on a ring of 4
    row shards on the card, then inside a one-rank NCCL process group; the
    sharded Krylov path on both.  Returns the window entry's rows and the
    Krylov kernels' launches of the sharded Krylov path."""
    import socket
    import torch.distributed as tdist
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import dia_kernel as D
    from amg_tpu_torch.parallel import halo, make_mesh, multihost
    from amg_tpu_torch.parallel.dist import shard_dia
    from amg_tpu_torch.sparse import Dia

    pars = spmd_pars(amg)
    b = np.ones(a.n_rows)
    # the single-device reference: solve_pcg, same parameters, embedded
    _reset_counts()
    t0 = time.perf_counter()
    single = amg.AMGSolver(a, pars.replace(embed_levels=8), device="cuda",
                           log=lambda *_: None)
    torch.cuda.synchronize()
    single_setup_s = time.perf_counter() - t0
    x1, i1 = single.solve(b)
    torch.cuda.synchronize()
    single_b1 = sum(n for k, n in D.launches_by_shape.items()
                    if k[0] in D.EPILOGUES)
    log(f"[spmd] single-device solve_pcg (embed_levels=8): setup "
        f"{single_setup_s:.2f} s, {i1.nits} FCG its, rres {i1.rres:.3e}, "
        f"solve {i1.solve_seconds:.4f} s, B1 launches {single_b1} "
        f"({single_b1 / max(i1.nits, 1):.1f} per FCG iteration; phase 14's "
        f"solve_refined: {emb_summary['b1']} in {emb_summary['cycles']} "
        f"cycles)")
    del single

    mesh = make_mesh(SPMD_SHARDS, device="cuda")
    check(mesh.device.type == "cuda" and mesh.world == 1
          and mesh.local == SPMD_SHARDS, f"mesh {mesh}")
    solver, x, info, (by_shape, _), counts, summ = _spmd_solver(
        a, pars, mesh, b, tag="spmd")
    log(f"[spmd] {mesh.describe()}; pad {solver.pad} = {SPMD_SHARDS} x "
        f"{solver.m_local} rows; E = {solver.E}")
    for l, lv in enumerate(solver.mg.levels):
        desc = [f"{type(lv.a).__name__} {str(lv.a.vals.dtype)[6:]}"]
        if l <= solver.E:
            desc.append("row-sharded")
        log(f"[spmd] level {l}: {lv.n} rows, {', '.join(desc)}")
    m = solver.m_local
    for tag, op in _sharded_ops(solver):
        lo, hi = halo.dia_halo_widths(op.offsets)
        log(f"[spmd] {tag}: nd={op.n_diags} {str(op.vals.dtype)[6:]}, halo "
            f"lo {lo} hi {hi} ({-(-lo // m)} / {-(-hi // m)} hop(s))")
    true_rel = float(np.linalg.norm(b - a.matvec(x.astype(np.float64)))
                     / np.linalg.norm(b))
    gap = float(np.linalg.norm(x - x1) / np.linalg.norm(x1))
    its = max(info.nits, 1)
    windows = sum(n for k, n in by_shape.items() if k[0] == D.WINDOW)
    log(f"[spmd] setup {summ['setup_s']:.2f} s (single-device "
        f"{single_setup_s:.2f}), device memory held after setup "
        f"{summ['mib']:.1f} MiB, cold solve {info.solve_seconds:.4f} s, warm "
        f"{summ['warm_s']:.4f} s (single-device {i1.solve_seconds:.4f}), "
        f"{info.nits} FCG its (single-device {i1.nits}), rres "
        f"{info.rres:.3e}, true rres (host f64) {true_rel:.3e}, "
        f"||x_spmd - x_single|| / ||x_single|| {gap:.3e}")
    log(f"[spmd] per FCG iteration: {windows / its:.1f} window launches, "
        f"{counts['products'] / its:.1f} ring products, "
        f"{counts['halo_bytes'] / its / 2**20:.2f} MiB of halo, "
        f"{counts['p2p'] / its:.1f} exchanges between processes, "
        f"{counts['psum'] / its:.1f} psums; single-device B1 launches "
        f"{single_b1 / max(i1.nits, 1):.1f}")
    for k, n in sorted(by_shape.items(), key=str):
        log(f"[spmd]   {k[0]} {str(k[1])[6:]}/{str(k[2])[6:]} "
            f"{', '.join(map(str, k[3:]))}: {n}")
    check(np.all(np.isfinite(x)) and x.shape == (a.n_rows,),
          "spmd: solution not finite or wrong shape")
    check(true_rel < 1e-8, f"spmd: true rres {true_rel:.3e}")
    check(abs(info.nits - i1.nits) <= 1,
          f"spmd: {info.nits} FCG its against {i1.nits} single-device")
    for tag, op in _sharded_ops(solver):
        xdt = torch.float64 if op.vals.dtype == torch.float64 \
            else torch.float32
        key = (D.WINDOW, op.vals.dtype, xdt, op.n_diags, m, SPMD_SHARDS)
        check(by_shape.get(key, 0) > 0,
              f"spmd: window entry not launched on {tag} {key}")
    single_on_ring = [k for k in by_shape
                      if k[0] in D.EPILOGUES and k[4] == solver.pad]
    check(not single_on_ring,
          f"spmd: single-device B1 launched on a sharded level: "
          f"{single_on_ring}")

    # the window entry against plain at every launch shape of the solve
    g = torch.Generator().manual_seed(18)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = []
    for key, n in sorted(by_shape.items(), key=str):
        if key[0] != D.WINDOW:
            continue
        match = [(tag, op) for tag, op in _sharded_ops(solver)
                 if (D.WINDOW, op.vals.dtype, key[2], op.n_diags, m,
                     SPMD_SHARDS) == key]
        check(match, f"no sharded operator has the window shape {key}")
        rows.append(_one_row([_compare_window("s-" + tag, op, mesh, g, flush)
                              for tag, op in match], n))

    # the sharded Krylov path on the same ring: cg, gmres and fcg with the
    # mesh's psum, each one CUDA graph; B1's window entry on poisson3d's
    # f64 operator, K1 and K2 on every Arnoldi step and restart end of
    # gmres
    del solver
    kry, (kdia, ksmall) = _sharded_krylov(a, mesh, "spmd-krylov")
    kd = shard_dia(Dia.from_csr(a, dtype=torch.float64, device="cuda"),
                   mesh)
    key = (D.WINDOW, torch.float64, torch.float64, kd.n_diags,
           kd.vals.shape[1] // SPMD_SHARDS, SPMD_SHARDS)
    check(kdia.get(key, 0) > 0 and set(kdia) == {key},
          f"spmd-krylov: window launches {kdia}, expected only {key}")
    for entry in ("givens", "backsub"):
        check(ksmall.get((entry, torch.float64,
                          RING_KRYLOV["gmres"]["restart"]), 0) > 0,
              f"spmd-krylov: {entry} not launched: {ksmall}")
    log(f"[spmd-krylov] launches of the three solves: window {kdia[key]}, "
        f"Krylov kernels {ksmall}")
    rows.append(_one_row([_compare_window("k-A0f64", kd, mesh, g, flush)],
                         kdia[key]))
    del kd, flush
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"window entry disagrees with its plain version: {bad}")

    # the same solve and Krylov path inside a one-rank NCCL process group
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    check(multihost.initialize(f"localhost:{port}", 1, 0, device="cuda"),
          "NCCL process group not initialized")
    try:
        check(tdist.get_backend() == "nccl", f"backend {tdist.get_backend()}")
        gmesh = make_mesh(SPMD_SHARDS, device="cuda")
        check(gmesh.group is not None, "mesh without its process group")
        _, x2, info2, _, counts2, summ2 = _spmd_solver(a, pars, gmesh, b,
                                                       tag="spmd-nccl")
        st = summ2["steps"]
        log(f"[spmd-nccl] one rank, {gmesh.describe()}: {info2.nits} FCG its, "
            f"cold {info2.solve_seconds:.4f} s, warm graph "
            f"{st['warm_graph_s']:.4f} s / eager {st['warm_eager_s']:.4f} s, "
            f"{counts2['psum']} psums through NCCL all_reduce; x equal bit "
            f"for bit to the in-process run: {np.array_equal(x2, x)}")
        check(info2.nits == info.nits and np.array_equal(x2, x),
              "spmd: the one-rank NCCL run differs from the in-process run")
        _sharded_krylov(a, gmesh, "spmd-nccl-krylov", ref=kry)
    finally:
        tdist.destroy_process_group()
    return rows, ksmall


# ---------------------------------------------------------------------------
# 19. the general SPMD mode: fem2d on a ring of row shards
# ---------------------------------------------------------------------------


def general_pars(amg):
    """bench_dist.py's parameters for ``AMG_DIST_MATRIX=fem2d``
    (bench_dist.py:136-145): f32 cycles, FCG in f64 (``refine``),
    Chebyshev below level 0, f32 coarse operators, WEll on from 1,024
    rows; ``use_banded`` on "auto" (on for a ring)."""
    return amg.AMGParams(
        tol=1e-8, dtype="float32", refine=True, verbose=0,
        coarse_smoother=amg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="float32", use_well="on", well_min_rows=1024,
        accel="cg")


def _general_ops(solver):
    """(tag, sharded WEll operator, window entry, input) of every WEll
    operator of the general ring: A, P and R of the sharded levels
    0..Es, each a ring product (input "ring"), except at a ring-R boundary
    level Es's P, applied to the whole coarse vector (input "full"; at an
    all-gather boundary level Es's P and R are replicated and not listed),
    and the df64 operator of FCG."""
    import amg_tpu_torch as amg

    ops = []
    for l in range(solver.Es + 1):
        lv = solver.mg.levels[l]
        for name in ("a", "p", "r"):
            op = getattr(lv, name)
            if not isinstance(op, amg.WEll) or (
                    l == solver.Es and name != "a" and not solver.ring_r):
                continue
            full = l == solver.Es and name == "p"
            ops.append((f"{name.upper()}{l}", op, "window",
                        "full" if full else "ring"))
    if solver.a0_hi is not None:
        ops.append(("a0_hi", solver.a0_hi, "df64_window", "ring"))
    return ops


def _compare_well_window(tag, op, entry, mode, mesh, g, flush):
    """B2's (``entry="window"``) or B3's (``"df64_window"``) window entry
    against its plain version on one sharded WEll operator, on a random x
    as the ring gives it (this process's haloed block, ``mode="ring"``, or
    the whole coarse vector at col0 = 0, ``"full"``), held to TOL of
    max|Ax|; timed beside the whole ring product (halo build and launch),
    the single-device B2/B3 entry on the same operator (one process holds
    every shard: the block is the whole operator), the fastest torch
    sparse CSR product of its rows and its bound (B2/B3's bytes with x as
    the window, halos included).  Returns one result row."""
    from amg_tpu_torch.ops import well_kernel as K
    from amg_tpu_torch.parallel import halo

    df64 = entry == "df64_window"
    fn, plain, single = (
        (K.spmv_df64_window, K.spmv_df64_window_plain, K.spmv_df64) if df64
        else (K.spmv_window, K.spmv_window_plain, K.spmv))
    vdt = op.rows.vals.dtype
    xdt = torch.float64 if (df64 or vdt == torch.float64) else torch.float32
    tol = TOL[torch.float64 if df64 else vdt]
    S, m_in = mesh.local, op.pad_cols // mesh.n_shards
    if mode == "full":
        xw, col0 = torch.randn(op.pad_cols, generator=g, dtype=xdt).cuda(), 0
        xg = xw

        def ring():
            return halo.well_spmv_local_full(op, xw)
    else:
        x = torch.randn(S, m_in, generator=g, dtype=xdt).cuda()
        xw, col0 = halo.well_ring_window(op, x, mesh)
        xg = x.reshape(-1)

        def ring():
            return halo.well_spmv_ring_local(op, x, mesh)
    want = plain(op, xw, col0)
    got = fn(op, xw, col0)
    torch.cuda.synchronize()
    check(got.dtype == xdt and got.shape == (op.padded_rows,),
          f"{tag}: window output {got.dtype} {tuple(got.shape)}")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    ok = err <= tol * scale
    ms = _time_ms(lambda: fn(op, xw, col0), flush)
    plain_ms = _time_ms(lambda: plain(op, xw, col0), flush)
    ring_ms = _time_ms(ring, flush)
    single_ms = _time_ms(lambda: single(op, xg), flush)
    csr = op.rows.to_csr((op.padded_rows, op.pad_cols))
    lib_variants = {idx: _time_ms(lambda lib=lib: lib @ xg, flush)
                    for idx, lib in _lib_variants(csr, xdt).items()}
    lib_ms = min(lib_variants.values())
    nbytes, nnz = _layout_bytes(op, df64, xw.shape[0], xw.element_size())
    bound_ms, bound_by = _bound(nbytes, 2 * nnz, xdt)
    lo128, hi128 = op.ring_plan or (0, 0)
    row = dict(op=tag, entry=entry, vals=str(vdt)[6:], x=str(xdt)[6:],
               rows=op.n_rows, nnz=nnz, n_x=xw.shape[0], col0=col0,
               mode=mode, lo=lo128 * 128, hi=hi128 * 128, S=S,
               slices=op.rows.n_slices, max_abs_err=err,
               rel_err=err / scale, tol=tol, ok=ok, ms=ms,
               plain_ms=plain_ms, ring_ms=ring_ms, single_ms=single_ms,
               lib_ms=lib_ms, lib_variants=lib_variants, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, gbps=nbytes / ms / 1e6)
    log(f"[general] {tag:8s} {entry:11s} {row['vals']:7s}/{row['x']:7s} "
        f"rows={op.n_rows} nnz={nnz} {mode} window {xw.shape[0]} (col0 "
        f"{col0}, lo {row['lo']}, hi {row['hi']}) err {err:.3e} (rel "
        f"{err / scale:.2e} <= {tol:g}: {ok})  window {ms:.4f} ms "
        f"{row['gbps']:.1f} GB/s, ring product {ring_ms:.4f} ms; "
        f"single-device {single_ms:.4f} ms; torch CSR {lib_ms:.4f} ms "
        f"(int64 {lib_variants['int64']:.4f}, int32 "
        f"{lib_variants['int32']:.4f}); bound {bound_ms:.4f} ms "
        f"({bound_by}, {nbytes / 1e6:.1f} MB); plain {plain_ms:.4f} ms")
    return row


def _general_run(a, pars, tag, b, mesh):
    """The single-device ``solve_pcg`` of ``pars`` packed for the mesh's
    ring (``dist_devices``), then ``SpmdAMGSolver`` on ``mesh`` (counts
    reset just before), logged and checked: a host-checked true rres below
    1e-8, FCG its within 1 of the single-device solve, B2's window entry
    launched on every sharded WEll operator and B3's on the df64 operator,
    no single-device B2/B3 product on a sharded operator.  Returns the
    solver, its cold solution and info, its WEll launches by shape and
    its summary."""
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import well_kernel as W

    t0 = time.perf_counter()
    single = amg.AMGSolver(a, pars.replace(dist_devices=mesh.n_shards),
                           device="cuda", log=lambda *_: None)
    torch.cuda.synchronize()
    single_setup_s = time.perf_counter() - t0
    x1, i1 = single.solve(b)
    _, i1w = single.solve(b)
    torch.cuda.synchronize()
    del single
    log(f"[{tag}] single-device solve_pcg (dist_devices="
        f"{mesh.n_shards} packing): setup {single_setup_s:.2f} s, "
        f"{i1.nits} FCG its, rres {i1.rres:.3e}, cold "
        f"{i1.solve_seconds:.4f} s, warm {i1w.solve_seconds:.4f} s")

    solver, x, info, (dia_shape, by_shape), counts, summ = _spmd_solver(
        a, pars, mesh, b, tag=tag)
    launches = {e: sum(n for k, n in by_shape.items() if k[0] == e)
                for e in W.ENTRIES}
    log(f"[{tag}] {mesh.describe()}; pad {solver.pad} = {mesh.n_shards} x "
        f"{solver.m_local} rows; E = {solver.E}, Es = {solver.Es}, "
        f"boundary: {'ring R' if solver.ring_r else 'all-gather'}")
    for l, lv in enumerate(solver.mg.levels):
        desc = [f"{type(lv.a).__name__} {str(lv.a.vals.dtype)[6:]}"]
        if isinstance(lv.a, amg.BandedBlocks):
            desc.append(f"nb={lv.a.nb}")
        desc.append("row-sharded" if l <= solver.Es else "replicated")
        for name in ("p", "r"):
            op = getattr(lv, name)
            if op is not None and l <= solver.Es:
                where = ("row-sharded" if l < solver.Es or solver.ring_r
                         else "replicated")
                desc.append(f"{name.upper()} {type(op).__name__} ({where})")
        log(f"[{tag}] level {l}: {lv.n} rows, pad {lv.pad}, "
            f"{', '.join(desc)}")
    for l in range(solver.Es + 1):
        lv = solver.mg.levels[l]
        for name in ("a", "p", "r"):
            op = getattr(lv, name)
            if isinstance(op, amg.WEll) and (l < solver.Es or name == "a"
                                             or solver.ring_r):
                m_in = op.pad_cols // mesh.n_shards
                lo, hi = (t * 128 for t in op.ring_plan)
                log(f"[{tag}] {name.upper()}{l}: WEll halo lo {lo} hi {hi} "
                    f"({-(-lo // m_in)} / {-(-hi // m_in)} hop(s) of "
                    f"{m_in})")
            elif isinstance(op, amg.BandedBlocks):
                log(f"[{tag}] {name.upper()}{l}: BandedBlocks halo "
                    f"{op.nb * 128} each way")
    if solver.a0_hi is not None:
        lo, hi = (t * 128 for t in solver.a0_hi.ring_plan)
        log(f"[{tag}] a0_hi: df64 WEll halo lo {lo} hi {hi}; level 0 "
            f"shares its row-slice structure and hi plane: "
            f"{solver.mg.levels[0].a.rows.cols is solver.a0_hi.rows.cols}")
    true_rel = float(np.linalg.norm(b - a.matvec(x.astype(np.float64)))
                     / np.linalg.norm(b))
    gap = float(np.linalg.norm(x - x1) / np.linalg.norm(x1))
    its = max(info.nits, 1)
    log(f"[{tag}] setup {summ['setup_s']:.2f} s (single-device "
        f"{single_setup_s:.2f}), device memory held after setup "
        f"{summ['mib']:.1f} MiB, cold solve {info.solve_seconds:.4f} s, "
        f"warm {summ['warm_s']:.4f} s (single-device cold "
        f"{i1.solve_seconds:.4f}, warm {i1w.solve_seconds:.4f}), "
        f"{info.nits} FCG its (single-device {i1.nits}), rres "
        f"{info.rres:.3e}, true rres (host f64) {true_rel:.3e}, "
        f"||x_spmd - x_single|| / ||x_single|| {gap:.3e}")
    log(f"[{tag}] per FCG iteration: "
        f"{(launches['window'] + launches['df64_window']) / its:.1f} "
        f"window launches (B2 {launches['window'] / its:.1f}, B3 "
        f"{launches['df64_window'] / its:.1f}), "
        f"{counts['products'] / its:.1f} ring products (WEll {counts['well_products'] / its:.1f}, "
        f"BandedBlocks {counts['banded_products'] / its:.1f}), "
        f"{counts['halo_bytes'] / its / 2**20:.2f} MiB of halo, "
        f"{counts['all_gather'] / its:.1f} all-gathers, "
        f"{counts['psum'] / its:.1f} psums, {counts['p2p'] / its:.1f} "
        f"exchanges between processes; DIA launches {sum(dia_shape.values())}")
    for k, n in sorted(by_shape.items(), key=str):
        log(f"[{tag}]   {k[0]} {str(k[1])[6:]} rows={k[2]} nnz={k[3]}: {n}")
    check(np.all(np.isfinite(x)) and x.shape == (a.n_rows,),
          f"{tag}: solution not finite or wrong shape")
    check(solver.E == 0 and solver.Es >= 1,
          f"{tag}: E = {solver.E}, Es = {solver.Es}")
    check(true_rel < 1e-8, f"{tag}: true rres {true_rel:.3e}")
    check(abs(info.nits - i1.nits) <= 1,
          f"{tag}: {info.nits} FCG its against {i1.nits} single-device")
    ops = _general_ops(solver)
    check(solver.a0_hi is not None, f"{tag}: no df64 FCG operator")
    sharded = set()
    for t, op, entry, _ in ops:
        key = (entry, op.rows.vals.dtype, op.n_rows, op.nnz)
        check(by_shape.get(key, 0) > 0,
              f"{tag}: {entry} not launched on {t} {key}")
        sharded.add(key[1:])
    single_on_ring = [k for k in by_shape
                      if k[0] in ("spmv", "df64") and k[1:] in sharded]
    check(not single_on_ring, f"{tag}: single-device B2/B3 launched on a "
                              f"sharded operator: {single_on_ring}")
    return solver, x, info, by_shape, dict(summ, nits=info.nits,
                                           single_nits=i1.nits)


def phase_general(a, fem_summary, fem_auto_summary):
    """19. fem2d(1,000,000) in bench_dist.py's fem2d mode on a ring of 4
    row shards on the card: ``use_banded`` on "on" (the all-gather
    boundary) and "off" (the ring-R boundary), then the first inside a
    one-rank NCCL process group.  Returns the window entries' rows."""
    import socket
    import torch.distributed as tdist
    import amg_tpu_torch as amg
    from amg_tpu_torch.parallel import make_mesh, multihost

    b = np.ones(a.n_rows)
    mesh = make_mesh(SPMD_SHARDS, device="cuda")
    check(mesh.device.type == "cuda" and mesh.world == 1
          and mesh.local == SPMD_SHARDS, f"mesh {mesh}")
    g = torch.Generator().manual_seed(19)
    rows, kinds = [], []
    first = None
    for banded in ("on", "off"):
        pars = general_pars(amg).replace(use_banded=banded)
        tag = f"general-{banded}"
        solver, x, info, by_shape, summ = _general_run(a, pars, tag, b,
                                                       mesh)
        kinds.append(solver.ring_r)
        log(f"[{tag}] device memory {summ['mib']:.1f} MiB (phase 8 "
            f"{fem_summary['mib']:.1f}, phase 15 "
            f"{fem_auto_summary['mib']:.1f})")
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        for entry in ("window", "df64_window"):
            for key, n in sorted(by_shape.items(), key=str):
                if key[0] != entry:
                    continue
                match = [(t, op, mode) for t, op, e, mode
                         in _general_ops(solver) if e == entry
                         and (op.rows.vals.dtype, op.n_rows, op.nnz)
                         == key[1:]]
                check(match, f"{tag}: no sharded operator has the launch "
                             f"shape {key}")
                rows.append(_one_row([
                    _compare_well_window(f"g{banded[1]}-{t}", op, entry,
                                         mode, mesh, g, flush)
                    for t, op, mode in match], n))
        del flush
        if first is None:
            first = (pars, x, info)
        del solver
    check(kinds == [False, True], f"boundaries {kinds}: use_banded on "
          "should take the all-gather boundary, use_banded off the ring-R")
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"WEll window entry disagrees with its plain version: "
                   f"{bad}")

    # the first solve inside a one-rank NCCL process group
    pars, x, info = first
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    check(multihost.initialize(f"localhost:{port}", 1, 0, device="cuda"),
          "NCCL process group not initialized")
    try:
        check(tdist.get_backend() == "nccl", f"backend {tdist.get_backend()}")
        gmesh = make_mesh(SPMD_SHARDS, device="cuda")
        check(gmesh.group is not None, "mesh without its process group")
        _, x2, info2, _, counts2, summ2 = _spmd_solver(a, pars, gmesh, b,
                                                       tag="general-nccl")
        st = summ2["steps"]
        log(f"[general-nccl] one rank, {gmesh.describe()}: {info2.nits} FCG "
            f"its, cold {info2.solve_seconds:.4f} s, warm graph "
            f"{st['warm_graph_s']:.4f} s / eager {st['warm_eager_s']:.4f} s, "
            f"{counts2['psum']} psums and {counts2['all_gather']} "
            f"all-gathers through NCCL; x equal bit for bit to the "
            f"in-process run: {np.array_equal(x2, x)}")
        check(info2.nits == info.nits and np.array_equal(x2, x),
              "general: the one-rank NCCL run differs from the in-process "
              "run")
    finally:
        tdist.destroy_process_group()
    return rows


# ---------------------------------------------------------------------------
# 20. the GSPMD solver: ring products where XLA exchanges halos, all-gather
# products where it gathers
# ---------------------------------------------------------------------------


def gspmd_pars(amg):
    """bench_dist.py's ``AMG_DIST_SOLVER=gspmd`` parameters for poisson3d
    (bench_dist.py:132-145): f32 cycles with f64 defect correction,
    Chebyshev below level 0, bf16 coarse operators, WEll on "auto" from
    65,536 rows, no Krylov acceleration."""
    return amg.AMGParams(
        tol=1e-8, dtype="float32", refine=True, verbose=0,
        coarse_smoother=amg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="bfloat16", use_well="auto", well_min_rows=65536,
        accel="none")


def phase_gspmd(a):
    """20. poisson3d(100) in bench_dist.py's gspmd mode with DistAMGSolver
    on a ring of 4 row shards on the card, beside the single-device
    solve_refined with the same packing, then inside a one-rank NCCL
    process group.  Returns the B1 and B2 window entries' rows."""
    import socket
    import torch.distributed as tdist
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import dia_kernel as D
    from amg_tpu_torch.parallel import DistAMGSolver, make_mesh, multihost

    pars = gspmd_pars(amg)
    b = np.ones(a.n_rows)
    _reset_counts()
    t0 = time.perf_counter()
    single = amg.AMGSolver(a, pars.replace(dist_devices=SPMD_SHARDS),
                           device="cuda", log=lambda *_: None)
    torch.cuda.synchronize()
    single_setup_s = time.perf_counter() - t0
    x1, i1 = single.solve(b)
    _, i1w = single.solve(b)
    torch.cuda.synchronize()
    del single
    log(f"[gspmd] single-device solve_refined (dist_devices="
        f"{SPMD_SHARDS} packing): setup {single_setup_s:.2f} s, {i1.nits} "
        f"cycles, rres {i1.rres:.3e}, cold {i1.solve_seconds:.4f} s, warm "
        f"{i1w.solve_seconds:.4f} s")

    mesh = make_mesh(SPMD_SHARDS, device="cuda")
    check(mesh.device.type == "cuda" and mesh.world == 1
          and mesh.local == SPMD_SHARDS, f"mesh {mesh}")
    solver, x, info, (dia_shape, well_shape), counts, summ = _spmd_solver(
        a, pars, mesh, b, DistAMGSolver, tag="gspmd")
    log(f"[gspmd] {mesh.describe()}; level-0 pad {solver.pad} = "
        f"{SPMD_SHARDS} x {solver.pad // SPMD_SHARDS} rows; Es = "
        f"{solver.Es}; a0_hi {type(solver.a0_hi).__name__}")
    for l, lv in enumerate(solver.mg.levels):
        place = "row-sharded" if l <= solver.Es else "replicated"
        desc = [f"{type(lv.a).__name__} {str(lv.a.vals.dtype)[6:]}"]
        for name in ("p", "r"):
            op = getattr(lv, name)
            if op is not None:
                desc.append(f"{name.upper()} {type(op).__name__}")
        log(f"[gspmd] level {l}: {lv.n} rows, {', '.join(desc)}, {place}")
    true_rel = float(np.linalg.norm(b - a.matvec(x.astype(np.float64)))
                     / np.linalg.norm(b))
    gap = float(np.linalg.norm(x - x1) / np.linalg.norm(x1))
    its = max(info.nits, 1)
    b1w = sum(n for k, n in dia_shape.items() if k[0] == D.WINDOW)
    b2w = sum(n for k, n in well_shape.items() if k[0] == "window")
    log(f"[gspmd] setup {summ['setup_s']:.2f} s (single-device "
        f"{single_setup_s:.2f}), device memory held after setup "
        f"{summ['mib']:.1f} MiB, cold solve {info.solve_seconds:.4f} s, "
        f"warm {summ['warm_s']:.4f} s (single-device cold "
        f"{i1.solve_seconds:.4f}, warm {i1w.solve_seconds:.4f}), "
        f"{info.nits} cycles (single-device {i1.nits}), rres "
        f"{info.rres:.3e}, true rres (host f64) {true_rel:.3e}, "
        f"||x_gspmd - x_single|| / ||x_single|| {gap:.3e}")
    log(f"[gspmd] per solve: {b1w} launches of B1's window entry, {b2w} of "
        f"B2's col0 = 0 entry, {sum(dia_shape.values()) - b1w} other B1/B4 "
        f"and {sum(well_shape.values()) - b2w} other B2/B3 launches; per "
        f"cycle: {counts['products'] / its:.1f} ring products, "
        f"{counts['gather_products'] / its:.1f} all-gather products, "
        f"{counts['all_gather'] / its:.1f} all-gathers, "
        f"{counts['psum'] / its:.1f} psums, "
        f"{counts['halo_bytes'] / its / 2**20:.2f} MiB of halo")
    for k, n in sorted(dia_shape.items(), key=str):
        log(f"[gspmd]   {k[0]} {str(k[1])[6:]}/{str(k[2])[6:]} "
            f"{', '.join(map(str, k[3:]))}: {n}")
    for k, n in sorted(well_shape.items(), key=str):
        log(f"[gspmd]   {k[0]} {str(k[1])[6:]} rows={k[2]} nnz={k[3]}: {n}")
    check(np.all(np.isfinite(x)) and x.shape == (a.n_rows,),
          "gspmd: solution not finite or wrong shape")
    check(solver.Es >= 1, f"gspmd: Es = {solver.Es}")
    check(true_rel < 1e-8, f"gspmd: true rres {true_rel:.3e}")
    check(abs(info.nits - i1.nits) <= 1,
          f"gspmd: {info.nits} cycles against {i1.nits} single-device")
    sharded = solver.mg.levels[: solver.Es + 1]
    dia_ops = [(f"A{l}", lv.a) for l, lv in enumerate(sharded)
               if isinstance(lv.a, amg.Dia)]
    dia_ops.append(("a0_hi", solver.a0_hi))
    well_ops = [(f"{n.upper()}{l}", getattr(lv, n))
                for l, lv in enumerate(sharded) for n in ("a", "p", "r")
                if isinstance(getattr(lv, n), amg.WEll)]
    check(isinstance(solver.a0_hi, amg.Dia) and well_ops,
          f"gspmd: a0_hi {type(solver.a0_hi).__name__}, sharded WEll "
          f"operators {[t for t, _ in well_ops]}")
    def window_key(op):
        xdt = torch.float64 if op.vals.dtype == torch.float64 \
            else torch.float32
        return (D.WINDOW, op.vals.dtype, xdt, op.n_diags,
                op.vals.shape[1] // SPMD_SHARDS, SPMD_SHARDS)

    for tag, op in dia_ops:
        check(dia_shape.get(window_key(op), 0) > 0, f"gspmd: B1's window "
              f"entry not launched on {tag} {window_key(op)}")
    for tag, op in well_ops:
        key = ("window", op.rows.vals.dtype, op.n_rows, op.nnz)
        check(well_shape.get(key, 0) > 0,
              f"gspmd: B2's col0 = 0 entry not launched on {tag} {key}")
    single_on_ring = [k for k in dia_shape
                      if k[0] in D.EPILOGUES and k[4] == solver.pad]
    single_on_ring += [k for k in well_shape if k[0] == "spmv" and k[1:] in
                       {(op.rows.vals.dtype, op.n_rows, op.nnz)
                        for _, op in well_ops}]
    check(not single_on_ring, f"gspmd: a single-device kernel launched on "
                              f"a row-sharded operator: {single_on_ring}")

    # every launch shape against its plain version, beside the
    # single-device kernel on the same operator
    g = torch.Generator().manual_seed(20)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    b1_rows, b2_rows = [], []
    for key, n in sorted(dia_shape.items(), key=str):
        if key[0] != D.WINDOW:
            continue
        match = [(t, op) for t, op in dia_ops if window_key(op) == key]
        check(match, f"gspmd: no sharded Dia operator has the window "
                     f"shape {key}")
        b1_rows.append(_one_row([_compare_window("gs-" + t, op, mesh, g,
                                                 flush)
                                 for t, op in match], n))
    for key, n in sorted(well_shape.items(), key=str):
        if key[0] != "window":
            continue
        match = [(t, op) for t, op in well_ops
                 if (op.rows.vals.dtype, op.n_rows, op.nnz) == key[1:]]
        check(match, f"gspmd: no sharded WEll operator has the launch "
                     f"shape {key}")
        b2_rows.append(_one_row([
            _compare_well_window("gs-" + t, op, "window", "full", mesh, g,
                                 flush) for t, op in match], n))
    del flush
    bad = [r for r in b1_rows + b2_rows if not r["ok"]]
    check(not bad, f"gspmd: a window entry disagrees with its plain "
                   f"version: {bad}")

    # the same solve and Krylov path inside a one-rank NCCL process group
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    check(multihost.initialize(f"localhost:{port}", 1, 0, device="cuda"),
          "NCCL process group not initialized")
    try:
        check(tdist.get_backend() == "nccl", f"backend {tdist.get_backend()}")
        gmesh = make_mesh(SPMD_SHARDS, device="cuda")
        check(gmesh.group is not None, "mesh without its process group")
        _, x2, info2, _, counts2, summ2 = _spmd_solver(a, pars, gmesh, b,
                                                       DistAMGSolver,
                                                       tag="gspmd-nccl")
        st = summ2["steps"]
        log(f"[gspmd-nccl] one rank, {gmesh.describe()}: {info2.nits} "
            f"cycles, cold {info2.solve_seconds:.4f} s, warm graph "
            f"{st['warm_graph_s']:.4f} s / eager {st['warm_eager_s']:.4f} s, "
            f"{counts2['psum']} psums and "
            f"{counts2['all_gather']} all-gathers through NCCL; x equal bit "
            f"for bit to the in-process run: {np.array_equal(x2, x)}")
        check(info2.nits == info.nits and np.array_equal(x2, x),
              "gspmd: the one-rank NCCL run differs from the in-process run")
    finally:
        tdist.destroy_process_group()
    return b1_rows, b2_rows


# ---------------------------------------------------------------------------
# 21. the device PMIS splitter
# ---------------------------------------------------------------------------


def phase_pmis(a):
    """21. ``pmis_split_device`` on the strength graph of fem2d(1,000,000,
    seed=0)'s level 0, on the card and on the CPU (equal partitions, the
    PMIS checks), beside the host ``pmis_split``; then phase 8's setup
    with ``cs_type=PMIS`` through the device splitter, solved with FCG
    beside the same setup on the host splitter."""
    import amg_tpu_torch as amg
    from amg_tpu_torch.params import CGPT, FGPT, UNPT
    from amg_tpu_torch.setup_phase import cf_split
    from amg_tpu_torch.setup_phase.strength import strength_matrix

    pars = unstructured_pars(amg).replace(cs_type=amg.CoarsenType.PMIS)
    s = strength_matrix(a, pars.strong_threshold, pars.max_row_sum)
    rows, cols = s.row_indices, s.indices.astype(np.int64)
    res = {}
    for where in ("cuda", "cpu", "host"):
        t0 = time.perf_counter()
        if where == "host":
            vec, col = cf_split.pmis_split(s)
        else:
            vec, col = cf_split.pmis_split_device(s, device=where)
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        covered = np.zeros(s.n_rows, dtype=bool)
        covered[rows[vec[cols] == CGPT]] = True
        uncovered = int(np.sum((vec == FGPT) & (s.row_degrees > 0)
                               & ~covered))
        cc = int(np.sum((vec[rows] == CGPT) & (vec[cols] == CGPT)))
        res[where] = (vec, col)
        log(f"[pmis] {where:4s}: {col} C points of {s.n_rows} "
            f"({col / s.n_rows:.4f}), {sec:.3f} s; undecided "
            f"{int(np.sum(vec == UNPT))}, F points with strong links and no "
            f"C among them {uncovered}, strongly linked C-C pairs {cc}")
        check(not np.any(vec == UNPT) and uncovered == 0,
              f"pmis {where}: not a valid PMIS splitting")
    check(np.array_equal(res["cuda"][0], res["cpu"][0]),
          "pmis: the card's partition differs from the CPU's")
    check(0.5 < res["cuda"][1] / res["host"][1] < 2.0,
          "pmis: C fraction far from the host splitter's")

    calls = []
    real = cf_split.pmis_split_device

    def device_spy(s, seed=42, device="cuda"):
        calls.append((s.n_rows, str(device)))
        return real(s, seed, device=device)

    out = {}
    for where, fn in (("device", device_spy),
                      ("host", lambda s, seed=42, device=None:
                       cf_split.pmis_split(s, seed))):
        cf_split.pmis_split_device = fn
        try:
            t0 = time.perf_counter()
            solver = amg.AMGSolver(a, pars, device="cuda",
                                   log=lambda *_: None)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
        finally:
            cf_split.pmis_split_device = real
        b = np.ones(a.n_rows)
        x, info = solver.solve(b)
        true_rel = float(np.linalg.norm(b - a.matvec(x.astype(np.float64)))
                         / np.linalg.norm(b))
        hh = solver.host_hierarchy
        out[where] = (info.nits, true_rel < pars.tol)
        log(f"[pmis] setup with the {where} splitter: {setup_s:.2f} s, "
            f"{hh.num_levels} levels, rows {[m.n_rows for m in hh.a]}; FCG "
            f"{info.nits} its, true rres {true_rel:.3e}, solve "
            f"{info.solve_seconds:.4f} s")
        del solver
    log(f"[pmis] device splitter calls in the PMIS setup: {calls}")
    check(calls and calls[0] == (a.n_rows, "cuda"),
          f"pmis: the setup did not call the device splitter: {calls}")
    (nd, okd), (nh, okh) = out["device"], out["host"]
    check(okd and okh, f"pmis: statuses {okd} / {okh}")
    check(abs(nd - nh) <= 0.2 * max(nd, nh),
          f"pmis: {nd} against {nh} FCG its")


# ---------------------------------------------------------------------------
# 22. solve_jit: the masked cycle step as a CUDA graph
# ---------------------------------------------------------------------------


JIT_TOL = 1e-6             # f32 cycles reach it without defect correction
JIT_TRUE_RRES = 1.5e-6     # tol plus the f32 residual's floor (~6e-8 ||b||)
JIT_REPS = 3               # warm solves timed per entry point (median)


def jit_pars(pars):
    """Phase 22's parameters from a main path's: f32 cycles without defect
    correction or Krylov acceleration (solve_jit runs neither), to
    ``JIT_TOL``."""
    return pars.replace(refine=False, accel="none", tol=JIT_TOL)


def jit_rhs(a, seed=22):
    """b = A x for a seeded standard-normal x.  With b = ones the solution
    is large and smooth, and the f32 residual of a cycle cannot fall below
    ~eps32 * || |A| |x| || / ||b||: poisson3d(64) stalls at 2.5e-5 and
    fem2d(70,000) at 2e-3 (the CPU, plain versions), above tol; with this
    b the floor is ~1e-7."""
    return a.matvec(np.random.default_rng(seed).standard_normal(a.n_rows))


def _median_s(fn):
    times = []
    for _ in range(JIT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _one_replay_vs_step(solver, n):
    """One replay of the captured step from a fixed seeded x against one
    eager ``_step`` from the same x: max |x difference| and max |x|.
    Neither is counted as a main-path launch (the counts were read)."""
    loop = solver.jit_loop
    rng = np.random.default_rng(23)
    xd = solver._pad_vec(rng.standard_normal(n))
    bd = solver._pad_vec(rng.standard_normal(n))
    loop.load(xd, bd)
    loop.graph.replay()
    x_eager, _ = solver._step(xd, bd)
    torch.cuda.synchronize()
    return ((loop.x - x_eager).abs().max().item(),
            x_eager.abs().max().item())


def _jit_against_solve(tag, solver, a, b):
    """``solve_jit`` on ``solver`` (counts set to 0 just before its cold
    call and read just after) against ``solve`` on the same solver: equal
    iterations, histories within rtol 1e-5, x within 1e-6 * ||x||, a host
    f64 true rres below ``JIT_TRUE_RRES``; one replay equal to one eager
    step.  Logs capture seconds, device MiB after the
    capture against before, blocks and host reads per solve, warm
    seconds of both entries.  Returns the cold call's DIA and WEll
    launches by shape and a summary."""
    from amg_tpu_torch.ops import dia_kernel as D, well_kernel as W
    from amg_tpu_torch.solve.driver import JIT_BLOCK

    _reset_counts()
    torch.cuda.synchronize()
    mem0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    x, info = solver.solve_jit(b)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    _settle_counts()
    dia, well = dict(D.launches_by_shape), dict(W.launches_by_shape)
    launches = (dict(D.launches), dict(W.launches))
    mib = (torch.cuda.memory_allocated() - mem0) / 2**20
    rmib = (torch.cuda.memory_reserved() - res0) / 2**20
    loop = solver.jit_loop
    xs, info_s = solver.solve(b)
    torch.cuda.synchronize()
    true_rel = float(np.linalg.norm(b - a.matvec(x.astype(np.float64)))
                     / np.linalg.norm(b))
    hj, hs = np.array(info.residuals), np.array(info_s.residuals)
    same = hj.shape == hs.shape and np.array_equal(hj, hs)
    x_gap = float(np.linalg.norm(x - xs) / np.linalg.norm(xs))
    warm_jit = _median_s(lambda: solver.solve_jit(b))
    warm_solve = _median_s(lambda: solver.solve(b))
    log(f"[{tag}] solve_jit: {info.nits} its, rres {info.rres:.3e}, true "
        f"rres (host f64) {true_rel:.3e}; solve: {info_s.nits} its; "
        f"histories bit-identical: {same}; x gap {x_gap:.3e} of ||x||")
    route = ("CUDA graph of one masked step" if loop.graph is not None
             else "eager masked loop")
    log(f"[{tag}] route: {route} on {loop.x.device}; capture "
        f"{loop.capture_seconds:.3f} s; "
        f"device MiB after the cold call against before: allocated "
        f"{mib:+.1f}, reserved {rmib:+.1f}; {loop.blocks} blocks of "
        f"{JIT_BLOCK} steps, {loop.host_reads} host reads of the stop flag "
        f"per solve (+4 for the results)")
    log(f"[{tag}] cold solve_jit {cold_s:.4f} s; warm (median of "
        f"{JIT_REPS}) solve_jit {warm_jit:.4f} s, solve {warm_solve:.4f} s")
    log(f"[{tag}] launches: DIA {launches[0]}, WEll {launches[1]}")
    check(np.all(np.isfinite(x)) and x.shape == (a.n_rows,),
          f"{tag}: solution not finite or wrong shape")
    check(info.nits == info_s.nits,
          f"{tag}: solve_jit {info.nits} its, solve {info_s.nits}")
    check(hj.shape == hs.shape and np.allclose(hj, hs, rtol=1e-5, atol=0),
          f"{tag}: histories differ: {hj} against {hs}")
    check(x_gap <= 1e-6, f"{tag}: x gap {x_gap:.3e}")
    check(info.rres < JIT_TOL and true_rel < JIT_TRUE_RRES,
          f"{tag}: true rres {true_rel:.3e}")
    summary = dict(nits=info.nits, cold_s=cold_s, warm_jit_s=warm_jit,
                   warm_solve_s=warm_solve, mib=mib, reserved_mib=rmib,
                   capture_s=loop.capture_seconds, blocks=loop.blocks,
                   reads=loop.host_reads)
    check(loop.graph is not None, f"{tag}: no CUDA graph captured")
    diff, scale = _one_replay_vs_step(solver, a.n_rows)
    log(f"[{tag}] one replay against one eager step from the same x: "
        f"max |dx| {diff:.3e} (max |x| {scale:.3e})")
    check(diff <= 1e-6 * scale, f"{tag}: a replay differs from an "
                                f"eager step by {diff:.3e}")
    summary["step_diff"] = diff
    return dia, well, summary


def _graph_launches(loop, K, entries):
    """Check that ``loop``'s graph replays kernel module ``K``'s
    ``entries`` (the capture recorded them)."""
    per_entry = loop.per_step[K][0]
    check(all(per_entry.get(e, 0) > 0 for e in entries),
          f"the graph does not launch {entries}: {per_entry}")
    return per_entry


def phase_jit(p3d, auto_hh, fem, fem_hh):
    """22. ``solve_jit`` at full width: poisson3d(100) with phase 13's
    parameters and host hierarchy, fem2d(1,000,000) with phase 15's, both
    as ``jit_pars`` (f32 cycles to 1e-6, no defect correction or Krylov
    acceleration) on ``jit_rhs``; B1 (update, resid, spmv) and B2 (spmv)
    replayed in the structured graph, B2 (spmv, gs on level 0's classes)
    in the unstructured one; then phase 17's KRYLOV hierarchy, whose
    captured step holds the coarsest solve's graph.  Returns the kernel
    rows of both graphs' launch shapes (tags "j-", "jf-")."""
    import amg_tpu_torch as amg
    from amg_tpu_torch.ops import dia_kernel as D, well_kernel as W

    quiet = dict(device="cuda", log=lambda *_: None)
    pars = jit_pars(structured_pars(amg).replace(use_well="auto",
                                                 use_banded="auto"))
    b = jit_rhs(p3d)
    solver = amg.AMGSolver(p3d, pars, host_hierarchy=auto_hh, **quiet)
    check(_formats(solver) == STRUCTURED_AUTO,
          f"jit formats {_formats(solver)}")
    dia, well, summary = _jit_against_solve("jit", solver, p3d, b)
    per_dia = _graph_launches(solver.jit_loop, D, ("update", "resid",
                                                   "spmv"))
    per_well = _graph_launches(solver.jit_loop, W, ("spmv",))
    log(f"[jit] launches per replay: DIA {per_dia}, WEll {per_well}")
    dia_rows = phase_main_shapes(solver, dia, prefix="j-")
    well_rows = phase_unstructured_shapes(solver, well, prefix="j-")
    del solver

    ks = amg.AMGSolver(p3d, pars.replace(
        coarsest_solver=amg.CoarsestSolver.KRYLOV), host_hierarchy=auto_hh,
        **quiet)
    _, _, ksum = _jit_against_solve("jit-krylov", ks, p3d, b)
    ksum["coarsest_graph_nodes"] = _cached_krylov(ks, 1).graph.nodes
    log(f"[jit-krylov] route: graph (the coarsest solve's while and if "
        f"nodes, {ksum['coarsest_graph_nodes']} nodes, added to the "
        f"captured step); warm solve_jit {ksum['warm_jit_s']:.4f} s against "
        f"solve {ksum['warm_solve_s']:.4f} s (the eager route's 0.976 s "
        f"against 0.531 s)")
    del ks

    fpars = jit_pars(unstructured_pars(amg).replace(use_well="auto",
                                                    use_banded="auto"))
    fb = jit_rhs(fem)
    fs = amg.AMGSolver(fem, fpars, host_hierarchy=fem_hh, **quiet)
    check(_formats(fs) == FEM_AUTO, f"jit fem2d formats {_formats(fs)}")
    _, fwell, fsum = _jit_against_solve("jit-fem", fs, fem, fb)
    per_well = _graph_launches(fs.jit_loop, W, ("spmv", "gs"))
    n_cls = len(fs.mg.levels[0].a.rows.segments) - 1
    log(f"[jit-fem] launches per replay: WEll {per_well}, level 0's "
        f"{n_cls} GS classes")
    check(per_well["gs"] % n_cls == 0, "gs launches per replay do not "
                                       "cover level 0's classes")
    well_rows += phase_unstructured_shapes(fs, fwell, prefix="jf-")
    del fs
    log(f"[jit] summary: structured {summary}; krylov {ksum}; fem2d {fsum}")
    return dia_rows, well_rows


def _kernel_entries(dia_rows, well_rows, multi_rows=(), window_rows=(),
                    well_window_rows=(), small_rows=(), dense_rows=()):
    """The ``kernels`` JSON entries: one per (epilogue, launch shape) of
    phases 6, 13, 14, 16, 17 and 22, per (entry, operator) of phases 9,
    13, 15, 17 and 22 (per GS class for the ``gs`` entry), per launch
    shape of phases 11, 14 and 17, and per launch shape of B1's window
    entry in phases 18 and 20 and of B2/B3's in phases 19 and 20."""
    out = [{
        "name": f"dia_spmv.{r['epilogue']}[{r['op']} {r['vals']}/{r['x']} "
                f"nd={r['nd']} pad={r['pad']}]",
        "route": "cuda", "source": "amg_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "amg_tpu/ops/pallas_dia.py:118",
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["lib_ms"],
        "lib_ms": r["lib_ms"]} for r in dia_rows]
    out += [{
        "name": f"well_spmv.{r['entry']}[{r['op']} {r['vals']}/{r['x']} "
                f"rows={r['rows']} nnz={r['nnz']}]",
        "route": "cuda", "source": "amg_tpu_torch/csrc/well_spmv.cu",
        "replaces": ("amg_tpu/ops/pallas_well.py:146" if r["entry"] == "df64"
                     else "amg_tpu/ops/pallas_well.py:77"),
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["lib_ms"],
        "lib_ms": r["lib_ms"]} for r in well_rows]
    out += [{
        "name": f"dia_spmv.{r['epilogue']}[{r['op']} {r['vals']}/{r['x']} "
                f"nd={r['nd']} pad={r['pad']} k={r['k']}]",
        "route": "cuda", "source": "amg_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "amg_tpu/ops/pallas_dia.py:281",
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["lib_ms"],
        "lib_ms": r["lib_ms"]} for r in multi_rows]
    out += [{
        "name": f"dia_spmv.window[{r['op']} {r['vals']}/{r['x']} "
                f"nd={r['nd']} m={r['m']} S={r['S']}]",
        "route": "cuda", "source": "amg_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "amg_tpu/ops/pallas_dia.py:495",
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["lib_ms"],
        "lib_ms": r["lib_ms"]} for r in window_rows]
    out += [{
        "name": f"well_spmv.{r['entry']}[{r['op']} {r['vals']}/{r['x']} "
                f"rows={r['rows']} nnz={r['nnz']} {r['mode']} "
                f"n_x={r['n_x']}]",
        "route": "cuda", "source": "amg_tpu_torch/csrc/well_spmv.cu",
        "replaces": ("amg_tpu/ops/pallas_well.py:146"
                     if r["entry"] == "df64_window"
                     else "amg_tpu/ops/pallas_well.py:77"),
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["lib_ms"],
        "lib_ms": r["lib_ms"]} for r in well_window_rows]
    # no TPU kernel: lax.fori_loop scalar work of amg_tpu's GMRES
    out += [{
        "name": f"krylov_small.{r['entry']}[{r['dtype']} m={r['m']}]",
        "route": "cuda", "source": "amg_tpu_torch/csrc/krylov_small.cu",
        "replaces": ("amg_tpu/solve/krylov.py:336" if r["entry"] == "givens"
                     else "amg_tpu/solve/krylov.py:371"),
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "floor_ms": r["floor_ms"],
        "library_ms": r["lib_ms"], "lib_ms": r["lib_ms"]}
        for r in small_rows]
    # no TPU kernel: XLA's convert + dot of amg_tpu's spmv_dense
    out += [{
        "name": f"dense_gemv.spmv[{r['op']} bf16/f32 rows={r['rows']} "
                f"cols={r['cols']}]",
        "route": "cuda", "source": "amg_tpu_torch/csrc/dense_gemv.cu",
        "replaces": "amg_tpu/ops/spmv.py:134",
        "launches": r["launches"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["lib_ms"],
        "lib_ms": r["lib_ms"]} for r in dense_rows]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this smoke run needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    stamps = []

    def stamp(name):
        stamps.append((name, time.perf_counter()))

    name, smi = phase_device()
    phase_build()
    stamp("build")
    phase_kernels()
    stamp("dia kernels")
    phase_goldens()
    stamp("goldens")
    solver, by_shape, summary = phase_main_path()
    stamp("structured path")
    dia_rows = phase_main_shapes(solver, by_shape)
    stamp("structured shapes")
    phase_multi_kernels(solver)
    stamp("multi-rhs kernel")
    B = np.random.default_rng(6).standard_normal((solver.a.n_rows, N_RHS))
    multi_by_shape, _ = phase_batched(solver, B)
    multi_rows = _multi_shapes(solver, multi_by_shape)
    stamp("batched path")
    phase_batched_one_column(solver, B[:, 0])
    stamp("one column")
    import amg_tpu_torch as amg

    a = amg.fem2d(FEM_ROWS, seed=0)
    stamp("fem2d matrix")
    phase_well_kernels(a)
    stamp("well kernels")
    fem, well_by_shape, fem_summary = phase_unstructured(a)
    stamp("unstructured path")
    well_rows = phase_unstructured_shapes(fem, well_by_shape)
    stamp("unstructured shapes")

    auto, (auto_dia, auto_well), auto_summary = phase_structured_auto(
        solver, summary)
    dia_rows += auto_dia
    well_rows += auto_well
    stamp("structured auto")
    dense_rows = phase_dense_kernel(auto)
    p3d = solver.a
    auto_hh = auto.host_hierarchy
    del solver, auto
    stamp("dense kernel")
    emb_dia, emb_multi, emb_summary = phase_embedded(p3d)
    dia_rows += emb_dia
    multi_rows += emb_multi
    stamp("structured embedded")
    fa_rows, fem_auto_summary, fem_auto_hh = phase_fem_auto(a, fem,
                                                            fem_summary)
    well_rows += fa_rows
    del fem
    stamp("unstructured auto")
    g_dia, g_well, g_small = phase_gmres()
    dia_rows += g_dia
    well_rows += g_well
    stamp("gmres")
    k_dia, k_well, k_multi, small_rows = phase_krylov_coarsest(
        p3d, auto_hh, auto_summary, g_small)
    dia_rows += k_dia
    well_rows += k_well
    multi_rows += k_multi
    stamp("krylov coarsest")
    window_rows, ring_small = phase_spmd(p3d, emb_summary)
    for r in small_rows:    # the sharded Krylov path's K1 and K2 launches
        r["launches"] += ring_small.get(
            (r["entry"], getattr(torch, r["dtype"]), r["m"]), 0)
    stamp("spmd ring")
    well_window_rows = phase_general(a, fem_summary, fem_auto_summary)
    stamp("general spmd")
    g_b1, g_b2 = phase_gspmd(p3d)
    window_rows += g_b1
    well_window_rows += g_b2
    stamp("gspmd")
    phase_pmis(a)
    stamp("device pmis")
    j_dia, j_well = phase_jit(p3d, auto_hh, a, fem_auto_hh)
    dia_rows += j_dia
    well_rows += j_well
    del a, auto_hh, fem_auto_hh
    stamp("solve_jit graph")

    prev = t_start
    for label, t in stamps:
        log(f"[time] {label}: {t - prev:.1f} s")
        prev = t
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all; "
        f"card: {smi}")
    log(smi)
    log(json.dumps({"declined": auto_summary["bands"]
                    + fem_auto_summary["bands"]}))
    log(json.dumps({"kernels": _kernel_entries(dia_rows, well_rows,
                                               multi_rows, window_rows,
                                               well_window_rows,
                                               small_rows, dense_rows)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
