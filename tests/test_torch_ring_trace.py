"""The ring's rows of the span table (``amg.ring.send``,
``amg.ring.all_reduce``, ``amg.ring.all_gather``) and ``amg.setup.shard``,
on 2 gloo processes x 2 shards (tests/_torch_ring_worker.py) solving
poisson3d 12 x 12 x 48 with ``benchmark/configs/p3d7_4x1m.json``'s
parameters, held against the plain reference of
``benchmark/reference/ring.py``:

- each rank's rows of the level-0 ring product, f32 and f64;
- the solve's true residual below tol, and its reported one within the
  cell's ``rres_report_gap`` limit of it;
- the bytes one level-0 product sends: at least the least halo that the
  other ranks read from this one, at most that plus the 16-byte rounding
  of each message;
- an eager step's counts taken back by a capture and added by each
  replay;
- the rows move in ``profiled()`` only under a profiler, and never on a
  mesh held by one process.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from amg_tpu_torch import tracing
from amg_tpu_torch.parallel import SpmdAMGSolver, make_mesh

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark.reference import generators, ring  # noqa: E402

from _torch_ring_worker import GRID, problem, ring_rows  # noqa: E402

WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ring") / "r")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    worker = os.path.join(REPO, "tests", "_torch_ring_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(port), str(r),
                               str(WORLD), "4", out], env=env, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def csr():
    return generators.poisson3d_7pt(*GRID)


def test_each_ranks_ring_product_is_the_references(ranks, csr):
    """f64 (FCG's ``a0_hi``): integer stencil values times f32-rounded
    probe entries, 7 terms a row, so every sum is exact in f64 but for
    its order: 1e-14 of the largest entry.  f32 (the cycle's operator):
    each product and sum rounded to f32, 7 terms: 1e-6 of the largest."""
    n = len(csr[0]) - 1
    probe = np.random.default_rng(5).uniform(-1, 1, n)
    probe = probe.astype(np.float32).astype(np.float64)
    for g in ranks:
        lo, hi = int(g["lo"]), min(int(g["hi"]), n)
        want = ring.block_product(*csr, probe, lo, hi).numpy()
        scale = np.abs(want).max()
        for dtype, rtol in (("f64", 1e-14), ("f32", 1e-6)):
            got = g[f"y_{dtype}"][: hi - lo]
            assert np.abs(got - want).max() <= rtol * scale, dtype
            assert not g[f"y_{dtype}"][hi - lo:].any()


def test_one_product_sends_the_least_halo(ranks, csr):
    """The bytes rank r sends in one level-0 product against the columns
    of r's block that the other ranks' rows read (their least halos):
    no fewer, and no more than 16 bytes of rounding per message."""
    n = len(csr[0]) - 1
    bounds = [(int(g["lo"]), min(int(g["hi"]), n)) for g in ranks]
    assert bounds == ring.blocks(n, WORLD, int(ranks[0]["hi"]))
    halos = [ring.halo_columns(*csr[:2], lo, hi) for lo, hi in bounds]
    for r, g in enumerate(ranks):
        lo, hi = bounds[r]
        need = sum(int(((h >= lo) & (h < hi)).sum())
                   for q, h in enumerate(halos) if q != r)
        assert need == GRID[0] * GRID[1]     # one plane, one neighbour
        for dtype in ("f32", "f64"):
            msgs, nbytes = g[f"sent_{dtype}"]
            least = need * int(g[f"itemsize_{dtype}"])
            assert msgs == 1
            assert least <= nbytes <= least + 16 * msgs, dtype


def test_the_solve_is_correct_by_the_reference(ranks, csr):
    with open(os.path.join(REPO, "benchmark", "limits",
                           "p3d7_4x1m.spmd.json")) as f:
        limit = json.load(f)["limits"]["rres_report_gap"]
    b = np.random.default_rng(43).standard_normal(len(csr[0]) - 1)
    for g in ranks:
        true = ring.rel_residual(*csr, b, g["x"])
        assert true < 1e-8
        assert abs(float(g["rres"]) - true) <= limit
    np.testing.assert_array_equal(ranks[0]["x"], ranks[1]["x"])


def test_replays_add_the_eager_steps_counts(ranks):
    """A cycle step's ring rows, counted eagerly, go back to 0 when a
    capture takes them back and come to three times the eager step's
    after three replays (``launch_counts.add``)."""
    for g in ranks:
        eager = g["step_eager"]
        assert eager[0][0] > 0 and eager[1][0] > 0     # sends, all-reduces
        assert not g["step_taken_back"].any()
        np.testing.assert_array_equal(g["step_replayed"], 3 * eager)


def test_rows_move_in_profiled_only_under_a_profiler(ranks):
    for g in ranks:
        assert int(g["shard_spans"]) == 1
        assert (g["solve_totals"][:, 0] > 0).all()      # every row moved
        assert not g["solve_profiled"].any()
        np.testing.assert_array_equal(g["prof_profiled"], g["prof_totals"])
        np.testing.assert_array_equal(g["prof_totals"], g["solve_totals"])


def test_a_mesh_in_one_process_counts_nothing():
    a, pars = problem()
    before = tracing.totals()
    s = SpmdAMGSolver(a, pars, mesh=make_mesh(4, device="cpu"),
                      log=lambda *_: None)
    x, info = s.solve(np.random.default_rng(43).standard_normal(a.n_rows))
    assert info.rres < 1e-8
    assert ring_rows(tracing.totals()) == ring_rows(before)
    assert tracing.totals()["amg.setup.shard"]["n"] == \
        before["amg.setup.shard"]["n"] + 1
