"""The port's span table (``amg_tpu_torch.tracing``): its arithmetic, the
spans each entry leaves with and without a ``torch.profiler``, the
set-up spans, the CLI's printed table and, on a card, the trace's regions.

The counts are derived from the code: an entry is one ``amg.solve``; it
uploads b, and x0 when one is given (a missing x0 is zeros made on the
device; level 0's permutation, where level 0 is RCM-ordered for WEll,
went to the device once, at set-up) and downloads x; it reads ``||b||``
once and then its residuals at its loop's cadence (``solve_refined``,
``AMGSolver``'s and ``DistAMGSolver``'s alike: one read per pair of
defect-correction steps; ``solve_pcg``: ``||r0||``, one read per 4 FCG
iterations and the truth check).  The file imports neither jax nor
amg_tpu, so on the card's machine it runs as ``python -m pytest
--noconftest tests/test_torch_tracing.py``.
"""

import math
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import amg_tpu_torch as tamg
from amg_tpu_torch import tracing
from amg_tpu_torch.solve import krylov

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

PKG = os.path.dirname(os.path.abspath(tamg.__file__))
SETUP = ("amg.setup.host", "amg.setup.plan", "amg.setup.reorder",
         "amg.setup.pack", "amg.setup.coarse_inv")


def _quiet(*_):
    pass


def _poisson(**kw):
    """poisson3d(10) in f32 cycles with f64 defect correction (FCG with
    ``accel="cg"``), Chebyshev below level 0."""
    pars = dict(verbose=0, tol=1e-9, dtype="float32", refine=True,
                coarse_smoother=tamg.SmootherType.CHEBYSHEV)
    pars.update(kw)
    return tamg.poisson3d(10), tamg.AMGParams(**pars)


def _fem_rcm():
    """fem2d(6000) with a WEll level 0, RCM-ordered: FCG in f64."""
    return tamg.fem2d(6000, seed=11), tamg.AMGParams(
        verbose=0, tol=1e-8, dtype="float32", refine=True, accel="cg",
        coarse_smoother=tamg.SmootherType.CHEBYSHEV,
        coarse_op_dtype="float32", use_well="on", well_min_rows=1024,
        dense_level_bytes=1 << 20)


@pytest.fixture
def clean():
    tracing.reset()
    yield
    tracing.reset()


def _rows(table):
    return {k: dict(v) for k, v in table.items()}


def test_span_names_are_the_closed_list(clean):
    """Every span the package opens and every counter row it adds to is
    one of ``NAMES``, every name is used somewhere, and another name
    raises."""
    used = set()
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py") and f != "tracing.py":
                with open(os.path.join(root, f)) as fh:
                    used |= set(re.findall(
                        r"(?:span|spanned|_phase|count)\(\s*"
                        r"\"(amg\.[a-z_.]+)\"", fh.read()))
    assert used == set(tracing.NAMES)
    with pytest.raises(KeyError):
        tracing.span("amg.other")


def test_table_arithmetic(clean):
    """Counts, bytes set inside the block, nested spans of one name (the
    seconds once), ``spanned`` and ``reset``."""
    with tracing.span("amg.capture") as outer:
        with tracing.span("amg.capture", 5) as inner:
            inner.nbytes += 2
        outer.nbytes = 1
    tracing.spanned("amg.step")(lambda: None)()
    t = tracing.totals()
    assert t["amg.capture"]["n"] == 2 and t["amg.capture"]["bytes"] == 8
    assert 0 < inner.seconds <= outer.seconds
    assert math.isclose(t["amg.capture"]["s"], outer.seconds,
                        rel_tol=1e-6)
    assert t["amg.step"]["n"] == 1
    assert all(r["n"] == 0 for r in tracing.profiled().values())
    tracing.reset()
    assert all(r == {"n": 0, "s": 0.0, "bytes": 0}
               for r in tracing.totals().values())


def test_counter_rows(clean):
    """``count`` adds counts and bytes (negative ones too: a capture takes
    its counts back) to a counter row, with no seconds, in ``profiled()``
    only while a profiler records; ``counters()`` holds the ring's rows,
    not the set-up's; a span's name is no counter row."""
    tracing.count("amg.setup.banded_declined", 1 << 20)
    tracing.count("amg.ring.send", 40)
    tracing.count("amg.ring.send", 24, 2)
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("amg.ring.all_reduce", 8)
    tracing.count("amg.ring.all_gather", 100)
    tracing.count("amg.ring.all_gather", -100, -1)
    t, p = tracing.totals(), tracing.profiled()
    assert t["amg.ring.send"] == {"n": 3, "s": 0.0, "bytes": 64}
    assert t["amg.ring.all_reduce"] == p["amg.ring.all_reduce"] == {
        "n": 1, "s": 0.0, "bytes": 8}
    assert t["amg.ring.all_gather"]["n"] == 0
    assert p["amg.ring.send"]["n"] == 0
    assert t["amg.setup.banded_declined"] == {"n": 1, "s": 0.0,
                                              "bytes": 1 << 20}
    assert tracing.counters() == {
        ("amg.ring.send", "n"): 3, ("amg.ring.send", "bytes"): 64,
        ("amg.ring.all_reduce", "n"): 1, ("amg.ring.all_reduce", "bytes"): 8,
        ("amg.ring.all_gather", "n"): 0, ("amg.ring.all_gather", "bytes"): 0}
    with pytest.raises(KeyError):
        tracing.count("amg.solve", 8)


@pytest.fixture(scope="module")
def solvers():
    """poisson3d(10) to 1e-6: f32 cycles with f64 defect correction, f64
    cycles, the SPMD solver on a ring of 2 shards in this process, and the
    GSPMD solver on the same ring, its level 0 row-sharded (f32 cycles,
    f64 defect correction) or replicated (f64 cycles)."""
    from amg_tpu_torch.parallel.dist import DistAMGSolver, make_mesh
    from amg_tpu_torch.parallel.spmd_cycle import SpmdAMGSolver

    a, pars = _poisson(tol=1e-6)
    f64 = pars.replace(dtype="float64", refine=False)
    mesh = make_mesh(2, device="cpu")
    ss = {"f32": tamg.AMGSolver(a, pars, log=_quiet, device="cpu"),
          "f64": tamg.AMGSolver(a, f64, log=_quiet, device="cpu"),
          "spmd": SpmdAMGSolver(a, f64, log=_quiet, mesh=mesh),
          "gspmd": DistAMGSolver(a, pars.replace(coarse_replicate_nnz=200),
                                 log=_quiet, mesh=mesh),
          "gspmd64": DistAMGSolver(a, f64, log=_quiet, mesh=mesh)}
    assert ss["gspmd"].Es >= 0 and ss["gspmd64"].Es < 0
    return a, ss


@pytest.mark.parametrize("case", [
    "f64-solve", "f32-solve", "f32-solve_refined", "f32-solve_pcg",
    "f32-solve_pgmres", "f64-solve_batched", "f64-solve_jit",
    "spmd-solve", "spmd-solve_pcg", "gspmd-solve", "gspmd-solve_refined",
    "gspmd64-solve"])
def test_without_a_profiler_only_totals_move(solvers, clean, case):
    """With no profiler an entry adds one ``amg.solve`` (``solve`` handing
    over to ``solve_refined`` or ``solve_pcg`` included), one upload (b:
    the missing x0 is made on the device) and its download to
    ``totals()`` and leaves ``profiled()`` as it was."""
    a, ss = solvers
    kind, entry = case.split("-")
    b = np.random.default_rng(1).standard_normal(a.n_rows)
    if entry == "solve_batched":
        b = np.stack([b, -b], axis=1)
    before = _rows(tracing.profiled())
    x, info = getattr(ss[kind], entry)(b)
    assert info.rres < 1e-6
    t = tracing.totals()
    assert t["amg.solve"]["n"] == 1
    assert t["amg.upload"]["n"] == 1
    assert t["amg.download"]["n"] == 1
    assert t["amg.read"]["n"] >= 2
    assert _rows(tracing.profiled()) == before


def _reads(entry, nits, k):
    if entry == "solve_refined":
        return 1 + math.ceil(nits // k / 2)
    return 2 + math.ceil(nits / 4) + 1


@pytest.mark.parametrize("case", ["poisson-solve_refined",
                                  "poisson-solve_pcg", "fem_rcm-solve_pcg",
                                  "gspmd-solve_refined"])
def test_profiled_spans_of_one_call(clean, case):
    """Under a CPU ``torch.profiler``: one ``amg.solve``; upload and
    download bytes are the arrays moved (b up, and no permutation: a
    WEll level 0's went to the device at set-up; x down in the outer
    dtype; on a ring of 2 shards in this process, the padded rows of
    both); ``amg.read`` is the loop's cadence over ``nits``; every
    ``amg.*`` event of the trace is on the CPU."""
    from amg_tpu_torch.parallel.dist import DistAMGSolver, make_mesh

    matrix, entry = case.split("-")
    a, pars = _fem_rcm() if matrix == "fem_rcm" else _poisson()
    if matrix == "gspmd":
        s = DistAMGSolver(a, pars.replace(coarse_replicate_nnz=200),
                          log=_quiet, mesh=make_mesh(2, device="cpu"))
        assert s.Es >= 0
    else:
        s = tamg.AMGSolver(a, pars, log=_quiet, device="cpu")
    assert (s.staging.perm is not None) == (matrix == "fem_rcm")
    b = np.random.default_rng(2).standard_normal(a.n_rows)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x, info = getattr(s, entry)(b)
    p = tracing.profiled()
    rows = s.pad if matrix == "gspmd" else a.n_rows
    assert p["amg.solve"]["n"] == 1
    assert p["amg.upload"]["n"] == 1 and p["amg.download"]["n"] == 1
    assert p["amg.upload"]["bytes"] == 8 * rows
    assert p["amg.download"]["bytes"] == 8 * rows
    assert p["amg.read"]["n"] == _reads(entry, info.nits,
                                        pars.refine_inner_cycles)
    assert info.rres < pars.tol
    names = {e.name for e in prof.events() if e.name.startswith("amg.")}
    assert {"amg.solve", "amg.upload", "amg.download", "amg.read",
            "amg.step"} <= names
    assert all(e.device_type == torch.autograd.DeviceType.CPU
               for e in prof.events() if e.name.startswith("amg."))
    assert p["amg.solve"]["s"] >= p["amg.step"]["s"] > 0


def test_setup_spans_appear_once_each(clean):
    """The four phases of ``setup``, the coarse inverse and the f64
    level-0 operator once each; one ``amg.setup.pack_level`` per level,
    all inside ``amg.setup.pack``."""
    a, pars = _poisson()
    s = tamg.AMGSolver(a, pars, log=_quiet, device="cpu")
    t = tracing.totals()
    for name in SETUP + ("amg.setup.refine_op",):
        assert t[name]["n"] == 1, name
    assert t["amg.setup.pack_level"]["n"] == len(s.mg.levels)
    assert t["amg.setup.pack"]["s"] >= t["amg.setup.pack_level"]["s"]
    assert t["amg.solve"]["n"] == 0


def test_krylov_reads_are_read_spans(clean):
    """The Krylov host loop's flag reads (``krylov.counts["syncs"]``) are
    ``amg.read`` spans, one each."""
    a = tamg.poisson2d(12)
    op = tamg.Ell.from_csr(a, dtype=torch.float64)
    b = torch.ones(op.padded_rows, dtype=torch.float64)
    syncs = krylov.counts["syncs"]
    krylov.cg(op, b, torch.zeros_like(b), tol=1e-8)
    assert tracing.totals()["amg.read"]["n"] == \
        krylov.counts["syncs"] - syncs > 0


def test_cli_profile_prints_the_span_table(clean, tmp_path, capsys):
    """``--profile DIR`` writes ``trace.json`` and prints the profiled
    spans: name, count, seconds, MiB."""
    from amg_tpu_torch import cli

    assert cli.main(["poisson2d:8", "--device", "cpu", "--profile",
                     str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert (tmp_path / "trace.json").exists()
    head = next(i for i, l in enumerate(out) if l.split()[:4] ==
                ["span", "count", "seconds", "MiB"])
    rows = {}
    for line in out[head + 1:]:
        if not line.startswith("amg."):
            break
        name, count, sec, mib = line.split()
        rows[name] = (int(count), float(sec), float(mib))
    assert rows["amg.solve"][0] == 1
    assert rows["amg.upload"][0] == 2 and rows["amg.download"][0] == 1
    assert rows["amg.setup.pack"][0] == 1
    want = tracing.profiled()["amg.upload"]["bytes"] / 2**20
    assert rows["amg.upload"][2] == pytest.approx(want, abs=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["solve_refined", "solve_pcg"])
def test_spans_on_card_have_no_device_copy(clean, entry):
    """On the card, under a CUDA profiler: every ``amg.*`` event is a
    host event with no device-side copy, and after a warm-up each step
    graph made is one ``amg.capture``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the step graphs are CUDA graphs)")
    a, pars = _poisson()
    s = tamg.AMGSolver(a, pars, log=_quiet)
    b = np.random.default_rng(3).standard_normal(a.n_rows)
    for _ in range(2):
        getattr(s, entry)(b)
    assert tracing.totals()["amg.capture"]["n"] == s.steps.builds > 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        getattr(s, entry)(b)
        torch.cuda.synchronize()
    amg = [e for e in prof.events() if e.name.startswith("amg.")]
    assert {"amg.solve", "amg.step", "amg.read"} <= {e.name for e in amg}
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in amg)
    assert tracing.profiled()["amg.solve"]["n"] == 1
    assert tracing.profiled()["amg.capture"]["n"] == 0
