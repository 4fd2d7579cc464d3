"""The benchmark's files: the manifest against its contract, every file a
cell names found by name, the seeded pool, the reference's generators
against the program's, the last line's schema, the run without a card
and the modules a run loads."""

import json
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmark import harness, port_api
from benchmark.reference import generators

from .conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_manifest_follows_the_contract(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    names = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    assert len(json.dumps(manifest)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "traffic", "metrics", "limits"])
def test_every_file_a_cell_names_loads(with_batch, kind):
    for w in with_batch["workloads"]:
        cell = harness.Cell(with_batch, w["name"])
        if kind == "configs":
            assert cell.config["name"] == w["config"]
            port_api.params(cell.config["params"])
        elif kind == "traffic":
            assert cell.traffic["entry"] in ("solve", "solve_batched")
        elif kind == "limits":
            assert set(cell.limits) == {"rres_report_gap", "l0_op_gap"}
        else:
            for m in cell.e2e + cell.per_layer:
                assert callable(harness.load_metric(m["name"]))
    for c in with_batch["configs"]:
        assert (ROOT / c["file"]).exists()


def test_rhs_pool_repeats_for_a_seed_and_differs_across_seeds():
    traffic = harness.load_json(BENCH / "traffic" / "batch16.json")

    def pool(seed):
        rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(3)[0])
        return harness.rhs_inputs(traffic, 50, rng)

    big = 2**31 + 12345
    a, b, c = pool(big), pool(big), pool(big + 1)
    assert len(a) == 4 and a[0].shape == (50, 16) and a[0].flags.c_contiguous
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert -1.0 <= a[0].min() and a[0].max() < 1.0


def _port_arrays(a):
    return (np.asarray(a.indptr, dtype=np.int64), np.asarray(a.indices),
            np.asarray(a.data))


@pytest.mark.parametrize("kind", ["poisson3d", "fem2d"])
def test_reference_generators_equal_the_programs(kind):
    import amg_tpu_torch as amg

    if kind == "poisson3d":
        ours = generators.poisson3d_7pt(5, 4, 3)
        theirs = _port_arrays(amg.poisson3d(5, 4, 3))
    else:
        ours = generators.fem2d(700, seed=3, kappa_jump=1e3)
        theirs = _port_arrays(amg.fem2d(700, seed=3, kappa_jump=1e3))
    for x, y in zip(ours, theirs):
        assert np.array_equal(x, y)


def test_the_last_line_has_the_contracts_keys(manifest, small_data):
    cell = harness.Cell(manifest, "p3d7_1m.solve", small_data)
    for trace_on in (False, True):
        rec = harness.run(cell, 2**33 + 5, 0.3, trace_on, "cpu", time.time())
        out = harness.result(cell, rec, trace_on, {"platform": "gpu",
                                                   "kind": "test",
                                                   "count": 1})
        assert list(out)[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics",
                "device"} <= set(out)
        assert out["correct"] is True and out["failed"] == 0
        assert out["attempted"] >= 1
        want = cell.per_layer if trace_on else cell.e2e
        names = {m["name"] for m in want}
        assert set(out["metrics"]) <= names
        for name, m in out["metrics"].items():
            assert NAME.match(name) and UNIT.match(m["unit"])
            assert isinstance(m["value"], float) or isinstance(m["value"],
                                                                int)
        assert {"platform", "kind", "count",
                "memory_peak_bytes"} <= set(out["device"])
        json.dumps(out)
    assert {"rhs_per_s", "solve_ms_p95", "setup_s"} <= set(
        harness.result(cell, harness.run(cell, 3, 0.2, False, "cpu", time.time()),
                       False, {})["metrics"])


def test_run_exits_nonzero_without_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "p3d7_1m.solve", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert "correct" not in proc.stdout
    assert "CUDA card" in proc.stderr


IMPORT_CHECK = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.harness, benchmark.calibrate
import amg_tpu_torch
for m in pkgutil.walk_packages(amg_tpu_torch.__path__, "amg_tpu_torch."):
    importlib.import_module(m.name)
from benchmark import harness
for name in {metrics!r}:
    harness.load_metric(name)
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_nothing_the_benchmark_runs_imports_jax(manifest):
    """Every module the benchmark imports, directly or through the
    program, by whole top-level name: ``amg_tpu_torch`` is the program,
    ``amg_tpu`` and ``jax`` may not appear."""
    metrics = [m["name"] for m in manifest["end_to_end"] +
               manifest["per_layer"]]
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_CHECK.format(root=str(ROOT),
                                                   metrics=metrics)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    top = set(proc.stdout.split())
    assert "amg_tpu_torch" in top and "benchmark" in top
    assert not top & set(harness.FORBIDDEN)
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "amg_tpu")


@pytest.mark.gpu
def test_a_traced_run_reads_the_device(manifest, small_data, cuda):
    """On the card: the profiler sees device work, the level-0 product is
    timed, and no share of a roofline passes 100%."""
    cell = harness.Cell(manifest, "p3d7_1m.solve", small_data)
    rec = harness.run(cell, 17, 0.5, True, "cuda", time.time())
    out = harness.result(cell, rec, True, {})
    assert out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["l0_op_roofline"]["value"] <= 100
