"""Fixtures of the benchmark's CPU tests: the real manifest, traffic mixes
and limits, with each configuration's matrix shrunk so that a run fits a
test (the solver's parameters as the configuration states them, the
coarsest level brought down with the matrix)."""

import json
import shutil
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

SMALL = {
    "p3d7_1m": ({"nx": 16, "ny": 16, "nz": 16}, 200),
    "fem2d_1m": ({"n": 2000}, 300),
}


@pytest.fixture(scope="session")
def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


# a cell on the batched entry, not in BENCHMARK.json (PERF.md, open
# questions): its mix and limits are files here, and the tests drive it
BATCH_CELL = {"name": "p3d7_1m.batch16", "config": "p3d7_1m",
              "traffic": "batch16", "chips": 1, "why": "test"}


@pytest.fixture(scope="session")
def with_batch(manifest):
    """The manifest with the batched cell added."""
    return dict(manifest, workloads=manifest["workloads"] + [BATCH_CELL])


@pytest.fixture(scope="session")
def small_data(tmp_path_factory, manifest):
    """A data directory laid out as ``benchmark/`` (configs, traffic,
    limits) with the configurations at test size."""
    d = tmp_path_factory.mktemp("bench_data")
    shutil.copytree(BENCH / "traffic", d / "traffic")
    shutil.copytree(BENCH / "limits", d / "limits")
    (d / "configs").mkdir()
    for c in manifest["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        matrix, stop = SMALL[c["name"]]
        cfg["matrix"].update(matrix)
        cfg["params"]["coarse_stop_rows"] = stop
        with open(d / "configs" / f"{c['name']}.json", "w") as f:
            json.dump(cfg, f)
    return d


@pytest.fixture(autouse=True)
def one_thread():
    """Several test workers share the cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """Skips a test that needs a CUDA card on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
