"""A cell of several cards: the rank processes that ``run.py`` starts,
stopped together when one fails, and a process group (gloo on the CPU
here, NCCL on the cards) driving one cell through the harness, rank 0
judging the result."""

import json
import multiprocessing
import shutil
import sys
import time
import types

from benchmark import harness, port_api, run

from .conftest import ROOT

SPMD_CELL = {"name": "p3d7_4x1m.spmd", "config": "p3d7_4x1m",
             "traffic": "solve", "chips": 2, "why": "test"}


def test_launch_stops_every_rank_when_one_fails():
    t0 = time.perf_counter()
    rc, _ = run.launch([[sys.executable, "-c", "import time; time.sleep(60)"],
                        [sys.executable, "-c", "import sys; sys.exit(5)"]])
    assert rc == 5
    assert time.perf_counter() - t0 < 40


def test_launch_returns_rank_0s_output():
    rc, out = run.launch([[sys.executable, "-c", "print('a'); print('b')"],
                          [sys.executable, "-c", "print('c')"]])
    assert rc == 0 and out.split() == ["a", "b"]


def test_every_rank_refuses_a_forbidden_module(monkeypatch):
    """The check a rank makes once its window has closed (a rank's
    non-zero exit stops the group and is the run's exit code): by whole
    top-level name, so the program itself passes."""
    assert "amg_tpu_torch" in sys.modules
    assert run.loaded_forbidden() == 0
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert run.loaded_forbidden() == 3


def _rank(rank, world, port, data, manifest, queue):
    import torch

    torch.set_num_threads(1)
    port_api.join_group(f"127.0.0.1:{port}", world, rank, "cpu")
    cell = harness.Cell(manifest, SPMD_CELL["name"], data)
    for trace_on in (False, True):
        rec = harness.run(cell, 2**31 + 99, 0.5, trace_on, "cpu",
                          time.time())
        if rank == 0:
            queue.put(harness.result(cell, rec, trace_on, {}))
    torch.distributed.destroy_process_group()


def test_a_process_group_drives_one_cell(manifest, small_data, tmp_path):
    data = tmp_path / "data"
    shutil.copytree(small_data, data)
    with open(ROOT / "benchmark" / "configs" / "p3d7_4x1m.json") as f:
        cfg = json.load(f)
    cfg["matrix"].update(nx=12, ny=12, nz=24)
    cfg["params"]["coarse_stop_rows"] = 200
    with open(data / "configs" / "p3d7_4x1m.json", "w") as f:
        json.dump(cfg, f)
    with open(data / "limits" / "p3d7_4x1m.spmd.json", "w") as f:
        json.dump({"limits": {"rres_report_gap": 1e-10,
                              "l0_op_gap": 1e-4}}, f)
    per_layer = [dict(m, workloads=m["workloads"] + [SPMD_CELL["name"]])
                 for m in manifest["per_layer"]]
    man = dict(manifest, workloads=manifest["workloads"] + [SPMD_CELL],
               per_layer=per_layer)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = run.free_port()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, data, man, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        outs = [queue.get(timeout=300) for _ in range(2)]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    plain, traced = outs
    assert plain["correct"] is True, plain["checks"]
    assert traced["correct"] is True, traced["checks"]
    assert {"rhs_per_s", "setup_s"} <= set(plain["metrics"])
    assert traced["metrics"]["iters"]["value"] >= 1
