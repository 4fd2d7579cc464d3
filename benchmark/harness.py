"""One run of one cell: build the matrix, set up the solver under test,
warm up, drive the traffic mix in a closed loop for the window, check
what the window produced against the plain reference, and reduce the run
to its metrics.

Everything that belongs to one configuration, traffic mix, metric or
cell is a file found by name:

- ``configs/<config>.json``: the matrix (a generator of
  ``reference/generators.py`` and its arguments) and the solver's
  parameters;
- ``traffic/<mix>.json``: the entry driven, the columns per call, the
  right-hand sides' pool and distribution, and the sizes of the warm-up,
  the checked sample and the profiled stretch;
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``, with the readings they were set from;
- ``metrics/<metric>.py``: ``read(record) -> float | None``.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import math
import os
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from . import port_api, trace
from .peaks import spmv_bytes
from .reference import check
from .reference.generators import generate

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"

# the JAX stack and the JAX package the port was made from: none of them
# may be loaded by the process that reports a result
FORBIDDEN = ("jax", "jaxlib", "flax", "amg_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic
    mix and limits, read from the files named by it under ``data``."""

    def __init__(self, manifest: dict, name: str, data: Path = BENCH):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec = cells[name]
        self.name = name
        self.chips = int(self.spec["chips"])
        self.config = load_json(data / "configs" / f"{self.spec['config']}.json")
        self.traffic = load_json(data / "traffic" / f"{self.spec['traffic']}.json")
        lim = data / "limits" / f"{name}.json"
        self.limits = load_json(lim)["limits"] if lim.exists() else None
        self.tol = float(self.traffic.get("tol") or
                         self.config["params"]["tol"])
        self.e2e = [m for m in manifest["end_to_end"] if self._has(m)]
        moved = {m["name"] for m in self.e2e}
        self.per_layer = [m for m in manifest["per_layer"]
                          if self._has(m) and m["moves"] in moved]

    def _has(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])


def matrix(config: dict):
    """The configuration's CSR arrays, from the checkout's matrix cache
    when a run here built them before (keyed by the configuration's name
    and its generator's arguments), else generated and cached."""
    spec = config["matrix"]
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()
                         ).hexdigest()[:16]
    path = CACHE / f"{config['name']}-{key}.npz"
    if path.exists():
        with np.load(path) as z:
            return z["indptr"], z["indices"], z["data"]
    indptr, indices, data = generate(spec)
    CACHE.mkdir(exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, indptr=indptr, indices=indices, data=data)
    os.replace(tmp, path)
    return indptr, indices, data


def rhs_inputs(traffic: dict, n: int, rng: np.random.Generator) -> list:
    """The pool of right-hand sides, in the form each call hands over:
    ``(n,)`` vectors, or ``(n, k)`` contiguous blocks of ``k`` pool
    members for a batched entry."""
    dist = traffic["rhs"]
    if dist["dist"] != "uniform":
        raise ValueError(f"unknown rhs distribution {dist['dist']!r}")
    pool = rng.uniform(dist["low"], dist["high"], size=(traffic["pool"], n))
    k = int(traffic["columns"])
    if k == 1:
        return list(pool)
    return [np.ascontiguousarray(pool[j:j + k].T)
            for j in range(0, traffic["pool"] - k + 1, k)]


def load_metric(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Session:
    """The solver under test set up for a cell on ``device`` (the
    program's set-up), with the matrix the benchmark made and the plain
    reference of it.  ``params`` overrides entries of the configuration's
    solver parameters (the lower-precision control)."""

    def __init__(self, cell: Cell, device: str, params: dict | None = None):
        self.cell = cell
        self.cuda = device == "cuda"
        self.k = int(cell.traffic["columns"])
        t0 = time.perf_counter()
        indptr, indices, data = matrix(cell.config)
        t1 = time.perf_counter()
        self.n = len(indptr) - 1
        self.ref = check.Matrix(indptr, indices, data)
        pars = dict(cell.config["params"], **(params or {}))
        self.rank, self.world = ((dist.get_rank(), dist.get_world_size())
                                 if dist.is_initialized() else (0, 1))
        self.solver = port_api.make_solver(
            indptr, indices, data, port_api.params(pars), device,
            cell.config.get("solver", "amg"))
        self.call = port_api.entry(self.solver, cell.traffic["entry"],
                                   cell.tol)
        self.warm = False
        log(f"# set-up: matrix {t1 - t0:.2f} s, solver "
            f"{time.perf_counter() - t1:.2f} s")

    def warm_up(self, inputs: list) -> None:
        """Every step graph the window replays is captured here: at least
        ``warmup_calls`` calls, and more while a call still makes one."""
        need = int(self.cell.traffic["warmup_calls"])
        builds = port_api.graph_builds(self.solver)
        for i in range(need + 8):
            self.call(inputs[i % len(inputs)])
            now = port_api.graph_builds(self.solver)
            if i + 1 >= need and now == builds:
                break
            builds = now
        if self.cuda:
            torch.cuda.synchronize()
        self.warm = True

    def _go_on(self, i: int, trace_on: bool, t_window: float,
               seconds: float) -> bool:
        """Whether the window takes another call: the profiled stretch's
        count, or the clock, read by rank 0 and sent to every rank (each
        call of a process group is collective)."""
        traffic = self.cell.traffic
        if trace_on:
            return i < int(traffic["trace_calls"])
        go = time.perf_counter() - t_window < seconds
        if self.world > 1:
            flag = torch.tensor([go], device="cuda" if self.cuda else "cpu")
            dist.broadcast(flag, 0)
            go = bool(flag.item())
        return go

    def drive(self, seed: int, seconds: float, trace_on: bool,
              t_process: float) -> dict:
        """Draw the seed's right-hand sides, warm up (once per session),
        run the window (``trace_on``: the profiled stretch of
        ``trace_calls`` calls), read the device's peak, then apply level
        0's packed operator to a seeded probe (timing it when traced).
        ``t_process`` is the start of the run (``time.time()``).
        Returns the run's record, the reference's inputs under ``_``."""
        traffic = self.cell.traffic
        pool_rng, sample_rng, probe_rng = (
            np.random.default_rng(s)
            for s in np.random.SeedSequence(seed).spawn(3))
        inputs = rhs_inputs(traffic, self.n, pool_rng)
        if not self.warm:
            t0 = time.perf_counter()
            self.warm_up(inputs)
            log(f"# warm-up {time.perf_counter() - t0:.2f} s")
        builds = port_api.graph_builds(self.solver)
        calls, sample = [], []
        n_sample = int(traffic["check_sample"])
        prof = None
        setup_s = time.time() - t_process
        if trace_on and self.cuda:
            # the device's trace (a CPU run has no device to trace)
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        t_window = time.perf_counter()
        i = 0
        while True:
            j = i % len(inputs)
            with record_function(trace.CALL) if trace_on else nullcontext():
                t0 = time.perf_counter()
                x, info = self.call(inputs[j])
                ms = (time.perf_counter() - t0) * 1e3
            nits, rres = port_api.info_numbers(info)
            calls.append({"ms": ms, "nits": nits, "rres": rres,
                          "solved": bool(np.isfinite(rres)
                                         and rres < self.cell.tol)})
            # a seeded reservoir: every call of the window equally likely
            if i < n_sample:
                sample.append((j, x, rres))
            else:
                r = int(sample_rng.integers(0, i + 1))
                if r < n_sample:
                    sample[r] = (j, x, rres)
            i += 1
            if not self._go_on(i, trace_on, t_window, seconds):
                break
        window_s = time.perf_counter() - t_window
        if prof is not None:
            prof.__exit__(None, None, None)
        q = np.percentile([c["ms"] for c in calls], [0, 50, 95, 100])
        log(f"# {len(calls)} calls in {window_s:.3f} s; ms min {q[0]:.2f}, "
            f"median {q[1]:.2f}, p95 {q[2]:.2f}, max {q[3]:.2f}")
        peak = torch.cuda.max_memory_allocated() if self.cuda else 0
        built = port_api.graph_builds(self.solver) - builds
        if built:
            log(f"# {built} step graph(s) made inside the window")
        k = self.k
        rec = {"cell": self.cell.name, "columns": k, "tol": self.cell.tol,
               "setup_s": setup_s, "window_s": window_s,
               "calls": calls, "rhs_attempted": k * len(calls),
               "rhs_solved": k * sum(c["solved"] for c in calls),
               "hierarchy_s": port_api.hierarchy_seconds(self.solver),
               "device_peak_bytes": int(peak),
               "graphs_built_in_window": built}

        probe = check.probe_vector(probe_rng, self.n, k)
        prepare, apply = port_api.level0_product(self.solver)
        xd = prepare(probe)
        y = port_api.to_host(self.solver, apply(xd))
        if trace_on and self.cuda:
            # a rank of a group applies its own row shard: its share of
            # the operator's bytes
            rec["l0_op"] = {
                "ms": trace.kernel_ms(lambda: apply(xd)),
                "bytes": spmv_bytes(self.ref.nnz, self.n, k,
                                    self.cell.config["params"]["dtype"])
                / self.world}
        if prof is not None:
            t0 = time.perf_counter()
            reduced = trace.reduce(prof)
            log(f"# trace of {len(calls)} calls read in "
                f"{time.perf_counter() - t0:.1f} s")
            if reduced:
                rec["profile"] = dict(reduced,
                                      nits=sum(c["nits"] for c in calls))
        rec["_"] = (inputs, sample, probe, y)
        return rec

    def close(self) -> None:
        """Free the program's state (the reference runs after it)."""
        self.solver = self.call = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, trace_on: bool,
        device: str, t_process: float) -> dict:
    """One run of ``cell`` (in a process group: this rank's part of it):
    set-up, window, the program's state freed, then on rank 0 the
    reference's numbers (``rec["numbers"]``) and every rank's per-layer
    record (``rec["ranks"]``)."""
    sess = Session(cell, device)
    rec = sess.drive(seed, seconds, trace_on, t_process)
    sess.close()
    if sess.world > 1:
        mine = {k: v for k, v in rec.items() if k not in ("calls", "_")}
        ranks = [None] * sess.world
        dist.all_gather_object(ranks, mine)
        rec["ranks"] = ranks
    rec["numbers"] = numbers(sess.ref, *rec.pop("_")) if sess.rank == 0 \
        else None
    return rec


def numbers(a, inputs, sample, probe, y) -> dict:
    """The numbers compared: the worst true relative residual of the
    sampled answers, the widest gap between a sampled call's reported
    residual and its true one, and the gap of the level-0 product."""
    worst, report_gap = 0.0, 0.0
    for j, x, reported in sample:
        true = a.rel_residual(inputs[j], np.asarray(x, dtype=np.float64))
        worst = max(worst, float(np.max(true)))
        report_gap = max(report_gap, abs(reported - float(np.max(true))))
    return {"rres_worst": worst if sample else math.nan,
            "rres_report_gap": report_gap if sample else math.nan,
            "l0_op_gap": check.product_gap(y, a.matvec(probe))}


def result(cell: Cell, rec: dict, trace_on: bool, device: dict) -> dict:
    """The last line: ``correct``, counts, the cell's metrics, the device,
    and (traced) the breakdown; the numbers compared come last."""
    limits = {"rres_worst": cell.tol, **(cell.limits or {})}
    correct, shown = check.judge(rec["numbers"], limits)
    # a per-layer metric of a process group: its worst rank (the largest
    # reading); end-to-end metrics are rank 0's, whose calls wait for all
    ranks = [dict(r, calls=rec["calls"]) for r in rec.get("ranks", [rec])]
    metrics = {}
    for m in (cell.per_layer if trace_on else cell.e2e):
        read = load_metric(m["name"])
        vals = [v for v in map(read, ranks if trace_on else [rec])
                if v is not None]
        if vals:
            metrics[m["name"]] = {"value": max(vals), "unit": m["unit"]}
    dev = dict(device, memory_peak_bytes=max(r["device_peak_bytes"]
                                             for r in ranks))
    out = {"correct": correct,
           "attempted": rec["rhs_attempted"],
           "failed": rec["rhs_attempted"] - rec["rhs_solved"],
           "metrics": metrics, "device": dev}
    profs = [r["profile"] for r in ranks if r.get("profile")]
    if trace_on and profs:
        dev["busy_s"] = sum(p["busy_s"] for p in profs) / len(profs)
        dev["window_s"] = max(p["window_s"] for p in profs)
        prof = rec.get("profile") or profs[0]
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["checks"] = shown
    return out
