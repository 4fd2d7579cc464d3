"""The ring cell's readers (``ring_ops_per_iter``, ``ring_mib_per_iter``,
``shard_s``) on a fabricated span table and on a program without its
ring rows, and ``calibrate_ranks.py`` on 2 gloo ranks at test size."""

import json
import subprocess
import sys
import types

import pytest

from benchmark import harness, port_trace

from .conftest import BENCH, ROOT, SMALL

RING = ("amg.ring.send", "amg.ring.all_reduce", "amg.ring.all_gather")
READERS = ("ring_ops_per_iter", "ring_mib_per_iter", "shard_s")


def _table(ring=True, **rows):
    names = ("amg.solve", "amg.setup.pack") + (
        RING + ("amg.setup.shard",) if ring else ())
    t = {n: {"n": 0, "s": 0.0, "bytes": 0} for n in names}
    for name, (n, s, nbytes) in rows.items():
        t["amg." + name.replace("__", ".")] = {"n": n, "s": s,
                                               "bytes": nbytes}
    return t


def _fake(monkeypatch, ring=True):
    """20 profiled calls whose ring rows hold 600 messages of 3 MiB in
    all, 240 all-reduces of 1 MiB and 20 all-gathers of 160 MiB, and a
    set-up whose sharding took 2.5 s."""
    prof = dict(solve=(20, 2.0, 0)) if not ring else dict(
        solve=(20, 2.0, 0), ring__send=(600, 0.0, 3 << 20),
        ring__all_reduce=(240, 0.0, 1 << 20),
        ring__all_gather=(20, 0.0, 160 << 20))
    tot = dict(setup__pack=(1, 4.0, 0))
    if ring:
        tot["setup__shard"] = (1, 2.5, 0)
    mod = types.SimpleNamespace(profiled=lambda: _table(ring, **prof),
                                totals=lambda: _table(ring, **tot))
    monkeypatch.setattr(port_trace, "_tracing", lambda: mod)


@pytest.mark.parametrize("name, want", [
    ("ring_ops_per_iter", 860 / 120), ("ring_mib_per_iter", 164 / 120),
    ("shard_s", 2.5)])
def test_reader_arithmetic(monkeypatch, name, want):
    _fake(monkeypatch)
    rec = {"profile": {"nits": 120}}
    assert harness.load_metric(name)(rec) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_are_silent_on_a_program_without_the_rows(monkeypatch,
                                                          name):
    """A program whose table has no ring rows and no ``amg.setup.shard``
    (the parent of the ring's tracing) or no table at all: None."""
    rec = {"profile": {"nits": 120}}
    _fake(monkeypatch, ring=False)
    assert harness.load_metric(name)(rec) is None
    monkeypatch.setattr(port_trace, "_tracing", lambda: None)
    assert harness.load_metric(name)(rec) is None


@pytest.mark.parametrize("name", ["ring_ops_per_iter", "ring_mib_per_iter"])
def test_per_iteration_readers_need_a_device_trace(monkeypatch, name):
    """No profiled stretch on the device (no ``profile`` in the record,
    a CPU run): None."""
    _fake(monkeypatch)
    assert harness.load_metric(name)({}) is None


def test_the_ring_has_a_test_size():
    """``benchmark/conftest.py`` registers the ring's test size."""
    assert SMALL["p3d7_4x1m"] == ({"nx": 12, "ny": 12, "nz": 24}, 200)


def test_readers_read_the_programs_rows(manifest):
    from amg_tpu_torch import tracing

    assert set(RING) | {"amg.setup.shard"} <= set(tracing.NAMES)
    for m in manifest["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == ["p3d7_4x1m.spmd"]


def test_calibrate_ranks_on_two_gloo_ranks(small_data):
    """Both kinds of run give every number; the float32 outer loop misses
    a limit of the cell; the ring's readings come from both ranks."""
    proc = subprocess.run(
        [sys.executable, str(BENCH / "calibrate_ranks.py"), "--workload",
         "p3d7_4x1m.spmd", "--seeds", "2147483659,2147483660",
         "--seconds", "0.3", "--controls", "1", "--device", "cpu",
         "--data", str(small_data), "--ranks", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(l) for l in proc.stdout.splitlines()]
    by_kind = {}
    for d in lines:
        by_kind.setdefault(d["kind"], []).append(d)
    limits = dict(harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                               "p3d7_4x1m.spmd", small_data).limits,
                  rres_worst=1e-8)
    for d in by_kind["sound"]:
        assert d["failed"] == 0
        assert all(d["numbers"][k] <= v for k, v in limits.items())
    (ctl,) = by_kind["f32_outer"]
    assert any(ctl["numbers"][k] > v for k, v in limits.items())
    (prod,) = by_kind["ring_product"]
    assert len(prod["gap"]["cycle"]) == len(prod["gap"]["float64"]) == 2
    assert max(prod["gap"]["float64"]) < 1e-14
    assert max(prod["gap"]["cycle"]) < 1e-6
    (counts,) = by_kind["ring_counts"]
    assert counts["graph"] == counts["eager"]
    assert counts["graph"]["amg.ring.send"][0] > 0
