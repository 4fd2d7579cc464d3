"""The readers of the program's span table (``port_trace.py`` and the
five metrics that read it) on a fabricated table, and their silence on a
program without one."""

import sys
import types

import pytest

from benchmark import harness, port_trace

SPANS = ("amg.solve", "amg.upload", "amg.download", "amg.read",
         "amg.capture", "amg.setup.pack", "amg.setup.refine_op")
READERS = ("copy_share", "copy_mib_per_call", "host_reads_per_call",
           "pack_s", "capture_s")


def _table(**rows):
    t = {n: {"n": 0, "s": 0.0, "bytes": 0} for n in SPANS}
    for name, (n, s, nbytes) in rows.items():
        t["amg." + name.replace("__", ".")] = {"n": n, "s": s,
                                               "bytes": nbytes}
    return t


@pytest.fixture
def fake(monkeypatch):
    """A span table module whose ``profiled()`` holds 20 calls and whose
    ``totals()`` holds the set-up and the graphs made."""
    mod = types.SimpleNamespace(
        profiled=lambda: _table(solve=(20, 2.0, 0),
                                upload=(40, 0.3, 640 << 20),
                                download=(20, 0.2, 160 << 20),
                                read=(120, 0.05, 0)),
        totals=lambda: _table(solve=(35, 3.5, 0), capture=(3, 1.25, 0),
                              setup__pack=(1, 2.5, 0),
                              setup__refine_op=(1, 0.5, 0)))
    monkeypatch.setattr(port_trace, "_tracing", lambda: mod)
    return mod


@pytest.mark.parametrize("name, want", [
    ("copy_share", 25.0), ("copy_mib_per_call", 40.0),
    ("host_reads_per_call", 6.0), ("pack_s", 3.0), ("capture_s", 1.25)])
def test_reader_arithmetic(fake, name, want):
    assert harness.load_metric(name)({}) == pytest.approx(want)


@pytest.mark.parametrize("name", ["copy_share", "copy_mib_per_call",
                                  "host_reads_per_call"])
def test_per_call_readers_need_profiled_calls(monkeypatch, name):
    """With no call in the profiled stretch (a run without a device
    trace) a per-call reader gives None."""
    empty = types.SimpleNamespace(profiled=lambda: _table(),
                                  totals=lambda: _table())
    monkeypatch.setattr(port_trace, "_tracing", lambda: empty)
    assert harness.load_metric(name)({}) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_are_silent_without_the_table(monkeypatch, name):
    """A program without ``amg_tpu_torch.tracing`` (a checkout older than
    it): every reader gives None, and raises nothing."""
    import amg_tpu_torch

    monkeypatch.delattr(amg_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "amg_tpu_torch.tracing", None)
    assert port_trace.profiled() is None and port_trace.totals() is None
    assert harness.load_metric(name)({}) is None


def test_readers_read_the_programs_table():
    """The real module: the names the readers sum are the program's."""
    from amg_tpu_torch import tracing

    assert set(SPANS) <= set(tracing.NAMES)
    assert set(port_trace.totals()) == set(tracing.NAMES)
