"""The kernel modules' launch counters and the ring's host counters, as a
whole.

Each kernel wrapper counts a launch when it is called, and the ring
counts its products and collectives (``parallel.halo.counts``,
``parallel.dist.counts``, registered in :data:`COUNTERS` by their
modules; the messages and collectives that cross processes also in the
span table's counter rows, ``tracing.COUNTERS``, keyed here by the
``tracing`` module) when they are called.  Called while a CUDA graph is
captured, they launch nothing: the code that captures takes the capture's
counts back (:func:`delta`, :func:`add` with ``times=-1``) and adds them
again for every run of the graph (``solve.loop_graph.StepGraph`` per replay,
``solve.loop_graph.LoopGraph`` per run of a captured body).
"""

from __future__ import annotations

from .. import tracing
from . import dense_kernel, dia_kernel, krylov_small, well_kernel

MODULES = (dia_kernel, well_kernel, krylov_small, dense_kernel)
# host counters that code run inside a captured graph adds to: a key of
# the counts below is the position of the counter here
COUNTERS: list = []


def _live(key) -> tuple:
    """The live dicts behind ``key``: a kernel module's ``launches`` and
    ``launches_by_shape``, or a registered counter."""
    if key in MODULES:
        return key.launches, key.launches_by_shape
    return (COUNTERS[key],)


def snapshot() -> dict:
    """Every counter (per kernel module ``launches`` and
    ``launches_by_shape``, per registered counter its dict, the span
    table's counter rows under ``tracing``), copied."""
    keys = MODULES + tuple(range(len(COUNTERS)))
    snap = {k: tuple(dict(d) for d in _live(k)) for k in keys}
    snap[tracing] = (tracing.counters(),)
    return snap


def delta(before: dict, after: dict) -> dict:
    """``after - before`` (as :func:`snapshot` gives them), the nonzero
    counts only."""
    return {K: tuple({k: n - b.get(k, 0) for k, n in a.items()
                      if n != b.get(k, 0)}
                     for a, b in zip(after[K], before.get(K, ({},) * len(
                         after[K]))))
            for K in after}


def add(counts: dict, times: int):
    """Add ``times`` x ``counts`` to the counters.  The keys of a module's
    ``launches`` and of a registered counter stay; a ``launches_by_shape``
    key that falls to 0 goes.  The span table's rows are added through
    ``tracing.count``, so that a replay under a profiler lands in
    ``tracing.profiled`` too."""
    for K, parts in counts.items():
        if K is tracing:
            for (name, field), v in parts[0].items():
                if field == "n":
                    tracing.count(name, 0, v * times)
                else:
                    tracing.count(name, v * times, 0)
            continue
        for j, (live, part) in enumerate(zip(_live(K), parts)):
            for key, n in part.items():
                v = live.get(key, 0) + n * times
                if v or j == 0:
                    live[key] = v
                else:
                    live.pop(key, None)


def empty(counts: dict) -> bool:
    return not any(any(parts) for parts in counts.values())
