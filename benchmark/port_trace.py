"""The program's own span table (``amg_tpu_torch.tracing``), for the
per-layer metrics that read it: each span name's count ``n``, host
seconds ``s`` and ``bytes``.

:func:`profiled` holds the spans entered while the run's profiler
recorded: in a ``--trace 1`` run, exactly the profiled stretch of calls
(the warm-up runs before the profiler starts, the level-0 probe after it
stops).  :func:`totals` holds every span of the process: set-up included.
A program without the table (a checkout older than it) gives None, and
the metric is left out of the line.  In a process group each process
keeps its own table and rank 0 prints the line, so the readings are rank
0's.
"""

from __future__ import annotations


def _tracing():
    try:
        from amg_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def profiled() -> dict | None:
    t = _tracing()
    return None if t is None else t.profiled()


def totals() -> dict | None:
    t = _tracing()
    return None if t is None else t.totals()


def per_call(table: dict | None, *names: str, field: str) -> float | None:
    """The sum of ``field`` over ``names`` per ``amg.solve`` span (None
    without a table or a solve in it)."""
    if not table or not table["amg.solve"]["n"]:
        return None
    return sum(table[n][field] for n in names) / table["amg.solve"]["n"]


def seconds(table: dict | None, *names: str) -> float | None:
    """The host seconds of ``names`` together (None without a table)."""
    if table is None:
        return None
    return float(sum(table[n]["s"] for n in names))
