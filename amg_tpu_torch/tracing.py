"""The program's spans: one table of counts, host seconds and bytes of
its own host work, by span name.

A :class:`span` times one stretch of host code that runs on every call
(an entry, a copy, a host read, one step of a host loop) or once in
set-up.  It adds one count, its host seconds and the bytes it was given
to its name's row of the table.

The names, a closed list (:data:`NAMES`; another name raises
``KeyError``):

- ``amg.solve``: one public entry call of ``AMGSolver`` (``solve``,
  ``solve_refined``, ``solve_pcg``, ``solve_pgmres``, ``solve_batched``,
  ``solve_jit``), of ``SpmdAMGSolver`` (``solve``, ``solve_pcg``) or of
  ``DistAMGSolver`` (``solve``, ``solve_refined``);
- ``amg.upload``: a host array made into the padded device vector in the
  solver's ordering (the entry frame's ``Staging.upload``, whole or in
  rows); bytes: the host-to-device copy (level 0's permutation went to
  the device once, at set-up; a missing x0 is made on the device);
- ``amg.download``: a device solution back to the host in the caller's
  ordering (``Staging.download``), the host permutation included; bytes:
  the device-to-host copy;
- ``amg.read``: one blocking device-to-host read of a norm, a batch of
  residuals or a loop flag in an entry's host loop (``krylov._read``
  included; ``solve_jit``'s final state is one); its count is the
  program's count of host reads;
- ``amg.step``: one step of a host loop through
  ``StepGraph.run``: a replay and the copies it hands back, or the eager
  step on the static buffers;
- ``amg.capture``: one graph made (``StepGraph``'s warm-ups, capture and
  instantiation; ``LoopGraph.build``);
- ``amg.setup.host``, ``amg.setup.plan``, ``amg.setup.reorder``,
  ``amg.setup.pack``: the four phases of ``hierarchy.setup``;
  ``amg.setup.pack_level`` (one level's device pack) and
  ``amg.setup.coarse_inv`` (the coarse inverse) inside the pack;
- ``amg.setup.refine_op``: ``AMGSolver``'s f64 level-0 operator of
  defect correction (``a0_hi``);
- ``amg.setup.shard``: ``SpmdAMGSolver``'s sharding of the packed
  hierarchy and of its f64 level-0 operator (``shard_hierarchy``, the
  general mode's placement, ``a0_hi``);
- ``amg.kernels.build``: one ``nvcc`` build of a CUDA source.

The ring's work that crosses processes is counted in three counter rows
(:data:`COUNTERS`), a count and bytes with no host seconds, added by
:func:`count` (never a span: they sit in code that a CUDA graph captures,
and a replay adds its capture's counts through ``ops.launch_counts``):

- ``amg.ring.send``: one point-to-point message this process sends to
  another process (``parallel.halo._remote_halos``); bytes: its payload;
- ``amg.ring.all_reduce``: one ``Mesh.psum`` that reduces across
  processes; bytes: the reduced tensor;
- ``amg.ring.all_gather``: one ``Mesh.all_gather`` across processes;
  bytes: this process's contribution.

A mesh held by one process adds nothing to them.

One more counter row is the set-up's:

- ``amg.setup.banded_declined``: one coarse level whose RCM band
  ``use_banded="on"`` would store and ``"auto"`` does not, as it reads
  at least the bytes of the level's sparse pack, on rows short enough
  for kernel B2 (``hierarchy.reorder_for_gs``); bytes: the band's.

:func:`totals` holds every span since the process started or since
:func:`reset`; :func:`profiled` only the spans entered while a
``torch.profiler`` records.  Those spans also go into the profiler's
trace, on its clock, as ``cpu_op`` regions of the fast record-function
kind: a region open on the host names the program's work there, and
none has a device-side copy.  With no profiler a span costs one check,
two clock reads and its additions.

A span inside another of its own name (a graph built while another graph
is captured) adds its count and bytes; its seconds are already in the
outer span's.  A span never sits in code that a CUDA graph captures: it
would time the capture, not the replays.
"""

from __future__ import annotations

import functools
from time import perf_counter_ns

import torch

NAMES = (
    "amg.solve",
    "amg.upload",
    "amg.download",
    "amg.read",
    "amg.step",
    "amg.capture",
    "amg.setup.host",
    "amg.setup.plan",
    "amg.setup.reorder",
    "amg.setup.pack",
    "amg.setup.pack_level",
    "amg.setup.coarse_inv",
    "amg.setup.refine_op",
    "amg.setup.shard",
    "amg.kernels.build",
    "amg.ring.send",
    "amg.ring.all_reduce",
    "amg.ring.all_gather",
    "amg.setup.banded_declined",
)
# the rows that :func:`count` adds to, and no span: the ring's (which a
# captured graph's replays add again, :func:`counters`) and the set-up's
COUNTERS = ("amg.ring.send", "amg.ring.all_reduce", "amg.ring.all_gather")
SETUP_COUNTERS = ("amg.setup.banded_declined",)

_profiling = torch._C._autograd._profiler_enabled
_Region = torch._C._profiler._RecordFunctionFast

# name -> [count, ns, bytes, depth] (depth: spans of the name now open)
_totals = {name: [0, 0, 0, 0] for name in NAMES}
# name -> [count, ns, bytes] of the spans entered under a profiler
_profiled = {name: [0, 0, 0] for name in NAMES}


class span:
    """``with span(name, nbytes):`` adds one count, the host seconds of
    the block and ``nbytes`` (settable inside the block) to ``name``'s
    row.  After the block, ``seconds`` holds its host seconds."""

    __slots__ = ("name", "nbytes", "seconds", "_row", "_region", "_t0")

    def __init__(self, name: str, nbytes: int = 0):
        self._row = _totals[name]
        self.name = name
        self.nbytes = nbytes
        self.seconds = 0.0

    def __enter__(self) -> "span":
        self._row[3] += 1
        if _profiling():
            self._region = _Region(self.name)
            self._region.__enter__()
        else:
            self._region = None
        self._t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        ns = perf_counter_ns() - self._t0
        self.seconds = ns * 1e-9
        row = self._row
        row[3] -= 1
        if row[3]:
            ns = 0
        row[0] += 1
        row[1] += ns
        row[2] += self.nbytes
        if self._region is not None:
            self._region.__exit__(None, None, None)
            p = _profiled[self.name]
            p[0] += 1
            p[1] += ns
            p[2] += self.nbytes


def spanned(name: str):
    """A decorator: every call of the function is one ``name`` span."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, nbytes: int, n: int = 1) -> None:
    """Add ``n`` counts and ``nbytes`` to the counter row ``name`` (one of
    :data:`COUNTERS` or :data:`SETUP_COUNTERS`), in :func:`profiled` too
    while a ``torch.profiler`` records.  ``n`` and ``nbytes`` may be
    negative: a capture takes back what the captured code counted while
    it was captured."""
    if name not in COUNTERS and name not in SETUP_COUNTERS:
        raise KeyError(name)
    row = _totals[name]
    row[0] += n
    row[2] += nbytes
    if _profiling():
        p = _profiled[name]
        p[0] += n
        p[2] += nbytes


def counters() -> dict:
    """The ring's counter rows' counts and bytes, as ``{(name, "n"):
    count, (name, "bytes"): bytes}`` (the form ``ops.launch_counts`` takes
    differences of)."""
    out = {}
    for name in COUNTERS:
        r = _totals[name]
        out[(name, "n")], out[(name, "bytes")] = r[0], r[2]
    return out


def _table(rows: dict) -> dict:
    return {name: {"n": r[0], "s": r[1] * 1e-9, "bytes": r[2]}
            for name, r in rows.items()}


def totals() -> dict:
    """Every name's ``{"n", "s", "bytes"}``: spans, host seconds and bytes
    since the process started or since :func:`reset`."""
    return _table(_totals)


def profiled() -> dict:
    """As :func:`totals`, for the spans entered while a
    ``torch.profiler`` recorded."""
    return _table(_profiled)


def reset() -> None:
    """Set both tables to 0 (spans open now keep their depth)."""
    for r in _totals.values():
        r[:3] = [0, 0, 0]
    for r in _profiled.values():
        r[:] = [0, 0, 0]


def table_lines(table: dict) -> list:
    """The rows of ``table`` (:func:`totals` or :func:`profiled`) with a
    count, as text: name, count, seconds, MiB."""
    lines = [f"{'span':<22} {'count':>7} {'seconds':>10} {'MiB':>10}"]
    for name, r in table.items():
        if r["n"]:
            lines.append(f"{name:<22} {r['n']:>7d} {r['s']:>10.4f} "
                         f"{r['bytes'] / 2**20:>10.4f}")
    return lines
