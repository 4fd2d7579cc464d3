"""Device loops: a small program of loop bodies, run by the host on the
CPU and as one CUDA graph with while and if nodes on the card.

``amg_tpu`` keeps its Krylov loops on the device with ``lax.while_loop``
and ``lax.cond``.  Here a loop is a program of steps over tensors whose
addresses stay fixed:

* a *segment*, a callable that reads and writes the loop's state tensors
  in place (``copy_``) and reads nothing from the host;
* :class:`While`: run ``body`` while the device flag ``flag`` (one bool)
  is set; the body leaves the flag for the next test;
* :class:`If`: run ``body`` once if ``flag`` is set;
* :class:`Copy`: copy one contiguous tensor into another of its shape.

:func:`run_plain` runs a program on the host: a Python ``while``/``if`` on
``bool(flag)``, one host read per test (``krylov.counts["syncs"]``), the
plain version of the nodes.  :class:`LoopGraph` makes it one CUDA graph:
each segment is run eagerly twice (the second time under
``torch.cuda.set_sync_debug_mode("error")``, so a segment that reads the
host raises), captured once with ``torch.cuda.CUDAGraph(keep_graph=True)``
(one memory pool for all of a program's captures: segments run one after
another and hand nothing to each other but the state tensors), and placed
as a child graph node; while and if nodes are added with the CUDA
runtime's conditional nodes (``ops.krylov_small.Graph``), a one-thread
kernel setting each condition from its flag.  The graph is instantiated
once and launched on the current stream; inside another capture
(``torch.cuda.is_current_stream_capturing()``) the same nodes are added to
the graph being captured instead (:meth:`LoopGraph.add_to_capture`).

A segment may hold a process group's NCCL collectives and p2p messages
(the Krylov loops with an NCCL group's ``psum``): NCCL adds an event wait
node and an event record node to a graph that captures one of its calls,
to order the graph's NCCL work against NCCL calls made outside it, and a
conditional node's body may hold no event node.  So a captured segment
placed inside a while or if node is stripped of them first
(``krylov_small.strip_events``: each one's dependencies pass to its
dependents); within one graph the nodes run in one chain, and the
segments at the top level keep theirs, which order the whole graph
against the group's calls before and after it.

A kernel wrapper counts its launch when a segment is captured; the graph
takes those counts back and counts each captured segment's runs on the
device.  :func:`settle` adds them, runs times, to the kernel modules'
counters (one host read per graph): whoever reads the counters calls it
just after the run it measures, and before setting them to 0.  There is
no fallback: a failure to build, capture or instantiate raises.

:class:`StepGraph` is the other kind of program here: one step of a host
loop (a cycle and its residual norm, an FCG iteration), the counterpart
of one ``jax.jit`` program of ``amg_tpu``, on static buffers, captured
once on the card and replayed by every later step; :class:`StepGraphs`
keeps a solver's step graphs, keyed, in one memory pool.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import weakref

import torch

from .. import tracing
from ..ops import launch_counts, krylov_small


@dataclasses.dataclass(eq=False)
class While:
    flag: torch.Tensor
    body: tuple


@dataclasses.dataclass(eq=False)
class If:
    flag: torch.Tensor
    body: tuple


@dataclasses.dataclass(eq=False)
class Copy:
    dst: torch.Tensor
    src: torch.Tensor


def run_plain(prog, read):
    """Run ``prog`` on the host; ``read(flag) -> bool`` reads a flag."""
    for step in prog:
        if isinstance(step, While):
            while read(step.flag):
                run_plain(step.body, read)
        elif isinstance(step, If):
            if read(step.flag):
                run_plain(step.body, read)
        elif isinstance(step, Copy):
            step.dst.copy_(step.src)
        else:
            step()


def segments(prog) -> list:
    """The program's segments, each once, in program order."""
    out: list = []
    for step in prog:
        if isinstance(step, (While, If)):
            out += [s for s in segments(step.body) if s not in out]
        elif not isinstance(step, Copy) and step not in out:
            out.append(step)
    return out


# graphs whose captured segments launched counted kernels
_pending: "weakref.WeakSet[LoopGraph]" = weakref.WeakSet()
# launches of LoopGraphs, and the nodes that add_to_capture placed below
# the top level of a graph being captured, over the process
_tally = {"launches": 0, "nested_nodes": 0}
# one list per capture in progress that keeps what its graph holds: the
# LoopGraphs that add_to_capture placed in it
_keepers: list = []


@contextlib.contextmanager
def keeping_added():
    """Collect the LoopGraphs that :meth:`LoopGraph.add_to_capture` adds
    inside (their nodes run on their pools and buffers: a graph holding
    them keeps them alive)."""
    kept: list = []
    _keepers.append(kept)
    try:
        yield kept
    finally:
        _keepers.pop()


@contextlib.contextmanager
def no_collector():
    """Keep Python's cyclic garbage collector from running inside: an
    object it frees may destroy a CUDA graph, which invalidates a capture
    in progress."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@contextlib.contextmanager
def host_syncs_raise():
    """Inside, a call that synchronises with the host raises
    (``torch.cuda.set_sync_debug_mode("error")``): an eager run of a
    segment or step under it proves that it reads nothing from the host
    before it is captured."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def settle():
    """Add the kernel launches of every graph's segment runs since the
    last call to the kernel modules' counters (one host read per graph
    with counted launches)."""
    for g in list(_pending):
        g.settle()


class LoopGraph:
    """``prog`` as one CUDA graph on ``device``.

    ``restore``: tensors whose values the eager warm-up of the segments
    must not change (the Krylov layer's device counters).  After
    :meth:`build`: ``nodes`` (the graph's nodes, child graphs' and
    conditional bodies' included), ``captures`` (segments captured as
    child graphs), ``direct`` (segments captured into their place),
    ``build_seconds`` (warm-up, captures and instantiation),
    ``pool_bytes`` (device memory the captures took), ``events`` (the
    event nodes taken out of segments inside conditional bodies).
    ``embedded`` holds the graphs whose nodes a segment captured in place
    added (the KRYLOV coarsest solves of a captured cycle), kept alive
    with it."""

    def __init__(self, prog, device, restore=()):
        self.prog = tuple(prog)
        self.device = torch.device(device)
        self.restore = tuple(restore)
        self.segs = segments(self.prog)
        self.direct: set = set()      # segments that run device loops
        self.captured: dict = {}      # segment -> torch CUDAGraph
        self.counted: dict = {}       # segment -> (index, launch counts)
        self.runs = None              # runs of each segment (int64)
        self.settled: list = []
        self.increments: dict = {}    # index -> CUDAGraph of runs[i] += 1
        self.root = self.exec = None
        self.pool = self.pool_device = None
        self.holds = 0                # holds on the pool of direct captures
        self.embedded = ()
        self.stripped: set = set()    # segments stripped of event nodes
        self.nodes = self.captures = self.pool_bytes = self.events = 0
        self.build_seconds = 0.0

    def _warm_up(self, stream):
        with torch.cuda.stream(stream):
            saved = [t.clone() for t in self.restore]
            for seg in self.segs:
                seg()
            with host_syncs_raise():
                for seg in self.segs:
                    launched = _tally["launches"]
                    seg()
                    if _tally["launches"] != launched:
                        self.direct.add(seg)
            for t, v in zip(self.restore, saved):
                t.copy_(v)

    def _capture(self, fn, stream, pool):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(stream):
            g.capture_begin(pool=pool)
            try:
                fn()
            finally:
                g.capture_end()
        return g

    def build(self):
        """Warm up, capture every segment, compose and instantiate."""
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a device loop's graph is built outside "
                               "captures: run its solve once eagerly first")
        with no_collector(), tracing.span("amg.capture") as sp:
            self._build()
        self.build_seconds = sp.seconds

    def _build(self):
        krylov_small.build()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        self._warm_up(side)
        side.synchronize()
        mem0 = torch.cuda.memory_reserved(self.device)
        self.pool, self.pool_device = torch.cuda.graph_pool_handle(), \
            side.device
        self.runs = torch.zeros(len(self.segs), dtype=torch.int64,
                                device=self.device)
        self.settled = [0] * len(self.segs)
        for i, seg in enumerate(self.segs):
            if seg in self.direct:
                continue
            before = launch_counts.snapshot()
            self.captured[seg] = self._capture(seg, side, self.pool)
            self._count(seg, i, before)
        for seg, (i, _) in self.counted.items():
            self.increments[i] = self._capture(
                lambda i=i: self.runs[i: i + 1].add_(1), side, self.pool)
        self.captures = len(self.captured)
        self.root = krylov_small.Graph.new()
        self._emit(self.root, self.prog, side)
        if self.counted:
            _pending.add(self)
        side.synchronize()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - mem0
        cur.wait_stream(side)
        self.nodes = self.root.nodes
        self.exec = self.root.instantiate()

    def _count(self, seg, i, before):
        """Take back the launches counted since ``before`` (a capture of
        segment ``seg``, index ``i``): the graph counts them per run."""
        d = launch_counts.delta(before, launch_counts.snapshot())
        launch_counts.add(d, -1)
        if not launch_counts.empty(d):
            self.counted[seg] = (i, d)

    def _emit(self, g, prog, stream=None, nested=False):
        for step in prog:
            if isinstance(step, (While, If)):
                with g.conditional(step.flag, isinstance(step, While)) as b:
                    self._emit(b, step.body, stream, True)
            elif isinstance(step, Copy):
                g.copy(step.dst, step.src)
            elif step in self.direct:
                if stream is None:
                    raise RuntimeError("a device loop whose segments run "
                                       "device loops themselves is not added "
                                       "to another capture")
                self._capture_into(g, step, stream)
            else:
                raw = self.captured[step].raw_cuda_graph()
                if nested and step not in self.stripped:
                    self.events += krylov_small.strip_events(raw)
                    self.stripped.add(step)
                g.child(raw)
                if step in self.counted:
                    i = self.counted[step][0]
                    g.child(self.increments[i].raw_cuda_graph())

    def _capture_into(self, g, seg, stream):
        """Capture ``seg`` and its run count straight into graph ``g``;
        the device loops it runs add their nodes there."""
        i = self.segs.index(seg)
        before = launch_counts.snapshot()
        nested = _tally["nested_nodes"]

        def run():
            seg()
            self.runs[i: i + 1].add_(1)

        self.holds += 1
        with keeping_added() as kept:
            g.capture(run, stream, self.pool)
        self.embedded += tuple(kept)
        self._count(seg, i, before)
        g.nodes += _tally["nested_nodes"] - nested

    def launch(self):
        """Run the graph on the current stream."""
        if self.exec is None:
            self.build()
        _tally["launches"] += 1
        self.exec.launch(self.device)

    def add_to_capture(self):
        """Add the graph's nodes to the graph the current stream is
        capturing (the graph is built first, outside any capture)."""
        if self.exec is None:
            self.build()
        stream = torch.cuda.current_stream(self.device)
        g = krylov_small.Graph.capturing(stream)
        self._emit(g, self.prog)
        g.continue_capture(stream)
        _tally["nested_nodes"] += g.nodes - g.top
        if _keepers:
            _keepers[-1].append(self)

    def settle(self):
        """Add this graph's kernel launches since its last settle to the
        counters (one host read)."""
        if not self.counted:
            return
        runs = self.runs.tolist()
        for seg, (i, d) in self.counted.items():
            if runs[i] != self.settled[i]:
                launch_counts.add(d, runs[i] - self.settled[i])
                self.settled[i] = runs[i]

    def close(self):
        if self.exec is not None:
            self.exec.close()
        if self.root is not None:
            self.root.close()
        self.exec = self.root = None
        for _ in range(self.holds):
            krylov_small.release_pool(self.pool_device, self.pool)
        self.holds = 0

    def __del__(self):
        try:
            self.close()
        except Exception:       # noqa: BLE001  (interpreter shutdown)
            pass


class StepGraph:
    """One step of a host loop on static buffers ``args``: on the card a
    CUDA graph, captured at the first :meth:`run` and replayed by every
    later one; on the CPU the same step, run eagerly on the same buffers.

    A step ``fn(*args)`` returns ``(*state, *results)``: the first
    ``n_state`` arguments are its state, which the new state replaces in
    place (no new state aliases another state buffer), and the results go
    to buffers of their own.  :meth:`run` copies its arguments into the
    buffers, except those already there (the buffer itself, the state the
    last run handed back, an argument given again: a right-hand side),
    runs the step and hands back copies of the new state and the results,
    so that a caller may keep the iterates of several steps.

    The capture runs two eager steps on copies of the buffers first, on a
    side stream: the first builds the kernels and makes their first-use
    tensors (B1's read plans, the KRYLOV coarsest graphs) and, in an NCCL
    group, the communicator of every collective and p2p message the step
    sends (torch makes it at first use, which a capture cannot hold); the
    second runs under ``torch.cuda.set_sync_debug_mode("error")``, so a
    step that reads the host raises (an NCCL ``Work.wait()`` makes the
    current stream wait for NCCL's and passes).  Inside the capture NCCL's
    kernels join the graph and its waits become edges.  Every rank of a
    group captures the same step at the same point of the same host loop
    (:class:`StepGraphs`).  The capture runs with the cyclic collector off
    (:func:`no_collector`) into ``pool`` (shared by a solver's graphs,
    which never run at once and keep nothing in it between steps); the
    kernel launches and ring counts it made are taken back and added again
    at every replay (``per_step``); the LoopGraphs whose nodes it added
    are kept alive (``embedded``).  There is no fallback: a failed capture
    raises.  After it: ``build_seconds`` (warm-ups, capture and
    instantiation), ``pool_bytes`` (device memory the capture took from
    the pool), ``nodes``; ``replays`` counts the replays.
    """

    def __init__(self, args, n_state: int, pool=None):
        self.args = tuple(args)
        self.n_state = n_state
        self.pool = pool
        self.results = None
        self.graph = None
        self.per_step = None        # kernel launches and ring counts
        self.embedded = ()
        self.build_seconds = 0.0
        self.pool_bytes = 0
        self.nested_nodes = 0
        self.replays = 0
        self._held = (None,) * len(self.args)

    @property
    def nodes(self) -> int:
        """The graph's nodes, those that LoopGraphs added below its top
        level included (``krylov_small.cu`` counts them)."""
        return (krylov_small.graph_nodes(self.graph.raw_cuda_graph())
                + self.nested_nodes)

    def _apply(self, fn, args, results):
        """One step on ``args`` in place; the results into ``results``
        (made here when None).  Returns the results' buffers."""
        outs = fn(*args) or ()
        n = self.n_state
        if results is None:
            results = tuple(torch.empty_like(o) for o in outs[n:])
        for t, o in zip(args[:n] + results, outs):
            t.copy_(o)
        return results

    @tracing.spanned("amg.step")
    def run(self, fn, *args):
        """One step of ``fn`` from ``args``: copies of the new state and of
        the results."""
        for buf, a, held in zip(self.args, args, self._held):
            if a is not buf and a is not held:
                buf.copy_(a)
        if self.args[0].is_cuda:
            if self.graph is None:
                with tracing.span("amg.capture") as sp:
                    self._capture(fn)
                self.build_seconds = sp.seconds
            self.graph.replay()
            self.replays += 1
            launch_counts.add(self.per_step, 1)
        else:
            self.results = self._apply(fn, self.args, self.results)
        n = self.n_state
        out = tuple(t.clone() for t in self.args[:n] + self.results)
        self._held = out[:n] + args[n:]
        return out

    def _capture(self, fn):
        dev = self.args[0].device
        with torch.cuda.device(dev), no_collector():
            scratch = tuple(t.clone() for t in self.args)
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                res = self._apply(fn, scratch, None)
                with host_syncs_raise():
                    self._apply(fn, scratch, res)
            cur.wait_stream(side)
            self.results = tuple(torch.empty_like(t) for t in res)
            del scratch, res
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            mem0 = torch.cuda.memory_reserved(dev)
            before = launch_counts.snapshot()
            nested = _tally["nested_nodes"]
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with keeping_added() as kept, \
                    torch.cuda.graph(graph, pool=self.pool):
                self._apply(fn, self.args, self.results)
            graph.instantiate()
            self.per_step = launch_counts.delta(before,
                                                launch_counts.snapshot())
            launch_counts.add(self.per_step, -1)
            self.nested_nodes = _tally["nested_nodes"] - nested
            self.embedded = tuple(kept)
            torch.cuda.synchronize()
            self.pool_bytes = torch.cuda.memory_reserved(dev) - mem0
        self.graph = graph


class StepGraphs:
    """A solver's step graphs, one per step name, in one memory pool.

    The route is fixed when the solver is made, from the device and the
    ``backend`` of the process group the steps' collectives go through
    (None: no group, every shard in this process): ``"graph"`` (a
    :class:`StepGraph` replayed per step) on the card alone or in an NCCL
    group, whose collectives and p2p messages are captured; ``"static"``
    (the same static buffers, the step run eagerly on them) on the CPU,
    with no group or gloo; ``"eager"`` (the steps run as they are, on
    fresh tensors) for any other group on the card (gloo on CUDA tensors:
    its collectives cannot be captured).

    In a process group every rank runs the same host loop: it captures
    each step at the same step of the loop, and the loop's decisions
    (stop, residual replacement, the truth check) read ``psum``-reduced
    norms, the same numbers on every rank.  So every rank replays the
    same graphs in the same order, and the collectives and p2p messages
    captured in them meet their peers'; eager collectives between steps
    (the norm of b, the gather of x) come in the same order on every rank
    as well.
    """

    def __init__(self, device, backend: str | None = None):
        self.device = torch.device(device)
        self.backend = backend
        self.route = ("static" if self.device.type != "cuda" else
                      "graph" if backend in (None, "nccl") else "eager")
        self.graphs: dict = {}
        self.keys: dict = {}
        self.builds = 0
        self.pool = None

    def describe(self) -> str:
        group = "" if self.backend is None else f" in a {self.backend} group"
        return {"graph": f"one CUDA graph per step{group}, replayed",
                "static": "static buffers, run eagerly",
                "eager": f"eager (a {self.backend} group on the card: its "
                         f"collectives are not captured)"}[self.route]

    def memory_pool(self):
        """The pool of the solver's graphs (made at first use; None on the
        CPU)."""
        if self.pool is None and self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    def get(self, name, args, n_state: int, key=()) -> StepGraph:
        """The step graph ``name`` for ``args`` (made anew when ``key`` or
        the arguments' shapes, dtypes or devices change)."""
        key = (key, tuple((a.shape, a.dtype, a.device) for a in args))
        if self.keys.get(name) != key:
            self.graphs[name] = StepGraph(
                [torch.empty_like(a) for a in args], n_state,
                self.memory_pool())
            self.keys[name] = key
            self.builds += 1
        return self.graphs[name]

    def step(self, name, fn, n_state: int, key=(), eager=False):
        """``fn`` as step ``name`` on this route (``eager``: this call's
        steps run as they are): a callable taking ``fn``'s arguments and
        returning ``(*state, *results)``.  The step graph is made when the
        step first runs."""
        if eager or self.route == "eager":
            return fn
        return lambda *a: self.get(name, a, n_state, key).run(fn, *a)
