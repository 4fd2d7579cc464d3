"""The scalar steps of restarted GMRES as hand-written CUDA kernels, their
plain PyTorch versions, and the assembly of the CUDA graphs that run the
Krylov layer's loops on the card.

No TPU kernel: ``amg_tpu`` runs this work as ``lax.fori_loop`` scalar code
inside its GMRES ``lax.while_loop`` (``amg_tpu/solve/krylov.py``), which
XLA keeps on the device.  Two entries, in the vectors' dtype (f32 or
f64), in ``amg_tpu``'s order, each one warp on the card::

    givens(hcol, hnorm, j, hraw, H, cs, sn, g, done, k_eff, go, normr0, tol)
        the scalar tail of Arnoldi step ``j`` (a 0-d int32 on the device;
        amg_tpu/solve/krylov.py:336-362), IN PLACE: store the raw
        Hessenberg column, ``hcol`` (m + 1; the step's Gram-Schmidt
        coefficients) with ``hnorm`` at j + 1, as ``hraw[j]``; rotate it by
        the rotations ``cs[:j]``, ``sn[:j]``, make rotation j and rotate
        ``g``; store rotation j, the rotated column as ``H[:, j]``,
        ``g[j]``, ``g[j + 1]`` and ``k_eff = j + 1`` unless ``done`` was
        set, then set ``done`` where the residual estimate ``|g[j+1]| /
        normr0`` passed ``tol`` or the step broke down (``hnorm <=
        SMALLFLOAT``); advance ``j`` and set ``go = j < m and not done``
    backsub(H, g, k_eff) -> y
        the masked back-substitution (:371-379): ``y[jj]`` for jj = m-1 ..
        0 on the ``k_eff x k_eff`` triangle, 0 for jj >= k_eff

``H`` is ``(m + 1, m)``, ``hraw`` ``(m, m + 1)``, ``cs``, ``sn`` ``(m,)``,
``g`` ``(m + 1,)``, ``done`` and ``go`` 0-d bools, ``j`` and ``k_eff`` 0-d
int32 and ``hnorm``, ``normr0`` 0-d tensors of the dtype.  Each multiply,
add, divide and square root of a kernel rounds once, as one elementwise
torch operation does, so the kernels and the plain versions agree bit for
bit.  The plain versions read nothing on the host: ``givens_plain``
selects with ``j`` as a tensor, as ``amg_tpu``'s masked loop does.

Dispatch is by the tensors' device: CUDA tensors launch the kernels in
``amg_tpu_torch/csrc/krylov_small.cu`` (built with ``nvcc`` on first use
into ``amg_tpu_torch/build/``, bound with ctypes) or raise; CPU tensors
take the plain versions (``*_plain``), which ``chip_smoke.py`` also holds
the kernels against.  ``launches`` counts kernel launches per entry and
``launches_by_shape`` per (entry, dtype, m); a launch captured into a
graph is counted once per run of the graph (``solve.loop_graph``).
:func:`launch_floor` launches an empty kernel the way the two are
launched (one warp), the latency floor ``chip_smoke.py`` times them
against.

:class:`Graph` builds CUDA graphs node by node from the same library:
child graphs (captured loop bodies), work captured straight into the
graph (:meth:`Graph.capture`), device-to-device copies, and while and if
nodes whose condition is a device flag (a bool tensor), set by a
one-thread kernel before the node and at the end of a while node's body.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..params import SMALLFLOAT
from .cuda_build import CudaLibrary

ENTRIES = ("givens", "backsub")
# kernel launches per entry (plain-version calls are not counted), and per
# (entry, dtype, m) launch shape
launches = {e: 0 for e in ENTRIES}
launches_by_shape: dict = {}

# the longest restart m the kernels take (kMaxM in krylov_small.cu)
MAX_M = 64
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}


def _bind(dll):
    p, i32 = ctypes.c_void_p, ctypes.c_int
    for suffix, real in (("_f32", ctypes.c_float), ("_f64", ctypes.c_double)):
        fn = getattr(dll, "ks_givens" + suffix)
        fn.argtypes = [p, p, p, i32, p, p, p, p, p, p, p, p, p, real, real,
                       p]
        fn.restype = i32
        fn = getattr(dll, "ks_backsub" + suffix)
        fn.argtypes = [p, p, p, i32, p, real, p]
        fn.restype = i32
    pp, u64, size = ctypes.POINTER(p), ctypes.c_ulonglong, ctypes.c_size_t
    for name, args in (
            ("ks_graph_create", [pp]), ("ks_graph_destroy", [p]),
            ("ks_graph_nodes", [p, ctypes.POINTER(size)]),
            ("ks_handle", [p, ctypes.POINTER(u64)]),
            ("ks_add_child", [p, p, p, pp]),
            ("ks_add_set_flag", [p, p, u64, p, pp]),
            ("ks_add_cond", [p, p, u64, i32, pp, pp]),
            ("ks_add_copy", [p, p, p, p, size, pp]),
            ("ks_instantiate", [p, pp]), ("ks_launch", [p, p]),
            ("ks_exec_destroy", [p]), ("ks_capture_tail", [p, pp, pp]),
            ("ks_capture_continue", [p, p]), ("ks_capture_begin", [p, p, p]),
            ("ks_capture_end", [p, pp]), ("ks_empty", [p]),
            ("ks_graph_kinds", [p, ctypes.POINTER(size), i32]),
            ("ks_graph_strip_events", [p, ctypes.POINTER(size)])):
        fn = getattr(dll, name)
        fn.argtypes = args
        fn.restype = i32


_LIB = CudaLibrary("krylov_small.cu", _bind)


def build() -> str:
    """Compile ``csrc/krylov_small.cu`` into ``build/libkrylov_small.so``
    unless the library is newer than the source.  Returns its path."""
    return _LIB.build()


def _call(name, *args):
    err = getattr(_LIB.load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def _count(entry, dtype, m):
    launches[entry] += 1
    key = (entry, dtype, m)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _check(H, g, k_eff, vectors=()):
    if H.dim() != 2 or H.shape[0] != H.shape[1] + 1:
        raise ValueError(f"H must be (m + 1, m); got {tuple(H.shape)}")
    m = H.shape[1]
    if H.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {H.dtype}; supported: float32, "
                        f"float64")
    if m > MAX_M:
        raise ValueError(f"restart {m} exceeds the kernels' {MAX_M}")
    for name, t, shape in (("g", g, (m + 1,)), *vectors):
        if t.shape != shape or t.dtype != H.dtype:
            raise ValueError(f"{name} must be {shape} {H.dtype}; got "
                             f"{tuple(t.shape)} {t.dtype}")
    if k_eff.shape != () or k_eff.dtype != torch.int32:
        raise ValueError("k_eff must be a 0-d int32 tensor")
    for name, t in (("H", H), ("g", g), ("k_eff", k_eff)) + tuple(
            (n, t) for n, t, _ in vectors):
        if t.device != H.device:
            raise ValueError(f"{name} is on {t.device}, H on {H.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return m


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU tensors; the reference on the card)
# ---------------------------------------------------------------------------


def givens_plain(hcol, hnorm, j, hraw, H, cs, sn, g, done, k_eff, go,
                 normr0, tol):
    """:func:`givens` in torch operations, one per rounding step, with
    ``j`` read on the device: rotation i applies where ``i < j``."""
    m = H.shape[1]
    jl = j.reshape(1).long()
    rows = torch.arange(m + 1, device=H.device)
    col = torch.where(rows == jl + 1, hnorm, hcol)
    hraw.index_copy_(0, jl, col[None])
    h = list(col.unbind())
    for i in range(m):
        a, b = h[i], h[i + 1]
        turn = j > i
        h[i] = torch.where(turn, cs[i] * a + sn[i] * b, a)
        h[i + 1] = torch.where(turn, -sn[i] * a + cs[i] * b, b)
    h = torch.stack(h)
    hj = h.index_select(0, jl)[0]
    denom = torch.sqrt(hj * hj + hnorm * hnorm)
    big = denom > SMALLFLOAT
    dm = torch.where(big, denom, SMALLFLOAT)
    c = torch.where(big, hj / dm, 1.0)
    s = torch.where(big, hnorm / dm, 0.0)
    col = torch.where(rows == jl, c * hj + s * hnorm,
                      torch.where(rows < jl, h, 0.0))
    gj = g.index_select(0, jl)[0]
    gj1 = -s * gj
    for t, dim, at, new in ((cs, 0, jl, c), (sn, 0, jl, s),
                            (H, 1, jl, col[:, None]), (g, 0, jl, c * gj),
                            (g, 0, jl + 1, gj1)):
        t.index_copy_(dim, at, torch.where(done, t.index_select(dim, at),
                                           new))
    k_eff.copy_(torch.where(done, k_eff, j + 1))
    done.copy_(done | (torch.abs(gj1) / normr0 < tol) | (hnorm <= SMALLFLOAT))
    j.add_(1)
    go.copy_((j < m) & ~done)


def backsub_plain(H, g, k_eff):
    """:func:`backsub` in torch operations, one per rounding step."""
    m = H.shape[1]
    y = [None] * m
    for jj in range(m - 1, -1, -1):
        acc = torch.zeros((), dtype=H.dtype, device=H.device)
        for c in range(jj + 1, m):
            acc = acc + H[jj, c] * y[c]
        s = g[jj] - acc
        hjj = H[jj, jj]
        val = torch.where(torch.abs(hjj) > SMALLFLOAT, s / hjj, 0.0)
        y[jj] = torch.where(k_eff > jj, val, 0.0)
    return torch.stack(y)


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------


def givens(hcol, hnorm, j, hraw, H, cs, sn, g, done, k_eff, go, normr0,
           tol: float):
    """The scalar tail of Arnoldi step ``j``, in place (kernel on CUDA
    tensors, plain version on CPU tensors)."""
    m = _check(H, g, k_eff, (("hcol", hcol, (H.shape[1] + 1,)),
                             ("hnorm", hnorm, ()),
                             ("hraw", hraw, (H.shape[1], H.shape[1] + 1)),
                             ("cs", cs, (H.shape[1],)),
                             ("sn", sn, (H.shape[1],)),
                             ("normr0", normr0, ())))
    for name, t, dtype in (("j", j, torch.int32), ("done", done, torch.bool),
                           ("go", go, torch.bool)):
        if t.shape != () or t.dtype != dtype or t.device != H.device:
            raise ValueError(f"{name} must be a 0-d {dtype} tensor on H's "
                             f"device")
    if not H.is_cuda:
        return givens_plain(hcol, hnorm, j, hraw, H, cs, sn, g, done, k_eff,
                            go, normr0, tol)
    stream = torch.cuda.current_stream(H.device).cuda_stream
    _call("ks_givens" + _SUFFIX[H.dtype], hcol.data_ptr(), hnorm.data_ptr(),
          j.data_ptr(), m, hraw.data_ptr(), H.data_ptr(), cs.data_ptr(),
          sn.data_ptr(), g.data_ptr(), done.data_ptr(), k_eff.data_ptr(),
          go.data_ptr(), normr0.data_ptr(), tol, SMALLFLOAT, stream)
    _count("givens", H.dtype, m)


def backsub(H, g, k_eff) -> torch.Tensor:
    """The masked back-substitution: ``y`` (m,) (kernel on CUDA tensors,
    plain version on CPU tensors)."""
    m = _check(H, g, k_eff)
    if not H.is_cuda:
        return backsub_plain(H, g, k_eff)
    y = torch.empty(m, dtype=H.dtype, device=H.device)
    stream = torch.cuda.current_stream(H.device).cuda_stream
    _call("ks_backsub" + _SUFFIX[H.dtype], H.data_ptr(), g.data_ptr(),
          k_eff.data_ptr(), m, y.data_ptr(), SMALLFLOAT, stream)
    _count("backsub", H.dtype, m)
    return y


def launch_floor(device):
    """Launch an empty kernel as :func:`givens` and :func:`backsub` are
    launched (one warp, on the current stream): the latency floor they are
    timed against.  Not counted."""
    _call("ks_empty", torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# CUDA graphs with conditional nodes
# ---------------------------------------------------------------------------


def graph_nodes(raw: int) -> int:
    """The number of nodes at the top level of graph ``raw``."""
    n = ctypes.c_size_t()
    _call("ks_graph_nodes", ctypes.c_void_p(raw), ctypes.byref(n))
    return n.value


# cudaGraphNodeType's values (driver_types.h)
NODE_KINDS = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "event_wait", "event_record", "semaphore_signal",
              "semaphore_wait", "mem_alloc", "mem_free", "batch_memop",
              "conditional")


def graph_kinds(raw: int) -> dict:
    """The nodes of graph ``raw`` by kind (``NODE_KINDS``), those of child
    graphs included; kinds with no node are left out."""
    counts = (ctypes.c_size_t * len(NODE_KINDS))()
    _call("ks_graph_kinds", ctypes.c_void_p(raw), counts, len(NODE_KINDS))
    return {k: n for k, n in zip(NODE_KINDS, counts) if n}


def strip_events(raw: int) -> int:
    """Remove the event record and wait nodes of graph ``raw`` (child
    graphs' included), passing each one's dependencies on to its
    dependents: how many were removed.  NCCL adds them to a graph that
    captures one of its calls, to order it against NCCL calls outside
    the graph; a conditional node's body may hold none (``LoopGraph``)."""
    n = ctypes.c_size_t()
    _call("ks_graph_strip_events", ctypes.c_void_p(raw), ctypes.byref(n))
    return n.value


class Graph:
    """A CUDA graph (``raw``, a ``cudaGraph_t``) built node by node, each
    node after the one added before it (``tail``).

    ``nodes`` counts the nodes added, those of child graphs and of
    conditional bodies included; ``top`` those added at this graph's own
    level.  The nodes read and write tensors by address: the caller keeps
    them alive while the graph runs.
    """

    def __init__(self, raw: int, tail=None, owned: bool = False):
        self.raw = raw
        self.tail = tail
        self.owned = owned
        self.nodes = self.top = 0

    @classmethod
    def new(cls) -> "Graph":
        raw = ctypes.c_void_p()
        _call("ks_graph_create", ctypes.byref(raw))
        return cls(raw.value, owned=True)

    @classmethod
    def capturing(cls, stream: torch.cuda.Stream) -> "Graph":
        """The graph ``stream`` is capturing, after the work captured so
        far; :meth:`continue_capture` lets the capture go on after the
        nodes added."""
        raw, tail = ctypes.c_void_p(), ctypes.c_void_p()
        _call("ks_capture_tail", ctypes.c_void_p(stream.cuda_stream),
              ctypes.byref(raw), ctypes.byref(tail))
        return cls(raw.value, tail.value)

    def continue_capture(self, stream: torch.cuda.Stream):
        if self.tail is not None:
            _call("ks_capture_continue", ctypes.c_void_p(stream.cuda_stream),
                  ctypes.c_void_p(self.tail))

    def _added(self, node, count=1):
        self.tail = node.value
        self.nodes += count
        self.top += 1

    def capture(self, fn, stream: torch.cuda.Stream, pool):
        """Capture the work ``fn`` gives ``stream`` straight into this
        graph after its tail (``cudaStreamBeginCaptureToGraph``), torch's
        allocations of this thread served from graph pool ``pool`` (a
        ``torch.cuda.graph_pool_handle()``).  Each call takes one hold on
        the pool, whether or not it succeeds: the caller gives it back
        (:func:`release_pool`) once the graph is gone.  Work captured
        here may add conditional nodes of its own (``Graph.capturing``),
        which a child graph may not hold."""
        dev = stream.device.index
        before = graph_nodes(self.raw)
        sp = ctypes.c_void_p(stream.cuda_stream)
        tail = ctypes.c_void_p()
        # torch's routing of one thread's allocations to a graph pool, as
        # torch.cuda.graph routes a capture's
        torch._C._cuda_beginAllocateCurrentThreadToPool(dev, pool)
        try:
            _call("ks_capture_begin", sp, ctypes.c_void_p(self.raw),
                  ctypes.c_void_p(self.tail))
            try:
                with torch.cuda.stream(stream):
                    fn()
            finally:
                err = _LIB.load().ks_capture_end(sp, ctypes.byref(tail))
        finally:
            torch._C._cuda_endAllocateToPool(dev, pool)
        if err != 0:
            raise RuntimeError(f"ks_capture_end failed: CUDA error {err}")
        self.tail = tail.value
        added = graph_nodes(self.raw) - before
        self.nodes += added
        self.top += added

    def child(self, raw: int):
        """A child graph node running a copy of graph ``raw``."""
        node = ctypes.c_void_p()
        _call("ks_add_child", ctypes.c_void_p(self.raw),
              ctypes.c_void_p(self.tail), ctypes.c_void_p(raw),
              ctypes.byref(node))
        self._added(node, graph_nodes(raw))

    def copy(self, dst: torch.Tensor, src: torch.Tensor):
        """A device-to-device copy of contiguous ``src`` into ``dst``."""
        if dst.shape != src.shape or dst.dtype != src.dtype or \
                not (dst.is_contiguous() and src.is_contiguous()):
            raise ValueError("copy needs two contiguous tensors of one "
                             "shape and dtype")
        node = ctypes.c_void_p()
        _call("ks_add_copy", ctypes.c_void_p(self.raw),
              ctypes.c_void_p(self.tail), ctypes.c_void_p(dst.data_ptr()),
              ctypes.c_void_p(src.data_ptr()),
              src.numel() * src.element_size(), ctypes.byref(node))
        self._added(node)

    def _set_flag(self, handle, flag):
        if flag.dtype != torch.bool or flag.numel() != 1 or not flag.is_cuda:
            raise ValueError("a condition must be one bool on the card")
        node = ctypes.c_void_p()
        _call("ks_add_set_flag", ctypes.c_void_p(self.raw),
              ctypes.c_void_p(self.tail), handle,
              ctypes.c_void_p(flag.data_ptr()), ctypes.byref(node))
        self._added(node)

    @contextlib.contextmanager
    def conditional(self, flag: torch.Tensor, loop: bool):
        """A while node (``loop``) or an if node on ``flag``; yields the
        body's :class:`Graph`.  A while node's body ends by setting the
        condition from ``flag`` again."""
        handle = ctypes.c_ulonglong()
        _call("ks_handle", ctypes.c_void_p(self.raw), ctypes.byref(handle))
        self._set_flag(handle, flag)
        node, body = ctypes.c_void_p(), ctypes.c_void_p()
        _call("ks_add_cond", ctypes.c_void_p(self.raw),
              ctypes.c_void_p(self.tail), handle, int(loop),
              ctypes.byref(node), ctypes.byref(body))
        inner = Graph(body.value)
        yield inner
        if loop:
            inner._set_flag(handle, flag)
        self._added(node, 1 + inner.nodes)

    def instantiate(self) -> "Exec":
        exec_ = ctypes.c_void_p()
        _call("ks_instantiate", ctypes.c_void_p(self.raw),
              ctypes.byref(exec_))
        return Exec(exec_.value)

    def close(self):
        if self.owned and self.raw:
            self.raw, raw = None, self.raw
            _call("ks_graph_destroy", ctypes.c_void_p(raw))


def release_pool(device: torch.device, pool):
    """Give back one hold on graph pool ``pool`` that
    :meth:`Graph.capture` took."""
    torch._C._cuda_releasePool(device.index, pool)


class Exec:
    """An instantiated graph, launched on the current stream."""

    def __init__(self, raw: int):
        self.raw = raw

    def launch(self, device):
        _call("ks_launch", ctypes.c_void_p(self.raw),
              ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))

    def close(self):
        if self.raw:
            self.raw, raw = None, self.raw
            _call("ks_exec_destroy", ctypes.c_void_p(raw))
