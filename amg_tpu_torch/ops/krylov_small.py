"""The scalar steps of restarted GMRES as hand-written CUDA kernels, their
plain PyTorch versions, and the assembly of the CUDA graphs that run the
Krylov layer's loops on the card.

No TPU kernel: ``amg_tpu`` runs this work as ``lax.fori_loop`` scalar code
inside its GMRES ``lax.while_loop`` (``amg_tpu/solve/krylov.py``), which
XLA keeps on the device.  Two entries, in the vectors' dtype (f32 or
f64), in ``amg_tpu``'s order, each one thread on the card::

    givens(hraw, j, H, cs, sn, g, done, k_eff, normr0, tol)
        step j of the Givens update (amg_tpu/solve/krylov.py:336-362), IN
        PLACE: rotate the raw Hessenberg column ``hraw`` (m + 1) by the
        rotations ``cs[:j]``, ``sn[:j]``, make rotation j and rotate ``g``;
        store rotation j, the rotated column as ``H[:, j]``, ``g[j]``,
        ``g[j + 1]`` and ``k_eff = j + 1`` unless ``done`` was set, then
        set ``done`` where the residual estimate ``|g[j+1]| / normr0``
        passed ``tol`` or the step broke down (``hraw[j+1] <= SMALLFLOAT``)
    backsub(H, g, k_eff) -> y
        the masked back-substitution (:371-379): ``y[jj]`` for jj = m-1 ..
        0 on the ``k_eff x k_eff`` triangle, 0 for jj >= k_eff

``H`` is ``(m + 1, m)``, ``cs``, ``sn`` ``(m,)``, ``g`` ``(m + 1,)``,
``done`` a 0-d bool, ``k_eff`` a 0-d int32 and ``normr0`` a 0-d tensor of
the dtype.  Each multiply, add, divide and square root of a kernel rounds
once, as one elementwise torch operation does, so the kernels and the
plain versions agree bit for bit.

Dispatch is by the tensors' device: CUDA tensors launch the kernels in
``amg_tpu_torch/csrc/krylov_small.cu`` (built with ``nvcc`` on first use
into ``amg_tpu_torch/build/``, bound with ctypes) or raise; CPU tensors
take the plain versions (``*_plain``), which ``chip_smoke.py`` also holds
the kernels against.  ``launches`` counts kernel launches per entry and
``launches_by_shape`` per (entry, dtype, m); a launch captured into a
graph is counted once per run of the graph (``solve.loop_graph``).

:class:`Graph` builds CUDA graphs node by node from the same library:
child graphs (captured loop bodies), device-to-device copies, and while
and if nodes whose condition is a device flag (a bool tensor), set by a
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
        fn.argtypes = [p, i32, i32, p, p, p, p, p, p, p, real, real, p]
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
            ("ks_capture_continue", [p, p])):
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


def givens_plain(hraw, j, H, cs, sn, g, done, k_eff, normr0, tol):
    """:func:`givens` in torch operations, one per rounding step."""
    h = list(hraw[: j + 2].unbind())
    hj1 = h[j + 1]
    for i in range(j):
        a, b = h[i], h[i + 1]
        h[i] = cs[i] * a + sn[i] * b
        h[i + 1] = -sn[i] * a + cs[i] * b
    denom = torch.sqrt(h[j] * h[j] + h[j + 1] * h[j + 1])
    big = denom > SMALLFLOAT
    dm = torch.where(big, denom, SMALLFLOAT)
    c = torch.where(big, h[j] / dm, 1.0)
    s = torch.where(big, h[j + 1] / dm, 0.0)
    h[j] = c * h[j] + s * h[j + 1]
    col = torch.zeros_like(H[:, j])
    col[: j + 1] = torch.stack(h[: j + 1])
    gj1 = -s * g[j]
    gj = c * g[j]
    for t, new in ((cs[j], c), (sn[j], s), (H[:, j], col), (g[j], gj),
                   (g[j + 1], gj1), (k_eff, j + 1)):
        t.copy_(torch.where(done, t, new))
    done.copy_(done | (torch.abs(gj1) / normr0 < tol) | (hj1 <= SMALLFLOAT))


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


def givens(hraw, j: int, H, cs, sn, g, done, k_eff, normr0, tol: float):
    """Step ``j`` of the Givens update, in place (kernel on CUDA tensors,
    plain version on CPU tensors)."""
    m = _check(H, g, k_eff, (("hraw", hraw, (H.shape[1] + 1,)),
                             ("cs", cs, (H.shape[1],)),
                             ("sn", sn, (H.shape[1],)),
                             ("normr0", normr0, ())))
    if not 0 <= j < m:
        raise ValueError(f"step {j} outside the restart of {m}")
    if done.shape != () or done.dtype != torch.bool or \
            done.device != H.device:
        raise ValueError("done must be a 0-d bool tensor on H's device")
    if not H.is_cuda:
        return givens_plain(hraw, j, H, cs, sn, g, done, k_eff, normr0, tol)
    stream = torch.cuda.current_stream(H.device).cuda_stream
    _call("ks_givens" + _SUFFIX[H.dtype], hraw.data_ptr(), j, m,
          H.data_ptr(), cs.data_ptr(), sn.data_ptr(), g.data_ptr(),
          done.data_ptr(), k_eff.data_ptr(), normr0.data_ptr(), tol,
          SMALLFLOAT, stream)
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


# ---------------------------------------------------------------------------
# CUDA graphs with conditional nodes
# ---------------------------------------------------------------------------


def graph_nodes(raw: int) -> int:
    """The number of nodes at the top level of graph ``raw``."""
    n = ctypes.c_size_t()
    _call("ks_graph_nodes", ctypes.c_void_p(raw), ctypes.byref(n))
    return n.value


class Graph:
    """A CUDA graph (``raw``, a ``cudaGraph_t``) built node by node, each
    node after the one added before it (``tail``).

    ``nodes`` counts the nodes added, those of child graphs and of
    conditional bodies included.  The nodes read and write tensors by
    address: the caller keeps them alive while the graph runs.
    """

    def __init__(self, raw: int, tail=None, owned: bool = False):
        self.raw = raw
        self.tail = tail
        self.owned = owned
        self.nodes = 0

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
