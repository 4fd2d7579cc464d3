"""ctypes bindings for the native C++ setup kernels.

The C++ source ``amg_native.cpp`` beside this file is the port's own copy
of ``amg_tpu``'s setup kernels (tests/test_torch_host.py holds the two
files byte-identical and the host hierarchies they build bit-identical).
The shared library is built on demand with the same g++ flags as
``amg_tpu.native`` into ``amg_tpu_torch/build/``.  ``lib`` is None when no
compiler is available; all callers fall back to pure-Python
implementations.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "amg_native.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "build")
_SO = os.path.join(_BUILD, "libamg_native.so")

_lock = threading.Lock()


def _build() -> str | None:
    if not os.path.exists(_SRC):
        return None
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    with _lock:
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
            return _SO
        os.makedirs(_BUILD, exist_ok=True)
        # per-process temporary: concurrent test workers may build at once
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-fopenmp", _SRC, "-o", tmp,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO)
            return _SO
        except Exception:
            # retry without OpenMP (toolchains missing libgomp)
            try:
                subprocess.run([c for c in cmd if c != "-fopenmp"],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, _SO)
                return _SO
            except Exception:
                return None


class _NativeLib:
    def __init__(self, dll: ctypes.CDLL):
        self._dll = dll
        i64 = ctypes.c_int64
        i32 = ctypes.c_int32
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

        dll.spgemm_count.restype = i64
        dll.spgemm_count.argtypes = [i64, i64, p_i64, p_i32, p_i64, p_i32, p_i64]
        dll.spgemm_fill.restype = i32
        dll.spgemm_fill.argtypes = [
            i64, i64, p_i64, p_i32, p_f64, p_i64, p_i32, p_f64,
            p_i64, p_i32, p_f64,
        ]
        dll.csr_transpose_pat.restype = i32
        dll.csr_transpose_pat.argtypes = [i64, i64, p_i64, p_i32, p_i64, p_i32]
        dll.rs_split.restype = i64
        dll.rs_split.argtypes = [i64, p_i64, p_i32, p_i64, p_i32, p_i64]
        dll.clean_ff.restype = i64
        dll.clean_ff.argtypes = [i64, p_i64, p_i32, p_i64, i64]
        dll.std_interp_values.restype = i32
        dll.std_interp_values.argtypes = [
            i64, p_i64, p_i32, p_f64, p_i64, p_i32, p_i64, p_i32, p_i64, p_f64,
        ]
        dll.greedy_color.restype = i64
        dll.greedy_color.argtypes = [i64, p_i64, p_i32, p_i64]
        dll.dir_interp_values.restype = i32
        dll.dir_interp_values.argtypes = [
            i64, p_i64, p_i32, p_f64, p_i64, p_i32, p_i64, p_f64,
        ]
        dll.csr_transpose.restype = i32
        dll.csr_transpose.argtypes = [
            i64, i64, p_i64, p_i32, p_f64, p_i64, p_i32, p_f64,
        ]
        f64 = ctypes.c_double
        dll.strength_count.restype = None
        dll.strength_count.argtypes = [i64, p_i64, p_i32, p_f64, f64, f64,
                                       p_i64]
        dll.strength_fill.restype = None
        dll.strength_fill.argtypes = [i64, p_i64, p_i32, p_f64, f64, f64,
                                      p_i64, p_i32]
        dll.p_pattern_dir_count.restype = None
        dll.p_pattern_dir_count.argtypes = [i64, p_i64, p_i32, p_i64, p_i64]
        dll.p_pattern_dir_fill.restype = None
        dll.p_pattern_dir_fill.argtypes = [i64, p_i64, p_i32, p_i64, p_i64,
                                           p_i32]
        dll.trunc_count.restype = None
        dll.trunc_count.argtypes = [i64, p_i64, p_i32, p_f64, f64, p_i64]
        dll.trunc_fill.restype = None
        dll.trunc_fill.argtypes = [i64, p_i64, p_i32, p_f64, f64, p_i64,
                                   p_i32, p_f64]
        dll.sa_aggregate.restype = i64
        dll.sa_aggregate.argtypes = [i64, p_i64, p_i32, p_i64]
        dll.p_pattern_std_count.restype = None
        dll.p_pattern_std_count.argtypes = [i64, p_i64, p_i32, p_i64, p_i64]
        dll.p_pattern_std_fill.restype = None
        dll.p_pattern_std_fill.argtypes = [i64, p_i64, p_i32, p_i64, p_i64,
                                           p_i32]
        dll.well_pack_count.restype = i64
        dll.well_pack_count.argtypes = [i64, p_i64, p_i32, i64, i64, p_i64]
        dll.well_pack_fill.restype = i32
        dll.well_pack_fill.argtypes = [
            i64, p_i64, p_i32, p_f64, i64, i64, i64, p_i32, p_i32, p_f64,
        ]

    # -- wrappers ------------------------------------------------------

    def spgemm(self, a, b):
        from ..sparse import CSR

        m, n = a.n_rows, b.n_cols
        ap = np.ascontiguousarray(a.indptr, dtype=np.int64)
        aj = np.ascontiguousarray(a.indices, dtype=np.int32)
        av = np.ascontiguousarray(a.data, dtype=np.float64)
        bp = np.ascontiguousarray(b.indptr, dtype=np.int64)
        bj = np.ascontiguousarray(b.indices, dtype=np.int32)
        bv = np.ascontiguousarray(b.data, dtype=np.float64)
        cp = np.zeros(m + 1, dtype=np.int64)
        nnz = self._dll.spgemm_count(m, n, ap, aj, bp, bj, cp)
        cj = np.zeros(nnz, dtype=np.int32)
        cv = np.zeros(nnz, dtype=np.float64)
        self._dll.spgemm_fill(m, n, ap, aj, av, bp, bj, bv, cp, cj, cv)
        return CSR(cp, cj, cv, (m, n))

    def rs_split(self, s):
        n = s.n_rows
        sp = np.ascontiguousarray(s.indptr, dtype=np.int64)
        sj = np.ascontiguousarray(s.indices, dtype=np.int32)
        # S is a pure pattern: transpose structure only (skips the value
        # scatter, the biggest per-level array after A itself)
        tp = np.zeros(n + 1, dtype=np.int64)
        tj = np.zeros(s.nnz, dtype=np.int32)
        self._dll.csr_transpose_pat(n, n, sp, sj, tp, tj)
        vec = np.zeros(n, dtype=np.int64)
        col = self._dll.rs_split(n, sp, sj, tp, tj, vec)
        return vec, int(col)

    def clean_ff(self, s, vec, col):
        sp = np.ascontiguousarray(s.indptr, dtype=np.int64)
        sj = np.ascontiguousarray(s.indices, dtype=np.int32)
        assert vec.dtype == np.int64
        return int(self._dll.clean_ff(s.n_rows, sp, sj, vec, col))

    def std_interp_values(self, a, vec, p, s):
        ap = np.ascontiguousarray(a.indptr, dtype=np.int64)
        aj = np.ascontiguousarray(a.indices, dtype=np.int32)
        av = np.ascontiguousarray(a.data, dtype=np.float64)
        sp = np.ascontiguousarray(s.indptr, dtype=np.int64)
        sj = np.ascontiguousarray(s.indices, dtype=np.int32)
        pp = np.ascontiguousarray(p.indptr, dtype=np.int64)
        pj = np.ascontiguousarray(p.indices, dtype=np.int32)
        v = np.ascontiguousarray(vec, dtype=np.int64)
        self._dll.std_interp_values(
            a.n_rows, ap, aj, av, sp, sj, pp, pj, v, p.data
        )

    def dir_interp_values(self, a, vec, p):
        ap = np.ascontiguousarray(a.indptr, dtype=np.int64)
        aj = np.ascontiguousarray(a.indices, dtype=np.int32)
        av = np.ascontiguousarray(a.data, dtype=np.float64)
        pp = np.ascontiguousarray(p.indptr, dtype=np.int64)
        pj = np.ascontiguousarray(p.indices, dtype=np.int32)
        v = np.ascontiguousarray(vec, dtype=np.int64)
        self._dll.dir_interp_values(a.n_rows, ap, aj, av, pp, pj, v, p.data)

    def csr_transpose(self, a):
        from ..sparse import CSR

        m, n = a.n_rows, a.n_cols
        ap = np.ascontiguousarray(a.indptr, dtype=np.int64)
        aj = np.ascontiguousarray(a.indices, dtype=np.int32)
        av = np.ascontiguousarray(a.data, dtype=np.float64)
        tp = np.zeros(n + 1, dtype=np.int64)
        tj = np.zeros(a.nnz, dtype=np.int32)
        tv = np.zeros(a.nnz, dtype=np.float64)
        self._dll.csr_transpose(m, n, ap, aj, av, tp, tj, tv)
        return CSR(tp, tj, tv, (n, m))

    def strength(self, a, theta, max_row_sum):
        """Strength-of-connection pattern CSR (data = ones)."""
        from ..sparse import CSR

        n = a.n_rows
        ap = np.ascontiguousarray(a.indptr, dtype=np.int64)
        aj = np.ascontiguousarray(a.indices, dtype=np.int32)
        av = np.ascontiguousarray(a.data, dtype=np.float64)
        sp = np.zeros(n + 1, dtype=np.int64)
        self._dll.strength_count(n, ap, aj, av, theta, max_row_sum, sp)
        np.cumsum(sp, out=sp)
        sj = np.zeros(sp[n], dtype=np.int32)
        self._dll.strength_fill(n, ap, aj, av, theta, max_row_sum, sp, sj)
        # S is consumed as a pattern only (split / clean_ff / P patterns);
        # a broadcast stride-0 "ones" avoids materializing nnz float64s
        ones = np.broadcast_to(np.float64(1.0), int(sp[n]))
        return CSR(sp, sj, ones, (n, n))

    def p_pattern_dir(self, s, vec, n_coarse):
        """Direct-interpolation pattern CSR (data = zeros)."""
        from ..sparse import CSR

        n = s.n_rows
        sp = np.ascontiguousarray(s.indptr, dtype=np.int64)
        sj = np.ascontiguousarray(s.indices, dtype=np.int32)
        v = np.ascontiguousarray(vec, dtype=np.int64)
        pp = np.zeros(n + 1, dtype=np.int64)
        self._dll.p_pattern_dir_count(n, sp, sj, v, pp)
        np.cumsum(pp, out=pp)
        pj = np.zeros(pp[n], dtype=np.int32)
        self._dll.p_pattern_dir_fill(n, sp, sj, v, pp, pj)
        return CSR(pp, pj, np.zeros(len(pj), dtype=np.float64),
                   (n, n_coarse))

    def truncate(self, p, eps):
        """Interpolation truncation with pos/neg row-sum rescaling."""
        from ..sparse import CSR

        n = p.n_rows
        pp = np.ascontiguousarray(p.indptr, dtype=np.int64)
        pj = np.ascontiguousarray(p.indices, dtype=np.int32)
        pv = np.ascontiguousarray(p.data, dtype=np.float64)
        qp = np.zeros(n + 1, dtype=np.int64)
        self._dll.trunc_count(n, pp, pj, pv, eps, qp)
        np.cumsum(qp, out=qp)
        qj = np.zeros(qp[n], dtype=np.int32)
        qv = np.zeros(qp[n], dtype=np.float64)
        self._dll.trunc_fill(n, pp, pj, pv, eps, qp, qj, qv)
        return CSR(qp, qj, qv, p.shape)

    def sa_aggregate(self, s):
        """Three-phase greedy aggregation over the strength graph.

        Returns ``(agg, n_agg)`` — exact semantics of
        setup_phase.aggregation.aggregate's Python loops.
        """
        n = s.n_rows
        sp = np.ascontiguousarray(s.indptr, dtype=np.int64)
        sj = np.ascontiguousarray(s.indices, dtype=np.int32)
        agg = np.zeros(n, dtype=np.int64)
        n_agg = int(self._dll.sa_aggregate(n, sp, sj, agg))
        return agg, n_agg

    def p_pattern_std(self, s, vec, n_coarse):
        """Standard (distance-2) interpolation pattern CSR (data = zeros);
        first-visit column order, matching the Python reference loop."""
        from ..sparse import CSR

        n = s.n_rows
        sp = np.ascontiguousarray(s.indptr, dtype=np.int64)
        sj = np.ascontiguousarray(s.indices, dtype=np.int32)
        v = np.ascontiguousarray(vec, dtype=np.int64)
        pp = np.zeros(n + 1, dtype=np.int64)
        self._dll.p_pattern_std_count(n, sp, sj, v, pp)
        np.cumsum(pp, out=pp)
        pj = np.zeros(pp[n], dtype=np.int32)
        self._dll.p_pattern_std_fill(n, sp, sj, v, pp, pj)
        return CSR(pp, pj, np.zeros(len(pj), dtype=np.float64),
                   (n, n_coarse))

    def well_pack(self, a, ngroups, pad_cols):
        """WEll slot packing (greedy first-fit; see sparse.py::WEll).

        Returns ``(base (ngroups, S) i32, loc (ngroups, S, 8, 128) i32,
        vals (ngroups, S, 8, 128) f64)``.
        """
        n = a.n_rows
        ap = np.ascontiguousarray(a.indptr, dtype=np.int64)
        aj = np.ascontiguousarray(a.indices, dtype=np.int32)
        av = np.ascontiguousarray(a.data, dtype=np.float64)
        spg = np.zeros(ngroups, dtype=np.int64)
        S = int(self._dll.well_pack_count(n, ap, aj, ngroups, pad_cols, spg))
        base = np.zeros((ngroups, S), dtype=np.int32)
        loc = np.zeros((ngroups, S, 8, 128), dtype=np.int32)
        vals = np.zeros((ngroups, S, 8, 128), dtype=np.float64)
        self._dll.well_pack_fill(n, ap, aj, av, ngroups, pad_cols, S,
                                 base.reshape(-1), loc.reshape(-1),
                                 vals.reshape(-1))
        return base, loc, vals

    def greedy_color(self, a):
        """Greedy sequential coloring of A's symmetrized pattern.

        Returns ``(colors int64[n], n_colors)``.
        """
        ap = np.ascontiguousarray(a.indptr, dtype=np.int64)
        aj = np.ascontiguousarray(a.indices, dtype=np.int32)
        colors = np.zeros(a.n_rows, dtype=np.int64)
        nc = self._dll.greedy_color(a.n_rows, ap, aj, colors)
        return colors, int(nc)


def _load() -> _NativeLib | None:
    if os.environ.get("AMG_TPU_NO_NATIVE"):
        return None
    so = _build()
    if so is None:
        return None
    try:
        return _NativeLib(ctypes.CDLL(so))
    except OSError:
        return None


lib = _load()
