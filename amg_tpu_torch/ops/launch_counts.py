"""The kernel modules' launch counters, as a whole.

Each kernel wrapper counts a launch when it is called.  Called while a
CUDA graph is captured, it launches nothing: the code that captures takes
the capture's counts back (:func:`delta`, :func:`add` with ``times=-1``)
and adds them again for every run of the graph (``solve.driver.JitLoop``
per replay, ``solve.loop_graph.LoopGraph`` per run of a captured body).
"""

from __future__ import annotations

from . import dia_kernel, krylov_small, well_kernel

MODULES = (dia_kernel, well_kernel, krylov_small)


def snapshot() -> dict:
    """The counters (``launches``, ``launches_by_shape``) of every kernel
    module, copied."""
    return {K: (dict(K.launches), dict(K.launches_by_shape))
            for K in MODULES}


def delta(before: dict, after: dict) -> dict:
    """``after - before`` (as :func:`snapshot` gives them), the nonzero
    counts only."""
    return {K: tuple({k: n - b.get(k, 0) for k, n in a.items()
                      if n != b.get(k, 0)}
                     for a, b in zip(after[K], before[K]))
            for K in after}


def add(counts: dict, times: int):
    """Add ``times`` x ``counts`` to the modules' counters; keys that fall
    to 0 go."""
    for K, (entries, shapes) in counts.items():
        for e, n in entries.items():
            K.launches[e] += n * times
        for key, n in shapes.items():
            v = K.launches_by_shape.get(key, 0) + n * times
            if v:
                K.launches_by_shape[key] = v
            else:
                K.launches_by_shape.pop(key, None)


def empty(counts: dict) -> bool:
    return not any(e or s for e, s in counts.values())
