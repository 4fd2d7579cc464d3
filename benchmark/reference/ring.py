"""The plain reference of a row-sharded operator on a ring of processes:
plain PyTorch in float64 on the benchmark's own CSR arrays.  It imports
nothing of the program.

A matrix of ``n`` rows split over ``world`` processes gives each process
one contiguous block of rows (:func:`blocks`).  A process's rows of
``A x`` read x at its own rows and at the columns outside its block that
those rows name: the least halo it must receive (:func:`halo_columns`).
"""

from __future__ import annotations

import numpy as np
import torch


def blocks(n: int, world: int, per: int | None = None) -> list:
    """``[(lo, hi), ...]``: each process's contiguous rows, ``per`` a
    process (default ``ceil(n / world)``; a padded layout passes its own),
    the last block cut at ``n``."""
    per = -(-n // world) if per is None else int(per)
    return [(min(r * per, n), min((r + 1) * per, n)) for r in range(world)]


def _csr(indptr, indices, data=None):
    ip = torch.as_tensor(np.asarray(indptr, dtype=np.int64))
    ix = torch.as_tensor(np.asarray(indices, dtype=np.int64))
    if data is None:
        return ip, ix
    return ip, ix, torch.as_tensor(np.asarray(data, dtype=np.float64))


def halo_columns(indptr, indices, lo: int, hi: int) -> torch.Tensor:
    """The distinct columns outside ``[lo, hi)`` that rows ``[lo, hi)``
    read, sorted: the least halo of that block."""
    ip, ix = _csr(indptr, indices)
    cols = ix[ip[lo]:ip[hi]]
    return torch.unique(cols[(cols < lo) | (cols >= hi)])


def block_product(indptr, indices, data, x, lo: int, hi: int) -> torch.Tensor:
    """Rows ``[lo, hi)`` of ``A x`` in float64: each entry's value times
    ``x`` at its column (``index_select``), summed into its row
    (``index_add_``)."""
    ip, ix, vals = _csr(indptr, indices, data)
    x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    s, e = int(ip[lo]), int(ip[hi])
    rows = torch.repeat_interleave(torch.arange(hi - lo),
                                   ip[lo + 1:hi + 1] - ip[lo:hi])
    prod = vals[s:e] * x.index_select(0, ix[s:e])
    return torch.zeros(hi - lo, dtype=torch.float64).index_add_(0, rows,
                                                                prod)


def rel_residual(indptr, indices, data, b, x) -> float:
    """``||b - A x|| / ||b||`` in float64."""
    n = len(indptr) - 1
    b = torch.as_tensor(np.asarray(b, dtype=np.float64))
    r = b - block_product(indptr, indices, data, x, 0, n)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
