"""The plain reference that decides ``correct``: NumPy and plain PyTorch,
working from the CSR arrays the benchmark made.  It imports nothing of
the program and takes nothing the program made; it reads the program's
outputs (solutions, reported residuals, level-0 products) only to judge
them.
"""

from __future__ import annotations

import numpy as np
import torch


class Matrix:
    """A CSR matrix on the host with the products the checks need, in
    float64."""

    def __init__(self, indptr, indices, data):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int64)
        self.data = np.asarray(data, dtype=np.float64)
        self.n = len(self.indptr) - 1
        self.nnz = len(self.data)
        self._rows = np.repeat(np.arange(self.n, dtype=np.int64),
                               np.diff(self.indptr))

    def matvec(self, x: np.ndarray, data=None) -> np.ndarray:
        """``A x`` for ``x`` of shape ``(n,)`` or ``(n, k)``; ``data``
        replaces the values (the lower-precision control)."""
        data = self.data if data is None else data
        if x.ndim == 2:
            return np.stack([self.matvec(x[:, j], data)
                             for j in range(x.shape[1])], axis=1)
        return np.bincount(self._rows, weights=data * x[self.indices],
                           minlength=self.n)

    def rel_residual(self, b: np.ndarray, x: np.ndarray) -> np.ndarray:
        """``||b - A x|| / ||b||`` in float64, one number per column."""
        r = b - self.matvec(x)
        return np.linalg.norm(r, axis=0) / np.linalg.norm(b, axis=0)


def product_gap(y: np.ndarray, y_ref: np.ndarray) -> float:
    """Widest gap of a product from the reference's, as a share of the
    reference's largest entry (per column for a batch: the worst)."""
    y, y_ref = np.atleast_2d(y.T).T, np.atleast_2d(y_ref.T).T
    scale = np.maximum(np.abs(y_ref).max(axis=0), 1e-300)
    return float((np.abs(y - y_ref).max(axis=0) / scale).max())


def probe_vector(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """A level-0 probe: uniform on [-1, 1), rounded to float32 so that
    both sides start from the same numbers whatever dtype they read."""
    x = rng.uniform(-1.0, 1.0, size=(n, k) if k > 1 else n)
    return x.astype(np.float32).astype(np.float64)


def bfloat16_round(v: np.ndarray) -> np.ndarray:
    """``v`` rounded to bfloat16 (nearest, even), back in float64."""
    return torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.bfloat16).to(torch.float64).numpy()


def control_product(a: Matrix, x: np.ndarray) -> np.ndarray:
    """The reference's level-0 product one precision below float32: values
    and vector in bfloat16 (the control of the product check)."""
    return a.matvec(bfloat16_round(x), data=bfloat16_round(a.data))


def control_residual(a: Matrix, b: np.ndarray, x: np.ndarray,
                     dtype: torch.dtype) -> float:
    """The worst column's ``||b - A x|| / ||b||`` with the matrix, the
    vectors, the products and the sums in ``dtype``: the reference one
    precision below the program's own residual, in the program's place
    (the control of ``rres_report_gap``)."""
    rows = torch.from_numpy(a._rows)
    cols = torch.from_numpy(a.indices)
    vals = torch.from_numpy(a.data).to(dtype)
    b2, x2 = np.atleast_2d(b.T).T, np.atleast_2d(x.T).T
    worst = 0.0
    for j in range(b2.shape[1]):
        xt = torch.from_numpy(np.ascontiguousarray(x2[:, j])).to(dtype)
        bt = torch.from_numpy(np.ascontiguousarray(b2[:, j])).to(dtype)
        y = torch.zeros(a.n, dtype=dtype).index_add_(0, rows, vals * xt[cols])
        r = (bt - y).to(torch.float64)
        worst = max(worst, float(torch.linalg.vector_norm(r))
                    / float(np.linalg.norm(b2[:, j])))
    return worst


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value": v, "limit": l}})``: every number at or
    below its limit, and no number or limit missing or not finite."""
    shown = {}
    ok = True
    for name in sorted(set(numbers) | set(limits)):
        v, limit = numbers.get(name), limits.get(name)
        shown[name] = {"value": v, "limit": limit}
        if limit is None or v is None or not np.isfinite(v) or v > limit:
            ok = False
    return ok, shown
