"""Model-problem generators.

The reference bundles a single test matrix (HB/1138_bus).  The BASELINE
configs additionally call for generated Poisson problems:

* 2D 5-point Poisson (Dirichlet), size nx*ny
* 3D 7-point Poisson, size nx*ny*nz
* anisotropic 2D Poisson (epsilon-scaled y-coupling)

All generators emit host :class:`~amg_tpu_torch.sparse.CSR` directly (vectorized
stencil assembly, no Python loops) so 10M+ row problems build in seconds.
"""

from __future__ import annotations

import numpy as np

from ..sparse import CSR


def _stencil_csr(n: int, terms) -> CSR:
    """Assemble a stencil matrix directly in CSR order — no sort.

    ``terms`` is a list of ``(offset, mask, value)`` sorted by offset;
    per-row nnz positions come from a running prefix over the sorted terms.
    O(nnz) with ~3 passes; a 10M-row 7-point matrix assembles in ~2s.
    """
    masks = [np.asarray(m) for (_, m, _) in terms]
    deg = np.zeros(n, dtype=np.int64)
    for m in masks:
        deg += m
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = np.empty(nnz, dtype=np.int32)
    data = np.empty(nnz, dtype=np.float64)
    idx = np.arange(n, dtype=np.int64)
    prefix = np.zeros(n, dtype=np.int64)
    for (off, _, val), m in zip(terms, masks):
        pos = indptr[:-1][m] + prefix[m]
        indices[pos] = (idx[m] + off).astype(np.int32)
        data[pos] = val
        prefix += m
    return CSR(indptr, indices, data, (n, n))


def poisson2d(nx: int, ny: int | None = None, epsilon: float = 1.0) -> CSR:
    """2D 5-point Laplacian on an nx-by-ny grid, Dirichlet boundaries.

    ``epsilon`` scales the y-direction coupling (anisotropy); stencil is
    [ -eps; -1, 2+2*eps, -1; -eps ].
    """
    if ny is None:
        ny = nx
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = idx // nx
    ones = np.ones(n, dtype=bool)

    return _stencil_csr(n, [
        (-nx, iy > 0, -epsilon),
        (-1, ix > 0, -1.0),
        (0, ones, 2.0 + 2.0 * epsilon),
        (1, ix < nx - 1, -1.0),
        (nx, iy < ny - 1, -epsilon),
    ])


def poisson3d(nx: int, ny: int | None = None, nz: int | None = None) -> CSR:
    """3D 7-point Laplacian on nx*ny*nz grid, Dirichlet boundaries."""
    if ny is None:
        ny = nx
    if nz is None:
        nz = nx
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    ones = np.ones(n, dtype=bool)

    return _stencil_csr(n, [
        (-nx * ny, iz > 0, -1.0),
        (-nx, iy > 0, -1.0),
        (-1, ix > 0, -1.0),
        (0, ones, 6.0),
        (1, ix < nx - 1, -1.0),
        (nx, iy < ny - 1, -1.0),
        (nx * ny, iz < nz - 1, -1.0),
    ])


def fem2d(n: int, seed: int = 0, kappa_jump: float = 1.0e3,
          graded: bool = False) -> CSR:
    """Unstructured P1-FEM stiffness matrix on a random Delaunay mesh.

    Stress-tests the setup phase the way SuiteSparse thermal problems do
    (BASELINE configs thermal2 / parabolic_fem, which cannot be fetched in
    this zero-egress environment): irregular vertex degrees (4..20+), skinny
    triangles that produce *positive* off-diagonal couplings (non-M-matrix
    rows for the strength heuristics), and a checkerboard conductivity jump
    of ``kappa_jump`` across material quadrants.

    ``n`` interior vertices are sampled in the unit square (``graded=True``
    squares the coordinates, clustering points near one corner like a graded
    mesh); a structured ring of boundary vertices closes the hull and is
    Dirichlet-eliminated, so the returned matrix is SPD of order ``n``.
    """
    from scipy.spatial import Delaunay  # lazy: setup-only dependency

    rng = np.random.default_rng(seed)
    nb = max(int(np.sqrt(n)), 4)  # boundary points per side
    t = np.linspace(0.0, 1.0, nb, endpoint=False)
    zeros = np.zeros(nb)
    ones_b = np.ones(nb)
    bnd = np.concatenate([
        np.stack([t, zeros], axis=1),          # south
        np.stack([ones_b, t], axis=1),         # east
        np.stack([1.0 - t, ones_b], axis=1),   # north
        np.stack([zeros, 1.0 - t], axis=1),    # west
    ])
    n_bnd = bnd.shape[0]
    interior = rng.random((n, 2))
    if graded:
        interior = interior ** 2
        # keep a minimum clearance from the boundary so qhull stays happy
        interior = 1e-3 + interior * (1.0 - 2e-3)
    pts = np.concatenate([bnd, interior])

    tri = Delaunay(pts).simplices  # (nt, 3) vertex ids
    p = pts[tri]  # (nt, 3, 2)
    # edge opposite vertex i: e_i = p_{i+2} - p_{i+1} (cyclic); sum_i e_i = 0
    e = p[:, [2, 0, 1], :] - p[:, [1, 2, 0], :]
    # signed double area from any two edges
    area2 = e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0]
    area2 = np.where(np.abs(area2) < 1e-14, 1e-14, area2)
    centroid = p.mean(axis=1)
    quad = (centroid[:, 0] > 0.5).astype(np.int64) \
        + 2 * (centroid[:, 1] > 0.5).astype(np.int64)
    kappa = np.where((quad == 0) | (quad == 3), 1.0, kappa_jump)
    # P1 stiffness: K_ij = kappa * (e_i . e_j) / (2 * |area2|)
    scale = kappa / (2.0 * np.abs(area2))
    rows = []
    cols = []
    vals = []
    for i in range(3):
        for j in range(3):
            rows.append(tri[:, i])
            cols.append(tri[:, j])
            vals.append(scale * np.einsum("td,td->t", e[:, i], e[:, j]))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    v = np.concatenate(vals)
    # Dirichlet-eliminate the boundary ring (first n_bnd vertices)
    keep = (r >= n_bnd) & (c >= n_bnd)
    return CSR.from_coo(r[keep] - n_bnd, c[keep] - n_bnd, v[keep], (n, n))


def random_spd(n: int, density: float = 0.05, seed: int = 0) -> CSR:
    """Random diagonally-dominant SPD matrix (test fixture)."""
    rng = np.random.default_rng(seed)
    nnz = max(int(n * n * density), n)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = -rng.random(nnz)
    # symmetrize
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    v = np.concatenate([vals, vals]) * 0.5
    off = r != c
    a = CSR.from_coo(r[off], c[off], v[off], (n, n))
    # diagonal = 1 + sum|offdiag| per row  -> strictly diagonally dominant
    rowsum = np.zeros(n)
    rr = np.repeat(np.arange(n), a.row_degrees)
    np.add.at(rowsum, rr, np.abs(a.data))
    d = CSR.from_coo(np.arange(n), np.arange(n), 1.0 + rowsum, (n, n))
    return CSR.from_coo(
        np.concatenate([np.repeat(np.arange(n), a.row_degrees), np.arange(n)]),
        np.concatenate([a.indices, np.arange(n)]),
        np.concatenate([a.data, d.data]),
        (n, n),
    )
