"""The benchmark's own matrix generators (NumPy; scipy's Delaunay for the
FEM mesh).  Each returns ``(indptr int64, indices int32, data float64)``
of a square CSR matrix with sorted column indices in every row.

The configurations' matrices come from here, and the same arrays are
handed to the program under test and to the plain reference.  Nothing
here imports the program.
"""

from __future__ import annotations

import numpy as np


def poisson3d_7pt(nx: int, ny: int, nz: int):
    """The 7-point Laplacian on an ``nx * ny * nz`` grid with Dirichlet
    boundaries (hypre's IJ driver ``-laplacian -n nx ny nz``): 6 on the
    diagonal, -1 to each grid neighbour, rows numbered x fastest."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    # neighbours in increasing column order, so every row comes out sorted
    stencil = ((-nx * ny, iz > 0), (-nx, iy > 0), (-1, ix > 0),
               (0, None), (1, ix < nx - 1), (nx, iy < ny - 1),
               (nx * ny, iz < nz - 1))
    cols = np.full((n, 7), -1, dtype=np.int64)
    vals = np.zeros((n, 7))
    for j, (off, inside) in enumerate(stencil):
        keep = np.ones(n, dtype=bool) if inside is None else inside
        cols[keep, j] = idx[keep] + off
        vals[keep, j] = 6.0 if off == 0 else -1.0
    present = cols >= 0
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(present.sum(axis=1), out=indptr[1:])
    return indptr, cols[present].astype(np.int32), vals[present]


def _csr_from_coo(rows, cols, vals, n):
    """COO -> CSR with rows sorted by column and duplicates summed in the
    order they come (a frozen copy of the port's ``CSR.from_coo`` at the
    time the benchmark was written, so the FEM matrix is the same bits)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    dup = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
    if dup.any():
        keep = np.concatenate([[True], ~dup])
        grp = np.cumsum(keep) - 1
        summed = np.zeros(int(keep.sum()), dtype=np.float64)
        np.add.at(summed, grp, vals)
        rows, cols, vals = rows[keep], cols[keep], summed
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.bincount(rows, minlength=n)
    np.cumsum(indptr, out=indptr)
    return indptr, cols.astype(np.int32), vals


def fem2d(n: int, seed: int = 0, kappa_jump: float = 1.0e3):
    """P1 FEM stiffness matrix of a random Delaunay mesh of the unit square
    with a checkerboard conductivity jump of ``kappa_jump`` and a
    Dirichlet-eliminated ring of boundary vertices: SPD of order ``n``,
    about 7 nonzeros a row, as SuiteSparse's thermal2.

    A frozen copy of the port's ``fem2d`` generator (``graded=False``):
    the same random stream, mesh and arithmetic, so that the program and
    the reference can be held to one matrix that the benchmark makes."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    nb = max(int(np.sqrt(n)), 4)
    t = np.linspace(0.0, 1.0, nb, endpoint=False)
    zeros, ones_b = np.zeros(nb), np.ones(nb)
    bnd = np.concatenate([
        np.stack([t, zeros], axis=1),
        np.stack([ones_b, t], axis=1),
        np.stack([1.0 - t, ones_b], axis=1),
        np.stack([zeros, 1.0 - t], axis=1),
    ])
    n_bnd = bnd.shape[0]
    pts = np.concatenate([bnd, rng.random((n, 2))])
    tri = Delaunay(pts).simplices
    p = pts[tri]
    # edge opposite vertex i: e_i = p_{i+2} - p_{i+1} (cyclic)
    e = p[:, [2, 0, 1], :] - p[:, [1, 2, 0], :]
    area2 = e[:, 0, 0] * e[:, 1, 1] - e[:, 0, 1] * e[:, 1, 0]
    area2 = np.where(np.abs(area2) < 1e-14, 1e-14, area2)
    centroid = p.mean(axis=1)
    quad = (centroid[:, 0] > 0.5).astype(np.int64) \
        + 2 * (centroid[:, 1] > 0.5).astype(np.int64)
    kappa = np.where((quad == 0) | (quad == 3), 1.0, kappa_jump)
    scale = kappa / (2.0 * np.abs(area2))
    rows, cols, vals = [], [], []
    for i in range(3):
        for j in range(3):
            rows.append(tri[:, i])
            cols.append(tri[:, j])
            vals.append(scale * np.einsum("td,td->t", e[:, i], e[:, j]))
    r, c, v = np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    keep = (r >= n_bnd) & (c >= n_bnd)
    return _csr_from_coo(r[keep] - n_bnd, c[keep] - n_bnd, v[keep], n)


GENERATORS = {"poisson3d_7pt": poisson3d_7pt, "fem2d": fem2d}


def generate(spec: dict):
    """The matrix a configuration's ``matrix`` entry names:
    ``{"generator": name, **arguments}``."""
    args = {k: v for k, v in spec.items() if k != "generator"}
    return GENERATORS[spec["generator"]](**args)
