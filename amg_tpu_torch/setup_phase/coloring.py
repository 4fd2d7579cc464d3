"""Graph coloring for TPU-parallel Gauss-Seidel.

The reference's default smoother is sequential lexicographic Gauss-Seidel
with C/F ordering (amg/Solve/SSS_smooth.c:4-137) — inherently serial, the
number-one "hard part" for a SIMD machine (SURVEY.md section 7).

TPU-native answer: **multicolor Gauss-Seidel**.  Color the adjacency graph
of A so no two adjacent rows share a color; rows of one color have no
mutual dependencies, so updating them simultaneously is *exact* Gauss-Seidel
for the colored ordering.  One sweep = `n_colors` vectorized group updates,
each a rectangular gather/multiply — the same work as one SpMV.

Coloring runs once per level at setup (host, vectorized Jones-Plassmann).
C/F ordering is honored by splitting each color class into its F and C
parts and ordering groups F-first (pre-smooth) or C-first (post-smooth),
matching the reference's ``gs_cf`` semantics (amg/Solve/SSS_smooth.c:16-86).
"""

from __future__ import annotations

import numpy as np

from ..params import CGPT
from ..sparse import CSR


def color_graph(a: CSR, seed: int = 7, max_rounds: int = 10000) -> np.ndarray:
    """Color the symmetrized pattern of A so no adjacent rows share a color.

    Fast path: native C++ greedy first-fit coloring (O(nnz), <= maxdeg+1
    colors).  Fallback: vectorized Jones-Plassmann-Luby rounds.  Returns int
    colors[n] >= 0.
    """
    from ..native import lib

    if lib is not None:
        colors, _ = lib.greedy_color(a)
        return colors
    n = a.n_rows
    rows = np.repeat(np.arange(n, dtype=np.int64), a.row_degrees)
    cols = a.indices.astype(np.int64)
    off = rows != cols
    # symmetrize edge list
    u = np.concatenate([rows[off], cols[off]])
    v = np.concatenate([cols[off], rows[off]])

    rng = np.random.default_rng(seed)
    prio = rng.random(n)
    colors = np.full(n, -1, dtype=np.int64)

    for _ in range(max_rounds):
        unc = colors < 0
        if not unc.any():
            break
        # does any uncolored neighbor have higher priority?
        beaten = np.zeros(n, dtype=bool)
        m = unc[u] & unc[v] & (prio[v] > prio[u])
        beaten[u[m]] = True
        winners = unc & ~beaten
        if not winners.any():
            # ties in priorities: nudge
            prio = prio + rng.random(n) * 1e-9
            continue
        # smallest color not used by (colored) neighbors, per winner
        # iterate candidate colors; bounded by max degree + 1
        cand = np.zeros(n, dtype=np.int64)
        for _c in range(n):
            conflict = np.zeros(n, dtype=bool)
            m = winners[u] & (colors[v] == cand[u]) & (colors[v] >= 0)
            conflict[u[m]] = True
            if not conflict.any():
                break
            cand[winners & conflict] += 1
        colors[winners] = cand[winners]

    return colors


def build_groups(
    a: CSR,
    cfmark: np.ndarray | None,
    pad_to: int,
    group_multiple: int = 8,
    seed: int = 7,
):
    """Build padded GS update groups.

    Returns ``(groups, group_cf, gid)`` where ``groups`` is an int32 array
    (n_groups, max_size) of row indices padded with ``pad_to`` (an
    out-of-range index — dropped by scatter, harmless for gather),
    ``group_cf[g]`` is 1 if group g contains C points, 0 for F points
    (used to order groups F-first / C-first), and ``gid`` is the (pad_to,)
    int32 inverse map (group index per row, -1 on padding) used by the
    gather-free masked-GS path.

    When ``cfmark`` is None, groups are pure color classes in color order.
    """
    n = a.n_rows
    colors = color_graph(a, seed=seed)
    n_colors = int(colors.max()) + 1 if n else 1

    group_lists: list[np.ndarray] = []
    group_cf: list[int] = []
    for c in range(n_colors):
        members = np.flatnonzero(colors == c)
        if cfmark is None:
            if len(members):
                group_lists.append(members)
                group_cf.append(0)
        else:
            f_part = members[cfmark[members] != CGPT]
            c_part = members[cfmark[members] == CGPT]
            if len(f_part):
                group_lists.append(f_part)
                group_cf.append(0)
            if len(c_part):
                group_lists.append(c_part)
                group_cf.append(1)

    if not group_lists:
        group_lists = [np.zeros(0, dtype=np.int64)]
        group_cf = [0]

    max_size = max(len(g) for g in group_lists)
    max_size = ((max_size + group_multiple - 1) // group_multiple) * group_multiple
    max_size = max(max_size, group_multiple)
    out = np.full((len(group_lists), max_size), pad_to, dtype=np.int64)
    gid = np.full(pad_to, -1, dtype=np.int32)
    for gi, g in enumerate(group_lists):
        out[gi, : len(g)] = g
        gid[g] = gi
    return (
        out.astype(np.int32),
        np.asarray(group_cf, dtype=np.int32),
        gid,
    )
