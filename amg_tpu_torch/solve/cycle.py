"""Multigrid V/W-cycle.

Replicates the reference's non-recursive counter/goto cycle
(``SSS_amg_cycle``, amg/Solve/SSS_cycle.cu:848-967) as a plain Python
recursion over the levels.  At the boundary of a fine-grid-embedded
hierarchy (``Level.compact_idx`` / ``member_idx``) one gather and one
scatter move the vectors between the embedded and the compact index
spaces; the index tensors hold only valid positions, so every index is in
range.  Per reference semantics, level 0 runs its
block once per cycle call and deeper levels repeat their block
``cycle_type`` times per parent visit (V=1, W=2).

The coarsest solve is either a dense inverse apply (one matvec) or the
reference's CG with a GMRES fallback (``CoarsestSolver.KRYLOV``,
``SSS_amg_coarest_solve``, amg/Solve/SSS_cycle.cu:819-846).
"""

from __future__ import annotations

import torch

from ..params import AMGParams, CoarsestSolver
from ..hierarchy import Hierarchy
from ..ops.spmv import spmv, residual_fused
from .smoothers import smooth
from .krylov import CoarsestKrylov


def krylov_solver(mg: Hierarchy, b: torch.Tensor, ctol) -> CoarsestKrylov:
    """The KRYLOV coarsest solve of ``mg`` for right-hand sides shaped like
    ``b`` at ``ctol``, made at first use and cached on the hierarchy (on
    the card its CUDA graph and graph pool are built at its first solve).
    The cache keeps one solve per number of dimensions of ``b``: a new
    batch width, dtype, device or tolerance replaces the one made before
    it (whose graph and pool go with it, unless a captured ``solve_jit``
    step that holds its nodes keeps it)."""
    level = mg.levels[-1]
    key = (tuple(b.shape), b.dtype, b.device, float(ctol))
    solver = mg.krylov.get(key)
    if solver is None:
        for old in [k for k in mg.krylov if len(k[0]) == b.dim()]:
            del mg.krylov[old]
        n = level.n
        # maxit = max(250, min(n*n, 1000)) (amg/Solve/SSS_cycle.cu:822)
        solver = mg.krylov[key] = CoarsestKrylov(
            level.a, b, ctol, max(250, min(n * n, 1000)), restart=30)
    return solver


def coarsest_solve(mg: Hierarchy, b: torch.Tensor, pars: AMGParams, ctol):
    """Solve the coarsest system (``b`` one vector or a ``(k, pad)``
    batch).

    KRYLOV: CG to ``ctol``, and GMRES (restart 30) from zero only where CG
    did not converge (amg/Solve/SSS_cycle.cu:837-841), as one CUDA graph
    of while and if nodes on the card (no host read) and host loops on
    the CPU (:class:`~.krylov.CoarsestKrylov`): a batch runs one CG over
    its columns and GMRES on each failed column as one vector, as the
    one-vector call would."""
    if pars.coarsest_solver == CoarsestSolver.DENSE:
        if b.dim() == 2:
            return b @ mg.coarse_inv.T
        return mg.coarse_inv @ b
    return krylov_solver(mg, b, ctol).solve(b)


def cycle(mg: Hierarchy, x: torch.Tensor, b: torch.Tensor, pars: AMGParams):
    """One multigrid cycle on level 0. Returns updated x (padded length)."""
    ctol = min(pars.ctol, pars.tol * 0.1) if pars.ctol > pars.tol else pars.ctol
    return _cycle_level(mg, 0, x, b, pars, ctol)


def _cycle_level(mg: Hierarchy, l: int, x, b, pars: AMGParams, ctol):
    nl = mg.num_levels
    if l == nl - 1:
        return coarsest_solve(mg, b, pars, ctol)

    level = mg.levels[l]
    repeats = 1 if l == 0 else max(pars.cycle_type, 1)
    # coarse-level smoother override (e.g. Chebyshev below level 0)
    pars_l = pars if (l == 0 or pars.coarse_smoother is None) \
        else pars.replace(smoother=pars.coarse_smoother)
    if pars.poly_deg_schedule is not None:
        sched = pars.poly_deg_schedule
        pars_l = pars_l.replace(poly_deg=sched[min(l, len(sched) - 1)])

    for _ in range(repeats):
        # pre-smoothing
        x = smooth(level, x, b, pars_l, pars.pre_iter, pre=True)
        # restrict residual
        r = residual_fused(level.a, x, b)
        if level.member_idx is not None:
            # compact boundary: gather the residual at this level's member
            # positions (into a vector of the compact P's padded length),
            # then the compact Ell restriction
            rc = r.new_zeros((*r.shape[:-1], level.p.padded_rows))
            rc[..., : level.member_idx.shape[0]] = r[..., level.member_idx]
            bc = spmv(level.r, rc)
        else:
            bc = spmv(level.r, r)
            if level.compact_idx is not None:
                # fine-grid-embedded -> compact boundary: the next level's
                # rows from their embedded positions
                coarse = bc.new_zeros((*bc.shape[:-1],
                                       mg.levels[l + 1].pad))
                coarse[..., : level.compact_idx.shape[0]] = \
                    bc[..., level.compact_idx]
                bc = coarse
        # coarse correction
        xc = _cycle_level(mg, l + 1, torch.zeros_like(bc), bc, pars, ctol)
        if level.member_idx is not None:
            # compact prolongation on the short vector, then added back
            # into the embedded index space
            xe = spmv(level.p, xc)[..., : level.member_idx.shape[0]]
            x = x.index_add(-1, level.member_idx, xe.to(x.dtype))
        elif level.compact_idx is not None:
            # compact -> embedded: one scatter, then the embedded P
            xe = torch.zeros_like(x)
            xe[..., level.compact_idx] = \
                xc[..., : level.compact_idx.shape[0]]
            x = x + spmv(level.p, xe)
        else:
            x = x + spmv(level.p, xc)
        # post-smoothing
        x = smooth(level, x, b, pars_l, pars.post_iter, pre=False)
    return x
