"""AMG hierarchy: host setup driver and device-resident level containers.

Host setup (:func:`setup_host`) replicates the control flow of the
reference's ``SSS_amg_setup`` (amg/Setup/SSS_SETUP.cu:36-178): loop
coarsening -> interpolation -> R = P^T -> Galerkin RAP, with the same four
break checks and warnings.  It is the same numpy code as
``amg_tpu.hierarchy`` and produces the same hierarchy.  The result is then
packed once into plain dataclasses of torch tensors (:class:`Level` /
:class:`Hierarchy`) on an explicit device, with the same level pads as
``amg_tpu`` so vectors compare entry for entry.

Formats: ``Dia`` for banded levels, ``Dense`` for small ones, ``WEll``
for large unstructured levels when ``use_well="on"`` (level 0 then
RCM-ordered, coarse WEll levels in barycentric order, P/R packed as WEll
too), ``Ell`` otherwise.  ``amg_tpu``'s BandedBlocks format and its
fine-grid embedding are not ported yet: ``use_banded`` on ``"auto"``
resolves to ``"off"`` and ``embed_levels=-1`` to 0; asking for them raises
``NotImplementedError``.  ``use_well="auto"`` resolves to ``"off"`` too:
on one device ``amg_tpu``'s auto turns WEll and BandedBlocks on together,
a hierarchy the port cannot build until BandedBlocks is ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .params import AMGParams, CoarsenType, InterpType, MIN_CDOF, SMALLFLOAT
from .params import SmootherType
from .sparse import (CSR, Ell, Dia, Dense, WEll, _round_up, _to_device,
                     torch_dtype)
from .setup_phase.strength import strength_matrix
from .setup_phase.cf_split import rs_split, pmis_split, clean_ff_couplings
from .setup_phase.interp import build_interpolation
from .setup_phase.coloring import build_groups
from .ops.spgemm import rap


# ---------------------------------------------------------------------------
# Device containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Level:
    """One device-resident grid level.

    The coarsest level has ``p = r = None`` and the hierarchy holds a dense
    inverse for it.  The level operator ``a`` is :class:`Dia` when banded
    (gather-free SpMV and fused masked-colour GS through the DIA kernel),
    :class:`Dense` when small, :class:`WEll` when large and unstructured
    (masked-colour GS through the WEll kernel) and :class:`Ell` otherwise.
    """

    a: object                   # Dia | Dense | WEll | Ell
    p: Optional[object]         # prolongation from level l+1 to l (Ell|WEll)
    r: Optional[object]         # restriction  from level l to l+1 (Ell|WEll)
    diag: torch.Tensor          # (pad,) a_ii
    inv_diag: torch.Tensor      # (pad,) 1/a_ii, 0 where |a_ii| tiny
    l1_inv: torch.Tensor        # (pad,) 1/sum_j |a_ij|
    diag_mask: Optional[torch.Tensor]  # (pad, w) bool diagonal slots (Ell GS)
    # GS groups for the gather path (unpermuted Ell levels): one int64 row
    # index tensor per group, WITHOUT amg_tpu's out-of-range padding (torch
    # raises on out-of-range indices where JAX clamps or drops)
    groups: Optional[Tuple[torch.Tensor, ...]]
    gid: Optional[torch.Tensor]        # (pad,) int32 group id per row (-1 pad)
    rho_dinv_a: float           # spectral-radius estimate of D^-1 A
    group_cf: Tuple[int, ...]   # 1 if group holds C points
    # (start, size) row range per GS group when the level is
    # color-contiguously ordered; None -> masked or gather group path
    ranges: Optional[Tuple[Tuple[int, int], ...]] = None
    # (n_groups, pad) group-masked inverse diagonal: gs_w[g] = inv_diag
    # where gid == g (and inv_diag != 0), else 0 — the weight operand of
    # the DIA kernel's fused GS update (one operator pass per colour)
    gs_w: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.a.n_rows

    @property
    def pad(self) -> int:
        return self.a.padded_rows


@dataclasses.dataclass
class Hierarchy:
    """The full device multigrid hierarchy (reference ``SSS_AMG``)."""

    levels: Tuple[Level, ...]
    coarse_inv: torch.Tensor      # (pad_c, pad_c) dense inverse of coarsest A

    @property
    def num_levels(self) -> int:
        return len(self.levels)


# ---------------------------------------------------------------------------
# Host setup results (kept for printing / tests / checkpoints)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostHierarchy:
    """Host-side mirror of the hierarchy (CSR matrices + C/F markers)."""

    a: list          # list[CSR], per level
    p: list          # list[CSR], per level except coarsest
    r: list
    cfmark: list     # list[np.ndarray]
    setup_seconds: float = 0.0
    # per level: sorted GS class key per row (color*2 + is_C) when the level
    # has been permuted color-contiguously by :func:`reorder_for_gs`, else None
    gs_key: Optional[list] = None
    # per level: the new->old row permutation applied by reorder_for_gs
    # (None where untouched)
    perms: Optional[list] = None
    # per level: block half-bandwidth of amg_tpu's BandedBlocks format; kept
    # so checkpoints round-trip (the port packs such levels as Ell/Dense)
    banded_nb: Optional[list] = None

    @property
    def num_levels(self) -> int:
        return len(self.a)

    def complexity(self) -> tuple[float, float]:
        grid = sum(m.n_rows for m in self.a) / self.a[0].n_rows
        op = sum(m.nnz for m in self.a) / max(self.a[0].nnz, 1)
        return grid, op


def complexity_print(hh: HostHierarchy) -> str:
    """Level/complexity table with the reference's exact format
    (``SSS_amg_complexity_print``, amg/Setup/SSS_SETUP.cu:5-34)."""
    lines = []
    lines.append("-----------------------------------------------------------")
    lines.append("  Level   Num of rows   Num of nonzeros   Avg. NNZ / row   ")
    lines.append("-----------------------------------------------------------")
    for lvl, m in enumerate(hh.a):
        avg = m.nnz / m.n_rows
        lines.append("%5d %13d %17d %14.2f" % (lvl, m.n_rows, m.nnz, avg))
    lines.append("-----------------------------------------------------------")
    grid, op = hh.complexity()
    lines.append("  Grid complexity = %.3f  |  Operator complexity = %.3f"
                 % (grid, op))
    lines.append("-----------------------------------------------------------")
    return "\n".join(lines)


def check_supported(pars: AMGParams) -> None:
    """Raise ``NotImplementedError`` for format and layout options of
    ``amg_tpu`` that the port does not implement yet.  ``"auto"`` and
    ``-1`` are accepted and resolve to the compact single-device layout
    (``use_well = use_banded = "off"``, ``embed_levels = 0``);
    ``use_well="on"`` is taken."""
    if pars.use_banded == "on":
        raise NotImplementedError("use_banded='on': the BandedBlocks format "
                                  "is not ported yet")
    if pars.embed_levels > 0:
        raise NotImplementedError("embed_levels > 0: fine-grid embedding is "
                                  "not ported yet")
    if pars.dist_devices > 1:
        raise NotImplementedError("dist_devices > 1: multi-device layouts "
                                  "are not ported yet")
    if pars.dtype not in ("float32", "float64"):
        raise NotImplementedError(f"dtype={pars.dtype!r}: the port cycles in "
                                  "float32 or float64")


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


def setup_host(a: CSR, pars: AMGParams, log=print) -> HostHierarchy:
    """Build the CSR hierarchy on the host.

    Control flow and warnings replicate ``SSS_amg_setup``
    (amg/Setup/SSS_SETUP.cu:69-155) including its four break checks.
    PMIS runs the host splitter at every size (``amg_tpu`` switches to a
    JAX device routine at 262,144 rows).
    """
    t0 = time.perf_counter()
    min_cdof = max(pars.coarse_dof, MIN_CDOF)
    stop_rows = max(min_cdof, pars.coarse_stop_rows)
    max_lvls = pars.max_levels

    mats = [a]
    ps: list[CSR] = []
    rs: list[CSR] = []
    cfmarks: list[np.ndarray] = []
    cs_type = pars.cs_type

    lvl = 0
    while mats[lvl].n_rows > stop_rows and lvl < max_lvls - 1:
        al = mats[lvl]
        s = strength_matrix(al, pars.strong_threshold, pars.max_row_sum)

        failed = s.nnz <= 0
        vec = None
        agg = None
        col = 0
        if not failed:
            if cs_type == CoarsenType.RS:
                vec, col = rs_split(s)
            elif cs_type == CoarsenType.PMIS:
                vec, col = pmis_split(s)
            elif cs_type == CoarsenType.SA:
                from .setup_phase.aggregation import aggregate

                agg, col = aggregate(s)
            else:  # RSP falls back to RS (reference leaves RSP unimplemented,
                   # amg/Setup/SSS_coarsen.c:741-743)
                vec, col = rs_split(s)
            if pars.interp_type == InterpType.DIR and col > 0 \
                    and vec is not None:
                col = clean_ff_couplings(s, vec, col)
            failed = col <= 0

        # Check 1: coarsening succeeded? (amg/Setup/SSS_SETUP.cu:78-89)
        if failed:
            if pars.verbose:
                log("### WARNING: Could not find any C-variables!")
                log(f"### WARNING: RS coarsening on level-{lvl} failed!")
            break

        # Check 2: coarse space too small (amg/Setup/SSS_SETUP.cu:92-98)
        if col < min_cdof:
            break

        # Check 3: over-aggressive coarsening warning (:101-106)
        if al.n_rows > col * 10 and pars.verbose:
            log("### WARNING: Coarsening might be too aggressive!")
            log(f"### WARNING: Lvl = {lvl} ,Fine level = {al.n_rows}, "
                f"coarse level = {col}. Discard!")

        # Fall back to RS when coarsening slows (:110)
        if col * 1.5 > al.n_rows:
            cs_type = CoarsenType.RS

        cfmarks.append(vec.copy() if vec is not None else None)

        if agg is not None:
            from .setup_phase.aggregation import sa_interpolation

            p = sa_interpolation(al, agg, col)
        else:
            p = build_interpolation(al, s, vec, col, pars)
        r = p.transpose()
        ac = rap(r, al, p)
        if (pars.coarse_sparsify > 0
                and lvl + 1 >= pars.sparsify_from_level
                and _pick_format(ac, pars) in ("ell", "well")):
            # scope to gather-bound (ELL) levels: dense deep levels cost
            # nothing per extra nnz, so sparsifying them only loses
            # convergence
            ac = sparsify_operator(ac, pars.coarse_sparsify)

        # Check 4: is the coarse matrix too dense? (:142-152)
        # (replicates the reference's integer division on the fine matrix)
        if al.nnz // al.n_rows > al.n_cols * 0.2:
            if pars.verbose:
                log("### WARNING: Coarse matrix is too dense!")
                log(f"### WARNING: m = n = {al.n_cols}, nnz = {al.nnz}!")
            break

        ps.append(p)
        rs.append(r)
        mats.append(ac)
        lvl += 1

    hh = HostHierarchy(a=mats, p=ps, r=rs, cfmark=cfmarks)
    hh.setup_seconds = time.perf_counter() - t0
    return hh


def reorder_for_gs(hh: HostHierarchy, pars: AMGParams) -> HostHierarchy:
    """Reorder levels for the device formats (in place).

    Level 0 is RCM-ordered when it is headed for the WEll format
    (:func:`reorder_l0_for_well`).  Each coarse level ``l >= 1`` not
    destined for the Dia format is then permuted:

    * a WEll level into barycentric order (:func:`_barycentric_order`),
      which keeps its slot windows local; its GS runs masked;
    * any other level, when a GS-family smoother runs on it, by
      ``(color, C/F)`` so every multicolor-GS class is a contiguous row
      range: a GS sweep then costs one SpMV's worth of slices instead of
      ``n_groups`` gathers.

    Each permutation is a similarity transform (``P A P^T`` plus matching
    P/R/cfmark updates), so the hierarchy's numerics are unchanged.
    (``amg_tpu``'s RCM branch for BandedBlocks is not ported: that format
    is off in the port.)
    """
    from .params import CGPT
    from .setup_phase.coloring import color_graph

    nl = hh.num_levels
    hh.gs_key = [None] * nl
    hh.perms = [None] * nl
    hh.banded_nb = [None] * nl
    reorder_l0_for_well(hh, pars)
    for l in range(1, nl):
        al = hh.a[l]
        fmt_l = _pick_format(al, pars)
        if fmt_l == "dia":
            continue
        n = al.n_rows
        if fmt_l == "well":
            # order rows for slot-window locality (not by color): each
            # unknown at its interpolation barycenter in the parent level
            perm = _barycentric_order(hh.p[l - 1])
        elif not _needs_groups(pars, True):
            # no GS-family smoother on this level: the color-contiguous
            # permutation (and the coloring itself) buys nothing
            continue
        else:
            colors = color_graph(al)
            cf = hh.cfmark[l] if l < len(hh.cfmark) else None
            is_c = (
                (np.asarray(cf) == CGPT).astype(np.int64)
                if cf is not None
                else np.zeros(n, dtype=np.int64)
            )
            key = colors.astype(np.int64) * 2 + is_c
            perm = np.argsort(key, kind="stable")  # new -> old
            hh.gs_key[l] = key[perm]
        if not np.array_equal(perm, np.arange(n, dtype=np.int64)):
            hh.perms[l] = perm
            inv = np.empty_like(perm)
            inv[perm] = np.arange(n, dtype=np.int64)
            hh.a[l] = al.permute(perm)
            hh.p[l - 1] = hh.p[l - 1].permute_cols(inv)
            hh.r[l - 1] = hh.r[l - 1].permute_rows(perm)
            if l < nl - 1:
                hh.p[l] = hh.p[l].permute_rows(perm)
                hh.r[l] = hh.r[l].permute_cols(inv)
            if l < len(hh.cfmark) and hh.cfmark[l] is not None:
                hh.cfmark[l] = np.asarray(hh.cfmark[l])[perm]
    return hh


def reorder_l0_for_well(hh: HostHierarchy, pars: AMGParams) -> None:
    """RCM-permute level 0 when it is headed for the WEll format.

    WEll slot counts (and with them the bytes every product streams) grow
    with how far a row's couplings stray from its 1024-wide x windows, so
    an unstructured level 0 is bandwidth-reduced before packing.  Unlike
    the coarse-level permutations this one is visible at the API boundary:
    the driver permutes b/x0 on entry and inverts on exit
    (``hh.perms[0]``).  Numerics are unchanged (similarity transform).
    """
    a0 = hh.a[0]
    if _pick_format(a0, pars) != "well":
        return
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    m = sp.csr_matrix((a0.data, a0.indices, a0.indptr), shape=a0.shape)
    perm = np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True),
                      dtype=np.int64)
    if np.array_equal(perm, np.arange(a0.n_rows, dtype=np.int64)):
        return
    if hh.perms is None:
        hh.perms = [None] * hh.num_levels
    hh.perms[0] = perm
    inv = np.empty_like(perm)
    inv[perm] = np.arange(a0.n_rows, dtype=np.int64)
    hh.a[0] = a0.permute(perm)
    if hh.num_levels > 1:
        hh.p[0] = hh.p[0].permute_rows(perm)
        hh.r[0] = hh.r[0].permute_cols(inv)
    if len(hh.cfmark) > 0 and hh.cfmark[0] is not None:
        hh.cfmark[0] = np.asarray(hh.cfmark[0])[perm]


def _barycentric_order(p: CSR) -> np.ndarray:
    """Locality ordering of a coarse level induced by its parent: place
    each coarse unknown at the |P|-weighted mean of its fine rows'
    positions and sort.  Keeps A_l, P_{l-1}, R_{l-1} window-local when
    the parent is already bandwidth-reduced (level-0 RCM cascades down
    the hierarchy without per-level RCM passes)."""
    w = np.abs(p.data)
    rows = p.row_indices.astype(np.float64)
    cols = p.indices.astype(np.int64)
    nc = p.n_cols
    wsum = np.bincount(cols, weights=w, minlength=nc)
    wpos = np.bincount(cols, weights=w * rows, minlength=nc)
    pos = np.where(wsum > 0, wpos / np.maximum(wsum, 1e-300), 0.0)
    return np.argsort(pos, kind="stable").astype(np.int64)


def _gs_w_stack(gid_np, inv_diag_np, n_groups, dtype, device):
    """Stacked fused-GS weights: w[g] = inv_diag where gid==g else 0.
    Only built for small color counts AND a bounded byte footprint
    (n_groups * pad resident device memory)."""
    if n_groups == 0 or n_groups > 8:
        return None
    if n_groups * len(gid_np) * inv_diag_np.dtype.itemsize > 256e6:
        return None
    w = np.zeros((n_groups, len(gid_np)), dtype=inv_diag_np.dtype)
    for g in range(n_groups):
        m = (gid_np == g) & (inv_diag_np != 0)
        w[g, m] = inv_diag_np[m]
    return _to_device(w, dtype, device)


def sparsify_operator(a: CSR, threshold: float) -> CSR:
    """Non-Galerkin coarse-operator sparsification.

    Drop entries with ``|a_ij| < threshold * sqrt(|a_ii a_jj|)`` and lump
    the dropped mass into the diagonal (row sums preserved) — the
    standard remedy for Galerkin stencil growth.  No reference equivalent:
    the reference keeps exact Galerkin operators (amg/SSS_matvec.c:398).
    """
    n = a.n_rows
    d = a.diagonal_fast()
    rows = a.row_indices
    cols = a.indices.astype(np.int64)
    scale = np.sqrt(np.abs(d[rows]) * np.abs(d[cols]))
    keep = (rows == cols) | (np.abs(a.data) >= threshold * scale)
    lump = np.bincount(rows[~keep], weights=a.data[~keep], minlength=n)

    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.bincount(rows[keep], minlength=n)
    np.cumsum(indptr, out=indptr)
    data = a.data[keep].copy()
    new_cols = cols[keep].astype(np.int32)
    # add the lumped mass onto each row's diagonal slot
    kept_rows = rows[keep]
    is_diag = new_cols == kept_rows
    data[is_diag] += lump[kept_rows[is_diag]]
    return CSR(indptr, new_cols, data, a.shape)


def _needs_groups(pars: AMGParams, is_coarse: bool) -> bool:
    """GS update groups (graph coloring) are only consumed by the
    GS-family smoothers; Chebyshev/Jacobi/L1 levels skip the coloring
    entirely."""
    sm = pars.smoother if (not is_coarse or pars.coarse_smoother is None) \
        else pars.coarse_smoother
    return sm in (
        SmootherType.GS, SmootherType.SGS, SmootherType.SOR,
        SmootherType.SSOR, SmootherType.GSOR, SmootherType.SGSOR,
        SmootherType.CG,
    )


def _row_abs_sums(al: CSR) -> np.ndarray:
    """sum_j |a_ij| per row — reduceat over the CSR entry stream."""
    out = np.zeros(al.n_rows)
    nonempty = al.row_degrees > 0
    starts = al.indptr[:-1][nonempty]
    if len(starts):
        out[nonempty] = np.add.reduceat(np.abs(al.data), starts)
    return out


def _rho_dinv_a_host(al: CSR, niter: int = 12) -> float:
    """Spectral-radius estimate of ``D^{-1} A`` by host power iteration
    (scipy CSR matvec, O(niter * nnz)).  Only the Chebyshev/polynomial
    smoothers consume the result.  The start vector is the one random
    draw of the setup: ``np.random.default_rng(0)``, as in ``amg_tpu``.
    """
    import scipy.sparse as sp

    n = al.n_rows
    if n == 0:
        return 1.0
    d = al.diagonal_fast()
    dinv = np.where(np.abs(d) > SMALLFLOAT,
                    1.0 / np.where(d != 0, d, 1.0), 0.0)
    m = sp.csr_matrix((al.data, al.indices, al.indptr), shape=al.shape)
    v = np.random.default_rng(0).random(n)
    rho = 1.0
    for _ in range(niter):
        w = dinv * (m @ v)
        nw = float(np.linalg.norm(w))
        nv = float(np.linalg.norm(v))
        if nw <= 0.0 or nv <= 0.0:
            break
        rho = nw / nv
        v = w / nw
    return float(rho)


def _use_dia(al: CSR, pars: AMGParams) -> bool:
    """Pick the DIA fast path when the operator is banded enough: few
    distinct (col-row) offsets and acceptable zero-fill."""
    if al.n_rows != al.n_cols:
        return False
    nd = Dia.num_offsets(al)
    if nd > pars.max_diags:
        return False
    fill = nd * al.n_rows / max(al.nnz, 1)
    return fill <= pars.max_dia_fill


def _pick_format(al: CSR, pars: AMGParams) -> str:
    """Device format for a level operator: 'dia' | 'dense' | 'well' | 'ell'.

    DIA when banded; Dense when the dense footprint fits the budget — deep
    levels are small but nearly dense; WEll for large unstructured levels
    when ``use_well="on"`` (``"auto"`` resolves to off in the port);
    padded-ELL gathers otherwise.
    """
    if _use_dia(al, pars):
        return "dia"
    itemsize = np.dtype(pars.dtype).itemsize
    if al.n_rows == al.n_cols and (
        al.n_rows * al.n_cols * itemsize <= pars.dense_level_bytes
    ):
        return "dense"
    if pars.use_well == "on" and al.n_rows >= pars.well_min_rows:
        return "well"
    return "ell"


def _level_from_csr(
    al: CSR,
    p: Optional[CSR],
    r: Optional[CSR],
    cfmark: Optional[np.ndarray],
    pad: int,
    pad_coarse: Optional[int],
    dtype: torch.dtype,
    pars: AMGParams,
    device,
    gs_key: Optional[np.ndarray] = None,
    is_coarse: bool = False,
) -> Level:
    fmt = _pick_format(al, pars)
    op_dtype = dtype if (not is_coarse or pars.coarse_op_dtype == "same") \
        else torch_dtype(pars.coarse_op_dtype)
    # per-row vectors are rounded to the solve dtype on the host, as in
    # amg_tpu (check_supported admits float32 and float64 only)
    np_dt = np.dtype(pars.dtype)
    ell_cols_np = ell_vals_np = None
    if fmt == "dia":
        a_dev = Dia.from_csr(al, dtype=op_dtype, pad_rows_to=pad,
                             device=device)
    elif fmt == "dense":
        a_dev = Dense.from_csr(al, dtype=op_dtype, pad_rows_to=pad,
                               pad_cols_to=pad, device=device)
    elif fmt == "well":
        a_dev = None   # packed below, once its GS classes are known
    else:
        ell_cols_np, ell_vals_np = Ell.pack_host(al, pad_rows_to=pad)
        a_dev = Ell(
            _to_device(ell_cols_np, torch.int64, device),
            _to_device(ell_vals_np, dtype, device),
            al.shape,
            al.nnz,
        )
    # transfer operators of a WEll level are WEll too (in
    # transfer_op_dtype), where their output length, which WEll pads to a
    # multiple of 1024, equals the level pad they feed
    tr_dtype = dtype if pars.transfer_op_dtype == "same" \
        else torch_dtype(pars.transfer_op_dtype)
    if p is not None and fmt == "well" and pad % 1024 == 0:
        p_ell = WEll.from_csr(p, dtype=tr_dtype, pad_rows_to=pad,
                              pad_cols_to=pad_coarse, device=device)
    elif p is not None:
        p_ell = Ell.from_csr(p, dtype=dtype, pad_rows_to=pad, device=device)
    else:
        p_ell = None
    if r is not None and fmt == "well" and pad_coarse is not None \
            and pad_coarse % 1024 == 0:
        r_ell = WEll.from_csr(r, dtype=tr_dtype, pad_rows_to=pad_coarse,
                              pad_cols_to=pad, device=device)
    elif r is not None:
        r_ell = Ell.from_csr(r, dtype=dtype, pad_rows_to=pad_coarse,
                             device=device)
    else:
        r_ell = None

    n = al.n_rows
    diag = np.zeros(pad)
    diag[:n] = al.diagonal_fast()
    inv_diag = np.where(np.abs(diag) > SMALLFLOAT,
                        1.0 / np.where(diag != 0, diag, 1.0), 0.0)

    l1 = np.zeros(pad)
    l1[:n] = _row_abs_sums(al)
    l1_inv = np.where(l1 > SMALLFLOAT, 1.0 / np.where(l1 != 0, l1, 1.0), 0.0)

    diag_mask = None
    groups_dev = None
    gid_dev = None
    ranges = None
    gs_w = None
    if fmt == "ell":
        # mark diagonal slots in the ELL layout (host-side numpy)
        row_ids = np.arange(a_dev.padded_rows)[:, None]
        diag_mask = _to_device((ell_cols_np == row_ids) & (ell_vals_np != 0),
                               torch.bool, device)
    if not _needs_groups(pars, is_coarse):
        group_cf = ()
    elif gs_key is not None and n and np.all(np.diff(gs_key) >= 0):
        # color-contiguous fast path: GS groups are row ranges
        # (level permuted by reorder_for_gs); key = color*2 + is_C
        bnd = np.flatnonzero(np.diff(gs_key)) + 1
        starts = np.concatenate([[0], bnd])
        ends = np.concatenate([bnd, [n]])
        ranges = tuple(
            (int(s), int(e - s)) for s, e in zip(starts, ends)
        )
        group_cf = [int(gs_key[s] % 2) for s in starts]
    elif fmt in ("dia", "dense", "well"):
        # gather-free masked GS path (full-operator product + class mask;
        # on WEll one class-update launch over the class's rows)
        groups, group_cf, gid = build_groups(al, cfmark, pad_to=pad)
        gid_dev = _to_device(gid, torch.int32, device)
        if fmt == "dia":
            gs_w = _gs_w_stack(np.asarray(gid, dtype=np.int32),
                               inv_diag.astype(np_dt), len(group_cf),
                               dtype, device)
    else:
        # gather-based group path (unpermuted ELL levels, e.g. level 0);
        # build_groups pads each group with the out-of-range index `pad`,
        # which is stripped here
        groups, group_cf, gid = build_groups(al, cfmark, pad_to=pad)
        groups_dev = tuple(_to_device(g[g < pad], torch.int64, device)
                           for g in np.asarray(groups, dtype=np.int64))

    if fmt == "well":
        # the derived layout groups its rows by GS class where the level
        # takes the masked path (gid), else keeps them in row order
        a_dev = WEll.from_csr(al, dtype=op_dtype, pad_rows_to=pad,
                              pad_cols_to=pad, device=device,
                              classes=gid_dev)

    # spectral radius of D^{-1} A (host power iteration; only the
    # Chebyshev/poly smoothers consume it).  The coarse-smoother override
    # applies on coarse levels, same as the cycle's dispatch.
    lvl_smoother = pars.smoother if (not is_coarse or
                                     pars.coarse_smoother is None) \
        else pars.coarse_smoother
    rho = 1.0
    if lvl_smoother in (SmootherType.POLY, SmootherType.CHEBYSHEV):
        rho = _rho_dinv_a_host(al)
    return Level(
        a=a_dev,
        p=p_ell,
        r=r_ell,
        diag=_to_device(diag.astype(np_dt), dtype, device),
        inv_diag=_to_device(inv_diag.astype(np_dt), dtype, device),
        l1_inv=_to_device(l1_inv.astype(np_dt), dtype, device),
        diag_mask=diag_mask,
        groups=groups_dev,
        gid=gid_dev,
        # amg_tpu keeps rho as a device scalar of the solve dtype
        rho_dinv_a=float(np.asarray(rho, dtype=np_dt)),
        group_cf=tuple(int(t) for t in group_cf),
        ranges=ranges,
        gs_w=gs_w,
    )


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it is a CUDA device
    and this machine has no card (there is no quiet fall to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda is not "
                           "available on this machine (pass device='cpu' "
                           "to run on the CPU)")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def to_device(hh: HostHierarchy, pars: AMGParams,
              device="cuda") -> Hierarchy:
    """Pack the host hierarchy into device tensors on ``device`` (the
    card unless the caller asks for the CPU)."""
    check_supported(pars)
    device = resolve_device(device)
    dtype = torch_dtype(pars.dtype)
    nl = hh.num_levels
    # dense levels pad to the 128 boundary (amg_tpu's lane-aligned pad),
    # WEll levels to the 1024-row group, others to 8 — the same pads as
    # amg_tpu so vectors compare entry for entry
    fmts = [_pick_format(m, pars) for m in hh.a]
    pads = [
        _round_up(max(m.n_rows, 1),
                  {"well": 1024, "dense": 128}.get(fmts[l], 8))
        for l, m in enumerate(hh.a)
    ]
    # a WEll level's R output is the child's vector: 1024-align the child
    # pad too so R can pack as WEll (the extra rows are padding)
    for l in range(1, nl):
        if fmts[l - 1] == "well" and fmts[l] != "dia":
            pads[l] = _round_up(pads[l], 1024)
    levels = []
    for l in range(nl):
        p = hh.p[l] if l < nl - 1 else None
        r = hh.r[l] if l < nl - 1 else None
        cf = hh.cfmark[l] if l < len(hh.cfmark) else None
        pad_coarse = pads[l + 1] if l < nl - 1 else None
        gs_key = hh.gs_key[l] if hh.gs_key is not None else None
        levels.append(
            _level_from_csr(hh.a[l], p, r, cf, pads[l], pad_coarse, dtype,
                            pars, device, gs_key=gs_key, is_coarse=l >= 1)
        )

    # dense inverse of the coarsest operator, by host LAPACK in the solve
    # dtype, stored and applied in the solve dtype
    ac = hh.a[-1]
    pad_c = pads[-1]
    inv_dtype = np.dtype(pars.dtype)
    try:
        inv = np.linalg.inv(ac.to_dense(inv_dtype))
    except np.linalg.LinAlgError:
        inv = np.linalg.pinv(ac.to_dense(inv_dtype))
    if not np.all(np.isfinite(inv)):
        inv = np.linalg.pinv(ac.to_dense(inv_dtype))
    full = np.zeros((pad_c, pad_c), dtype=inv_dtype)
    full[: ac.n_rows, : ac.n_cols] = inv
    coarse_inv = _to_device(full, dtype, device)
    return Hierarchy(levels=tuple(levels), coarse_inv=coarse_inv)


def setup(a: CSR, pars: AMGParams, log=print,
          hh: Optional[HostHierarchy] = None,
          device="cuda") -> tuple[Hierarchy, HostHierarchy]:
    """Full setup: host hierarchy + device pack on ``device`` (the card
    unless the caller asks for the CPU), with reference-format complexity
    table and timing print.

    Pass a pre-built (e.g. checkpoint-restored) ``hh`` to skip the host
    coarsening and go straight to the device pack.
    """
    check_supported(pars)
    device = resolve_device(device)
    if hh is None:
        hh = setup_host(a, pars, log=log)
    # hh.perms set => reorder_for_gs already ran on this hierarchy (e.g. a
    # checkpoint-restored one, saved post-reorder)
    if pars.reorder_gs and hh.perms is None:
        reorder_for_gs(hh, pars)
    elif pars.reorder_gs and hh.perms[0] is None:
        # a restored hierarchy written before level-0 reordering existed:
        # the coarse permutations are baked in, but a WEll level 0 still
        # needs its RCM pass
        reorder_l0_for_well(hh, pars)
    mg = to_device(hh, pars, device=device)
    if pars.verbose:
        log(complexity_print(hh))
        log(f"AMG setup time: {hh.setup_seconds:g} s")
    return mg, hh
