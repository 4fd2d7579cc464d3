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
for large unstructured levels (level 0 then RCM-ordered, coarse WEll
levels in barycentric order, P/R packed as WEll too), ``BandedBlocks``
for coarse levels whose RCM band fits the byte budget, ``Ell`` otherwise.
``use_well`` and ``use_banded`` on ``"auto"`` are on, as in ``amg_tpu``
on one device, which is what the port solves on (:func:`format_on`);
``use_banded="auto"`` then declines a band that reads at least the bytes
of the level's sparse pack, on rows short enough for kernel B2, and,
with ``use_well`` on, sends the level to WEll (:func:`reorder_for_gs`;
``"on"`` is ``amg_tpu``'s rule).  Fine-grid embedding
(:func:`embedding_plan`) keeps coarse levels ``1..E`` at their level-0
positions as Dia operators over level 0's pad; ``embed_levels=-1``
resolves to 0 (no embedding), as in ``amg_tpu`` off a TPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from . import tracing
from .params import AMGParams, CoarsenType, InterpType, MIN_CDOF, SMALLFLOAT
from .params import SmootherType
from .sparse import (CSR, Ell, Dia, Dense, BandedBlocks, WEll,
                     ROW_THREAD_MAX, SLICE_ROWS, _round_up, _to_device,
                     row_slices_bytes, torch_dtype)
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
    (masked-colour GS through the WEll kernel), :class:`BandedBlocks` when
    its RCM band fits, and :class:`Ell` otherwise.  A fine-grid-embedded
    level is Dia with Dia P/R, all at level 0's pad.
    """

    a: object                   # Dia | Dense | WEll | BandedBlocks | Ell
    p: Optional[object]         # prolongation from level l+1 to l
    r: Optional[object]         # restriction  from level l to l+1
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
    # the embedded -> compact boundary, set on the deepest embedded level E
    # (int64 row positions in the embedded index space, only the valid
    # prefix: amg_tpu pads these with the out-of-range value pad0, which
    # JAX clamps or drops and torch would reject).  compact_idx: where the
    # next level's rows sit (embedded P_E/R_E); member_idx: where this
    # level's own rows sit (compact Ell P_E/R_E on short vectors)
    compact_idx: Optional[torch.Tensor] = None
    member_idx: Optional[torch.Tensor] = None

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
    # the KRYLOV coarsest solves made on this hierarchy, by right-hand
    # side shape, dtype, device and tolerance, the last one per number of
    # dimensions (solve.cycle.krylov_solver)
    krylov: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

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
    # per level: block half-bandwidth when the level was RCM-ordered for
    # the BandedBlocks format (None -> not banded)
    banded_nb: Optional[list] = None
    # per level: the device format reorder_for_gs chose ("dia", "dense",
    # "well", "ell" or "banded"); None -> :func:`level_formats` derives
    # it (a hierarchy not reordered, or one restored from a checkpoint
    # written without it)
    formats: Optional[list] = None

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
    """Raise ``NotImplementedError`` for options of ``amg_tpu`` that the
    port does not implement yet: cycles in a dtype other than float32 and
    float64."""
    if pars.dtype not in ("float32", "float64"):
        raise NotImplementedError(f"dtype={pars.dtype!r}: the port cycles in "
                                  "float32 or float64")


def format_on(flag: str) -> bool:
    """``use_well`` / ``use_banded`` resolved: ``amg_tpu`` turns ``"auto"``
    on when ``jax.device_count() == 1 or dist_devices > 1``
    (``amg_tpu/hierarchy.py:305-308, 965-968``), and the port solves on
    one device or on a ring of ``dist_devices`` shards."""
    return flag in ("on", "auto")


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------


def setup_host(a: CSR, pars: AMGParams, log=print,
               device="cuda") -> HostHierarchy:
    """Build the CSR hierarchy on the host.

    Control flow and warnings replicate ``SSS_amg_setup``
    (amg/Setup/SSS_SETUP.cu:69-155) including its four break checks.
    PMIS runs the host splitter below 262,144 rows and the device one
    (``cf_split.pmis_split_device``, on ``device``: the card unless the
    caller asks for the CPU) from there on, as ``amg_tpu`` does.
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
                # big graphs: the rounds on the device
                if al.n_rows >= 262_144:
                    from .setup_phase import cf_split

                    vec, col = cf_split.pmis_split_device(s, device=device)
                else:
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


def _coarse_itemsize(pars: AMGParams) -> int:
    """Bytes per value of the coarse-level operators (through torch:
    without JAX's ml_dtypes numpy knows no bfloat16)."""
    return torch_dtype(pars.dtype if pars.coarse_op_dtype == "same"
                       else pars.coarse_op_dtype).itemsize


def _sparse_bytes(al: CSR, pars: AMGParams, well: bool) -> int:
    """Bytes one product of coarse level ``al`` reads on the sparse pack
    it takes without a band: kernel B2's count (:func:`~.sparse.
    row_slices_bytes`) on a WEll pack (``well``; one slot row per row, as
    no pack exists yet), else the gather product's on an Ell pack (int64
    columns and values in the solve dtype over ``width`` slots a row, x
    and y once)."""
    n = al.n_rows
    xb = np.dtype(pars.dtype).itemsize
    if well:
        return row_slices_bytes(al.nnz, _coarse_itemsize(pars),
                                -(-n // SLICE_ROWS), al.n_cols, n, xb)
    width = max(int(al.row_degrees.max()) if n else 1, 1)
    return _round_up(max(n, 1), 8) * width * (xb + 8) + (al.n_cols + n) * xb


def _declines_band(al: CSR, pars: AMGParams, band_bytes: int,
                   well: bool) -> bool:
    """Whether ``use_banded="auto"`` turns down a band of ``band_bytes``
    on coarse level ``al`` for the sparse pack the level takes without
    one (WEll where ``well``, else Ell): where the band reads at least the
    pack's bytes (:func:`_sparse_bytes`), and, for WEll, the level's
    longest row is one that B2's one thread a row reads at the pace of
    its bytes (:data:`~.sparse.ROW_THREAD_MAX`)."""
    if well and al.n_rows and int(al.row_degrees.max()) > ROW_THREAD_MAX:
        return False
    return band_bytes >= _sparse_bytes(al, pars, well)


def reorder_for_gs(hh: HostHierarchy, pars: AMGParams,
                   skip_levels: int = 0) -> HostHierarchy:
    """Reorder levels for the device formats (in place).

    Level 0 is RCM-ordered when it is headed for the WEll format
    (:func:`reorder_l0_for_well`), unless ``skip_levels > 0``: levels
    ``1..skip_levels`` are fine-grid embedded (:func:`embedding_plan`) and
    keep the ordering the plan was made on, level 0 included.  Each coarse
    level ``l > skip_levels`` not destined for the Dia format is then
    permuted:

    * with ``use_banded`` on, an Ell, Dense or WEll level other than the
      coarsest is RCM-ordered for the BandedBlocks format when its band
      fits ``banded_level_bytes`` (and, against WEll, costs at most 40 B
      per nonzero; against Dense, at most half the square); an Ell level
      whose band overshoots is clipped to the widest band that fits
      (:func:`clip_to_band`) when at most ``banded_clip_frac`` of its
      entries fall outside.  That is ``amg_tpu``'s rule, and ``"on"``'s.
      ``"auto"`` keeps such a band unless it reads at least the bytes of
      the sparse pack the level takes without one (:func:`_declines_band`:
      WEll with ``use_well`` on, where the level's rows are short enough
      for B2, else Ell; a Dense level keeps the rule of "on" when
      ``use_well`` is off), and counts each band it declines in
      ``amg.setup.banded_declined`` (bytes: the band's); with
      ``use_well`` on, a declined Ell or Dense level packs as WEll.
      ``hh.formats`` keeps each level's format;
    * otherwise a WEll level into barycentric order
      (:func:`_barycentric_order`), which keeps its slot windows local;
      its GS runs masked;
    * otherwise, when a GS-family smoother runs on it, by ``(color,
      C/F)`` so every multicolor-GS class is a contiguous row range.

    Each permutation is a similarity transform (``P A P^T`` plus matching
    P/R/cfmark updates), so the hierarchy's numerics are unchanged; only
    the clipping changes the operator (row sums preserved).
    """
    from .params import CGPT
    from .setup_phase.coloring import color_graph

    banded_on = format_on(pars.use_banded)
    by_bytes = pars.use_banded == "auto"
    well_on = format_on(pars.use_well)
    op_itemsize = _coarse_itemsize(pars)

    nl = hh.num_levels
    hh.gs_key = [None] * nl
    hh.perms = [None] * nl
    hh.banded_nb = [None] * nl
    hh.formats = [_pick_format(al, pars) for al in hh.a]
    if skip_levels == 0:
        reorder_l0_for_well(hh, pars)
    for l in range(max(1, skip_levels + 1), nl):
        al = hh.a[l]
        fmt_l = hh.formats[l]
        if fmt_l == "dia":
            continue
        n = al.n_rows

        perm = None
        clip_nb = None
        if banded_on and fmt_l in ("ell", "dense", "well") and l < nl - 1:
            import scipy.sparse as sp
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            m = sp.csr_matrix((al.data, al.indices, al.indptr),
                              shape=al.shape)
            rcm = np.asarray(
                reverse_cuthill_mckee(m, symmetric_mode=True),
                dtype=np.int64,
            )
            al_rcm = al.permute(rcm)
            nb = BandedBlocks.block_bandwidth(al_rcm)
            nbr = _round_up(max(n, 1), 128) // 128
            per_w = nbr * 128 * 128 * op_itemsize   # one block diagonal
            band_bytes = per_w * (2 * nb + 1)
            dense_bytes = (nbr * 128) ** 2 * op_itemsize
            keep_nb = None
            if band_bytes <= pars.banded_level_bytes and (
                fmt_l == "ell"
                or (fmt_l == "well" and band_bytes <= 40 * al.nnz)
                or (fmt_l == "dense" and 2 * band_bytes <= dense_bytes)
            ):
                keep_nb = nb
            elif pars.banded_clip_frac > 0 and fmt_l == "ell":
                # the band overshoots the budget: clip at the largest nb
                # that fits and lump the out-of-band tail into the
                # diagonal, if that tail is a small fraction of nnz
                nb_fit = int((pars.banded_level_bytes / per_w - 1) // 2)
                if nb_fit >= 1:
                    bd = np.abs((al_rcm.indices.astype(np.int64) >> 7)
                                - (al_rcm.row_indices >> 7))
                    frac = float(np.count_nonzero(bd > nb_fit)) \
                        / max(al_rcm.nnz, 1)
                    if frac <= pars.banded_clip_frac:
                        keep_nb = clip_nb = nb_fit
            if keep_nb is not None and by_bytes and (fmt_l != "dense"
                                                     or well_on):
                kept = per_w * (2 * keep_nb + 1)
                if _declines_band(al, pars, kept,
                                  well_on or fmt_l == "well"):
                    tracing.count("amg.setup.banded_declined", kept)
                    keep_nb = clip_nb = None
                    if well_on:
                        fmt_l = hh.formats[l] = "well"
            if keep_nb is not None:
                perm = rcm
                hh.banded_nb[l] = keep_nb
                hh.formats[l] = "banded"

        if perm is None and fmt_l == "well":
            # order rows for slot-window locality (not by color): each
            # unknown at its interpolation barycenter in the parent level
            perm = _barycentric_order(hh.p[l - 1])
        elif perm is None:
            if not _needs_groups(pars, True):
                # no GS-family smoother on this level: the color-contiguous
                # permutation (and the coloring itself) buys nothing
                continue
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
        if clip_nb is not None:
            hh.a[l] = clip_to_band(hh.a[l], clip_nb)
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
    if hh.formats is not None:
        hh.formats[0] = "well"
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


def clip_to_band(a: CSR, nb: int) -> CSR:
    """Drop entries outside the block band ``|block(j) - block(i)| <= nb``
    and lump them into the diagonal (row sums preserved), for an RCM band
    that slightly overshoots the BandedBlocks byte budget."""
    n = a.n_rows
    rows = a.row_indices
    cols = a.indices.astype(np.int64)
    keep = np.abs((cols >> 7) - (rows >> 7)) <= nb
    lump = np.bincount(rows[~keep], weights=a.data[~keep], minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.bincount(rows[keep], minlength=n)
    np.cumsum(indptr, out=indptr)
    data = a.data[keep].copy()
    new_cols = cols[keep].astype(np.int32)
    kept_rows = rows[keep]
    is_diag = new_cols == kept_rows
    data[is_diag] += lump[kept_rows[is_diag]]
    return CSR(indptr, new_cols, data, a.shape)


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
    when ``use_well`` is on (:func:`format_on`); padded-ELL gathers
    otherwise.  (``reorder_for_gs`` may then turn an Ell, Dense or WEll
    level into BandedBlocks, or an Ell or Dense level into WEll.)
    """
    if _use_dia(al, pars):
        return "dia"
    itemsize = np.dtype(pars.dtype).itemsize
    if al.n_rows == al.n_cols and (
        al.n_rows * al.n_cols * itemsize <= pars.dense_level_bytes
    ):
        return "dense"
    if format_on(pars.use_well) and al.n_rows >= pars.well_min_rows:
        return "well"
    return "ell"


# ---------------------------------------------------------------------------
# Fine-grid embedding of coarse levels
#
# Coarse unknowns keep their level-0 grid positions: every coarse operator
# of levels 1..E becomes a diagonal-offset stencil (Dia) over level 0's pad,
# so those levels' products and transfers run through the DIA kernel with
# no gathers.  Coarse vectors are fine-grid length with zeros at non-member
# positions (zero inverse diagonals keep the smoothers exact there).
# Embedding stops when a stencil outgrows `embed_max_diags` or the byte
# budget; deeper levels use compact formats, with one gather/scatter pair
# at the boundary.  The same plan as amg_tpu's (hierarchy.py:490-803).
# ---------------------------------------------------------------------------


# good_pad's tiles: amg_tpu's DIA kernel tile (amg_tpu/ops/pallas_dia.py:
# 37-41) and the candidate tiles, largest first, that the shared embedded
# pad is rounded to
TILE = 4096
TILES = (81920, 40960, 20480, 8192, TILE)


def good_pad(n: int, max_overhead: float = 0.025) -> int:
    """``amg_tpu.ops.pallas_dia.good_pad``: the padding of ``n`` rows to
    the largest of :data:`TILES` within a relative overhead of
    ``max_overhead``, else to a multiple of :data:`TILE`.  The shared
    embedded pad takes it, so that the port's level pads equal
    ``amg_tpu``'s."""
    best = ((n + TILE - 1) // TILE) * TILE
    for t in TILES:
        p = ((n + t - 1) // t) * t
        if n > 0 and (p - n) / n <= max_overhead:
            return p
    return best


def _embed_csr(m: CSR, row_emb: np.ndarray, col_emb: np.ndarray,
               n0: int) -> CSR:
    """Re-index a compact operator into the fine (level-0) index space."""
    deg = m.row_degrees
    cols = col_emb[m.indices.astype(np.int64)]
    if m.n_rows == 0 or np.all(np.diff(row_emb) > 0):
        # row map strictly increasing (embedding positions are sorted
        # C-point lists): rows stay in CSR order, so build the row pointer
        # directly instead of sorting the entries
        indptr = np.zeros(n0 + 1, dtype=np.int64)
        indptr[row_emb.astype(np.int64) + 1] = deg
        np.cumsum(indptr, out=indptr)
        return CSR(indptr, cols.astype(np.int32), m.data.copy(), (n0, n0))
    return CSR.from_coo(row_emb[m.row_indices], cols, m.data, (n0, n0))


def _embedded_offset_hist(m: CSR, row_emb, col_emb, cache=None):
    """(off_lo, uniq) histogram of embedded (col - row) offsets, memoized
    in ``cache`` (keyed by object identity, stable within one setup): the
    plan counts them for every candidate operator and the pack needs the
    same histogram again."""
    key = (id(m), id(row_emb), id(col_emb))
    if cache is not None and key in cache:
        return cache[key]
    rows = m.row_indices
    off = col_emb[m.indices] - row_emb[rows]
    if len(off) == 0:
        hist = (0, np.zeros(0, dtype=np.int64))
    else:
        lo = int(off.min())
        uniq = np.flatnonzero(np.bincount(off - lo)) + lo
        hist = (lo, uniq)
    if cache is not None:
        cache[key] = hist
    return hist


def _num_offsets_embedded(m: CSR, row_emb, col_emb, cache=None) -> int:
    return len(_embedded_offset_hist(m, row_emb, col_emb, cache)[1])


def _embed_csr_cached(m: CSR, row_emb, col_emb, n0: int, cache) -> CSR:
    """:func:`_embed_csr`, with the result's (col - row) histogram seeded
    from the plan's cache so that ``Dia.from_csr`` skips its recount."""
    out = _embed_csr(m, row_emb, col_emb, n0)
    out._off_hist_cache = (
        out.nnz, _embedded_offset_hist(m, row_emb, col_emb, cache))
    return out


def resolved_embed_levels(pars: AMGParams) -> int:
    """``pars.embed_levels`` with -1 (auto) resolved to 0.  ``amg_tpu``
    embeds under auto on a TPU only (``amg_tpu/hierarchy.py:564-578``);
    whether embedding pays on the card is measured before auto turns it
    on (``PERF.md``), so explicit ``embed_levels > 0`` are taken as
    given."""
    return pars.embed_levels if pars.embed_levels >= 0 else 0


def embedding_plan(hh: HostHierarchy, pars: AMGParams):
    """Decide how deep the fine-grid embedding goes.

    Returns ``(E, emb, boundary)`` where ``emb[l]`` maps level-l rows to
    level-0 positions, levels ``1..E`` (plus level 0's P/R) are embedded,
    and ``boundary`` is how level E hands off to the compact levels:
    ``"embedded"`` (fine-grid P_E/R_E) or ``"compact"`` (compact the
    residual first, then small Ell P/R; only A_E needs the embedded
    array).  ``E = 0`` means no embedding.
    """
    from .params import CGPT
    from .setup_phase.coloring import color_graph

    nl = hh.num_levels
    n0 = hh.a[0].n_rows
    hist_cache = hh.__dict__.setdefault("_emb_hist", {})
    emb = [np.arange(n0, dtype=np.int64)]
    for cf in hh.cfmark:
        if cf is None:
            # aggregation levels: coarse unknowns are aggregates, not
            # fine-grid points
            return 0, emb, None
        cpos = np.flatnonzero(np.asarray(cf) == CGPT)
        emb.append(emb[len(emb) - 1][cpos])

    embed_levels = resolved_embed_levels(pars)
    if embed_levels <= 0 or nl < 2:
        return 0, emb, None
    # level 0 must itself be a banded (Dia) operator for stencil embedding
    if _pick_format(hh.a[0], pars) != "dia":
        return 0, emb, None

    itemsize = _coarse_itemsize(pars)
    budget = pars.embed_max_bytes
    # with a Gauss-Seidel-family smoother a masked sweep on an embedded
    # level costs n_colors full operator passes: cap n_groups * n_diags
    coarse_sm = pars.coarse_smoother or pars.smoother
    gs_like = coarse_sm in (
        SmootherType.GS, SmootherType.SGS, SmootherType.SOR,
        SmootherType.SSOR, SmootherType.GSOR, SmootherType.SGSOR,
    )
    gs_cap = 1500

    E = 0
    spent = 0.0
    # level l is embeddable if A_l, P_{l-1}, R_{l-1} all stay within the
    # stencil cap; the coarsest level always stays compact (dense inverse)
    for l in range(1, min(embed_levels + 1, nl - 1)):
        if l >= len(emb):
            break
        nd_a = _num_offsets_embedded(hh.a[l], emb[l], emb[l], hist_cache)
        nd_p = _num_offsets_embedded(hh.p[l - 1], emb[l - 1], emb[l],
                                     hist_cache)
        nd_r = _num_offsets_embedded(hh.r[l - 1], emb[l], emb[l - 1],
                                     hist_cache)
        if max(nd_a, nd_p, nd_r) > pars.embed_max_diags:
            break
        if gs_like:
            colors = color_graph(hh.a[l])
            ngroups = (int(colors.max()) + 1 if len(colors) else 1) * 2
            if ngroups * nd_a > gs_cap:
                break
        cost = (nd_a + nd_p + nd_r) * n0 * itemsize
        if spent + cost > budget:
            break
        spent += cost
        E = l
    boundary = None
    if E >= 1:
        # the boundary level needs either embedded P_E/R_E ((nd_p + nd_r)
        # * n0 bytes) or the compact handoff (small gather + compact Ell
        # P/R, no extra embedded arrays)
        nd_p = _num_offsets_embedded(hh.p[E], emb[E], emb[E + 1], hist_cache)
        nd_r = _num_offsets_embedded(hh.r[E], emb[E + 1], emb[E], hist_cache)
        cost = (nd_p + nd_r) * n0 * itemsize
        emb_fits = (max(nd_p, nd_r) <= pars.embed_max_diags
                    and spent + cost <= budget)
        if pars.embed_boundary == "compact":
            boundary = "compact"
        elif emb_fits:
            boundary = "embedded"
        elif pars.embed_boundary == "auto":
            boundary = "compact"
        else:  # forced "embedded" but it doesn't fit: shrink the embedding
            E -= 1
            boundary = "embedded" if E >= 1 else None
    return E, emb, boundary


def _embedded_level(hh: HostHierarchy, l: int, E: int, emb: list,
                    pad0: int, pad_next: Optional[int], dtype: torch.dtype,
                    pars: AMGParams, device,
                    boundary: str = "embedded") -> Level:
    """Build a fine-grid-embedded device level (A, P and R all Dia over
    ``pad0``; at the compact boundary Ell P/R and ``member_idx``)."""
    al = hh.a[l]
    n0 = hh.a[0].n_rows
    nl = hh.num_levels
    rl = emb[l]
    np_dt = np.dtype(pars.dtype)
    coarse_dt = dtype if pars.coarse_op_dtype == "same" \
        else torch_dtype(pars.coarse_op_dtype)
    hist_cache = hh.__dict__.setdefault("_emb_hist", {})

    if l == 0:
        if _pick_format(al, pars) != "dia":
            raise ValueError("embedded hierarchy requires a banded A_0")
        a_dev = Dia.from_csr(al, dtype=dtype, pad_rows_to=pad0,
                             device=device)
    else:
        a_emb = _embed_csr_cached(al, rl, rl, n0, hist_cache)
        a_dev = Dia.from_csr(a_emb, dtype=coarse_dt, pad_rows_to=pad0,
                             device=device)

    p_dev = r_dev = None
    compact_idx = None
    member_idx = None
    if l == E and l < nl - 1 and boundary == "compact":
        # compact handoff: the cycle gathers the residual at this level's
        # member positions, applies compact Ell R/P on short vectors and
        # scatter-adds the prolonged correction back
        pad_self = _round_up(max(al.n_rows, 1), 8)
        p_dev = Ell.from_csr(hh.p[l], dtype=dtype, pad_rows_to=pad_self,
                             device=device)
        r_dev = Ell.from_csr(hh.r[l], dtype=dtype, pad_rows_to=pad_next,
                             device=device)
        member_idx = _to_device(rl, torch.int64, device)
    elif l < nl - 1:
        cl = emb[l + 1]
        p_emb = _embed_csr_cached(hh.p[l], rl, cl, n0, hist_cache)
        r_emb = _embed_csr_cached(hh.r[l], cl, rl, n0, hist_cache)
        p_dev = Dia.from_csr(p_emb, dtype=coarse_dt, pad_rows_to=pad0,
                             device=device)
        r_dev = Dia.from_csr(r_emb, dtype=coarse_dt, pad_rows_to=pad0,
                             device=device)
        if l == E:
            # the next (compact) level's rows at their embedded positions
            compact_idx = _to_device(cl, torch.int64, device)

    n = al.n_rows
    diag_c = al.diagonal_fast()
    diag = np.zeros(pad0)
    diag[rl] = diag_c
    inv_diag = np.zeros(pad0)
    nz = np.abs(diag_c) > SMALLFLOAT
    inv_diag[rl[nz]] = 1.0 / diag_c[nz]

    l1_c = _row_abs_sums(al)
    l1_inv = np.zeros(pad0)
    nz1 = l1_c > SMALLFLOAT
    l1_inv[rl[nz1]] = 1.0 / l1_c[nz1]

    cfmark = hh.cfmark[l] if l < len(hh.cfmark) else None
    gs_w = None
    gid_dev = None
    group_cf = ()
    if _needs_groups(pars, l >= 1):
        _, group_cf, gid_c = build_groups(al, cfmark, pad_to=pad0)
        gid = np.full(pad0, -1, dtype=np.int32)
        gid[rl] = gid_c[:n]
        gid_dev = _to_device(gid, torch.int32, device)
        if l == 0:
            # fused-GS weights on level 0 only: every embedded level
            # shares pad0, so deeper stacks would each cost n_groups *
            # pad0 values of device memory
            gs_w = _gs_w_stack(gid, inv_diag.astype(np_dt), len(group_cf),
                               dtype, device)

    lvl_smoother = pars.smoother if (l == 0 or pars.coarse_smoother is None) \
        else pars.coarse_smoother
    rho = 1.0
    if lvl_smoother in (SmootherType.POLY, SmootherType.CHEBYSHEV):
        rho = _rho_dinv_a_host(al)
    return Level(
        a=a_dev,
        p=p_dev,
        r=r_dev,
        diag=_to_device(diag.astype(np_dt), dtype, device),
        inv_diag=_to_device(inv_diag.astype(np_dt), dtype, device),
        l1_inv=_to_device(l1_inv.astype(np_dt), dtype, device),
        diag_mask=None,
        groups=None,
        gid=gid_dev,
        rho_dinv_a=float(np.asarray(rho, dtype=np_dt)),
        group_cf=tuple(int(t) for t in group_cf),
        ranges=None,
        gs_w=gs_w,
        compact_idx=compact_idx,
        member_idx=member_idx,
    )


def level_formats(hh: HostHierarchy, pars: AMGParams) -> list:
    """The device format each host level packs as: ``hh.formats``, which
    :func:`reorder_for_gs` chose, else ``"banded"`` where a band was kept
    and :func:`_pick_format`'s elsewhere."""
    if hh.formats is not None:
        return list(hh.formats)
    return ["banded" if hh.banded_nb is not None
            and hh.banded_nb[l] is not None else _pick_format(m, pars)
            for l, m in enumerate(hh.a)]


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
    fmt: str,
    gs_key: Optional[np.ndarray] = None,
    is_coarse: bool = False,
    banded_nb: Optional[int] = None,
) -> Level:
    op_dtype = dtype if (not is_coarse or pars.coarse_op_dtype == "same") \
        else torch_dtype(pars.coarse_op_dtype)
    # per-row vectors are rounded to the solve dtype on the host, as in
    # amg_tpu (check_supported admits float32 and float64 only)
    np_dt = np.dtype(pars.dtype)
    ell_cols_np = ell_vals_np = None
    if fmt == "dia":
        a_dev = Dia.from_csr(al, dtype=op_dtype, pad_rows_to=pad,
                             device=device)
    elif fmt == "banded":
        a_dev = BandedBlocks.from_csr(al, dtype=op_dtype, nb=banded_nb,
                                      pad_rows_to=pad, device=device)
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
                              pad_cols_to=pad_coarse, device=device,
                              ring_devices=pars.dist_devices)
    elif p is not None:
        p_ell = Ell.from_csr(p, dtype=dtype, pad_rows_to=pad, device=device)
    else:
        p_ell = None
    if r is not None and fmt == "well" and pad_coarse is not None \
            and pad_coarse % 1024 == 0:
        r_ell = WEll.from_csr(r, dtype=tr_dtype, pad_rows_to=pad_coarse,
                              pad_cols_to=pad, device=device,
                              ring_devices=pars.dist_devices)
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
    elif fmt in ("dia", "dense", "banded", "well"):
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
                              classes=gid_dev,
                              ring_devices=pars.dist_devices)

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


def to_device(hh: HostHierarchy, pars: AMGParams, device="cuda",
              plan=None) -> Hierarchy:
    """Pack the host hierarchy into device tensors on ``device`` (the
    card unless the caller asks for the CPU), following ``plan`` (from
    :func:`embedding_plan`, computed here when not given)."""
    check_supported(pars)
    device = resolve_device(device)
    dtype = torch_dtype(pars.dtype)
    nl = hh.num_levels
    if plan is None:
        plan = embedding_plan(hh, pars)
    E, emb, boundary = plan
    # the first compact level may have been permuted after the plan was
    # made: carry its permutation into its fine-position map, so that the
    # boundary operators (P_E/R_E, compact_idx) index it correctly
    if E >= 1 and hh.perms is not None and E + 1 < nl \
            and hh.perms[E + 1] is not None:
        emb = list(emb)
        emb[E + 1] = emb[E + 1][hh.perms[E + 1]]
    # dense and banded levels pad to the 128 boundary, WEll levels to the
    # 1024-row group, others to 8, embedded levels share level 0's pad —
    # the same pads as amg_tpu so vectors compare entry for entry.  For a
    # ring of D = dist_devices > 1 shards every pad splits into D equal
    # shards of whole granules (amg_tpu/hierarchy.py:1319-1347)
    fmts = level_formats(hh, pars)
    D = max(pars.dist_devices, 1)
    pads = [
        _round_up(max(m.n_rows, 1), D * {"well": 1024, "dense": 128,
                                         "banded": 128}.get(fmts[l], 8))
        for l, m in enumerate(hh.a)
    ]
    # a WEll level's R output is the child's vector: 1024-align the child
    # pad too so R can pack as WEll (the extra rows are padding)
    for l in range(1, nl):
        if fmts[l - 1] == "well" and fmts[l] != "dia":
            pads[l] = _round_up(pads[l], D * 1024)
    pad0 = pads[0]
    if E >= 1 and hh.a[0].n_rows >= 65536:
        # amg_tpu rounds the shared embedded pad to its kernel's tiles
        pad0 = good_pad(pad0)
        pads[0] = pad0
    for l in range(1, E + 1):
        pads[l] = pad0
    timers = _setup_timers()
    levels = []
    for l in range(nl):
        with _phase("amg.setup.pack_level", timers, device) as sp:
            if E >= 1 and l <= E:
                pad_next = pads[l + 1] if l < nl - 1 else None
                levels.append(_embedded_level(hh, l, E, emb, pad0, pad_next,
                                              dtype, pars, device,
                                              boundary=boundary))
            else:
                p = hh.p[l] if l < nl - 1 else None
                r = hh.r[l] if l < nl - 1 else None
                cf = hh.cfmark[l] if l < len(hh.cfmark) else None
                pad_coarse = pads[l + 1] if l < nl - 1 else None
                gs_key = hh.gs_key[l] if hh.gs_key is not None else None
                levels.append(
                    _level_from_csr(hh.a[l], p, r, cf, pads[l], pad_coarse,
                                    dtype, pars, device, fmts[l],
                                    gs_key=gs_key, is_coarse=l >= 1,
                                    banded_nb=(hh.banded_nb[l]
                                               if hh.banded_nb is not None
                                               else None))
                )
        if timers:
            _timer_line(f"  pack level {l}", sp)

    # dense inverse of the coarsest operator, by host LAPACK in the solve
    # dtype, stored and applied in the solve dtype
    ac = hh.a[-1]
    pad_c = pads[-1]
    inv_dtype = np.dtype(pars.dtype)
    with _phase("amg.setup.coarse_inv", timers, device) as sp:
        try:
            inv = np.linalg.inv(ac.to_dense(inv_dtype))
        except np.linalg.LinAlgError:
            inv = np.linalg.pinv(ac.to_dense(inv_dtype))
        if not np.all(np.isfinite(inv)):
            inv = np.linalg.pinv(ac.to_dense(inv_dtype))
        full = np.zeros((pad_c, pad_c), dtype=inv_dtype)
        full[: ac.n_rows, : ac.n_cols] = inv
        coarse_inv = _to_device(full, dtype, device)
    if timers:
        _timer_line("  pack coarse inverse", sp)
    return Hierarchy(levels=tuple(levels), coarse_inv=coarse_inv)


def _setup_timers() -> bool:
    """``AMG_SETUP_TIMERS=1``: the pack prints each level's seconds to
    stderr and :func:`setup` logs its phases (``amg_tpu``'s labels), each
    read from its set-up span after the card's queued work is done."""
    return os.environ.get("AMG_SETUP_TIMERS", "0") == "1"


@contextlib.contextmanager
def _phase(name, timers: bool, device):
    """A set-up span; with ``timers`` it ends once the card's queued work
    is done, so that its reading holds that work."""
    with tracing.span(name) as sp:
        yield sp
        if timers and device.type == "cuda":
            torch.cuda.synchronize(device)


def _timer_line(label, sp):
    print(f"{label}: {sp.seconds:.2f}s", file=sys.stderr, flush=True)


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
    timers = _setup_timers()
    with _phase("amg.setup.host", timers, device) as host:
        if hh is None:
            hh = setup_host(a, pars, log=log, device=device)
    # amg_tpu's order: the embedding plan on the unpermuted hierarchy, the
    # reordering of the levels below the embedded ones, then the pack
    with _phase("amg.setup.plan", timers, device) as plan_s:
        plan = embedding_plan(hh, pars)
    with _phase("amg.setup.reorder", timers, device) as reorder:
        # hh.perms set => reorder_for_gs already ran on this hierarchy
        # (e.g. a checkpoint-restored one, saved post-reorder)
        if pars.reorder_gs and hh.perms is None:
            reorder_for_gs(hh, pars, skip_levels=plan[0])
        elif pars.reorder_gs and hh.perms is not None \
                and hh.perms[0] is None and plan[0] == 0:
            # a restored hierarchy written before level-0 reordering
            # existed: the coarse permutations are baked in, but a WEll
            # level 0 still needs its RCM pass
            reorder_l0_for_well(hh, pars)
    with _phase("amg.setup.pack", timers, device) as pack:
        mg = to_device(hh, pars, device=device, plan=plan)
    if timers:
        log(f"setup phases: host {host.seconds:.2f}s, "
            f"plan {plan_s.seconds:.2f}s, reorder {reorder.seconds:.2f}s, "
            f"pack {pack.seconds:.2f}s")
    if pars.verbose:
        log(complexity_print(hh))
        log(f"AMG setup time: {hh.setup_seconds:g} s")
    return mg, hh
