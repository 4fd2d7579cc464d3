"""C/F splitting.

* :func:`rs_split` — classical Ruge-Stueben greedy splitting with the C1
  second pass.  Behavioral replica of the reference's ``cfsplitting_cls``
  (amg/Setup/SSS_coarsen.c:294-498): same measures (in-degree of S), same
  bucket-FIFO tie-breaking, same update order, so it produces the same C/F
  partition the reference does.  Runs on the host; the greedy loop is
  inherently sequential (SURVEY.md "hard parts" #2).  A C++ fast path is
  used when the native extension is built.

* :func:`clean_ff_couplings` — Falgout-style F-F fixup used before direct
  interpolation (reference amg/Setup/SSS_coarsen.c:501-574).

* :func:`pmis_split` — parallel-friendly PMIS splitting (vectorized numpy,
  trivially portable to the device) for pod-scale problems where the greedy
  queue would be the bottleneck.  No reference equivalent; TPU-native
  addition.

* :func:`pmis_split_device` — the same rounds in torch on a device
  (``amg_tpu``'s JAX routine, which its setup runs from 262,144 rows).
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import FGPT, CGPT, ISPT, UNPT
from ..sparse import CSR


class _BucketQueue:
    """Bucket priority queue with FIFO order inside each bucket.

    Matches the ordering semantics of the reference's doubly-linked
    measure-bucket list (enter_list/remove_node, amg/Setup/SSS_coarsen.c:22-292):
    insertion appends at the bucket tail, extraction takes the head of the
    highest-measure bucket.
    """

    def __init__(self, n: int):
        self.nxt = np.full(n, -1, dtype=np.int64)
        self.prv = np.full(n, -1, dtype=np.int64)
        self.head: dict[int, int] = {}
        self.tail: dict[int, int] = {}
        self.cur_max = -1

    def push(self, i: int, measure: int) -> None:
        t = self.tail.get(measure, -1)
        self.prv[i] = t
        self.nxt[i] = -1
        if t >= 0:
            self.nxt[t] = i
        else:
            self.head[measure] = i
        self.tail[measure] = i
        if measure > self.cur_max:
            self.cur_max = measure

    def remove(self, i: int, measure: int) -> None:
        p, nx = self.prv[i], self.nxt[i]
        if p >= 0:
            self.nxt[p] = nx
        else:
            if nx >= 0:
                self.head[measure] = nx
            else:
                del self.head[measure]
                del self.tail[measure]
        if nx >= 0:
            self.prv[nx] = p
        else:
            if p >= 0:
                self.tail[measure] = p
        self.prv[i] = self.nxt[i] = -1

    def pop_max(self) -> int:
        while self.cur_max >= 0 and self.cur_max not in self.head:
            self.cur_max -= 1
        if self.cur_max < 0:
            # exhausted — pick any remaining bucket (shouldn't happen)
            if not self.head:
                return -1
            self.cur_max = max(self.head)
        i = self.head[self.cur_max]
        self.remove(i, self.cur_max)
        return i


def rs_split(s: CSR) -> tuple[np.ndarray, int]:
    """Classical RS splitting on strength pattern ``s``.

    Returns ``(vec, n_coarse)`` where ``vec[i]`` is FGPT/CGPT/ISPT and
    ``n_coarse`` counts C points (reference returns this as ``col``).
    """
    try:
        from ..native import lib as _native
    except Exception:
        _native = None
    if _native is not None:
        return _native.rs_split(s)
    return _rs_split_py(s)


def _rs_split_py(s: CSR) -> tuple[np.ndarray, int]:
    n = s.n_rows
    sp, sj = s.indptr, s.indices
    st = s.transpose()
    tp, tj = st.indptr, st.indices

    lam = (tp[1:] - tp[:-1]).astype(np.int64).copy()   # in-degree of S
    vec = np.full(n, UNPT, dtype=np.int64)
    isolated = sp[1:] == sp[:-1]
    vec[isolated] = ISPT
    lam[isolated] = 0
    num_left = int((~isolated).sum())
    col = 0

    q = _BucketQueue(n)
    in_q = np.zeros(n, dtype=bool)

    # Initial fill, preserving the reference's "late nodes see updated
    # measures" behavior (amg/Setup/SSS_coarsen.c:338-372).
    for i in range(n):
        if vec[i] == ISPT:
            continue
        measure = lam[i]
        if measure > 0:
            q.push(i, measure)
            in_q[i] = True
        else:
            vec[i] = FGPT
            num_left -= 1
            for k in range(sp[i], sp[i + 1]):
                j = sj[k]
                if vec[j] == ISPT:
                    continue
                if j < i:
                    if lam[j] > 0 and in_q[j]:
                        q.remove(j, lam[j])
                    lam[j] += 1
                    q.push(j, lam[j])
                    in_q[j] = True
                else:
                    lam[j] += 1

    # Greedy loop (reference amg/Setup/SSS_coarsen.c:375-439)
    while num_left > 0:
        maxnode = q.pop_max()
        if maxnode < 0:
            break
        in_q[maxnode] = False
        vec[maxnode] = CGPT
        lam[maxnode] = 0
        num_left -= 1
        col += 1

        # strong dependents of maxnode become F
        for ii in range(tp[maxnode], tp[maxnode + 1]):
            j = tj[ii]
            if vec[j] != UNPT:
                continue
            vec[j] = FGPT
            if in_q[j]:
                q.remove(j, lam[j])
                in_q[j] = False
            num_left -= 1
            for l in range(sp[j], sp[j + 1]):
                k = sj[l]
                if vec[k] == UNPT:
                    if in_q[k]:
                        q.remove(k, lam[k])
                    lam[k] += 1
                    q.push(k, lam[k])
                    in_q[k] = True

        # strong influences of maxnode lose a unit of measure
        for ii in range(sp[maxnode], sp[maxnode + 1]):
            j = sj[ii]
            if vec[j] != UNPT:
                continue
            if in_q[j]:
                q.remove(j, lam[j])
                in_q[j] = False
            lam[j] -= 1
            if lam[j] > 0:
                q.push(j, lam[j])
                in_q[j] = True
            else:
                vec[j] = FGPT
                num_left -= 1
                for l in range(sp[j], sp[j + 1]):
                    k = sj[l]
                    if vec[k] == UNPT:
                        if in_q[k]:
                            q.remove(k, lam[k])
                        lam[k] += 1
                        q.push(k, lam[k])
                        in_q[k] = True

    col = _c1_pass(s, vec, col)
    return vec, col


def _c1_pass(s: CSR, vec: np.ndarray, col: int) -> int:
    """Second pass enforcing the C1 criterion: every strong F-F pair must
    share an interpolatory C point (reference amg/Setup/SSS_coarsen.c:441-482)."""
    n = s.n_rows
    sp, sj = s.indptr, s.indices
    graph = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        if vec[i] != FGPT:
            continue
        for ji in range(sp[i], sp[i + 1]):
            j = sj[ji]
            if vec[j] == CGPT:
                graph[j] = i
        cnt = 0
        jkeep = -1
        for ji in range(sp[i], sp[i + 1]):
            j = sj[ji]
            if vec[j] != FGPT:
                continue
            set_empty = True
            for jj in range(sp[j], sp[j + 1]):
                if graph[sj[jj]] == i:
                    set_empty = False
                    break
            if set_empty:
                if cnt == 0:
                    vec[j] = CGPT
                    col += 1
                    graph[j] = i
                    jkeep = j
                    cnt = 1
                else:
                    vec[i] = CGPT
                    vec[jkeep] = FGPT
                    break
    return col


def clean_ff_couplings(s: CSR, vec: np.ndarray, col: int) -> int:
    """F-F fixup used before direct interpolation (reference
    amg/Setup/SSS_coarsen.c:501-574), including its tentative-C rollback."""
    try:
        from ..native import lib as _native
    except Exception:
        _native = None
    if _native is not None:
        return _native.clean_ff(s, vec, col)
    n = s.n_rows
    sp, sj = s.indptr, s.indices
    cindex = np.full(n, -1, dtype=np.int64)
    c_i_nonempty = False
    ci_tilde = -1
    ci_tilde_mark = -1

    i = 0
    while i < n:
        if vec[i] != FGPT:
            i += 1
            continue
        for ji in range(sp[i], sp[i + 1]):
            j = sj[ji]
            cindex[j] = i if vec[j] == CGPT else -1
        if ci_tilde_mark != i:
            ci_tilde = -1
        redo = False
        for ji in range(sp[i], sp[i + 1]):
            j = sj[ji]
            if vec[j] != FGPT:
                continue
            set_empty = True
            for jj in range(sp[j], sp[j + 1]):
                if cindex[sj[jj]] == i:
                    set_empty = False
                    break
            if set_empty:
                if c_i_nonempty:
                    vec[i] = CGPT
                    col += 1
                    if ci_tilde > -1:
                        vec[ci_tilde] = FGPT
                        col -= 1
                        ci_tilde = -1
                    c_i_nonempty = False
                    break
                else:
                    vec[j] = CGPT
                    col += 1
                    ci_tilde = j
                    ci_tilde_mark = i
                    c_i_nonempty = True
                    redo = True   # reference rolls back with i--
                    break
        if not redo:
            i += 1
    return col


def pmis_split(s: CSR, seed: int = 42) -> tuple[np.ndarray, int]:
    """PMIS splitting: parallel maximal-independent-set coarsening.

    Vectorized (no data-dependent Python loops over nodes); the natural
    choice once the problem is sharded across chips.  Semantics follow the
    standard PMIS algorithm (De Sterck, Yang & Heys 2006): measure =
    in-degree of S plus a random tie-breaker; points whose measure dominates
    all undecided strong neighbors become C; strong dependents of new C
    points become F.
    """
    n = s.n_rows
    st = s.transpose()
    rng = np.random.default_rng(seed)
    lam = (st.indptr[1:] - st.indptr[:-1]).astype(np.float64)
    lam += rng.random(n)

    vec = np.full(n, UNPT, dtype=np.int64)
    isolated = s.indptr[1:] == s.indptr[:-1]
    # isolated + zero in-degree => truly disconnected
    no_in = st.indptr[1:] == st.indptr[:-1]
    vec[isolated & no_in] = ISPT
    # rows with no strong couplings but with dependents stay candidates via F
    vec[isolated & ~no_in] = FGPT

    rows_s = np.repeat(np.arange(n, dtype=np.int64), s.row_degrees)
    cols_s = s.indices.astype(np.int64)
    rows_t = np.repeat(np.arange(n, dtype=np.int64), st.row_degrees)
    cols_t = st.indices.astype(np.int64)

    while (vec == UNPT).any():
        und = vec == UNPT
        # neighbor max over undirected strong graph (S union S^T)
        nb_max = np.zeros(n)
        m = und[rows_s] & und[cols_s]
        np.maximum.at(nb_max, rows_s[m], lam[cols_s[m]])
        m = und[rows_t] & und[cols_t]
        np.maximum.at(nb_max, rows_t[m], lam[cols_t[m]])
        new_c = und & (lam > nb_max)
        if not new_c.any():
            # numerical tie deadlock: promote the global max
            cand = np.flatnonzero(und)
            new_c = np.zeros(n, dtype=bool)
            new_c[cand[np.argmax(lam[cand])]] = True
        vec[new_c] = CGPT
        # strong dependents of new C points -> F
        m2 = new_c[rows_t]
        f_candidates = cols_t[m2]
        f_mask = vec[f_candidates] == UNPT
        vec[f_candidates[f_mask]] = FGPT

    col = int((vec == CGPT).sum())
    return vec, col


def pmis_permutation(n: int, seed: int) -> np.ndarray:
    """The random tie-break of :func:`pmis_split_device`: a permutation of
    ``0..n-1`` from a CPU ``torch.Generator`` seeded with ``seed``, so the
    card and the CPU draw the same one (``amg_tpu`` draws
    ``jax.random.permutation(PRNGKey(seed), n)``; the streams differ)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=g).numpy()


def pmis_split_device(s: CSR, seed: int = 42,
                      device="cuda") -> tuple[np.ndarray, int]:
    """PMIS on ``device``: the round loop of ``amg_tpu``'s
    ``pmis_split_device`` (``cf_split.py:298-367``) in torch.

    Measure ``lam = in-degree of S + (perm + 0.5) / n`` in f64 (``perm``
    from :func:`pmis_permutation`: distinct tie-breaks 1/n apart, so
    measures never tie).  Each round takes, per undecided point, the
    largest measure of its undecided strong neighbours in S and S^T
    (``scatter_reduce`` ``"amax"``, ``amg_tpu``'s ``segment_max``); points
    above it become C (if none does, the global undecided maximum: the
    deadlock net), and the new C points' undecided strong dependents
    become F.  Rows without strong couplings start as ISPT (nobody
    depends on them) or FGPT.  The host reads one flag per round, whether
    undecided points remain.  Returns the host ``cfmark`` and the C count.
    """
    from ..hierarchy import resolve_device

    dev = resolve_device(device)
    n = s.n_rows
    st = s.transpose()
    indeg = torch.from_numpy((st.indptr[1:] - st.indptr[:-1])
                             .astype(np.float64))
    perm = np.array(pmis_permutation(n, seed), dtype=np.float64)
    u = (torch.from_numpy(perm) + 0.5) / n
    lam = (indeg + u).to(dev)

    def edges(m):
        return (torch.from_numpy(m.row_indices.astype(np.int64)).to(dev),
                torch.from_numpy(m.indices.astype(np.int64)).to(dev))

    rows_s, cols_s = edges(s)
    rows_t, cols_t = edges(st)
    vec0 = np.full(n, UNPT, dtype=np.int64)
    isolated = s.indptr[1:] == s.indptr[:-1]
    no_in = st.indptr[1:] == st.indptr[:-1]
    vec0[isolated & no_in] = ISPT
    vec0[isolated & ~no_in] = FGPT
    vec = torch.from_numpy(vec0).to(dev)
    neg_inf = torch.tensor(-np.inf, dtype=torch.float64, device=dev)

    while True:
        und = vec == UNPT
        if not bool(und.any()):
            break
        nb_max = torch.full((n,), -np.inf, dtype=torch.float64, device=dev)
        for rows, cols in ((rows_s, cols_s), (rows_t, cols_t)):
            both = und[rows] & und[cols]
            nb_max.scatter_reduce_(0, rows, torch.where(both, lam[cols],
                                                        neg_inf), "amax")
        new_c = und & (lam > nb_max)
        # deadlock net (exact float ties): the global undecided maximum
        fallback = torch.zeros_like(new_c)
        fallback[torch.argmax(torch.where(und, lam, neg_inf))] = True
        new_c = torch.where(new_c.any(), new_c, fallback & und)
        vec = torch.where(new_c, CGPT, vec)
        # strong dependents of the new C points -> F
        hit = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, cols_t, new_c[rows_t].to(torch.int32))
        vec = torch.where((hit > 0) & (vec == UNPT), FGPT, vec)
    vec = vec.cpu().numpy()
    return vec, int((vec == CGPT).sum())
