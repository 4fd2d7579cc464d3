// Native setup-phase kernels for amg_tpu.
//
// The AMG setup phase is irregular, data-dependent graph work that belongs
// on the host CPU: the greedy Ruge-Stueben C/F splitting is inherently
// sequential (a priority queue), and SpGEMM has data-dependent output
// sparsity.  The reference implements these in C on the host too
// (amg/Setup/SSS_coarsen.c, amg/SSS_matvec.c:398-534); this module provides
// the same capabilities, written fresh, exported with a C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC amg_native.cpp -o libamg_native.so

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Strength-of-connection pattern (reference strong_couplings + compress_S,
// amg/Setup/SSS_coarsen.c:106-212).  Per row i:
//   row_sum = sum_j |a_ij|  (diagonal included)
//   row_scl = theta * max_{j != i} |a_ij|
//   diagonally-dominant rows (row_sum < (2 - max_row_sum) * |a_ii|) have no
//   strong couplings; otherwise j is strong iff -a_ij > row_scl.
// Pass 1 (parallel) counts strong entries per row into sp[1..n]; caller
// prefix-sums sp and allocates sj; pass 2 (parallel) fills sj.
// ---------------------------------------------------------------------------

void strength_count(
    int64_t n, const int64_t* ap, const int32_t* aj, const double* av,
    double theta, double max_row_sum, int64_t* sp)
{
    sp[0] = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        double row_sum = 0.0, off_max = 0.0, diag = 0.0;
        bool have_diag = false;
        for (int64_t k = ap[i]; k < ap[i + 1]; ++k) {
            const double v = av[k];
            const double a = v < 0 ? -v : v;
            row_sum += a;
            if (aj[k] == (int32_t)i) {
                if (!have_diag) { diag = v; have_diag = true; }
            } else if (a > off_max) {
                off_max = a;
            }
        }
        int64_t cnt = 0;
        const double adiag = diag < 0 ? -diag : diag;
        if (!(row_sum < (2.0 - max_row_sum) * adiag)) {
            const double row_scl = theta * off_max;
            for (int64_t k = ap[i]; k < ap[i + 1]; ++k)
                if (aj[k] != (int32_t)i && -av[k] > row_scl) ++cnt;
        }
        sp[i + 1] = cnt;
    }
}

void strength_fill(
    int64_t n, const int64_t* ap, const int32_t* aj, const double* av,
    double theta, double max_row_sum, const int64_t* sp, int32_t* sj)
{
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        if (sp[i + 1] == sp[i]) continue;
        double off_max = 0.0;
        for (int64_t k = ap[i]; k < ap[i + 1]; ++k) {
            if (aj[k] == (int32_t)i) continue;
            const double a = av[k] < 0 ? -av[k] : av[k];
            if (a > off_max) off_max = a;
        }
        const double row_scl = theta * off_max;
        int64_t next = sp[i];
        for (int64_t k = ap[i]; k < ap[i + 1]; ++k)
            if (aj[k] != (int32_t)i && -av[k] > row_scl) sj[next++] = aj[k];
    }
}

// ---------------------------------------------------------------------------
// Interpolation truncation (reference SSS_amg_interp_trunc,
// amg/Setup/SSS_inter.cu:16-102): per row keep entries >= eps*max_pos or
// <= eps*min_neg, rescale kept positive/negative groups so each group's
// row sum is preserved.  Pass 1 counts into qp[1..n] (caller prefix-sums),
// pass 2 fills qj/qv.
// ---------------------------------------------------------------------------

void trunc_count(
    int64_t n, const int64_t* pp, const int32_t* pj, const double* pv,
    double eps, int64_t* qp)
{
    qp[0] = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        double max_pos = 0.0, min_neg = 0.0;
        for (int64_t k = pp[i]; k < pp[i + 1]; ++k) {
            if (pv[k] > max_pos) max_pos = pv[k];
            if (pv[k] < min_neg) min_neg = pv[k];
        }
        max_pos *= eps; min_neg *= eps;
        int64_t cnt = 0;
        for (int64_t k = pp[i]; k < pp[i + 1]; ++k)
            if (pv[k] >= max_pos || pv[k] <= min_neg) ++cnt;
        qp[i + 1] = cnt;
    }
}

void trunc_fill(
    int64_t n, const int64_t* pp, const int32_t* pj, const double* pv,
    double eps, const int64_t* qp, int32_t* qj, double* qv)
{
    const double SMALL = 1e-20;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        double max_pos = 0.0, min_neg = 0.0, sum_pos = 0.0, sum_neg = 0.0;
        for (int64_t k = pp[i]; k < pp[i + 1]; ++k) {
            const double v = pv[k];
            if (v > 0) { sum_pos += v; if (v > max_pos) max_pos = v; }
            if (v < 0) { sum_neg += v; if (v < min_neg) min_neg = v; }
        }
        max_pos *= eps; min_neg *= eps;
        double tsum_pos = 0.0, tsum_neg = 0.0;
        for (int64_t k = pp[i]; k < pp[i + 1]; ++k) {
            const double v = pv[k];
            if (v >= max_pos) tsum_pos += v;
            else if (v <= min_neg) tsum_neg += v;
        }
        const double fac_pos = (tsum_pos > SMALL) ? sum_pos / tsum_pos : 1.0;
        const double fac_neg = (tsum_neg < -SMALL) ? sum_neg / tsum_neg : 1.0;
        int64_t next = qp[i];
        for (int64_t k = pp[i]; k < pp[i + 1]; ++k) {
            const double v = pv[k];
            if (v >= max_pos) { qj[next] = pj[k]; qv[next++] = v * fac_pos; }
            else if (v <= min_neg) { qj[next] = pj[k]; qv[next++] = v * fac_neg; }
        }
    }
}

// ---------------------------------------------------------------------------
// SpGEMM: two-pass marker algorithm.
//
// Pass 1 counts the nnz of each output row using a "last seen in row i"
// stamp array; pass 2 accumulates values into a dense workspace indexed by
// column, materializing only the stamped columns.  Same asymptotics as the
// reference's Ps_marker/As_marker scheme (amg/SSS_matvec.c:443-522) but a
// single general A*B building block instead of a fused triple product.
// ---------------------------------------------------------------------------

// Pass 1: fill cp[0..m] (row pointer) and return total nnz (or -1 on error).
int64_t spgemm_count(
    int64_t m, int64_t n,
    const int64_t* ap, const int32_t* aj,
    const int64_t* bp, const int32_t* bj,
    int64_t* cp)
{
    cp[0] = 0;
    // rows are independent given a per-thread marker array
#ifdef _OPENMP
#pragma omp parallel
    {
        std::vector<int64_t> marker((size_t)n, -1);
#pragma omp for schedule(dynamic, 1024)
        for (int64_t i = 0; i < m; ++i) {
            int64_t cnt = 0;
            for (int64_t ka = ap[i]; ka < ap[i + 1]; ++ka) {
                const int32_t k = aj[ka];
                for (int64_t kb = bp[k]; kb < bp[k + 1]; ++kb) {
                    const int32_t j = bj[kb];
                    if (marker[(size_t)j] != i) { marker[(size_t)j] = i; ++cnt; }
                }
            }
            cp[i + 1] = cnt;
        }
    }
#else
    std::vector<int64_t> marker((size_t)n, -1);
    for (int64_t i = 0; i < m; ++i) {
        int64_t cnt = 0;
        for (int64_t ka = ap[i]; ka < ap[i + 1]; ++ka) {
            const int32_t k = aj[ka];
            for (int64_t kb = bp[k]; kb < bp[k + 1]; ++kb) {
                const int32_t j = bj[kb];
                if (marker[(size_t)j] != i) { marker[(size_t)j] = i; ++cnt; }
            }
        }
        cp[i + 1] = cnt;
    }
#endif
    for (int64_t i = 0; i < m; ++i) cp[i + 1] += cp[i];
    return cp[m];
}

// Pass 2: fill cj/cv given cp from pass 1. Columns within a row appear in
// first-touch order; values are exact sums. Returns 0 on success.
int32_t spgemm_fill(
    int64_t m, int64_t n,
    const int64_t* ap, const int32_t* aj, const double* av,
    const int64_t* bp, const int32_t* bj, const double* bv,
    const int64_t* cp, int32_t* cj, double* cv)
{
    // each row writes only its own cp[i]..cp[i+1] slice -> rows are
    // independent given per-thread workspaces
#ifdef _OPENMP
#pragma omp parallel
    {
        std::vector<int64_t> pos((size_t)n, -1);
        std::vector<int64_t> stamp((size_t)n, -1);
#pragma omp for schedule(dynamic, 1024)
        for (int64_t i = 0; i < m; ++i) {
            int64_t next = cp[i];
            for (int64_t ka = ap[i]; ka < ap[i + 1]; ++ka) {
                const int32_t k = aj[ka];
                const double a = av[ka];
                for (int64_t kb = bp[k]; kb < bp[k + 1]; ++kb) {
                    const int32_t j = bj[kb];
                    if (stamp[(size_t)j] != i) {
                        stamp[(size_t)j] = i;
                        pos[(size_t)j] = next;
                        cj[next] = j;
                        cv[next] = a * bv[kb];
                        ++next;
                    } else {
                        cv[pos[(size_t)j]] += a * bv[kb];
                    }
                }
            }
        }
    }
#else
    std::vector<int64_t> pos((size_t)n, -1);   // column -> output slot
    std::vector<int64_t> stamp((size_t)n, -1);
    for (int64_t i = 0; i < m; ++i) {
        int64_t next = cp[i];
        for (int64_t ka = ap[i]; ka < ap[i + 1]; ++ka) {
            const int32_t k = aj[ka];
            const double a = av[ka];
            for (int64_t kb = bp[k]; kb < bp[k + 1]; ++kb) {
                const int32_t j = bj[kb];
                if (stamp[(size_t)j] != i) {
                    stamp[(size_t)j] = i;
                    pos[(size_t)j] = next;
                    cj[next] = j;
                    cv[next] = a * bv[kb];
                    ++next;
                } else {
                    cv[pos[(size_t)j]] += a * bv[kb];
                }
            }
        }
    }
#endif
    return 0;
}

// ---------------------------------------------------------------------------
// CSR transpose (histogram + scatter), for completeness / future use.
// ---------------------------------------------------------------------------

int32_t csr_transpose(
    int64_t m, int64_t n,
    const int64_t* ap, const int32_t* aj, const double* av,
    int64_t* tp, int32_t* tj, double* tv)
{
    std::memset(tp, 0, sizeof(int64_t) * (size_t)(n + 1));
    const int64_t nnz = ap[m];
    for (int64_t k = 0; k < nnz; ++k) tp[aj[k] + 1]++;
    for (int64_t j = 0; j < n; ++j) tp[j + 1] += tp[j];
    std::vector<int64_t> next(tp, tp + n);
    for (int64_t i = 0; i < m; ++i) {
        for (int64_t k = ap[i]; k < ap[i + 1]; ++k) {
            const int64_t dst = next[(size_t)aj[k]]++;
            tj[dst] = (int32_t)i;
            tv[dst] = av[k];
        }
    }
    return 0;
}

// Pattern-only transpose (no values): the strength matrix S is a pure
// pattern, and rs_split only needs S^T's structure — skipping tv halves
// the transpose traffic on the biggest per-level array.
int32_t csr_transpose_pat(
    int64_t m, int64_t n,
    const int64_t* ap, const int32_t* aj,
    int64_t* tp, int32_t* tj)
{
    std::memset(tp, 0, sizeof(int64_t) * (size_t)(n + 1));
    const int64_t nnz = ap[m];
    for (int64_t k = 0; k < nnz; ++k) tp[aj[k] + 1]++;
    for (int64_t j = 0; j < n; ++j) tp[j + 1] += tp[j];
    std::vector<int64_t> next(tp, tp + n);
    for (int64_t i = 0; i < m; ++i)
        for (int64_t k = ap[i]; k < ap[i + 1]; ++k)
            tj[next[(size_t)aj[k]]++] = (int32_t)i;
    return 0;
}

// ---------------------------------------------------------------------------
// Classical RS C/F splitting.
//
// Same semantics as amg_tpu/setup/cf_split.py::_rs_split_py (which in turn
// replicates the reference's cfsplitting_cls ordering): bucket priority
// queue with FIFO buckets, measure = in-degree of S, quirks preserved.
// vec values: UNPT=-1, FGPT=0, CGPT=1, ISPT=2.
// ---------------------------------------------------------------------------

namespace {

constexpr int64_t UNPT = -1, FGPT = 0, CGPT = 1, ISPT = 2;

struct BucketQueue {
    std::vector<int64_t> nxt, prv;
    // head/tail per measure, sized lazily
    std::vector<int64_t> head, tail;
    int64_t cur_max = -1;

    explicit BucketQueue(int64_t n)
        : nxt((size_t)n, -1), prv((size_t)n, -1) {}

    void ensure(int64_t measure) {
        if ((int64_t)head.size() <= measure) {
            head.resize((size_t)measure + 1, -1);
            tail.resize((size_t)measure + 1, -1);
        }
    }

    void push(int64_t i, int64_t measure) {
        ensure(measure);
        const int64_t t = tail[(size_t)measure];
        prv[(size_t)i] = t;
        nxt[(size_t)i] = -1;
        if (t >= 0) nxt[(size_t)t] = i;
        else head[(size_t)measure] = i;
        tail[(size_t)measure] = i;
        if (measure > cur_max) cur_max = measure;
    }

    void remove(int64_t i, int64_t measure) {
        const int64_t p = prv[(size_t)i], nx = nxt[(size_t)i];
        if (p >= 0) nxt[(size_t)p] = nx;
        else head[(size_t)measure] = nx;
        if (nx >= 0) prv[(size_t)nx] = p;
        else tail[(size_t)measure] = p;
        prv[(size_t)i] = nxt[(size_t)i] = -1;
    }

    int64_t pop_max() {
        while (cur_max >= 0 &&
               (cur_max >= (int64_t)head.size() || head[(size_t)cur_max] < 0))
            --cur_max;
        if (cur_max < 0) return -1;
        const int64_t i = head[(size_t)cur_max];
        remove(i, cur_max);
        return i;
    }
};

}  // namespace

// Returns the number of C points (col). vec must be length n.
int64_t rs_split(
    int64_t n,
    const int64_t* sp, const int32_t* sj,     // S (compressed strength)
    const int64_t* tp, const int32_t* tj,     // S^T
    int64_t* vec)
{
    std::vector<int64_t> lam((size_t)n);
    std::vector<uint8_t> in_q((size_t)n, 0);
    for (int64_t i = 0; i < n; ++i) lam[(size_t)i] = tp[i + 1] - tp[i];

    int64_t num_left = 0, col = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (sp[i + 1] == sp[i]) { vec[i] = ISPT; lam[(size_t)i] = 0; }
        else { vec[i] = UNPT; ++num_left; }
    }

    BucketQueue q(n);

    // initial fill: nodes processed in index order; measure<=0 nodes become
    // F immediately and bump already-inserted (j < i) neighbors
    for (int64_t i = 0; i < n; ++i) {
        if (vec[i] == ISPT) continue;
        const int64_t measure = lam[(size_t)i];
        if (measure > 0) {
            q.push(i, measure);
            in_q[(size_t)i] = 1;
        } else {
            vec[i] = FGPT;
            --num_left;
            for (int64_t k = sp[i]; k < sp[i + 1]; ++k) {
                const int64_t j = sj[k];
                if (vec[j] == ISPT) continue;
                if (j < i) {
                    if (lam[(size_t)j] > 0 && in_q[(size_t)j])
                        q.remove(j, lam[(size_t)j]);
                    lam[(size_t)j] += 1;
                    q.push(j, lam[(size_t)j]);
                    in_q[(size_t)j] = 1;
                } else {
                    lam[(size_t)j] += 1;
                }
            }
        }
    }

    while (num_left > 0) {
        const int64_t maxnode = q.pop_max();
        if (maxnode < 0) break;
        in_q[(size_t)maxnode] = 0;
        vec[maxnode] = CGPT;
        lam[(size_t)maxnode] = 0;
        --num_left;
        ++col;

        for (int64_t ii = tp[maxnode]; ii < tp[maxnode + 1]; ++ii) {
            const int64_t j = tj[ii];
            if (vec[j] != UNPT) continue;
            vec[j] = FGPT;
            if (in_q[(size_t)j]) { q.remove(j, lam[(size_t)j]); in_q[(size_t)j] = 0; }
            --num_left;
            for (int64_t l = sp[j]; l < sp[j + 1]; ++l) {
                const int64_t k = sj[l];
                if (vec[k] == UNPT) {
                    if (in_q[(size_t)k]) q.remove(k, lam[(size_t)k]);
                    lam[(size_t)k] += 1;
                    q.push(k, lam[(size_t)k]);
                    in_q[(size_t)k] = 1;
                }
            }
        }

        for (int64_t ii = sp[maxnode]; ii < sp[maxnode + 1]; ++ii) {
            const int64_t j = sj[ii];
            if (vec[j] != UNPT) continue;
            if (in_q[(size_t)j]) { q.remove(j, lam[(size_t)j]); in_q[(size_t)j] = 0; }
            lam[(size_t)j] -= 1;
            if (lam[(size_t)j] > 0) {
                q.push(j, lam[(size_t)j]);
                in_q[(size_t)j] = 1;
            } else {
                vec[j] = FGPT;
                --num_left;
                for (int64_t l = sp[j]; l < sp[j + 1]; ++l) {
                    const int64_t k = sj[l];
                    if (vec[k] == UNPT) {
                        if (in_q[(size_t)k]) q.remove(k, lam[(size_t)k]);
                        lam[(size_t)k] += 1;
                        q.push(k, lam[(size_t)k]);
                        in_q[(size_t)k] = 1;
                    }
                }
            }
        }
    }

    // C1 criterion second pass (reference amg/Setup/SSS_coarsen.c:441-482)
    std::vector<int64_t> graph((size_t)n, -1);
    for (int64_t i = 0; i < n; ++i) {
        if (vec[i] != FGPT) continue;
        for (int64_t ji = sp[i]; ji < sp[i + 1]; ++ji) {
            const int64_t j = sj[ji];
            if (vec[j] == CGPT) graph[(size_t)j] = i;
        }
        int64_t cnt = 0, jkeep = -1;
        for (int64_t ji = sp[i]; ji < sp[i + 1]; ++ji) {
            const int64_t j = sj[ji];
            if (vec[j] != FGPT) continue;
            bool set_empty = true;
            for (int64_t jj = sp[j]; jj < sp[j + 1]; ++jj) {
                if (graph[(size_t)sj[jj]] == i) { set_empty = false; break; }
            }
            if (set_empty) {
                if (cnt == 0) {
                    vec[j] = CGPT; ++col; graph[(size_t)j] = i;
                    jkeep = j; cnt = 1;
                } else {
                    vec[i] = CGPT; vec[jkeep] = FGPT;
                    break;
                }
            }
        }
    }

    return col;
}

// F-F coupling cleanup for direct interpolation (reference
// amg/Setup/SSS_coarsen.c:501-574). Returns updated col.
int64_t clean_ff(
    int64_t n,
    const int64_t* sp, const int32_t* sj,
    int64_t* vec, int64_t col)
{
    std::vector<int64_t> cindex((size_t)n, -1);
    bool c_i_nonempty = false;
    int64_t ci_tilde = -1, ci_tilde_mark = -1;

    for (int64_t i = 0; i < n; /* manual advance */) {
        if (vec[i] != FGPT) { ++i; continue; }
        for (int64_t ji = sp[i]; ji < sp[i + 1]; ++ji) {
            const int64_t j = sj[ji];
            cindex[(size_t)j] = (vec[j] == CGPT) ? i : -1;
        }
        if (ci_tilde_mark != i) ci_tilde = -1;
        bool redo = false;
        for (int64_t ji = sp[i]; ji < sp[i + 1]; ++ji) {
            const int64_t j = sj[ji];
            if (vec[j] != FGPT) continue;
            bool set_empty = true;
            for (int64_t jj = sp[j]; jj < sp[j + 1]; ++jj) {
                if (cindex[(size_t)sj[jj]] == i) { set_empty = false; break; }
            }
            if (set_empty) {
                if (c_i_nonempty) {
                    vec[i] = CGPT; ++col;
                    if (ci_tilde > -1) { vec[ci_tilde] = FGPT; --col; ci_tilde = -1; }
                    c_i_nonempty = false;
                } else {
                    vec[j] = CGPT; ++col;
                    ci_tilde = j; ci_tilde_mark = i;
                    c_i_nonempty = true;
                    redo = true;  // reference rolls back with i--
                }
                break;
            }
        }
        if (!redo) ++i;
    }
    return col;
}

// ---------------------------------------------------------------------------
// Standard interpolation values (the heaviest per-row Python loop).
// Semantics identical to amg_tpu/setup/interp.py::interp_std_values.
// ---------------------------------------------------------------------------

int32_t std_interp_values(
    int64_t n,
    const int64_t* ap, const int32_t* aj, const double* av,
    const int64_t* sp, const int32_t* sj,
    const int64_t* pp, const int32_t* pj,
    const int64_t* vec,
    double* pv)
{
    std::vector<double> diag((size_t)n, 0.0), csum((size_t)n, 0.0),
        nsum((size_t)n, 0.0), psum((size_t)n, 0.0), ahat((size_t)n, 0.0);
    std::vector<int64_t> cindex((size_t)n, -1);
    std::vector<int64_t> rind((size_t)n, -1);  // col -> A slot for one row

    // strong-C flags + sums (reference amg/Setup/SSS_inter.cu:587-614)
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = sp[i]; j < sp[i + 1]; ++j) {
            const int64_t k = sj[j];
            if (vec[k] == CGPT) cindex[(size_t)k] = i;
        }
        for (int64_t j = ap[i]; j < ap[i + 1]; ++j) {
            const int64_t k = aj[j];
            if (cindex[(size_t)k] == i) csum[(size_t)i] += av[j];
            if (k == i) diag[(size_t)i] = av[j];
            else {
                nsum[(size_t)i] += av[j];
                if (vec[k] != ISPT) psum[(size_t)i] += av[j];
            }
        }
    }

    std::vector<int64_t> rind_k((size_t)n, -1);

    for (int64_t i = 0; i < n; ++i) {
        if (vec[i] == CGPT) {
            pv[pp[i]] = 1.0;
            continue;
        }
        if (vec[i] != FGPT) continue;

        double alN = psum[(size_t)i], alP = csum[(size_t)i];
        for (int64_t j = ap[i]; j < ap[i + 1]; ++j) rind[(size_t)aj[j]] = j;
        for (int64_t j = pp[i]; j < pp[i + 1]; ++j) ahat[(size_t)pj[j]] = 0.0;
        ahat[(size_t)i] = diag[(size_t)i];

        for (int64_t j = sp[i]; j < sp[i + 1]; ++j) {
            const int64_t k = sj[j];
            const int64_t slot = rind[(size_t)k];
            const double aik = (slot >= 0 && slot >= ap[i] && slot < ap[i + 1])
                                   ? av[slot] : 0.0;
            if (vec[k] == CGPT) {
                ahat[(size_t)k] += aik;
            } else if (vec[k] == FGPT) {
                const double akk = diag[(size_t)k];
                const double factor = aik / akk;
                double aki = 0.0;
                for (int64_t m = ap[k]; m < ap[k + 1]; ++m) {
                    rind_k[(size_t)aj[m]] = m;
                    if (aj[m] == i) {
                        aki = av[m];
                        ahat[(size_t)i] -= factor * aki;
                    }
                }
                for (int64_t m = sp[k]; m < sp[k + 1]; ++m) {
                    const int64_t l = sj[m];
                    if (vec[l] == CGPT) {
                        const int64_t sl = rind_k[(size_t)l];
                        const double akl =
                            (sl >= ap[k] && sl < ap[k + 1]) ? av[sl] : 0.0;
                        ahat[(size_t)l] -= factor * akl;
                    }
                }
                alN -= factor * (nsum[(size_t)k] - aki + akk);
                alP -= factor * csum[(size_t)k];
            }
        }
        if (pp[i + 1] > pp[i]) {
            const double alpha = alN / alP;
            for (int64_t j = pp[i]; j < pp[i + 1]; ++j)
                pv[j] = -alpha * ahat[(size_t)pj[j]] / ahat[(size_t)i];
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Direct-interpolation pattern (reference form_P_pattern_dir,
// amg/Setup/SSS_coarsen.c:577-630): F rows (vec==0) take their strong C
// neighbors (vec[col]==1), C rows (vec==1) get a single identity entry,
// isolated rows (vec==2) stay empty.  Pass 1 counts per-row entries into
// pp[1..n] (caller prefix-sums), pass 2 fills pj.  Both passes are
// embarrassingly parallel over rows.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// WEll (windowed-gather ELL) slot packer — see amg_tpu/sparse.py::WEll.
// Greedy first-fit per 1024-row group over column-sorted entries:
// admit (row, col) into a slot iff (1) col lies in the slot's 1024-wide
// window [128*base, 128*base + 1024), (2) the row's lane is free, and
// (3) the (output-sublane, column-remainder) cell of the slot's Q table
// is free or already maps to the same column block (the two-step-gather
// conflict-freedom invariant).  Pass 1 counts slots per group; pass 2
// re-runs the identical greedy and fills base / packed loc / values.
// No reference counterpart: the reference's CSR SpMV gathers globally
// (amg/SSS_utils.c:182-201); this layout is what makes the gather fast
// on a TPU vector unit.
// ---------------------------------------------------------------------------

namespace {

struct WellSlot {
    int32_t base;            // window start, sublane units
    uint64_t occ[16];        // row-lane occupancy (1024 bits)
    uint8_t qmap[1024];      // (sublane*128 + remainder) -> block, 0xFF free
    // (group-local row, global nnz index) pairs; fill pass only
    std::vector<std::pair<int32_t, int64_t>> entries;
};

// run the greedy for one group; returns slots (entries recorded only when
// want_entries).  erows/ecols/eidx are the group's entries sorted by col.
inline void well_greedy_group(
    const std::vector<int32_t>& erows, const std::vector<int64_t>& ecols,
    const std::vector<int64_t>& eidx, int64_t base_max, bool want_entries,
    std::vector<WellSlot>& slots)
{
    slots.clear();
    const size_t ne = ecols.size();
    for (size_t e = 0; e < ne; ++e) {
        const int64_t c = ecols[e];
        const int32_t r = erows[e];
        const int32_t su = r >> 7;
        bool placed = false;
        for (auto& s : slots) {
            const int64_t w0 = 128 * (int64_t)s.base;
            if (c < w0 || c >= w0 + 1024) continue;
            if (s.occ[r >> 6] & (1ull << (r & 63))) continue;
            const int32_t q = (int32_t)((c - w0) >> 7);
            const int32_t rem = (int32_t)((c - w0) & 127);
            uint8_t& cell = s.qmap[su * 128 + rem];
            if (cell != 0xFF && cell != (uint8_t)q) continue;
            s.occ[r >> 6] |= (1ull << (r & 63));
            cell = (uint8_t)q;
            if (want_entries) s.entries.emplace_back(r, eidx[e]);
            placed = true;
            break;
        }
        if (placed) continue;
        WellSlot ns;
        int64_t b = c >> 7;
        if (b > base_max) b = base_max;
        if (b < 0) b = 0;
        ns.base = (int32_t)b;
        std::memset(ns.occ, 0, sizeof(ns.occ));
        std::memset(ns.qmap, 0xFF, sizeof(ns.qmap));
        ns.occ[r >> 6] |= (1ull << (r & 63));
        const int64_t off = c - 128 * b;
        ns.qmap[su * 128 + (off & 127)] = (uint8_t)(off >> 7);
        if (want_entries) ns.entries.emplace_back(r, eidx[e]);
        slots.push_back(std::move(ns));
    }
}

inline void well_collect_group(
    int64_t g, int64_t n, const int64_t* ap, const int32_t* aj,
    std::vector<int32_t>& erows, std::vector<int64_t>& ecols,
    std::vector<int64_t>& eidx)
{
    const int64_t r0 = g * 1024;
    const int64_t r1 = std::min(r0 + 1024, n);
    erows.clear(); ecols.clear(); eidx.clear();
    if (r0 >= n) return;
    const int64_t lo = ap[r0], hi = ap[r1];
    erows.reserve(hi - lo); ecols.reserve(hi - lo); eidx.reserve(hi - lo);
    // sort by column: index sort over the group's entries
    std::vector<int64_t> order(hi - lo);
    for (int64_t k = 0; k < hi - lo; ++k) order[k] = lo + k;
    std::sort(order.begin(), order.end(),
              [aj](int64_t x, int64_t y) { return aj[x] < aj[y]; });
    // row of each entry: walk indptr once
    std::vector<int32_t> rows_of(hi - lo);
    for (int64_t i = r0; i < r1; ++i)
        for (int64_t k = ap[i]; k < ap[i + 1]; ++k)
            rows_of[k - lo] = (int32_t)(i - r0);
    for (int64_t k : order) {
        erows.push_back(rows_of[k - lo]);
        ecols.push_back((int64_t)aj[k]);
        eidx.push_back(k);
    }
}

}  // namespace

int64_t well_pack_count(
    int64_t n, const int64_t* ap, const int32_t* aj,
    int64_t ngroups, int64_t pad_cols, int64_t* slots_per_group)
{
    const int64_t base_max = pad_cols / 128 - 8;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<int32_t> erows;
        std::vector<int64_t> ecols, eidx;
        std::vector<WellSlot> slots;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 4)
#endif
        for (int64_t g = 0; g < ngroups; ++g) {
            well_collect_group(g, n, ap, aj, erows, ecols, eidx);
            well_greedy_group(erows, ecols, eidx, base_max, false, slots);
            slots_per_group[g] = (int64_t)slots.size();
        }
    }
    int64_t mx = 1;
    for (int64_t g = 0; g < ngroups; ++g)
        mx = std::max(mx, slots_per_group[g]);
    return mx;
}

int32_t well_pack_fill(
    int64_t n, const int64_t* ap, const int32_t* aj, const double* av,
    int64_t ngroups, int64_t pad_cols, int64_t S,
    int32_t* base, int32_t* loc, double* vals)
{
    const int64_t base_max = pad_cols / 128 - 8;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<int32_t> erows;
        std::vector<int64_t> ecols, eidx;
        std::vector<WellSlot> slots;
        std::vector<int32_t> row_of_entry;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 4)
#endif
        for (int64_t g = 0; g < ngroups; ++g) {
            well_collect_group(g, n, ap, aj, erows, ecols, eidx);
            well_greedy_group(erows, ecols, eidx, base_max, true, slots);
            for (size_t k = 0; k < slots.size(); ++k) {
                const WellSlot& s = slots[k];
                base[g * S + k] = s.base;
                int32_t* lc = loc + (g * S + (int64_t)k) * 1024;
                double* vv = vals + (g * S + (int64_t)k) * 1024;
                for (const auto& re : s.entries) {
                    const int32_t r = re.first;
                    const int64_t ei = re.second;
                    const int64_t off = (int64_t)aj[ei] - 128 * s.base;
                    lc[r] |= (int32_t)(off & 127);
                    vv[r] = av[ei];
                }
                // Q table: lane j of sublane su holds the block of the
                // remainder-j entry
                for (int32_t cell = 0; cell < 1024; ++cell)
                    if (s.qmap[cell] != 0xFF)
                        lc[cell] |= ((int32_t)s.qmap[cell]) << 16;
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Smoothed-aggregation greedy (three-phase Vanek; no reference
// counterpart — the reference is RS-only).  Exact port of the Python
// aggregate(): (1) seed where the whole strong neighborhood is free,
// (2) attach stragglers to the most-connected neighboring aggregate
// (ties -> smallest id), (3) leftovers seed with their free neighbors.
// Phase 1 is order-dependent (sequential greedy), but the whole pass is
// O(nnz) in C++ — the Python per-row loop was the SA setup bottleneck
// at 1M+ rows.
// ---------------------------------------------------------------------------

int64_t sa_aggregate(
    int64_t n, const int64_t* sp, const int32_t* sj, int64_t* agg)
{
    for (int64_t i = 0; i < n; ++i)
        agg[i] = (sp[i + 1] == sp[i]) ? -1 : -2;
    int64_t n_agg = 0;
    // phase 1
    for (int64_t i = 0; i < n; ++i) {
        if (agg[i] != -2) continue;
        bool free_nbhd = true;
        for (int64_t k = sp[i]; k < sp[i + 1]; ++k)
            if (agg[sj[k]] != -2) { free_nbhd = false; break; }
        if (!free_nbhd) continue;
        agg[i] = n_agg;
        for (int64_t k = sp[i]; k < sp[i + 1]; ++k) agg[sj[k]] = n_agg;
        ++n_agg;
    }
    // phase 2: most-connected neighboring aggregate, ties -> smallest id
    std::vector<int64_t> ids, counts;
    for (int64_t i = 0; i < n; ++i) {
        if (agg[i] != -2) continue;
        ids.clear(); counts.clear();
        for (int64_t k = sp[i]; k < sp[i + 1]; ++k) {
            const int64_t aa = agg[sj[k]];
            if (aa < 0) continue;
            size_t t = 0;
            for (; t < ids.size(); ++t)
                if (ids[t] == aa) { ++counts[t]; break; }
            if (t == ids.size()) { ids.push_back(aa); counts.push_back(1); }
        }
        if (ids.empty()) continue;  // stays -2 for phase 3
        int64_t best = -1, best_c = 0;
        for (size_t t = 0; t < ids.size(); ++t)
            if (counts[t] > best_c
                || (counts[t] == best_c && ids[t] < best)) {
                best = ids[t]; best_c = counts[t];
            }
        agg[i] = best;
    }
    // phase 3
    for (int64_t i = 0; i < n; ++i) {
        if (agg[i] != -2) continue;
        agg[i] = n_agg;
        for (int64_t k = sp[i]; k < sp[i + 1]; ++k)
            if (agg[sj[k]] == -2) agg[sj[k]] = n_agg;
        ++n_agg;
    }
    return n_agg;
}

// ---------------------------------------------------------------------------
// Standard-interpolation pattern (distance-2; reference interp_STD's
// pattern stage, amg/Setup/SSS_inter.cu:550-715): an F row interpolates
// from its strong C neighbors plus the strong C neighbors of its strong
// F neighbors, in first-visit order (the reference's `visited` stamps).
// Row degrees are small (tens), so dedup is a linear scan over the
// row's collected columns — O(deg^2) per row but allocation-free and
// embarrassingly parallel, vs the Python per-row loop that made STD
// unusable at 1M+ rows.
// ---------------------------------------------------------------------------

namespace {

inline int64_t std_row_collect(
    int64_t i, const int64_t* sp, const int32_t* sj, const int64_t* vec,
    int32_t* out)  // out: caller-provided buffer; returns count
{
    int64_t cnt = 0;
    auto push = [&](int32_t c) {
        for (int64_t t = 0; t < cnt; ++t)
            if (out[t] == c) return;
        out[cnt++] = c;
    };
    for (int64_t j = sp[i]; j < sp[i + 1]; ++j) {
        const int32_t k = sj[j];
        if (vec[k] == 1) {
            push(k);
        } else if (vec[k] == 0 && k != (int32_t)i) {
            for (int64_t l = sp[k]; l < sp[k + 1]; ++l) {
                const int32_t h = sj[l];
                if (vec[h] == 1) push(h);
            }
        }
    }
    return cnt;
}

}  // namespace

void p_pattern_std_count(
    int64_t n, const int64_t* sp, const int32_t* sj, const int64_t* vec,
    int64_t* pp)
{
    pp[0] = 0;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<int32_t> buf(256);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1024)
#endif
        for (int64_t i = 0; i < n; ++i) {
            if (vec[i] == 1) {
                pp[i + 1] = 1;
                continue;
            }
            if (vec[i] != 0) {
                pp[i + 1] = 0;
                continue;
            }
            // upper bound on candidates: sum of neighbor strong degrees
            int64_t cap = 0;
            for (int64_t j = sp[i]; j < sp[i + 1]; ++j) {
                const int32_t k = sj[j];
                cap += (vec[k] == 1) ? 1 : (sp[k + 1] - sp[k]);
            }
            if ((int64_t)buf.size() < cap) buf.resize(cap);
            pp[i + 1] = std_row_collect(i, sp, sj, vec, buf.data());
        }
    }
}

void p_pattern_std_fill(
    int64_t n, const int64_t* sp, const int32_t* sj, const int64_t* vec,
    const int64_t* pp, int32_t* pj)
{
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1024)
#endif
    for (int64_t i = 0; i < n; ++i) {
        if (vec[i] == 1) {
            pj[pp[i]] = (int32_t)i;
        } else if (vec[i] == 0) {
            (void)std_row_collect(i, sp, sj, vec, pj + pp[i]);
        }
    }
}

void p_pattern_dir_count(
    int64_t n, const int64_t* sp, const int32_t* sj, const int64_t* vec,
    int64_t* pp)
{
    pp[0] = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        int64_t cnt = 0;
        if (vec[i] == 1) {
            cnt = 1;
        } else if (vec[i] == 0) {
            for (int64_t k = sp[i]; k < sp[i + 1]; ++k)
                if (vec[sj[k]] == 1) ++cnt;
        }
        pp[i + 1] = cnt;
    }
}

void p_pattern_dir_fill(
    int64_t n, const int64_t* sp, const int32_t* sj, const int64_t* vec,
    const int64_t* pp, int32_t* pj)
{
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        int64_t next = pp[i];
        if (vec[i] == 1) {
            pj[next] = (int32_t)i;
        } else if (vec[i] == 0) {
            for (int64_t k = sp[i]; k < sp[i + 1]; ++k)
                if (vec[sj[k]] == 1) pj[next++] = sj[k];
        }
    }
}

// ---------------------------------------------------------------------------
// Direct interpolation values (reference DIR_Step_1,
// amg/Setup/SSS_inter.cu:104-210): per F row split off-diagonals into
// negative/positive sums over all neighbors (amN/apN) and over the P
// pattern's interpolatory neighbors (amP/apP); alpha=amN/amP,
// beta=apN/apP (or fold positive mass into the diagonal when the row has
// no positive interpolatory couplings); P_ij = -alpha*a_ij/aii (neg) or
// -beta*a_ij/aii (pos).  C rows get weight 1.
// ---------------------------------------------------------------------------

int32_t dir_interp_values(
    int64_t n,
    const int64_t* ap, const int32_t* aj, const double* av,
    const int64_t* pp, const int32_t* pj,
    const int64_t* vec,   // C/F markers (CGPT == 1, FGPT == 0)
    double* pv)
{
    std::vector<int64_t> mark((size_t)n, -1);  // col -> row stamp (pattern)
    for (int64_t i = 0; i < n; ++i) {
        if (vec[i] == 1) {  // CGPT: identity weight
            for (int64_t k = pp[i]; k < pp[i + 1]; ++k) pv[k] = 1.0;
            continue;
        }
        if (vec[i] != 0) continue;  // ISPT: empty row
        for (int64_t k = pp[i]; k < pp[i + 1]; ++k)
            mark[(size_t)pj[k]] = i;
        double aii = 0.0, amN = 0.0, amP = 0.0, apN = 0.0, apP = 0.0;
        int64_t npc = 0;
        for (int64_t k = ap[i]; k < ap[i + 1]; ++k) {
            const int64_t j = aj[k];
            const double v = av[k];
            if (j == i) { aii = v; continue; }
            if (v > 0.0) {
                apN += v;
                if (mark[(size_t)j] == i) { apP += v; ++npc; }
            } else {
                amN += v;
                if (mark[(size_t)j] == i) amP += v;
            }
        }
        const double alpha = (amP != 0.0) ? amN / amP : 0.0;
        double beta = 0.0;
        if (npc > 0) beta = (apP != 0.0) ? apN / apP : 0.0;
        else aii += apN;  // fold positive mass into the diagonal
        for (int64_t k = pp[i]; k < pp[i + 1]; ++k) {
            // find a_{i, pj[k]}: scan the row (rows are short)
            double a_ik = 0.0;
            for (int64_t m = ap[i]; m < ap[i + 1]; ++m)
                if (aj[m] == pj[k]) { a_ik = av[m]; break; }
            pv[k] = (a_ik > 0.0) ? -beta * a_ik / aii
                                 : -alpha * a_ik / aii;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Greedy sequential graph coloring over the symmetrized pattern of A.
//
// Rows of one color are mutually independent, so a vectorized update of a
// color class is exact Gauss-Seidel in the colored ordering (the TPU answer
// to the reference's sequential GS, amg/Solve/SSS_smooth.c:90-137).  Greedy
// first-fit in row order gives <= maxdeg+1 colors in O(nnz); the transpose
// pattern is built internally (counting sort) so asymmetric patterns are
// colored correctly.
// ---------------------------------------------------------------------------

int64_t greedy_color(
    int64_t n,
    const int64_t* ap, const int32_t* aj,
    int64_t* colors)
{
    const int64_t nnz = ap[n];
    // transpose pattern via counting sort
    std::vector<int64_t> tp((size_t)n + 1, 0);
    std::vector<int32_t> tj((size_t)nnz);
    for (int64_t k = 0; k < nnz; ++k) tp[(size_t)aj[k] + 1]++;
    for (int64_t j = 0; j < n; ++j) tp[(size_t)j + 1] += tp[(size_t)j];
    {
        std::vector<int64_t> next(tp.begin(), tp.end() - 1);
        for (int64_t i = 0; i < n; ++i)
            for (int64_t k = ap[i]; k < ap[i + 1]; ++k)
                tj[(size_t)next[(size_t)aj[k]]++] = (int32_t)i;
    }

    std::vector<int64_t> mark((size_t)n + 1, -1);  // mark[c]==i: color c taken
    for (int64_t i = 0; i < n; ++i) colors[i] = -1;
    int64_t ncolors = 0;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t j = ap[i]; j < ap[i + 1]; ++j) {
            const int64_t k = aj[j];
            if (k != i && k < n && colors[k] >= 0) mark[(size_t)colors[k]] = i;
        }
        for (int64_t j = tp[(size_t)i]; j < tp[(size_t)i + 1]; ++j) {
            const int64_t k = tj[(size_t)j];
            if (k != i && colors[k] >= 0) mark[(size_t)colors[k]] = i;
        }
        int64_t c = 0;
        while (mark[(size_t)c] == i) ++c;
        colors[i] = c;
        if (c + 1 > ncolors) ncolors = c + 1;
    }
    return ncolors;
}

}  // extern "C"
