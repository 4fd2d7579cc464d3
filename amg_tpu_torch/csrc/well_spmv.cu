// WEll sparse matrix-vector products for NVIDIA Hopper (sm_90a).
//
// Replaces the two TPU kernels of amg_tpu/ops/pallas_well.py:
//
//   _build       (B2)  y = A x           values f32 / bf16 (and f64), x f32 (f64)
//   _build_df64  (B3)  y = (A_hi + A_lo) x   values two f32 planes, x and y f64
//
// It computes what those kernels compute, not their tiling.  The TPU
// stores the operator as WEll (windowed-gather ELL: row groups of 1024
// rows, S slots per group, every slot's columns inside one 1024-column
// window of x) because its gathers are slow; the port keeps that pack
// array for array (the tests hold it equal to amg_tpu's) and derives from
// it, once per operator and on the card, the layout these kernels read
// (amg_tpu_torch/sparse.py::RowSlices):
//
//   rows in slices of 32 (SELL-32), each segment of rows (a GS class, or
//   all rows) cut into its own slices; slot row t = 32 * slice + lane is
//   output row row_idx[t] (-1: unused lane) with row_len[t] entries, and
//   entry j of slot row t sits at slice_ptr[t / 32] + 32 * j + t % 32 of
//   cols (int32) and vals.  Padding slots of the pack are dropped.
//
// Design: one thread per slot row, blocks of 256 threads (8 slices).  A
// thread loops to its own row length only; for each j the 32 lanes of a
// warp read 32 consecutive column words and values (one coalesced run),
// lanes past their row's end read nothing, and no block-wide barrier is
// needed.  Entries go in predicated batches of 4 (all lanes of a warp run
// the same batch, so each j stays one coalesced run), which gives each
// thread 4 independent loads in flight; batches of 8, and an unpredicated
// batch loop with a one-entry tail, were slower on the H100.  x is
// gathered through the read-only path: x of a 1M-row level is 4 MB in f32
// and 8 MB in f64 and stays in the 50 MB L2; the streamed columns and
// values are loaded with the evict-first hint (__ldcs) so they do not
// push x out.  Columns at or past the length of x read 0 (the TPU
// entries zero-pad x to pad_cols on every call; here the pad is a mask).
// Values are widened exactly to x's type and accumulated with FMA in it.
//
// Entries (all extern "C", launched on the caller's stream, returning
// cudaGetLastError()):
//
//   rows_spmv_<v>_<x>  B2: y[row] = sum_j v_j x[c_j - col0] over all slices
//   rows_df64          B3: the same with v_j = double(hi_j) + double(lo_j)
//                      (exact: each f32 plane widens to f64 without
//                      rounding, and hi, lo do not overlap)
//
// col0 is the column that x[0] holds: 0 for a whole vector; for the
// window entry of a ring of row shards (amg_tpu_torch/parallel/halo.py)
// x is one process's haloed block of the input vector, [left halo | its
// shards | right halo], and col0 the global column of its first entry.
// A column whose c - col0 falls outside [0, n_x) reads 0, which is both
// the zero past the end of a short x and the zero the ring puts beyond the
// mesh edges.  The single-vector entries pass col0 = 0: one kernel, one
// summation order, so the window entry's results equal the single-device
// ones bit for bit on the same x values.
//   rows_gs_<v>_<x>    B2's Gauss-Seidel class update, over the slices of
//                      one class only, IN PLACE on x:
//                        t = (b - ax + diag * x) * inv_diag
//                        t = (1 - relax) * x + relax * t   (with relax)
//                        x[row] = inv_diag != 0 ? t : x[row]
//                      each operation rounded as the torch expression of
//                      amg_tpu_torch/solve/smoothers.py rounds it.  Safe
//                      in place: rows of one class do not couple, so a row
//                      reads only other classes' entries of x and its own.
//
// What bounds them on an H100: device-memory bytes.  The row-slice
// product streams per nonzero its value (4 B f32, 2 B bf16, 8 B f64 or the
// df64 pair) and its column (4 B), per slot row its length and output row
// (8 B), x once (from L2 after the first touch) and y once: 2 flops per
// 6-12 bytes, far below the tensor cores' ratio, so neither tensor cores
// nor TMA apply.  The levers are bytes (no padding slots), coalescing, no
// barriers and x from L2.  A walk over the pack itself would stream every
// slot entry, filled or not (22.5% are filled on an RCM-ordered Delaunay
// FEM level), and pay one __syncthreads per slot to stage the loc tile
// for the lookup of Q, which lives in another lane.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSlice = 32;    // rows per slice (one warp)
constexpr int kBlock = 256;   // threads per block of the row-slice kernels

// ---- loads -----------------------------------------------------------------

// streamed once: evict-first, so that x stays in L2
__device__ __forceinline__ float ld_val(const float* p) { return __ldcs(p); }
__device__ __forceinline__ double ld_val(const double* p) { return __ldcs(p); }
__device__ __forceinline__ float ld_val(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcs(reinterpret_cast<const unsigned short*>(p))));
}

// one value plane, widened to the vector type X
template <typename V, typename X>
struct OnePlane {
  const V* v;
  __device__ __forceinline__ X operator()(int64_t p) const {
    return X(ld_val(v + p));
  }
};

// the df64 pair: exact widening of both f32 planes
struct TwoPlanes {
  const float* hi;
  const float* lo;
  __device__ __forceinline__ double operator()(int64_t p) const {
    return (double)ld_val(hi + p) + (double)ld_val(lo + p);
  }
};

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}

// x read through the read-only path where nothing writes x during the
// launch (the products); by a plain load where the launch updates x (gs)
template <bool kReadOnly, typename X>
__device__ __forceinline__ X ld_x(const X* x, int64_t c) {
  if constexpr (kReadOnly) return __ldg(x + c);
  return x[c];
}

constexpr int kBatch = 4;   // entries whose loads a thread issues together

// sum_j v_j x[c_j - col0] over the row_len entries of the slot row whose
// first entry is at place p, in order of j.  Entries go in batches of
// kBatch: all columns and values of a batch are loaded, then all its x
// entries, so that a thread has kBatch independent loads in flight
// instead of one chain of column -> x -> FMA per entry.
template <bool kReadOnly, typename X, typename Vals>
__device__ __forceinline__ X row_sum(const Vals& vals,
                                     const int32_t* __restrict__ cols,
                                     int64_t p, int len, const X* x,
                                     int64_t col0, int64_t n_x) {
  X acc = X(0);
  for (int j = 0; j < len; j += kBatch, p += kBatch * kSlice) {
    int64_t k[kBatch];   // place in x, -1 past the row's end
    X v[kBatch], xv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool in = j + u < len;
      k[u] = in ? (int64_t)__ldcs(cols + p + u * kSlice) - col0 : -1;
      v[u] = in ? vals(p + u * kSlice) : X(0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      xv[u] = (k[u] >= 0 && k[u] < n_x) ? ld_x<kReadOnly>(x, k[u]) : X(0);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (j + u < len) acc = fma_(v[u], xv[u], acc);
  }
  return acc;
}

// ---- rounded arithmetic of the GS epilogue (no FMA contraction) ------------

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// ---- row-slice kernels -----------------------------------------------------

template <typename X, typename Vals>
__global__ void __launch_bounds__(kBlock)
rows_spmv_kernel(Vals vals, const int32_t* __restrict__ cols,
                 const int64_t* __restrict__ slice_ptr,
                 const int32_t* __restrict__ row_len,
                 const int32_t* __restrict__ row_idx, int64_t n_slot_rows,
                 const X* __restrict__ x, int64_t col0, int64_t n_x,
                 X* __restrict__ y) {
  const int64_t t = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (t >= n_slot_rows) return;
  const int row = row_idx[t];
  if (row < 0) return;
  const int64_t p = slice_ptr[t / kSlice] + (t % kSlice);
  y[row] = row_sum<true>(vals, cols, p, row_len[t], x, col0, n_x);
}

template <typename X, typename V>
__global__ void __launch_bounds__(kBlock)
rows_gs_kernel(OnePlane<V, X> vals, const int32_t* __restrict__ cols,
               const int64_t* __restrict__ slice_ptr,
               const int32_t* __restrict__ row_len,
               const int32_t* __restrict__ row_idx, int64_t slot0,
               int64_t n_slot_rows, X* x, int64_t n_x,
               const X* __restrict__ b, const X* __restrict__ diag,
               const X* __restrict__ inv_diag, X one_minus_relax, X relax,
               int has_relax) {
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_slot_rows) return;
  const int64_t t = slot0 + i;
  const int row = row_idx[t];
  if (row < 0) return;
  const int64_t p = slice_ptr[t / kSlice] + (t % kSlice);
  const X ax = row_sum<false>(vals, cols, p, row_len[t], x, 0, n_x);
  const X xi = x[row];
  const X w = inv_diag[row];
  X v = mul_rn(add_rn(sub_rn(b[row], ax), mul_rn(diag[row], xi)), w);
  if (has_relax) v = add_rn(mul_rn(one_minus_relax, xi), mul_rn(relax, v));
  x[row] = w != X(0) ? v : xi;
}

unsigned blocks_for(int64_t n_threads) {
  return (unsigned)((n_threads + kBlock - 1) / kBlock);
}

bool bad_size(int64_t n_threads) {
  return n_threads < 0 || (n_threads + kBlock - 1) / kBlock > 0x7fffffffLL;
}

template <typename V, typename X>
int launch_rows(const void* vals, const void* cols, const void* slice_ptr,
                const void* row_len, const void* row_idx,
                int64_t n_slot_rows, const void* x, int64_t n_x,
                int64_t col0, void* y, void* stream) {
  if (bad_size(n_slot_rows)) return (int)cudaErrorInvalidValue;
  if (n_slot_rows == 0) return 0;
  rows_spmv_kernel<X, OnePlane<V, X>>
      <<<blocks_for(n_slot_rows), kBlock, 0,
         static_cast<cudaStream_t>(stream)>>>(
          OnePlane<V, X>{static_cast<const V*>(vals)},
          static_cast<const int32_t*>(cols),
          static_cast<const int64_t*>(slice_ptr),
          static_cast<const int32_t*>(row_len),
          static_cast<const int32_t*>(row_idx), n_slot_rows,
          static_cast<const X*>(x), col0, n_x, static_cast<X*>(y));
  return (int)cudaGetLastError();
}

template <typename V, typename X>
int launch_gs(const void* vals, const void* cols, const void* slice_ptr,
              const void* row_len, const void* row_idx, int64_t slot0,
              int64_t n_slot_rows, void* x, int64_t n_x, const void* b,
              const void* diag, const void* inv_diag,
              double one_minus_relax, double relax, int has_relax,
              void* stream) {
  if (bad_size(n_slot_rows) || slot0 < 0) return (int)cudaErrorInvalidValue;
  if (n_slot_rows == 0) return 0;
  rows_gs_kernel<X, V><<<blocks_for(n_slot_rows), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      OnePlane<V, X>{static_cast<const V*>(vals)},
      static_cast<const int32_t*>(cols),
      static_cast<const int64_t*>(slice_ptr),
      static_cast<const int32_t*>(row_len),
      static_cast<const int32_t*>(row_idx), slot0, n_slot_rows,
      static_cast<X*>(x), n_x, static_cast<const X*>(b),
      static_cast<const X*>(diag), static_cast<const X*>(inv_diag),
      X(one_minus_relax), X(relax), has_relax);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ---- row slices: B2 (spmv, gs) and B3 (df64) --------------------------------

#define ROWS_ENTRIES(SUFFIX, V, X)                                           \
  int rows_spmv_##SUFFIX(const void* vals, const void* cols,                 \
                         const void* slice_ptr, const void* row_len,         \
                         const void* row_idx, int64_t n_slot_rows,           \
                         const void* x, int64_t n_x, int64_t col0, void* y,  \
                         void* stream) {                                     \
    return launch_rows<V, X>(vals, cols, slice_ptr, row_len, row_idx,        \
                             n_slot_rows, x, n_x, col0, y, stream);          \
  }                                                                          \
  int rows_gs_##SUFFIX(const void* vals, const void* cols,                   \
                       const void* slice_ptr, const void* row_len,           \
                       const void* row_idx, int64_t slot0,                   \
                       int64_t n_slot_rows, void* x, int64_t n_x,            \
                       const void* b, const void* diag,                      \
                       const void* inv_diag, double one_minus_relax,         \
                       double relax, int has_relax, void* stream) {          \
    return launch_gs<V, X>(vals, cols, slice_ptr, row_len, row_idx, slot0,   \
                           n_slot_rows, x, n_x, b, diag, inv_diag,           \
                           one_minus_relax, relax, has_relax, stream);       \
  }

ROWS_ENTRIES(f32_f32, float, float)
ROWS_ENTRIES(bf16_f32, __nv_bfloat16, float)
ROWS_ENTRIES(f64_f64, double, double)

#undef ROWS_ENTRIES

int rows_df64(const void* hi, const void* lo, const void* cols,
              const void* slice_ptr, const void* row_len,
              const void* row_idx, int64_t n_slot_rows, const void* x,
              int64_t n_x, int64_t col0, void* y, void* stream) {
  if (bad_size(n_slot_rows)) return (int)cudaErrorInvalidValue;
  if (n_slot_rows == 0) return 0;
  rows_spmv_kernel<double, TwoPlanes>
      <<<blocks_for(n_slot_rows), kBlock, 0,
         static_cast<cudaStream_t>(stream)>>>(
          TwoPlanes{static_cast<const float*>(hi),
                    static_cast<const float*>(lo)},
          static_cast<const int32_t*>(cols),
          static_cast<const int64_t*>(slice_ptr),
          static_cast<const int32_t*>(row_len),
          static_cast<const int32_t*>(row_idx), n_slot_rows,
          static_cast<const double*>(x), col0, n_x,
          static_cast<double*>(y));
  return (int)cudaGetLastError();
}

}  // extern "C"
