// Windowed-gather ELL (WEll) sparse matrix-vector products for NVIDIA
// Hopper (sm_90a).
//
// Replaces the two TPU kernels of amg_tpu/ops/pallas_well.py:
//
//   _build       (B2)  y = A x           values f32 / bf16 (and f64), x f32 (f64)
//   _build_df64  (B3)  y = (A_hi + A_lo) x   values two f32 planes, x and y f64
//
// It computes what those kernels compute, not their tiling.  The operator
// is stored in row groups of 1024 rows (row g*1024 + s*128 + l at sublane
// s, lane l) and, per group, S slots; every slot k has one window start
// base[g, k] (in units of 128 columns) and per row at most one entry:
//
//   loc = (Q << 7) | r        (int16; r < 128, Q < 8)
//   col = (base[g, k] + Q[s, r]) * 128 + r,   r = loc[g, k, s, l] & 127,
//                                             Q[s, j] = loc[g, k, s, j] >> 7
//   y[g*1024 + s*128 + l] = sum_k vals[g, k, s, l] * x[col]
//
// Q of an entry is NOT stored at the entry's own lane but at lane r of the
// same sublane (the TPU resolves it with a sublane gather followed by a
// lane shuffle; amg_tpu/sparse.py:658-665).  So the block stages each
// slot's (8, 128) loc tile in shared memory and reads Q from there.
// Entries whose column is at or past the length of x read 0: the TPU
// entries zero-pad x to pad_cols on every call; here the pad is a mask.
//
// B3 on Hopper: the TPU has no f64, so pallas_well builds an f64-quality
// product from f32 arithmetic (Dekker split, TwoSum).  Hopper has f64: the
// kernel widens the two f32 value planes exactly, v = double(hi) +
// double(lo), and accumulates v * x[col] in native f64 with FMA.  The two
// planes are kept (not merged into one f64 plane) because the level-0
// f32 operator of the cycle shares the hi plane on the card.
//
// Design: one CUDA block of 1024 threads per row group, thread t = output
// row (s = t >> 7, l = t & 127), a loop over the group's S slots.  Slot
// tiles are contiguous 1024-entry runs of vals and loc, so every value
// and loc load is coalesced; the loc tile goes to a double-buffered
// shared array (one __syncthreads per slot).  The x reads gather within a
// 1024-column window per slot and are served by L1/L2 (x of a 1M-row level
// is 4 MB in f32, 8 MB in f64: it stays in the 50 MB L2).
//
// What bounds it on an H100: device-memory bytes.  Per slot entry it
// streams its value (4 B f32, 2 B bf16, 8 B for the df64 pair) and its
// loc word (2 B) for 2 flops; the row group's output is written once.
// Padding slots of a partly filled slot cost the same bytes as entries:
// the format's fill (about 35% on an RCM-ordered Delaunay FEM matrix)
// sets how far it stays from a CSR product's traffic.
//
// Bound with ctypes: plain extern "C" entries that launch on the given
// stream and return cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGroupRows = 1024;  // rows per group = threads per block

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double widen(double v) { return v; }

// Column of this thread's entry in slot tile `tile` (the staged loc tile).
__device__ __forceinline__ int64_t entry_col(const int16_t* tile, int t,
                                             int32_t base) {
  const int my = tile[t];
  const int r = my & 127;
  const int q = tile[(t & ~127) | r] >> 7;  // Q at lane r of sublane t >> 7
  return ((int64_t)base + q) * 128 + r;
}

template <typename V, typename X>
__global__ void __launch_bounds__(kGroupRows)
well_kernel(const V* __restrict__ vals, const int16_t* __restrict__ loc,
            const int32_t* __restrict__ base, int n_slots,
            const X* __restrict__ x, int64_t n_x, X* __restrict__ y) {
  __shared__ int16_t s_loc[2][kGroupRows];
  const int t = threadIdx.x;
  const int64_t g = blockIdx.x;
  X acc = X(0);
  for (int k = 0; k < n_slots; ++k) {
    const int64_t off = (g * n_slots + k) * kGroupRows;
    int16_t* tile = s_loc[k & 1];
    tile[t] = loc[off + t];
    __syncthreads();
    const int64_t col = entry_col(tile, t, base[g * n_slots + k]);
    const X xj = col < n_x ? x[col] : X(0);
    acc += X(widen(vals[off + t])) * xj;
  }
  y[g * kGroupRows + t] = acc;
}

__global__ void __launch_bounds__(kGroupRows)
well_df64_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                 const int16_t* __restrict__ loc,
                 const int32_t* __restrict__ base, int n_slots,
                 const double* __restrict__ x, int64_t n_x,
                 double* __restrict__ y) {
  __shared__ int16_t s_loc[2][kGroupRows];
  const int t = threadIdx.x;
  const int64_t g = blockIdx.x;
  double acc = 0.0;
  for (int k = 0; k < n_slots; ++k) {
    const int64_t off = (g * n_slots + k) * kGroupRows;
    int16_t* tile = s_loc[k & 1];
    tile[t] = loc[off + t];
    __syncthreads();
    const int64_t col = entry_col(tile, t, base[g * n_slots + k]);
    const double xj = col < n_x ? x[col] : 0.0;
    // exact: each f32 plane widens to f64 without rounding, and hi, lo do
    // not overlap, so their f64 sum is the packed f64 value to ~2^-48
    const double v = (double)hi[off + t] + (double)lo[off + t];
    acc = fma(v, xj, acc);
  }
  y[g * kGroupRows + t] = acc;
}

template <typename V, typename X>
int launch(const void* vals, const void* loc, const void* base,
           int64_t ngroups, int n_slots, const void* x, int64_t n_x,
           void* y, void* stream) {
  if (ngroups <= 0) return 0;
  if (ngroups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  well_kernel<V, X><<<(unsigned)ngroups, kGroupRows, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(vals), static_cast<const int16_t*>(loc),
      static_cast<const int32_t*>(base), n_slots,
      static_cast<const X*>(x), n_x, static_cast<X*>(y));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int well_f32_f32(const void* vals, const void* loc, const void* base,
                 int64_t ngroups, int n_slots, const void* x, int64_t n_x,
                 void* y, void* stream) {
  return launch<float, float>(vals, loc, base, ngroups, n_slots, x, n_x, y,
                              stream);
}

int well_bf16_f32(const void* vals, const void* loc, const void* base,
                  int64_t ngroups, int n_slots, const void* x, int64_t n_x,
                  void* y, void* stream) {
  return launch<__nv_bfloat16, float>(vals, loc, base, ngroups, n_slots, x,
                                      n_x, y, stream);
}

int well_f64_f64(const void* vals, const void* loc, const void* base,
                 int64_t ngroups, int n_slots, const void* x, int64_t n_x,
                 void* y, void* stream) {
  return launch<double, double>(vals, loc, base, ngroups, n_slots, x, n_x, y,
                                stream);
}

int well_df64(const void* hi, const void* lo, const void* loc,
              const void* base, int64_t ngroups, int n_slots, const void* x,
              int64_t n_x, void* y, void* stream) {
  if (ngroups <= 0) return 0;
  if (ngroups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  well_df64_kernel<<<(unsigned)ngroups, kGroupRows, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hi), static_cast<const float*>(lo),
      static_cast<const int16_t*>(loc), static_cast<const int32_t*>(base),
      n_slots, static_cast<const double*>(x), n_x,
      static_cast<double*>(y));
  return (int)cudaGetLastError();
}

}  // extern "C"
