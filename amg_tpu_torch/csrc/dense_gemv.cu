// Dense matrix-vector product of a bf16 operator with an f32 vector (D1),
// on NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel.  It replaces XLA's fused convert + dot of
// amg_tpu/ops/spmv.py:134-136 (spmv_dense, `a.vals @ x`): where the values
// of a Dense level are stored in bf16 (coarse_op_dtype "bfloat16") and the
// cycle runs in f32, XLA folds the widening of each value into the dot.
// Without this kernel the port widens the whole operator to an f32 copy in
// device memory and then runs cuBLAS's f32 gemv on the copy: it reads the
// bf16 values, writes and reads back twice their bytes, every product.
//
//   y[r] = sum_c float(A[r, c]) * x[c]      r in [0, rows), c in [0, cols)
//
// A is row-major bf16 with leading dimension ld (a row range of a Dense
// operator is its values pointer advanced by the first row); x and y are
// f32.  Each value is widened exactly to f32 and multiplied and summed in
// f32, with FMA, as the widened copy's f32 gemv computes it; only the order
// of the sum differs.  That order depends on cols alone, not on rows or on
// the first row, so a row range gives the same bits as the whole product.
//
// What bounds it on an H100: device-memory bytes.  It reads each value once
// and x once and writes y once, rows * cols * 2 + (rows + cols) * 4 bytes,
// at 2 flops per value: 1 flop per byte, far below the card's balance
// point, so tensor cores do not apply.  At the 6,400 x 6,400 level 4 of
// poisson3d(100) that is 82 MB, 24.5 us at 3.35 TB/s.
//
// Design, to reach that bound:
//  * One block of kThreads threads per row.  Thread t takes the 16-byte
//    runs of 8 values j = t, t + kThreads, ... of the row, so a warp reads
//    512 consecutive bytes per load, and issues the loads of its kUnroll
//    runs and of their x before any product: a row of level 4 (800 runs)
//    is one round trip of loads.  (Left to the compiler, the x loads
//    waited for the values: 34 registers instead of ~60, 6% slower.)
//    Short blocks, many of them (one per row), keep the latency chain of
//    each short and let the block scheduler balance the SMs: a warp per
//    row (25 runs a lane, 7 round trips) ran at 66% of the bound on
//    level 4, several rows per warp or per block slower still (PERF.md).
//  * Dense pads rows to 8 and columns to 128, so every row starts on a
//    16-byte boundary and has no ragged tail.  Values are streamed with
//    the evict-first hint (__ldcs), so that they do not push x out of L2;
//    other hints (no L1 allocation, an L2 evict-first policy, 256-byte L2
//    prefetch) measured the same.
//  * x is read as two float4 per run through the read-only path: 25.6 KB
//    at level 4 (89 KB at the widest Dense level the default
//    dense_level_bytes admits), served by L1 and L2.  Staging it in
//    shared memory was slower.
//  * Each thread sums its runs in order, a warp-shuffle reduction sums
//    the 32 lanes, and thread 0 sums the warps' partials in order and
//    writes y.  No allocation: the wrapper makes y with torch.empty on the
//    caller's stream, so a CUDA graph capture holds the launch as it holds
//    B1's.
//  * Where a row does not start on a 16-byte boundary (cols or ld not a
//    multiple of 8, or an unaligned pointer) the same kernel reads value by
//    value (kVec false): right, not fast.
//
// Entry (extern "C", launched on the caller's stream, returning
// cudaGetLastError()):
//
//   dense_gemv_bf16_f32(a, ld, rows, cols, vec, x, y, stream)

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // threads per block, one row a block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;             // 16-byte runs a thread has in flight

// the exact f32 values of the bf16 pair in one 32-bit word (low half first)
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// acc + the 8 products of one 16-byte run of values with x[8j .. 8j + 8)
__device__ __forceinline__ float dot8(uint4 v, float4 a, float4 b,
                                      float acc) {
  acc = fmaf(lo_bf16(v.x), a.x, acc);
  acc = fmaf(hi_bf16(v.x), a.y, acc);
  acc = fmaf(lo_bf16(v.y), a.z, acc);
  acc = fmaf(hi_bf16(v.y), a.w, acc);
  acc = fmaf(lo_bf16(v.z), b.x, acc);
  acc = fmaf(hi_bf16(v.z), b.y, acc);
  acc = fmaf(lo_bf16(v.w), b.z, acc);
  acc = fmaf(hi_bf16(v.w), b.w, acc);
  return acc;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dense_gemv_kernel(const __nv_bfloat16* __restrict__ a, int64_t ld,
                  int64_t cols, const float* __restrict__ x,
                  float* __restrict__ y) {
  __shared__ float part[kWarps];
  const int t = threadIdx.x;
  const int64_t r = blockIdx.x;
  const __nv_bfloat16* row = a + r * ld;
  float acc = 0.f;
  if constexpr (kVec) {
    const int64_t n = cols / 8;   // 16-byte runs per row
    const uint4* v4 = reinterpret_cast<const uint4*>(row);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int64_t k = t; k < n; k += kThreads * kUnroll) {
      // every load of the batch is issued before any product
      uint4 v[kUnroll];
      float4 xa[kUnroll], xb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = k + kThreads * u;
        if (j < n) {
          v[u] = __ldcs(v4 + j);
          xa[u] = __ldg(x4 + 2 * j);
          xb[u] = __ldg(x4 + 2 * j + 1);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (k + kThreads * u < n) acc = dot8(v[u], xa[u], xb[u], acc);
    }
  } else {
    for (int64_t c = t; c < cols; c += kThreads)
      acc = fmaf(__bfloat162float(row[c]), __ldg(x + c), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((t & 31) == 0) part[t / 32] = acc;
  __syncthreads();
  if (t == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w];
    y[r] = s;
  }
}

int launch(const void* a, int64_t ld, int64_t rows, int64_t cols, int vec,
           const void* x, void* y, void* stream) {
  if (rows < 0 || cols < 0 || ld < cols || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (vec && (cols % 8 || ld % 8)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const auto* av = static_cast<const __nv_bfloat16*>(a);
  const auto* xv = static_cast<const float*>(x);
  auto* yv = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    dense_gemv_kernel<true><<<(unsigned)rows, kThreads, 0, s>>>(
        av, ld, cols, xv, yv);
  else
    dense_gemv_kernel<false><<<(unsigned)rows, kThreads, 0, s>>>(
        av, ld, cols, xv, yv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dense_gemv_bf16_f32(const void* a, int64_t ld, int64_t rows,
                        int64_t cols, int vec, const void* x, void* y,
                        void* stream) {
  return launch(a, ld, rows, cols, vec, x, y, stream);
}

}  // extern "C"
