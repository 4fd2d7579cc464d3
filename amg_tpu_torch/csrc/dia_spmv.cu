// Diagonal-offset (DIA) sparse matrix-vector product with fused epilogues,
// and its multi-rhs variant, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel amg_tpu/ops/pallas_dia.py::_build (entries spmv,
// resid and gs_update).  It computes what that kernel computes, not its
// blocks:
//
//   acc[i] = sum_d vals[d, i] * x[i + off_d]     (x reads 0 outside [0, pad))
//   epilogue 0 "spmv":   y = acc
//   epilogue 1 "resid":  y = b - acc
//   epilogue 2 "update": y = x + w * (b - acc)   (fused masked-GS / Jacobi)
//
// Values are (nd, pad) row-major; every vector is (pad,).  Instantiated for
// (vals, vectors) = (float, float), (bf16, float) and (double, double).
// With bf16 values, float vectors and nd >= 32 (the caller decides, as
// pallas_dia.py:140-141 does) each product takes bf16 operands -- x is
// rounded to bf16 -- and is accumulated in float.  The product of two bf16
// values is exact in float and is not rounded again: that is what the TPU
// kernel computes when amg_tpu runs it on the CPU (interpret mode), where
// XLA fuses the bf16 product into the float accumulation.  Otherwise values
// are widened and products taken in the vector type.
//
// Design: one thread per row, grid-stride loop over rows, inner loop over
// the nd diagonals in offsets order; the offsets sit in shared memory.  The
// ragged edge is masked in the kernel, so no zero-haloed copy of x is built
// (the TPU entries pad x on every call).  Any pad is taken: the TPU kernel's
// tile divisibility (pallas_dia._pick_tile) does not apply here, so e.g. the
// 1,000,000-row level 0 of poisson3d(100) runs through this kernel.
//
// What bounds it on an H100: device-memory bytes.  Per row it streams
// nd * sizeof(V) bytes of values, writes one X and reads x once plus b (and
// w) -- (2...4) * sizeof(X) -- at 2 * nd flops, far below the flop/byte
// balance point.  The nd-fold reuse of x across diagonals is served from
// L1/L2 (x at 1M rows is 4 MB in float, well inside the 50 MB L2), since
// neighbouring threads read neighbouring x entries for each diagonal and
// neighbouring vals entries, so every load is coalesced.  Shared-memory x
// windows, 16-byte vector loads and CUDA graphs over the cycle are left
// for later work.
//
// The multi-rhs product (dia_multi_kernel below) replaces the TPU kernel
// amg_tpu/ops/pallas_dia.py::_build_multi (entry spmv_multi), which the
// batched solve reaches through the custom vmap rule of every Dia product:
//
//   Y[c, i] = sum_d vals[d, i] * X[c, i + off_d]   for c in [0, k)
//
// X and Y are (k, pad) row-major, rows on the last axis.  The same dtype
// pairs and bf16 product rule as above; per column the sum runs in offsets
// order, as here and in the plain version.  Design: one thread per row,
// grid-stride loop; for each block of KB columns (KB <= 16, a compile-time
// block) the thread keeps KB register accumulators and loads each
// vals[d, i] once for the whole block, so at k = 16 the values stream from
// device memory once for all columns (the point of the TPU kernel).  Any
// k >= 1 is taken; the ragged edge is masked as above.  Bound on an H100:
// bytes again, nd * sizeof(V) + 2 * k * sizeof(X) per row at 2 * nd * k
// flops.  wgmma/TMA and shared-memory x windows are later work.
//
// Bound with ctypes: plain extern "C" entries that launch on the given
// stream and return cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename V, typename X, bool kBf16Mul>
__device__ __forceinline__ X product(V v, X xj);

template <>
__device__ __forceinline__ float product<float, float, false>(float v,
                                                              float xj) {
  return v * xj;
}

template <>
__device__ __forceinline__ double product<double, double, false>(double v,
                                                                 double xj) {
  return v * xj;
}

template <>
__device__ __forceinline__ float product<__nv_bfloat16, float, false>(
    __nv_bfloat16 v, float xj) {
  return __bfloat162float(v) * xj;
}

template <>
__device__ __forceinline__ float product<__nv_bfloat16, float, true>(
    __nv_bfloat16 v, float xj) {
  // bf16 operands; their product is exact in float
  return __bfloat162float(v) * __bfloat162float(__float2bfloat16(xj));
}

template <typename V, typename X, int kEpilogue, bool kBf16Mul>
__global__ void __launch_bounds__(kThreads)
dia_kernel(const V* __restrict__ vals, const int* __restrict__ offs, int nd,
           int64_t pad, const X* __restrict__ x, const X* __restrict__ b,
           const X* __restrict__ w, X* __restrict__ y) {
  extern __shared__ int s_offs[];
  for (int d = threadIdx.x; d < nd; d += blockDim.x) s_offs[d] = offs[d];
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < pad;
       i += stride) {
    X acc = X(0);
    for (int d = 0; d < nd; ++d) {
      const int64_t j = i + s_offs[d];
      const X xj = (j >= 0 && j < pad) ? x[j] : X(0);
      // 64-bit index: embedded operators reach nd * pad > 2^31
      const V v = vals[(int64_t)d * pad + i];
      acc += product<V, X, kBf16Mul>(v, xj);
    }
    if (kEpilogue == 0) {
      y[i] = acc;
    } else if (kEpilogue == 1) {
      y[i] = b[i] - acc;
    } else {
      y[i] = x[i] + w[i] * (b[i] - acc);
    }
  }
}

template <typename V, typename X, bool kBf16Mul>
int launch(const void* vals, const void* offs, int nd, int64_t pad,
           const void* x, const void* b, const void* w, void* y,
           int epilogue, void* stream) {
  if (pad <= 0) return 0;
  int64_t blocks = (pad + kThreads - 1) / kThreads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride
  const dim3 grid((unsigned)blocks), block(kThreads);
  const size_t smem = (size_t)(nd > 0 ? nd : 1) * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const V* v = static_cast<const V*>(vals);
  const int* o = static_cast<const int*>(offs);
  const X* xp = static_cast<const X*>(x);
  const X* bp = static_cast<const X*>(b);
  const X* wp = static_cast<const X*>(w);
  X* yp = static_cast<X*>(y);
  switch (epilogue) {
    case 0:
      dia_kernel<V, X, 0, kBf16Mul><<<grid, block, smem, s>>>(
          v, o, nd, pad, xp, bp, wp, yp);
      break;
    case 1:
      dia_kernel<V, X, 1, kBf16Mul><<<grid, block, smem, s>>>(
          v, o, nd, pad, xp, bp, wp, yp);
      break;
    case 2:
      dia_kernel<V, X, 2, kBf16Mul><<<grid, block, smem, s>>>(
          v, o, nd, pad, xp, bp, wp, yp);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The multi-rhs kernel keeps KB register accumulators per thread: the
// launcher takes the largest KB in {16, 8, 4, 2, 1} that divides k, so the
// batched solve's k = 16 is one column block and one pass over the values.
// No column of a block is masked and the row range is tested once per
// diagonal: per-column masks ran 2.6x slower on an H100 (PERF.md).
template <typename V, typename X, bool kBf16Mul, int KB>
__global__ void __launch_bounds__(kThreads)
dia_multi_kernel(const V* __restrict__ vals, const int* __restrict__ offs,
                 int nd, int64_t pad, int k, const X* __restrict__ x,
                 X* __restrict__ y) {
  extern __shared__ int s_offs[];
  for (int d = threadIdx.x; d < nd; d += blockDim.x) s_offs[d] = offs[d];
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < pad;
       i += stride) {
    for (int c0 = 0; c0 < k; c0 += KB) {
      const X* xb = x + (int64_t)c0 * pad;
      X acc[KB];
#pragma unroll
      for (int c = 0; c < KB; ++c) acc[c] = X(0);
      for (int d = 0; d < nd; ++d) {
        const int64_t j = i + s_offs[d];
        const V v = vals[(int64_t)d * pad + i];
        if (j >= 0 && j < pad) {  // x reads 0 outside [0, pad)
#pragma unroll
          for (int c = 0; c < KB; ++c) {
            acc[c] += product<V, X, kBf16Mul>(v, xb[(int64_t)c * pad + j]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < KB; ++c) y[(int64_t)(c0 + c) * pad + i] = acc[c];
    }
  }
}

template <typename V, typename X, bool kBf16Mul>
int launch_multi(const void* vals, const void* offs, int nd, int64_t pad,
                 int k, const void* x, void* y, void* stream) {
  if (pad <= 0 || k <= 0) return 0;
  int64_t blocks = (pad + kThreads - 1) / kThreads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride
  const dim3 grid((unsigned)blocks), block(kThreads);
  const size_t smem = (size_t)(nd > 0 ? nd : 1) * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const V* v = static_cast<const V*>(vals);
  const int* o = static_cast<const int*>(offs);
  const X* xp = static_cast<const X*>(x);
  X* yp = static_cast<X*>(y);
  if (k % 16 == 0) {
    dia_multi_kernel<V, X, kBf16Mul, 16><<<grid, block, smem, s>>>(
        v, o, nd, pad, k, xp, yp);
  } else if (k % 8 == 0) {
    dia_multi_kernel<V, X, kBf16Mul, 8><<<grid, block, smem, s>>>(
        v, o, nd, pad, k, xp, yp);
  } else if (k % 4 == 0) {
    dia_multi_kernel<V, X, kBf16Mul, 4><<<grid, block, smem, s>>>(
        v, o, nd, pad, k, xp, yp);
  } else if (k % 2 == 0) {
    dia_multi_kernel<V, X, kBf16Mul, 2><<<grid, block, smem, s>>>(
        v, o, nd, pad, k, xp, yp);
  } else {
    dia_multi_kernel<V, X, kBf16Mul, 1><<<grid, block, smem, s>>>(
        v, o, nd, pad, k, xp, yp);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dia_f32_f32(const void* vals, const void* offs, int nd, int64_t pad,
                const void* x, const void* b, const void* w, void* y,
                int epilogue, void* stream) {
  return launch<float, float, false>(vals, offs, nd, pad, x, b, w, y,
                                     epilogue, stream);
}

int dia_bf16_f32(const void* vals, const void* offs, int nd, int64_t pad,
                 const void* x, const void* b, const void* w, void* y,
                 int epilogue, int bf16_mul, void* stream) {
  if (bf16_mul) {
    return launch<__nv_bfloat16, float, true>(vals, offs, nd, pad, x, b, w,
                                              y, epilogue, stream);
  }
  return launch<__nv_bfloat16, float, false>(vals, offs, nd, pad, x, b, w, y,
                                             epilogue, stream);
}

int dia_f64_f64(const void* vals, const void* offs, int nd, int64_t pad,
                const void* x, const void* b, const void* w, void* y,
                int epilogue, void* stream) {
  return launch<double, double, false>(vals, offs, nd, pad, x, b, w, y,
                                       epilogue, stream);
}

int dia_multi_f32_f32(const void* vals, const void* offs, int nd,
                      int64_t pad, int k, const void* x, void* y,
                      void* stream) {
  return launch_multi<float, float, false>(vals, offs, nd, pad, k, x, y,
                                           stream);
}

int dia_multi_bf16_f32(const void* vals, const void* offs, int nd,
                       int64_t pad, int k, const void* x, void* y,
                       int bf16_mul, void* stream) {
  if (bf16_mul) {
    return launch_multi<__nv_bfloat16, float, true>(vals, offs, nd, pad, k,
                                                    x, y, stream);
  }
  return launch_multi<__nv_bfloat16, float, false>(vals, offs, nd, pad, k, x,
                                                   y, stream);
}

int dia_multi_f64_f64(const void* vals, const void* offs, int nd,
                      int64_t pad, int k, const void* x, void* y,
                      void* stream) {
  return launch_multi<double, double, false>(vals, offs, nd, pad, k, x, y,
                                             stream);
}

}  // extern "C"
