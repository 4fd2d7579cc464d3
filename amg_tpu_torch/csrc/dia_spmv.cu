// Diagonal-offset (DIA) sparse matrix-vector product with fused epilogues,
// for one vector (B1) and for a batch of k vectors (B4), on NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels amg_tpu/ops/pallas_dia.py::_build (entries
// spmv, resid and gs_update) and ::_build_multi (entry spmv_multi).  It
// computes what they compute, not their blocks; B4 also takes B1's
// epilogues, over the batch:
//
//   acc[c, i] = sum_d vals[d, i] * x[c, i + off_d]   (x reads 0 outside
//                                                      [0, pad))
//   epilogue 0 "spmv":   y[c] = acc[c]
//   epilogue 1 "resid":  y[c] = b[c] - acc[c]
//   epilogue 2 "update": y[c] = x[c] + w * (b[c] - acc[c])  (fused masked
//                                                      GS / Jacobi)
//
// Values are (nd, pad) row-major; x, b and y are (k, pad) row-major (k = 1
// for B1), w is one (pad,) vector shared by all columns.  Instantiated for
// (vals, vectors) = (float, float), (bf16, float) and (double, double).
// With bf16 values, float vectors and nd >= 32 (the caller decides, as
// pallas_dia.py:140-141 does) each product takes bf16 operands -- x is
// rounded to bf16 at the product -- and is accumulated in float.  The
// product of two bf16 values is exact in float and is not rounded again:
// that is what the TPU kernel computes when amg_tpu runs it on the CPU
// (interpret mode).  Otherwise values are widened and products taken in
// the vector type.  Per row both kernels sum in offsets order and write
// the epilogue as the same expression, so B4 at k = 1 computes what B1
// computes.
//
// What bounds them on an H100: device-memory bytes.  Per row they stream
// nd * sizeof(V) bytes of values, and per column read x once (and b) and
// write y once, at 2 * nd flops per column: far below the flop/byte
// balance point.
//
// B1's design.  The first port (one thread per row, one value and one x
// load per diagonal) kept one or two loads in flight per thread and read x
// from L2 once per diagonal, 33-46% of the bound on the main path's f32
// and bf16 operators.
//
//  * R consecutive rows per thread, R = 16 / sizeof(V) (4 f32, 8 bf16, 2
//    f64), so one diagonal's values for the thread are one 16-byte load,
//    streamed with the evict-first hint so that they do not push x out of
//    L2; diagonals in batches of kBatch, whose values are loaded before
//    any of them is used, so each thread has several loads in flight.
//  * A plan made on the host (dia_kernel.py::plan) splits the diagonals,
//    in offsets order, into runs of consecutive offsets whose span fits
//    kMaxSpan.  A run of two or more diagonals is served from a
//    shared-memory window of x, the block's rows plus the run's span,
//    filled with cp.async (zero-filled outside x's bounds), so x crosses
//    from L2 once per run instead of once per diagonal: 3 times per row on
//    poisson3d(100)'s level 0 instead of 7, 5 on level 1 instead of 23.  A
//    run of one diagonal reads x straight through the read-only path (a
//    window would be read once), as two aligned vectors from which the
//    thread picks its R entries by the offset's residue (the same for
//    every thread), so a warp reads whole lines.
//  * The windows of up to nw runs (nw from a shared-memory budget,
//    kWindowBudget) are filled together at the start of the block, so the
//    fill overlaps the direct diagonals ahead of the first run, and waited
//    for once.
//  * A window is stored split by row residue: entry e sits at
//    (e mod R) * wq + e / R, so that for each of its R rows a warp reads
//    32 consecutive words and no two lanes share a bank (wq is padded to
//    32 / R words modulo 32, which keeps the fill conflict-free too).
//  * b, w, the centre x of the update and y move as vectors.  The centre x
//    is read from x itself: the unrounded value also in the bf16-products
//    case (pallas_dia.py keeps it from before the bf16 cast).  Vectors need
//    pad to be a multiple of R and every pointer to be 16-byte aligned;
//    otherwise the same kernel loads and stores entry by entry.
//
// B4's design: the first port's loop -- one thread per row, KB register
// accumulators (KB the column block, a template parameter: 16, 8, 4, 2 or
// 1, the largest dividing k), each value loaded once for the KB columns, x read
// through L1, which serves the reuse between neighbouring diagonals -- and
// B1's resid and update epilogues, so that the batched GS update and the
// batched residual are one pass over the batch instead of a product and
// three (one) elementwise passes.  Shared-memory windows per column block
// and batched value loads were built and measured for B4 on an H100: at
// the batched solve's k = 16 they ran 10-85% slower than this loop
// (PERF.md), so B4 does not use them.
//
// B1's window entry (dia_window_*) replaces pallas_dia.py::spmv_window
// (:495-503), the local product of a row-sharded ring (amg_tpu/parallel/
// halo.py): the same kernel, run for S shards of m rows at once (the
// shards are the grid's y dimension), each reading its values at column
// s * m of the (nd, S * m) values through their row stride, and x from
// its own haloed window [lo left halo | m rows | hi right halo], which
// reads 0 outside [-lo, m + hi) of the shard's rows instead of outside
// [0, pad).  The single-vector entries are the case S = 1, the window
// [0, pad) and the row stride pad.  Windows may overlap in memory (their
// shard stride is free), so a ring's windows are views of one haloed
// vector.  Only the spmv epilogue has a window entry.
//
// Bound with ctypes: plain extern "C" entries that launch on the given
// stream and return cudaGetLastError() (or the error of the attribute
// call), so a refused launch raises in the wrapper.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSpan = 256;  // widest windowed run (dia_kernel.WINDOW_SPAN)
constexpr int kBatch = 4;      // B1: diagonals whose loads go out together
constexpr int kBlockRows = 1024;   // rows per block of B1 (f32, bf16)
constexpr int kMultiThreads = 256;  // threads per block of B4
constexpr int kWindowBudget = 100 * 1024;  // shared memory for B1's windows

// One launch of B1.  The plan holds n_segs int4 segments (first diagonal,
// one past the last, the run's lowest offset, its span; span -1: x read
// directly).  Shard s (blockIdx.y) reads values from vals + s * pad with
// row stride vstride, x from x + s * xs (valid on [x_lo, x_hi) of its
// rows), and writes b, w and y at s * pad.
struct Args {
  const void* vals;
  const int* offs;
  const int4* plan;
  int n_segs;
  int nw;    // windows filled together
  int slot;  // entries of shared memory per window
  int wq;    // row stride of the window (entries)
  int64_t pad;      // rows per shard
  int64_t vstride;  // values: entries from one diagonal to the next
  int64_t xs;       // x: entries from one shard's window to the next
  int64_t x_lo;     // x reads 0 outside [x_lo, x_hi) of the shard's rows
  int64_t x_hi;
  const void* x;
  const void* b;
  const void* w;
  void* y;
  int vec;  // vector loads and stores allowed
};

template <typename V>
struct B1Cfg {
  static constexpr int R = 16 / (int)sizeof(V);  // rows per thread
  // threads per block: 1024 rows; f64 128 threads (256 rows), the
  // fastest of 512, 256 and 128 on an H100 (PERF.md)
  static constexpr int T = sizeof(V) == 8 ? 128 : kBlockRows / R;
  static constexpr int BR = T * R;  // rows per block
};

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

template <typename T>
__device__ __forceinline__ T zero() {
  return T(0.0f);
}

// N consecutive entries of one thread, aligned for a vector load.
template <typename T, int N>
struct alignas(16) Row {
  T v[N];
};

// r = p[i .. i + N), 0 outside [lo, hi): vector loads when vec (then i is
// a multiple of N and p 16-byte aligned) and the whole row lies inside,
// else one load per entry.
template <bool kStream, typename T, int N>
__device__ __forceinline__ void load_row(Row<T, N>& r,
                                         const T* __restrict__ p, int64_t i,
                                         int64_t lo, int64_t hi, bool vec) {
  constexpr int kBytes = N * (int)sizeof(T);
  static_assert(kBytes % 16 == 0, "rows of 16-byte vectors");
  if (vec && i >= lo && i + N <= hi) {
    const uint4* s = reinterpret_cast<const uint4*>(p + i);
    uint4* d = reinterpret_cast<uint4*>(r.v);
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q) {
      d[q] = kStream ? __ldcs(s + q) : __ldg(s + q);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      r.v[j] = (i + j >= lo && i + j < hi) ? p[i + j] : zero<T>();
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_row(T* __restrict__ p, int64_t i,
                                          int64_t pad, bool vec,
                                          const Row<T, N>& r) {
  if (vec && i < pad) {
#pragma unroll
    for (int q = 0; q < N * (int)sizeof(T) / 16; ++q) {
      reinterpret_cast<uint4*>(p + i)[q] =
          reinterpret_cast<const uint4*>(r.v)[q];
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (i + j < pad) p[i + j] = r.v[j];
    }
  }
}

// out[j] = (lo, hi)[j + A]: the N entries that start A into lo.
template <int A, typename T, int N>
__device__ __forceinline__ void pick(Row<T, N>& out, const Row<T, N>& lo,
                                     const Row<T, N>& hi) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    out.v[j] = j + A < N ? lo.v[(j + A) % N] : hi.v[(j + A) % N];
  }
}

// out = p[g .. g + N), 0 outside [x_lo, x_hi), for g = i + off with i a
// multiple of N: two aligned vectors and a pick by off mod N when vec.
template <typename T, int N>
__device__ __forceinline__ void load_shifted(Row<T, N>& out,
                                             const T* __restrict__ p,
                                             int64_t i, int off, int64_t x_lo,
                                             int64_t x_hi, bool vec) {
  const int a = off & (N - 1);  // the same for every thread
  const int64_t base = i + off - a;
  if (vec && base >= x_lo && base + (a ? 2 * N : N) <= x_hi) {
    Row<T, N> lo, hi;
    load_row<false>(lo, p, base, x_lo, x_hi, true);
    if (a == 0) {
      out = lo;
      return;
    }
    load_row<false>(hi, p, base + N, x_lo, x_hi, true);
    switch (a) {
#define DIA_PICK(A)                              \
  case A:                                        \
    if constexpr (A < N) pick<A>(out, lo, hi); \
    break;
      DIA_PICK(1)
      DIA_PICK(2)
      DIA_PICK(3)
      DIA_PICK(4)
      DIA_PICK(5)
      DIA_PICK(6)
      DIA_PICK(7)
#undef DIA_PICK
      default:
        break;
    }
  } else {
    load_row<false>(out, p, i + off, x_lo, x_hi, false);
  }
}

// Asynchronous copy of one entry into shared memory; zero-filled (nothing
// read) when !in.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(kBytes), "r"(in ? kBytes : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Walks the plan in offsets order.  fill(seg, slot) issues the copies of a
// run's window into slot `slot`; body(seg, slot) computes a segment (slot
// -1: a direct one).  Windows are staged nw at a time: the first stage
// before the first segment, the next when a run past it comes up.
template <typename Fill, typename Body>
__device__ __forceinline__ void walk_plan(const Args& a, Fill&& fill,
                                          Body&& body) {
  auto stage = [&](int from) {
    int n = 0, e = from;
    for (; e < a.n_segs && n < a.nw; ++e) {
      const int4 q = __ldg(a.plan + e);
      if (q.w >= 0) fill(q, n++);
    }
    return e;
  };
  int staged_to = stage(0);
  bool ready = false;
  int slot = 0;
  for (int s = 0; s < a.n_segs; ++s) {
    const int4 sg = __ldg(a.plan + s);
    if (sg.w < 0) {
      body(sg, -1);
      continue;
    }
    if (s >= staged_to) {  // every staged window has been read
      __syncthreads();
      staged_to = stage(s);
      slot = 0;
      ready = false;
    }
    if (!ready) {
      cp_async_wait_all();
      __syncthreads();
      ready = true;
    }
    body(sg, slot++);
  }
}

// ---------------------------------------------------------------------------
// B1
// ---------------------------------------------------------------------------

template <typename V, typename X, bool kBf16Mul, int kEpi>
__global__ void __launch_bounds__(B1Cfg<V>::T) dia_kernel(Args a) {
  constexpr int R = B1Cfg<V>::R, T = B1Cfg<V>::T, BR = B1Cfg<V>::BR;
  extern __shared__ __align__(16) unsigned char smem[];
  X* win = reinterpret_cast<X*>(smem);
  const int64_t pad = a.pad;
  const int64_t shard = blockIdx.y;
  const V* __restrict__ vals = static_cast<const V*>(a.vals) + shard * pad;
  const X* __restrict__ x = static_cast<const X*>(a.x) + shard * a.xs;
  // b and w exist for the resid and update epilogues only
  const X* __restrict__ b =
      kEpi > 0 ? static_cast<const X*>(a.b) + shard * pad : nullptr;
  const X* __restrict__ w =
      kEpi > 1 ? static_cast<const X*>(a.w) + shard * pad : nullptr;
  const int64_t x_lo = a.x_lo, x_hi = a.x_hi;
  const int wq = a.wq;
  const bool vec = a.vec != 0;
  const int t = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * BR;
  const int64_t i0 = row0 + (int64_t)t * R;  // the thread's first row

  X acc[R];
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = X(0);

  auto fill = [&](int4 sg, int slot) {
    // rows [row0 + lo, row0 + BR + lo + span), split by residue
    X* ws = win + slot * a.slot;
    const int64_t g0 = row0 + sg.z;
    for (int e = t; e < BR + sg.w; e += T) {
      const int64_t g = g0 + e;
      const bool in = g >= x_lo && g < x_hi;
      cp_async<sizeof(X)>(ws + (e % R) * wq + e / R, in ? x + g : x, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto body = [&](int4 sg, int slot) {
    const X* ws = win + slot * a.slot;
    for (int d = sg.x; d < sg.y; d += kBatch) {
      const int n = sg.y - d < kBatch ? sg.y - d : kBatch;
      Row<V, R> v[kBatch];
      int off[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u < n) {
          off[u] = __ldg(a.offs + d + u);
          load_row<true>(v[u], vals + (int64_t)(d + u) * a.vstride, i0, 0,
                         pad, vec);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u >= n) continue;
        if (slot < 0) {
          Row<X, R> xs;
          load_shifted(xs, x, i0, off[u], x_lo, x_hi, vec);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            acc[j] += product<V, X, kBf16Mul>(v[u].v[j], xs.v[j]);
          }
        } else {
          const int co = off[u] - sg.z;  // into the window, >= 0
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const unsigned e = (unsigned)(j + co);
            acc[j] += product<V, X, kBf16Mul>(
                v[u].v[j], ws[(e % R) * wq + t + e / R]);
          }
        }
      }
    }
  };
  walk_plan(a, fill, body);

  Row<X, R> out;
  if constexpr (kEpi == 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) out.v[j] = acc[j];
  } else {
    Row<X, R> bv;
    load_row<true>(bv, b, i0, 0, pad, vec);
    if constexpr (kEpi == 1) {
#pragma unroll
      for (int j = 0; j < R; ++j) out.v[j] = bv.v[j] - acc[j];
    } else {
      Row<X, R> xv, wv;
      load_row<false>(xv, x, i0, 0, pad, vec);
      load_row<true>(wv, w, i0, 0, pad, vec);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        out.v[j] = xv.v[j] + wv.v[j] * (bv.v[j] - acc[j]);
      }
    }
  }
  store_row(static_cast<X*>(a.y) + shard * pad, i0, pad, vec, out);
}

// ---------------------------------------------------------------------------
// B4
// ---------------------------------------------------------------------------

// One thread per row (grid-stride), KB register accumulators, each value
// loaded once for the KB columns, the offsets in shared memory, the row
// range tested once per diagonal.
template <typename V, typename X, bool kBf16Mul, int KB, int kEpi>
__global__ void __launch_bounds__(kMultiThreads)
    dia_multi_kernel(const V* __restrict__ vals, const int* __restrict__ offs,
                     int nd, int64_t pad, int k, const X* __restrict__ x,
                     const X* __restrict__ b, const X* __restrict__ w,
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
      for (int c = 0; c < KB; ++c) {
        const int64_t at = (int64_t)(c0 + c) * pad + i;
        if constexpr (kEpi == 0) {
          y[at] = acc[c];
        } else if constexpr (kEpi == 1) {
          y[at] = b[at] - acc[c];
        } else {
          y[at] = x[at] + w[i] * (b[at] - acc[c]);
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int set_smem(void (*kern)(Args), size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// windows filled together: as many as the budget holds, at least one
int windows_together(int n_win, size_t slot_bytes) {
  if (n_win <= 0) return 0;
  const int fit = (int)(kWindowBudget / slot_bytes);
  return fit < 1 ? 1 : (fit < n_win ? fit : n_win);
}

template <typename V, typename X, bool kBf16Mul, int kEpi>
int launch_b1(Args a, int n_shards, int n_win, int max_span,
              cudaStream_t stream) {
  using C = B1Cfg<V>;
  void (*kern)(Args) = dia_kernel<V, X, kBf16Mul, kEpi>;
  // 16-byte rows of every shard: R rows per thread start on a multiple of
  // R, so rows, row strides and shard strides must keep 16-byte alignment
  a.vec = a.pad % C::R == 0 && a.vstride % C::R == 0 &&
          (a.xs * (int64_t)sizeof(X)) % 16 == 0 && aligned16(a.vals) &&
          aligned16(a.x) && aligned16(a.b) && aligned16(a.w) &&
          aligned16(a.y);
  // ceil((BR + span) / R) entries per residue row, padded to 32 / R words
  // modulo 32 (banks of 4 bytes)
  const int words = 128 / (int)sizeof(X);
  int wq = (C::BR + (max_span > 0 ? max_span : 0) + C::R - 1) / C::R;
  wq = (wq + words - 1) / words * words + words / C::R;
  a.wq = wq;
  a.slot = C::R * wq;
  a.nw = windows_together(n_win, (size_t)a.slot * sizeof(X));
  const size_t smem = (size_t)a.nw * a.slot * sizeof(X);
  const int err = set_smem(kern, smem);
  if (err) return err;
  const int64_t blocks = (a.pad + C::BR - 1) / C::BR;
  if (blocks > 0x7fffffff || n_shards < 1 || n_shards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  kern<<<dim3((unsigned)blocks, (unsigned)n_shards), C::T, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename V, typename X, bool kBf16Mul, int KB, int kEpi>
int launch_b4(const void* vals, const void* offs, int nd, int64_t pad, int k,
              const void* x, const void* b, const void* w, void* y,
              cudaStream_t stream) {
  int64_t blocks = (pad + kMultiThreads - 1) / kMultiThreads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride
  const size_t smem = (size_t)(nd > 0 ? nd : 1) * sizeof(int);
  dia_multi_kernel<V, X, kBf16Mul, KB, kEpi>
      <<<(unsigned)blocks, kMultiThreads, smem, stream>>>(
          static_cast<const V*>(vals), static_cast<const int*>(offs), nd,
          pad, k, static_cast<const X*>(x), static_cast<const X*>(b),
          static_cast<const X*>(w), static_cast<X*>(y));
  return (int)cudaGetLastError();
}

template <typename V, typename X, bool kBf16Mul, int KB>
int b4_epilogue(int epilogue, const void* vals, const void* offs, int nd,
                int64_t pad, int k, const void* x, const void* b,
                const void* w, void* y, cudaStream_t s) {
  switch (epilogue) {
    case 0:
      return launch_b4<V, X, kBf16Mul, KB, 0>(vals, offs, nd, pad, k, x, b,
                                              w, y, s);
    case 1:
      return launch_b4<V, X, kBf16Mul, KB, 1>(vals, offs, nd, pad, k, x, b,
                                              w, y, s);
    case 2:
      return launch_b4<V, X, kBf16Mul, KB, 2>(vals, offs, nd, pad, k, x, b,
                                              w, y, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The column block is the largest of 16, 8, 4, 2, 1 that divides k, so the
// batched solve's k = 16 is one block and one pass over the values.  No
// column of a block is masked: per-column masks ran 2.6x slower on an
// H100 (PERF.md).
template <typename V, typename X, bool kBf16Mul>
int launch_multi(const void* vals, const void* offs, int nd, int64_t pad,
                 int k, const void* x, const void* b, const void* w, void* y,
                 int epilogue, void* stream) {
  if (pad <= 0 || k <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kb = k % 16 == 0 ? 16 : k % 8 == 0 ? 8 : k % 4 == 0 ? 4
                                               : k % 2 == 0 ? 2 : 1;
  switch (kb) {
    case 16:
      return b4_epilogue<V, X, kBf16Mul, 16>(epilogue, vals, offs, nd, pad,
                                             k, x, b, w, y, s);
    case 8:
      return b4_epilogue<V, X, kBf16Mul, 8>(epilogue, vals, offs, nd, pad, k,
                                            x, b, w, y, s);
    case 4:
      return b4_epilogue<V, X, kBf16Mul, 4>(epilogue, vals, offs, nd, pad, k,
                                            x, b, w, y, s);
    case 2:
      return b4_epilogue<V, X, kBf16Mul, 2>(epilogue, vals, offs, nd, pad, k,
                                            x, b, w, y, s);
    default:
      return b4_epilogue<V, X, kBf16Mul, 1>(epilogue, vals, offs, nd, pad, k,
                                            x, b, w, y, s);
  }
}

// B1 over n_shards shards of pad rows (one vector: n_shards 1, the window
// [0, pad), vstride pad).
template <typename V, typename X, bool kBf16Mul>
int launch(const void* vals, const void* offs, const void* plan, int n_segs,
           int n_win, int max_span, int64_t pad, int n_shards,
           int64_t vstride, const void* x, int64_t xs, int64_t x_lo,
           int64_t x_hi, const void* b, const void* w, void* y,
           int epilogue, void* stream) {
  if (pad <= 0 || n_shards == 0) return 0;
  if (max_span > kMaxSpan || n_segs < 0 || n_win < 0 || n_win > n_segs ||
      vstride < pad || x_lo > 0 || x_hi < pad) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{};
  a.vals = vals;
  a.offs = static_cast<const int*>(offs);
  a.plan = static_cast<const int4*>(plan);
  a.n_segs = n_segs;
  a.pad = pad;
  a.vstride = vstride;
  a.xs = xs;
  a.x_lo = x_lo;
  a.x_hi = x_hi;
  a.x = x;
  a.b = b;
  a.w = w;
  a.y = y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case 0:
      return launch_b1<V, X, kBf16Mul, 0>(a, n_shards, n_win, max_span, s);
    case 1:
      return launch_b1<V, X, kBf16Mul, 1>(a, n_shards, n_win, max_span, s);
    case 2:
      return launch_b1<V, X, kBf16Mul, 2>(a, n_shards, n_win, max_span, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// B1: vals (nd, pad), offsets (nd,) int32, the plan (n_segs, 4) int32 on
// the card (n_win windowed runs, the widest spanning max_span); x, b, w, y
// (pad,); epilogue 0 spmv, 1 resid, 2 update.
int dia_f32_f32(const void* vals, const void* offs, const void* plan,
                int n_segs, int n_win, int max_span, int64_t pad,
                const void* x, const void* b, const void* w, void* y,
                int epilogue, void* stream) {
  return launch<float, float, false>(vals, offs, plan, n_segs, n_win,
                                     max_span, pad, 1, pad, x, 0, 0, pad, b,
                                     w, y, epilogue, stream);
}

int dia_bf16_f32(const void* vals, const void* offs, const void* plan,
                 int n_segs, int n_win, int max_span, int64_t pad,
                 const void* x, const void* b, const void* w, void* y,
                 int epilogue, int bf16_mul, void* stream) {
  if (bf16_mul) {
    return launch<__nv_bfloat16, float, true>(vals, offs, plan, n_segs,
                                              n_win, max_span, pad, 1, pad, x,
                                              0, 0, pad, b, w, y, epilogue,
                                              stream);
  }
  return launch<__nv_bfloat16, float, false>(vals, offs, plan, n_segs, n_win,
                                             max_span, pad, 1, pad, x, 0, 0,
                                             pad, b, w, y, epilogue, stream);
}

int dia_f64_f64(const void* vals, const void* offs, const void* plan,
                int n_segs, int n_win, int max_span, int64_t pad,
                const void* x, const void* b, const void* w, void* y,
                int epilogue, void* stream) {
  return launch<double, double, false>(vals, offs, plan, n_segs, n_win,
                                       max_span, pad, 1, pad, x, 0, 0, pad, b,
                                       w, y, epilogue, stream);
}

// B1's window entry: n_shards shards of m rows; values (nd, >= n_shards *
// m) with row stride vstride, shard s's at column s * m; x points at row 0
// of shard 0's window (its left halo before it), shard s's window starts
// xs entries further and reads 0 outside [-lo, m + hi); y (n_shards, m).
int dia_window_f32_f32(const void* vals, const void* offs, const void* plan,
                       int n_segs, int n_win, int max_span, int64_t m,
                       int n_shards, int64_t vstride, const void* x,
                       int64_t xs, int64_t lo, int64_t hi, void* y,
                       void* stream) {
  return launch<float, float, false>(vals, offs, plan, n_segs, n_win,
                                     max_span, m, n_shards, vstride, x, xs,
                                     -lo, m + hi, nullptr, nullptr, y, 0,
                                     stream);
}

int dia_window_bf16_f32(const void* vals, const void* offs, const void* plan,
                        int n_segs, int n_win, int max_span, int64_t m,
                        int n_shards, int64_t vstride, const void* x,
                        int64_t xs, int64_t lo, int64_t hi, void* y,
                        int bf16_mul, void* stream) {
  if (bf16_mul) {
    return launch<__nv_bfloat16, float, true>(
        vals, offs, plan, n_segs, n_win, max_span, m, n_shards, vstride, x,
        xs, -lo, m + hi, nullptr, nullptr, y, 0, stream);
  }
  return launch<__nv_bfloat16, float, false>(
      vals, offs, plan, n_segs, n_win, max_span, m, n_shards, vstride, x, xs,
      -lo, m + hi, nullptr, nullptr, y, 0, stream);
}

int dia_window_f64_f64(const void* vals, const void* offs, const void* plan,
                       int n_segs, int n_win, int max_span, int64_t m,
                       int n_shards, int64_t vstride, const void* x,
                       int64_t xs, int64_t lo, int64_t hi, void* y,
                       void* stream) {
  return launch<double, double, false>(vals, offs, plan, n_segs, n_win,
                                       max_span, m, n_shards, vstride, x, xs,
                                       -lo, m + hi, nullptr, nullptr, y, 0,
                                       stream);
}

// B4: vals (nd, pad), offsets (nd,) int32; x, b, y (k, pad), w (pad,);
// the same epilogues.
int dia_multi_f32_f32(const void* vals, const void* offs, int nd,
                      int64_t pad, int k, const void* x, const void* b,
                      const void* w, void* y, int epilogue, void* stream) {
  return launch_multi<float, float, false>(vals, offs, nd, pad, k, x, b, w, y,
                                           epilogue, stream);
}

int dia_multi_bf16_f32(const void* vals, const void* offs, int nd,
                       int64_t pad, int k, const void* x, const void* b,
                       const void* w, void* y, int epilogue, int bf16_mul,
                       void* stream) {
  if (bf16_mul) {
    return launch_multi<__nv_bfloat16, float, true>(vals, offs, nd, pad, k, x,
                                                    b, w, y, epilogue,
                                                    stream);
  }
  return launch_multi<__nv_bfloat16, float, false>(vals, offs, nd, pad, k, x,
                                                   b, w, y, epilogue, stream);
}

int dia_multi_f64_f64(const void* vals, const void* offs, int nd,
                      int64_t pad, int k, const void* x, const void* b,
                      const void* w, void* y, int epilogue, void* stream) {
  return launch_multi<double, double, false>(vals, offs, nd, pad, k, x, b, w,
                                             y, epilogue, stream);
}

}  // extern "C"
