// The scalar steps of restarted GMRES, and the assembly of the CUDA graphs
// that run the Krylov layer's loops on the card, for NVIDIA Hopper
// (sm_90a).
//
// No TPU kernel: amg_tpu runs this work as lax.fori_loop scalar code inside
// its GMRES lax.while_loop (amg_tpu/solve/krylov.py), which XLA keeps on the
// device.  Two kernels, one thread each, in float or double (the vectors'
// type), in amg_tpu's order:
//
//   givens   step j of the Givens update (:336-362): rotate the raw
//            Hessenberg column hraw[0 .. j+1] by rotations 0 .. j-1, make
//            rotation j, store the rotated column as H[:, j], rotate g, and
//            update the restart's done flag and k_eff; a step with done
//            already set changes nothing but recomputes its values, as
//            amg_tpu's masked step does
//   backsub  the masked back-substitution (:371-379): y[jj] for jj = m-1
//            .. 0, 0 where jj >= k_eff
//
// Every multiply, add, divide and square root rounds once (the _rn
// intrinsics, which nvcc does not contract into FMAs), so that the kernels
// compute what their plain PyTorch versions (ops/krylov_small.py) compute
// with one elementwise operation per step, bit for bit.  The back-
// substitution's row products are summed from column jj + 1 up: the terms
// left of it are exact zeros (H is upper triangular, y is 0 there).
//
// What bounds them on an H100: neither bytes (a few hundred) nor flops
// (~6 j per Givens step), but the latency of a chain of dependent scalar
// operations in one thread: ~4 us per Givens step and ~35 us per back-
// substitution on an H100 80GB HBM3 (chip_smoke.py phase 17).  As one-
// element torch operations, ~200 per Givens step and ~1,000 per back-
// substitution, the same chains take 1.2 and 11 ms there.
//
// Graph assembly: plain entries around the CUDA runtime's graph API, so
// that the Python side can compose captured loop bodies into conditional
// nodes (CUDA 12.3+): a while node runs its body while a handle's value is
// non-zero, an if node once if it is.  ks_set_flag is the one-thread kernel
// that sets a handle from a device flag (one byte, a torch bool): placed
// before a conditional node, and at the end of a while node's body.  Each
// node is added after at most one dependency (the Python side chains them).
// ks_capture_tail / ks_capture_continue add nodes to a graph that a stream
// is capturing, between the captured work before and after.
//
// Bound with ctypes: plain extern "C" entries returning the CUDA error (0
// on success); the kernel entries return cudaGetLastError() after the
// launch.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 64;   // longest restart m (krylov_small.MAX_M)

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <>
struct Rn<double> {
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ double sqrt(double a) { return __dsqrt_rn(a); }
};

// H is (m + 1, m) row-major: H[i, j] at i * m + j.
template <typename T>
__global__ void givens_kernel(const T* __restrict__ hraw, int j, int m,
                              T* __restrict__ H, T* __restrict__ cs,
                              T* __restrict__ sn, T* __restrict__ g,
                              bool* __restrict__ done,
                              int* __restrict__ k_eff,
                              const T* __restrict__ normr0, T tol, T tiny) {
  using R = Rn<T>;
  T h[kMaxM + 1];
  for (int i = 0; i <= j + 1; ++i) h[i] = hraw[i];
  const T hj1 = h[j + 1];
  for (int i = 0; i < j; ++i) {
    const T a = h[i], b = h[i + 1];
    h[i] = R::add(R::mul(cs[i], a), R::mul(sn[i], b));
    h[i + 1] = R::add(R::mul(-sn[i], a), R::mul(cs[i], b));
  }
  const T denom = R::sqrt(R::add(R::mul(h[j], h[j]),
                                 R::mul(h[j + 1], h[j + 1])));
  const bool big = denom > tiny;
  const T dm = denom > tiny ? denom : tiny;
  const T c = big ? R::div(h[j], dm) : T(1);
  const T s = big ? R::div(h[j + 1], dm) : T(0);
  h[j] = R::add(R::mul(c, h[j]), R::mul(s, h[j + 1]));
  h[j + 1] = T(0);
  const T gj1 = R::mul(-s, g[j]);
  const T gj = R::mul(c, g[j]);
  const bool was_done = *done;
  if (!was_done) {
    cs[j] = c;
    sn[j] = s;
    for (int i = 0; i <= m; ++i) H[i * m + j] = i <= j + 1 ? h[i] : T(0);
    g[j] = gj;
    g[j + 1] = gj1;
    *k_eff = j + 1;
  }
  *done = was_done || R::div(fabs(gj1), *normr0) < tol || hj1 <= tiny;
}

template <typename T>
__global__ void backsub_kernel(const T* __restrict__ H,
                               const T* __restrict__ g,
                               const int* __restrict__ k_eff, int m,
                               T* __restrict__ y, T tiny) {
  using R = Rn<T>;
  const int k = *k_eff;
  for (int jj = m - 1; jj >= 0; --jj) {
    T acc = T(0);
    for (int c = jj + 1; c < m; ++c)
      acc = R::add(acc, R::mul(H[jj * m + c], y[c]));
    const T s = R::sub(g[jj], acc);
    const T hjj = H[jj * m + jj];
    const T val = fabs(hjj) > tiny ? R::div(s, hjj) : T(0);
    y[jj] = jj < k ? val : T(0);
  }
}

__global__ void set_flag_kernel(cudaGraphConditionalHandle handle,
                                const unsigned char* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

template <typename T>
int givens(const void* hraw, int j, int m, void* H, void* cs, void* sn,
           void* g, void* done, void* k_eff, const void* normr0, T tol,
           T tiny, void* stream) {
  if (m > kMaxM || j < 0 || j >= m) return (int)cudaErrorInvalidValue;
  givens_kernel<T><<<1, 1, 0, (cudaStream_t)stream>>>(
      (const T*)hraw, j, m, (T*)H, (T*)cs, (T*)sn, (T*)g, (bool*)done,
      (int*)k_eff, (const T*)normr0, tol, tiny);
  return (int)cudaGetLastError();
}

template <typename T>
int backsub(const void* H, const void* g, const void* k_eff, int m, void* y,
            T tiny, void* stream) {
  backsub_kernel<T><<<1, 1, 0, (cudaStream_t)stream>>>(
      (const T*)H, (const T*)g, (const int*)k_eff, m, (T*)y, tiny);
  return (int)cudaGetLastError();
}

// the dependency list of a node added after `dep` (none when null)
size_t deps(void* dep, cudaGraphNode_t* out) {
  if (dep == nullptr) return 0;
  *out = (cudaGraphNode_t)dep;
  return 1;
}

}  // namespace

extern "C" {

// H (m + 1, m), hraw (m + 1,), cs, sn (m,), g (m + 1,), done (bool),
// k_eff (int32), normr0 (scalar) on the card, in the entry's type.
int ks_givens_f32(const void* hraw, int j, int m, void* H, void* cs,
                  void* sn, void* g, void* done, void* k_eff,
                  const void* normr0, float tol, float tiny, void* stream) {
  return givens<float>(hraw, j, m, H, cs, sn, g, done, k_eff, normr0, tol,
                       tiny, stream);
}

int ks_givens_f64(const void* hraw, int j, int m, void* H, void* cs,
                  void* sn, void* g, void* done, void* k_eff,
                  const void* normr0, double tol, double tiny,
                  void* stream) {
  return givens<double>(hraw, j, m, H, cs, sn, g, done, k_eff, normr0, tol,
                        tiny, stream);
}

// y (m,) from H (m + 1, m), g (m + 1,) and k_eff (int32).
int ks_backsub_f32(const void* H, const void* g, const void* k_eff, int m,
                   void* y, float tiny, void* stream) {
  return backsub<float>(H, g, k_eff, m, y, tiny, stream);
}

int ks_backsub_f64(const void* H, const void* g, const void* k_eff, int m,
                   void* y, double tiny, void* stream) {
  return backsub<double>(H, g, k_eff, m, y, tiny, stream);
}

int ks_graph_create(void** graph) {
  return (int)cudaGraphCreate((cudaGraph_t*)graph, 0);
}

int ks_graph_destroy(void* graph) {
  return (int)cudaGraphDestroy((cudaGraph_t)graph);
}

int ks_graph_nodes(void* graph, size_t* n) {
  return (int)cudaGraphGetNodes((cudaGraph_t)graph, nullptr, n);
}

int ks_handle(void* graph, unsigned long long* handle) {
  return (int)cudaGraphConditionalHandleCreate(
      (cudaGraphConditionalHandle*)handle, (cudaGraph_t)graph, 0, 0);
}

int ks_add_child(void* graph, void* dep, void* child, void** node) {
  cudaGraphNode_t d;
  const size_t n = deps(dep, &d);
  return (int)cudaGraphAddChildGraphNode((cudaGraphNode_t*)node,
                                         (cudaGraph_t)graph, n ? &d : nullptr,
                                         n, (cudaGraph_t)child);
}

int ks_add_set_flag(void* graph, void* dep, unsigned long long handle,
                    const void* flag, void** node) {
  cudaGraphNode_t d;
  const size_t n = deps(dep, &d);
  cudaGraphConditionalHandle h = handle;
  const unsigned char* f = (const unsigned char*)flag;
  void* args[2] = {&h, &f};
  cudaKernelNodeParams p = {};
  p.func = (void*)set_flag_kernel;
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return (int)cudaGraphAddKernelNode((cudaGraphNode_t*)node,
                                     (cudaGraph_t)graph, n ? &d : nullptr, n,
                                     &p);
}

// A conditional node (while when is_while, else if) on `handle`; *body is
// the graph it runs, empty until nodes are added to it.
int ks_add_cond(void* graph, void* dep, unsigned long long handle,
                int is_while, void** node, void** body) {
  cudaGraphNode_t d;
  const size_t n = deps(dep, &d);
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  p.conditional.size = 1;
  const cudaError_t err = cudaGraphAddNode(
      (cudaGraphNode_t*)node, (cudaGraph_t)graph, n ? &d : nullptr, n, &p);
  if (err == cudaSuccess) *body = (void*)p.conditional.phGraph_out[0];
  return (int)err;
}

int ks_add_copy(void* graph, void* dep, void* dst, const void* src,
                size_t bytes, void** node) {
  cudaGraphNode_t d;
  const size_t n = deps(dep, &d);
  return (int)cudaGraphAddMemcpyNode1D((cudaGraphNode_t*)node,
                                       (cudaGraph_t)graph, n ? &d : nullptr,
                                       n, dst, src, bytes,
                                       cudaMemcpyDeviceToDevice);
}

int ks_instantiate(void* graph, void** exec) {
  return (int)cudaGraphInstantiate((cudaGraphExec_t*)exec,
                                   (cudaGraph_t)graph, 0);
}

int ks_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

int ks_exec_destroy(void* exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}

// The graph `stream` is capturing and the node after which the next node
// goes: the capture's one dependency, an empty node joining several, or
// null at the start.  cudaErrorIllegalState when the stream is not
// capturing.
int ks_capture_tail(void* stream, void** graph, void** dep) {
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* ds = nullptr;
  size_t n = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(
      (cudaStream_t)stream, &status, nullptr, (cudaGraph_t*)graph, &ds, &n);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorIllegalState;
  if (n == 0) {
    *dep = nullptr;
  } else if (n == 1) {
    *dep = (void*)ds[0];
  } else {
    err = cudaGraphAddEmptyNode((cudaGraphNode_t*)dep, (cudaGraph_t)*graph,
                                ds, n);
  }
  return (int)err;
}

// Let the capture of `stream` go on after `node`.
int ks_capture_continue(void* stream, void* node) {
  cudaGraphNode_t d = (cudaGraphNode_t)node;
  return (int)cudaStreamUpdateCaptureDependencies(
      (cudaStream_t)stream, &d, 1, cudaStreamSetCaptureDependencies);
}

}  // extern "C"
