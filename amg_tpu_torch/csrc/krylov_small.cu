// The scalar steps of restarted GMRES, and the assembly of the CUDA graphs
// that run the Krylov layer's loops on the card, for NVIDIA Hopper
// (sm_90a).
//
// No TPU kernel: amg_tpu runs this work as lax.fori_loop scalar code inside
// its GMRES lax.while_loop (amg_tpu/solve/krylov.py), which XLA keeps on the
// device.  Two kernels, one warp each, in float or double (the vectors'
// type), in amg_tpu's order:
//
//   givens   Arnoldi step j's scalar tail, j read from the card (:336-362):
//            store the raw Hessenberg column (the step's Gram-Schmidt
//            coefficients with h[j+1] = ||w||) as hraw[j], rotate it by
//            rotations 0 .. j-1, make rotation j, store the rotated column
//            as H[:, j], rotate g, update the restart's done flag and
//            k_eff, advance j and set the step loop's flag (j < m and not
//            done); a step with done already set changes nothing but
//            recomputes its values, as amg_tpu's masked step does
//   backsub  the masked back-substitution (:371-379): y[jj] for jj = m-1
//            .. 0, 0 where jj >= k_eff
//
// Every multiply, add, divide and square root rounds once (the _rn
// intrinsics, which nvcc does not contract into FMAs), so that the kernels
// compute what their plain PyTorch versions (ops/krylov_small.py) compute
// with one elementwise operation per step, bit for bit.  The back-
// substitution sums each row's products from column jj + 1 up to m - 1,
// as the plain version does.
//
// What bounds them on an H100: neither bytes (a few hundred) nor flops
// (~6 j per Givens step, ~m^2 per back-substitution), but latency: the
// launch, the round trips to memory and a chain of dependent scalar
// operations.  So each kernel is one warp that issues all its global
// loads at once (none waits on another; the back-substitution stages H's
// whole m x m block rather than wait on k_eff) into shared memory, and
// runs the dependent chain in one lane reading shared memory ahead of its
// arithmetic; the lanes stage and store.  Lanes forming a row's products
// for lane 0 cost more than they save: a store, a barrier and a broadcast
// on every row's serial path (PERF.md).  The Givens step also
// absorbs the step's scalar tail (the column's store, j += 1, the loop
// flag), so an Arnoldi step indexes the basis through the device j and a
// restart is one captured step under a while node.
//
// Graph assembly: plain entries around the CUDA runtime's graph API, so
// that the Python side can compose captured loop bodies into conditional
// nodes (CUDA 12.3+): a while node runs its body while a handle's value is
// non-zero, an if node once if it is.  ks_set_flag is the one-thread kernel
// that sets a handle from a device flag (one byte, a torch bool): placed
// before a conditional node, and at the end of a while node's body.  Each
// node is added after at most one dependency (the Python side chains them).
// ks_capture_tail / ks_capture_continue add nodes to a graph that a stream
// is capturing, between the captured work before and after;
// ks_capture_begin / ks_capture_end capture a stream's work straight into
// a graph (a conditional node's body), for work whose capture holds
// conditional nodes itself, which a child graph may not.
//
// Bound with ctypes: plain extern "C" entries returning the CUDA error (0
// on success); the kernel entries return cudaGetLastError() after the
// launch.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 64;   // longest restart m (krylov_small.MAX_M)
constexpr int kWarp = 32;

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

// H is (m + 1, m) row-major: H[i, j] at i * m + j; hraw (m, m + 1).  One
// warp.  Every global load is issued at once, none waiting on another (g
// is staged whole rather than read at g[j]), so the kernel pays one memory
// latency; lane 0 then runs the chain of rotations from shared memory and
// the lanes store H's column.
template <typename T>
__global__ void __launch_bounds__(kWarp) givens_kernel(
    const T* __restrict__ hcol, const T* __restrict__ hnorm,
    int* __restrict__ jp, int m, T* __restrict__ hraw, T* __restrict__ H,
    T* __restrict__ cs, T* __restrict__ sn, T* __restrict__ g,
    bool* __restrict__ done, int* __restrict__ k_eff, bool* __restrict__ go,
    const T* __restrict__ normr0, T tol, T tiny) {
  using R = Rn<T>;
  constexpr int kPer = (kMaxM + 1 + kWarp - 1) / kWarp;  // entries a lane
  __shared__ T h[kMaxM + 1];
  __shared__ T g_s[kMaxM + 1];
  __shared__ T c_s[kMaxM];
  __shared__ T s_s[kMaxM];
  __shared__ bool keep;
  const int lane = threadIdx.x;
  const int j = *jp;    // every lane reads j before lane 0 advances it
  const T hj1 = *hnorm;
  T hv[kPer], gv[kPer], cv[kPer], sv[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = lane + u * kWarp;
    hv[u] = i <= m ? hcol[i] : T(0);
    gv[u] = i <= m ? g[i] : T(0);
    cv[u] = i < m ? cs[i] : T(0);
    sv[u] = i < m ? sn[i] : T(0);
  }
  const bool was_done = *done;
  const T nr0 = *normr0;
  if (j < 0 || j >= m) {
    if (lane == 0) *go = false;
    return;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = lane + u * kWarp;
    if (i <= m) {
      const T v = i == j + 1 ? hj1 : hv[u];
      h[i] = v;
      g_s[i] = gv[u];
      hraw[j * (m + 1) + i] = v;
    }
    if (i < m) {
      c_s[i] = cv[u];
      s_s[i] = sv[u];
    }
  }
  __syncwarp();
  if (lane == 0) {
    T a = h[0];   // h[i] as rotated by rotations 0 .. i-1
    for (int i = 0; i < j; ++i) {
      const T b = h[i + 1], c = c_s[i], s = s_s[i];
      h[i] = R::add(R::mul(c, a), R::mul(s, b));
      a = R::add(R::mul(-s, a), R::mul(c, b));
    }
    const T denom = R::sqrt(R::add(R::mul(a, a), R::mul(hj1, hj1)));
    const bool big = denom > tiny;
    const T dm = big ? denom : tiny;
    const T c = big ? R::div(a, dm) : T(1);
    const T s = big ? R::div(hj1, dm) : T(0);
    h[j] = R::add(R::mul(c, a), R::mul(s, hj1));
    const T gj = g_s[j];
    const T gj1 = R::mul(-s, gj);
    if (!was_done) {
      cs[j] = c;
      sn[j] = s;
      g[j] = R::mul(c, gj);
      g[j + 1] = gj1;
      *k_eff = j + 1;
    }
    const bool now = was_done || R::div(fabs(gj1), nr0) < tol || hj1 <= tiny;
    *done = now;
    *jp = j + 1;
    *go = j + 1 < m && !now;
    keep = !was_done;
  }
  __syncwarp();
  if (keep)
    for (int i = lane; i <= m; i += kWarp) H[i * m + j] = i <= j ? h[i] : T(0);
}

// One warp.  The lanes stage rows 0 .. m-1 of H (whole, so that no load
// waits on k_eff) and g, every load issued at once for m <= 32 (kStage
// per lane in flight), and zero y.  Lane 0 then runs the rows from the
// last: row jj's products H[jj, c] * y[c], c > jj, formed and summed in
// column order (the plain version's order), kLoads pairs loaded ahead of
// the arithmetic, then the division; y stays in shared memory, so no row
// waits on a barrier or a broadcast.  Rows jj >= k_eff are 0 and cost
// nothing.
template <typename T>
__global__ void __launch_bounds__(kWarp) backsub_kernel(
    const T* __restrict__ H, const T* __restrict__ g,
    const int* __restrict__ k_eff, int m, T* __restrict__ y, T tiny) {
  using R = Rn<T>;
  constexpr int kStage = 32;
  constexpr int kLoads = 16;
  __shared__ T hs[kMaxM * kMaxM];
  __shared__ T gs[kMaxM];
  __shared__ T ys[kMaxM];
  const int lane = threadIdx.x;
  const int k_raw = *k_eff;
  const T g0 = lane < m ? g[lane] : T(0);
  const T g1 = lane + kWarp < m ? g[lane + kWarp] : T(0);
  const int n = m * m;
  for (int e0 = lane; e0 < n; e0 += kWarp * kStage) {
    T v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = e0 + u * kWarp;
      v[u] = e < n ? H[e] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = e0 + u * kWarp;
      if (e < n) hs[e] = v[u];
    }
  }
  if (lane < m) gs[lane] = g0;
  if (lane + kWarp < m) gs[lane + kWarp] = g1;
  for (int i = lane; i < m; i += kWarp) ys[i] = T(0);
  const int k = min(max(k_raw, 0), m);
  __syncwarp();
  if (lane == 0) {
    for (int jj = k - 1; jj >= 0; --jj) {
      const T* row = hs + jj * m;
      T acc = T(0);
      for (int c = jj + 1; c < m; c += kLoads) {
        T hv[kLoads], yv[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const bool in = c + u < m;
          hv[u] = in ? row[c + u] : T(0);
          yv[u] = in ? ys[c + u] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u)
          if (c + u < m) acc = R::add(acc, R::mul(hv[u], yv[u]));
      }
      const T s = R::sub(gs[jj], acc);
      const T hjj = row[jj];
      ys[jj] = fabs(hjj) > tiny ? R::div(s, hjj) : T(0);
    }
  }
  __syncwarp();
  for (int i = lane; i < m; i += kWarp) y[i] = ys[i];
}

// launched as the kernels are: the latency floor of one launch
__global__ void __launch_bounds__(kWarp) empty_kernel() {}

__global__ void set_flag_kernel(cudaGraphConditionalHandle handle,
                                const unsigned char* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

template <typename T>
int givens(const void* hcol, const void* hnorm, void* j, int m, void* hraw,
           void* H, void* cs, void* sn, void* g, void* done, void* k_eff,
           void* go, const void* normr0, T tol, T tiny, void* stream) {
  if (m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
  givens_kernel<T><<<1, kWarp, 0, (cudaStream_t)stream>>>(
      (const T*)hcol, (const T*)hnorm, (int*)j, m, (T*)hraw, (T*)H, (T*)cs,
      (T*)sn, (T*)g, (bool*)done, (int*)k_eff, (bool*)go, (const T*)normr0,
      tol, tiny);
  return (int)cudaGetLastError();
}

template <typename T>
int backsub(const void* H, const void* g, const void* k_eff, int m, void* y,
            T tiny, void* stream) {
  if (m < 1 || m > kMaxM) return (int)cudaErrorInvalidValue;
  backsub_kernel<T><<<1, kWarp, 0, (cudaStream_t)stream>>>(
      (const T*)H, (const T*)g, (const int*)k_eff, m, (T*)y, tiny);
  return (int)cudaGetLastError();
}

// the dependency list of a node added after `dep` (none when null)
size_t deps(void* dep, cudaGraphNode_t* out) {
  if (dep == nullptr) return 0;
  *out = (cudaGraphNode_t)dep;
  return 1;
}

// the nodes `node` depends on (`in`), else the nodes that depend on it;
// the list is only asked for when it is not empty
cudaError_t node_edges(cudaGraphNode_t node, std::vector<cudaGraphNode_t>* v,
                       bool in) {
  size_t n = 0;
  cudaError_t err = in ? cudaGraphNodeGetDependencies(node, nullptr, &n)
                       : cudaGraphNodeGetDependentNodes(node, nullptr, &n);
  v->assign(n, nullptr);
  if (err != cudaSuccess || n == 0) return err;
  return in ? cudaGraphNodeGetDependencies(node, v->data(), &n)
            : cudaGraphNodeGetDependentNodes(node, v->data(), &n);
}

}  // namespace

extern "C" {

// hcol (m + 1,), hnorm (scalar), hraw (m, m + 1), H (m + 1, m), cs, sn
// (m,), g (m + 1,), normr0 (scalar) on the card in the entry's type; j and
// k_eff int32, done and go bool.
int ks_givens_f32(const void* hcol, const void* hnorm, void* j, int m,
                  void* hraw, void* H, void* cs, void* sn, void* g,
                  void* done, void* k_eff, void* go, const void* normr0,
                  float tol, float tiny, void* stream) {
  return givens<float>(hcol, hnorm, j, m, hraw, H, cs, sn, g, done, k_eff,
                       go, normr0, tol, tiny, stream);
}

int ks_givens_f64(const void* hcol, const void* hnorm, void* j, int m,
                  void* hraw, void* H, void* cs, void* sn, void* g,
                  void* done, void* k_eff, void* go, const void* normr0,
                  double tol, double tiny, void* stream) {
  return givens<double>(hcol, hnorm, j, m, hraw, H, cs, sn, g, done, k_eff,
                        go, normr0, tol, tiny, stream);
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

int ks_empty(void* stream) {
  empty_kernel<<<1, kWarp, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
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

// Capture the work then given to `stream` straight into `graph`, after
// `dep` (none when null), until ks_capture_end.
int ks_capture_begin(void* stream, void* graph, void* dep) {
  cudaGraphNode_t d;
  const size_t n = deps(dep, &d);
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)stream, (cudaGraph_t)graph, n ? &d : nullptr, nullptr, n,
      cudaStreamCaptureModeThreadLocal);
}

// End the capture of `stream`; *dep is the node after which the graph's
// next node goes (as ks_capture_tail gives it).
int ks_capture_end(void* stream, void** dep) {
  void* graph = nullptr;
  const int err = ks_capture_tail(stream, &graph, dep);
  cudaGraph_t g;
  const cudaError_t end = cudaStreamEndCapture((cudaStream_t)stream, &g);
  return err != 0 ? err : (int)end;
}

// counts[t] += the nodes of cudaGraphNodeType t (t < n_kinds) in `graph`,
// child graphs' nodes included (a child graph node counts as well).
int ks_graph_kinds(void* graph, size_t* counts, int n_kinds) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return (int)err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes((cudaGraph_t)graph, nodes.data(), &n);
  for (size_t i = 0; i < n && err == cudaSuccess; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err != cudaSuccess) break;
    if ((int)t < n_kinds) ++counts[(int)t];
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = (cudaError_t)ks_graph_kinds(
          child, counts, n_kinds);
    }
  }
  return (int)err;
}

// Remove the event record and event wait nodes of `graph` (child graphs'
// included), each node's dependencies passed on to its dependents (an
// edge that exists already is not added again); *removed counts them.
// NCCL adds such nodes to a graph that captures one of its calls, to
// order the graph's NCCL work against NCCL calls made outside it (its
// "graph mixing" support); a conditional node's body may hold no event
// node.  Inside one graph whose nodes run in one chain the order holds
// without them.
int ks_graph_strip_events(void* graph, size_t* removed) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return (int)err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes((cudaGraph_t)graph, nodes.data(), &n);
  for (size_t i = 0; i < n && err == cudaSuccess; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err != cudaSuccess) break;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = (cudaError_t)ks_graph_strip_events(
          child, removed);
      continue;
    }
    if (t != cudaGraphNodeTypeEventRecord && t != cudaGraphNodeTypeWaitEvent)
      continue;
    std::vector<cudaGraphNode_t> in, out;
    err = node_edges(nodes[i], &in, true);
    if (err == cudaSuccess) err = node_edges(nodes[i], &out, false);
    for (size_t b = 0; b < out.size() && err == cudaSuccess; ++b) {
      std::vector<cudaGraphNode_t> has;
      err = node_edges(out[b], &has, true);
      for (size_t a = 0; a < in.size() && err == cudaSuccess; ++a)
        if (std::find(has.begin(), has.end(), in[a]) == has.end())
          err = cudaGraphAddDependencies((cudaGraph_t)graph, &in[a],
                                         &out[b], 1);
    }
    if (err == cudaSuccess) err = cudaGraphDestroyNode(nodes[i]);
    if (err == cudaSuccess) ++*removed;
  }
  return (int)err;
}

}  // extern "C"
