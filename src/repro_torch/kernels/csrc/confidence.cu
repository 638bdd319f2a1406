// Fused softmax confidence over the rows of a (B, V) logits tensor:
// argmax (the FIRST index of the row maximum) and delta = max softmax =
// 1 / sum(exp(x - max)) in f32, the softmax never materialised.  Inputs
// f32, bf16 and fp16.
//
// Replaces the Pallas kernel `_conf_kernel` / `confidence` of the JAX
// package's kernels/confidence.py (its pallas_call at
// src/repro/kernels/confidence.py:72), which streams vocab tiles in order
// on one TPU core with a running (max, sum-exp, argmax) in scratch.
//
// Bound on the H100: bytes, one read of the logits, B * V * sizeof(x)
// (1.2 MB at Algorithm 1's (4, 151936) in bf16: 0.36 us at 3.35 TB/s); the
// outputs are O(B).  At that size the cost is a launch and the chain of
// dependent steps after the read; at 64 rows it is the instructions spent
// on each element.  So the design is one launch whose cross-CTA merge
// never leaves the chip, and few instructions an element:
//  * one thread-block cluster of C CTAs per row, along grid.x (grid B * C,
//    so any B: grid.y's 65535 limit no longer applies).  C in {1, 2, 4, 8,
//    16} is the caller's, from V alone (the wrapper's plan(): C doubles
//    while a CTA would hold more than 8192 columns; C = 16 is a
//    non-portable cluster size, allowed on the kernel once a device).
//    CTA r reduces the r-th of C contiguous column ranges cut in 8-column
//    units (confidence_range: 16-byte aligned, the first units % C ranges
//    one unit longer, ranges past the last unit empty);
//  * 16-byte loads when the row base, its stride and V allow (vec16_ok),
//    scalar loads otherwise; a thread issues kBatch loads before it uses
//    the first.  A batch's maximum comes from packed max instructions on
//    the raw 16-bit pairs (__hmax2); only a batch that raises the thread's
//    maximum looks for its first index (the first chunk whose maximum it
//    is, then the first element of that chunk); the sum is of
//    exp2((x - m) log2 e), a subtraction, a multiply and one ex2.approx an
//    element (the max subtracted before the scaling: folding a pre-scaled
//    max into one FMA, x log2 e - m log2 e, rounds m log2 e and so loses
//    |m| 2^-24 of every exponent — 7e-5 of δ at the CI-ResNet heads'
//    logits);
//  * the reductions (lanes, warps, cluster ranks) take the maximum first,
//    then rescale each sum to it once and add the sums and the smallest
//    index among the maximum's holders, in a fixed shuffle-tree order, so
//    a run repeats its bits;
//  * the merge: the cluster's CTAs signal at their start that they run
//    (barrier.cluster.arrive.relaxed), each CTA stores its (max, sum,
//    argmax) into slot r of rank 0's shared memory (distributed shared
//    memory), one cluster barrier (release / acquire) follows, and rank 0's
//    first warp reduces the C slots and writes idx[b] and conf[b] = 1 / l;
//  * rows of at most kGroupCols columns (the paper's 10-class heads): C = 1
//    and a group of L lanes a row (L = 1 for 10 columns, 32 for 1024), 256
//    / L rows a CTA, no barrier at all.
// Why a cluster and not a global merge: exit_update.cu's one-launch form
// (partials to a global scratch, a fence, a per-row atomic ticket, the
// last CTA's L2 reads) chains three dependent round trips through L2 after
// the read; the cluster barrier and DSMEM stores stay on the SMs of one
// GPC.  The kernel keeps nothing between calls (no scratch, no ticket, no
// memset; the wrapper allocates only the two outputs), so a captured CUDA
// graph replays it on any stream with nothing to reset.
// Timed and dropped (PERF.md row 2; the exit_update.cu ticket form, with
// its carry merge, was timed in the same calls and is slower): the
// two-launch form (a partial kernel over (ceil(V / 4096), B) writing a
// scratch, then a combine launch per row) that this file held before; a
// first cluster form (expf and a running argmax on every element,
// triple_combine trees); rank 0 pulling the C triples between two cluster
// barriers; a one-way mbarrier signal into rank 0 in place of the
// barrier; 128 or 512 threads a CTA, 4 loads in flight, at most 64
// registers; the cluster sizes the plan does not pick at (4, 151936).
#include <cooperative_groups.h>

#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;         // loads a thread keeps in flight
constexpr int kUnit = 8;          // columns: the split's unit (16 bytes bf16)
constexpr int kMaxCluster = 16;
constexpr int kGroupCols = 1024;  // rows this short take a lane group each
constexpr int kLaneCols = 32;     // a lane group's lanes: V / kLaneCols
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx.ftz: ~2 ulp; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the maximum of one 16-byte chunk: packed max instructions on 16-bit pairs
template <typename T>
__device__ __forceinline__ float chunk_max(const uint4& c);
template <>
__device__ __forceinline__ float chunk_max<float>(const uint4& c) {
  return fmaxf(fmaxf(__uint_as_float(c.x), __uint_as_float(c.y)),
               fmaxf(__uint_as_float(c.z), __uint_as_float(c.w)));
}
template <>
__device__ __forceinline__ float chunk_max<__nv_bfloat16>(const uint4& c) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&c);
  const __nv_bfloat162 m2 = __hmax2(__hmax2(h[0], h[1]), __hmax2(h[2], h[3]));
  return fmaxf(__low2float(m2), __high2float(m2));
}
template <>
__device__ __forceinline__ float chunk_max<__half>(const uint4& c) {
  const __half2* h = reinterpret_cast<const __half2*>(&c);
  const __half2 m2 = __hmax2(__hmax2(h[0], h[1]), __hmax2(h[2], h[3]));
  return fmaxf(__low2float(m2), __high2float(m2));
}

// CTA r's column range [c0, c1) when a row of V columns is cut over C CTAs
__host__ __device__ __forceinline__ void plan_range(int V, int C, int r,
                                                    int& c0, int& c1) {
  const int units = (V + kUnit - 1) / kUnit;
  const int per = units / C, rem = units % C;
  const int u0 = r * per + (r < rem ? r : rem);
  const int u1 = u0 + per + (r < rem ? 1 : 0);
  c0 = u0 * kUnit < V ? u0 * kUnit : V;
  c1 = u1 * kUnit < V ? u1 * kUnit : V;
}

// Fold a batch into the thread's (m, l, a).  Group u < nu (of U) holds K
// elements e[u * K + i] at columns j0 + u * stride + i, above every column
// folded before; cm[u] is its maximum.  The batch maximum; if it is above
// m, l is rescaled to it and a becomes its first column (the first group
// whose maximum it is, then the first element of that group); then l gains
// the batch's sum of exp(x - m), each group's K terms first.
template <typename T, int U, int K>
__device__ __forceinline__ void fold_batch(const T* e, const float (&cm)[U],
                                           int nu, int j0, int stride,
                                           float& m, float& l, int& a) {
  float bm = cm[0];
#pragma unroll
  for (int u = 1; u < U; ++u)
    if (u < nu) bm = fmaxf(bm, cm[u]);
  if (bm > m) {
    l *= ex2((m - bm) * kLog2e);
    m = bm;
    int ub = 0;
#pragma unroll
    for (int u = U - 1; u > 0; --u)
      if (u < nu && cm[u] == bm) ub = u;
    if (cm[0] == bm) ub = 0;
    int first = 0;
    if constexpr (K > 1) {
      // the group's elements, picked by selects (no local-memory index)
      T g[K];
#pragma unroll
      for (int i = 0; i < K; ++i) g[i] = e[i];
#pragma unroll
      for (int u = 1; u < U; ++u)
        if (u == ub) {
#pragma unroll
          for (int i = 0; i < K; ++i) g[i] = e[u * K + i];
        }
      first = K - 1;
#pragma unroll
      for (int i = K - 1; i >= 0; --i)
        if (to_f32(g[i]) == bm) first = i;
    }
    a = j0 + ub * stride + first;
  }
  float s[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    s[u] = 0.f;
    if (u < nu) {
#pragma unroll
      for (int i = 0; i < K; ++i)
        s[u] += ex2((to_f32(e[u * K + i]) - m) * kLog2e);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) l += s[u];
}

// Columns [c0, c1) of one row reduced to thread t's (m, l, a), the n threads
// t = 0 .. n - 1 together covering the range: 16-byte chunks t, t + n, ...
// (vec: c0 16-byte aligned, c1 - c0 whole chunks) or columns c0 + t,
// c0 + t + n, ..., kBatch loads in flight at a time.
template <typename T>
__device__ __forceinline__ void range_triple(const T* __restrict__ row,
                                             int c0, int c1, int t, int n,
                                             bool vec, float& m, float& l,
                                             int& a) {
  m = NEG_BIG;
  l = 0.f;
  a = INT_MAX;
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const uint4* rv = reinterpret_cast<const uint4*>(row + c0);
    const int nc = (c1 - c0) / kVec;
    for (int base = t; base < nc; base += kBatch * n) {
      uint4 raw[kBatch];
      float cm[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = base + u * n;
        raw[u] = c < nc ? __ldg(rv + c) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) cm[u] = chunk_max<T>(raw[u]);
      fold_batch<T, kBatch, kVec>(reinterpret_cast<const T*>(raw), cm,
                                  (nc - base + n - 1) / n, c0 + base * kVec,
                                  n * kVec, m, l, a);
    }
    return;
  }
  for (int base = c0 + t; base < c1; base += kBatch * n) {
    T raw[kBatch];
    float cm[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = base + u * n;
      raw[u] = j < c1 ? __ldg(row + j) : from_f32<T>(0.f);
      cm[u] = to_f32(raw[u]);
    }
    fold_batch<T, kBatch, 1>(raw, cm, (c1 - base + n - 1) / n, base, n, m, l,
                             a);
  }
}

// Fold the (m, l, a) of the `width` lanes of each aligned lane group
// (width a power of two, at most 32): the maximum, then each l rescaled to
// it and summed, and the smallest a among the maximum's holders, by xor
// shuffles.  The group's first lane holds the result (the others hold the
// same values summed in other orders).  Every lane of the warp must call.
__device__ __forceinline__ void group_reduce(float& m, float& l, int& a,
                                             int width) {
  float M = m;
  for (int o = width / 2; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  if (m != M) {
    l *= ex2((m - M) * kLog2e);
    a = INT_MAX;
  }
  for (int o = width / 2; o > 0; o >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
    a = min(a, __shfl_xor_sync(0xffffffffu, a, o));
  }
  m = M;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One cluster of C CTAs per row (grid B * C), or, when `lanes` > 0, a
// group of `lanes` lanes per row (256 / lanes rows a CTA, C = 1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    conf_cluster_kernel(const T* __restrict__ x, long long row_stride, int B,
                        int V, int C, int lanes, bool vec,
                        int* __restrict__ idx_out,
                        float* __restrict__ conf_out) {
  float m, l;
  int a;
  if (lanes > 0) {
    const int b = blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
    const int t = threadIdx.x % lanes;
    range_triple<T>(x + (long long)min(b, B - 1) * row_stride, 0,
                    b < B ? V : 0, t, lanes, vec, m, l, a);
    group_reduce(m, l, a, lanes);
    if (t == 0 && b < B) {
      idx_out[b] = a;
      conf_out[b] = 1.f / l;
    }
    return;
  }
  __shared__ float4 slots[kMaxCluster];  // rank 0's: slot r holds rank r's
  __shared__ float4 warps[kWarps];
  if (C > 1) cluster_arrive_relaxed();  // this CTA runs
  const int b = blockIdx.x / C;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = C == 1 ? 0 : (int)cluster.block_rank();
  int c0, c1;
  plan_range(V, C, rank, c0, c1);
  range_triple<T>(x + (long long)b * row_stride, c0, c1, threadIdx.x,
                  kThreads, vec, m, l, a);
  // the CTA's triple: each warp's, then warp 0 over the warps'
  group_reduce(m, l, a, 32);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warps[warp] = make_float4(m, l, __int_as_float(a), 0.f);
  __syncthreads();
  if (warp == 0) {
    const float4 w = lane < kWarps ? warps[lane]
                                   : make_float4(NEG_BIG, 0.f,
                                                 __int_as_float(INT_MAX), 0.f);
    m = w.x;
    l = w.y;
    a = __float_as_int(w.z);
    group_reduce(m, l, a, kWarps);
  }
  if (C == 1) {
    if (threadIdx.x == 0) {
      idx_out[b] = a;
      conf_out[b] = 1.f / l;
    }
    return;
  }
  cluster_wait();  // every CTA of the cluster runs: rank 0's slots exist
  if (threadIdx.x == 0)
    *cluster.map_shared_rank(&slots[rank], 0) =
        make_float4(m, l, __int_as_float(a), 0.f);
  cluster.sync();  // the C slots have landed
  if (rank == 0 && warp == 0) {
    float4 p = make_float4(NEG_BIG, 0.f, __int_as_float(INT_MAX), 0.f);
    if (lane < C) p = slots[lane];
    m = p.x;
    l = p.y;
    a = __float_as_int(p.z);
    group_reduce(m, l, a, kMaxCluster);
    if (lane == 0) {
      idx_out[b] = a;
      conf_out[b] = 1.f / l;
    }
  }
}

// Allow C = 16 on the current device (a function attribute is set per
// device): once a device, remembered only when it succeeded.
template <typename T>
cudaError_t allow_cluster_16() {
  static std::atomic<unsigned long long> allowed{0};  // bit d: device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (allowed.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(conf_cluster_kernel<T>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (err == cudaSuccess) allowed.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// lanes per row for rows of at most kGroupCols columns (a power of two)
int group_lanes(int V) {
  int L = 1;
  while (L < 32 && V > L * kLaneCols) L *= 2;
  return L;
}

}  // namespace

// CTA r's column range [*c0, *c1) of a row of V columns cut over C CTAs.
extern "C" int confidence_range(int V, int C, int r, int* c0, int* c1) {
  if (V <= 0 || C <= 0 || r < 0 || r >= C) return (int)cudaErrorInvalidValue;
  plan_range(V, C, r, *c0, *c1);
  return (int)cudaSuccess;
}

// C CTAs a row (1, 2, 4, 8 or 16); C = 1 with V <= kGroupCols takes a lane
// group a row.
extern "C" int confidence_launch(const void* logits, long long row_stride,
                                 int B, int V, int dtype, int C,
                                 void* idx_out, void* conf_out,
                                 void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (V <= 0 || C <= 0 || C > kMaxCluster || (C & (C - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int lanes = C == 1 && V <= kGroupCols ? group_lanes(V) : 0;
  const long long rows_per_cta = lanes ? kThreads / lanes : 0;
  const long long blocks = lanes ? ((long long)B + rows_per_cta - 1) /
                                       rows_per_cta
                                 : (long long)B * C;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  DISPATCH_DTYPE(dtype, T, {
    if (C > 8) {
      const cudaError_t err = allow_cluster_16<T>();
      if (err != cudaSuccess) return (int)err;
    }
    const bool vec = vec16_ok<T>(logits, V, {row_stride});
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, conf_cluster_kernel<T>, (const T*)logits, row_stride, B, V, C,
        lanes, vec, (int*)idx_out, (float*)conf_out);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  });
  return (int)cudaErrorInvalidValue;
}
