// Cohort scatter: write cohort c's rows of every leaf of a segment's cache
// tree into the full slab, in one launch.
//
// Replaces the Pallas kernel `_scatter_kernel` / `cohort_scatter` of the
// JAX package's kernels/cohort_cache.py: dst (L, B, ...) takes src
// (L, B / C, ...) at rows [c * B / C, (c + 1) * B / C) of axis 1, the other
// cohorts' rows untouched; the bytes are exactly those of the per-leaf
// copy (bool leaves copy as bytes).  The TPU kernel makes one aliased
// pallas_call per leaf; here one launch covers every leaf of the tree.
//
// Bound on the H100: bytes (each source byte read once, written once).
// Design: for leaf i and layer l, cohort c's rows are one contiguous run
// of `chunk` bytes in dst (at dst + l * dst_stride) and in src (at
// src + l * src_stride), so the copy is L_i contiguous runs per leaf.  The
// leaves' (dst, src, L, chunk, strides) ride in the launch's parameter
// block (a by-value array in the constant bank), so no host-to-device copy
// and no host sync precede the launch.  Grid (x, max L, leaves): block
// (x, l, i) copies a grid-strided share of leaf i's run l with 16-byte
// loads and stores when the run and both addresses are 16-byte aligned,
// byte by byte otherwise.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 16;  // leaves per launch; more take more launches
constexpr int kUnroll = 4;

struct Leaf {
  char* dst;
  const char* src;
  long long dst_stride;  // bytes between layers l and l + 1
  long long src_stride;
  long long chunk;       // bytes of cohort c's rows in one layer
  int L;
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
};

__global__ void __launch_bounds__(kThreads)
    cohort_scatter_kernel(const Leaves args) {
  const Leaf f = args.leaf[blockIdx.z];
  const int l = blockIdx.y;
  if (l >= f.L) return;
  char* d = f.dst + l * f.dst_stride;
  const char* s = f.src + l * f.src_stride;
  const long long step = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if ((((uintptr_t)d | (uintptr_t)s | (uintptr_t)f.chunk) & 15) == 0) {
    uint4* d16 = reinterpret_cast<uint4*>(d);
    const uint4* s16 = reinterpret_cast<const uint4*>(s);
    const long long n = f.chunk / 16;
    long long i = first;
    for (; i + (kUnroll - 1) * step < n; i += kUnroll * step) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = s16[i + u * step];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) d16[i + u * step] = v[u];
    }
    for (; i < n; i += step) d16[i] = s16[i];
    return;
  }
  for (long long i = first; i < f.chunk; i += step) d[i] = s[i];
}

}  // namespace

extern "C" int cohort_scatter_max_leaves() { return kMaxLeaves; }

// n leaves; dst/src: arrays of n device pointers (dst already offset to
// cohort c's first row); the other arrays hold n values each.
extern "C" int cohort_scatter_launch(int n, void* const* dst,
                                     const void* const* src,
                                     const long long* dst_stride,
                                     const long long* src_stride,
                                     const long long* chunk, const int* L,
                                     void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Leaves args{};
  int max_l = 0;
  long long max_chunk = 0;
  for (int i = 0; i < n; ++i) {
    args.leaf[i] = Leaf{(char*)dst[i], (const char*)src[i], dst_stride[i],
                        src_stride[i], chunk[i], L[i]};
    max_l = L[i] > max_l ? L[i] : max_l;
    max_chunk = chunk[i] > max_chunk ? chunk[i] : max_chunk;
  }
  if (max_l <= 0 || max_chunk <= 0) return (int)cudaSuccess;
  // enough blocks per run for each thread to move kUnroll 16-byte vectors
  const long long per_block = (long long)kThreads * 16 * kUnroll;
  long long bx = (max_chunk + per_block - 1) / per_block;
  bx = bx < 1 ? 1 : (bx > 1024 ? 1024 : bx);
  cohort_scatter_kernel<<<dim3((unsigned)bx, max_l, n), kThreads, 0,
                          (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}
