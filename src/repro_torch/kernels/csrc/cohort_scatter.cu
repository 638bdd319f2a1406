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
// Slot route: a decode step writes only ring slot t % W of a dense cache
// leaf (L, B, W, ...), so select mode lands just cohort c's rows of that
// slot, src (L, B / C, 1, ...) -> dst[:, c * B / C + b, slot].  The slot
// is read from device memory (`slot`, a 0-d int64 tensor the decode step
// computed), so a captured step lands each replay's rows at that replay's
// slot; the whole-cohort form passes a null `slot`.
//
// Bound on the H100: bytes (each source byte read once, written once).
// Design: for leaf i, layer l and cohort row r, the bytes to move are one
// contiguous run of `chunk` bytes in dst (at dst + l * dst_stride +
// r * dst_row_stride + slot * slot_stride) and in src (at src +
// l * src_stride + r * src_row_stride): the whole-cohort form is one run a
// layer (rows = 1), the slot route B / C runs a layer.  The leaves'
// descriptors ride in the launch's parameter block (a by-value array in
// the constant bank), so no host-to-device copy and no host sync precede
// the launch.  Grid (x, max L * rows, leaves): block (x, y, i) copies a
// grid-strided share of leaf i's run y with 16-byte loads and stores when
// the run and both addresses are 16-byte aligned, byte by byte otherwise.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 16;  // leaves per launch; more take more launches
constexpr int kUnroll = 4;

struct Leaf {
  char* dst;               // cohort c's first row (ring position 0)
  const char* src;
  long long dst_stride;    // bytes between layers l and l + 1
  long long src_stride;
  long long dst_row_stride;  // bytes between cohort rows (slot route)
  long long src_row_stride;
  long long slot_stride;   // bytes between ring positions (slot route)
  long long chunk;         // bytes of one run
  int L;
  int rows;                // runs a layer: 1, or B / C on the slot route
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
};

__global__ void __launch_bounds__(kThreads)
    cohort_scatter_kernel(const Leaves args, const long long* slot) {
  const Leaf f = args.leaf[blockIdx.z];
  const int l = blockIdx.y / f.rows;
  const int r = blockIdx.y - l * f.rows;
  if (l >= f.L) return;
  const long long s = slot ? *slot : 0;
  char* d = f.dst + l * f.dst_stride + r * f.dst_row_stride + s * f.slot_stride;
  const char* sp = f.src + l * f.src_stride + r * f.src_row_stride;
  const long long step = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if ((((uintptr_t)d | (uintptr_t)sp | (uintptr_t)f.chunk) & 15) == 0) {
    uint4* d16 = reinterpret_cast<uint4*>(d);
    const uint4* s16 = reinterpret_cast<const uint4*>(sp);
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
  for (long long i = first; i < f.chunk; i += step) d[i] = sp[i];
}

}  // namespace

extern "C" int cohort_scatter_max_leaves() { return kMaxLeaves; }

// n leaves; dst/src: arrays of n device pointers (dst already offset to
// cohort c's first row); strides: n rows of 5 byte strides each (layer
// dst, layer src, row dst, row src, ring position); chunk, L and rows: n
// values each; slot: a device pointer to the ring slot (int64), or null
// for the whole-cohort form.
extern "C" int cohort_scatter_launch(int n, void* const* dst,
                                     const void* const* src,
                                     const long long* strides,
                                     const long long* chunk, const int* L,
                                     const int* rows, const void* slot,
                                     void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n > kMaxLeaves) return (int)cudaErrorInvalidValue;
  Leaves args{};
  int max_y = 0;
  long long max_chunk = 0;
  for (int i = 0; i < n; ++i) {
    const long long* st = strides + 5 * i;
    if (rows[i] < 1) return (int)cudaErrorInvalidValue;
    args.leaf[i] = Leaf{(char*)dst[i], (const char*)src[i], st[0], st[1],
                        st[2], st[3], st[4], chunk[i], L[i], rows[i]};
    const int y = L[i] * rows[i];
    max_y = y > max_y ? y : max_y;
    max_chunk = chunk[i] > max_chunk ? chunk[i] : max_chunk;
  }
  if (max_y <= 0 || max_chunk <= 0) return (int)cudaSuccess;
  // enough blocks per run for each thread to move kUnroll 16-byte vectors
  const long long per_block = (long long)kThreads * 16 * kUnroll;
  long long bx = (max_chunk + per_block - 1) / per_block;
  bx = bx < 1 ? 1 : (bx > 1024 ? 1024 : bx);
  if (max_y > 65535) return (int)cudaErrorInvalidValue;
  cohort_scatter_kernel<<<dim3((unsigned)bx, max_y, n), kThreads, 0,
                          (cudaStream_t)stream>>>(
      args, (const long long*)slot);
  return (int)cudaGetLastError();
}
