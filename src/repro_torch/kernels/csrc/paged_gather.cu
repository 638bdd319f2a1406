// Paged gather: the slot-logical ring views of a layer's paged k and v
// stores, gathered through the slots' block-table rows, in one launch.
//
// Replaces the Pallas kernel `_gather_kernel` / `paged_gather` of the JAX
// package's kernels/paged_gather.py: store (NB, bs, kv, hd) and table
// (B, nblk) int32 -> out (B, nblk * bs, kv, hd) with out[b, j * bs + i] =
// store[table[b, j], i].  Block 0 (the trash block) is copied like any
// other.  The TPU kernel makes one pallas_call per store (two per decode
// layer, k and v), each grid cell (b, j) one DMA whose source block comes
// from the scalar-prefetched table; here one launch covers both stores.
//
// Bound on the H100: bytes (each gathered block read once, written once;
// at B = 4, nblk = 32, bs = 16, kv = 2, hd = 128 in bf16 that is 4.19 MB
// for the pair, 1.25 us at 3.35 TB/s).  At that size the launch itself
// (a few us) dominates, which is why k and v share one.
// Design: grid (nblk, B, stores), one block per (ring block j, slot b,
// store).  The block reads table[b, j] once (one broadcast load per warp)
// and copies the physical block's bs * kv * hd elements, which are
// contiguous in the store, with 16-byte loads and stores when the block's
// size and both addresses allow it (byte by byte otherwise).  The store's
// block stride is a parameter, so the (NB, ...) layer slice of a stacked
// (n, NB, ...) store is read where it lies.  Block ids come from the host's
// pool and are trusted: there is no bounds check, and no sync.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStores = 2;
constexpr int kUnroll = 2;

struct Args {
  const char* src[kMaxStores];
  char* dst[kMaxStores];
  long long src_block_stride[kMaxStores];  // bytes between blocks id, id + 1
  const int* table;
  long long table_s0, table_s1;            // elements
  long long block_bytes;                   // bs * kv * hd * element size
};

__global__ void __launch_bounds__(kThreads)
    paged_gather_kernel(const Args a) {
  const int j = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int nblk = gridDim.x;
  const long long id = __ldg(a.table + b * a.table_s0 + j * a.table_s1);
  const char* s = a.src[z] + id * a.src_block_stride[z];
  char* d = a.dst[z] + ((long long)b * nblk + j) * a.block_bytes;
  if ((((uintptr_t)d | (uintptr_t)s | (uintptr_t)a.block_bytes) & 15) == 0) {
    const uint4* s16 = reinterpret_cast<const uint4*>(s);
    uint4* d16 = reinterpret_cast<uint4*>(d);
    const long long n = a.block_bytes / 16;
    long long i = threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < n; i += kUnroll * kThreads) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(s16 + i + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) d16[i + u * kThreads] = v[u];
    }
    for (; i < n; i += kThreads) d16[i] = __ldg(s16 + i);
    return;
  }
  for (long long i = threadIdx.x; i < a.block_bytes; i += kThreads)
    d[i] = s[i];
}

}  // namespace

// n stores (1 or 2) of one shape: src[i] the store's base pointer, its
// block stride in bytes, dst[i] a contiguous (B, nblk * bs, kv, hd) output;
// table (B, nblk) int32 with element strides table_s0, table_s1.
extern "C" int paged_gather_launch(int n, const void* src0, const void* src1,
                                   long long src_stride0,
                                   long long src_stride1, void* dst0,
                                   void* dst1, const int* table,
                                   long long table_s0, long long table_s1,
                                   int B, int nblk, long long block_bytes,
                                   void* stream) {
  if (n < 1 || n > kMaxStores || B > 65535) return (int)cudaErrorInvalidValue;
  if (B <= 0 || nblk <= 0 || block_bytes <= 0) return (int)cudaSuccess;
  Args a{};
  a.src[0] = (const char*)src0;
  a.src[1] = (const char*)src1;
  a.dst[0] = (char*)dst0;
  a.dst[1] = (char*)dst1;
  a.src_block_stride[0] = src_stride0;
  a.src_block_stride[1] = src_stride1;
  a.table = table;
  a.table_s0 = table_s0;
  a.table_s1 = table_s1;
  a.block_bytes = block_bytes;
  paged_gather_kernel<<<dim3((unsigned)nblk, (unsigned)B, (unsigned)n),
                        kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
