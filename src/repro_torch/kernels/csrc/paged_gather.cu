// Paged gather: the slot-logical ring views of a layer's paged k and v
// stores, gathered through the slots' block-table rows, in one launch.
//
// Replaces the Pallas kernel `_gather_kernel` / `paged_gather` of the JAX
// package's kernels/paged_gather.py: store (NB, bs, kv, hd) and table
// (B, nblk) int32 -> out (B, nblk * bs, kv, hd) with out[b, j * bs + i] =
// store[table[b, j], i].  Block 0 (the trash block) is copied like any
// other.  The TPU kernel makes one pallas_call per store (two per decode
// layer, k and v), each grid cell (b, j) one DMA whose source block comes
// from the scalar-prefetched table; here one launch covers both stores,
// and the copy engine moves the blocks as the TPU's DMA engine does.
//
// Bound on the H100: bytes (each gathered block read once, written once;
// at B = 4, nblk = 32, bs = 16, kv = 2, hd = 128 in bf16 that is 4.19 MB
// for the pair, 1.25 us at 3.35 TB/s, where the launch itself dominates;
// at qwen2.5-3b's layer store of block size 64, B = 16, a 4096-position
// ring, 134 MB, 40 us).
//
// Design: a persistent grid of at most one CTA per SM (n_ctas, from the
// wrapper), each CTA one warp.  The units are (store z, slot b, ring block j)
// in that order, u = (z * B + b) * nblk + j.  A block of bs * kv * hd elements
// is contiguous in its store and in the output, and is moved in boxes of at
// most 16 KB (kernels/paged_gather.py:boxes), so a 32 KB bf16 or 64 KB f32
// block of block size 64 still pipelines; box x of unit u is item u * nbox +
// x.  CTA c walks the contiguous range of items that
// kernels/paged_gather.py:plan gives it (split as evenly as they go, the first
// n_items % n_ctas one more): split by boxes and not by units, the 64 f32
// blocks of block size 64 of a B = 4 decode step (256 boxes) spread over every
// SM, not over 64 of them.  The warp's lanes read the ids of a window of up to
// 1024 of the range's units into shared memory (32 loads in flight, not one
// dependent load a block); then lane 0 alone drives the copy engine through a
// ring of kStages 16 KB stages: `cp.async.bulk` global -> shared completing on
// the stage's mbarrier, kStages - 1 boxes ahead, and as each box lands,
// `cp.async.bulk` shared -> global in a bulk group of its own; a stage is
// loaded again once the store out of it has read it
// (`cp.async.bulk.wait_group.read`).  The registers never hold the data. Boxes
// of 8 KB (8 or 16 stages) and 4 KB (16 or 32) were no faster at the 4.2 MB
// pair and slower at every larger shape, the 134 MB one 1.9x at 4 KB: a bulk
// copy's fixed cost rules (H100 80GB HBM3, 700 W; PERF.md §5, §6).  The
// store's block stride is a parameter, so the (NB, ...) layer slice of a
// stacked (n, NB, ...) store is read where it lies.  Every address and size
// must be 16-byte aligned (the bulk copy's rule): the launcher refuses
// anything else, and the wrapper checks before it launches.  Block ids come
// from the host's pool and are trusted: there is no bounds check, and no sync;
// the table is read from device memory, so a captured launch reads each
// replay's table.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kMaxStores = 2;
constexpr int kStages = 8;                // ring depth: 128 KB in flight
constexpr long long kBox = 16384;         // bytes of one box / stage
constexpr int kWindow = 1024;             // table ids read at a time

struct Args {
  const char* src[kMaxStores];
  char* dst[kMaxStores];
  long long src_block_stride[kMaxStores];  // bytes between blocks id, id + 1
  const int* table;
  long long table_s0, table_s1;            // elements
  long long block_bytes;                   // bs * kv * hd * element size
  int B, nblk;
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// every bulk group but the newest `n` has read its shared memory
template <int n>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(n) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    paged_gather_kernel(const Args a, long long n_units, int n_ctas) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kStages];
  __shared__ int ids[kWindow];
  const int lane = threadIdx.x, cta = blockIdx.x;
  const long long nbox = (a.block_bytes + kBox - 1) / kBox;
  const long long n_items = n_units * nbox;
  const long long per = n_items / n_ctas, rem = n_items % n_ctas;
  const long long i0 = cta * per + min((long long)cta, rem);
  const long long i1 = i0 + per + (cta < rem ? 1 : 0);
  if (i0 >= i1) return;
  // the units the range touches
  const long long u0 = i0 / nbox, u1 = (i1 - 1) / nbox + 1;
  const long long per_store = (long long)a.B * a.nblk;
  long long seq = 0;  // boxes this CTA has moved: stage seq % kStages
  for (long long w0 = u0; w0 < u1; w0 += kWindow) {
    const int nw = (int)min((long long)kWindow, u1 - w0);
    for (int k = lane; k < nw; k += kThreads) {
      const long long bj = (w0 + k) % per_store;
      ids[k] = __ldg(a.table + (bj / a.nblk) * a.table_s0 +
                     (bj % a.nblk) * a.table_s1);
    }
    if (w0 == u0 && lane == 0) {  // while the first ids load
      for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
      mbar_fence_init();
    }
    __syncwarp();
    if (lane == 0) {
      // the window's items q0 .. q0 + n - 1 of this CTA's range, in order
      const long long q0 = max(i0, w0 * nbox);
      const long long n = min(i1, (w0 + nw) * nbox) - q0;
      // item q0 + q: unit u = (q0 + q) / nbox, bytes [off, off + size) of
      // its block
      auto locate = [&](long long q, const char*& src, char*& dst,
                        uint32_t& size) {
        const long long u = (q0 + q) / nbox, k = u - w0;
        const long long off = ((q0 + q) % nbox) * kBox;
        const int z = (int)(u / per_store);
        size = (uint32_t)min(kBox, a.block_bytes - off);
        src = a.src[z] + (long long)ids[k] * a.src_block_stride[z] + off;
        dst = a.dst[z] + (u % per_store) * a.block_bytes + off;
      };
      auto load = [&](long long q) {
        const char* src;
        char* dst;
        uint32_t size;
        locate(q, src, dst, size);
        const int st = (int)((seq + q) % kStages);
        mbar_expect_tx(&full[st], size);
        bulk_load(ring + st * kBox, src, size, &full[st]);
      };
      for (long long q = 0; q < min(n, (long long)kStages); ++q) load(q);
      for (long long q = 0; q < n; ++q) {
        const char* src;
        char* dst;
        uint32_t size;
        locate(q, src, dst, size);
        const long long g = seq + q;
        const int st = (int)(g % kStages);
        mbar_wait(&full[st], (uint32_t)((g / kStages) & 1));
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_store(dst, ring + st * kBox, size);
        // the stage of box q - 1 is free once its store has read it
        if (q >= 1 && q - 1 + kStages < n) {
          bulk_wait_read<1>();
          load(q - 1 + kStages);
        }
      }
      // every stage free for the next window, and the shared memory read
      // before the CTA ends
      bulk_wait_read<0>();
      seq += n;
    }
    __syncwarp();
  }
}

}  // namespace

// n stores (1 or 2) of one shape: src[i] the store's base pointer, its
// block stride in bytes, dst[i] a contiguous (B, nblk * bs, kv, hd) output;
// table (B, nblk) int32 with element strides table_s0, table_s1; n_ctas
// persistent CTAs (at most one per SM).  Every base, the block strides and
// block_bytes must be multiples of 16 bytes: anything else is refused with
// cudaErrorInvalidValue.
extern "C" int paged_gather_launch(int n, const void* src0, const void* src1,
                                   long long src_stride0,
                                   long long src_stride1, void* dst0,
                                   void* dst1, const int* table,
                                   long long table_s0, long long table_s1,
                                   int B, int nblk, long long block_bytes,
                                   int n_ctas, void* stream) {
  if (n < 1 || n > kMaxStores || n_ctas < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || nblk <= 0 || block_bytes <= 0) return (int)cudaSuccess;
  const void* src[2] = {src0, src1};
  void* dst[2] = {dst0, dst1};
  const long long stride[2] = {src_stride0, src_stride1};
  if (block_bytes % 16) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i)
    if ((uintptr_t)src[i] % 16 || (uintptr_t)dst[i] % 16 || stride[i] % 16)
      return (int)cudaErrorInvalidValue;
  Args a{};
  for (int i = 0; i < n; ++i) {
    a.src[i] = (const char*)src[i];
    a.dst[i] = (char*)dst[i];
    a.src_block_stride[i] = stride[i];
  }
  a.table = table;
  a.table_s0 = table_s0;
  a.table_s1 = table_s1;
  a.block_bytes = block_bytes;
  a.B = B;
  a.nblk = nblk;
  const long long n_units = (long long)n * B * nblk;
  const long long n_items = n_units * ((block_bytes + kBox - 1) / kBox);
  const int ctas = (int)min((long long)n_ctas, n_items);
  const int smem = (int)(kStages * kBox);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  paged_gather_kernel<<<ctas, kThreads, smem, (cudaStream_t)stream>>>(
      a, n_units, ctas);
  return (int)cudaGetLastError();
}
