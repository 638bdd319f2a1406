// Fused exit-head megakernel: rmsnorm(h) * w, the (B, d) @ (d, V) head
// product, the softmax-max confidence and the exit-update carry merge,
// without the (B, V) logits ever reaching device memory.  Two routes,
// picked by the wrapper (kernels/megakernel.py:route) before the launch.
//
// Replaces the Pallas kernel `_megakernel` / `exit_head_update` of the JAX
// package's kernels/megakernel.py.  Semantics pinned there:
//  * xn = (x * rsqrt(mean(x^2) + eps)) * w in f32, cast once to x's dtype,
//    with the arithmetic of the csrc/rmsnorm.cu route the same rows take
//    (common.cuh's warp_row_load / warp_row_scale where the rows allow the
//    "warp" route, else the "block" route's strided sum and block_sum), so
//    the fused head and the unfused route normalise a row bit for bit
//    alike;
//  * logits = xn @ head with f32 accumulation; for a bf16/f16 model each
//    logit is rounded to the model dtype before the f32 softmax math, as
//    the unfused route's logits are (`lowp`);
//  * vocab columns at or past V never enter the reduction (the reference
//    pads them to -1e30);
//  * argmax is the FIRST index of the row maximum; delta = 1 / sum(exp);
//  * then exit_carry_merge of common.cuh, shared with the fused exit-update
//    kernel, with dead rows (live false) passing every carry through.
// The threshold δ̂ is an f32 in device memory that the combine reads once
// per row when it gates (the reference's `dynamic` route): a threshold
// push never rebuilds, and a captured graph replays at its current value.
// Both routes write (max, sum-exp, first-argmax) partials to a (3, B, P)
// workspace; a second launch (`head_combine_kernel`) merges each row's P
// partials in a fixed order (merge_partials) and applies the carry merge,
// so a run repeats its bits.  A launch whose rows are all dead reads no
// head byte; the combine passes dead rows through without reading
// partials.
//
// Bound on the H100: bytes.  The head is read once: d * V * sizeof(T)
// (2048 * 151936 * 2 B = 622 MB at qwen2.5-3b, ~0.19 ms at 3.35 TB/s); the
// product is 2 * B * d * V flops (5 GFLOP at B = 8, ~5 us at the tensor
// cores' rate, ~75 us on the CUDA cores).
//
// Route "tc" (`head_tc_kernel`; bf16 / fp16, B <= 16, a head and rows TMA
// and 16-byte loads can address, and a ring of at least kTcMinStages
// stages beside the normalised rows in shared memory: every exit head of
// the bf16 serving paths, d 7168 at B <= 8 included).  A persistent grid,
// one CTA per SM, each owning a contiguous range of 64-column vocab tiles
// (~18 at V = 151936 on 132 SMs, 3 or 4 at V = 32256).  One producer warp
// streams the range's head by TMA into an mbarrier ring of 16 KB stages:
// 8 stages, 128 KB in flight per SM where Little's law at 3.35 TB/s asks
// for ~20 KB, wherever they fit beside the rows (every d <= 4096 at
// B <= 8), else as many as fit (tc_stages: 7 at d 7168 and B <= 8, whose
// rows take 112 KB; B > 8 there leaves no room for 4 and takes
// "cuda_core").  A stage is two neighbouring
// tiles' boxes of 64 columns x 64 rows (128-byte swizzle), so each head
// row is read 256 contiguous bytes at a time.  At B = 4 one tile's 128
// rows a stage (128-byte reads, each in another DRAM page) ran at 63 % of
// the HBM rate, 2 x 64 at 86 %, 4 x 32 at 85 %, 8 x 16 at 80 %; 4 stages
// ran as fast as 8, and freeing a stage one stage late gained nothing
// (H100 80GB HBM3, 700 W).  The consumer warpgroup normalises the B rows
// into shared memory once per CTA while the first stages load, in the
// arithmetic of the rmsnorm route the rows take: "warp" up to 16 16-byte
// chunks a lane, else the "block" route's order (each lane carrying 8 of
// its 256 threads' strided sums, a warp a row, block_sum's shuffle tree
// split across lanes and registers).  The block route's operands are
// fetched before the ring's first loads (the raw rows by cp.async, the
// weights into registers), and the producer stops after 2 stages until
// the rows have landed: behind ~15 MB of ring loads over the card, and
// summed a 2-byte read at a time, they held the first wgmma back by 24 us
// at B = 4 (H100 80GB HBM3, 700 W; PERF.md §5, §6).  Then the warpgroup
// computes logitsᵀ = headᵀ xnᵀ on the tensor cores (swap-AB: wgmma
// m64nNk16, N = 8 for B <= 8 and 16 above, the head tile as the M-major A
// operand, the normalised rows as the K-major B operand, f32
// accumulation), and folds each tile's logits into per-thread triples;
// the CTA writes one partial per row (P = the CTA count).  The wgmma
// issue and the epilogue overlap the loads of the next stages, so the
// kernel is left waiting on HBM.
//
// Route "cuda_core" (`head_partial_kernel`; f32, where tensor cores would
// mean TF32 and the port runs with TF32 off, unaligned or V % 8 != 0
// heads, B > 16).  The vocab is split across blocks: block (tile, g) owns
// kVt = 32 * (16 / sizeof(T)) consecutive columns for the row group g of
// at most NB rows: it recomputes the group's normalised rows into shared
// memory (f32 copies of the T-rounded values); warp w streams head rows
// [w * d / 8, (w + 1) * d / 8) of its columns with 16-byte loads, kUnroll
// rows in flight, accumulating NB x (16 / sizeof(T)) dot products per
// thread in f32 on the CUDA cores; the 8 warps' sums are added in warp
// order in shared memory, then warp r reduces row r's kVt logits to a
// partial (P = the tile count).
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // head rows in flight per thread

template <typename T>
__host__ __device__ constexpr int vt_of() {
  return 32 * (16 / (int)sizeof(T));
}

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads) head_partial_kernel(
    const T* __restrict__ h, long long h_stride, const float* __restrict__ w,
    const T* __restrict__ head, long long ld, int B, int d, int V,
    const uint8_t* __restrict__ live, float eps, int lowp, int vec,
    int warp_norm, int n_tiles, float* __restrict__ pm,
    float* __restrict__ pl, int* __restrict__ pa) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVt = vt_of<T>();
  extern __shared__ float smem[];
  float* xn = smem;            // NB x d: normalised rows (T-rounded, as f32)
  float* red = smem + NB * d;  // NB x kVt column sums, laid out [r][i][lane]
  __shared__ float part[kWarps];
  const int tile = blockIdx.x;
  const int r0 = blockIdx.y * NB;
  const int nb = min(NB, B - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  bool any_live = live == nullptr;
  for (int r = 0; r < nb && !any_live; ++r) any_live = live[r0 + r] != 0;
  if (!any_live) return;  // the whole group passes its carries through

  // 1. the exit head's rmsnorm, with the arithmetic of the route
  //    csrc/rmsnorm.cu takes for these rows: warp r normalises row r
  //    (common.cuh's warp_row_load / warp_row_scale), or the block does
  //    row after row (the "block" route's strided sum and block_sum)
  if (warp_norm) {
    if (warp < nb) {
      uint4 v[16];
      warp_row_load<T, 16>(h + (long long)(r0 + warp) * h_stride, d, v);
      const float rs = warp_row_rs<T, 16>(v, d, eps);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = lane + 32 * j;
        if (c * kVec < d) {
          float wf[kVec];
          load_weights<float>(w, c, wf);
          const uint4 o = warp_row_scale<T>(v[j], rs, wf);
          const T* e = reinterpret_cast<const T*>(&o);
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            xn[warp * d + c * kVec + i] = to_f32(e[i]);
        }
      }
    }
  } else {
    for (int r = 0; r < nb; ++r) {
      const T* xr = h + (long long)(r0 + r) * h_stride;
      float ss = 0.f;
      for (int i = tid; i < d; i += kThreads) {
        const float v = to_f32(xr[i]);
        ss += v * v;
      }
      const float rs =
          rsqrtf(block_sum<kThreads>(ss, part) / (float)d + eps);
      for (int i = tid; i < d; i += kThreads)
        xn[r * d + i] = to_f32(from_f32<T>((to_f32(xr[i]) * rs) * w[i]));
    }
  }
  for (int i = tid; i < (NB - nb) * d; i += kThreads) xn[nb * d + i] = 0.f;
  __syncthreads();

  // 2. stream this warp's slice of head rows for the block's columns
  const int col0 = tile * kVt + lane * kVec;
  const int kc = (d + kWarps - 1) / kWarps;
  const int k0 = min(d, warp * kc), k1 = min(d, k0 + kc);
  float acc[NB][kVec];
#pragma unroll
  for (int r = 0; r < NB; ++r)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[r][i] = 0.f;
  if (col0 < V) {
    const T* p = head + col0;
    int k = k0;
    if (vec) {
      for (; k + kUnroll <= k1; k += kUnroll) {
        uint4 raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          raw[u] = __ldg(reinterpret_cast<const uint4*>(
              p + (long long)(k + u) * ld));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
          for (int r = 0; r < NB; ++r) {
            const float xv = xn[r * d + k + u];
#pragma unroll
            for (int i = 0; i < kVec; ++i)
              acc[r][i] = fmaf(xv, to_f32(e[i]), acc[r][i]);
          }
        }
      }
      for (; k < k1; ++k) {
        const uint4 raw =
            __ldg(reinterpret_cast<const uint4*>(p + (long long)k * ld));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int r = 0; r < NB; ++r) {
          const float xv = xn[r * d + k];
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            acc[r][i] = fmaf(xv, to_f32(e[i]), acc[r][i]);
        }
      }
    } else {
      // unaligned head or V % (16 / sizeof(T)) != 0: element loads
      for (; k < k1; ++k) {
        const T* row = p + (long long)k * ld;
        float hv[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          hv[i] = col0 + i < V ? to_f32(row[i]) : 0.f;
#pragma unroll
        for (int r = 0; r < NB; ++r) {
          const float xv = xn[r * d + k];
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            acc[r][i] = fmaf(xv, hv[i], acc[r][i]);
        }
      }
    }
  }

  // 3. add the warps' partial sums in warp order
  for (int ww = 0; ww < kWarps; ++ww) {
    if (warp == ww) {
#pragma unroll
      for (int r = 0; r < NB; ++r)
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          float* s = red + (r * kVec + i) * 32 + lane;
          *s = ww == 0 ? acc[r][i] : *s + acc[r][i];
        }
    }
    __syncthreads();
  }
  // ... and reduce row r's kVt logits in warp r
  for (int r = warp; r < nb; r += kWarps) {
    float m = NEG_BIG, l = 0.f;
    int a = INT_MAX;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int col = col0 + i;
      if (col < V) {
        float x = red[(r * kVec + i) * 32 + lane];
        if (lowp) x = to_f32(from_f32<T>(x));
        triple_push(m, l, a, x, col);
      }
    }
    warp_reduce_triple(m, l, a);
    if (lane == 0) {
      const long long o = (long long)(r0 + r) * n_tiles + tile;
      pm[o] = m;
      pl[o] = l;
      pa[o] = a;
    }
  }
}

// 4. merge row b's partials and apply the carry merge
__global__ void __launch_bounds__(kThreads)
    head_combine_kernel(const float* __restrict__ pm,
                        const float* __restrict__ pl,
                        const int* __restrict__ pa, int n_tiles,
                        const uint8_t* __restrict__ live, ExitCarry carry) {
  const int b = blockIdx.x;
  if (live != nullptr && live[b] == 0) {
    if (threadIdx.x == 0) exit_carry_merge(carry, b, 0.f, 0, false);
    return;
  }
  const long long o = (long long)b * n_tiles;
  float m, l;
  int a;
  merge_partials<kThreads>(pm + o, pl + o, pa + o, n_tiles, m, l, a);
  if (threadIdx.x == 0) exit_carry_merge(carry, b, 1.f / l, a, true);
}

// The partial contract (a head sharded over the mesh's `model` ranks by
// vocab): row b's partials merged as head_combine_kernel merges them, then
// written as one (max, Σexp, first argmax + vocab_offset) triple to part
// ((3, B) f32); the carries are left to the combine launch that merges the
// ranks' triples (common.cuh's exit_parts_combine_kernel).  A dead row's
// partials were never written: it gets the empty triple.
__global__ void __launch_bounds__(kThreads)
    head_parts_reduce_kernel(const float* __restrict__ pm,
                             const float* __restrict__ pl,
                             const int* __restrict__ pa, int n_tiles, int B,
                             const uint8_t* __restrict__ live,
                             int vocab_offset, float* __restrict__ part) {
  const int b = blockIdx.x;
  if (live != nullptr && live[b] == 0) {
    if (threadIdx.x == 0) store_part(part, B, b, NEG_BIG, 0.f, INT_MAX);
    return;
  }
  const long long o = (long long)b * n_tiles;
  float m, l;
  int a;
  merge_partials<kThreads>(pm + o, pl + o, pa + o, n_tiles, m, l, a);
  if (threadIdx.x == 0) store_part(part, B, b, m, l, a + vocab_offset);
}

template <typename T, int NB>
cudaError_t launch_partial(const T* h, long long h_stride, const float* w,
                           const T* head, long long ld, int B, int d, int V,
                           const uint8_t* live, float eps, int warp_norm,
                           int n_tiles, float* pm, float* pl, int* pa,
                           cudaStream_t s) {
  const size_t smem = (size_t)NB * (d + vt_of<T>()) * sizeof(float);
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        head_partial_kernel<T, NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  const int vec = vec16_ok<T>(head, V, {ld}) ? 1 : 0;
  const int lowp = sizeof(T) < 4 ? 1 : 0;
  const dim3 grid(n_tiles, (B + NB - 1) / NB);
  head_partial_kernel<T, NB><<<grid, kThreads, smem, s>>>(
      h, h_stride, w, head, ld, B, d, V, live, eps, lowp, vec, warp_norm,
      n_tiles, pm, pl, pa);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// route "tc": a persistent, TMA-fed tensor-core kernel for bf16 / fp16
// ---------------------------------------------------------------------------

constexpr int kTcCols = 64;        // vocab columns per tile: one 128-byte row
constexpr int kTcGroup = 2;        // tiles side by side in a stage
constexpr int kTcRows = 64;        // head rows per stage (the boxes' height)
constexpr int kTcStages = 8;       // ring depth where it fits: 128 KB
constexpr int kTcMinStages = 4;    // the least ring the route takes
constexpr int kTcBox = kTcCols * kTcRows * 2;  // 8 KB: one tile's box
constexpr int kTcStage = kTcGroup * kTcBox;    // 16 KB a stage
constexpr int kTcConsumers = 128;  // one warpgroup
constexpr int kTcThreads = kTcConsumers + 32;  // + the producer warp
constexpr int kTcBlockThreads = 256;  // the "block" norm's virtual threads
// the block norm's weight chunks a consumer thread holds: 8 floats each,
// chunks tid + 128 k; rows that leave a ring of kTcMinStages have at most
// 1296 chunks (d 10368 at B <= 8)
constexpr int kTcMaxWChunks = 11;
constexpr int kTcHeadStart = 2;  // ring stages loaded before the rows land
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory opt-in

// d (64 x N, f32) += A (64 x 16) B (16 x N): A M-major (the head tile,
// vocab contiguous: transpose bit set), B K-major (the normalised rows),
// both 128-byte swizzled in shared memory.  N = 8 or 16, N / 2 registers.
template <typename T, int N>
__device__ __forceinline__ void mma_tc(float (&d)[N / 2], uint64_t da,
                                       uint64_t db) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 8 && kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1));
  } else if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.f16.f16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1));
  } else if constexpr (kBf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
}

// the 128 consumer threads only (named barrier 1; the producer warp never
// joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kTcConsumers) : "memory");
}

// Shared memory of the tc kernel: the ring of `stages` stages, the
// normalised rows (d padded to whole 64-element chunks), the barriers (8
// pairs at any depth, and the block norm's `ready`) and the warps'
// triples.
__host__ __device__ constexpr size_t tc_xs_bytes(int n, int d) {
  return (size_t)n * ((d + 63) / 64) * 64 * 2;
}
__host__ __device__ constexpr size_t tc_smem_bytes(int n, int d,
                                                   int stages) {
  return (size_t)stages * kTcStage + tc_xs_bytes(n, d) +
         (2 * kTcStages + 1) * sizeof(uint64_t) + 4 * n * 3 * sizeof(float);
}
// The ring's depth for n rows of width d: 8 stages where they fit beside
// the rows, else as many as fit (below kTcMinStages the route is refused)
inline int tc_stages(int n, int d) {
  const size_t rest = tc_smem_bytes(n, d, 0);
  if (rest >= kMaxSmem) return 0;
  const size_t fit = (kMaxSmem - rest) / kTcStage;
  return fit < (size_t)kTcStages ? (int)fit : kTcStages;
}

// One CTA per SM walks a contiguous range of 64-column vocab tiles
// (megakernel.py's plan(): tiles split as evenly as they go, the first
// n_tiles % n_ctas CTAs one more), kTcGroup tiles side by side at a time:
// a stage holds 64 head rows of up to 2 neighbouring tiles (one 64 x 64
// box each), so every head row is read 256 contiguous bytes at a time.
// The producer warp's lane 0 streams the groups' stages by TMA into the
// ring; the consumer warpgroup first normalises the rows into shared
// memory (overlapped with the first loads), then per stage issues 4
// wgmma (k16 steps) per tile into that tile's logitsᵀ (64 vocab x N rows,
// f32: the group's tiles accumulate independently), and after a group's
// last stage folds its logits, rounded to T, into per-thread
// (max, Σexp, first-argmax) triples in ascending column order.  The
// triples meet across lanes (xor tree) and warps (in warp order), and
// thread b writes row b's partial at [b][cta].
//
// Accumulator layout of m64nNk16 (f32): thread t, warp w = t / 32, lane l,
// holds d[4g + 2h + e] at row (vocab) 16w + l/4 + 8h, column (batch row)
// 8g + 2(l%4) + e, g < N / 8.
template <typename T, int N>
__global__ void __launch_bounds__(kTcThreads, 1) head_tc_kernel(
    const __grid_constant__ CUtensorMap tm_head, const T* __restrict__ h,
    long long h_stride, const float* __restrict__ w, int B, int d, int V,
    const uint8_t* __restrict__ live, float eps, int warp_norm, int stages,
    T* __restrict__ xn_out, int n_ctas, float* __restrict__ pm,
    float* __restrict__ pl, int* __restrict__ pa) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(kVec == 8, "the tc route takes 16-bit rows");
  constexpr int NR = N / 2;     // accumulator registers a tile
  constexpr int NQ = N / 4;     // batch rows a thread holds
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_u32(smem_raw) & 1023) __trap();
  const int nkb = (d + kTcRows - 1) / kTcRows;  // stages per group
  unsigned char* ring = smem_raw;
  // row r's K chunk kc (64 elements) at xs + kc * N * 128 + r * 128, its
  // 16-byte unit u at (u ^ (r % 8)) * 16: the 128-byte swizzle, so one
  // descriptor per k16 step reads it as a K-major operand
  unsigned char* xs = ring + stages * kTcStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + tc_xs_bytes(N, d));
  uint64_t* empty = full + kTcStages;
  uint64_t* ready = empty + kTcStages;  // the block norm's rows have landed
  float* red_m = reinterpret_cast<float*>(ready + 1);  // [4][N]
  float* red_l = red_m + 4 * N;
  int* red_a = reinterpret_cast<int*>(red_l + 4 * N);

  const int n_tiles = (V + kTcCols - 1) / kTcCols;
  const int per = n_tiles / n_ctas, rem = n_tiles % n_ctas;
  const int cta = blockIdx.x;
  const int t0 = cta * per + min(cta, rem);
  const int t1 = t0 + per + (cta < rem ? 1 : 0);
  const int tid = threadIdx.x;

  bool any_live = live == nullptr;
  for (int r = 0; r < B && !any_live; ++r) any_live = live[r] != 0;
  if (!any_live) return;  // every row passes its carries through

  const int warp = tid / 32, lane = tid % 32;
  const int n_units = (int)(tc_xs_bytes(1, d) / 16);  // 16-byte units a row
  const int nu = d / kVec;                             // units of row data
  // row r's 16-byte unit c (8 elements) in the swizzled layout below
  auto unit = [&](int r, int c) {
    return reinterpret_cast<uint4*>(xs + (c / 8) * N * 128 + r * 128 +
                                    (((c % 8) ^ (r % 8)) << 4));
  };
  // the "block" norm's operands are fetched before the producer's first
  // loads, not behind them (~15 MB of ring loads over the card): the raw
  // rows by cp.async into their places in the swizzled layout, every
  // thread's weight chunks c = tid + 128 k into registers
  float4 wpre[kTcMaxWChunks][2];
  if (!warp_norm && tid < kTcConsumers) {
    for (int r = 0; r < B; ++r)
      for (int c = tid; c < nu; c += kTcConsumers)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_u32(unit(r, c))),
                     "l"(reinterpret_cast<const uint4*>(
                             h + (long long)r * h_stride) +
                         c)
                     : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kTcMaxWChunks; ++k) {
      const int c = tid + k * kTcConsumers;
      if (c < nu) {
        wpre[k][0] = __ldg(reinterpret_cast<const float4*>(w) + 2 * c);
        wpre[k][1] = __ldg(reinterpret_cast<const float4*>(w) + 2 * c + 1);
      }
    }
  }

  if (tid == kTcConsumers) prefetch_map(&tm_head);
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kTcConsumers);
    }
    mbar_init(ready, kTcConsumers);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kTcConsumers) {  // the producer warp: lane 0 issues every load
    if (tid == kTcConsumers) {
      // load `it` fills stage st in its round-th pass over the ring
      int it = 0, st = 0, round = 0;
      for (int g0 = t0; g0 < t1; g0 += kTcGroup) {
        const int ng = min(kTcGroup, t1 - g0);
        for (int kb = 0; kb < nkb; ++kb, ++it) {
          // past a head start, the ring waits for the block norm's rows:
          // behind ~15 MB of ring loads over the card they land late
          if (!warp_norm && it == kTcHeadStart) mbar_wait(ready, 0);
          if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
          mbar_expect_tx(&full[st], ng * kTcBox);
          for (int g = 0; g < ng; ++g)
            tma_load(ring + st * kTcStage + g * kTcBox, &tm_head, &full[st],
                     (g0 + g) * kTcCols, kb * kTcRows);
          if (++st == stages) {
            st = 0;
            ++round;
          }
        }
      }
    }
    return;
  }

  // the rows' rmsnorm while the first stages load, in the arithmetic of
  // the csrc/rmsnorm.cu route the same rows take; rows past B and columns
  // past d are zero
  if (!warp_norm) {
    // the "block" route (rmsnorm_kernel): zeros past B and d beside the
    // raw rows, which land by cp.async
    for (int r = 0; r < N; ++r)
      for (int c = r < B ? nu + tid : tid; c < n_units; c += kTcConsumers)
        *unit(r, c) = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    mbar_arrive(ready);
    consumers_sync();
    // virtual thread t < 256 sums x_i^2 over i = t, t + 256, ... in order:
    // element t % 8 of units t / 8 + 32 j.  Warp w takes rows w, w + 4,
    // lane q carrying virtual threads 8q .. 8q + 7 of the row, so one
    // 16-byte read feeds 8 of them, each in its own order.  block_sum's
    // shuffle tree over a virtual warp (lanes 4 vw .. 4 vw + 3) is its
    // offsets 16 and 8 across lanes (xor 2, 1) and 4, 2, 1 across a lane's
    // 8 sums; then warp 0 adds the 8 warp sums as block_sum does (part:
    // [N][8] sums, then [N] scales).
    float* part = red_m;
    for (int r = warp; r < B; r += 4) {
      float ss[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) ss[e] = 0.f;
#pragma unroll 4
      for (int c = lane; c < nu; c += 32) {
        const uint4 raw = *unit(r, c);
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float v = to_f32(x[e]);
          ss[e] += v * v;  // rmsnorm_kernel's expression: the same FMA
        }
      }
#pragma unroll
      for (int o = 2; o > 0; o >>= 1)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          ss[e] += __shfl_xor_sync(0xffffffffu, ss[e], o);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) {
        float t[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) t[e] = ss[e] + ss[e ^ o];
#pragma unroll
        for (int e = 0; e < kVec; ++e) ss[e] = t[e];
      }
      if (lane % 4 == 0) part[r * 8 + lane / 4] = ss[0];
    }
    consumers_sync();
    if (warp == 0) {
      for (int r = 0; r < B; ++r) {
        float s = lane < kTcBlockThreads / 32 ? part[r * 8 + lane] : 0.f;
        s = warp_sum(s);
        if (lane == 0) part[N * 8 + r] = rsqrtf(s / (float)d + eps);
      }
    }
    consumers_sync();
    // xn = T((x * rs) * w), in place
#pragma unroll
    for (int k = 0; k < kTcMaxWChunks; ++k) {
      const int c = tid + k * kTcConsumers;
      if (c < nu) {
        const float wf[kVec] = {wpre[k][0].x, wpre[k][0].y, wpre[k][0].z,
                                wpre[k][0].w, wpre[k][1].x, wpre[k][1].y,
                                wpre[k][1].z, wpre[k][1].w};
#pragma unroll
        for (int r = 0; r < N; ++r) {
          if (r < B) {
            uint4* p = unit(r, c);
            *p = warp_row_scale<T>(*p, part[N * 8 + r], wf);
          }
        }
      }
    }
  }
  for (int r = warp; r < N && warp_norm; r += 4) {
    unsigned char* xr = xs + r * 128;
    int c0 = 0;
    if (r < B) {
      uint4 v[16];
      warp_row_load<T, 16>(h + (long long)r * h_stride, d, v);
      const float rs = warp_row_rs<T, 16>(v, d, eps);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = lane + 32 * j;
        if (c * kVec < d) {
          float wf[kVec];
          load_weights<float>(w, c, wf);
          *reinterpret_cast<uint4*>(xr + (c / 8) * N * 128 +
                                    (((c % 8) ^ (r % 8)) << 4)) =
              warp_row_scale<T>(v[j], rs, wf);
        }
      }
      c0 = d / kVec;
    }
    for (int c = c0 + lane; c < n_units; c += 32)
      *reinterpret_cast<uint4*>(xr + (c / 8) * N * 128 +
                                (((c % 8) ^ (r % 8)) << 4)) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  // generic-proxy stores, read next by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();
  if (xn_out != nullptr && cta == 0) {  // the checks' copy of the rows
    for (int i = tid; i < B * nu; i += kTcConsumers)
      reinterpret_cast<uint4*>(xn_out)[i] = *unit(i / nu, i % nu);
  }

  float m_r[NQ], l_r[NQ];
  int a_r[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    m_r[q] = NEG_BIG;
    l_r[q] = 0.f;
    a_r[q] = INT_MAX;
  }
  int st = 0;          // the stage the next load lands in,
  uint32_t phase = 0;  // in this parity of its barrier
  for (int g0 = t0; g0 < t1; g0 += kTcGroup) {
    const int ng = min(kTcGroup, t1 - g0);
    float acc[kTcGroup][NR];
#pragma unroll
    for (int g = 0; g < kTcGroup; ++g)
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[g][i] = 0.f;
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(&full[st], phase);
      __syncwarp();  // the warp is converged for the .aligned wgmma ops
      const unsigned char* a = ring + st * kTcStage;
#pragma unroll
      for (int g = 0; g < kTcGroup; ++g) fence_regs(acc[g]);
      wgmma_fence();
#pragma unroll
      for (int g = 0; g < kTcGroup; ++g) {
        if (g < ng) {  // uniform across the warpgroup
#pragma unroll
          for (int kk = 0; kk < kTcRows / 16; ++kk) {
            const int k = kb * kTcRows + kk * 16;  // the step's first row
            // A: 16 head rows of 128 bytes of tile g's box (the MN-major
            // form of flash_attention.cu's V operand); B: 32 bytes of each
            // normalised row at K chunk k / 64 (its Q / K operand form)
            mma_tc<T, N>(acc[g],
                         desc_sw128(a + g * kTcBox + kk * 16 * 128, kTcBox,
                                    1024),
                         desc_sw128(xs + (k / 64) * N * 128 + (k % 64) * 2,
                                    16, 1024));
          }
        }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int g = 0; g < kTcGroup; ++g) fence_regs(acc[g]);
      mbar_arrive(&empty[st]);  // this stage is free for the producer
      if (++st == stages) {
        st = 0;
        phase ^= 1;
      }
    }
    // fold the group's logits in ascending column order
#pragma unroll
    for (int g = 0; g < kTcGroup; ++g) {
      if (g < ng) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = (g0 + g) * kTcCols + 16 * warp + lane / 4 + 8 * hh;
          if (col < V) {
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              const float x = to_f32(from_f32<T>(
                  acc[g][4 * (q / 2) + 2 * hh + (q % 2)]));
              triple_push(m_r[q], l_r[q], a_r[q], x, col);
            }
          }
        }
      }
    }
  }

  // the 8 lanes that hold the same batch rows (lane % 4 alike), then the
  // 4 warps in order
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m_r[q], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l_r[q], o);
      const int a2 = __shfl_xor_sync(0xffffffffu, a_r[q], o);
      triple_combine(m_r[q], l_r[q], a_r[q], m2, l2, a2);
    }
    if (lane < 4) {
      const int b = 8 * (q / 2) + 2 * lane + (q % 2);
      red_m[warp * N + b] = m_r[q];
      red_l[warp * N + b] = l_r[q];
      red_a[warp * N + b] = a_r[q];
    }
  }
  consumers_sync();
  if (tid < B) {
    float m = red_m[tid], l = red_l[tid];
    int a = red_a[tid];
    for (int ww = 1; ww < 4; ++ww)
      triple_combine(m, l, a, red_m[ww * N + tid], red_l[ww * N + tid],
                     red_a[ww * N + tid]);
    const long long o = (long long)tid * n_ctas + cta;
    pm[o] = m;
    pl[o] = l;
    pa[o] = a;
  }
}

template <typename T, int N>
cudaError_t launch_tc(const T* h, long long h_stride, const float* w,
                      const T* head, long long ld, int B, int d, int V,
                      const uint8_t* live, float eps, int warp_norm,
                      T* xn_out, int n_ctas, float* pm, float* pl, int* pa,
                      cudaStream_t s) {
  const int stages = tc_stages(N, d);
  if (stages < kTcMinStages) return cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  // the head as a 2-D map, dims innermost first (V, d), row stride ld;
  // boxes of 64 columns x 64 rows, 128-byte swizzle; columns past V and
  // rows past d read as zeros
  const cuuint64_t dims[2] = {(cuuint64_t)V, (cuuint64_t)d};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(T)};
  const cuuint32_t box[2] = {kTcCols, kTcRows}, step[2] = {1, 1};
  CUtensorMap map;
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  if (fn(&map, dt, 2, const_cast<T*>(head), dims, strides, box, step,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(N, d, stages);
  static size_t configured = 0;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        head_tc_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  head_tc_kernel<T, N><<<n_ctas, kTcThreads, smem, s>>>(
      map, h, h_stride, w, B, d, V, live, eps, warp_norm, stages, xn_out,
      n_ctas, pm, pl, pa);
  return cudaGetLastError();
}

ExitCarry carry_of(const void* const* carries, const void* thr, int m_idx,
                   int n_components, int patience_k, float ema_decay,
                   float ema_keep, int tel_bins) {
  return ExitCarry{
      (const uint8_t*)carries[0], (const int*)carries[1],
      (const int*)carries[2],     (const float*)carries[3],
      (const int*)carries[4],     (const float*)carries[5],
      (const uint8_t*)carries[6], (uint8_t*)carries[7],
      (int*)carries[8],           (int*)carries[9],
      (float*)carries[10],        (int*)carries[11],
      (float*)carries[12],        (int*)carries[13],
      (const float*)thr,          m_idx,
      n_components,               patience_k,
      ema_decay,                  ema_keep,
      tel_bins};
}

// the combine launch of both routes: (3, B, n_parts) partials -> carries;
// with `part` (the partial contract) the row's triple instead
int combine(int B, int n_parts, float* pm, const uint8_t* live,
            const void* const* carries, const void* thr, int m_idx,
            int n_components, int patience_k, float ema_decay,
            float ema_keep, int tel_bins, int vocab_offset, float* part,
            cudaStream_t s) {
  float* pl = pm + (long long)B * n_parts;
  int* pa = (int*)(pl + (long long)B * n_parts);
  if (part != nullptr) {
    head_parts_reduce_kernel<<<B, kThreads, 0, s>>>(pm, pl, pa, n_parts, B,
                                                    live, vocab_offset, part);
    return (int)cudaGetLastError();
  }
  if (thr == nullptr) return (int)cudaErrorInvalidValue;
  head_combine_kernel<<<B, kThreads, 0, s>>>(
      pm, pl, pa, n_parts, live,
      carry_of(carries, thr, m_idx, n_components, patience_k, ema_decay,
               ema_keep, tel_bins));
  return (int)cudaGetLastError();
}

}  // namespace

// Vocab tiles (partials per row) of the "cuda_core" route for dtype code
// `dtype` and V columns; the caller sizes the (3, B, n_tiles) f32
// workspace with it.
extern "C" int megakernel_tiles(int V, int dtype) {
  const int vt = dtype == DT_F32 ? vt_of<float>() : vt_of<__nv_bfloat16>();
  return (V + vt - 1) / vt;
}

// Dynamic shared memory one "cuda_core" block takes for a group of nb rows
// of width d.
extern "C" long long megakernel_smem_bytes(int d, int nb, int dtype) {
  const int vt = dtype == DT_F32 ? vt_of<float>() : vt_of<__nv_bfloat16>();
  return (long long)nb * (d + vt) * (long long)sizeof(float);
}

// carries: the 7 inputs (answered, pred, exit, conf, streak, ema, active),
// then the 7 outputs (the same six and the telemetry code, NULL unless
// tel_bins > 0); `thr` points at the component's δ̂, an f32 on the device.
// With `part_out` ((3, B) f32, the partial contract) the launch writes each
// row's triple over the head's columns, the argmax offset by
// `vocab_offset`, and reads neither the carries nor `thr`.
extern "C" int megakernel_launch(
    const void* h, long long h_stride, const void* w, const void* head,
    long long ld, int B, int d, int V, int dtype, int nb, const void* live,
    float eps, int warp_norm, void* workspace, const void* const* carries,
    const void* thr, int m_idx, int n_components, int patience_k,
    float ema_decay, float ema_keep, int tel_bins, int vocab_offset,
    void* part_out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = megakernel_tiles(V, dtype);
  float* pm = (float*)workspace;
  float* pl = pm + (long long)B * n_tiles;
  int* pa = (int*)(pl + (long long)B * n_tiles);
  const uint8_t* lv = (const uint8_t*)live;
  const float* wf = (const float*)w;
  cudaError_t err = cudaErrorInvalidValue;
  DISPATCH_DTYPE(dtype, T, {
    const T* ht = (const T*)h;
    const T* hd = (const T*)head;
    switch (nb) {
      case 1:
        err = launch_partial<T, 1>(ht, h_stride, wf, hd, ld, B, d, V, lv, eps,
                                   warp_norm, n_tiles, pm, pl, pa, s);
        break;
      case 2:
        err = launch_partial<T, 2>(ht, h_stride, wf, hd, ld, B, d, V, lv, eps,
                                   warp_norm, n_tiles, pm, pl, pa, s);
        break;
      case 4:
        err = launch_partial<T, 4>(ht, h_stride, wf, hd, ld, B, d, V, lv, eps,
                                   warp_norm, n_tiles, pm, pl, pa, s);
        break;
      case 8:
        err = launch_partial<T, 8>(ht, h_stride, wf, hd, ld, B, d, V, lv, eps,
                                   warp_norm, n_tiles, pm, pl, pa, s);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  if (err != cudaSuccess) return (int)err;
  return combine(B, n_tiles, pm, lv, carries, thr, m_idx, n_components,
                 patience_k, ema_decay, ema_keep, tel_bins, vocab_offset,
                 (float*)part_out, s);
}

// The ring depth of the "tc" route for B rows of width d (0 where the rows
// leave room for fewer than kTcMinStages stages: the route refuses them).
extern "C" int megakernel_tc_stages(int B, int d) {
  const int stages = tc_stages(B <= 8 ? 8 : 16, d);
  return stages < kTcMinStages ? 0 : stages;
}

// The "tc" route: the same arguments with n_ctas (persistent CTAs, the
// workspace holding (3, B, n_ctas)) in place of nb.  bf16 / fp16 only,
// B <= 16, d a multiple of 8 whose rows leave room for a ring of
// kTcMinStages (megakernel_tc_stages), warp_norm only for rows of at most
// 16 16-byte chunks a lane, the head's base and row stride and h's base
// and row stride 16-byte aligned, w 16-byte aligned; anything else is
// refused with cudaErrorInvalidValue (the wrapper picks the route before
// the launch).  xn_out: NULL, or a contiguous (B, d) array in h's dtype
// into which CTA 0 copies the normalised rows (the checks' view of the
// prologue).
extern "C" int megakernel_tc_launch(
    const void* h, long long h_stride, const void* w, const void* head,
    long long ld, int B, int d, int V, int dtype, int n_ctas,
    const void* live, float eps, int warp_norm, void* xn_out,
    void* workspace, const void* const* carries, const void* thr, int m_idx,
    int n_components, int patience_k, float ema_decay, float ema_keep,
    int tel_bins, int vocab_offset, void* part_out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (B > 16 || d <= 0 || d % 8 || megakernel_tc_stages(B, d) == 0 ||
      (warp_norm && d / 8 > 16 * 32) ||
      (!warp_norm && d / 8 > kTcMaxWChunks * kTcConsumers) || V <= 0 ||
      n_ctas <= 0 ||
      (uintptr_t)h % 16 || (B > 1 && (h_stride * 2) % 16) ||
      (uintptr_t)head % 16 ||
      (ld * 2) % 16 || (uintptr_t)w % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* pm = (float*)workspace;
  float* pl = pm + (long long)B * n_ctas;
  int* pa = (int*)(pl + (long long)B * n_ctas);
  const uint8_t* lv = (const uint8_t*)live;
  const float* wf = (const float*)w;
  cudaError_t err;
  if (dtype == DT_BF16) {
    using T = __nv_bfloat16;
    err = B <= 8 ? launch_tc<T, 8>((const T*)h, h_stride, wf, (const T*)head,
                                   ld, B, d, V, lv, eps, warp_norm,
                                   (T*)xn_out, n_ctas, pm, pl, pa, s)
                 : launch_tc<T, 16>((const T*)h, h_stride, wf,
                                    (const T*)head, ld, B, d, V, lv, eps,
                                    warp_norm, (T*)xn_out, n_ctas, pm, pl,
                                    pa, s);
  } else if (dtype == DT_F16) {
    using T = __half;
    err = B <= 8 ? launch_tc<T, 8>((const T*)h, h_stride, wf, (const T*)head,
                                   ld, B, d, V, lv, eps, warp_norm,
                                   (T*)xn_out, n_ctas, pm, pl, pa, s)
                 : launch_tc<T, 16>((const T*)h, h_stride, wf,
                                    (const T*)head, ld, B, d, V, lv, eps,
                                    warp_norm, (T*)xn_out, n_ctas, pm, pl,
                                    pa, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return combine(B, n_ctas, pm, lv, carries, thr, m_idx, n_components,
                 patience_k, ema_decay, ema_keep, tel_bins, vocab_offset,
                 (float*)part_out, s);
}

// The combine of the partial contract: `parts` is the (R, 3, B) f32 triples
// of the R vocab slices in rank order, merged rank after rank; `live` and
// the carries as megakernel_launch takes them.
extern "C" int megakernel_combine_launch(
    const void* parts, int B, int R, const void* live,
    const void* const* carries, const void* thr, int m_idx, int n_components,
    int patience_k, float ema_decay, float ema_keep, int tel_bins,
    void* stream) {
  return launch_exit_parts_combine(
      (const float*)parts, B, R, (const uint8_t*)live,
      carry_of(carries, thr, m_idx, n_components, patience_k, ema_decay,
               ema_keep, tel_bins),
      (cudaStream_t)stream);
}
