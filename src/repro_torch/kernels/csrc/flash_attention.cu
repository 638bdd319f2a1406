// Causal (+ sliding-window) flash attention, forward only, with GQA: two
// routes, picked by the wrapper on the dtype and the views' alignment
// before any launch.
//
// Replaces the Pallas kernel `_flash_kernel` / `flash_attention` of the
// JAX package's kernels/flash_attention.py.  Query head h reads KV head
// h / qpk; scores are (q . k) * (1 / sqrt(hd)) in f32; key j is visible to
// query i iff (!causal || j <= i) && (window == 0 || j > i - window);
// masked scores are -1e30; the softmax is the f32 online one; the result is
// acc / max(l, 1e-30).  Key tiles wholly outside the causal/window band of
// a query tile are skipped, as the TPU kernel skips them.
//
// Bound on the H100: operations at long S, bytes at the serving path's
// S = 128 / 256 (the visible pairs' 4 * hd flops against one read of q, k,
// v and one write of the output).
//
// Route "wgmma" (`flash_attention_wgmma_kernel`; causal attention at
// hd = 128, the model's, over bf16 and fp16 views that TMA can address:
// 16-byte aligned bases, strides in multiples of 16 bytes).  One block per (64-row query tile, query head, batch row): a
// consumer warpgroup (128 threads) and one producer warp.  The tile shape
// is kept for the grid: at the serving path's S = 128 a 64-row tile of one
// head gives 2 x 16 x 4 = 128 blocks on 132 SMs, where 128-row tiles would
// give 64 (and at S = 256, 256 blocks at two per SM).  Heads of one GQA
// group read the same K/V tiles, which stay in the 50 MB L2 between them.
// The producer's lane 0 loads the Q tile once and then the K and V tiles
// of 64 keys by TMA (4-D tensor maps encoded on the host from the views'
// own (b, s, h) strides over the model layout, 64 x 64-element boxes with
// the 128-byte swizzle, one box per 64 columns of hd) into a ring of three
// stages, each with a K-full, a V-full and an empty mbarrier: at S = 256
// the fourth key tile of the last query tile loads while the first ones
// are computed, and two blocks (2 x 112 KB) still fit an SM.  The
// consumers compute S = Q K^T by wgmma (m64n64k16, both operands from
// shared memory, f32 accumulate), run the online softmax in registers on
// the accumulator layout (a row's max and sum across the quad of lanes
// that holds it), round P to the input type in registers, whose layout is
// then the A-fragment layout of the second product, and accumulate
// O += P V by wgmma with A from registers and V as an N-major (transposed)
// shared-memory operand.  Only the key tiles on the diagonal or the window
// edge are masked.  The epilogue stores acc / max(l, 1e-30) in the model
// layout.  Numerics: the softmax runs in the base-2 domain (scores
// scaled by log2(e), exp2f: about 2 ulp of f32 against expf); P is rounded
// to bf16 (fp16) before the second product, where the plain version keeps
// it in f32 — the choices of FlashAttention-2/3.  With random
// unit-variance inputs at the serving shapes the outputs stay within one
// bf16 ulp of the f32 plain version (tests/test_torch_attention_redesign.py
// pins the emulated arithmetic against the JAX kernel within
// chip_smoke.py's bf16 tolerance).  The barrier, TMA and wgmma helpers
// live in hopper.cuh, shared with the megakernel's "tc" route; there
// cuTensorMapEncodeTiled, a libcuda function, is looked up through the
// CUDA runtime's entry-point query, so no library links libcuda.
//
// Route "cuda_core" (`flash_attention_kernel`; f32, which needs IEEE f32
// and not the tensor cores' TF32, 16-bit views TMA cannot address, and
// hd = 64 or non-causal attention in any type): one block of 256 threads per (64-row query tile, query head, batch
// row); K and V tiles of 64 keys stream through one shared buffer,
// expanded to f32 (16-byte loads where the views allow), with padded rows
// so the 16x16 thread grid reads shared memory without bank conflicts;
// each thread owns a 4x4 block of scores and a 4 x (hd/16) block of the
// output, all in f32 on the CUDA cores.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kTq = 64, kTk = 64, kThreads = 256;

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)kTq * (HD + 1) + (size_t)kTk * (HD + 1) +
         (size_t)kTq * (kTk + 1) + 3 * kTq;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int S, int qpk, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float scale,
    bool vec) {
  constexpr int QS = HD + 1, KS = HD + 1, SS = kTk + 1, ND = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;               // kTq x QS
  float* kv_s = q_s + kTq * QS;    // kTk x KS (K, then V, of one tile)
  float* s_s = kv_s + kTk * KS;    // kTq x SS (scores, then probabilities)
  float* m_s = s_s + kTq * SS;     // running max per row
  float* l_s = m_s + kTq;          // running sum per row
  float* c_s = l_s + kTq;          // this tile's rescale factor per row

  const int q0 = blockIdx.x * kTq, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / qpk;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  load_tile_f32(q_s, QS, qb + q0 * q_ss, q_ss, kTq, kTq, HD, vec);
  if (tid < kTq) {
    m_s[tid] = NEG_BIG;
    l_s[tid] = 0.f;
  }
  float acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;

  const int n_kt = causal ? (q0 + kTq - 1) / kTk + 1 : S / kTk;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTk;
    // whole-tile skip: no key of this tile is inside any row's window
    if (window && !(k0 + kTk - 1 > q0 - window)) continue;
    __syncthreads();  // previous tile's readers of kv_s / s_s are done
    load_tile_f32(kv_s, KS, kb + k0 * k_ss, k_ss, kTk, kTk, HD, vec);
    __syncthreads();

    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        bool ok = true;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        s_s[r * SS + c] = ok ? sacc[i][j] * scale : NEG_BIG;
      }
    }
    __syncthreads();  // scores written, K no longer read

    load_tile_f32(kv_s, KS, vb + k0 * v_ss, v_ss, kTk, kTk, HD, vec);
    // online softmax: warp w owns rows 8w .. 8w+7, two columns per lane
    for (int rr = 0; rr < kTq / 8; ++rr) {
      const int r = warp * (kTq / 8) + rr;
      const float a0 = s_s[r * SS + lane], a1 = s_s[r * SS + lane + 32];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a0, a1)));
      const float p0 = expf(a0 - m_new), p1 = expf(a1 - m_new);
      const float psum = warp_sum(p0 + p1);
      s_s[r * SS + lane] = p0;
      s_s[r * SS + lane + 32] = p1;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();  // V tile and probabilities ready

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < kTk; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_s[(ty + 16 * i) * SS + c];
      const float* vr = kv_s + c * KS + tx;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const float vv = vr[16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }
  __syncthreads();
  T* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      ob[(q0 + r) * o_ss + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int qpk, const long long* st, int causal,
           int window, float scale, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats<HD>();
  const bool vec = vec16_ok<T>(q, HD, {st[0], st[1], st[2]}) &&
                   vec16_ok<T>(k, HD, {st[3], st[4], st[5]}) &&
                   vec16_ok<T>(v, HD, {st[6], st[7], st[8]});
  cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid(S / kTq, H, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, qpk, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      causal, window, scale, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// route "wgmma": TMA-fed tensor-core kernel for bf16 / fp16
// ---------------------------------------------------------------------------

constexpr int kWgM = 64;            // query rows per block (one warpgroup)
constexpr int kWgN = 64;            // keys per K/V tile
constexpr int kStages = 3;          // K/V ring depth
constexpr int kConsumers = 128;     // the consumer warpgroup
constexpr int kWgThreads = kConsumers + 32;  // + the producer warp
constexpr int kSub = 64 * 128;      // bytes of one 64-row x 128-byte box

#define WG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define WG_OUT32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), A and B K-major in shared
// memory; accumulate = 0 overwrites d
template <typename T>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_OUT32(d)
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_OUT32(d)
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// d (64 x 64, f32) += A (64 x 16, registers) B (16 x 64), B N-major
// (transposed) in shared memory
template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_OUT32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_OUT32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// two f32 as one 32-bit pair of T, lo in the low half (round to nearest)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// Accumulator layout of m64nNk16 (f32): thread t of the warpgroup, warp
// w = t / 32, lane l, holds for each 8-column group g the elements
// d[4g + 2h + e] at row 16w + l/4 + 8h, column 8g + 2(l%4) + e.  For 16
// columns (2 groups) that is exactly the A-fragment layout of m64k16 with
// A in registers (a_j = pair d[8k + 2j], d[8k + 2j + 1] for keys
// 16k .. 16k + 15), so P passes from the first product to the second
// without leaving the registers.
template <typename T, int HD>
__global__ void __launch_bounds__(kWgThreads, 2) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out, int S,
    int qpk, long long o_sb, long long o_ss, long long o_sh, int window,
    float scale) {
  constexpr int NC = HD / 64;  // 128-byte boxes per row of hd
  // the 128-byte swizzle repeats every 1024 bytes: every box starts on a
  // 1024-byte boundary (the kernel has no static shared memory, so the
  // dynamic block starts the block's window)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_u32(smem_raw) & 1023) __trap();
  unsigned char* q_s = smem_raw;                    // NC boxes
  unsigned char* k_s = q_s + NC * kSub;             // [stage][NC] boxes
  unsigned char* v_s = k_s + kStages * NC * kSub;   // [stage][NC] boxes
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * NC * kSub);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  // the query tiles with the most key tiles start first
  const int qt = S / kWgM - 1 - (int)blockIdx.x;
  const int q0 = qt * kWgM, h = blockIdx.y, b = blockIdx.z, kvh = h / qpk;
  // key tiles holding a visible key for some row q0 .. q0 + 63
  int kt_lo = 0;
  if (window && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / kWgN;
  const int kt_hi = (q0 + kWgM - 1) / kWgN + 1;

  const int tid = threadIdx.x;
  if (tid == kConsumers) {  // fetch the maps while the barriers are set up
    prefetch_map(&tm_q);
    prefetch_map(&tm_k);
    prefetch_map(&tm_v);
  }
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: lane 0 issues every load
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, NC * kSub);
      for (int c = 0; c < NC; ++c)
        tma_load(q_s + c * kSub, &tm_q, q_full, 64 * c, q0, h, b);
      for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
        const int st = i % kStages, round = i / kStages;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        mbar_expect_tx(&k_full[st], NC * kSub);
        for (int c = 0; c < NC; ++c)
          tma_load(k_s + (st * NC + c) * kSub, &tm_k, &k_full[st], 64 * c,
                   kt * kWgN, kvh, b);
        mbar_expect_tx(&v_full[st], NC * kSub);
        for (int c = 0; c < NC; ++c)
          tma_load(v_s + (st * NC + c) * kSub, &tm_v, &v_full[st], 64 * c,
                   kt * kWgN, kvh, b);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int rr = 16 * warp + lane / 4;  // this thread's rows rr, rr + 8
  const int cc = 2 * (lane % 4);        // its column in each 8-column group
  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m_r[2] = {NEG_BIG, NEG_BIG}, l_r[2] = {0.f, 0.f};
  // exp(x * scale - m) == exp2(x * scale * log2(e) - m'): one MUFU.EX2 per
  // probability; the row max and sum are taken in that domain
  const float scale_log2 = scale * 1.4426950408889634f;

  mbar_wait(q_full, 0);
  __syncwarp();
  for (int kt = kt_lo, i = 0; kt < kt_hi; ++kt, ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = kt * kWgN;
    const unsigned char* kst = k_s + st * NC * kSub;
    const unsigned char* vst = v_s + st * NC * kSub;

    // S = Q K^T over hd in steps of 16 (32 bytes inside a 128-byte row).
    // Issuing the next tile's product before this tile's softmax would
    // overlap the two, but its 32 more live registers make ptxas spill and
    // serialize the wgmma ops at two blocks an SM: slower on the H100.
    float s[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    mbar_wait(&k_full[st], parity);
    __syncwarp();  // the warp is converged for the .aligned wgmma ops
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const int c = ks / 4, off = (ks % 4) * 32;
      mma_ss<T>(s, desc_sw128(q_s + c * kSub + off, 16, 1024),
                desc_sw128(kst + c * kSub + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // scale into the base-2 domain, mask the diagonal / window-edge
    // tiles, online softmax
    const bool whole = k0 + kWgN - 1 <= q0 &&
                       (!window || k0 > q0 + kWgM - 1 - window);
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int hf = (j >> 1) & 1;
      float x = s[j] * scale_log2;
      if (!whole) {
        const int qpos = q0 + rr + 8 * hf;
        const int kpos = k0 + 8 * (j >> 2) + cc + (j & 1);
        const bool ok = kpos <= qpos &&
                        (!window || kpos > qpos - window);
        x = ok ? x : NEG_BIG;
      }
      s[j] = x;
      mx[hf] = fmaxf(mx[hf], x);
    }
    float corr[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m_r[hf], mx[hf]);
      corr[hf] = exp2f(m_r[hf] - m_new);
      m_r[hf] = m_new;
      l_r[hf] *= corr[hf];  // a per-thread part of the row sum
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int hf = (j >> 1) & 1;
      const float p = exp2f(s[j] - m_r[hf]);
      s[j] = p;
      l_r[hf] += p;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[c][j] *= corr[(j >> 1) & 1];
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack2<T>(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    // O += P V: per 64 columns of hd, 4 steps of 16 keys (2048 bytes of V)
    mbar_wait(&v_full[st], parity);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<T>(o[c], pa[kk],
                  desc_sw128(vst + c * kSub + kk * 16 * 128, kSub, 1024));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(o[c]);
    mbar_arrive(&empty[st]);  // this stage's K and V are free
  }

  T* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_r[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    T* orow = ob + (long long)(q0 + rr + 8 * hf) * o_ss;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int j = 4 * g + 2 * hf;
        *reinterpret_cast<uint32_t*>(orow + 64 * c + 8 * g + cc) =
            pack2<T>(o[c][j] / denom, o[c][j + 1] / denom);
      }
  }
}

// Whether TMA can address a view of 16-bit elements: a 16-byte aligned
// base and strides of 16-byte multiples on every dim longer than 1.
bool tma_ok(const void* p, const long long* st, const long long* n) {
  if ((uintptr_t)p % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && (st[i] * 2) % 16 != 0) return false;
  return true;
}

// A 4-D map over a view of (B, S, heads, hd) elements, dims innermost
// first (hd, S, heads, B) with element strides st = (s, h, b), boxes of
// 64 x 64 x 1 x 1 elements with the 128-byte swizzle.  A dim of length 1
// is never stepped: it gets the packed stride.
bool encode_map(EncodeTiledFn fn, CUtensorMap* map, CUtensorMapDataType dt,
                const void* p, int hd, int S, int heads, int B,
                const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  cuuint64_t strides[3];
  long long packed = hd;
  for (int i = 0; i < 3; ++i) {
    strides[i] = (cuuint64_t)(2 * (dims[i + 1] == 1 ? packed : st[i]));
    packed *= (long long)dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 64, 1, 1}, step[4] = {1, 1, 1, 1};
  return fn(map, dt, 4, const_cast<void*>(p), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int H, int KV, const long long* st,
                 int window, float scale, cudaStream_t s) {
  // st holds (b, s, h) per tensor; the maps take (s, h, b)
  const long long sq[3] = {st[1], st[2], st[0]}, sk[3] = {st[4], st[5], st[3]},
                  sv[3] = {st[7], st[8], st[6]};
  const long long nq[3] = {S, H, B}, nk[3] = {S, KV, B};
  if (!tma_ok(q, sq, nq) || !tma_ok(k, sk, nk) || !tma_ok(v, sv, nk))
    return (int)cudaErrorInvalidValue;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap mq, mk, mv;
  if (!encode_map(fn, &mq, dt, q, HD, S, H, B, sq) ||
      !encode_map(fn, &mk, dt, k, HD, S, KV, B, sk) ||
      !encode_map(fn, &mv, dt, v, HD, S, KV, B, sv))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(1 + 2 * kStages) * (HD / 64) * kSub +
                      sizeof(uint64_t) * (1 + 3 * kStages);
  cudaFuncSetAttribute(flash_attention_wgmma_kernel<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid(S / kWgM, H, B);
  flash_attention_wgmma_kernel<T, HD><<<grid, kWgThreads, smem, s>>>(
      mq, mk, mv, (T*)out, S, H / KV, st[9], st[10], st[11], window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (b, s, h) for q, k, v and out in turn
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int hd,
                                      const long long* strides, int causal,
                                      int window, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  if (S % kTq != 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const int qpk = H / KV;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T, {
    switch (hd) {
      case 64:
        return launch<T, 64>(q, k, v, out, B, S, H, qpk, strides, causal,
                             window, scale, s);
      case 128:
        return launch<T, 128>(q, k, v, out, B, S, H, qpk, strides, causal,
                              window, scale, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaErrorInvalidValue;
}

// The "wgmma" route, same arguments; causal attention at hd = 128 over
// bf16 / fp16 views TMA can address only, the cases checked on the card
// (anything else is refused with cudaErrorInvalidValue — the wrapper
// picks the route before the launch).
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int KV, int hd, const long long* strides, int causal, int window,
    float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaSuccess;
  if (S % kWgM != 0 || KV <= 0 || H % KV != 0 || hd != 128 || !causal)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_BF16:
      return launch_wgmma<__nv_bfloat16, 128>(q, k, v, out, B, S, H, KV,
                                              strides, window, scale, s);
    case DT_F16:
      return launch_wgmma<__half, 128>(q, k, v, out, B, S, H, KV, strides,
                                       window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
