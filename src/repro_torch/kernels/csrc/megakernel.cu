// Fused exit-head megakernel: rmsnorm(h) * w, the (B, d) @ (d, V) head
// product, the softmax-max confidence and the exit-update carry merge,
// without the (B, V) logits ever reaching device memory.
//
// Replaces the Pallas kernel `_megakernel` / `exit_head_update` of the JAX
// package's kernels/megakernel.py.  Semantics pinned there:
//  * xn = (x * rsqrt(mean(x^2) + eps)) * w in f32, cast once to x's dtype
//    (the operand order of csrc/rmsnorm.cu, and its reduction: 256
//    threads, a strided sum, then block_sum of common.cuh);
//  * logits = xn @ head with f32 accumulation; for a bf16/f16 model each
//    logit is rounded to the model dtype before the f32 softmax math, as
//    the unfused route's logits are (`lowp`);
//  * vocab columns at or past V never enter the reduction (the reference
//    pads them to -1e30);
//  * argmax is the FIRST index of the row maximum; delta = 1 / sum(exp);
//  * then exit_carry_merge of common.cuh, shared with the fused exit-update
//    kernel, with dead rows (live false) passing every carry through.
// The threshold is a runtime argument: a threshold push never rebuilds.
//
// Bound on the H100: bytes.  The head is read once: d * V * sizeof(T)
// (2048 * 151936 * 2 B = 622 MB at qwen2.5-3b, ~0.19 ms at 3.35 TB/s); the
// product is 2 * B * d * V flops (2.5 GFLOP at B = 4), negligible at the
// tensor cores' rate, so the design spends nothing on them and everything
// on streaming the head.  Design: the vocab is split across blocks.  Block
// (tile, g) owns kVt = 32 * (16 / sizeof(T)) consecutive columns (256 in
// bf16: ~600 blocks at V = 151936) for the row group g of at most NB rows:
//  1. it recomputes the group's normalised rows into shared memory (f32
//     copies of the T-rounded values) -- a few KB of h per block, from L2;
//  2. warp w streams head rows [w * d / 8, (w + 1) * d / 8) of its columns
//     with 16-byte loads (one warp-wide load covers the block's kVt
//     columns of one head row, fully coalesced), kUnroll rows in flight,
//     accumulating NB x (16 / sizeof(T)) dot products per thread in f32;
//  3. the 8 warps' sums are added in warp order in shared memory, then warp
//     r reduces row r's kVt logits to a (max, sum-exp, first-argmax)
//     partial, written to a (3, B, n_tiles) workspace;
//  4. a second launch merges each row's partials (merge_partials, shared
//     with the confidence kernel) and applies the carry merge.
// A block whose rows are all dead returns before the norm and the product;
// the combine step passes dead rows through without reading partials.
// Left for later: TMA / cp.async multi-stage loads and a persistent grid.
#include "common.cuh"

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
    int n_tiles, float* __restrict__ pm, float* __restrict__ pl,
    int* __restrict__ pa) {
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

  // 1. the exit head's rmsnorm, csrc/rmsnorm.cu's arithmetic row by row
  for (int r = 0; r < nb; ++r) {
    const T* xr = h + (long long)(r0 + r) * h_stride;
    float ss = 0.f;
    for (int i = tid; i < d; i += kThreads) {
      const float v = to_f32(xr[i]);
      ss += v * v;
    }
    const float rs = rsqrtf(block_sum<kThreads>(ss, part) / (float)d + eps);
    for (int i = tid; i < d; i += kThreads)
      xn[r * d + i] = to_f32(from_f32<T>((to_f32(xr[i]) * rs) * w[i]));
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

template <typename T, int NB>
cudaError_t launch_partial(const T* h, long long h_stride, const float* w,
                           const T* head, long long ld, int B, int d, int V,
                           const uint8_t* live, float eps, int n_tiles,
                           float* pm, float* pl, int* pa, cudaStream_t s) {
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
      h, h_stride, w, head, ld, B, d, V, live, eps, lowp, vec, n_tiles, pm,
      pl, pa);
  return cudaGetLastError();
}

}  // namespace

// Vocab tiles (partials per row) for dtype code `dtype` and V columns; the
// caller sizes the (3, B, n_tiles) f32 workspace with it.
extern "C" int megakernel_tiles(int V, int dtype) {
  const int vt = dtype == DT_F32 ? vt_of<float>() : vt_of<__nv_bfloat16>();
  return (V + vt - 1) / vt;
}

// Dynamic shared memory one block takes for a group of nb rows of width d.
extern "C" long long megakernel_smem_bytes(int d, int nb, int dtype) {
  const int vt = dtype == DT_F32 ? vt_of<float>() : vt_of<__nv_bfloat16>();
  return (long long)nb * (d + vt) * (long long)sizeof(float);
}

extern "C" int megakernel_launch(
    const void* h, long long h_stride, const void* w, const void* head,
    long long ld, int B, int d, int V, int dtype, int nb, const void* live,
    float eps, void* workspace, const void* ans_in, const void* pred_in,
    const void* exit_in, const void* conf_in, const void* streak_in,
    const void* ema_in, const void* act_in, void* ans_out, void* pred_out,
    void* exit_out, void* conf_out, void* streak_out, void* ema_out,
    void* tcode_out, float threshold, int m_idx, int n_components,
    int patience_k, float ema_decay, float ema_keep, int tel_bins,
    void* stream) {
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
                                   n_tiles, pm, pl, pa, s);
        break;
      case 2:
        err = launch_partial<T, 2>(ht, h_stride, wf, hd, ld, B, d, V, lv, eps,
                                   n_tiles, pm, pl, pa, s);
        break;
      case 4:
        err = launch_partial<T, 4>(ht, h_stride, wf, hd, ld, B, d, V, lv, eps,
                                   n_tiles, pm, pl, pa, s);
        break;
      case 8:
        err = launch_partial<T, 8>(ht, h_stride, wf, hd, ld, B, d, V, lv, eps,
                                   n_tiles, pm, pl, pa, s);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
  if (err != cudaSuccess) return (int)err;
  const ExitCarry carry{
      (const uint8_t*)ans_in, (const int*)pred_in, (const int*)exit_in,
      (const float*)conf_in,  (const int*)streak_in, (const float*)ema_in,
      (const uint8_t*)act_in, (uint8_t*)ans_out,   (int*)pred_out,
      (int*)exit_out,         (float*)conf_out,    (int*)streak_out,
      (float*)ema_out,        (int*)tcode_out,     threshold,
      m_idx,                  n_components,        patience_k,
      ema_decay,              ema_keep,            tel_bins};
  head_combine_kernel<<<B, kThreads, 0, s>>>(pm, pl, pa, n_tiles, lv, carry);
  return (int)cudaGetLastError();
}
