// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel source exposes a plain C entry point (loaded with ctypes):
// it takes raw device pointers, element strides and a dtype code, launches
// on the caller's stream and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>

// dtype codes shared with kernels/build.py
enum DType : int { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

#define NEG_BIG (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum v over a block of kThreads threads: a warp shuffle tree, then warp 0
// over the warps' sums.  Every thread gets the total.  `part` is
// kThreads / 32 floats of shared memory, free for reuse on return.  Every
// thread of the block must call it.
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* part) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kThreads / 32 ? part[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) part[0] = s;
  }
  __syncthreads();
  const float total = part[0];
  __syncthreads();
  return total;
}

// ---------------------------------------------------------------------------
// The row norm of one warp: the arithmetic shared by rmsnorm.cu's "warp"
// route and the megakernel's prologues, so both normalise a row bit for
// bit alike.  The row's d elements are read once, 16 bytes a lane a load,
// into registers: lane l holds the 16-byte chunks c = l + 32 j, j < NV
// (zeros past the row's end; warp_row_load).  Each lane sums its
// elements' squares in load order (fmaf), a xor-shuffle tree adds the
// lanes, and rs = rsqrt(sum / d + eps) (warp_row_rs, in every lane); chunk
// j's element i becomes T((x_i * rs) * w_i), the product taken in f32 as
// the reference's operand order pins it (warp_row_scale, with chunk j's
// weights from load_weights, which a caller may issue early).  The row
// needs d % (16 / sizeof(T)) == 0 and a 16-byte aligned base.
// ---------------------------------------------------------------------------
template <typename T, int NV>
__device__ __forceinline__ void warp_row_load(const T* __restrict__ x, int d,
                                              uint4 (&v)[NV]) {
  const int lane = threadIdx.x % 32, nc = d / (16 / (int)sizeof(T));
  const uint4* xv = reinterpret_cast<const uint4*>(x);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < nc ? __ldg(xv + c) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int NV>
__device__ __forceinline__ float warp_row_rs(const uint4 (&v)[NV], int d,
                                             float eps) {
  constexpr int kVec = 16 / sizeof(T);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float f = to_f32(e[i]);
      ss = fmaf(f, f, ss);
    }
  }
  return rsqrtf(warp_sum(ss) / (float)d + eps);
}

// the N weights of chunk c as f32 (16-byte loads where they fill one)
template <typename TW, int N>
__device__ __forceinline__ void load_weights(const TW* __restrict__ w, int c,
                                             float (&f)[N]) {
  constexpr int kBytes = N * (int)sizeof(TW);
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(TW);
    const uint4* wv = reinterpret_cast<const uint4*>(w + (long long)c * N);
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q) {
      const uint4 raw = __ldg(wv + q);
      const TW* e = reinterpret_cast<const TW*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) f[q * kPer + i] = to_f32(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f32(w[(long long)c * N + i]);
  }
}

// chunk v of a row, normalised and scaled by its weights wf: 16 bytes of
// T((x_i * rs) * w_i)
template <typename T>
__device__ __forceinline__ uint4 warp_row_scale(const uint4& v, float rs,
                                                const float (&wf)[16 /
                                                                  sizeof(T)]) {
  constexpr int kVec = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&v);
  uint4 out;
  T* o = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    o[i] = from_f32<T>((to_f32(e[i]) * rs) * wf[i]);
  return out;
}

// Whether rows of element type T at `p` with the given element strides can
// be read 16 bytes at a time (aligned base, strides and row length).
template <typename T>
inline bool vec16_ok(const void* p, int row_len,
                     std::initializer_list<long long> strides) {
  constexpr int kVec = 16 / sizeof(T);
  if (((uintptr_t)p % 16) != 0 || row_len % kVec != 0) return false;
  for (long long s : strides)
    if (s % kVec != 0) return false;
  return true;
}

// Copy a tile of `rows` rows x `cols` contiguous elements (row r at
// src + r * stride) into shared memory as f32 with row pitch `pitch`; rows
// at or past `valid_rows` are zero-filled.  With `vec` every thread moves
// 16 bytes per load, so a tile takes a few independent loads per thread
// instead of one dependent 2-byte load per element.
template <typename T>
__device__ __forceinline__ void load_tile_f32(float* dst, int pitch,
                                              const T* __restrict__ src,
                                              long long stride, int rows,
                                              int valid_rows, int cols,
                                              bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int nv = cols / kVec;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < rows * nv; idx += blockDim.x) {
      const int r = idx / nv, c = (idx % nv) * kVec;
      float* out = dst + r * pitch + c;
      if (r < valid_rows) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(src + r * stride + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < kVec; ++i) out[i] = to_f32(e[i]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) out[i] = 0.f;
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int r = idx / cols, c = idx % cols;
    dst[r * pitch + c] = r < valid_rows ? to_f32(src[r * stride + c]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Streaming softmax-max reduction: a running (max m, sum l of exp(x - m),
// first index a of the max) triple.  Ties go to the lower index, so merging
// triples is order-free for the argmax; the sum's rounding follows the
// fixed merge order each kernel documents.
// ---------------------------------------------------------------------------

// push value x at index j (visited in ascending j): strict > keeps the
// earlier index of an equal later value
__device__ __forceinline__ void triple_push(float& m, float& l, int& a,
                                            float x, int j) {
  if (x > m) {
    l = l * expf(m - x) + 1.f;
    m = x;
    a = j;
  } else {
    l += expf(x - m);
  }
}

// fold (m2, l2, a2) into (m, l, a): max, rescaled sum, first index of max
__device__ __forceinline__ void triple_combine(float& m, float& l, int& a,
                                               float m2, float l2, int a2) {
  const float M = fmaxf(m, m2);
  l = l * expf(m - M) + l2 * expf(m2 - M);
  if (m2 > m || (m2 == m && a2 < a)) a = a2;
  m = M;
}

// Reduce the triples of a warp (shuffle tree); every lane ends with the
// warp's triple.
__device__ __forceinline__ void warp_reduce_triple(float& m, float& l,
                                                   int& a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const int a2 = __shfl_xor_sync(0xffffffffu, a, o);
    triple_combine(m, l, a, m2, l2, a2);
  }
}

// Reduce every thread's triple of a block of kThreads threads: a warp
// shuffle tree, then thread 0 folds the warps in order.  The result is
// valid in thread 0 only.  Every thread of the block must call it.
template <int kThreads>
__device__ __forceinline__ void block_reduce_triple(float& m, float& l,
                                                    int& a) {
  __shared__ float sm_m[kThreads / 32];
  __shared__ float sm_l[kThreads / 32];
  __shared__ int sm_a[kThreads / 32];
  warp_reduce_triple(m, l, a);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
    sm_a[warp] = a;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kThreads / 32; ++w)
      triple_combine(m, l, a, sm_m[w], sm_l[w], sm_a[w]);
}

// The combine step of a vocab split: merge one row's n per-tile partial
// triples (pm/pl/pa, tile t at index t) into thread 0's (m, l, a).  Thread
// i merges tiles i, i + kThreads, ... in ascending order, then the block
// tree above: a fixed order, so a run repeats its bits.
template <int kThreads>
__device__ __forceinline__ void merge_partials(const float* __restrict__ pm,
                                               const float* __restrict__ pl,
                                               const int* __restrict__ pa,
                                               int n, float& m, float& l,
                                               int& a) {
  m = NEG_BIG;
  l = 0.f;
  a = INT_MAX;
  for (int t = threadIdx.x; t < n; t += kThreads)
    triple_combine(m, l, a, pm[t], pl[t], pa[t]);
  block_reduce_triple<kThreads>(m, l, a);
}

// ---------------------------------------------------------------------------
// The exit-update carry merge: one component step of the decision scan for
// row b, given its confidence and prediction.  Shared by the fused
// exit-update kernel and the exit-head megakernel.  Semantics (pinned by
// the JAX package's kernels/exit_update.py and kernels/megakernel.py):
//  * the final component's gate is open BEFORE the patience rewrite;
//  * patience: streak' = gate ? streak + 1 : 0, gate = streak' >= k;
//  * merge: fresh = gate & !answered picks pred / exit / conf;
//  * EMA: ema' = d * ema + (1 - d) * conf' on active rows (no FMA, so the
//    fold rounds like the plain version);
//  * telemetry: pred * bins + clip(int(conf * bins), 0, bins - 1);
//  * a dead row (live false) passes every carry through unchanged and gets
//    telemetry code 0 (the megakernel's contract).
// ---------------------------------------------------------------------------
struct ExitCarry {
  const uint8_t* ans_in;
  const int* pred_in;
  const int* exit_in;
  const float* conf_in;
  const int* streak_in;
  const float* ema_in;
  const uint8_t* act_in;
  uint8_t* ans_out;
  int* pred_out;
  int* exit_out;
  float* conf_out;
  int* streak_out;
  float* ema_out;
  int* tcode_out;    // nullptr unless tel_bins > 0
  const float* thr;  // δ̂, an f32 in device memory (read when the gate
                     // needs it, so a graph replays at its current value)
  int m_idx;
  int n_components;
  int patience_k;
  float ema_decay;
  float ema_keep;  // 1 - ema_decay, computed on the host as the plain
                   // version computes it
  int tel_bins;
};

__device__ __forceinline__ void exit_carry_merge(const ExitCarry& c, int b,
                                                 float conf, int pred,
                                                 bool live) {
  if (!live) {
    c.ans_out[b] = c.ans_in[b];
    c.pred_out[b] = c.pred_in[b];
    c.exit_out[b] = c.exit_in[b];
    c.conf_out[b] = c.conf_in[b];
    c.streak_out[b] = c.streak_in[b];
    c.ema_out[b] = c.ema_in[b];
    if (c.tel_bins > 0) c.tcode_out[b] = 0;
    return;
  }
  const bool last = c.m_idx >= c.n_components - 1;
  bool gate = last ? true : (conf >= *c.thr);
  int srow = c.streak_in[b];
  if (c.patience_k > 0) {
    srow = gate ? srow + 1 : 0;
    gate = srow >= c.patience_k;
    if (last) gate = true;
  }
  c.streak_out[b] = srow;
  const bool answered = c.ans_in[b] != 0;
  const bool fresh = gate && !answered;
  c.ans_out[b] = (answered || gate) ? 1 : 0;
  c.pred_out[b] = fresh ? pred : c.pred_in[b];
  c.exit_out[b] = fresh ? c.m_idx : c.exit_in[b];
  const float cf = fresh ? conf : c.conf_in[b];
  c.conf_out[b] = cf;
  float e = c.ema_in[b];
  if (c.ema_decay > 0.f && c.act_in[b] != 0)
    e = __fadd_rn(__fmul_rn(c.ema_decay, e), __fmul_rn(c.ema_keep, cf));
  c.ema_out[b] = e;
  if (c.tel_bins > 0) {
    int bin = (int)__fmul_rn(conf, (float)c.tel_bins);
    bin = bin < 0 ? 0 : (bin > c.tel_bins - 1 ? c.tel_bins - 1 : bin);
    c.tcode_out[b] = pred * c.tel_bins + bin;
  }
}

// Run `body` with T bound to the C++ type of dtype code `code`; an unknown
// code returns cudaErrorInvalidValue from the enclosing entry point.
#define DISPATCH_DTYPE(code, T, ...)          \
  switch (code) {                             \
    case DT_F32: {                            \
      using T = float;                        \
      __VA_ARGS__;                            \
      break;                                  \
    }                                         \
    case DT_BF16: {                           \
      using T = __nv_bfloat16;                \
      __VA_ARGS__;                            \
      break;                                  \
    }                                         \
    case DT_F16: {                            \
      using T = __half;                       \
      __VA_ARGS__;                            \
      break;                                  \
    }                                         \
    default:                                  \
      return (int)cudaErrorInvalidValue;      \
  }
