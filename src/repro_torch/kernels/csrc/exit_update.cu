// Fused exit update: softmax-max confidence + threshold gate + patience
// rewrite + first-open-gate carry merge (+ optional EMA fold and telemetry
// code) in one pass over a (B, V) logits tensor.
//
// Replaces the Pallas kernel `_exit_update_kernel` / `exit_update` of the
// JAX package's kernels/exit_update.py.  Semantics pinned there:
//  * argmax is the FIRST index of the row maximum (ties go to the lower
//    index, across and within tiles);
//  * delta = 1 / sum(exp(x - max));
//  * the final component's gate is open BEFORE the patience rewrite;
//  * patience: streak' = gate ? streak + 1 : 0, gate = streak' >= k;
//  * merge: fresh = gate & !answered picks pred / exit / conf;
//  * EMA: ema' = d * ema + (1 - d) * conf' on active rows (no FMA, so the
//    fold rounds like the plain version);
//  * telemetry: pred * bins + clip(int(delta * bins), 0, bins - 1).
// The threshold is a runtime argument: a threshold push never rebuilds.
//
// Bound on the H100: bytes.  The logits are read once (B * V * sizeof(x));
// the outputs are O(B).  Design: one block of 1024 threads per row, each
// thread streaming a strided slice of the vocab with a running
// (max, sum-exp, first-argmax) triple, then a warp-shuffle and shared-memory
// merge of the triples.  At decode batch B = 4 this uses 4 of the 132 SMs,
// so a single SM's bandwidth bounds it; splitting the vocab across blocks
// with a second combine pass is left for later.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

// fold (m2, l2, a2) into (m, l, a): max, rescaled sum, first index of max
__device__ __forceinline__ void combine(float& m, float& l, int& a, float m2,
                                        float l2, int a2) {
  const float M = fmaxf(m, m2);
  l = l * expf(m - M) + l2 * expf(m2 - M);
  if (m2 > m || (m2 == m && a2 < a)) a = a2;
  m = M;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) exit_update_kernel(
    const T* __restrict__ logits, long long row_stride, int V,
    const uint8_t* __restrict__ ans_in, const int* __restrict__ pred_in,
    const int* __restrict__ exit_in, const float* __restrict__ conf_in,
    const int* __restrict__ streak_in, const float* __restrict__ ema_in,
    const uint8_t* __restrict__ act_in, uint8_t* __restrict__ ans_out,
    int* __restrict__ pred_out, int* __restrict__ exit_out,
    float* __restrict__ conf_out, int* __restrict__ streak_out,
    float* __restrict__ ema_out, int* __restrict__ tcode_out,
    float threshold, int m_idx, int n_components, int patience_k,
    float ema_decay, float ema_keep, int tel_bins) {
  __shared__ float sm_m[kThreads / 32];
  __shared__ float sm_l[kThreads / 32];
  __shared__ int sm_a[kThreads / 32];
  const int b = blockIdx.x;
  const T* row = logits + (long long)b * row_stride;

  float m = NEG_BIG, l = 0.f;
  int a = INT_MAX;
  for (int j = threadIdx.x; j < V; j += kThreads) {
    const float x = to_f32(row[j]);
    if (x > m) {  // strict: an equal later value keeps the earlier index
      l = l * expf(m - x) + 1.f;
      m = x;
      a = j;
    } else {
      l += expf(x - m);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const int a2 = __shfl_xor_sync(0xffffffffu, a, o);
    combine(m, l, a, m2, l2, a2);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
    sm_a[warp] = a;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  // thread 0 already holds warp 0's triple; fold in the other warps'
  for (int w = 1; w < kThreads / 32; ++w)
    combine(m, l, a, sm_m[w], sm_l[w], sm_a[w]);
  const float conf = 1.f / l;
  const int pred = a;

  const bool last = m_idx >= n_components - 1;
  bool gate = last ? true : (conf >= threshold);
  int srow = streak_in[b];
  if (patience_k > 0) {
    srow = gate ? srow + 1 : 0;
    gate = srow >= patience_k;
    if (last) gate = true;
  }
  streak_out[b] = srow;
  const bool answered = ans_in[b] != 0;
  const bool fresh = gate && !answered;
  ans_out[b] = (answered || gate) ? 1 : 0;
  pred_out[b] = fresh ? pred : pred_in[b];
  exit_out[b] = fresh ? m_idx : exit_in[b];
  const float cf = fresh ? conf : conf_in[b];
  conf_out[b] = cf;
  float e = ema_in[b];
  if (ema_decay > 0.f && act_in[b] != 0)
    e = __fadd_rn(__fmul_rn(ema_decay, e), __fmul_rn(ema_keep, cf));
  ema_out[b] = e;
  if (tel_bins > 0) {
    int bin = (int)__fmul_rn(conf, (float)tel_bins);
    bin = bin < 0 ? 0 : (bin > tel_bins - 1 ? tel_bins - 1 : bin);
    tcode_out[b] = pred * tel_bins + bin;
  }
}

}  // namespace

extern "C" int exit_update_launch(
    const void* logits, long long row_stride, int B, int V, int dtype,
    const void* ans_in, const void* pred_in, const void* exit_in,
    const void* conf_in, const void* streak_in, const void* ema_in,
    const void* act_in, void* ans_out, void* pred_out, void* exit_out,
    void* conf_out, void* streak_out, void* ema_out, void* tcode_out,
    float threshold, int m_idx, int n_components, int patience_k,
    float ema_decay, float ema_keep, int tel_bins, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(dtype, T, {
    exit_update_kernel<T><<<B, kThreads, 0, s>>>(
        (const T*)logits, row_stride, V, (const uint8_t*)ans_in,
        (const int*)pred_in, (const int*)exit_in, (const float*)conf_in,
        (const int*)streak_in, (const float*)ema_in, (const uint8_t*)act_in,
        (uint8_t*)ans_out, (int*)pred_out, (int*)exit_out, (float*)conf_out,
        (int*)streak_out, (float*)ema_out, (int*)tcode_out, threshold, m_idx,
        n_components, patience_k, ema_decay, ema_keep, tel_bins);
  });
  return (int)cudaGetLastError();
}
