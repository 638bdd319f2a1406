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
// The reduction and the carry merge live in common.cuh, shared with the
// exit-head megakernel and the confidence kernel.
// The threshold is a runtime argument: a threshold push never rebuilds.
//
// Bound on the H100: bytes.  The logits are read once (B * V * sizeof(x));
// the outputs are O(B).  Design: one block of 1024 threads per row, each
// thread streaming a strided slice of the vocab with a running
// (max, sum-exp, first-argmax) triple, then a warp-shuffle and shared-memory
// merge of the triples.  At decode batch B = 4 this uses 4 of the 132 SMs,
// so a single SM's bandwidth bounds it; splitting the vocab across blocks
// with a second combine pass is left for later.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    exit_update_kernel(const T* __restrict__ logits, long long row_stride,
                       int V, ExitCarry carry) {
  const int b = blockIdx.x;
  const T* row = logits + (long long)b * row_stride;
  float m = NEG_BIG, l = 0.f;
  int a = INT_MAX;
  for (int j = threadIdx.x; j < V; j += kThreads)
    triple_push(m, l, a, to_f32(row[j]), j);
  block_reduce_triple<kThreads>(m, l, a);
  if (threadIdx.x == 0) exit_carry_merge(carry, b, 1.f / l, a, true);
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
  const ExitCarry carry{
      (const uint8_t*)ans_in, (const int*)pred_in, (const int*)exit_in,
      (const float*)conf_in,  (const int*)streak_in, (const float*)ema_in,
      (const uint8_t*)act_in, (uint8_t*)ans_out,   (int*)pred_out,
      (int*)exit_out,         (float*)conf_out,    (int*)streak_out,
      (float*)ema_out,        (int*)tcode_out,     threshold,
      m_idx,                  n_components,        patience_k,
      ema_decay,              ema_keep,            tel_bins};
  DISPATCH_DTYPE(dtype, T, {
    exit_update_kernel<T><<<B, kThreads, 0, s>>>((const T*)logits,
                                                 row_stride, V, carry);
  });
  return (int)cudaGetLastError();
}
