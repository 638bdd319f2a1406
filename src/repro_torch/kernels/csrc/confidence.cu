// Fused softmax confidence over the rows of a (B, V) logits tensor:
// argmax (the FIRST index of the row maximum) and delta = max softmax =
// 1 / sum(exp(x - max)), the softmax never materialised.
//
// Replaces the Pallas kernel `_conf_kernel` / `confidence` of the JAX
// package's kernels/confidence.py, which streams vocab tiles in order on
// one TPU core with a running (max, sum-exp, argmax) in scratch.
//
// Bound on the H100: bytes (one read of the logits, B * V * sizeof(x); the
// outputs are O(B)).  Design: the vocab split of the exit-head megakernel
// without its product or carry merge.  Grid (ceil(V / kTile), B): each
// block reduces one kTile-column tile of one row to a (max, sum-exp,
// first-argmax) partial; a second launch merges each row's partials
// (merge_partials in common.cuh, shared with the megakernel).  At the
// serving shape (4, 151936) that is 152 blocks instead of one per row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;  // vocab columns per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conf_partial_kernel(const T* __restrict__ x, long long row_stride, int V,
                        int n_tiles, float* __restrict__ pm,
                        float* __restrict__ pl, int* __restrict__ pa) {
  const int b = blockIdx.y, tile = blockIdx.x;
  const T* row = x + (long long)b * row_stride;
  const int j1 = min(V, (tile + 1) * kTile);
  float m = NEG_BIG, l = 0.f;
  int a = INT_MAX;
  for (int j = tile * kTile + threadIdx.x; j < j1; j += kThreads)
    triple_push(m, l, a, to_f32(row[j]), j);
  block_reduce_triple<kThreads>(m, l, a);
  if (threadIdx.x == 0) {
    const long long o = (long long)b * n_tiles + tile;
    pm[o] = m;
    pl[o] = l;
    pa[o] = a;
  }
}

__global__ void __launch_bounds__(kThreads)
    conf_combine_kernel(const float* __restrict__ pm,
                        const float* __restrict__ pl,
                        const int* __restrict__ pa, int n_tiles,
                        int* __restrict__ idx_out,
                        float* __restrict__ conf_out) {
  const int b = blockIdx.x;
  const long long o = (long long)b * n_tiles;
  float m, l;
  int a;
  merge_partials<kThreads>(pm + o, pl + o, pa + o, n_tiles, m, l, a);
  if (threadIdx.x == 0) {
    idx_out[b] = a;
    conf_out[b] = 1.f / l;
  }
}

}  // namespace

// Number of vocab tiles (partials per row) for a row of V columns; the
// caller sizes the (3, B, n_tiles) workspace with it.
extern "C" int confidence_tiles(int V) { return (V + kTile - 1) / kTile; }

extern "C" int confidence_launch(const void* logits, long long row_stride,
                                 int B, int V, int dtype, void* workspace,
                                 void* idx_out, void* conf_out,
                                 void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = confidence_tiles(V);
  float* pm = (float*)workspace;
  float* pl = pm + (long long)B * n_tiles;
  int* pa = (int*)(pl + (long long)B * n_tiles);
  DISPATCH_DTYPE(dtype, T, {
    conf_partial_kernel<T><<<dim3(n_tiles, B), kThreads, 0, s>>>(
        (const T*)logits, row_stride, V, n_tiles, pm, pl, pa);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conf_combine_kernel<<<B, kThreads, 0, s>>>(pm, pl, pa, n_tiles,
                                             (int*)idx_out,
                                             (float*)conf_out);
  return (int)cudaGetLastError();
}
