// RMSNorm over the rows of an (R, d) tensor.
//
// Replaces the Pallas kernel `_rmsnorm_kernel` / `rmsnorm` of the JAX
// package's kernels/rmsnorm.py.  Per row: the mean square in f32,
// y = (x * rsqrt(var + eps)) * w, all in f32, then one cast to x's dtype
// (the multiply by w happens before the cast, as the TPU kernel does it).
//
// Bound on the H100: bytes.  It reads each row once and writes it once
// (2 * R * d * sizeof(x) + d * sizeof(w)) and does ~4 flops per element,
// far below the ~295 flop/byte ridge.  Design: one block of 256 threads per
// row; the row is read twice (once for the sum of squares, once for the
// scale) but the second read hits L1/L2 for d = 2048 (4 KB of bf16).  Left
// for later: vectorised 16-byte loads and several rows per block, which
// matter at decode (R = 4), where the launch itself dominates.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                   T* __restrict__ out, int d, float eps) {
  __shared__ float partial[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  const float r = rsqrtf(block_sum<kThreads>(ss, partial) / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    orow[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(w[i]));
}

}  // namespace

extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              long long rows, int d, float eps, int x_dtype,
                              int w_dtype, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(x_dtype, T, DISPATCH_DTYPE(w_dtype, TW, {
    rmsnorm_kernel<T, TW><<<(unsigned)rows, kThreads, 0, s>>>(
        (const T*)x, (const TW*)w, (T*)out, d, eps);
  }));
  return (int)cudaGetLastError();
}
