// RMSNorm over the rows of an (R, d) tensor: two routes, picked by the
// wrapper (kernels/rmsnorm.py:route) on the shape, dtypes and alignment
// before the launch.
//
// Replaces the Pallas kernel `_rmsnorm_kernel` / `rmsnorm` of the JAX
// package's kernels/rmsnorm.py.  Per row: the mean square in f32,
// y = (x * rsqrt(var + eps)) * w, all in f32, then one cast to x's dtype
// (the multiply by w happens before the cast, as the TPU kernel does it).
//
// Bound on the H100: bytes.  It reads each row once and writes it once
// (2 * R * d * sizeof(x) + d * sizeof(w)) and does ~4 flops per element,
// far below the ~295 flop/byte ridge.  At decode (R = 4) the work is
// smaller than a launch: what counts there is how few dependent memory
// round trips and barriers stand between the launch and the last store.
//
// Route "warp" (`rmsnorm_warp_kernel`; rows of at most 16 16-byte chunks
// a lane — d <= 4096 in bf16 / fp16, <= 2048 in f32 — with d a multiple of
// 16 bytes, 16-byte aligned x, out and w, w in f32 or x's dtype): a warp
// owns a row and a block holds 4 rows (256 blocks at R = 1024, one at
// R = 4).  The row is read once, 16 bytes a lane a load, into registers;
// the lane's sum of squares in load order, a xor-shuffle tree for the row
// (no shared memory, no __syncthreads), then 16-byte stores.  The
// arithmetic is common.cuh's warp_row_load / warp_row_scale, which the
// exit-head megakernel's prologue calls too, so the fused head and the
// unfused route normalise a row bit for bit alike.
//
// Route "block" (`rmsnorm_kernel`; every other shape — d 7168 in bf16,
// 896 16-byte chunks, is past the warp route): a block of 256 threads
// takes `rows_per_block` consecutive rows (the tile registry's
// `rmsnorm.rows`, kernels/autotune.py; 1 by default), one after another;
// per row a strided sum and block_sum of common.cuh, the row read a second
// time (from L1/L2) for the scale.  The rows a block only schedules rows,
// so every value gives the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 4;  // route "warp": one warp a row

template <typename T, typename TW>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                   T* __restrict__ out, long long rows, int d, float eps,
                   int rows_per_block) {
  __shared__ float partial[kThreads / 32];
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 =
      r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * d;
    T* orow = out + row * d;
    float ss = 0.f;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float v = to_f32(xr[i]);
      ss += v * v;
    }
    // block_sum ends in a barrier, so `partial` is free for the next row
    const float r =
        rsqrtf(block_sum<kThreads>(ss, partial) / (float)d + eps);
    for (int i = threadIdx.x; i < d; i += kThreads)
      orow[i] = from_f32<T>((to_f32(xr[i]) * r) * to_f32(w[i]));
  }
}

template <typename T, typename TW, int NV>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    rmsnorm_warp_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                        T* __restrict__ out, long long rows, int d,
                        float eps) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp: no shuffle is left waiting
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x % 32, nc = d / kVec;
  // the row and its weights are loaded together: one memory round trip
  // before the sum, none after it
  uint4 v[NV];
  warp_row_load<T, NV>(x + row * d, d, v);
  float wf[NV][kVec];
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (lane + 32 * j < nc) load_weights<TW>(w, lane + 32 * j, wf[j]);
  const float rs = warp_row_rs<T, NV>(v, d, eps);
  uint4* o = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + 32 * j;
    if (c < nc) o[c] = warp_row_scale<T>(v[j], rs, wf[j]);
  }
}

template <typename T, typename TW>
int launch_warp(const void* x, const void* w, void* out, long long rows,
                int d, float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_lane = (d / kVec + 31) / 32;
  const unsigned grid =
      (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(32 * kRowsPerBlock);
  const T* xt = (const T*)x;
  const TW* wt = (const TW*)w;
  T* ot = (T*)out;
#define RMSNORM_WARP(NV)                                          \
  rmsnorm_warp_kernel<T, TW, NV><<<grid, block, 0, s>>>(xt, wt, ot, rows, \
                                                        d, eps)
  if (per_lane <= 1)
    RMSNORM_WARP(1);
  else if (per_lane <= 2)
    RMSNORM_WARP(2);
  else if (per_lane <= 4)
    RMSNORM_WARP(4);
  else if (per_lane <= 8)
    RMSNORM_WARP(8);
  else
    RMSNORM_WARP(16);
#undef RMSNORM_WARP
  return (int)cudaGetLastError();
}

}  // namespace

// The "block" route; `rows_per_block` rows a block (>= 1).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              long long rows, int d, float eps, int x_dtype,
                              int w_dtype, int rows_per_block, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (rows_per_block < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid =
      (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  DISPATCH_DTYPE(x_dtype, T, DISPATCH_DTYPE(w_dtype, TW, {
    rmsnorm_kernel<T, TW><<<grid, kThreads, 0, s>>>(
        (const T*)x, (const TW*)w, (T*)out, rows, d, eps, rows_per_block);
  }));
  return (int)cudaGetLastError();
}

// The "warp" route, same arguments; w in f32 or x's dtype.  A shape or an
// alignment the route does not take is refused with cudaErrorInvalidValue
// (the wrapper picks the route before the launch).
extern "C" int rmsnorm_warp_launch(const void* x, const void* w, void* out,
                                   long long rows, int d, float eps,
                                   int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (w_dtype != DT_F32 && w_dtype != x_dtype)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || (uintptr_t)w % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_DTYPE(x_dtype, T, {
    constexpr int kVec = 16 / sizeof(T);
    if (d <= 0 || d % kVec != 0 || d / kVec > 16 * 32)
      return (int)cudaErrorInvalidValue;
    if (w_dtype == DT_F32)
      return launch_warp<T, float>(x, w, out, rows, d, eps, s);
    return launch_warp<T, T>(x, w, out, rows, d, eps, s);
  });
  return (int)cudaErrorInvalidValue;
}
