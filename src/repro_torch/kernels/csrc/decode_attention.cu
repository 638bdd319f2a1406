// Single-query (decode) attention over a ring KV cache, with GQA, ring /
// causal / sliding-window masking by absolute slot position and per-slot
// exit masking.
//
// Replaces the Pallas kernel `_decode_kernel` / `decode_attention` of the
// JAX package's kernels/decode_attention.py.  Per slot b and KV head h the
// qpk query heads h*qpk .. h*qpk+qpk-1 attend over the W cache slots; slot
// w is visible iff kpos >= 0 && kpos <= t && (window == 0 ||
// kpos > t - window), with kpos the lane-wide (W,) ring or a per-slot
// (B, W) row.  Scores are (q . k) * (1 / sqrt(hd)) in f32, masked scores
// are -1e30, the softmax is the f32 online one, and the result is
// acc / max(l, 1e-30).  A slot whose live flag is 0 writes a zero row and
// does no other work.
//
// Bound on the H100: bytes.  Each live slot reads its K and V cache rows
// once (2 * W * KV * hd * sizeof(T) per slot) for 4 * qpk * hd flops per
// key, about 8 flop/byte in bf16, far below the ridge.  Design: one block
// per (slot, KV head), one warp per query row (qpk warps), streaming the
// cache in tiles of 32 keys through shared memory (lane j scores key j of
// the tile), filled with 16-byte loads; the cache is read in the model's
// (B, W, KV, hd) layout through strides, so no transposed copy is made.
// At B = 4, KV = 2 this is 8 blocks on 132 SMs: splitting W across blocks
// (flash-decoding) with a combine pass and cp.async prefetch are left for
// later.
#include "common.cuh"

namespace {

constexpr int kTile = 32;  // keys per tile == warp size
constexpr int kMaxDPerLane = 8;  // hd <= 256

template <typename T>
__global__ void decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kpos, const uint8_t* __restrict__ live,
    T* __restrict__ out, int W, int qpk, int hd, long long q_sb,
    long long q_sh, long long k_sb, long long k_sw, long long k_sh,
    long long v_sb, long long v_sw, long long v_sh, long long o_sb,
    long long o_sh, long long kpos_sb, int t, int window, float scale,
    bool vec) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int nthreads = blockDim.x;
  const int r = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nd = hd / 32;
  T* orow = out + b * o_sb + (long long)(h * qpk + r) * o_sh;

  if (live != nullptr && live[b] == 0) {  // exit mask: zero row, no work
    for (int i = 0; i < nd; ++i) orow[lane + 32 * i] = from_f32<T>(0.f);
    return;
  }

  const int ks = hd + 1;  // padded row: lane j reads row j conflict-free
  float* q_s = smem;                 // qpk * hd
  float* k_s = q_s + qpk * hd;       // kTile * (hd + 1)
  float* v_s = k_s + kTile * ks;     // kTile * hd
  float* p_s = v_s + kTile * hd;     // qpk * kTile

  for (int idx = threadIdx.x; idx < qpk * hd; idx += nthreads) {
    const int rr = idx / hd, d = idx % hd;
    q_s[idx] = to_f32(q[b * q_sb + (long long)(h * qpk + rr) * q_sh + d]);
  }

  float m_run = NEG_BIG, l_run = 0.f;
  float acc[kMaxDPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) acc[i] = 0.f;

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const int* kp = kpos + b * kpos_sb;
  for (int w0 = 0; w0 < W; w0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    // keys past W load as zero rows and are masked below
    const int valid = W - w0 < kTile ? W - w0 : kTile;
    load_tile_f32(k_s, ks, kb + w0 * k_sw, k_sw, kTile, valid, hd, vec);
    load_tile_f32(v_s, hd, vb + w0 * v_sw, v_sw, kTile, valid, hd, vec);
    __syncthreads();

    const int w = w0 + lane;
    bool vis = false;
    if (w < W) {
      const int p = kp[w];
      vis = p >= 0 && p <= t && (window == 0 || p > t - window);
    }
    float s = NEG_BIG;
    if (vis) {
      float dot = 0.f;
      const float* qr = q_s + r * hd;
      const float* kr = k_s + lane * ks;
      for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
      s = dot * scale;
    }
    const float m_new = fmaxf(m_run, warp_max(s));
    const float p = expf(s - m_new);
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + warp_sum(p);
    p_s[r * kTile + lane] = p;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i)
      if (i < nd) acc[i] *= corr;
    for (int j = 0; j < kTile; ++j) {
      const float pj = p_s[r * kTile + j];
      const float* vr = v_s + j * hd + lane;
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i)
        if (i < nd) acc[i] += pj * vr[32 * i];
    }
    __syncwarp();
    m_run = m_new;
  }
  const float denom = fmaxf(l_run, 1e-30f);
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i)
    if (i < nd) orow[lane + 32 * i] = from_f32<T>(acc[i] / denom);
}

}  // namespace

extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kpos,
    const void* live, void* out, int B, int W, int KV, int qpk, int hd,
    long long q_sb, long long q_sh, long long k_sb, long long k_sw,
    long long k_sh, long long v_sb, long long v_sw, long long v_sh,
    long long o_sb, long long o_sh, long long kpos_sb, int t, int window,
    float scale, int dtype, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (hd % 32 != 0 || hd > 32 * kMaxDPerLane || qpk < 1 || qpk > 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)qpk * hd + (size_t)kTile * (hd + 1) +
                       (size_t)kTile * hd + (size_t)qpk * kTile);
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(B, KV);
  DISPATCH_DTYPE(dtype, T, {
    const bool vec = vec16_ok<T>(k, hd, {k_sb, k_sw, k_sh}) &&
                     vec16_ok<T>(v, hd, {v_sb, v_sw, v_sh});
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(decode_attention_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    decode_attention_kernel<T><<<grid, 32 * qpk, smem, s>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)kpos,
        (const uint8_t*)live, (T*)out, W, qpk, hd, q_sb, q_sh, k_sb, k_sw,
        k_sh, v_sb, v_sw, v_sh, o_sb, o_sh, kpos_sb, t, window, scale, vec);
  });
  return (int)cudaGetLastError();
}
