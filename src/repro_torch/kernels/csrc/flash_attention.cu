// Causal (+ sliding-window) flash attention, forward only, with GQA.
//
// Replaces the Pallas kernel `_flash_kernel` / `flash_attention` of the JAX
// package's kernels/flash_attention.py.  Query head h reads KV head
// h / qpk; scores are (q . k) * (1 / sqrt(hd)) in f32; key j is visible to
// query i iff (!causal || j <= i) && (window == 0 || j > i - window);
// masked scores are -1e30; the softmax is the f32 online one; the result is
// acc / max(l, 1e-30).  Key tiles wholly outside the causal/window band of
// a query tile are skipped, as the TPU kernel skips them.
//
// Bound on the H100: operations.  Over the visible (query, key) pairs it
// does 4 * hd flops per pair on bf16 inputs it reads once
// ((B*H + 2*B*KV) * S * hd elements plus the output), i.e. ~hd/2 flop per
// byte per query tile revisit; at S = 256 the tensor-core bound is
// microseconds.  Design: one block of 256 threads per (q tile of 64 rows,
// q head, batch row); K and V tiles of 64 keys stream through one shared
// buffer (K for the scores, then V for the weighted sum), filled with
// 16-byte loads, with padded rows so the 16x16 thread grid reads shared
// memory without bank conflicts;
// each thread owns a 4x4 block of scores and a 4 x (hd/16) block of the
// output, all in f32 on the CUDA cores (no tensor cores).  Left for later:
// wgmma on bf16 tiles, TMA loads and a producer/consumer pipeline — the
// f32 CUDA-core math sits far above the tensor-core bound.
#include "common.cuh"

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
