// Single-query (decode) attention over a ring KV cache, with GQA, ring /
// causal / sliding-window masking by absolute slot position and per-slot
// exit masking: split-KV (flash-decoding) across the SMs.
//
// Replaces the Pallas kernel `_decode_kernel` / `decode_attention` of the
// JAX package's kernels/decode_attention.py.  Per slot b and KV head h the
// qpk query heads h*qpk .. h*qpk+qpk-1 attend over the W cache slots; slot
// w is visible iff kpos >= 0 && kpos <= t && (window == 0 ||
// kpos > t - window), with kpos the lane-wide (W,) ring or a per-slot
// (B, W) row.  Scores are (q . k) * (1 / sqrt(hd)) in f32, masked scores
// are -1e30, the softmax is the f32 online one, and the result is
// acc / max(l, 1e-30).  A slot whose live flag is 0 gets a zero row and
// does no other work.  A live row with no visible key at all gets the
// plain softmax's answer for it: uniform weights, the mean of V over W.
//
// Bound on the H100: bytes.  Each live slot reads its K and V cache rows
// once (2 * W * KV * hd * sizeof(T) per slot) for 4 * qpk * hd flops per
// key, about 8 flop/byte in bf16, far below the ridge: tensor cores do not
// pay here, putting the cache reads on many SMs at once does.
//
// Design: `decode_attention_split_kernel`, grid (n_split, KV, B): each
// block takes one chunk of `chunk` keys (a multiple of the 32-key tile) of
// one (slot, KV head), one warp per query row.  A dead slot's blocks do no
// work (block 0 writes its zero rows).  A block first reads its chunk's
// kpos; if no key of the chunk is visible it loads nothing and its
// partial is the empty one (m = -1e30, l = 0, acc = 0), which is exact: it
// adds exp(-1e30 - M) * 0 = 0 in the merge.  Otherwise K and V tiles come
// in by 16-byte cp.async, double-buffered across the chunk's tiles (views
// that are not 16-byte addressable take element-wise loads into the same
// buffers).  Lane j scores key j of the tile (its K row read 16 bytes at a
// time from a row padded by 16 bytes, so the 8 lanes of each shared-memory
// phase hit distinct banks, with four independent partial sums), the
// warp's online softmax runs on shuffles, and each lane accumulates
// hd / 32 contiguous output dims.  The partial (m, l, acc[hd]) goes to an
// f32 scratch the wrapper allocates.  The partials of a row are merged in
// ascending split order (max first, then sum_s l_s * exp(m_s - M) and
// sum_s acc_s * exp(m_s - M)), so a run repeats its bits, and dense and
// paged calls, which reach this kernel with the same W and so the same
// split, stay bit-identical.  The merge is a second launch,
// `decode_attention_combine_kernel`, grid (H, B), hd threads.  A merge by
// the last block of each (slot, KV head) to arrive (an atomic count, one
// launch) measured slower on the H100 at the serving shape (PERF.md): its
// merge runs on B * KV blocks at the tail of the grid.
// The chunk is picked by the wrapper from W alone: 32 keys up to W = 512
// (16 splits: 128 blocks for the serving path's B = 4, KV = 2 on 132
// SMs), growing in 32-key steps beyond so that a row has at most 16
// partials.
//
// Route "paged": the caches are a layer's paged stores (NB, bs, KV, hd)
// (possibly a layer slice of a stacked store: the block stride is a
// parameter) and a (B, nblk) int32 block table, W = nblk * bs; row w of
// slot b is store[table[b, w / bs], w % bs].  This replaces the gather of
// the slot-logical views (paged_gather.cu: 4.19 MB written and read again
// per decode layer at the serving shape, and a launch) with an indirection
// in the tile loads.  A block first loads its chunk's block ids (one
// __ldg per block of bs keys, issued before the kpos read, so that the two
// loads are in flight together) into shared memory; the tile loads then
// address each row through them.  bs must be a power of two dividing the
// 32-key tile (so dividing every chunk): then the split, the tiles, their
// order and the merge are those of the dense route over the gathered view,
// and the two give the same bits — also for a live row that sees no key
// (the combine's mean of V over all W rows, read through the table) and
// for trash block 0 and duplicate ids, read as stored.
#include "common.cuh"

namespace {

constexpr int kTile = 32;  // keys per tile == warp size

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ bool visible(int p, int t, int window) {
  return p >= 0 && p <= t && (window == 0 || p > t - window);
}

// Where row w (hd contiguous elements) of one (slot, KV head)'s keys or
// values lies.  Dense (blk == 0): base + w * sw.  Paged: base is the
// store at the KV head's offset, row w at base + ids[(w - w0) >> shift] *
// blk + ((w - w0) & (bs - 1)) * sw, with ids the block ids of the chunk
// that starts at w0 (a multiple of bs) and bs = 1 << shift.
template <typename T>
struct Rows {
  const T* base;
  long long sw, blk;
  const int* ids;
  int shift, w0;
  __device__ __forceinline__ const T* row(int w) const {
    if (blk == 0) return base + w * sw;
    const int r = w - w0;
    return base + ids[r >> shift] * blk + (r & ((1 << shift) - 1)) * sw;
  }
};

// Rows [w, w + valid) of one key tile into shared memory with row pitch
// `pitch`: 16-byte cp.async with `vec`, else plain element loads.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int pitch,
                                          const Rows<T>& src, int w,
                                          int valid, int hd, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int nv = hd / kVec;
    for (int idx = threadIdx.x; idx < valid * nv; idx += blockDim.x) {
      const int r = idx / nv, c = (idx % nv) * kVec;
      cp_async16(dst + r * pitch + c, src.row(w + r) + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < valid * hd; idx += blockDim.x) {
      const int r = idx / hd, c = idx % hd;
      dst[r * pitch + c] = src.row(w + r)[c];
    }
  }
}

// N contiguous elements at p (aligned to their size when N * sizeof(T) is
// a power of two up to 16 bytes) as f32
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr ((kBytes & (kBytes - 1)) == 0 && kBytes >= 4 &&
                kBytes <= 16) {
    struct alignas(kBytes) Vec {
      T e[N];
    };
    const Vec x = *reinterpret_cast<const Vec*>(p);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(x.e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

// A live row with no visible key: the plain softmax's uniform weights,
// the mean of V over all W slots in slot order (v_d at output dim d of the
// KV head; paged: slot b's table row `tab`, blocks of 1 << shift rows).
template <typename T>
__device__ __forceinline__ float mean_dim(const T* v_d, long long v_sw,
                                          long long v_blk,
                                          const int* __restrict__ tab,
                                          int shift, int W) {
  // two loops, not a branch in one: a branch per row keeps the compiler
  // from batching the rows' loads (4.4x slower on the H100, PERF.md)
  float sum = 0.f;
  if (v_blk == 0) {
    for (int w = 0; w < W; ++w) sum += to_f32(v_d[w * v_sw]);
  } else {
#pragma unroll 8
    for (int w = 0; w < W; ++w)
      sum += to_f32(v_d[__ldg(tab + (w >> shift)) * v_blk +
                        (w & ((1 << shift) - 1)) * v_sw]);
  }
  return sum / (float)W;
}

template <typename T, int ND>  // ND = hd / 32 output dims per lane
__global__ void decode_attention_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kpos, const uint8_t* __restrict__ live,
    const int* __restrict__ table, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int W, int chunk, int qpk, long long q_sb,
    long long q_sh, long long k_sb, long long k_sw, long long k_sh,
    long long v_sb, long long v_sw, long long v_sh, long long kpos_sb,
    long long tab_sb, long long k_blk, long long v_blk, int shift,
    const int* __restrict__ t_ptr, int window, float scale, bool vec) {
  constexpr int HD = 32 * ND;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int KP = HD + kVec;  // K row pitch: 16 bytes of padding
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, H = gridDim.y * qpk;
  const int r = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = kvh * qpk + r;
  if (live != nullptr && live[b] == 0) return;  // the combine writes zeros
  const int t = __ldg(t_ptr);  // the position, read at every launch

  const int w0 = split * chunk;
  const int w_end = min(W, w0 + chunk);
  // paged: the chunk's block ids, after the tiles in shared memory
  int* ids = reinterpret_cast<int*>(
      smem + sizeof(float) * qpk * HD + sizeof(T) * 2 * kTile * (KP + HD));
  if (table != nullptr) {
    const int* trow = table + b * tab_sb + (w0 >> shift);
    for (int i = threadIdx.x; i < (w_end - w0) >> shift; i += blockDim.x)
      ids[i] = __ldg(trow + i);
  }
  const int* kp = kpos + b * kpos_sb;
  int any = 0;
  for (int w = w0 + threadIdx.x; w < w_end; w += blockDim.x)
    any |= visible(kp[w], t, window);
  any = __syncthreads_or(any);  // also publishes ids

  const Rows<T> kr{k + b * k_sb + kvh * k_sh, k_sw, k_blk, ids, shift, w0};
  const Rows<T> vr{v + b * v_sb + kvh * v_sh, v_sw, v_blk, ids, shift, w0};
  float m_run = NEG_BIG, l_run = 0.f;
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  // a chunk with no visible key loads nothing: its partial stays the
  // empty one (-1e30, 0, 0)
  if (any) {
    float* q_s = reinterpret_cast<float*>(smem);      // qpk x HD
    T* k_s = reinterpret_cast<T*>(q_s + qpk * HD);    // 2 x kTile x KP
    T* v_s = k_s + 2 * kTile * KP;                    // 2 x kTile x HD

    const int n_tiles = (w_end - w0 + kTile - 1) / kTile;
    load_tile(k_s, KP, kr, w0, min(kTile, w_end - w0), HD, vec);
    load_tile(v_s, HD, vr, w0, min(kTile, w_end - w0), HD, vec);
    cp_async_commit();
    for (int idx = threadIdx.x; idx < qpk * HD; idx += blockDim.x)
      q_s[idx] = to_f32(
          q[b * q_sb + (long long)(kvh * qpk + idx / HD) * q_sh + idx % HD]);

    const float* qr = q_s + r * HD;
    for (int it = 0; it < n_tiles; ++it) {
      const int base = w0 + it * kTile;
      const int valid = min(kTile, w_end - base);
      if (it + 1 < n_tiles) {  // prefetch the next tile into the other buffer
        const int nb = base + kTile, nvalid = min(kTile, w_end - nb);
        const int o = (it + 1) & 1;
        load_tile(k_s + o * kTile * KP, KP, kr, nb, nvalid, HD, vec);
        load_tile(v_s + o * kTile * HD, HD, vr, nb, nvalid, HD, vec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // this tile (and q) is in shared memory
      const T* ks = k_s + (it & 1) * kTile * KP;
      const T* vs = v_s + (it & 1) * kTile * HD;

      float s = NEG_BIG;
      if (lane < valid && visible(kp[base + lane], t, window)) {
        const T* kr = ks + lane * KP;
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int c = 0; c < HD; c += kVec) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            part[i % 4] = fmaf(qr[c + i], to_f32(e[i]), part[i % 4]);
        }
        s = ((part[0] + part[1]) + (part[2] + part[3])) * scale;
      }
      const float m_new = fmaxf(m_run, warp_max(s));
      const float p = expf(s - m_new);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + warp_sum(p);
      m_run = m_new;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] *= corr;
#pragma unroll 8
      for (int j = 0; j < valid; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        float vv[ND];
        load_f32<T, ND>(vs + j * HD + lane * ND, vv);
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[i] = fmaf(pj, vv[i], acc[i]);
      }
      __syncthreads();  // readers of this buffer are done before its refill
    }
  }

  const long long row = (long long)b * H + h;
  float* ml = part_ml + row * n_split * 2;
  float* pacc = part_acc + row * n_split * HD + lane * ND;
  if (lane == 0) {
    ml[2 * split] = m_run;
    ml[2 * split + 1] = l_run;
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) pacc[(long long)split * HD + i] = acc[i];
}

// The merge: one block of hd threads per (query head, slot), thread d
// for output dim d.  M = max m, then L = sum l * exp(m - M) and
// a = sum acc[d] * exp(m - M) in ascending split order, out =
// a / max(L, 1e-30); M == -1e30 means no partial saw a visible key.  L2
// loads (__ldcg): the split kernel's blocks wrote the partials.  The
// loops are unrolled so that several partials' loads are in flight at
// once (the sums keep their order).  Staging the (m, l) pairs in shared
// memory and computing each exp once measured slower on the H100.
template <typename T>
__global__ void decode_attention_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    const T* __restrict__ v, const uint8_t* __restrict__ live,
    const int* __restrict__ table, T* __restrict__ out, int W, int n_split,
    int qpk, long long v_sb, long long v_sw, long long v_sh, long long v_blk,
    long long tab_sb, int shift, long long o_sb, long long o_sh) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int H = gridDim.x, hd = blockDim.x;
  T* orow = out + b * o_sb + h * o_sh;
  if (live != nullptr && live[b] == 0) {
    orow[d] = from_f32<T>(0.f);
    return;
  }
  const long long row = (long long)b * H + h;
  const float* ml = part_ml + row * n_split * 2;
  const float* acc = part_acc + row * n_split * hd + d;
  float M = NEG_BIG;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, __ldcg(ml + 2 * s));
  if (M == NEG_BIG) {
    orow[d] = from_f32<T>(mean_dim(v + b * v_sb + (h / qpk) * v_sh + d, v_sw,
                                   v_blk, table + b * tab_sb, shift, W));
    return;
  }
  float L = 0.f, a = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const float f = expf(__ldcg(ml + 2 * s) - M);
    L += __ldcg(ml + 2 * s + 1) * f;
    a += __ldcg(acc + (long long)s * hd) * f;
  }
  orow[d] = from_f32<T>(a / fmaxf(L, 1e-30f));
}

struct Args {
  const void *q, *k, *v, *kpos, *live, *table, *t;
  void* out;
  float *pml, *pacc;
  int B, W, KV, qpk, hd, chunk, window, shift;
  float scale;
  long long st[9];  // q (b, h), k (b, w, h), v (b, w, h), kpos slot
  long long os[2];  // out (b, h)
  long long pg[3];  // paged: table row, k and v block strides (else 0)
};

template <typename T, int ND>
cudaError_t launch_split(const Args& a, const dim3& grid, size_t smem,
                         bool vec, cudaStream_t s) {
  auto kern = decode_attention_split_kernel<T, ND>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const long long* st = a.st;
  kern<<<grid, 32 * a.qpk, smem, s>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int*)a.kpos,
      (const uint8_t*)a.live, (const int*)a.table, a.pml, a.pacc, a.W,
      a.chunk, a.qpk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], a.pg[0], a.pg[1], a.pg[2], a.shift, (const int*)a.t, a.window,
      a.scale, vec);
  return cudaGetLastError();
}

template <typename T>
int launch(const Args& a, cudaStream_t s) {
  const int n_split = (a.W + a.chunk - 1) / a.chunk;
  const dim3 grid(n_split, a.KV, a.B);
  const size_t smem =
      sizeof(float) * (size_t)a.qpk * a.hd +
      sizeof(T) * 2 * (size_t)kTile * (2 * a.hd + 16 / sizeof(T)) +
      (a.table != nullptr ? sizeof(int) * (size_t)(a.chunk >> a.shift) : 0);
  const bool vec =
      vec16_ok<T>(a.k, a.hd, {a.st[2], a.st[3], a.st[4], a.pg[1]}) &&
      vec16_ok<T>(a.v, a.hd, {a.st[5], a.st[6], a.st[7], a.pg[2]});
  cudaError_t err = cudaErrorInvalidValue;
  switch (a.hd / 32) {
#define SPLIT_CASE(ND)                                  \
  case ND:                                              \
    err = launch_split<T, ND>(a, grid, smem, vec, s);   \
    break;
    SPLIT_CASE(1)
    SPLIT_CASE(2)
    SPLIT_CASE(3)
    SPLIT_CASE(4)
    SPLIT_CASE(5)
    SPLIT_CASE(6)
    SPLIT_CASE(7)
    SPLIT_CASE(8)
#undef SPLIT_CASE
  }
  if (err != cudaSuccess) return (int)err;
  decode_attention_combine_kernel<T><<<dim3(a.KV * a.qpk, a.B), a.hd, 0, s>>>(
      a.pml, a.pacc, (const T*)a.v, (const uint8_t*)a.live,
      (const int*)a.table, (T*)a.out, a.W, n_split, a.qpk, a.st[5], a.st[6],
      a.st[7], a.pg[2], a.pg[0], a.shift, a.os[0], a.os[1]);
  return (int)cudaGetLastError();
}

}  // namespace

// Two launches on `stream`: the split kernel reads the position from `t`
// (one int32 in device memory, so that a captured launch reads the
// position of each replay; the combine does not need it) and writes (m, l)
// pairs to
// part_ml (B, H, n_split, 2) and acc to part_acc (B, H, n_split, hd), f32
// scratch of the caller's; the combine kernel merges them into out.
// Dense route: table == nullptr, k / v (B, W, KV, hd) views.  Paged route:
// table (B, W / bs) int32 with row stride tab_sb, k / v stores of blocks
// of bs rows, k_blk / v_blk elements apart (k_sb = v_sb = 0); bs a power
// of two dividing 32.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kpos,
    const void* live, const void* table, void* out, void* part_ml,
    void* part_acc, int B, int W, int KV, int qpk, int hd, int chunk, int bs,
    long long q_sb, long long q_sh, long long k_sb, long long k_sw,
    long long k_sh, long long v_sb, long long v_sw, long long v_sh,
    long long o_sb, long long o_sh, long long kpos_sb, long long tab_sb,
    long long k_blk, long long v_blk, const void* t, int window, float scale,
    int dtype, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (W <= 0 || hd % 32 != 0 || hd > 256 || qpk < 1 || qpk > 32 ||
      chunk <= 0 || chunk % kTile != 0 || t == nullptr)
    return (int)cudaErrorInvalidValue;
  int shift = 0;
  if (table != nullptr) {
    while ((1 << shift) < bs) ++shift;
    if (bs < 1 || (1 << shift) != bs || kTile % bs != 0 || W % bs != 0 ||
        k_sb != 0 || v_sb != 0 || k_blk <= 0 || v_blk <= 0)
      return (int)cudaErrorInvalidValue;
  }
  const Args a{q,  k,   v,  kpos, live, table, t, out, (float*)part_ml,
               (float*)part_acc, B, W, KV, qpk, hd, chunk, window, shift,
               scale,
               {q_sb, q_sh, k_sb, k_sw, k_sh, v_sb, v_sw, v_sh, kpos_sb},
               {o_sb, o_sh},
               {table != nullptr ? tab_sb : 0, table != nullptr ? k_blk : 0,
                table != nullptr ? v_blk : 0}};
  DISPATCH_DTYPE(dtype, T, { return launch<T>(a, (cudaStream_t)stream); });
  return (int)cudaErrorInvalidValue;
}
