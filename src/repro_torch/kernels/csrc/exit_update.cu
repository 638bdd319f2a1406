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
// The threshold δ̂ is an f32 in device memory (the reference's `dynamic`
// route, `th_ref` there), which the row's merging CTA reads when it
// gates: a captured graph replays at whatever value it holds at replay
// time, so a threshold push never re-captures and never rebuilds.
//
// Bound on the H100: bytes.  The logits are read once (B * V * sizeof(x);
// 1.2 MB at the serving shape (4, 151936) in bf16, 0.36 us at 3.35 TB/s);
// the outputs are O(B).  At that size a launch and two dependent memory
// round trips cost more than the bytes, so the design puts every row's
// reads on many SMs at once and ends in the same launch:
//  * grid (n_tiles, B): CTA (tile, b) reduces columns [tile * kTile,
//    (tile + 1) * kTile) of row b.  kTile is the tile registry's
//    `exit_update.vt` (kernels/autotune.py), one of 2048, 4096 (the
//    default) and 8192, each its own instantiation: at 4096 and B = 4 the
//    serving (4, 151936) is 38 x 4 = 152 CTAs, at least one on each of the
//    132 SMs, and a CTA's 8 KB (bf16) is two 16-byte loads a thread, both
//    in flight before the first is used;
//  * 16-byte loads when the row base, its stride and V allow (vec16_ok):
//    8 bf16 / fp16 or 4 f32 a load; a thread pushes its elements in index
//    order, so triple_push's strict > keeps the first index of a tie;
//  * the CTA's (max, sum-exp, first-argmax) triple goes to a scratch;
//    thread 0 fences it and takes a ticket on its row (atomicAdd).  The
//    CTA that takes the row's last ticket merges the row's partials in
//    ascending tile order (merge_partials: a fixed order, so a run repeats
//    its bits), applies the carry merge and puts the ticket back to 0, so
//    no memset launch is needed between calls and a captured graph can
//    replay the kernel.
// The two-launch form of the same split (the partial kernel, then a
// combine launch of one CTA per row, as confidence.cu) gave the same bits
// and was slower at every measured shape (PERF.md row 3), so it was
// removed.
//
// The partial contract (a vocab sharded over the mesh's `model` ranks):
// with `part_out`, the row's merging CTA writes the row's (max, Σexp,
// first argmax + vocab_offset) triple to part_out (a (3, B) f32 array, row
// 2 the argmax's int32 bits) and leaves the carries alone; the ranks'
// triples, gathered in rank order, go to exit_update_combine_launch (one
// thread a row, common.cuh's exit_parts_combine_kernel), which merges them
// rank after rank and applies the carry merge.  Without `part_out` the
// launch is the single-rank one, bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Columns [tile * kTile, min(V, (tile + 1) * kTile)) of one row reduced to
// this thread's triple (the block's threads together cover the tile).
template <typename T, int kTile>
__device__ __forceinline__ void tile_triple(const T* __restrict__ row, int V,
                                            int tile, bool vec, float& m,
                                            float& l, int& a) {
  m = NEG_BIG;
  l = 0.f;
  a = INT_MAX;
  const int j0 = tile * kTile, j1 = min(V, j0 + kTile);
  if (vec) {  // V % kVec == 0, so the tile is whole chunks
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kPer = kTile / kVec / kThreads;  // 2 (16-bit), 4 (f32)
    const uint4* rv = reinterpret_cast<const uint4*>(row + j0);
    const int nc = (j1 - j0) / kVec;
    uint4 raw[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = threadIdx.x + u * kThreads;
      raw[u] = c < nc ? __ldg(rv + c) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int c = threadIdx.x + u * kThreads;
      if (c < nc) {
        const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          triple_push(m, l, a, to_f32(e[i]), j0 + c * kVec + i);
      }
    }
    return;
  }
  for (int j = j0 + threadIdx.x; j < j1; j += kThreads)
    triple_push(m, l, a, to_f32(row[j]), j);
}

// The row's n partials (pm/pl/pa, tile t at index t) merged into thread
// 0's (m, l, a) as merge_partials does, but read from L2 (__ldcg): other
// CTAs of this launch wrote them.
__device__ __forceinline__ void merge_partials_l2(const float* pm,
                                                  const float* pl,
                                                  const int* pa, int n,
                                                  float& m, float& l, int& a) {
  m = NEG_BIG;
  l = 0.f;
  a = INT_MAX;
  for (int t = threadIdx.x; t < n; t += kThreads)
    triple_combine(m, l, a, __ldcg(pm + t), __ldcg(pl + t), __ldcg(pa + t));
  block_reduce_triple<kThreads>(m, l, a);
}

// One CTA per (tile, row); the row's last CTA to finish merges the
// partials and applies the carry merge.
template <typename T, int kTile>
__global__ void __launch_bounds__(kThreads)
    exit_update_tile_kernel(const T* __restrict__ logits, long long row_stride,
                            int V, bool vec, float* pm, float* pl, int* pa,
                            unsigned int* tickets, ExitCarry carry,
                            int vocab_offset, float* part_out) {
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  float m, l;
  int a;
  tile_triple<T, kTile>(logits + (long long)b * row_stride, V, tile, vec, m,
                       l, a);
  block_reduce_triple<kThreads>(m, l, a);
  const long long o = (long long)b * n_tiles;
  __shared__ int is_last;
  if (threadIdx.x == 0) {
    pm[o + tile] = m;
    pl[o + tile] = l;
    pa[o + tile] = a;
    __threadfence();  // the partial is visible device-wide before the
                      // ticket that counts it
    is_last = atomicAdd(tickets + b, 1u) == (unsigned)n_tiles - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  merge_partials_l2(pm + o, pl + o, pa + o, n_tiles, m, l, a);
  if (threadIdx.x == 0) {
    if (part_out != nullptr)
      store_part(part_out, gridDim.y, b, m, l, a + vocab_offset);
    else
      exit_carry_merge(carry, b, 1.f / l, a, true);
    tickets[b] = 0;  // ready for the next launch
  }
}

// The kernel instantiated at the CTA's vocab tile `tile`.
template <typename T>
int launch_tiles(int tile, const dim3& grid, cudaStream_t s, const T* logits,
                 long long row_stride, int V, bool vec, float* pm, float* pl,
                 int* pa, unsigned int* tickets, const ExitCarry& carry,
                 int vocab_offset, float* part_out) {
  switch (tile) {
    case 2048:
      exit_update_tile_kernel<T, 2048><<<grid, kThreads, 0, s>>>(
          logits, row_stride, V, vec, pm, pl, pa, tickets, carry, vocab_offset,
          part_out);
      break;
    case 4096:
      exit_update_tile_kernel<T, 4096><<<grid, kThreads, 0, s>>>(
          logits, row_stride, V, vec, pm, pl, pa, tickets, carry, vocab_offset,
          part_out);
      break;
    case 8192:
      exit_update_tile_kernel<T, 8192><<<grid, kThreads, 0, s>>>(
          logits, row_stride, V, vec, pm, pl, pa, tickets, carry, vocab_offset,
          part_out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// `tile` is the vocab columns a CTA reduces: 2048, 4096 or 8192.
// `workspace` is a (3, B, ceil(V / tile)) f32 scratch; `tickets` is B
// uint32 zeros, and each row's last CTA puts its ticket back to 0, so
// launches that share a tickets buffer must be ordered (one stream).
// `thr` points at the component's δ̂, an f32 on the device.  With
// `part_out` ((3, B) f32) the launch writes each row's triple over its
// columns, the argmax offset by `vocab_offset`, instead of merging the
// carries (the carry pointers and `thr` are then not read).
extern "C" int exit_update_launch(
    const void* logits, long long row_stride, int B, int V, int dtype,
    void* workspace, void* tickets,
    const void* ans_in, const void* pred_in, const void* exit_in,
    const void* conf_in, const void* streak_in, const void* ema_in,
    const void* act_in, void* ans_out, void* pred_out, void* exit_out,
    void* conf_out, void* streak_out, void* ema_out, void* tcode_out,
    const void* thr, int m_idx, int n_components, int patience_k,
    float ema_decay, float ema_keep, int tel_bins, int tile,
    int vocab_offset, void* part_out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (B > 65535 || V <= 0 || tickets == nullptr ||
      (thr == nullptr && part_out == nullptr) ||
      (tile != 2048 && tile != 4096 && tile != 8192))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const ExitCarry carry{
      (const uint8_t*)ans_in, (const int*)pred_in, (const int*)exit_in,
      (const float*)conf_in,  (const int*)streak_in, (const float*)ema_in,
      (const uint8_t*)act_in, (uint8_t*)ans_out,   (int*)pred_out,
      (int*)exit_out,         (float*)conf_out,    (int*)streak_out,
      (float*)ema_out,        (int*)tcode_out,     (const float*)thr,
      m_idx,                  n_components,        patience_k,
      ema_decay,              ema_keep,            tel_bins};
  const int n_tiles = (V + tile - 1) / tile;
  const long long n = (long long)B * n_tiles;
  float* pm = (float*)workspace;
  float* pl = pm + n;
  int* pa = (int*)(pl + n);
  const dim3 grid(n_tiles, B);
  DISPATCH_DTYPE(dtype, T, {
    const bool vec = vec16_ok<T>((const T*)logits, V, {row_stride});
    return launch_tiles<T>(tile, grid, s, (const T*)logits, row_stride, V,
                           vec, pm, pl, pa, (unsigned int*)tickets, carry,
                           vocab_offset, (float*)part_out);
  });
  return (int)cudaErrorInvalidValue;
}

// The combine of the partial contract: `parts` is the (R, 3, B) f32 triples
// of the R vocab slices in rank order; the carries as exit_update_launch
// takes them.
extern "C" int exit_update_combine_launch(
    const void* parts, int B, int R, const void* ans_in, const void* pred_in,
    const void* exit_in, const void* conf_in, const void* streak_in,
    const void* ema_in, const void* act_in, void* ans_out, void* pred_out,
    void* exit_out, void* conf_out, void* streak_out, void* ema_out,
    void* tcode_out, const void* thr, int m_idx, int n_components,
    int patience_k, float ema_decay, float ema_keep, int tel_bins,
    void* stream) {
  const ExitCarry carry{
      (const uint8_t*)ans_in, (const int*)pred_in, (const int*)exit_in,
      (const float*)conf_in,  (const int*)streak_in, (const float*)ema_in,
      (const uint8_t*)act_in, (uint8_t*)ans_out,   (int*)pred_out,
      (int*)exit_out,         (float*)conf_out,    (int*)streak_out,
      (float*)ema_out,        (int*)tcode_out,     (const float*)thr,
      m_idx,                  n_components,        patience_k,
      ema_decay,              ema_keep,            tel_bins};
  return launch_exit_parts_combine((const float*)parts, B, R, nullptr, carry,
                                   (cudaStream_t)stream);
}
