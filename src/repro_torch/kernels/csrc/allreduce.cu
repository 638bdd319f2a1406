// One-shot all-reduce, all-gather and reduce-scatter over CUDA IPC
// buffers, for the ranks of one mesh axis.
//
// Replaces no TPU kernel: the JAX package's collectives are the ones XLA's
// GSPMD partitioner inserts.  The port needs its own because the decode
// loop captures a whole guarded iteration in a CUDA graph, so every
// collective inside it must be a kernel launch on the capturing stream;
// gloo's CUDA collectives stage through the host and cannot be captured,
// and NCCL refuses two ranks of one communicator on one device.  Training
// on a mesh adds the reduce-scatter: the backward of the K/V all-gather
// and FSDP's gradient reduction over `data`.
//
// Protocol (one launch = one collective of one rank; every rank of the
// axis launches the same sequence of collectives):
//  * each rank owns an IPC region: kMaxCtas flags (one 128-byte line each)
//    then two data buffers of `cap` bytes (parity 0 and 1), every buffer
//    cut into kMaxCtas fixed slabs; CTA c of every launch owns slab c and
//    flag c, so CTAs never wait on each other;
//  * CTA c keeps a generation counter gens[c] in the rank's own (not
//    shared) memory: g = gens[c] + 1 names this launch.  Being device
//    state, it advances at every graph replay; all ranks run the same
//    collectives, so their counters stay equal;
//  * write: the CTA copies its slab of the input into its own buffer of
//    parity g & 1, then thread 0 fences (system scope) and stores g into
//    its flag with st.release.sys;
//  * wait: thread 0 polls each peer's flag c with ld.acquire.sys until it
//    reaches g, sleeping between polls (__nanosleep).  The wait is bounded
//    by `timeout_ns` of %globaltimer: past it the CTA writes (1, rank,
//    generation, peer) into a host-mapped error word and traps, so a lost
//    peer ends the launch with an error instead of hanging the card;
//  * read: the CTA sums the R ranks' slabs IN RANK ORDER in f32 (max: the
//    same order) and stores the result in the input's dtype, so every rank
//    ends with the same bits; an all-gather copies rank r's slab to row r
//    of the output.  Peer data is read through L2 (__ldcg): L1 is not
//    coherent with another context's writes;
//  * reduce-scatter: the input is R rank slices of n elements (`stride`
//    apart); CTA c takes elements [c·q, c·q + q) of EVERY slice, q =
//    slab / R rounded down to whole 16-byte chunks, and writes slice p's
//    piece at p·q of its own slab, so a CTA still writes its slab alone;
//    rank r then sums piece r of every peer's slab in rank order in f32:
//    the bits of the all-reduce's slice r, on rank r only;
//  * reuse: a rank writes buffer g & 1 only after every peer has set flag
//    c to g - 1, i.e. after each peer finished launch g - 2 on its stream,
//    the last one that read that buffer: two buffers need no second
//    barrier.
//
// Bound on the H100: latency, not bytes.  At decode sizes ((4, 2048) bf16,
// 16 KB) the bytes take ~10 ns at 3.35 TB/s; a launch, the flag's round
// trip through L2 and, with two processes time-sliced on one card (no MPS),
// a context switch per wait set the time.  One CTA serves up to one slab
// (cap / kMaxCtas bytes); prefill-sized calls spread over up to kMaxCtas
// CTAs.  A reduce-scatter moves R·n elements in and n out a rank; past
// `cap` bytes of input the wrapper splits it into rank-sliced chunks.
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCtas = 64;
constexpr int kMaxRanks = 8;
constexpr int kFlagStride = 32;  // uint32s: one 128-byte line per flag
constexpr int OP_SUM = 0, OP_MAX = 1, OP_GATHER = 2, OP_RS = 3;

struct Peers {
  char* base[kMaxRanks];  // every rank's IPC region (own included), in rank
                          // order, as mapped in this process
};

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) oneshot_kernel(
    const T* __restrict__ in, T* __restrict__ out, long long n,
    long long stride, long long slab_elems, long long per, int R, int rank,
    Peers peers, long long cap, unsigned* __restrict__ gens, int op,
    unsigned long long timeout_ns, volatile unsigned* err) {
  // per: the elements of each rank slice a CTA takes (the slab for the
  // other ops, one R-th of it for the reduce-scatter)
  __shared__ unsigned gen;
  const int c = blockIdx.x;
  const long long lo = (long long)c * per;
  const long long cnt = min(per, n - lo);
  if (threadIdx.x == 0) gen = gens[c] + 1u;
  __syncthreads();
  const unsigned g = gen;
  const long long off = kMaxCtas * kFlagStride * sizeof(unsigned) +
                        (long long)(g & 1u) * cap +
                        (long long)c * slab_elems * sizeof(T);
  // 1. this rank's part into its own buffer (reduce-scatter: each rank
  //    slice's piece at its place in the slab)
  T* mine = reinterpret_cast<T*>(peers.base[rank] + off);
  if (op == OP_RS) {
    for (int p = 0; p < R; ++p)
      for (long long i = threadIdx.x; i < cnt; i += kThreads)
        mine[p * per + i] = in[p * stride + lo + i];
  } else {
    for (long long i = threadIdx.x; i < cnt; i += kThreads)
      mine[i] = in[lo + i];
  }
  __syncthreads();
  // 2. publish, then wait for every peer's part of this generation
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release_sys(
        reinterpret_cast<unsigned*>(peers.base[rank]) + c * kFlagStride, g);
    const unsigned long long t0 = global_ns();
    for (int p = 0; p < R; ++p) {
      if (p == rank) continue;
      const unsigned* flag =
          reinterpret_cast<const unsigned*>(peers.base[p]) + c * kFlagStride;
      unsigned ns = 32;
      while ((int)(ld_acquire_sys(flag) - g) < 0) {
        if (global_ns() - t0 > timeout_ns) {
          err[1] = (unsigned)rank;
          err[2] = g;
          err[3] = (unsigned)p;
          __threadfence_system();
          err[0] = 1u;
          __threadfence_system();
          __trap();
        }
        __nanosleep(ns);
        if (ns < 4096) ns <<= 1;
      }
    }
  }
  __syncthreads();
  // 3. combine in rank order
  if (op == OP_GATHER) {
    for (int p = 0; p < R; ++p) {
      const T* src = reinterpret_cast<const T*>(peers.base[p] + off);
      T* dst = out + (long long)p * n + lo;
      for (long long i = threadIdx.x; i < cnt; i += kThreads)
        dst[i] = __ldcg(src + i);
    }
  } else if constexpr (!std::is_same<T, int>::value) {
    // reduce-scatter: this rank's piece of every peer's slab
    const long long at = op == OP_RS ? (long long)rank * per : 0;
    for (long long i = threadIdx.x; i < cnt; i += kThreads) {
      float acc = to_f32(__ldcg(reinterpret_cast<const T*>(peers.base[0] +
                                                           off) + at + i));
      for (int p = 1; p < R; ++p) {
        const float v =
            to_f32(__ldcg(reinterpret_cast<const T*>(peers.base[p] + off) +
                          at + i));
        acc = op == OP_MAX ? fmaxf(acc, v) : __fadd_rn(acc, v);
      }
      out[lo + i] = from_f32<T>(acc);
    }
  }
  if (threadIdx.x == 0) gens[c] = g;
}

}  // namespace

namespace {
// the host-mapped error word: (set, rank, generation, peer)
unsigned* g_err_host = nullptr;
unsigned* g_err_dev = nullptr;
}  // namespace

// Bytes of the flags header that precedes the two data buffers.
extern "C" long long allreduce_header_bytes() {
  return (long long)kMaxCtas * kFlagStride * sizeof(unsigned);
}

extern "C" int allreduce_max_ctas() { return kMaxCtas; }

// A zeroed IPC region of `bytes` on the current device and its IPC handle
// (64 bytes into `handle`).
extern "C" int allreduce_alloc(long long bytes, void** ptr, void* handle) {
  cudaError_t e = cudaMalloc(ptr, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(*ptr, 0, (size_t)bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaIpcGetMemHandle((cudaIpcMemHandle_t*)handle, *ptr);
}

// A peer's region in this process, from its handle.
extern "C" int allreduce_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int allreduce_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int allreduce_free(void* ptr) { return (int)cudaFree(ptr); }

// The process's host-mapped error word (4 uint32: set, rank, generation,
// peer), allocated at first use; readable after a trap killed the context.
extern "C" int allreduce_error_word(void** host) {
  if (g_err_host == nullptr) {
    cudaError_t e = cudaHostAlloc((void**)&g_err_host, 4 * sizeof(unsigned),
                                  cudaHostAllocMapped);
    if (e != cudaSuccess) return (int)e;
    memset(g_err_host, 0, 4 * sizeof(unsigned));
    e = cudaHostGetDevicePointer((void**)&g_err_dev, g_err_host, 0);
    if (e != cudaSuccess) return (int)e;
  }
  *host = g_err_host;
  return 0;
}

namespace {
// elements of one CTA's slab: whole 16-byte chunks
long long slab_of(long long cap, int esize) {
  return (cap / kMaxCtas) / 16 * 16 / esize;
}
// elements of each rank slice one CTA takes: the slab for sum, max and
// gather; for the reduce-scatter an R-th of it in whole 16-byte chunks
long long per_of(long long cap, int esize, int op, int R) {
  const long long slab = slab_of(cap, esize);
  if (op != OP_RS) return slab;
  const long long vec = 16 / esize;
  return slab / R / vec * vec;
}
}  // namespace

// The most elements of each rank slice one reduce-scatter launch takes
// (`dtype`'s element size, R ranks, `cap` bytes a buffer): the wrapper
// splits a larger call into rank-sliced chunks of this many.
extern "C" long long allreduce_rs_capacity(int dtype, int R, long long cap) {
  if (R < 1 || R > kMaxRanks) return 0;
  const int esize = dtype == DT_F32 || dtype == 3 ? 4 : 2;
  return (long long)kMaxCtas * per_of(cap, esize, OP_RS, R);
}

// One collective: `op` 0 sum, 1 max (out has in's shape), 2 all-gather
// (out is R x n), 3 reduce-scatter (in is R slices of n elements, `stride`
// apart; out is this rank's n).  `bases` holds the R regions in rank order
// (this rank's own at `rank`), `cap` the bytes of one data buffer, `gens`
// kMaxCtas uint32 counters in this rank's memory.  The call's bytes must
// fit in the buffer (a reduce-scatter: n within allreduce_rs_capacity);
// the wrapper splits larger tensors.  dtype 3 is int32 (gather only).
extern "C" int allreduce_launch(const void* in, void* out, long long n,
                                long long stride, int dtype, int op, int R,
                                int rank, void* const* bases, long long cap,
                                void* gens, double timeout_s, void* stream) {
  if (n <= 0) return 0;
  if (R < 1 || R > kMaxRanks || rank < 0 || rank >= R || g_err_dev == nullptr)
    return (int)cudaErrorInvalidValue;
  if (op < OP_SUM || op > OP_RS) return (int)cudaErrorInvalidValue;
  const int esize = dtype == DT_F32 || dtype == 3 ? 4 : 2;
  if (n * esize > cap || (dtype == 3 && op != OP_GATHER) ||
      (op == OP_RS && stride < n))
    return (int)cudaErrorInvalidValue;
  // slabs of whole 16-byte chunks, as many CTAs as the bytes need
  const long long slab = slab_of(cap, esize);
  const long long per = per_of(cap, esize, op, R);
  if (per <= 0) return (int)cudaErrorInvalidValue;
  const long long ctas_ll = (n + per - 1) / per;
  if (ctas_ll > kMaxCtas) return (int)cudaErrorInvalidValue;
  const int ctas = (int)ctas_ll;
  Peers peers;
  for (int p = 0; p < kMaxRanks; ++p)
    peers.base[p] = p < R ? (char*)bases[p] : nullptr;
  const unsigned long long tns = (unsigned long long)(timeout_s * 1e9);
  cudaStream_t s = (cudaStream_t)stream;
  unsigned* gc = (unsigned*)gens;
  switch (dtype) {
    case DT_F32:
      oneshot_kernel<float><<<ctas, kThreads, 0, s>>>(
          (const float*)in, (float*)out, n, stride, slab, per, R, rank, peers,
          cap, gc, op, tns, g_err_dev);
      break;
    case DT_BF16:
      oneshot_kernel<__nv_bfloat16><<<ctas, kThreads, 0, s>>>(
          (const __nv_bfloat16*)in, (__nv_bfloat16*)out, n, stride, slab, per,
          R, rank, peers, cap, gc, op, tns, g_err_dev);
      break;
    case DT_F16:
      oneshot_kernel<__half><<<ctas, kThreads, 0, s>>>(
          (const __half*)in, (__half*)out, n, stride, slab, per, R, rank,
          peers, cap, gc, op, tns, g_err_dev);
      break;
    case 3:
      oneshot_kernel<int><<<ctas, kThreads, 0, s>>>(
          (const int*)in, (int*)out, n, stride, slab, per, R, rank, peers,
          cap, gc, op, tns, g_err_dev);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
