// Conditional (IF) nodes in a CUDA graph under stream capture: the device
// runtime's counterpart of the reference's `lax.cond` and of the guard of
// its `lax.while_loop`.
//
// The card's PyTorch has no public call that captures into a conditional
// node, so this source builds one.  cond_if_begin(stream, child, pred,
// negate), called while `stream` is being captured:
//   1. reads the capture's graph and its current dependencies;
//   2. creates a conditional handle in that graph;
//   3. launches `cond_set_kernel` on `stream` (one thread: the handle
//      takes pred != negate, read from device memory when the graph runs);
//   4. adds an IF node of one body graph after that kernel and makes it
//      the capture's only dependency, so everything captured on `stream`
//      afterwards runs after the node;
//   5. starts capturing `child` into the node's body graph.
// The caller captures the body on `child` and ends it with
// cond_if_end(child).  Bodies nest: a body's capture stream is the
// `stream` of the IF nodes inside it.  The body runs, when the graph is
// launched, iff the predicate read by the set kernel is true.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cond_set_kernel(cudaGraphConditionalHandle handle,
                                const uint8_t* pred, int negate) {
  cudaGraphSetConditional(handle, (pred[0] != 0) != (negate != 0) ? 1u : 0u);
}

}  // namespace

// On a failure *stage names the call that failed (1 = the capture info,
// 2 = the handle, 3 = the set kernel, 4 = the node, 5 = the dependencies,
// 6 = the body's capture).
extern "C" int cond_if_begin(void* stream, void* child, const void* pred,
                             int negate, int* stage) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  *stage = 1;
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  *stage = 2;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  *stage = 3;
  cond_set_kernel<<<1, 1, 0, s>>>(handle, (const uint8_t*)pred, negate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  *stage = 4;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  *stage = 5;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  *stage = 6;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)child, body,
                                            nullptr, nullptr, 0,
                                            cudaStreamCaptureModeRelaxed);
}

// A stream of its own for a capture or its bodies (created on the current
// device, never destroyed): streams handed out by a pool come round again
// and could be the stream a capture already runs on.
extern "C" int cond_stream_create(void** stream) {
  return (int)cudaStreamCreateWithFlags((cudaStream_t*)stream,
                                        cudaStreamNonBlocking);
}

extern "C" int cond_if_end(void* child) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)child, &body);
}
