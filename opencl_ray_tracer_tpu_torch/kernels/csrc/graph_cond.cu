// Conditional nodes of a CUDA graph under stream capture: the port's
// `lax.cond` (opencl_ray_tracer_tpu_torch/runtime/graph.py:cond).
//
// Replaces no TPU kernel. Under `jax.jit` a `lax.cond` runs one branch; in a
// CUDA graph that is an IF node per branch, whose body graph runs only
// where its condition handle is non-zero at that launch. The handles are
// set on the card, by a one-thread kernel in the graph, from a bool that
// earlier nodes of the same graph wrote (the overflow flag of the bins), so
// a replay chooses its branch with no host read.
//
// A cond is placed in four steps, each a call here from runtime/graph.py:
//   1. octrt_cond_handles: two handles in the graph that `stream` captures
//      into, and the kernel that sets them to pred and !pred;
//   2. octrt_cond_begin_body: an IF node on one handle, after the stream's
//      current dependencies; the stream then depends on that node only, and
//      `body_stream` starts capturing into the node's body graph;
//   3. the branch's launches, on `body_stream`;
//   4. octrt_cond_end_body: `body_stream` stops capturing.
// Steps 2-4 run once for the false branch, then for the true one.
//
// What bounds it: one launch of one thread a replay, and the two nodes; no
// data moves.

#include <cuda_runtime.h>

namespace {

__global__ void set_branches(cudaGraphConditionalHandle on_true,
                             cudaGraphConditionalHandle on_false,
                             const bool* pred) {
  const unsigned int taken = *pred ? 1u : 0u;
  cudaGraphSetConditional(on_true, taken);
  cudaGraphSetConditional(on_false, 1u - taken);
}

// The graph `s` captures into and its current dependencies; an error where
// `s` is not capturing.
cudaError_t capture_of(cudaStream_t s, cudaGraph_t* graph,
                       const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                           n_deps);
  if (e != cudaSuccess) return e;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorStreamCaptureInvalidated;
}

}  // namespace

extern "C" {

// handles[0] = pred, handles[1] = !pred at every launch of the graph that
// `stream` captures into; pred is one bool on the card.
int octrt_cond_handles(const void* pred, unsigned long long* handles,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  cudaError_t e = capture_of(s, &graph, nullptr, nullptr);
  if (e != cudaSuccess) return e;
  cudaGraphConditionalHandle h[2];
  for (int i = 0; i < 2; ++i) {
    e = cudaGraphConditionalHandleCreate(&h[i], graph, 0, 0);
    if (e != cudaSuccess) return e;
  }
  set_branches<<<1, 1, 0, s>>>(h[0], h[1], static_cast<const bool*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  handles[0] = h[0];
  handles[1] = h[1];
  return cudaSuccess;
}

// An IF node on `handle` after `stream`'s dependencies; `stream` then
// depends on it alone, and `body_stream` captures into its body.
int octrt_cond_begin_body(unsigned long long handle, void* stream,
                          void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t e = capture_of(s, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return e;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeGlobal);
}

int octrt_cond_end_body(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

// A stream of its own for the bodies, on the current device (never from
// PyTorch's pool, whose streams other code takes round-robin).
int octrt_body_stream(void** stream) {
  cudaStream_t s;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (e == cudaSuccess) *stream = s;
  return e;
}

}  // extern "C"
