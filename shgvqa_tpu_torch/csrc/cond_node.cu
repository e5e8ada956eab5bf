// A data-dependent branch inside a CUDA graph being captured: an IF
// conditional node whose condition a one-thread kernel sets from a bool on
// the device at each replay, and whose body graph is captured from a second
// stream.  The port's counterpart of jax.lax.cond in a CUDA graph of the
// train step (train/graph.py): the fixed-capacity augmentation's overflow
// branch (data/transforms.py), which must not read its flag on the host.
//
// Replaces no Pallas kernel; it computes nothing but the condition.  Its
// plain version is the eager branch of kernels/cond.py, which reads the
// flag on the host.  Needs CUDA 12.3+ (conditional nodes,
// cudaStreamBeginCaptureToGraph) and a device of compute capability 9.0 for
// cudaGraphSetConditional.

#include <cuda_runtime.h>

#if CUDART_VERSION < 12030
#error "conditional graph nodes need CUDA 12.3 or later"
#endif

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* flag, int negate) {
  cudaGraphSetConditional(handle, (*flag != static_cast<bool>(negate)) ? 1u : 0u);
}

}  // namespace

extern "C" {

// On `stream`, which must be capturing: adds a kernel that sets a new
// condition to (*flag xor negate) and, after it, an IF node on that
// condition that depends on everything captured so far; the capture goes on
// after the node.  Then starts capturing `body_stream` (not capturing) into
// the node's body graph, in thread-local mode.  Returns a cudaError_t (0 =
// done); cudaErrorStreamCaptureUnmatched when `stream` is not capturing.
int shgvqa_cond_if_begin(void* stream, const void* flag, int negate, void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t num_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &num_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorStreamCaptureUnmatched);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_condition<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(flag), negate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the dependencies again: the set_condition kernel is now the last node
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &num_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, num_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal));
}

// Ends the body's capture on `body_stream`.  Returns a cudaError_t.
int shgvqa_cond_if_end(void* body_stream) {
  cudaGraph_t body;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}

const char* shgvqa_cond_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
