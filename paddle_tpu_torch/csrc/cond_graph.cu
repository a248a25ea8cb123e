// Conditional (IF) nodes inside a CUDA graph that is being captured from a
// stream, for Hopper (sm_90a, CUDA 12.4 or later).
//
// Replaces the branch selection of the TPU's lax.cond / lax.switch /
// lax.scan-over-cond (paddle_tpu/ops/control_flow_ops.py:50-184), which XLA
// compiles into one program: here the executor's one CUDA graph per key holds
// an IF node per branch, so a replay runs only the taken branch, and a key
// captured while one branch was taken takes the other when its predicate
// says so.
//
// cond_if_begin, called while `stream` captures:
//   1. creates a conditional handle on the graph `stream` captures into;
//   2. enqueues cond_set_kernel, which reads the device predicate (a byte,
//      nonzero = taken; `negate` inverts it) and sets the handle with
//      cudaGraphSetConditional at every replay;
//   3. adds the IF node after the stream's capture dependencies and makes it
//      the stream's only dependency, so the work captured next follows it;
//   4. starts capturing `body_stream` into the node's body graph.
// The caller then runs the branch's work on `body_stream`, and cond_if_end
// ends that capture. Nested IF nodes work the same way from a body stream.
//
// Bound: cond_set_kernel is one thread reading one byte: launch latency, a
// few microseconds per node and replay, nothing the memory or the ALUs bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cond_set_kernel(cudaGraphConditionalHandle handle,
                                const unsigned char* pred, int negate) {
  unsigned int v = pred[0] != 0;
  cudaGraphSetConditional(handle, negate ? 1u - v : v);
}

int status(cudaError_t e) { return e == cudaSuccess ? 0 : static_cast<int>(e); }

}  // namespace

#define COND_CHECK(call)                         \
  do {                                           \
    cudaError_t e_ = (call);                     \
    if (e_ != cudaSuccess) return status(e_);    \
  } while (0)

extern "C" int cond_if_begin(void* stream, const void* pred, int negate,
                             void* body_stream, void** body_graph) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus st;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  COND_CHECK(cudaStreamGetCaptureInfo(s, &st, &id, &graph, &deps, &ndeps));
  if (st != cudaStreamCaptureStatusActive) return -2;
  cudaGraphConditionalHandle handle;
  COND_CHECK(cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                              cudaGraphCondAssignDefault));
  cond_set_kernel<<<1, 1, 0, s>>>(
      handle, static_cast<const unsigned char*>(pred), negate);
  COND_CHECK(cudaGetLastError());
  COND_CHECK(cudaStreamGetCaptureInfo(s, &st, &id, &graph, &deps, &ndeps));
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  COND_CHECK(cudaGraphAddNode(&node, graph, deps, ndeps, &params));
  COND_CHECK(cudaStreamUpdateCaptureDependencies(
      s, &node, 1, cudaStreamSetCaptureDependencies));
  cudaGraph_t body = params.conditional.phGraph_out[0];
  COND_CHECK(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), body, nullptr, nullptr, 0,
      cudaStreamCaptureModeRelaxed));
  *body_graph = body;
  return 0;
}

extern "C" int cond_if_end(void* body_stream, void* body_graph) {
  cudaGraph_t graph = nullptr;
  COND_CHECK(cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream),
                                  &graph));
  return graph == static_cast<cudaGraph_t>(body_graph) ? 0 : -3;
}

extern "C" const char* cond_error_string(int code) {
  if (code == -2) return "the stream is not capturing";
  if (code == -3) return "the body capture ended on another graph";
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
