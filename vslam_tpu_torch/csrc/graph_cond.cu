// Conditional nodes of a CUDA graph under stream capture: the port's
// counterparts of the JAX package's data-dependent control flow inside
// its compiled per-frame program --
//   lax.while_loop  the Gauss-Newton phases (vslam_tpu/solve/gn.py,
//                   vslam_tpu/solve/aligners.py), the closure ICP batch
//   lax.cond        the registration retry ladder, the keyframe snapshot
//                   and the eviction sweep (vslam_tpu/tracking/fused.py)
// -- which become a WHILE node and an IF node of the captured graph
// (CUDA 12.4+; conditional bodies may hold conditional nodes).  Python
// drives it through vslam_tpu_torch/ops/control.py.
//
// gc_begin, on a stream being captured:
//   * reads the capture (the graph and the stream's current dependencies),
//   * creates a conditional handle in that graph,
//   * launches gc_set_kernel on the stream, which sets the handle from a
//     device flag array (the first entry of a WHILE node, an IF's branch),
//   * adds the conditional node after that kernel,
//   * makes the node the stream's only dependency, so what the stream
//     captures next runs after the node,
//   * and starts capturing the node's body graph on body_stream.
// gc_end ends the body's capture; for a WHILE node it first launches
// gc_set_kernel on body_stream as the body's last kernel, which decides
// the next iteration.
//
// The decision: value = any(flags[0..n)), XOR negate; with a counter,
// AND (counter < max_iters), where gc_begin's kernel sets the counter to
// 0 and each iteration's closing kernel adds one, so after a replay it
// holds the iterations the WHILE node ran.  flags are torch bools (one
// byte each).  The kernel is one thread: n is a batch of problems (at
// most 16 here), the flags lie in L2.
//
// Every function returns the cudaError_t of the first call that failed
// (0 = success); the wrapper raises on anything else.  Nothing here
// allocates device memory or synchronizes.

#include <cuda_runtime.h>

namespace {

__global__ void gc_set_kernel(cudaGraphConditionalHandle handle, const unsigned char* flags,
                              int n, int* counter, int max_iters, int negate, int init) {
  unsigned int any = 0;
  for (int i = 0; i < n; ++i) any |= flags[i] != 0;
  unsigned int value = any ^ (negate ? 1u : 0u);
  if (counter != nullptr) {
    int c = init ? 0 : *counter + 1;
    *counter = c;
    value = value && c < max_iters;
  }
  cudaGraphSetConditional(handle, value);
}

}  // namespace

extern "C" {

// kind: 0 = IF, 1 = WHILE.  handle_out receives the node's handle, which
// gc_end takes back.
int gc_begin(void* stream, void* body_stream, int kind, const void* flags, int n,
             void* counter, int max_iters, int negate, unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStream_t body = static_cast<cudaStream_t>(body_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  gc_set_kernel<<<1, 1, 0, s>>>(handle, static_cast<const unsigned char*>(flags), n,
                                static_cast<int*>(counter), max_iters, negate, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // The kernel is now the stream's dependency: the node goes after it.
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(body, body_graph, nullptr, nullptr, 0,
                                      cudaStreamCaptureModeRelaxed);
  if (err != cudaSuccess) return err;
  *handle_out = static_cast<unsigned long long>(handle);
  return cudaSuccess;
}

int gc_end(void* body_stream, unsigned long long handle, int kind, const void* flags, int n,
           void* counter, int max_iters) {
  cudaStream_t body = static_cast<cudaStream_t>(body_stream);
  if (kind == 1) {
    gc_set_kernel<<<1, 1, 0, body>>>(static_cast<cudaGraphConditionalHandle>(handle),
                                     static_cast<const unsigned char*>(flags), n,
                                     static_cast<int*>(counter), max_iters, 0, 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaGraph_t captured;
  return cudaStreamEndCapture(body, &captured);
}

}  // extern "C"
