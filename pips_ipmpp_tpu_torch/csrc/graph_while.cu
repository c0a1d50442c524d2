// Device-side control flow for captured CUDA graphs (sm_90a).
//
// The fused IPM loop (ipm/control.py, ipm/device_loop.py) is the port's
// counterpart of the JAX package's lax.while_loop / lax.cond.  Captured
// into a CUDA graph, each loop becomes a conditional WHILE node and each
// branch a conditional IF node: the body graph runs only while (or if) a
// device flag holds, so nothing is masked and no trip is wasted.  PyTorch
// exposes IF nodes only (CUDAGraph.begin_capture_to_if_node); these
// functions open either kind on the capture of a stream, the way PyTorch
// opens its IF node:
//
//   graph_cond_begin  on the capturing stream `outer`: create a conditional
//                     handle in the graph being captured, capture a
//                     one-thread kernel that sets it from the device bool
//                     `pred` (negated when asked), add the conditional node
//                     after it, make the node the stream's only dependency,
//                     and begin capturing `body` into the node's body graph;
//   graph_cond_end    for a WHILE node, capture the same kernel on `body`
//                     with the flag for the next trip; then end the body's
//                     capture.
//
// Between the two calls every launch on `body` lands in the body graph,
// nested nodes included.  The handle is created without a default value:
// the kernel before the node sets it on every replay.
// Each function returns the first CUDA error it meets, else 0.
#include <cuda_runtime.h>

namespace {

constexpr int kIf = 0;
constexpr int kWhile = 1;

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* pred, int negate) {
  const bool v = *pred;
  cudaGraphSetConditional(handle, (negate ? !v : v) ? 1u : 0u);
}

}  // namespace

// Loads the module of the condition kernel, so that no capture meets a
// lazy module load.
extern "C" int graph_cond_prepare() {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, set_condition_kernel));
}

// kind 0: IF, 1: WHILE.  pred: one bool on the device, read when the
// node is reached.  handle_out receives the node's conditional handle.
extern "C" int graph_cond_begin(void* outer, void* body, const bool* pred,
                                int negate, int kind,
                                unsigned long long* handle_out) {
  if (kind != kIf && kind != kWhile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t so = static_cast<cudaStream_t>(outer);
  cudaStream_t sb = static_cast<cudaStream_t>(body);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err =
      cudaStreamGetCaptureInfo(so, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureUnmatched);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_condition_kernel<<<1, 1, 0, so>>>(handle, pred, negate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the dependencies now end at the kernel just captured
  err = cudaStreamGetCaptureInfo(so, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      kind == kWhile ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(so, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamBeginCaptureToGraph(sb, params.conditional.phGraph_out[0],
                                      nullptr, nullptr, 0,
                                      cudaStreamCaptureModeRelaxed);
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle_out = handle;
  return 0;
}

// For a WHILE node, pred is the flag for the next trip, computed at the
// end of the body; an IF node ignores it.  nodes_out receives the number
// of nodes of the body graph.
extern "C" int graph_cond_end(void* body, unsigned long long handle,
                              const bool* pred, int kind, size_t* nodes_out) {
  cudaStream_t sb = static_cast<cudaStream_t>(body);
  if (kind == kWhile) {
    set_condition_kernel<<<1, 1, 0, sb>>>(handle, pred, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamEndCapture(sb, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  *nodes_out = 0;
  return static_cast<int>(cudaGraphGetNodes(graph, nullptr, nodes_out));
}
