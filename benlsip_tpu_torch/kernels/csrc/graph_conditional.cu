// Conditional WHILE and IF nodes for CUDA graph capture: the device-side
// loop guards of `_loops.masked_while` and branch guards of `_loops.if_any`
// in capture mode.
//
// Not the port of a TPU kernel.  The JAX package runs its loops as
// `lax.while_loop`s and its branches as `lax.cond`s inside one compiled
// program; the port captures each loop's body once into the body graph of
// a conditional WHILE node, whose handle a one-thread kernel sets from a
// device bool (`run.any()` and the trip cap) before the node and again at
// the end of every trip, so the device runs exactly the trips the lanes
// need and the host decides nothing.  A branch taken for some lanes is
// captured into the body of an IF node, whose handle the same kernel sets
// once from `mask.any()` before the node.  These are the calls of
// PyTorch's own `CUDAGraph.begin_capture_to_if_node` (in torch releases
// after 2.11, IF nodes only), for a torch that lacks it: create a handle in
// the graph being captured on `parent`, capture the kernel that sets it,
// add the node after the current capture dependencies, make it the only
// dependency of what `parent` captures next, and start capturing `body`
// (another stream) into the node's body graph, which it returns.  The
// caller captures the body on `body` and routes its allocations into a
// private memory pool; a WHILE body ends by setting the handle again on
// `body` (benlsip_while_set).  Both end with benlsip_body_end.
//
// What bounds it: nothing on the device worth counting.  Each trip or
// branch adds one one-thread kernel and the node's evaluation.
#include "common.cuh"

namespace {

__global__ void set_handle(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

BENLSIP_API int benlsip_while_set(unsigned long long handle, const void* pred, void* stream) {
  set_handle<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(handle, static_cast<const bool*>(pred));
  return cudaGetLastError();
}

namespace {

int begin_conditional(cudaGraphConditionalNodeType type, const void* pred, void* parent_stream, void* body_stream,
                      unsigned long long* handle_out, void** body_graph_out) {
  cudaStream_t parent = static_cast<cudaStream_t>(parent_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  err = static_cast<cudaError_t>(benlsip_while_set(handle, pred, parent_stream));
  if (err != cudaSuccess) return err;
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  *handle_out = handle;
  *body_graph_out = params.conditional.phGraph_out[0];
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
}

}  // namespace

BENLSIP_API int benlsip_while_begin(const void* pred, void* parent_stream, void* body_stream,
                                    unsigned long long* handle_out, void** body_graph_out) {
  return begin_conditional(cudaGraphCondTypeWhile, pred, parent_stream, body_stream, handle_out, body_graph_out);
}

BENLSIP_API int benlsip_if_begin(const void* pred, void* parent_stream, void* body_stream,
                                 unsigned long long* handle_out, void** body_graph_out) {
  return begin_conditional(cudaGraphCondTypeIf, pred, parent_stream, body_stream, handle_out, body_graph_out);
}

BENLSIP_API int benlsip_body_end(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}
