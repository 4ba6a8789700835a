// Conditional nodes of a CUDA graph under stream capture: the device side of
// runtime/graph_cond.py:cond, the port's counterpart of jax.lax.cond in the
// frame programs (beats3d_tpu/runtime/pipeline.py frame_step and
// frame_step_batched).  Not a port of a TPU kernel: XLA runs only the branch
// a lax.cond takes, and these entries let a captured graph do the same with
// the predicate on the card, read by no host.
//
// b3d_cond_begin, called while `stream` captures a graph (the frame graph,
// or a body of an enclosing cond), appends to that graph
//
//   set_branch_kernel --> IF node (true body) --> IF node (false body)
//
// and makes the IF nodes the stream's capture dependencies, so whatever the
// stream captures next runs after both.  The one-thread kernel reads the 0-d
// bool predicate and sets the two nodes' handles to pred and !pred: at each
// replay exactly one body runs.  Two IF nodes and not one IF/ELSE node,
// which needs CUDA 12.8; the kernel sets both handles, so the negation costs
// no launch.  It also adds one to taken[0] (true) or taken[1] (false) when
// `taken` is not null: the replays of each body, kept on the card for the
// checks that hold the kernels' launches to the graph's.
//
// The caller captures each body with b3d_capture_to_graph on a stream of its
// own and closes it with b3d_capture_end.  Bodies hold kernels, device
// copies and nested conditional nodes, which a conditional body allows.
//
// Needs CUDA 12.4 (runtime and driver): conditional handles set from device
// code and capture into an existing graph.  Built with an older toolkit the
// entries return cudaErrorNotSupported, and b3d_cuda_versions says why.

#include <cuda_runtime.h>

#if CUDART_VERSION >= 12040

namespace {

__global__ void set_branch_kernel(cudaGraphConditionalHandle on_true,
                                  cudaGraphConditionalHandle on_false,
                                  const bool* pred, long long* taken) {
  const bool p = *pred;
  cudaGraphSetConditional(on_true, p ? 1u : 0u);
  cudaGraphSetConditional(on_false, p ? 0u : 1u);
  if (taken != nullptr) taken[p ? 0 : 1] += 1;
}

// The graph `stream` is capturing into and its current dependencies.
cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                           deps, nullptr, n);
#else
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                           deps, n);
#endif
  if (e != cudaSuccess) return e;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess : cudaErrorStreamCaptureUnsupported;
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* deps, size_t n,
                     cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, deps, nullptr, n, params);
#else
  return cudaGraphAddNode(node, graph, deps, n, params);
#endif
}

cudaError_t set_dependencies(cudaStream_t stream, cudaGraphNode_t* node) {
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(
      stream, node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies(
      stream, node, 1, cudaStreamSetCaptureDependencies);
#endif
}

}  // namespace

extern "C" int b3d_cond_begin(void* stream_, const void* pred, void* taken,
                              void** bodies) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t e = capture_info(stream, &graph, &deps, &n);
  if (e != cudaSuccess) return e;
  cudaGraphConditionalHandle handle[2];
  for (int i = 0; i < 2; ++i) {
    e = cudaGraphConditionalHandleCreate(&handle[i], graph, 0,
                                         cudaGraphCondAssignDefault);
    if (e != cudaSuccess) return e;
  }
  set_branch_kernel<<<1, 1, 0, stream>>>(handle[0], handle[1],
                                         static_cast<const bool*>(pred),
                                         static_cast<long long*>(taken));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = capture_info(stream, &graph, &deps, &n);   // now: the kernel's node
  if (e != cudaSuccess) return e;
  cudaGraphNode_t node[2];
  for (int i = 0; i < 2; ++i) {
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle[i];
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    e = i == 0 ? add_node(&node[0], graph, deps, n, &params)
               : add_node(&node[1], graph, &node[0], 1, &params);
    if (e != cudaSuccess) return e;
    bodies[i] = params.conditional.phGraph_out[0];
  }
  return set_dependencies(stream, &node[1]);
}

extern "C" int b3d_capture_to_graph(void* stream, void* graph) {
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(graph),
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int b3d_capture_end(void* stream) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph);
}

#else   // CUDART_VERSION < 12040

extern "C" int b3d_cond_begin(void*, const void*, void*, void**) {
  return cudaErrorNotSupported;
}
extern "C" int b3d_capture_to_graph(void*, void*) {
  return cudaErrorNotSupported;
}
extern "C" int b3d_capture_end(void*) { return cudaErrorNotSupported; }

#endif

// The CUDA runtime this library was built with and the driver's version,
// as 1000 * major + 10 * minor.
extern "C" int b3d_cuda_versions(int* runtime, int* driver) {
  *runtime = CUDART_VERSION;
  return cudaDriverGetVersion(driver);
}

// A stream of the bodies' captures, its own and not one of PyTorch's pool
// (which hands out its 32 streams in turn, the capture's own among them).
extern "C" int b3d_stream_create(void** stream) {
  return cudaStreamCreateWithFlags(reinterpret_cast<cudaStream_t*>(stream),
                                   cudaStreamNonBlocking);
}

extern "C" int b3d_stream_destroy(void* stream) {
  return cudaStreamDestroy(static_cast<cudaStream_t>(stream));
}
