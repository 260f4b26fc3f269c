// The tracking loop's lax.while_loop as one CUDA graph: a WHILE
// conditional node per level, its body the level's captured iteration
// graph, the condition decided on the card by while_cond. And the
// gradient reduction's lax.cond as an IF node spliced into a capture under
// way, its branch decided on the card by if_cond.
//
// Replaces no Pallas kernel. The JAX package compiles
// gaus_slam_tpu/slam/steps.py::tracking_loop (two lax.while_loop's, a
// coarse level and then the full-resolution one) into one XLA program,
// whose cond (cond_until, steps.py:129-135) XLA evaluates on the device
// between iterations. Here each level's iteration is a CUDA graph that
// PyTorch captured (slam/programs.py); this file assembles them:
//
//   parent:  cond(entry) -> WHILE(h0) -> cond(entry) -> WHILE(h1) ... -> tail
//   body l:  iteration graph (child node) -> cond(body, tally)
//
// The conditional handles are created without cudaGraphCondAssignDefault:
// the entry while_cond sets each handle before its WHILE node runs, so a
// level whose first test fails runs no iteration, as the JAX while_loop
// tests its cond before the first body.
//
// lax.cond (gaus_slam_tpu/ops/binning.py:120, Binning.slab_scatter_grads:
// the slab reduction on the overflow flag, else the run reduction; XLA
// runs only the taken branch). Inside a PyTorch capture under way on a
// stream, graph_cond_add captures if_cond and adds after it one IF node
// with an else body (cudaGraphCondTypeIf, size 2: a CUDA 12.8 runtime and
// driver; the card runs driver 580, CUDA 13.0, and nvcc's static cudart
// 12.8 or later, which the #error below holds), then moves the capture on
// after the node:
//
//   ... -> if_cond(flag, tally) -> IF(h) [then body | else body] -> ...
//
// if_cond sets h to the flag and adds one to the tally of the branch it
// picks. Each body is captured from a second stream with
// cudaStreamBeginCaptureToGraph (graph_cond_body_begin / _end). Chosen
// over two IF nodes (one on the flag, one on its negation): one handle,
// one node, the same kernel.
//
// What bounds while_cond and if_cond: nothing of the card's rates: one
// thread reads 5 bytes (if_cond 1, and adds to 8) and sets the handle;
// its cost is one kernel node's launch inside the graph (a few
// microseconds), once per iteration or per IF node.
//
// The C functions return the cudaError_t of the first call that failed
// (0 on success); the Python wrappers (ops/graph_loop.py) raise on it.
#include <cuda_runtime.h>
#include <cstdint>
#include <vector>

#if CUDART_VERSION < 12080
#error "an IF node with an else body needs the CUDA 12.8 runtime or later"
#endif

// cond_until: the loop goes on while the count of live iterations is under
// the level's bound and, with the early exit on, the device flag holds.
// In a body (tally not null) it first counts the iteration that just ran.
__global__ void while_cond(cudaGraphConditionalHandle handle,
                           const int* iters, const bool* live, int kmax,
                           int early, long long* tally) {
  if (tally != nullptr) *tally += 1;
  cudaGraphSetConditional(handle,
                          (*iters < kmax && (!early || *live)) ? 1u : 0u);
}

static cudaError_t add_cond(cudaGraph_t graph, cudaGraphNode_t* node,
                            const cudaGraphNode_t* deps, size_t n_deps,
                            cudaGraphConditionalHandle handle,
                            const int* iters, const bool* live, int kmax,
                            int early, long long* tally) {
  void* args[] = {&handle, &iters, &live, &kmax, &early, &tally};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(while_cond);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &p);
}

// A new empty graph, its nodes on `device`.
extern "C" int graph_loop_create(int device, cudaGraph_t* graph) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return cudaGraphCreate(graph, 0);
}

// One level after `*last` (null: the first node): the entry while_cond,
// the WHILE node, and in its body a child node cloned from `body` followed
// by while_cond with the tally. `*last` becomes the WHILE node.
extern "C" int graph_loop_add_level(cudaGraph_t graph, cudaGraphNode_t* last,
                                    cudaGraph_t body, const int* iters,
                                    const bool* live, int kmax, int early,
                                    long long* tally) {
  cudaGraphConditionalHandle handle;
  cudaError_t e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  cudaGraphNode_t entry;
  e = add_cond(graph, &entry, last, *last != nullptr ? 1 : 0, handle, iters,
               live, kmax, early, nullptr);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, &entry, nullptr, 1, &params);
#else
  e = cudaGraphAddNode(&node, graph, &entry, 1, &params);
#endif
  if (e != cudaSuccess) return e;
  cudaGraph_t inner = params.conditional.phGraph_out[0];
  cudaGraphNode_t child, again;
  e = cudaGraphAddChildGraphNode(&child, inner, nullptr, 0, body);
  if (e != cudaSuccess) return e;
  e = add_cond(inner, &again, &child, 1, handle, iters, live, kmax, early,
               tally);
  if (e != cudaSuccess) return e;
  *last = node;
  return cudaSuccess;
}

// A child node cloned from `child` after `*last`; `*last` becomes it.
extern "C" int graph_loop_add_child(cudaGraph_t graph, cudaGraphNode_t* last,
                                    cudaGraph_t child) {
  cudaGraphNode_t node;
  cudaError_t e = cudaGraphAddChildGraphNode(
      &node, graph, last, *last != nullptr ? 1 : 0, child);
  if (e != cudaSuccess) return e;
  *last = node;
  return cudaSuccess;
}

// The executable graph; `*result` the cudaGraphInstantiateResult.
extern "C" int graph_loop_instantiate(cudaGraph_t graph,
                                      cudaGraphExec_t* exec, int* result) {
  cudaGraphInstantiateParams p = {};
  p.flags = 0;
  cudaError_t e = cudaGraphInstantiateWithParams(exec, graph, &p);
  *result = static_cast<int>(p.result_out);
  return e;
}

extern "C" int graph_loop_launch(cudaGraphExec_t exec, cudaStream_t stream) {
  cudaError_t e = cudaGraphLaunch(exec, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" int graph_loop_destroy(cudaGraph_t graph, cudaGraphExec_t exec) {
  cudaError_t e = cudaSuccess;
  if (exec != nullptr) e = cudaGraphExecDestroy(exec);
  if (graph != nullptr) {
    cudaError_t e2 = cudaGraphDestroy(graph);
    if (e == cudaSuccess) e = e2;
  }
  return e;
}

// The driver's cuGraphNodeGetType (CUgraphNodeType has cudaGraphNodeType's
// values): the runtime's cudaGraphNodeGetType fails (cudaErrorUnknown) on
// a conditional node of a graph that PyTorch captured, on the H100's
// driver 580 with nvcc 12.9's static cudart.
typedef int (*node_get_type_fn)(cudaGraphNode_t, int*);

static cudaError_t node_get_type(node_get_type_fn* fn) {
  if (*fn != nullptr) return cudaSuccess;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuGraphNodeGetType", &p, 12000, cudaEnableDefault, &found);
  if (e != cudaSuccess) return e;
  if (found != cudaDriverEntryPointSuccess) return cudaErrorSymbolNotFound;
  *fn = reinterpret_cast<node_get_type_fn>(p);
  return cudaSuccess;
}

// The types (cudaGraphNodeType) of `graph`'s nodes, in the order
// cudaGraphGetNodes gives them, into types[0 .. cap); *n the node count.
extern "C" int graph_loop_node_types(cudaGraph_t graph, int* types,
                                     size_t cap, size_t* n) {
  static node_get_type_fn get_type = nullptr;
  cudaError_t e = cudaGraphGetNodes(graph, nullptr, n);
  if (e != cudaSuccess) return e;
  std::vector<cudaGraphNode_t> nodes(*n);
  if (*n == 0 || cap == 0) return cudaSuccess;
  e = cudaGraphGetNodes(graph, nodes.data(), n);
  if (e != cudaSuccess) return e;
  e = node_get_type(&get_type);
  if (e != cudaSuccess) return e;
  for (size_t i = 0; i < *n && i < cap; ++i) {
    if (get_type(nodes[i], &types[i]) != 0) return cudaErrorUnknown;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// lax.cond inside a capture under way

// The flag picks the branch: the then body (handle 1) where it holds, the
// else body (handle 0) where not; tally[0] counts the then branch's runs,
// tally[1] the else branch's.
__global__ void if_cond(cudaGraphConditionalHandle handle, const bool* flag,
                        long long* tally) {
  const bool f = *flag;
  if (tally != nullptr) tally[f ? 0 : 1] += 1;
  cudaGraphSetConditional(handle, f ? 1u : 0u);
}

// The stream IF node bodies are captured from on `device`, a stream of
// its own (PyTorch's torch.cuda.Stream hands out a pool of streams round
// robin, one of which an owner may be capturing on), and if_cond loaded
// there: with lazy module loading its first launch, which is inside a
// capture (the eager path never launches it), would load it.
extern "C" int graph_cond_stream(int device, cudaStream_t* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, if_cond);
  if (e != cudaSuccess) return e;
  return cudaStreamCreateWithFlags(stream, cudaStreamNonBlocking);
}

// The graph under capture on `stream` and the capture's current
// dependencies (valid until the next call on the stream).
static cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
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
             ? cudaSuccess : cudaErrorStreamCaptureUnmatched;
}

// In the capture under way on `stream`: if_cond, then an IF node with an
// else body after it; the capture goes on after the node. bodies[0] (run
// where *flag) and bodies[1] (else) are the node's empty body graphs, for
// graph_cond_body_begin.
extern "C" int graph_cond_add(cudaStream_t stream, const bool* flag,
                              long long* tally, cudaGraph_t* bodies) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t e = capture_info(stream, &graph, &deps, &n);
  if (e != cudaSuccess) return e;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  if_cond<<<1, 1, 0, stream>>>(handle, flag, tally);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = capture_info(stream, &graph, &deps, &n);   // now: the if_cond node
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 2;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
#else
  e = cudaGraphAddNode(&node, graph, deps, n, &params);
#endif
  if (e != cudaSuccess) return e;
#if CUDART_VERSION >= 13000
  e = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                          cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return e;
  bodies[0] = params.conditional.phGraph_out[0];
  bodies[1] = params.conditional.phGraph_out[1];
  return cudaSuccess;
}

// What `stream` launches from now on is captured into `body` (a branch of
// an IF node), until graph_cond_body_end.
extern "C" int graph_cond_body_begin(cudaStream_t stream, cudaGraph_t body) {
  return cudaStreamBeginCaptureToGraph(stream, body, nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

extern "C" int graph_cond_body_end(cudaStream_t stream) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(stream, &graph);
}

extern "C" const char* graph_loop_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
