// The tracking loop's lax.while_loop as one CUDA graph: a WHILE
// conditional node per level, its body the level's captured iteration
// graph, the condition decided on the card by while_cond.
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
// What bounds while_cond: nothing of the card's rates: one thread reads 5
// bytes and sets the handle; its cost is one kernel node's launch inside
// the graph (a few microseconds), once per iteration.
//
// The C functions return the cudaError_t of the first call that failed
// (0 on success); the Python wrappers (ops/graph_loop.py) raise on it.
#include <cuda_runtime.h>
#include <cstdint>
#include <vector>

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

// The types (cudaGraphNodeType) of `graph`'s nodes, in the order
// cudaGraphGetNodes gives them, into types[0 .. cap); *n the node count.
extern "C" int graph_loop_node_types(cudaGraph_t graph, int* types,
                                     size_t cap, size_t* n) {
  cudaError_t e = cudaGraphGetNodes(graph, nullptr, n);
  if (e != cudaSuccess) return e;
  std::vector<cudaGraphNode_t> nodes(*n);
  if (*n == 0) return cudaSuccess;
  e = cudaGraphGetNodes(graph, nodes.data(), n);
  if (e != cudaSuccess) return e;
  for (size_t i = 0; i < *n && i < cap; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    if (e != cudaSuccess) return e;
    types[i] = static_cast<int>(t);
  }
  return cudaSuccess;
}

extern "C" const char* graph_loop_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
