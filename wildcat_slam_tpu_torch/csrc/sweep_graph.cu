// A sweep's captured CUDA graphs composed into one device program
// (odometry/graph.py, SweepGraph): the counterpart of the JAX package's
// jax.jit(process_sweep), whose LM loop is a lax.while_loop on the device
// (wildcat_slam_tpu/odometry/solver.py) with the re-linearisation in a
// lax.cond. Not a kernel port: the torch on the card's machine captures
// graphs but offers no conditional nodes, so the captured graphs (the code
// before the LM loop, one LM step, one re-linearisation, the code after it)
// are put together here with the CUDA runtime's graph API:
//
//   [before] -> memset(iteration = 0) -> WHILE(loop) { [LM step] ->
//     lm_decide_kernel -> IF(relin) { [re-linearisation] } } -> [after]
//
// The LM step writes two device flags, (re-linearise, done); the one-thread
// lm_decide_kernel reads them and sets the conditions: re-linearise after an
// accepted step that is not final; loop again while not done and fewer than
// max_iterations steps ran. That is solver.lm_loop_eager's decision, taken on
// the card, so a sweep is one graph launch with no host sync inside.
// Each captured graph enters as a child graph node (a copy of it).

#include <cuda_runtime.h>

namespace {

// A failed graph call leaves its error as the thread's last error, which the
// kernels' entries read after their launches: clear it, return it.
int result(cudaError_t e) {
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

__global__ void lm_decide_kernel(const bool* flags, int* iteration, int max_iterations,
                                 cudaGraphConditionalHandle loop, cudaGraphConditionalHandle relin) {
  const bool done = flags[1];
  const int it = *iteration + 1;
  *iteration = it;
  cudaGraphSetConditional(relin, (!done && flags[0]) ? 1u : 0u);
  cudaGraphSetConditional(loop, (!done && it < max_iterations) ? 1u : 0u);
}

// The node that follows *last (or the first node), then it becomes *last.
cudaError_t add_child(cudaGraph_t graph, cudaGraphNode_t* last, cudaGraph_t child) {
  cudaGraphNode_t node;
  cudaError_t e = cudaGraphAddChildGraphNode(&node, graph, *last ? last : nullptr, *last ? 1 : 0,
                                             child);
  if (e == cudaSuccess) *last = node;
  return e;
}

cudaError_t add_conditional(cudaGraph_t graph, cudaGraphNode_t* last,
                            cudaGraphConditionalHandle handle, cudaGraphConditionalNodeType type,
                            cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = type;
  p.conditional.size = 1;
  cudaGraphNode_t node;
  cudaError_t e = cudaGraphAddNode(&node, graph, *last ? last : nullptr, *last ? 1 : 0, &p);
  if (e != cudaSuccess) return e;
  *last = node;
  *body = p.conditional.phGraph_out[0];
  return cudaSuccess;
}

}  // namespace

// An empty graph to compose into. Returns a cudaError_t code (0 on success).
extern "C" int wc_graph_create(void** graph) {
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  *graph = g;
  return result(e);
}

// Append a copy of `child` (a captured cudaGraph_t) after the node *last
// (null: as the first node); *last becomes the new node.
extern "C" int wc_graph_add_child(void* graph, void** last, void* child) {
  return result(add_child(static_cast<cudaGraph_t>(graph),
                         reinterpret_cast<cudaGraphNode_t*>(last), static_cast<cudaGraph_t>(child)));
}

// Append an LM loop after *last: `step` (writes flags[0] = re-linearise,
// flags[1] = done, bool, on the device) at most max_iterations times,
// `rebuild` after each step that asks for it. `iteration` is one int of
// device memory the loop counts in. *last becomes the loop's node.
extern "C" int wc_graph_add_lm_loop(void* graph, void** last, void* step, void* rebuild,
                                    const void* flags, void* iteration, int max_iterations) {
  if (max_iterations < 1) return (int)cudaErrorInvalidValue;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphNode_t* tail = reinterpret_cast<cudaGraphNode_t*>(last);
  cudaMemsetParams zero = {};
  zero.dst = iteration;
  zero.value = 0;
  zero.elementSize = 4;
  zero.width = 1;
  zero.height = 1;
  cudaGraphNode_t node;
  cudaError_t e = cudaGraphAddMemsetNode(&node, g, *tail ? tail : nullptr, *tail ? 1 : 0, &zero);
  if (e != cudaSuccess) return result(e);
  *tail = node;
  // the loop's condition starts at 1 on every launch: the first step always runs
  cudaGraphConditionalHandle loop, relin;
  e = cudaGraphConditionalHandleCreate(&loop, g, 1, cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return result(e);
  cudaGraph_t body;
  e = add_conditional(g, tail, loop, cudaGraphCondTypeWhile, &body);
  if (e != cudaSuccess) return result(e);
  // the IF node lives in the loop's body, so its handle belongs to that graph;
  // lm_decide_kernel sets it before the node every iteration
  e = cudaGraphConditionalHandleCreate(&relin, body, 0, 0);
  if (e != cudaSuccess) return result(e);
  cudaGraphNode_t in_body = nullptr;
  e = add_child(body, &in_body, static_cast<cudaGraph_t>(step));
  if (e != cudaSuccess) return result(e);
  const bool* f = static_cast<const bool*>(flags);
  int* it = static_cast<int*>(iteration);
  void* args[] = {&f, &it, &max_iterations, &loop, &relin};
  cudaKernelNodeParams k = {};
  k.func = (void*)lm_decide_kernel;
  k.gridDim = dim3(1);
  k.blockDim = dim3(1);
  k.kernelParams = args;
  e = cudaGraphAddKernelNode(&node, body, &in_body, 1, &k);
  if (e != cudaSuccess) return result(e);
  in_body = node;
  cudaGraph_t relin_body;
  e = add_conditional(body, &in_body, relin, cudaGraphCondTypeIf, &relin_body);
  if (e != cudaSuccess) return result(e);
  cudaGraphNode_t in_relin = nullptr;
  return result(add_child(relin_body, &in_relin, static_cast<cudaGraph_t>(rebuild)));
}

extern "C" int wc_graph_instantiate(void* graph, void** exec) {
  cudaGraphExec_t x = nullptr;
  cudaError_t e = cudaGraphInstantiate(&x, static_cast<cudaGraph_t>(graph), 0);
  *exec = x;
  return result(e);
}

extern "C" int wc_graph_launch(void* exec, void* stream) {
  return result(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                static_cast<cudaStream_t>(stream)));
}

// Free a composed graph and its executable (either may be null).
extern "C" int wc_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = e2;
  }
  return result(e);
}

// The node count of a cudaGraph_t (its top level). Returns a cudaError_t code.
extern "C" int wc_graph_nodes(void* graph, unsigned long long* nodes) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  *nodes = (unsigned long long)n;
  return result(e);
}
