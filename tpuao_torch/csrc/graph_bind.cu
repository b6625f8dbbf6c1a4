// A captured frame graph bound to a call's own buffers
// (tpuao_torch/models/frame_graph.py).
//
// A captured launch keeps the pointers it was captured with.  Of a frame
// program's launches two touch the caller's buffers: the prologue
// (prepare.cu), the one launch that reads the depth and the normals, and
// the last chain step (upsample.cu or fused.cu), which writes the cropped
// output.  tpuao_graph_find finds their nodes in the captured graph and
// keeps their parameters; tpuao_graph_bind points them, in the
// instantiated graph, at a call's depth, normals and output before its
// launch, so a replay copies nothing in and clones nothing out.  Nothing
// else changes: grids, tiles and every other argument stay as captured.
//
// Launches nothing.  Cost: two cudaGraphExecKernelNodeSetParams a replay.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include <cuda_runtime.h>

#include "chain_step.cuh"
#include "prepare.cuh"

namespace tpuao {

constexpr int kMaxBoundParams = 4;  // fused_step_kernel's

// What tpuao_graph_find keeps of the two nodes.  The parameters are as
// captured; kernelParams of each points into its node in the captured
// graph, which must outlive the binding.
struct GraphBinding {
  cudaGraphNode_t prologue;  // null: the inputs are not bound
  cudaGraphNode_t output;    // null: the output is not bound
  cudaKernelNodeParams pp, po;
  int po_count;  // the output kernel's parameters
  PrepareArgs pa;
  ChainArgs oa;
};

inline bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// Params of a kernel node launched through the runtime, or false (the
// query's error is cleared).
inline bool kernel_params(cudaGraphNode_t node, cudaKernelNodeParams& p) {
  cudaGraphNodeType type;
  if (cudaGraphNodeGetType(node, &type) != cudaSuccess ||
      type != cudaGraphNodeTypeKernel ||
      cudaGraphKernelNodeGetParams(node, &p) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return p.kernelParams != nullptr && p.extra == nullptr;
}

}  // namespace tpuao

// graph: a captured cudaGraph_t of one frame program.  depth, normals: the
// inputs it was captured with (depth null: bind no input; normals null:
// none); out: its output, dense, numel floats (null: bind no output).
// binding: `bytes` bytes of the caller's, which this fills.  The prologue
// node is the one prepare_levels_kernel node that reads depth and normals;
// the output node is the one chain-step node that writes out, all numel
// floats of it, with no node after it.  Returns 1 where it found the
// prologue node, plus 2 where it found the output node, and -1 where
// `bytes` are too few.
extern "C" int tpuao_graph_find(void* graph, const float* depth,
                                const float* normals, float* out,
                                long long numel, void* binding, int bytes) {
  using namespace tpuao;
  if (binding == nullptr || bytes < static_cast<int>(sizeof(GraphBinding)))
    return -1;
  GraphBinding b;
  std::memset(&b, 0, sizeof(b));
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  std::vector<cudaGraphNode_t> nodes;
  if (cudaGraphGetNodes(g, nullptr, &n) == cudaSuccess) {
    nodes.resize(n);
    if (n && cudaGraphGetNodes(g, nodes.data(), &n) != cudaSuccess) n = 0;
  }
  cudaGetLastError();
  int prologues = 0, outputs = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaKernelNodeParams p;
    if (!kernel_params(nodes[i], p)) continue;
    if (is_prepare_kernel(p.func)) {
      const PrepareArgs& a =
          *static_cast<const PrepareArgs*>(p.kernelParams[0]);
      if (depth != nullptr && a.depth == depth && a.nrm == normals) {
        ++prologues;
        b.prologue = nodes[i];
        b.pp = p;
        b.pa = a;
      }
      continue;
    }
    const int count = std::max(upsample_kernel_params(p.func),
                               fused_kernel_params(p.func));
    if (count == 0) continue;
    const ChainArgs& a = *static_cast<const ChainArgs*>(p.kernelParams[0]);
    if (out == nullptr || a.out != out) continue;
    ++outputs;
    size_t after = 1;
    cudaGraphNodeGetDependentNodes(nodes[i], nullptr, &after);
    cudaGetLastError();
    if (after == 0 &&
        static_cast<long long>(p.gridDim.z) * a.h0 * a.w0 == numel) {
      b.output = nodes[i];
      b.po = p;
      b.po_count = count;
      b.oa = a;
    }
  }
  if (prologues != 1) b.prologue = nullptr;
  if (outputs != 1) b.output = nullptr;
  std::memcpy(binding, &b, sizeof(b));
  return (b.prologue != nullptr ? 1 : 0) | (b.output != nullptr ? 2 : 0);
}

// exec: the instantiation of the graph that tpuao_graph_find read into
// binding.  Points its prologue node (where found) at depth and normals and
// its output node (where found) at out, for the launches of exec from now
// on; launches under way keep what they had.  Returns the cudaError_t:
// cudaErrorInvalidValue for inputs the captured prologue cannot read (a
// missing pointer, or a misaligned one where it was captured with 16-byte
// loads).
extern "C" int tpuao_graph_bind(void* exec, const void* binding,
                                const float* depth, const float* normals,
                                float* out) {
  using namespace tpuao;
  GraphBinding b;
  std::memcpy(&b, binding, sizeof(b));
  cudaGraphExec_t e = static_cast<cudaGraphExec_t>(exec);
  cudaError_t err = cudaSuccess;
  if (b.prologue != nullptr) {
    if (depth == nullptr || (b.pa.nrm == nullptr) != (normals == nullptr) ||
        (b.pa.vec_depth && !aligned16(depth)) ||
        (b.pa.vec_nrm && !aligned16(normals)))
      return cudaErrorInvalidValue;
    PrepareArgs a = b.pa;
    a.depth = depth;
    a.nrm = normals;
    void* args[2] = {&a, b.pp.kernelParams[1]};
    cudaKernelNodeParams p = b.pp;
    p.kernelParams = args;
    err = cudaGraphExecKernelNodeSetParams(e, b.prologue, &p);
  }
  if (err == cudaSuccess && b.output != nullptr) {
    if (out == nullptr) return cudaErrorInvalidValue;
    ChainArgs a = b.oa;
    a.out = out;
    void* args[kMaxBoundParams] = {&a};
    for (int i = 1; i < b.po_count; ++i) args[i] = b.po.kernelParams[i];
    cudaKernelNodeParams p = b.po;
    p.kernelParams = args;
    err = cudaGraphExecKernelNodeSetParams(e, b.output, &p);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}
