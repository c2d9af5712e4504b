// The JAX package's lax.conds inside a CUDA graph: kernel cond_set and
// the host entry points that build a conditional IF node.
//
// Replaces no pallas_call.  It carries two lax.conds of the JAX package
// into the port's CUDA graphs.  (1) The incremental-or-exact slot rebuild
// (particlerobotsimulations_tpu/engine_table.py:274 _smart_rebuild, :299
// _smart_rebuild_batched, parallel/spatial_table.py:189 take_inc /
// take_exact): a captured rebuild enqueues the incremental compaction,
// writes its result into the output buffers, then cond_set and an IF
// node whose body graph holds the exact rebuild (which overwrites the
// same buffers).  (2) The span segment's adopt-or-redo (engine_table.py
// :908 and :1370): an IF node with an else branch, whose bodies are the
// regular segment redone from the segment's entry and the closing post
// that adopts the spans.  Nodes nest: the redo body runs the redone
// segment's ungated blocks under a WHILE node (JAX's lax.scan inside
// regular_seg), one block captured once, and the rebuilds are IF nodes
// inside.  cond_set reads the device flag `ok` and sets the node's handle
// to !ok, so a replay runs an IF node's first body only when `ok` is
// false (and the else body only when it holds), and a WHILE body until a
// cond_set at its end reads a true `ok`; the host reads nothing.  The
// plain forms beside them (ops/cond.py) run both branches and select with
// torch.where, read the flag, or loop on the host.
//
// What bounds it on the card: launch latency.  One thread reads one byte
// and sets one handle (1 byte in, nothing written to memory); the cost is
// the launch and the node's evaluation, a few microseconds, paid once per
// rebuild.  The design keeps it at one launch: the predicate is computed
// by the rebuild's own ops, and cond_set only hands it to the node.
//
// Entry points (plain C, each returns a cudaError_t; `stream` is a
// cudaStream_t that a CUDA graph capture is under way on, as a pointer):
//   pbot_cond_handle      a conditional handle in the graph `stream` is
//                         capturing (default 0, reset at every launch)
//   pbot_cond_set         enqueue cond_set(handle, ok) on `stream`
//   pbot_cond_node        add an IF node (size 1), an IF node with an
//                         else branch (size 2) or a WHILE node (loop) on
//                         the capture's current dependencies, make it the
//                         capture's sole dependency, hand back its body
//                         graphs
//   pbot_cond_body_begin  begin capturing a stream into that body graph
//   pbot_cond_body_end    end that capture
//
// Conditional nodes need CUDA 12.3 or later where the library is built
// and where it runs, their else branch CUDA 12.8.  CUDA 13 added the edge-data argument to three of
// the calls; both forms build.

#include <cuda_runtime.h>

namespace {

__global__ void cond_set(cudaGraphConditionalHandle handle, const bool* ok) {
  // the body (the exact rebuild) runs where the value is non-zero
  cudaGraphSetConditional(handle, *ok ? 0u : 1u);
}

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
#if CUDART_VERSION >= 13000
  cudaError_t err =
      cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess : cudaErrorIllegalState;
}

}  // namespace

extern "C" int pbot_cond_handle(void* stream, unsigned long long* handle) {
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream), &graph, &deps, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle h = 0;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, cudaGraphCondAssignDefault);
  *handle = h;
  return static_cast<int>(err);
}

extern "C" int pbot_cond_set(unsigned long long handle, const void* ok, void* stream) {
  cond_set<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, static_cast<const bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pbot_cond_node(void* stream, unsigned long long handle, int loop, int size,
                              void** bodies) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (size < 1 || size > 2 || (loop && size != 1))
    return static_cast<int>(cudaErrorInvalidValue);
#if CUDART_VERSION < 12080
  // the IF node's else branch came with CUDA 12.8
  if (size == 2) return static_cast<int>(cudaErrorNotSupported);
#endif
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = loop ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = static_cast<unsigned int>(size);
  cudaGraphNode_t node = nullptr;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < size; ++i) bodies[i] = params.conditional.phGraph_out[i];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  return static_cast<int>(err);
}

extern "C" int pbot_cond_body_begin(void* stream, void* body) {
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(body), nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal));
}

extern "C" int pbot_cond_body_end(void* stream, void* body) {
  cudaGraph_t got = nullptr;
  cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &got);
  if (err != cudaSuccess) return static_cast<int>(err);
  return got == static_cast<cudaGraph_t>(body) ? 0 : static_cast<int>(cudaErrorIllegalState);
}
