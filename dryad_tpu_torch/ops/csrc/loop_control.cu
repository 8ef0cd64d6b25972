// Loop control of the on-device do_while (exec/devloop.py) for Hopper
// (sm_90a), and the graph calls that make a WHILE conditional node.
//
// Replaces no TPU kernel.  The reference runs its on-device do_while as
// one lax.while_loop (dryad_tpu/exec/executor.py::_run_do_while_device),
// whose condition and carry update XLA fuses into the loop program.  The
// port records the whole loop as one CUDA graph: each round runs the
// body's ops, copies their outputs into the carry, runs the condition's
// ops, then this kernel, which computes what the reference's condition
// and carry update compute and sets the graph's WHILE node from it, so
// the host reads nothing while the loop runs.
//
// State: st int64[4] = {i, overflow, miss, pred}, zeroed by the graph
// before the body's first application.  One step:
//   i        <- i + 1                      (body applications so far)
//   overflow <- overflow | body_ovf | cond_ovf
//   miss     <- miss + body_miss           (dictionary misses of the body)
//   pred     <- (i < max_iter) & go & !overflow
// and, with a handle, cudaGraphSetConditional(handle, pred).  go is the
// condition column's first element (partition 0, row 0); go_kind says
// its type: 0 one byte (bool), 1 int32, 2 int64, 3 float32, 4 float64,
// true when nonzero.  A condition that overflows stops the loop at once,
// so or-ing it into the flag reports what the reference's final
// re-evaluation of the condition reports.
//
// Bound: one thread reads 4 flag words and writes 4: launch-bound (a few
// microseconds of launch latency against nanoseconds of work).  Inside a
// graph its launch cost is the graph's per-node cost; nothing here is
// worth making wider.
//
// The graph calls (dl_handle_create, dl_while_begin, dl_while_end) act on
// the stream a PyTorch capture is recording: they add a WHILE node to
// the captured graph and start a second capture into its body graph on
// a new stream, whose work the caller then records (exec/devloop.py).
// They need CUDA 12.4 or later (conditional nodes, capture to a graph).

#include <cuda_runtime.h>

#include <cstdint>

#define DL_HAVE_CONDITIONAL (CUDART_VERSION >= 12040)

__global__ void dl_loop_step_kernel(long long* st, const bool* body_ovf,
                                    const long long* body_miss, const void* go,
                                    int go_kind, const bool* cond_ovf,
                                    long long max_iter,
                                    unsigned long long handle, int has_handle) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  bool g;
  switch (go_kind) {
    case 0: g = *static_cast<const unsigned char*>(go) != 0; break;
    case 1: g = *static_cast<const int*>(go) != 0; break;
    case 2: g = *static_cast<const long long*>(go) != 0; break;
    case 3: g = *static_cast<const float*>(go) != 0.0f; break;
    default: g = *static_cast<const double*>(go) != 0.0; break;
  }
  const long long i = st[0] + 1;
  const long long ovf = st[1] | (*body_ovf ? 1 : 0) | (*cond_ovf ? 1 : 0);
  const long long miss = st[2] + *body_miss;
  const long long pred = (i < max_iter && g && ovf == 0) ? 1 : 0;
  st[0] = i;
  st[1] = ovf;
  st[2] = miss;
  st[3] = pred;
#if DL_HAVE_CONDITIONAL
  if (has_handle) {
    cudaGraphSetConditional(static_cast<cudaGraphConditionalHandle>(handle),
                            static_cast<unsigned int>(pred));
  }
#endif
}

extern "C" int dl_loop_step(void* st, const void* body_ovf, const void* body_miss,
                            const void* go, int go_kind, const void* cond_ovf,
                            long long max_iter, unsigned long long handle,
                            int has_handle, void* stream) {
  if (go_kind < 0 || go_kind > 4) return (int)cudaErrorInvalidValue;
#if !DL_HAVE_CONDITIONAL
  if (has_handle) return (int)cudaErrorNotSupported;
#endif
  dl_loop_step_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(st), static_cast<const bool*>(body_ovf),
      static_cast<const long long*>(body_miss), go, go_kind,
      static_cast<const bool*>(cond_ovf), max_iter, handle, has_handle);
  return (int)cudaGetLastError();
}

extern "C" int dl_runtime_version(int* version) {
  return (int)cudaRuntimeGetVersion(version);
}

#if DL_HAVE_CONDITIONAL

// The graph a stream is capturing into, and the capture's current
// dependencies (the nodes the next captured node follows).
static cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                                const cudaGraphNode_t** deps, size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps,
                                             nullptr, ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, ndeps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorStreamCaptureImplicit;
}

extern "C" int dl_handle_create(void* stream, unsigned long long* handle_out) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream), &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle h;
  // no default: the loop-control kernel ahead of the node always sets it
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  *handle_out = static_cast<unsigned long long>(h);
  return 0;
}

extern "C" int dl_while_begin(void* stream, unsigned long long handle,
                              void** body_stream_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_info(s, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = static_cast<cudaGraphConditionalHandle>(handle);
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &p);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &p);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaStream_t body;
  err = cudaStreamCreateWithFlags(&body, cudaStreamNonBlocking);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamBeginCaptureToGraph(body, p.conditional.phGraph_out[0], nullptr,
                                      nullptr, 0, cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) {
    cudaStreamDestroy(body);
    return (int)err;
  }
  *body_stream_out = body;
  return 0;
}

extern "C" int dl_while_end(void* body_stream) {
  cudaStream_t body = static_cast<cudaStream_t>(body_stream);
  cudaGraph_t g;
  cudaError_t err = cudaStreamEndCapture(body, &g);
  cudaError_t err2 = cudaStreamDestroy(body);
  return (int)(err != cudaSuccess ? err : err2);
}

#else

extern "C" int dl_handle_create(void*, unsigned long long*) {
  return (int)cudaErrorNotSupported;
}
extern "C" int dl_while_begin(void*, unsigned long long, void**) {
  return (int)cudaErrorNotSupported;
}
extern "C" int dl_while_end(void*) { return (int)cudaErrorNotSupported; }

#endif

extern "C" const char* dl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
