// Probe of the thread-block-cluster primitives the bucket kernel is built
// from, on one Hopper card: shared-memory atomics (local and through
// distributed shared memory), remote mbarrier arrives, cluster barriers
// and distributed-shared-memory loads.
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o probe_cluster dryad_tpu_torch/tools/probe_cluster.cu && ./probe_cluster
//
// Every mode runs the same grid: as many clusters of C blocks as the
// card's SMs hold (132 / C), 16 warps a block, one block an SM (the
// shared memory it asks for), each warp running ITERS iterations of the
// operation over a table of T 64-bit words a block.  Where fewer
// clusters fit at once ("active_clusters" x C < blocks) the grid runs
// in two waves.  Prints one JSON line a (mode, C): the kernel time and
// the operations per second over the whole card (a warp-wide
// instruction counts 32 operations).

#include <cooperative_groups.h>
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define ITERS 2048
#define T_WORDS 16384  // 128 KB of table a block
#define WARPS 16

enum Mode {
  LOCAL_U32, LOCAL_U64, REMOTE_U32, REMOTE_U64, REMOTE_RED_U32_PTX, FENCE_CLUSTER,
  ARRIVE_REMOTE_CTA, ARRIVE_REMOTE_CLUSTER, CLUSTER_SYNC, REMOTE_LOAD_V4, N_MODES
};
static const char* kNames[] = {
    "local atomicAdd u32", "local atomicAdd u64", "dsmem atomicAdd u32 (generic pointer)",
    "dsmem atomicAdd u64 (generic pointer)", "dsmem red.shared::cluster.add.u32",
    "fence.acq_rel.cluster + local atomic",
    "remote mbarrier arrive (release.cta), lanes 0..C-1 of a warp",
    "remote mbarrier arrive (release.cluster), lanes 0..C-1 of a warp",
    "cluster.sync()", "dsmem 16-byte load"};

__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__global__ void probe(int mode, unsigned long long* sink) {
  extern __shared__ __align__(16) unsigned long long tab[];
  __shared__ __align__(8) uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks();
  for (int i = threadIdx.x; i < T_WORDS; i += blockDim.x) tab[i] = 0ull;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(&bar)),
                 "r"((1u << 20) - 1u));  // the largest count; a run arrives 2^19 times at most
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  const uint32_t seed = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u;
  unsigned long long acc = 0ull;
  unsigned* tab32 = reinterpret_cast<unsigned*>(tab);
  for (int it = 0; it < ITERS; ++it) {
    const uint32_t h = hash32(seed + it);
    const unsigned idx = h % T_WORDS;
    const unsigned owner = (h >> 20) % C;
    switch (mode) {
      case LOCAL_U32: atomicAdd(tab32 + idx, 1u); break;
      case LOCAL_U64: atomicAdd(tab + idx, 1ull); break;
      case REMOTE_U32: atomicAdd(cluster.map_shared_rank(tab32, owner) + idx, 1u); break;
      case REMOTE_U64: atomicAdd(cluster.map_shared_rank(tab, owner) + idx, 1ull); break;
      case REMOTE_RED_U32_PTX: {
        uint32_t a = (uint32_t)__cvta_generic_to_shared(tab32 + idx), r;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(owner));
        asm volatile("red.shared::cluster.add.u32 [%0], %1;" ::"r"(r), "r"(1u) : "memory");
        break;
      }
      case FENCE_CLUSTER:
        atomicAdd(tab32 + idx, 1u);
        asm volatile("fence.acq_rel.cluster;" ::: "memory");
        break;
      case ARRIVE_REMOTE_CTA:
      case ARRIVE_REMOTE_CLUSTER:
        atomicAdd(tab32 + idx, 1u);
        if ((threadIdx.x & 31) < C) {
          uint32_t a = (uint32_t)__cvta_generic_to_shared(&bar), r;
          asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                       : "=r"(r) : "r"(a), "r"(threadIdx.x & 31));
          if (mode == ARRIVE_REMOTE_CTA)
            asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(r) : "memory");
          else
            asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(r)
                         : "memory");
        }
        break;
      case CLUSTER_SYNC:
        if (it % 32 == 0) cluster.sync();  // 64 cluster barriers a run
        atomicAdd(tab32 + idx, 1u);
        break;
      case REMOTE_LOAD_V4: {
        const uint4* src = reinterpret_cast<const uint4*>(cluster.map_shared_rank(tab, owner));
        const uint4 v = src[(idx / 2)];
        acc += v.x ^ v.w;
        break;
      }
    }
  }
  cluster.sync();
  if (acc == 0x12345ull) sink[0] = acc;
}

int main() {
  unsigned long long* sink;
  cudaMalloc(&sink, 8);
  const int smem = T_WORDS * 8 + 64 * 1024;  // forces one block an SM
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const int Cs[] = {2, 4, 8, 16};
  for (int mode = 0; mode < N_MODES; ++mode) {
    for (int ci = 0; ci < 4; ++ci) {
      const int C = Cs[ci];
      cudaLaunchConfig_t cfg = {};
      const int clusters = prop.multiProcessorCount / C;
      cfg.gridDim = dim3(C * clusters, 1, 1);
      cfg.blockDim = dim3(32 * WARPS, 1, 1);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = C;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int active = 0;
      cudaOccupancyMaxActiveClusters(&active, probe, &cfg);
      cudaEvent_t a, b;
      cudaEventCreate(&a);
      cudaEventCreate(&b);
      cudaLaunchKernelEx(&cfg, probe, mode, sink);  // warm-up
      cudaEventRecord(a);
      const int reps = 5;
      for (int r = 0; r < reps; ++r) cudaLaunchKernelEx(&cfg, probe, mode, sink);
      cudaEventRecord(b);
      cudaError_t err = cudaEventSynchronize(b);
      if (err == cudaSuccess) err = cudaGetLastError();
      float ms = 0.f;
      cudaEventElapsedTime(&ms, a, b);
      ms /= reps;
      const double ops = (double)cfg.gridDim.x * 32 * WARPS * ITERS;
      printf("{\"mode\": \"%s\", \"cluster\": %d, \"blocks\": %d, \"active_clusters\": %d, "
             "\"ms\": %.4f, \"ops_per_s\": %.4g, \"ns_per_warp_op\": %.2f, \"error\": \"%s\"}\n",
             kNames[mode], C, cfg.gridDim.x, active, ms, ops / (ms * 1e-3),
             ms * 1e6 / ITERS, cudaGetErrorString(err));
      fflush(stdout);
    }
  }
  return 0;
}
