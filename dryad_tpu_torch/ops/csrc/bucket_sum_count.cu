// Dense-key bucket reduction for Hopper (sm_90a): per partition, the row
// count and each value column's sum for every bucket k in [0, Kp).
//
// Replaces the TPU kernel dryad_tpu/ops/pallas_bucket.py::_make_kernel
// (launched by pl.pallas_call in bucket_sum_count), which computes the
// same tables as a factorised one-hot bf16 matrix product on the MXU.
// A one-hot product spends Kp/16 tensor-core operations per row to place
// one value; on a GPU a bucket table in shared memory places it with one
// add, so this kernel scatters instead of multiplying.
//
// Layout: keys int32, valid bool (one byte), values int32 or float32,
// all (P, cap) row-major; every partition is reduced on its own (the
// caller rounds each partition's counts before summing partitions, which
// keeps global counts exact past 2^24).
//
// Design (partial tables, two kernels, deterministic by construction):
//  1. bucket_partials: a block owns (bucket tile, row chunk, partition).
//     Its warps stride over the chunk 32 rows at a time in a fixed
//     order, issuing the loads of DN_UNROLL steps together so their
//     latencies overlap.  Counts: every row in the tile adds 1 to the
//     block's shared uint32 table with an integer atomic (integer adds
//     commute, so the order does not change the bytes).  Sums go to the
//     WARP's private float table, which no other warp touches: a step
//     with one row in the tile adds it directly; otherwise equal keys
//     are grouped (__match_any_sync), each group summed in ascending
//     lane order, and the group's lowest lane adds the sum.  At the end the block adds the warp tables in warp order
//     and writes one partial table per (partition, chunk).
//  2. bucket_combine: sums the partials over chunks in chunk order and
//     writes f32 counts and sums.
//  No float atomic exists anywhere, so equal inputs give equal bytes.
//  Float sums accumulate in f32 directly (more exact than the TPU's
//  split-bf16 terms); integer values convert to f32 once per row, so
//  integer sums are exact while a bucket's partition total is <= 2^24.
//
// Bound on this card: bytes, rows * (4 key + 1 valid + 4 per value
// column) plus the output tables, against 3.35 TB/s.  What keeps it off
// that bound: a block re-reads its chunk once per bucket tile (the tile
// is capped by shared memory, per-warp value tables most of all), which
// L2 absorbs when the blocks of one chunk run together (tile is the
// fastest grid axis); a hot key serialises its shared-memory atomics;
// steps with several rows in a tile pay for grouping their keys.
// Making it fast (sorted tiles, TMA) is later work.

#include <cstdint>
#include <cuda_runtime.h>

#define DN_MAX_VALS 8
#define DN_UNROLL 8  // row steps whose loads are issued together

struct ValPtrs {
  const void* p[DN_MAX_VALS];
};

// Value column j of row i as f32 (int32 columns convert, rounding to
// nearest as the reference's astype(float32) does).
static __device__ __forceinline__ float load_value(const ValPtrs& vals,
                                                   unsigned int_mask, int j,
                                                   long long i) {
  return ((int_mask >> j) & 1u)
             ? (float)static_cast<const int32_t*>(vals.p[j])[i]
             : static_cast<const float*>(vals.p[j])[i];
}

static __global__ void bucket_partials(
    const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
    ValPtrs vals, unsigned int_mask, int m, long long cap, int Kp, int tile,
    long long chunk_rows, int n_chunks, unsigned* __restrict__ pcnt,
    float* __restrict__ psum) {
  extern __shared__ unsigned char smem[];
  unsigned* cnt = reinterpret_cast<unsigned*>(smem);           // [tile]
  float* wsum = reinterpret_cast<float*>(smem) + tile;          // [W][m][tile]
  const int W = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * tile;
  const int tn = min(tile, Kp - t0);
  const int c = blockIdx.y;
  const int p = blockIdx.z;
  const unsigned FULL = 0xffffffffu;

  const int table_words = tile * (1 + W * m);
  for (int i = threadIdx.x; i < table_words; i += blockDim.x) {
    reinterpret_cast<unsigned*>(smem)[i] = 0u;  // 0u is also +0.0f
  }
  __syncthreads();

  const long long r0 = (long long)c * chunk_rows;
  const long long r1 = min(cap, r0 + chunk_rows);
  const long long base_p = (long long)p * cap;
  float* mysum = wsum + (size_t)warp * m * tile;

  // A warp walks rows base, base + W*32, base + 2*W*32, ... (lane = row
  // offset), DN_UNROLL steps at a time: the keys and valid bytes of all
  // the steps are loaded first, so their latencies overlap, then the
  // steps are processed in the same order as a one-step loop would.
  const long long stride = (long long)W * 32;
  for (long long base0 = r0 + (long long)warp * 32; base0 < r1;
       base0 += stride * DN_UNROLL) {
    int kk[DN_UNROLL];
    bool in[DN_UNROLL];
#pragma unroll
    for (int u = 0; u < DN_UNROLL; ++u) {
      const long long r = base0 + u * stride + lane;
      const bool ok = r < r1;
      const int k = ok ? keys[base_p + r] : 0;
      const bool v = ok && valid[base_p + r];
      kk[u] = k - t0;
      in[u] = v && kk[u] >= 0 && kk[u] < tn;
    }
#pragma unroll
    for (int u = 0; u < DN_UNROLL; ++u) {
      if (in[u]) atomicAdd(&cnt[kk[u]], 1u);
      if (m == 0) continue;
      const unsigned todo = __ballot_sync(FULL, in[u]);
      if (todo == 0u) continue;
      const long long r = base0 + u * stride + lane;
      if ((todo & (todo - 1u)) == 0u) {
        // one row of this step is in the tile: it adds its own values
        if (in[u]) {
          for (int j = 0; j < m; ++j) {
            mysum[(size_t)j * tile + kk[u]] += load_value(vals, int_mask, j, base_p + r);
          }
        }
        continue;
      }
      // Several rows: group equal keys; each group's values are summed in
      // ascending lane order and its lowest lane adds the sum (a singleton
      // adds -0.0 + v == v, the same bits as the one-row path above).
      const unsigned grp = __match_any_sync(FULL, in[u] ? kk[u] : -1 - lane);
      const bool leader = in[u] && (__ffs(grp) - 1) == lane;
      const bool shared_key = __any_sync(FULL, in[u] && __popc(grp) > 1);
      for (int j = 0; j < m; ++j) {
        const float v = in[u] ? load_value(vals, int_mask, j, base_p + r) : 0.0f;
        float acc = v;
        if (shared_key) {
          acc = -0.0f;
          for (int s = 0; s < 32; ++s) {
            const float x = __shfl_sync(FULL, v, s);
            if ((grp >> s) & 1u) acc += x;
          }
        }
        if (leader) mysum[(size_t)j * tile + kk[u]] += acc;
      }
    }
  }
  __syncthreads();

  const size_t part = ((size_t)p * n_chunks + c) * Kp + t0;
  const size_t plane = (size_t)gridDim.z * n_chunks * Kp;
  for (int b = threadIdx.x; b < tn; b += blockDim.x) {
    pcnt[part + b] = cnt[b];
    for (int j = 0; j < m; ++j) {
      float s = wsum[(size_t)j * tile + b];
      for (int w = 1; w < W; ++w) s += wsum[((size_t)w * m + j) * tile + b];
      psum[(size_t)j * plane + part + b] = s;
    }
  }
}

static __global__ void bucket_combine(const unsigned* __restrict__ pcnt,
                                      const float* __restrict__ psum, int m,
                                      int P, int n_chunks, int Kp,
                                      float* __restrict__ cnt_out,
                                      float* __restrict__ sum_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)P * Kp) return;
  const long long p = i / Kp;
  const long long k = i - p * Kp;
  const size_t first = (size_t)p * n_chunks * Kp + k;
  unsigned cnt = 0;
  for (int ch = 0; ch < n_chunks; ++ch) cnt += pcnt[first + (size_t)ch * Kp];
  cnt_out[i] = (float)cnt;
  const size_t plane = (size_t)P * n_chunks * Kp;
  for (int j = 0; j < m; ++j) {
    float s = psum[j * plane + first];
    for (int ch = 1; ch < n_chunks; ++ch) s += psum[j * plane + first + (size_t)ch * Kp];
    sum_out[(size_t)j * P * Kp + i] = s;
  }
}

extern "C" int dn_bucket_max_vals() { return DN_MAX_VALS; }

// Launches both kernels on `stream`.  Returns 0 or the cudaError_t of the
// first failed launch.  Scratch (pcnt: P*n_chunks*Kp uint32, psum:
// m*P*n_chunks*Kp float) and outputs (cnt_out: P*Kp, sum_out: m*P*Kp
// float) are allocated by the caller.
extern "C" int dn_bucket_sum_count(
    const void* keys, const void* valid, const void* const* vals,
    unsigned int_mask, int m, int P, long long cap, int Kp, int tile,
    int n_chunks, long long chunk_rows, int threads, void* pcnt, void* psum,
    void* cnt_out, void* sum_out, void* stream) {
  if (m < 0 || m > DN_MAX_VALS || P < 1 || Kp < 1 || tile < 1 ||
      n_chunks < 1 || threads < 32 || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  ValPtrs vp = {};
  for (int j = 0; j < m; ++j) vp.p[j] = vals[j];
  const size_t smem = (size_t)tile * 4 * (1 + (size_t)(threads / 32) * m);
  cudaError_t err = cudaFuncSetAttribute(
      bucket_partials, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Kp + tile - 1) / tile, n_chunks, P);
  bucket_partials<<<grid, threads, smem, s>>>(
      static_cast<const int32_t*>(keys), static_cast<const uint8_t*>(valid), vp,
      int_mask, m, cap, Kp, tile, chunk_rows, n_chunks,
      static_cast<unsigned*>(pcnt), static_cast<float*>(psum));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)P * Kp;
  const int cb = 256;
  bucket_combine<<<(unsigned)((total + cb - 1) / cb), cb, 0, s>>>(
      static_cast<const unsigned*>(pcnt), static_cast<const float*>(psum), m, P,
      n_chunks, Kp, static_cast<float*>(cnt_out), static_cast<float*>(sum_out));
  return (int)cudaGetLastError();
}

extern "C" const char* dn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
