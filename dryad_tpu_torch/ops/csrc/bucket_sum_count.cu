// Dense-key bucket reduction for Hopper (sm_90a): per partition, the row
// count and each value column's sum for every bucket k in [0, Kp).
//
// Replaces the TPU kernel dryad_tpu/ops/pallas_bucket.py::_make_kernel
// (launched by pl.pallas_call in bucket_sum_count), which computes the
// same tables as a factorised one-hot bf16 product on the MXU, with each
// value split into bf16 terms (_split_terms) so the MXU can sum them.
// Here each value becomes INTEGER terms, so integer atomics, which
// commute, can sum them: the same inputs give the same bytes whatever
// order the rows arrive in, with no float atomic anywhere.
//
// Layout: keys int32, valid bool (one byte), values int32 or float32,
// all (P, cap) row-major with cap a multiple of 4 and 16-byte aligned
// bases (the wrapper pads and copies where they are not); every
// partition is reduced on its own, and a partition holds at most 2^24
// rows (the capacity guard of exec/kernels.py).
//
// Integer accumulation:
//  - counts: u32;
//  - int32 columns: int64 sums, rounded once to f32 at the end;
//  - float32 columns: fixed point against Eb, the largest biased
//    exponent (max(exponent field, 1)) among the finite live rows of
//    the row's (partition, column, BUCKET).  A row with exponent field
//    e and significand s (24 bits with the hidden one) becomes
//    q = round(s * 2^(max(e,1) - Eb + 46)), i.e. v * 2^(F - E) with
//    F = 69 and E = Eb - 127, computed with integer shifts only (ties
//    round away from zero).  q is split into hi = floor(q / 2^32) and
//    lo = q mod 2^32, each summed in its own 64-bit word.  Overflow
//    bound, at 2^24 rows a bucket: |q| < 2^(F+1) = 2^70, so
//    |sum hi| <= 2^24 * 2^38 = 2^62 < 2^63 and sum lo < 2^24 * 2^32 =
//    2^56.  An element's error is at most 2^(E - F - 1) and the bucket
//    holds a value >= 2^E, so a bucket's error is below
//    2^24 * 2^-70 = 2^-46 of its sum of |v|, for any spread of values.
//    (One exponent per partition, the cheaper choice, loses buckets
//    that hold only values 2^-53 below the partition's largest.)
//  - non-finite values set flags instead (bit 56 NaN, 57 +Inf, 58 -Inf
//    of the lo word, which sums never reach): the bucket then comes out
//    as IEEE addition gives it (NaN, or +-Inf, NaN if both).
//  - at the end each bucket is rounded once to f32: the integer sum is
//    cut to 53 bits with a sticky bit, converted exactly to double,
//    scaled by an exact power of two, and rounded to f32 (round to
//    nearest even).  ops/bucket.py's plain version repeats this step
//    bit for bit.
//
// Kernels (each launched once a call, on the caller's stream):
//  1. bucket_cluster, phase 0 (only with float columns): each bucket's
//     largest exponent, shared atomicMax, flushed with global atomicMax
//     into E (nf, P, Kp) int32.  Its table is 4 bytes a bucket, so it
//     runs on its own, smaller cluster;
//  2. bucket_cluster, phase 1: counts and integer sums;
//  3. bucket_finish: global integer tables -> f32 outputs.
//
// bucket_cluster: a thread-block cluster of C blocks holds the bucket
// range [b0, b0 + C*T) of one partition in shared memory, T buckets a
// block (phase 1: 4 + 8 per int column + 17 per float column bytes a
// bucket; K=131072 counts are 512 KB, held by 4 blocks; K=65536 with an
// f32 and an int32 column 1.81 MiB, held by 16).  The grid is
// (C, row chunk x bucket range, P).  Every block of a cluster reads all
// of the cluster's rows and adds those in its own range with local
// shared atomics; the cluster runs its blocks at once, so L2 serves the
// C reads of a row.  Warps stream rows straight from global memory, 4
// consecutive rows a lane (16-byte key loads, 4 groups of 128 rows a
// warp issued together).  Counts alone (WordCount) take one increment
// a live row: the hardware merges lanes that increment one address.
// With value columns a warp lists the rows its block adds and adds them
// 32 at a time; lanes that share lane 0's bucket are summed with
// shuffles and added once (a hot key would otherwise serialise its
// 64-bit atomics, which shared memory runs as compare-and-swap loops).
// At the end each block adds its nonzero buckets into global u32 / u64
// tables with integer atomics (order-free), and bucket_finish converts
// them.
//
// Why the blocks do not exchange rows: a first version of this kernel
// fed rows through an mbarrier ring by cp.async.bulk and multicast them
// to the C blocks.  On an NVIDIA H100 80GB HBM3 (700 W) the ring moved
// rows at well under half the card's memory rate at the stage sizes a
// bucket table leaves room for (each bulk copy paid a fixed latency,
// and larger stages, not more of them, helped), and multicast
// multiplies the bytes each SM takes in by C.  Adding each row into its
// owner's shared memory through distributed-shared-memory atomics was
// slower than rereading at both main-path shapes: a remote atomic costs
// a warp several local ones (tools/probe_cluster.cu), and its latency
// stalls the warp's next shared-memory access.  It was faster only with
// a hot key, whose rows rereading gives to one block (PERF.md).
//
// Bound on this card: bytes, each input byte read once (4 key + 1
// valid + 4 a value column a row) plus the output tables, over
// 3.35 TB/s.  What the design pays beyond it: each row is read C times
// from L2, once a block (value columns only for a block's own rows,
// in scattered 4-byte loads); float columns are read twice (phase 0);
// shared-memory atomic throughput, 64-bit ones most of all.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define DN_MAX_VALS 8
#define DN_MAX_CLUSTER 16
#define DN_MAX_THREADS 1024
#define DN_FIX_SHIFT 46  // F - 23 with F = 69
#define DN_SCALE_BIAS 196  // 127 + F
#define DN_FLAG_SHIFT 56
#define DN_LOW_MASK ((1ull << DN_FLAG_SHIFT) - 1ull)
#define DN_FULL 0xffffffffu
#define DN_LIST 160  // row-list entries a warp: < 32 left over + 128 a group
#define DN_UNROLL 4  // 128-row groups whose loads a warp issues together

struct DnParams {
  const int32_t* keys;
  const uint8_t* valid;
  const void* vals[DN_MAX_VALS];
  unsigned int_mask;      // bit j: column j is int32 (else float32)
  int m, ni, nf;          // value columns, of them int32, float32
  int slot[DN_MAX_VALS];  // column j's index among the int (or float) columns
  int P;
  long long cap;          // row stride of a partition (a multiple of 4)
  int Kp, T, n_ranges, phase;
  long long chunk_rows;
  int* E;                 // (nf, P, Kp) int32 biased exponents
  unsigned* cnt_g;                 // (P, Kp)
  unsigned long long* isum_g;      // (ni, P, Kp)
  unsigned long long* fhi_g;       // (nf, P, Kp)
  unsigned long long* flo_g;       // (nf, P, Kp)
};

// ---- integer terms of a value, and the one rounding back to f32 ------------

static __device__ __forceinline__ unsigned biased_exponent(uint32_t b) {
  return max((b >> 23) & 0xffu, 1u);
}

// f32 bits -> (hi, lo) two's-complement terms of q (see the header), or a
// non-finite flag (1 NaN, 2 +Inf, 4 -Inf) with zero terms.
static __device__ __forceinline__ void float_terms(uint32_t b, int Eb, unsigned long long& hi,
                                                   unsigned long long& lo, unsigned& flag) {
  const uint32_t e = (b >> 23) & 0xffu, frac = b & 0x7fffffu;
  hi = 0ull;
  lo = 0ull;
  flag = 0u;
  if (e == 0xffu) {
    flag = frac ? 1u : ((b >> 31) ? 4u : 2u);
    return;
  }
  const uint32_t s = e ? (frac | 0x800000u) : frac;
  const int sh = (int)max(e, 1u) - Eb + DN_FIX_SHIFT;
  unsigned long long mh, ml;
  if (sh >= 32) {
    mh = (unsigned long long)s << (sh - 32);
    ml = 0ull;
  } else if (sh >= 0) {
    const unsigned long long f = (unsigned long long)s << sh;
    mh = f >> 32;
    ml = f & 0xffffffffull;
  } else {
    const int r = min(-sh, 25);  // s < 2^24, so a shift of 25 gives 0
    mh = 0ull;
    ml = (unsigned long long)((s + (1u << (r - 1))) >> r);
  }
  if ((b >> 31) && (mh | ml)) {  // -q = (-mh - 1) * 2^32 + (2^32 - ml)
    if (ml) {
      hi = ~mh;
      lo = (1ull << 32) - ml;
    } else {
      hi = 0ull - mh;
    }
  } else {
    hi = mh;
    lo = ml;
  }
}

static __device__ __forceinline__ double pow2(int e) {  // exact, e in [-1022, 1023]
  return __longlong_as_double((long long)(e + 1023) << 52);
}

// f32 nearest to (H * 2^32 + L) * 2^scale, L in [0, 2^32).
static __device__ float integer_to_f32(long long H, unsigned long long L, int scale) {
  const bool neg = H < 0;
  unsigned long long hm, lm;
  if (!neg) {
    hm = (unsigned long long)H;
    lm = L;
  } else if (L) {
    hm = ~(unsigned long long)H;
    lm = (1ull << 32) - L;
  } else {
    hm = 0ull - (unsigned long long)H;
    lm = 0ull;
  }
  unsigned long long t;
  int sh = 0;
  if (hm < (1ull << 21)) {
    t = (hm << 32) | lm;  // < 2^53: exact in a double
  } else {                // cut to 53 bits, the dropped bits kept as a sticky bit
    sh = (64 - __clzll((long long)hm)) - 21;
    if (sh <= 32) {
      t = (hm << (32 - sh)) | (lm >> sh);
      t |= (lm & ((1ull << sh) - 1ull)) != 0ull;
    } else {
      t = hm >> (sh - 32);
      t |= ((hm & ((1ull << (sh - 32)) - 1ull)) | lm) != 0ull;
    }
  }
  const double d = __dmul_rn(__ull2double_rn(t), pow2(sh + scale));
  return __double2float_rn(neg ? -d : d);
}

// ---- the cluster kernel -----------------------------------------------------

// Where column slots live in a block's table (byte offsets, T buckets):
// isum[ni][T] u64 | fhi[nf][T] u64 | flo[nf][T] u64 | cnt[T] u32 | ebyte[nf][T] u8
// Phase 0 uses emax[nf][T] u32 at offset 0 instead.
struct Table {
  unsigned long long* isum;
  unsigned long long* fhi;
  unsigned long long* flo;
  unsigned* cnt;
  uint8_t* ebyte;
  unsigned* emax;
};

static __device__ __forceinline__ Table table_at(unsigned char* base, int T, int ni, int nf) {
  Table t;
  t.isum = reinterpret_cast<unsigned long long*>(base);
  t.fhi = t.isum + (size_t)ni * T;
  t.flo = t.fhi + (size_t)nf * T;
  t.cnt = reinterpret_cast<unsigned*>(t.flo + (size_t)nf * T);
  t.ebyte = reinterpret_cast<uint8_t*>(t.cnt + T);
  t.emax = reinterpret_cast<unsigned*>(base);
  return t;
}

static __device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(DN_FULL, x, o);
  return x;
}

static __global__ void __launch_bounds__(DN_MAX_THREADS) bucket_cluster(const DnParams q) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NW = (int)(blockDim.x >> 5);
  const int m = q.m, T = q.T, ni = q.ni, nf = q.nf;
  const bool phase0 = q.phase == 0;

  uint32_t* wlist = reinterpret_cast<uint32_t*>(smem) + (size_t)warp * DN_LIST;
  unsigned char* tab_base = smem + (size_t)NW * DN_LIST * 4;
  const Table tab = table_at(tab_base, T, ni, nf);

  const int p = blockIdx.z;
  const int range = blockIdx.y % q.n_ranges;
  const long long chunk = blockIdx.y / q.n_ranges;
  const long long b0 = (long long)range * C * T;               // the cluster's first bucket
  const int span = (int)min((long long)C * T, (long long)q.Kp - b0);
  const long long my_b0 = b0 + (long long)rank * T;           // this block's first bucket
  const size_t PK = (size_t)q.P * q.Kp;
  const size_t prow = (size_t)p * q.Kp;
  // the rel = key - b0 this block adds
  const int rel_lo = (int)rank * T;
  const int rel_hi = min(span, (int)(rank + 1) * T);

  // zero (or, for phase 0, set to the least exponent 1) the table; load
  // this block's bucket exponents for phase 1
  if (phase0) {
    for (int i = tid; i < nf * T; i += blockDim.x) tab.emax[i] = 1u;
  } else {
    const int words = (ni + 2 * nf) * T;
    for (int i = tid; i < words; i += blockDim.x) tab.isum[i] = 0ull;
    for (int b = tid; b < T; b += blockDim.x) {
      tab.cnt[b] = 0u;
      const long long g = my_b0 + b;
      for (int f = 0; f < nf; ++f)
        tab.ebyte[(size_t)f * T + b] =
            g < q.Kp ? (uint8_t)q.E[(size_t)f * PK + prow + g] : (uint8_t)1;
    }
  }
  __syncthreads();  // the table is ready

  // every block of the cluster reads all of the cluster's rows
  const long long base_p = (long long)p * q.cap;
  const long long r0 = chunk * q.chunk_rows;
  const long long r1 = min(q.cap, r0 + q.chunk_rows);
  const int32_t* keys = q.keys + base_p;
  const uint8_t* valid = q.valid + base_p;

  // add up to 32 listed rows (row offsets in the partition), one a lane;
  // lanes that share lane 0's bucket are summed with shuffles and added
  // once (a hot key would otherwise serialise its 64-bit atomics)
  auto add_batch = [&](int nb, const uint32_t* rows) {
    const bool act = lane < nb;  // lane 0 always is
    const long long i = act ? (long long)rows[lane] : 0;
    const int rel = act ? (int)((long long)__ldg(keys + i) - b0) : -1;
    const int idx = act ? rel - rel_lo : 0;
    const int lrel = __shfl_sync(DN_FULL, rel, 0);
    const unsigned same = __ballot_sync(DN_FULL, act && rel == lrel);
    const bool grouped = __popc(same) > 1;  // warp-uniform
    const bool in_group = grouped && ((same >> lane) & 1u);
    const bool solo = act && !in_group;
    const Table& t = tab;

    if (phase0) {
      for (int j = 0; j < m; ++j) {
        if ((q.int_mask >> j) & 1u) continue;
        const uint32_t b =
            act ? __ldg(static_cast<const uint32_t*>(q.vals[j]) + base_p + i) : 0u;
        const unsigned e = (act && ((b >> 23) & 0xffu) != 0xffu) ? biased_exponent(b) : 1u;
        unsigned* dst = t.emax + (size_t)q.slot[j] * T + idx;
        if (solo && e > 1u) atomicMax(dst, e);
        if (grouped) {
          const unsigned ge = __reduce_max_sync(DN_FULL, in_group ? e : 1u);
          if (lane == 0 && ge > 1u) atomicMax(dst, ge);
        }
      }
      return;
    }

    if (solo) atomicAdd(t.cnt + idx, 1u);
    if (grouped && lane == 0) atomicAdd(t.cnt + idx, (unsigned)__popc(same));
    for (int j = 0; j < m; ++j) {
      const int sl = q.slot[j];
      if ((q.int_mask >> j) & 1u) {
        const long long v = act ? __ldg(static_cast<const int32_t*>(q.vals[j]) + base_p + i) : 0;
        unsigned long long* dst = t.isum + (size_t)sl * T + idx;
        const unsigned long long w = (unsigned long long)v;
        if (solo && w) atomicAdd(dst, w);
        if (grouped) {
          const unsigned long long gw = warp_sum(in_group ? w : 0ull);
          if (lane == 0 && gw) atomicAdd(dst, gw);
        }
      } else {
        const uint32_t b = act ? __ldg(static_cast<const uint32_t*>(q.vals[j]) + base_p + i) : 0u;
        unsigned long long hi = 0ull, lo = 0ull;
        unsigned flag = 0u;
        if (act) float_terms(b, (int)t.ebyte[(size_t)sl * T + idx], hi, lo, flag);
        unsigned long long* dh = t.fhi + (size_t)sl * T + idx;
        unsigned long long* dl = t.flo + (size_t)sl * T + idx;
        if (solo) {
          if (hi) atomicAdd(dh, hi);
          if (lo) atomicAdd(dl, lo);
          if (flag) atomicOr(dl, (unsigned long long)flag << DN_FLAG_SHIFT);
        }
        if (grouped) {
          const unsigned long long gh = warp_sum(in_group ? hi : 0ull);
          const unsigned long long gl = warp_sum(in_group ? lo : 0ull);
          const unsigned gf = __reduce_or_sync(DN_FULL, in_group ? flag : 0u);
          if (lane == 0) {
            if (gh) atomicAdd(dh, gh);
            if (gl) atomicAdd(dl, gl);
            if (gf) atomicOr(dl, (unsigned long long)gf << DN_FLAG_SHIFT);
          }
        }
      }
    }
  };

  // a step: DN_UNROLL groups of 128 rows a warp, 4 consecutive rows a
  // lane (16-byte key loads, all issued before any is used)
  const bool counts_only = !phase0 && m == 0;
  int listed = 0;  // rows in wlist, < 32 between groups
  const long long step = (long long)NW * 128 * DN_UNROLL;
  for (long long base = r0 + (long long)warp * 128 * DN_UNROLL; base < r1; base += step) {
    int4 k4[DN_UNROLL];
    uint32_t v4[DN_UNROLL];
#pragma unroll
    for (int u = 0; u < DN_UNROLL; ++u) {
      const long long i0 = base + u * 128 + 4 * lane;  // r1 - i0 is a multiple of 4
      k4[u] = make_int4(-1, -1, -1, -1);
      v4[u] = 0u;
      if (i0 < r1) {
        k4[u] = __ldg(reinterpret_cast<const int4*>(keys + i0));
        v4[u] = __ldg(reinterpret_cast<const uint32_t*>(valid + i0));
      }
    }
#pragma unroll
    for (int u = 0; u < DN_UNROLL; ++u) {
      const int kk[4] = {k4[u].x, k4[u].y, k4[u].z, k4[u].w};
      const uint32_t i0 = (uint32_t)(base + u * 128 + 4 * lane);
      if (counts_only) {
        // one increment a live row, no list: the hardware merges the
        // increments of lanes that share an address
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long rel = (long long)kk[e] - b0;
          if (!(((v4[u] >> (8 * e)) & 0xffu) && kk[e] >= 0 && rel >= rel_lo && rel < rel_hi))
            continue;
          atomicAdd(tab.cnt + ((int)rel - rel_lo), 1u);
        }
        continue;
      }
      // list the rows this block adds; add them 32 at a time, so a row
      // another block adds costs only the scan
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long rel = (long long)kk[e] - b0;
        const bool live =
            ((v4[u] >> (8 * e)) & 0xffu) && kk[e] >= 0 && rel >= rel_lo && rel < rel_hi;
        const unsigned mm = __ballot_sync(DN_FULL, live);
        if (live) wlist[listed + __popc(mm & ((1u << lane) - 1u))] = i0 + e;
        listed += __popc(mm);
      }
      __syncwarp();
      if (listed >= 32) {
        int done = 0;
        for (; listed - done >= 32; done += 32) add_batch(32, wlist + done);
        listed -= done;
        const uint32_t rest = lane < listed ? wlist[done + lane] : 0u;
        __syncwarp();
        if (lane < listed) wlist[lane] = rest;
        __syncwarp();
      }
    }
  }
  if (listed) add_batch(listed, wlist);
  __syncthreads();  // every row of the chunk is in the table

  // flush this block's nonzero buckets into the global tables
  for (int b = tid; b < T; b += blockDim.x) {
    const long long g = my_b0 + b;
    if (g >= q.Kp) break;
    const size_t gi = prow + (size_t)g;
    if (phase0) {
      for (int f = 0; f < nf; ++f) {
        const unsigned e = tab.emax[(size_t)f * T + b];
        if (e > 1u) atomicMax(q.E + (size_t)f * PK + gi, (int)e);
      }
      continue;
    }
    const unsigned c = tab.cnt[b];
    if (!c) continue;
    atomicAdd(q.cnt_g + gi, c);
    for (int i2 = 0; i2 < ni; ++i2) {
      const unsigned long long w = tab.isum[(size_t)i2 * T + b];
      if (w) atomicAdd(q.isum_g + (size_t)i2 * PK + gi, w);
    }
    for (int f = 0; f < nf; ++f) {
      const unsigned long long h = tab.fhi[(size_t)f * T + b];
      const unsigned long long w = tab.flo[(size_t)f * T + b];
      if (h) atomicAdd(q.fhi_g + (size_t)f * PK + gi, h);
      if (w & DN_LOW_MASK) atomicAdd(q.flo_g + (size_t)f * PK + gi, w & DN_LOW_MASK);
      if (w >> DN_FLAG_SHIFT) atomicOr(q.flo_g + (size_t)f * PK + gi, w & ~DN_LOW_MASK);
    }
  }
}

static __global__ void bucket_finish(const DnParams q, float* __restrict__ cnt_out,
                                     float* __restrict__ sum_out) {
  const size_t PK = (size_t)q.P * q.Kp;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= PK) return;
  cnt_out[i] = (float)q.cnt_g[i];
  for (int j = 0; j < q.m; ++j) {
    const int sl = q.slot[j];
    float out;
    if ((q.int_mask >> j) & 1u) {
      const long long s = (long long)q.isum_g[(size_t)sl * PK + i];
      out = integer_to_f32(s >> 32, (unsigned long long)s & 0xffffffffull, 0);
    } else {
      const unsigned long long w = q.flo_g[(size_t)sl * PK + i];
      const unsigned flags = (unsigned)(w >> DN_FLAG_SHIFT);
      const unsigned long long low = w & DN_LOW_MASK;
      if ((flags & 1u) || (flags & 6u) == 6u) {
        out = __int_as_float(0x7fc00000);
      } else if (flags) {
        out = __int_as_float((flags & 2u) ? 0x7f800000 : (int)0xff800000u);
      } else {
        const long long H = (long long)q.fhi_g[(size_t)sl * PK + i] + (long long)(low >> 32);
        out = integer_to_f32(H, low & 0xffffffffull,
                             q.E[(size_t)sl * PK + i] - DN_SCALE_BIAS);
      }
    }
    sum_out[(size_t)j * PK + i] = out;
  }
}

// ---- host entry points (plain C ABI) ----------------------------------------

static cudaError_t set_attributes(int C, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      bucket_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(bucket_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// Launches phase 0 (when there are float columns), phase 1 and the
// finish kernel on `stream`.  geo holds each phase's launch, 6 numbers
// a phase: cluster size, buckets a block, bucket ranges, row chunks,
// rows a chunk, dynamic shared memory bytes.
// Returns 0 or the cudaError_t of the first failure.  The caller
// allocates and initialises every buffer: E (nf, P, Kp) int32 set to 1;
// cnt_g (P, Kp) u32, isum_g (ni, P, Kp), fhi_g and flo_g (nf, P, Kp) u64
// set to 0; cnt_out (P, Kp) and sum_out (m, P, Kp) float.
extern "C" int dn_bucket_sum_count(
    const void* keys, const void* valid, const void* const* vals, unsigned int_mask, int m,
    int P, long long cap, int Kp, const long long* geo, int threads, void* E, void* cnt_g,
    void* isum_g, void* fhi_g, void* flo_g, void* cnt_out, void* sum_out, void* stream) {
  if (m < 0 || m > DN_MAX_VALS || P < 1 || Kp < 1 || cap % 4 != 0 || threads < 32 ||
      threads % 32 != 0 || threads > DN_MAX_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  DnParams q = {};
  q.keys = static_cast<const int32_t*>(keys);
  q.valid = static_cast<const uint8_t*>(valid);
  q.int_mask = int_mask;
  q.m = m;
  for (int j = 0; j < m; ++j) {
    q.vals[j] = vals[j];
    q.slot[j] = ((int_mask >> j) & 1u) ? q.ni++ : q.nf++;
  }
  q.P = P;
  q.cap = cap;
  q.Kp = Kp;
  q.E = static_cast<int*>(E);
  q.cnt_g = static_cast<unsigned*>(cnt_g);
  q.isum_g = static_cast<unsigned long long*>(isum_g);
  q.fhi_g = static_cast<unsigned long long*>(fhi_g);
  q.flo_g = static_cast<unsigned long long*>(flo_g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  for (int phase = q.nf ? 0 : 1; phase < 2; ++phase) {
    const long long* g = geo + 6 * phase;
    const int C = (int)g[0], T = (int)g[1], n_ranges = (int)g[2], n_chunks = (int)g[3];
    const long long chunk_rows = g[4];
    const int smem = (int)g[5];
    const size_t bucket = phase ? 4 + 8 * q.ni + 17 * q.nf : 4 * q.nf;
    if (C < 1 || C > DN_MAX_CLUSTER || T < 1 || n_ranges < 1 || n_chunks < 1 ||
        chunk_rows < 128 || chunk_rows % 128 != 0 ||
        (long long)n_chunks * n_ranges > 65535 || (long long)C * T * n_ranges < Kp ||
        (long long)n_chunks * chunk_rows < cap ||
        (size_t)smem < (size_t)threads / 32 * DN_LIST * 4 + (size_t)T * bucket) {
      return (int)cudaErrorInvalidValue;
    }
    q.T = T;
    q.n_ranges = n_ranges;
    q.chunk_rows = chunk_rows;
    q.phase = phase;
    cudaError_t err = set_attributes(C, smem);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, n_chunks * n_ranges, P);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, bucket_cluster, q);
    if (err != cudaSuccess) return (int)err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t total = (size_t)P * Kp;
  const int fb = 256;
  bucket_finish<<<(unsigned)((total + fb - 1) / fb), fb, 0, s>>>(
      q, static_cast<float*>(cnt_out), static_cast<float*>(sum_out));
  return (int)cudaGetLastError();
}

extern "C" const char* dn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
