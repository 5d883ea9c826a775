// Bit-parallel Myers edit distance of query tokens to W vocabulary
// terms, one thread per term.  Hopper (sm_90a) port of two Pallas
// kernels of nxsearch_tpu/ops/pallas/fuzzy.py: _myers_kernel_batch
// (M queries: myers_kernel, entry nxs_myers_distances; plain PyTorch
// twin ops/kernels.py:myers_distances_ref) and _myers_kernel (one
// query: myers_one_kernel, entry nxs_myers_distances_one; twin
// myers_distances_one_ref).  Kernels and twins agree bit for bit
// (distances are exact integers).
//
// Batched kernel.
// What bounds it.  Each (query, term) pair costs len(term) Myers steps
// (csrc/myers_step.cuh: 17 integer instructions with nvcc 12.9, the
// count chip_smoke.py reads from the step's SASS) plus one shared-memory
// table lookup; the vocabulary is read once per call (W x 32 B, 6.4 MB
// at W = 200000) and the output is M x W x 4 B.  At M = 64 and 6-7
// byte terms that is about 25 integer operations per byte moved (the
// card's balance point is about 5), so the kernel is bound by integer
// throughput and shared-memory lookups, not by device-memory bandwidth.
//
// What the design does about it.
// - The TPU kernel builds Peq (the bitmask of query positions matching
//   a term byte) by comparing every term byte with every query byte,
//   because a TPU lane has no cheap table lookup.  Here each query's
//   classic 256-entry Peq table (u32, bit i set where q[i] == c) is
//   staged once per block in shared memory, so a Myers step reads its
//   mask with one lookup instead of up to 32 compares.
// - Each thread holds its term's 32 bytes in registers (two 16-byte
//   loads from the row-major [W, 32] layout) and reuses them for every
//   query of the call: the vocabulary is never re-read.
// - The step loop is fully unrolled over term positions (byte j is a
//   static shift of a register word) and exits at the term's own
//   length, the per-lane form of the TPU kernel's length gating.
// - Queries are processed in groups of kQGroup whose tables fit shared
//   memory (32 KB); each output row is stored coalesced across the
//   block's threads.
//
// Single-query kernel.
// What bounds it.  One query over W terms is a stream: 36 B read and
// 4 B written per term (8 MB at W = 200,000, 0.0024 ms at 3.35 TB/s;
// a row is one 32-byte sector, so reading only a short term's bytes
// would move no fewer) against a handful of steps, so bytes and the
// launch's fixed cost bound it, not operations: an empty kernel
// launched back to back takes about 0.002 ms on the H100.  Its first
// port, the batched body at one query, launched 782 blocks at four
// blocks per SM (64 registers): 1.48 waves, each thread one load round
// trip, a few steps and a store, with two barriers per block in front
// of the table.
// What the design does about it.
// - One thread per term, 256 terms a block, a grid of ceil(W / 256).
//   __launch_bounds__(kOneThreads, 6) caps registers at 40 (nvcc
//   -Xptxas -v for sm_90a: 24, no spills, 8 KB of shared memory), so
//   eight blocks (64 warps, the SM's limit) fit an SM and the 782
//   blocks of W = 200,000 are one wave on 132 SMs.  The north-star
//   tier's band (bench.py's vocabulary of 1,000,000 terms) takes 3,907
//   blocks, 3.7 waves of 1,056; there the kernel stays near its bytes
//   bound (PERF.md), since each block is one load round trip and a few
//   steps.  An earlier form of this kernel (a one-wave grid-stride loop
//   with the next term's loads in flight) gained nothing measurable,
//   and tools/myers_variants.py timed its blocks of 128 to 1024 threads
//   within 10 % of each other (PERF.md).
// - The term's two 16-byte loads and its length load are issued before
//   the table build, so their round trip overlaps it.
// - The 256-entry Peq table is built by each warp for itself (8 KB a
//   block), behind no block barrier: the warp zeroes its copy, lane i
//   reads query byte i, __match_any_sync gives each lane the set of
//   lanes holding its byte -- that byte's Peq entry -- and the lanes
//   write their entries; two __syncwarp()s order it.  Every thread
//   building all 256 entries from the whole query would cost 32 byte
//   loads and about 100 instructions a thread in front of the steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "myers_step.cuh"

namespace {

constexpr int kThreads = 256;   // terms per block
constexpr int kWidth = 32;      // bytes per term / query row
constexpr int kQGroup = 32;     // queries whose Peq tables share smem
constexpr int kOneThreads = 256;  // single-query kernel: terms per block
constexpr int kOneBlocksPerSm = 6;

__global__ void __launch_bounds__(kThreads)
myers_kernel(const uint8_t* __restrict__ vocab,    // [W, 32] row-major
             const int32_t* __restrict__ vlen,     // [W]
             const uint8_t* __restrict__ qbytes,   // [M, 32]
             const int32_t* __restrict__ qlen,     // [M]
             int32_t* __restrict__ out,            // [M, W]
             int n_terms, int n_queries) {
  __shared__ uint32_t peq[kQGroup][256];
  __shared__ uint8_t qs[kQGroup][kWidth];
  __shared__ int32_t qls[kQGroup];

  const int t = blockIdx.x * kThreads + threadIdx.x;
  const bool live = t < n_terms;

  // The term's bytes: two 16-byte loads (rows are 32-byte aligned).
  uint32_t w[8];
  int n = 0;
  if (live) {
    const uint4* row = reinterpret_cast<const uint4*>(vocab) + 2 * t;
    const uint4 a = row[0];
    const uint4 b = row[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    n = vlen[t];
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = 0;
  }

  for (int g0 = 0; g0 < n_queries; g0 += kQGroup) {
    const int ng = min(kQGroup, n_queries - g0);
    __syncthreads();  // the previous group's tables are no longer read
    for (int i = threadIdx.x; i < ng * kWidth; i += kThreads) {
      qs[i / kWidth][i % kWidth] = qbytes[(size_t)g0 * kWidth + i];
    }
    for (int i = threadIdx.x; i < ng; i += kThreads) {
      qls[i] = qlen[g0 + i];
    }
    __syncthreads();
    // Peq tables: entry (q, c) = bitmask of positions i < len(q) with
    // q[i] == c.  One thread per (query, byte value).
    for (int e = threadIdx.x; e < ng * 256; e += kThreads) {
      const int q = e >> 8;
      const int c = e & 255;
      const int m = min(qls[q], kWidth);
      uint32_t bits = 0;
      for (int i = 0; i < m; ++i) {
        bits |= (uint32_t)(qs[q][i] == c) << i;
      }
      peq[q][c] = bits;
    }
    __syncthreads();
    if (!live) continue;

    for (int q = 0; q < ng; ++q) {
      const int m = qls[q];
      const uint32_t mu = (uint32_t)m;
      // Masks exactly as the reference (pallas/fuzzy.py:72-76): all
      // ones at m >= 32; the high bit clamps the u32-wrapped m - 1 to
      // 31, so m == 0 reads bit 31 (a shift by 32 is undefined in C).
      const uint32_t mask_m = m >= 32 ? 0xFFFFFFFFu : (1u << mu) - 1u;
      const uint32_t high_bit = 1u << min(mu - 1u, 31u);
      const uint32_t* tbl = peq[q];
      uint32_t pv = mask_m;
      uint32_t mv = 0;
      int score = m;
#pragma unroll
      for (int j = 0; j < kWidth; ++j) {
        if (j >= n) break;   // past the term's end the state is frozen
        const uint32_t c = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
        myers_step(tbl[c], mask_m, high_bit, pv, mv, score);
      }
      out[(size_t)(g0 + q) * n_terms + t] = score;
    }
  }
}

__global__ void __launch_bounds__(kOneThreads, kOneBlocksPerSm)
myers_one_kernel(const uint8_t* __restrict__ vocab,    // [W, 32] row-major
                 const int32_t* __restrict__ vlen,     // [W]
                 const uint8_t* __restrict__ qbytes,   // [32]
                 const int32_t* __restrict__ qlen,     // [1]
                 int32_t* __restrict__ out,            // [W]
                 int n_terms) {
  // Each warp's own copy of the query's Peq table, built and read by
  // that warp alone: no block barrier.
  __shared__ uint32_t peq[kOneThreads / 32][256];
  const int lane = threadIdx.x & 31;
  uint32_t* tbl = peq[threadIdx.x >> 5];
  const int t = blockIdx.x * kOneThreads + threadIdx.x;
  const bool live = t < n_terms;

  // The term's bytes: two 16-byte loads (rows are 32-byte aligned).
  uint4 a = make_uint4(0, 0, 0, 0);
  uint4 b = a;
  int n = 0;
  if (live) {
    const uint4* row = reinterpret_cast<const uint4*>(vocab) + 2 * (size_t)t;
    a = row[0];
    b = row[1];
    n = vlen[t];
  }

  const int m = qlen[0];
#pragma unroll
  for (int k = 0; k < 8; ++k) tbl[lane + 32 * k] = 0;
  // Lane i holds query byte i (i < len(q); other lanes a key of their
  // own): the lanes holding one byte value find each other, and that
  // lane set is the value's Peq entry.  Dead lanes take part too.
  const uint32_t key = lane < m ? (uint32_t)qbytes[lane] : 256u + lane;
  const uint32_t same = __match_any_sync(0xFFFFFFFFu, key);
  __syncwarp();
  if (lane < m) tbl[key] = same;
  __syncwarp();
  if (!live) return;

  // Masks exactly as the batched kernel's.
  const uint32_t mu = (uint32_t)m;
  const uint32_t mask_m = m >= 32 ? 0xFFFFFFFFu : (1u << mu) - 1u;
  const uint32_t high_bit = 1u << min(mu - 1u, 31u);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t pv = mask_m;
  uint32_t mv = 0;
  int score = m;
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    if (j >= n) break;   // past the term's end the state is frozen
    const uint32_t c = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
    myers_step(tbl[c], mask_m, high_bit, pv, mv, score);
  }
  out[t] = score;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on
// ``stream`` and returns the first CUDA error: 0 on success.
extern "C" int nxs_myers_distances(const void* vocab, const void* vlen,
                                   const void* qbytes, const void* qlen,
                                   void* out, int n_terms, int n_queries,
                                   void* stream) {
  if (n_terms <= 0 || n_queries <= 0) return 0;
  const dim3 grid((n_terms + kThreads - 1) / kThreads);
  myers_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)vocab, (const int32_t*)vlen,
      (const uint8_t*)qbytes, (const int32_t*)qlen, (int32_t*)out,
      n_terms, n_queries);
  return (int)cudaGetLastError();
}

// One query: qbytes uint8[1, 32], qlen int32[1], out int32[1, W].
extern "C" int nxs_myers_distances_one(const void* vocab, const void* vlen,
                                       const void* qbytes, const void* qlen,
                                       void* out, int n_terms,
                                       void* stream) {
  if (n_terms <= 0) return 0;
  const dim3 grid((n_terms + kOneThreads - 1) / kOneThreads);
  myers_one_kernel<<<grid, kOneThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)vocab, (const int32_t*)vlen,
      (const uint8_t*)qbytes, (const int32_t*)qlen, (int32_t*)out,
      n_terms);
  return (int)cudaGetLastError();
}
