// Bit-parallel Myers edit distance of M query tokens to W vocabulary
// terms, one thread per term.  Hopper (sm_90a) port of the Pallas
// kernels nxsearch_tpu/ops/pallas/fuzzy.py:_myers_kernel_batch (entry
// nxs_myers_distances; plain PyTorch twin
// ops/kernels.py:myers_distances_ref) and _myers_kernel, the same body
// for one query (entry nxs_myers_distances_one; twin
// myers_distances_one_ref).  Kernel and twins agree bit for bit
// (distances are exact integers).
//
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
// - The single-query entry instantiates the same kernel with
//   kQGroup = 1: its tables take 1.3 KB of shared memory instead of
//   33 KB.  Registers still hold both instantiations to four blocks
//   per SM (nvcc -Xptxas -v for sm_90a: 64 registers, no spills; the
//   batched one 62), and chip_smoke.py times the two at M = 1 in
//   turns: on the H100 they take the same time within a few percent.

#include <cuda_runtime.h>
#include <stdint.h>

#include "myers_step.cuh"

namespace {

constexpr int kThreads = 256;   // terms per block
constexpr int kWidth = 32;      // bytes per term / query row

// kQGroup: queries whose Peq tables share smem (32 batched, 1 single).
template <int kQGroup>
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

template <int kQGroup>
int launch(const void* vocab, const void* vlen, const void* qbytes,
           const void* qlen, void* out, int n_terms, int n_queries,
           void* stream) {
  if (n_terms <= 0 || n_queries <= 0) return 0;
  const dim3 grid((n_terms + kThreads - 1) / kThreads);
  myers_kernel<kQGroup><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)vocab, (const int32_t*)vlen,
      (const uint8_t*)qbytes, (const int32_t*)qlen, (int32_t*)out,
      n_terms, n_queries);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on
// ``stream`` and returns cudaGetLastError() of the launch: 0 on success.
extern "C" int nxs_myers_distances(const void* vocab, const void* vlen,
                                   const void* qbytes, const void* qlen,
                                   void* out, int n_terms, int n_queries,
                                   void* stream) {
  return launch<32>(vocab, vlen, qbytes, qlen, out, n_terms, n_queries,
                    stream);
}

// One query: qbytes uint8[1, 32], qlen int32[1], out int32[1, W].
extern "C" int nxs_myers_distances_one(const void* vocab, const void* vlen,
                                       const void* qbytes, const void* qlen,
                                       void* out, int n_terms,
                                       void* stream) {
  return launch<1>(vocab, vlen, qbytes, qlen, out, n_terms, 1, stream);
}
