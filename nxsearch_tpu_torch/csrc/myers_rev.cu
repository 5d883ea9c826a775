// Transposed bit-parallel Myers edit distance of M query tokens to W
// vocabulary terms, one thread per term: the TERM is the pattern (its
// DP column fits one u32) and the query is the text.  Hopper (sm_90a)
// port of the Pallas kernel
// nxsearch_tpu/ops/pallas/fuzzy.py:_myers_rev_kernel_batch; the plain
// PyTorch twin is ops/kernels.py:myers_rev_distances_ref and the two
// agree bit for bit on every lane.  Edit distance is symmetric, so the
// output equals the forward kernel's (csrc/myers.cu).
//
// What bounds it.  Each (query, term) pair costs len(query) Myers steps
// (csrc/myers_step.cuh: 17 integer instructions with nvcc 12.9, the
// count chip_smoke.py reads from the step's SASS) plus one shared-memory
// table read; the vocabulary is read once per call (W x 36 B) and the
// output is M x W x 4 B.  At M = 64 and 7-byte queries that is about
// 25 operations per byte moved (the card's balance point is about 5),
// so integer throughput and latency bound the kernel, not
// device-memory bandwidth.
//
// What the design does about it.
// - The char table of the TPU kernel (for each byte value c, the
//   bitmask of term positions j with term[j] == c) is built once per
//   block and serves every query of the launch, as the TPU scratch
//   serves the inner grid axis.  A step then reads its equality mask
//   with one lookup, table[q[i]][t].
// - The table is u32[256][kTerms] in shared memory and thread t owns
//   column t: it zeroes the column and sets its own bits, and every
//   read of a warp at one byte value c touches 32 consecutive words,
//   one per bank (no conflicts).  Since a thread only ever reads the
//   column it wrote, the table needs no barrier; the barriers only
//   fence the staged queries.
// - kTerms = 64: the table is 64 KB (above the 48 KB static limit, so
//   it is dynamic shared memory, enabled by cudaFuncSetAttribute before
//   each launch), 67,840 B per block with the staged queries, so three
//   blocks (six warps) fit an SM's 228 KB.  A block of 128 terms would
//   take 128 KB and fit one block (four warps) per SM; 64 keeps more
//   warps resident to hide the step's dependent-latency chain.
//   nvcc -Xptxas -v for sm_90a: 32 registers, no spills, no stack, so
//   registers never limit the three blocks.
// - The term's 32 bytes are read with two 16-byte loads; queries are
//   staged in groups of kQGroup in shared memory, so each warp reads a
//   query byte as one broadcast word.
//
// Bits the table never holds.  Bits at j >= n (the term's length) are
// never set, where the TPU kernel also sets bits for the zero padding.
// They could not reach the score either way: a Myers step only moves
// information upward (the carry of (eq & pv) + pv and the << 1 shifts),
// the score reads bit n - 1 alone, and pv / mv are masked to the low n
// bits after every step -- so bits >= n of eq change no bit below n.

#include <cuda_runtime.h>
#include <stdint.h>

#include "myers_step.cuh"

namespace {

constexpr int kTerms = 64;      // terms (threads) per block
constexpr int kQGroup = 64;     // queries staged in smem at a time
constexpr int kWidth = 32;      // bytes per term / query row
constexpr size_t kTableBytes = 256 * kTerms * sizeof(uint32_t);
constexpr size_t kSmemBytes =
    kTableBytes + kQGroup * kWidth + kQGroup * sizeof(int32_t);

__global__ void __launch_bounds__(kTerms)
myers_rev_kernel(const uint8_t* __restrict__ vocab,    // [W, 32] row-major
                 const int32_t* __restrict__ vlen,     // [W]
                 const uint8_t* __restrict__ qbytes,   // [M, 32]
                 const int32_t* __restrict__ qlen,     // [M]
                 int32_t* __restrict__ out,            // [M, W]
                 int n_terms, int n_queries) {
  extern __shared__ __align__(16) uint32_t smem[];
  // table[c][t] lives at smem[c * kTerms + t]; this thread's column:
  uint32_t* col = smem + threadIdx.x;
  uint8_t* qs = reinterpret_cast<uint8_t*>(smem + 256 * kTerms);
  int32_t* qls = reinterpret_cast<int32_t*>(qs + kQGroup * kWidth);

  const int t = blockIdx.x * kTerms + threadIdx.x;
  const bool live = t < n_terms;
  int n = 0;
  if (live) {
    // The term's bytes: two 16-byte loads (rows are 32-byte aligned).
    const uint4* row = reinterpret_cast<const uint4*>(vocab) + 2 * t;
    const uint4 a = row[0];
    const uint4 b = row[1];
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    n = vlen[t];
    for (int c = 0; c < 256; ++c) col[c * kTerms] = 0;
#pragma unroll
    for (int j = 0; j < kWidth; ++j) {
      if (j >= n) break;
      const uint32_t c = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
      col[c * kTerms] |= 1u << j;
    }
  }
  // Per-lane masks exactly as the reference (pallas/fuzzy.py:210-217):
  // all ones at n >= 32; the high bit clamps the u32-wrapped n - 1 to
  // 31, so n == 0 reads bit 31 (a shift by 32 is undefined in C).
  const uint32_t nu = (uint32_t)n;
  const uint32_t mask_n = n >= 32 ? 0xFFFFFFFFu : (1u << nu) - 1u;
  const uint32_t high_bit = 1u << min(nu - 1u, 31u);

  for (int g0 = 0; g0 < n_queries; g0 += kQGroup) {
    const int ng = min(kQGroup, n_queries - g0);
    __syncthreads();  // the previous group's queries are no longer read
    for (int i = threadIdx.x; i < ng * kWidth; i += kTerms) {
      qs[i] = qbytes[(size_t)g0 * kWidth + i];
    }
    for (int i = threadIdx.x; i < ng; i += kTerms) {
      qls[i] = qlen[g0 + i];
    }
    __syncthreads();
    if (!live) continue;   // dead threads still reach every barrier

    for (int q = 0; q < ng; ++q) {
      const int m = min(qls[q], kWidth);
      const uint32_t* qw = reinterpret_cast<const uint32_t*>(qs + q * kWidth);
      uint32_t pv = mask_n;
      uint32_t mv = 0;
      int score = n;
#pragma unroll
      for (int i = 0; i < kWidth; ++i) {
        if (i >= m) break;   // steps run over query positions i < q_len
        const uint32_t c = (qw[i >> 2] >> (8 * (i & 3))) & 0xFFu;
        myers_step(col[c * kTerms], mask_n, high_bit, pv, mv, score);
      }
      out[(size_t)(g0 + q) * n_terms + t] = score;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Enables the block's dynamic
// shared memory, launches on ``stream`` and returns the first CUDA error
// (0 on success).
extern "C" int nxs_myers_rev_distances(const void* vocab, const void* vlen,
                                       const void* qbytes, const void* qlen,
                                       void* out, int n_terms,
                                       int n_queries, void* stream) {
  if (n_terms <= 0 || n_queries <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      myers_rev_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_terms + kTerms - 1) / kTerms);
  myers_rev_kernel<<<grid, kTerms, kSmemBytes, (cudaStream_t)stream>>>(
      (const uint8_t*)vocab, (const int32_t*)vlen,
      (const uint8_t*)qbytes, (const int32_t*)qlen, (int32_t*)out,
      n_terms, n_queries);
  return (int)cudaGetLastError();
}
