// Transposed bit-parallel Myers edit distance of M query tokens to W
// vocabulary terms, one thread per term: the TERM is the pattern (its
// DP column fits one u32) and the query is the text.  Hopper (sm_90a)
// port of the Pallas kernel
// nxsearch_tpu/ops/pallas/fuzzy.py:_myers_rev_kernel_batch; the plain
// PyTorch twin is ops/kernels.py:myers_rev_distances_ref (its query
// grouping: rev_query_groups_ref) and the two agree bit for bit on
// every lane.  Edit distance is symmetric, so the output equals the
// forward kernel's (csrc/myers.cu).
//
// What bounds it.  Each (query, term) pair costs len(query) Myers steps
// (csrc/myers_step.cuh: 17 integer instructions with nvcc 12.9, the
// count chip_smoke.py reads from the step's SASS) plus two shared-memory
// reads (the query byte's table row, then the thread's word of it); the
// vocabulary is read once per call (W x 36 B) and the output is
// M x W x 4 B.  At M = 64 and 7-byte queries that is about 25 integer
// operations per byte moved (the card's balance point is about 5), so
// integer throughput bounds the kernel, and the dependent chain of each
// step (a table read, then about seven dependent ALU operations) must
// be hidden by other warps.
//
// What the design does about it.
// - The char table (for each byte value c, the bitmask of term
//   positions j with term[j] == c) only needs rows for bytes that some
//   query step reads: a term byte no query holds is never looked up.
//   So the table has kSigma = 32 rows over the alphabet of a GROUP of
//   queries instead of 256: one query holds at most 32 distinct bytes,
//   and queries are grouped greedily, in order, while the union of
//   their alphabets fits 32.  Any input is served: a launch of 256
//   distinct bytes simply takes more groups, and the table is rebuilt
//   per group (kSigma stores to zero it and one update per term byte).
//   The bench band's queries (a salt letter, the digits, "w") form one
//   group per chunk.
// - Queries are staged kChunk = 32 at a time.  Each block derives the
//   grouping from the staged rows itself (no prologue kernel, no host
//   sync): one warp per query reduces its bytes to a 256-bit set, warp
//   0 walks the chunk's sets in order (lanes 0-7 hold the open group's
//   union, __reduce_add_sync counts it), and then every staged byte is
//   rewritten in place as its rank in its group's alphabet.  Three
//   barriers per chunk; none inside a group.
// - Thread t owns column t of u32[kSigma][kTerms]: it zeroes and sets
//   its own bits and reads only its own words, so the table needs no
//   barrier, and a warp's read of one row touches 32 consecutive words,
//   one per bank (no conflicts).
// - 256 terms a block: the table is 32 KB and the block's shared memory
//   35,272 B (static), so six blocks (48 warps) fit an SM's 228 KB
//   where the 256-row table allowed three blocks of two warps (six
//   warps).  __launch_bounds__(kTerms, 6) caps registers at 40; nvcc
//   -Xptxas -v for sm_90a: 40 registers, no spills, so registers do not
//   cut the six blocks, and 782 blocks at W = 200,000 are one wave on
//   132 SMs.  That leaves the SM's L1 about 20 KB, so spills would go
//   to L2: the term's row is read again from L2 at each group's table
//   build instead of being held in eight registers across the steps.
// - One query per loop iteration: with 48 warps per SM the other warps
//   hide each step's table read and dependent ALU chain.
//   tools/myers_variants.py timed two and three queries advanced
//   together per thread (independent chains) within noise of one, at
//   the band and on 100 blocks (under one per SM); four spill.
// - Output stores are coalesced along W (consecutive threads, terms).
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

constexpr int kTerms = 256;       // terms (threads) per block
constexpr int kWarps = kTerms / 32;
constexpr int kBlocksPerSm = 6;   // what 35 KB of shared memory allows
constexpr int kChunk = 32;        // queries staged and grouped at a time
constexpr int kWidth = 32;        // bytes per term / query row
constexpr int kSigma = 32;        // table rows: a group's alphabet cap
constexpr uint32_t kAll = 0xFFFFFFFFu;

struct Shared {
  uint32_t table[kSigma][kTerms];  // table[a][t]; thread t owns column t
  // Per query its byte set (256 bits); then, per group, its alphabet.
  uint32_t bytes[kChunk][8];
  // Per query its bytes; then their ranks in the group's alphabet.
  uint8_t q[kChunk][kWidth];
  int32_t steps[kChunk];           // min(max(q_len, 0), 32)
  uint8_t below[kChunk][8];        // per group: alphabet bytes < 32 * k
  uint8_t group_of[kChunk];
  uint8_t group_start[kChunk + 1];
  int32_t n_groups;
};
static_assert(sizeof(Shared) <= 48 * 1024, "static shared memory");

// Rank of byte c in group g's alphabet (c must belong to it).
__device__ __forceinline__ uint32_t rank_of(const Shared& s, int g,
                                            uint32_t c) {
  const uint32_t word = s.bytes[g][c >> 5];
  return s.below[g][c >> 5] + __popc(word & ((1u << (c & 31)) - 1u));
}

// Warp 0: store group g's alphabet (word k in lane k < 8) and, per
// word, the count of its bytes in the words below.  Group g's first
// query has index >= g, so the set overwritten here was already read.
__device__ __forceinline__ void close_group(Shared& s, int g, uint32_t u,
                                           int lane) {
  const uint32_t own = __popc(u);          // u == 0 on lanes >= 8
  uint32_t incl = own;
#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
    const uint32_t x = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl += x;
  }
  if (lane < 8) {
    s.bytes[g][lane] = u;
    s.below[g][lane] = (uint8_t)(incl - own);
  }
}

// Half a term row, loaded where it stands in the code: the volatile
// asm keeps the compiler from hoisting it out of the group loop and
// holding the row in registers across the steps.
__device__ __forceinline__ uint4 load_row_half(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__global__ void __launch_bounds__(kTerms, kBlocksPerSm)
myers_rev_kernel(const uint8_t* __restrict__ vocab,    // [W, 32] row-major
                 const int32_t* __restrict__ vlen,     // [W]
                 const uint8_t* __restrict__ qbytes,   // [M, 32]
                 const int32_t* __restrict__ qlen,     // [M]
                 int32_t* __restrict__ out,            // [M, W]
                 int n_terms, int n_queries) {
  __shared__ Shared s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kTerms + threadIdx.x;
  const bool live = t < n_terms;

  // The term's row (32-byte aligned) is read at each group's table
  // build, not held in registers across the steps; it is fetched into
  // L2 now, while the first chunk of queries is staged and grouped.
  const uint4* row = reinterpret_cast<const uint4*>(vocab) + 2 * (size_t)t;
  int n = 0;
  if (live) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(row));
    n = vlen[t];
  }
  // Per-lane masks exactly as the reference (pallas/fuzzy.py:210-217):
  // all ones at n >= 32; the high bit clamps the u32-wrapped n - 1 to
  // 31, so n == 0 reads bit 31 (a shift by 32 is undefined in C).
  const uint32_t nu = (uint32_t)n;
  const uint32_t mask_n = n >= 32 ? kAll : (1u << nu) - 1u;
  const uint32_t high_bit = 1u << min(nu - 1u, 31u);
  uint32_t* col = &s.table[0][threadIdx.x];

  for (int c0 = 0; c0 < n_queries; c0 += kChunk) {
    const int nc = min(kChunk, n_queries - c0);
    __syncthreads();  // the previous chunk's shared state is no longer read

    // Stage: one warp per query, lane i holding byte i; the query's
    // byte set holds the bytes its steps read (i < steps).
    for (int q = warp; q < nc; q += kWarps) {
      const size_t row = (size_t)(c0 + q);
      const int m = min(max(qlen[row], 0), kWidth);
      const uint32_t c = qbytes[row * kWidth + lane];
      s.q[q][lane] = (uint8_t)c;
      uint32_t mine = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t word = __reduce_or_sync(
            kAll, (lane < m && (c >> 5) == (uint32_t)k) ? 1u << (c & 31)
                                                         : 0u);
        if (lane == k) mine = word;
      }
      if (lane < 8) s.bytes[q][lane] = mine;
      if (lane == 0) s.steps[q] = m;
    }
    __syncthreads();

    // Group, greedily in query order: a query joins the open group
    // unless the union would exceed kSigma bytes (a lone query never
    // does: it holds at most 32).
    if (warp == 0) {
      uint32_t u = 0;     // lane k < 8: word k of the open group's union
      int g = 0;
      for (int q = 0; q < nc; ++q) {
        const uint32_t b = lane < 8 ? s.bytes[q][lane] : 0u;
        const uint32_t merged = u | b;
        if (__reduce_add_sync(kAll, (uint32_t)__popc(merged)) >
            (uint32_t)kSigma) {
          close_group(s, g, u, lane);
          ++g;
          if (lane == 0) s.group_start[g] = (uint8_t)q;
          u = b;
        } else {
          u = merged;
        }
        if (lane == 0) s.group_of[q] = (uint8_t)g;
      }
      close_group(s, g, u, lane);
      if (lane == 0) {
        s.group_start[0] = 0;
        s.group_start[g + 1] = (uint8_t)nc;
        s.n_groups = g + 1;
      }
    }
    __syncthreads();

    // Each byte a step reads becomes its rank in its group's alphabet.
    for (int e = threadIdx.x; e < nc * kWidth; e += kTerms) {
      const int q = e / kWidth;
      const int i = e % kWidth;
      s.q[q][i] = i < s.steps[q]
                      ? (uint8_t)rank_of(s, s.group_of[q], s.q[q][i])
                      : (uint8_t)0;
    }
    __syncthreads();
    if (!live) continue;   // dead threads still reach every barrier

    for (int g = 0; g < s.n_groups; ++g) {
      // This thread's column over the group's alphabet.
      const int size = s.below[g][7] + __popc(s.bytes[g][7]);
      for (int a = 0; a < size; ++a) col[a * kTerms] = 0;
      const uint4 lo = load_row_half(row);
      const uint4 hi = load_row_half(row + 1);
      const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < kWidth; ++j) {
        if (j >= n) break;
        const uint32_t c = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
        if ((s.bytes[g][c >> 5] >> (c & 31)) & 1u) {
          col[rank_of(s, g, c) * kTerms] |= 1u << j;
        }
      }

      for (int q = s.group_start[g]; q < s.group_start[g + 1]; ++q) {
        const uint8_t* ranks = s.q[q];
        const int m = s.steps[q];
        uint32_t pv = mask_n;
        uint32_t mv = 0;
        int score = n;
        for (int i = 0; i < m; ++i) {
          myers_step(col[ranks[i] * kTerms], mask_n, high_bit, pv, mv, score);
        }
        out[(size_t)(c0 + q) * n_terms + t] = score;
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Asks for the SM's largest
// shared-memory carveout (six 35 KB blocks), launches on ``stream`` and
// returns the first CUDA error (0 on success).
extern "C" int nxs_myers_rev_distances(const void* vocab, const void* vlen,
                                       const void* qbytes, const void* qlen,
                                       void* out, int n_terms,
                                       int n_queries, void* stream) {
  if (n_terms <= 0 || n_queries <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      myers_rev_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_terms + kTerms - 1) / kTerms);
  myers_rev_kernel<<<grid, kTerms, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)vocab, (const int32_t*)vlen,
      (const uint8_t*)qbytes, (const int32_t*)qlen, (int32_t*)out,
      n_terms, n_queries);
  return (int)cudaGetLastError();
}
