// Block-dense BM25 / TF-IDF scores and presence bits of N queries of
// up to a few terms over every slot of the index.  Hopper (sm_90a)
// port of the Pallas kernel nxsearch_tpu/ops/pallas/segsum.py
// _make_kernel (with _accumulate_term); the plain PyTorch twin is
// ops/kernels.py:blockdense_scores_ref and the two agree bit for bit.
//
// For query n, slot s and term q (postings slot-sorted per term, at
// most one posting per (term, slot)):
//   score[n, s] = alive[s] * sum_q contrib(q, s), in term order,
//   contrib     = (ltf * idf) / ((ltf + C1) + C2 * dl[s])   (BM25)
//               =  ltf * idf                                 (TF-IDF)
//   bits[n, s]  = OR_q (1 << min(q, 31)) over the terms present at s.
// Term q's postings that fall into the 1024-slot block g are the
// contiguous range [bounds[n, q, g], bounds[n, q, g + 1]).
//
// What bounds it.  Each CTA writes its 1024 scores and 1024 bit words
// (8 KB) whether or not a posting falls into its block, so at N = 64
// queries over 1M slots the kernel stores 512 MB; the postings it reads
// (8 B each) and the doc lengths it gathers are far fewer for the
// selective terms this route serves.  It is bound by device-memory
// stores and by the per-CTA cost of zeroing and the bounds reads.
//
// What the design does about it.
// - The TPU kernel scatters a block's postings with a broadcast-compare
//   one-hot [256, 1024] and a sublane sum, because a TPU lane cannot
//   write by index.  Here one CTA owns one (query, block): a 1024-float
//   accumulator and 1024 presence words live in shared memory and each
//   posting is added at its slot by index.
// - Terms run in order with a barrier between them.  A term holds at
//   most one posting per slot, so no two adds of one term collide and
//   the per-slot summation order is the reference's, with no atomics.
// - Empty ranges (padding terms and dense-handled terms point at the
//   all-zero bounds row) are skipped before any barrier: they cost two
//   cached loads.
// - Every float operation is an explicitly rounded intrinsic, so nvcc
//   cannot contract C2 * dl + (ltf + C1) into an FMA: the kernel rounds
//   exactly as the twin and the reference do.
// - The epilogue stores the block with 16-byte vector stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockSlots = 1024;
constexpr int kThreads = 256;
constexpr int kPerThread = kBlockSlots / kThreads;   // 4: one float4

template <bool kBM25, bool kMask>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const int32_t* __restrict__ pslot,   // [P] slot-sorted per term
              const float* __restrict__ pltf,      // [P]
              const float* __restrict__ dlen,      // [S]
              const float* __restrict__ alive,     // [S] 0/1 factors
              const int32_t* __restrict__ bounds,  // [N, Q, G + 1]
              const float* __restrict__ coef,      // [N, Q, 4]: idf, C1, C2, 0
              float* __restrict__ out,             // [N, S]
              uint32_t* __restrict__ bits_out,     // [N, S]
              int n_terms, int n_blocks) {
  __shared__ __align__(16) float acc[kBlockSlots];
  __shared__ __align__(16) uint32_t pres[kBlockSlots];

  const int g = blockIdx.x;
  const int n = blockIdx.y;
  const int base = g * kBlockSlots;
  const int lane0 = threadIdx.x * kPerThread;
  const size_t n_slots = (size_t)n_blocks * kBlockSlots;

  *reinterpret_cast<float4*>(acc + lane0) = make_float4(0.f, 0.f, 0.f, 0.f);
  *reinterpret_cast<uint4*>(pres + lane0) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int32_t* brow = bounds + (size_t)n * n_terms * (n_blocks + 1);
  const float* crow = coef + (size_t)n * n_terms * 4;
  for (int q = 0; q < n_terms; ++q) {
    const int32_t* bq = brow + (size_t)q * (n_blocks + 1);
    const int b0 = bq[g];
    const int b1 = bq[g + 1];
    if (b0 >= b1) continue;   // uniform across the CTA
    const float idf = crow[q * 4 + 0];
    const float c1 = crow[q * 4 + 1];
    const float c2 = crow[q * 4 + 2];
    const uint32_t bit = 1u << min(q, 31);
    for (int j = b0 + threadIdx.x; j < b1; j += kThreads) {
      const int off = pslot[j] - base;
      if (off < 0 || off >= kBlockSlots) continue;
      const float ltf = pltf[j];
      float c;
      if (kBM25) {
        const float den = __fadd_rn(__fadd_rn(ltf, c1),
                                    __fmul_rn(c2, dlen[base + off]));
        c = __fdiv_rn(__fmul_rn(ltf, idf), den);
      } else {
        c = __fmul_rn(ltf, idf);
      }
      acc[off] = __fadd_rn(acc[off], c);
      if (kMask) pres[off] |= bit;
    }
    __syncthreads();   // the next term adds after this one, slot by slot
  }

  const size_t at = (size_t)n * n_slots + base + lane0;
  const float4 a = *reinterpret_cast<const float4*>(acc + lane0);
  const float4 f = *reinterpret_cast<const float4*>(alive + base + lane0);
  *reinterpret_cast<float4*>(out + at) =
      make_float4(__fmul_rn(a.x, f.x), __fmul_rn(a.y, f.y),
                  __fmul_rn(a.z, f.z), __fmul_rn(a.w, f.w));
  *reinterpret_cast<uint4*>(bits_out + at) =
      *reinterpret_cast<const uint4*>(pres + lane0);
}

template <bool kBM25, bool kMask>
void launch(const dim3& grid, cudaStream_t stream, const void* pslot,
            const void* pltf, const void* dlen, const void* alive,
            const void* bounds, const void* coef, void* out, void* bits,
            int n_terms, int n_blocks) {
  segsum_kernel<kBM25, kMask><<<grid, kThreads, 0, stream>>>(
      (const int32_t*)pslot, (const float*)pltf, (const float*)dlen,
      (const float*)alive, (const int32_t*)bounds, (const float*)coef,
      (float*)out, (uint32_t*)bits, n_terms, n_blocks);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  algo: 0 BM25, 1 TF-IDF.
// Launches on ``stream`` and returns cudaGetLastError() of the launch:
// 0 on success.
extern "C" int nxs_segsum_blockdense(const void* pslot, const void* pltf,
                                     const void* dlen, const void* alive,
                                     const void* bounds, const void* coef,
                                     void* out, void* bits, int n_queries,
                                     int n_terms, int n_blocks, int algo,
                                     int use_mask, void* stream) {
  if (n_queries <= 0 || n_blocks <= 0) return 0;
  const dim3 grid(n_blocks, n_queries);
  cudaStream_t s = (cudaStream_t)stream;
  if (algo == 0) {
    if (use_mask) {
      launch<true, true>(grid, s, pslot, pltf, dlen, alive, bounds, coef,
                         out, bits, n_terms, n_blocks);
    } else {
      launch<true, false>(grid, s, pslot, pltf, dlen, alive, bounds, coef,
                          out, bits, n_terms, n_blocks);
    }
  } else {
    if (use_mask) {
      launch<false, true>(grid, s, pslot, pltf, dlen, alive, bounds, coef,
                          out, bits, n_terms, n_blocks);
    } else {
      launch<false, false>(grid, s, pslot, pltf, dlen, alive, bounds, coef,
                           out, bits, n_terms, n_blocks);
    }
  }
  return (int)cudaGetLastError();
}
