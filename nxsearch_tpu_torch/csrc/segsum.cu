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
// What bounds it.  The kernel writes 8 B a slot a row (a score and a
// bit word) whether or not a posting falls there: N x S x 8 B, 536.9 MB
// for the 1M tier's launch of 64 rows x 1,048,576 slots and 528.5 MB
// for the north-star tier's 7 rows x 9,437,184.  The blockdense route
// gives it rare terms (heavy ones have dense rows and point at the
// all-zero bounds row), so almost every (row, block) is empty and the
// postings, bounds, doc lengths and alive factors it must read are a
// few MB.  It is bound by device-memory stores, and reaches their rate
// only if stores are in flight all the time.  The first port of it, one
// CTA per (row, block) that zeroed shared memory, walked its terms'
// bounds one load after another and read alive before it stored, ran
// at half that rate.
//
// What the design does about it.
// - Persistent CTAs (grid = SMs x kCtasPerSm) walk tiles: one block g
//   and up to kTileRows rows (all N rows of a launch unless its N x Q
//   bounds pairs exceed kPairsPerThread a thread).
// - A tile's bounds pairs are fetched in one round, each thread
//   loading its pairs together before any is branched on, and the
//   next tile's pairs load into registers while this tile stores.
// - An empty (row, block) -- every term's range empty -- is stored as
//   zeros straight from registers with 16-byte streaming stores: no
//   shared-memory zeroing, no barrier, no alive read.  This is exact:
//   its sum is +0.0f, and +0 x {0, 1} = +0; its bits are 0.  A tile
//   stores all of its empty rows before it works on its occupied ones.
// - A tile with a posting stages its block's doc lengths and alive
//   factors (8 KB) and its pairs' coef in shared memory with cp.async,
//   once for all of its rows; postings gather doc lengths there and
//   every occupied row takes alive from that one copy.
// - Sparse tile (at most kListCap postings, the blockdense route's
//   case): an exclusive prefix of the pairs' range lengths numbers the
//   tile's postings, and every thread loads its share of all of them in
//   one round, into a list in pair order.  Each thread then sums its
//   own four slots of each occupied row by walking the row's list in
//   term order, in registers: no atomics, no barrier per term.
// - Dense tile (heavy terms): each occupied row accumulates in shared
//   memory (a 1024-float sum and 1024 presence words); each thread
//   loads its posting of every term in one round when the row has at
//   most kTermRegs terms and no range longer than the CTA, and the
//   terms are added in order with a barrier between them.  A term holds
//   at most one posting per slot, so no two adds of one term collide.
// - In both, a slot's contributions are added in term order, as the
//   reference adds them, and every float operation is an explicitly
//   rounded intrinsic, so nvcc cannot contract C2 * dl + (ltf + C1)
//   into an FMA: the kernel rounds exactly as the twin and the
//   reference do.
//
// nvcc -Xptxas -v (sm_90a, nvcc 12.9): 59 registers in each of the four
// instantiations, no spills, no static shared memory; 35,140 B of
// dynamic shared memory a CTA (kSmemBytes), so four CTAs of 256 threads
// fit an SM.  Measured against the variants tools/segsum_variants.py
// builds: PERF.md section 6.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBlockSlots = 1024;
constexpr int kThreads = 256;         // CTA size (32-256, a power of two)
constexpr int kCtasPerSm = 4;         // persistent grid: SMs x this
constexpr int kTileRows = 64;         // most rows of one tile
constexpr int kPairsPerThread = 2;    // bounds pairs a thread fetches a tile
constexpr int kListPerThread = 2;     // postings a thread loads a list round
constexpr int kTermRegs = 8;          // terms of one posting round (dense)

constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairs = kThreads * kPairsPerThread;
constexpr int kListCap = kThreads * kListPerThread;
constexpr int kVecs = kBlockSlots / 4;     // float4 / uint4 per block row
constexpr int kVecsPerThread = kVecs / kThreads;
static_assert(kVecs % kThreads == 0 && kThreads % 32 == 0,
              "kThreads must be a power of two from 32 to 256");

// Dynamic shared memory, in bytes: bounds pairs and coef of the tile's
// (row, term) pairs; the postings list of a sparse tile; the
// accumulator and presence words of a dense one; the block's staged
// doc lengths and alive factors; the pairs' exclusive prefix of range
// lengths and its per-warp sums; row flags.
constexpr int kOffRng = 0;
constexpr int kOffCoef = kOffRng + 8 * kMaxPairs;
constexpr int kOffList = kOffCoef + 16 * kMaxPairs;
constexpr int kOffAcc = kOffList + 8 * kListCap;
constexpr int kOffPres = kOffAcc + 4 * kBlockSlots;
constexpr int kOffDl = kOffPres + 4 * kBlockSlots;
constexpr int kOffAl = kOffDl + 4 * kBlockSlots;
constexpr int kOffPre = kOffAl + 4 * kBlockSlots;
constexpr int kOffWsum = kOffPre + 4 * (kMaxPairs + 1);
constexpr int kOffFlag = kOffWsum + 4 * kPairsPerThread * kWarps;
constexpr int kSmemBytes = kOffFlag + 4 * kTileRows;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Tile {
  int g, r0, rows, pairs;
};

__device__ __forceinline__ Tile tile_of(int t, int n_chunks, int tile_rows,
                                        int n_rows, int n_terms) {
  Tile tl;
  tl.g = t / n_chunks;
  tl.r0 = (t - tl.g * n_chunks) * tile_rows;
  tl.rows = min(tile_rows, n_rows - tl.r0);
  tl.pairs = tl.rows * n_terms;
  return tl;
}

// This thread's bounds pairs of tile ``tl``: pair p = (row r0 + p / Q,
// term p % Q), its word (n * Q + q) * (G + 1) + g and the next one.
__device__ __forceinline__ void fetch_pairs(const int32_t* __restrict__ bounds,
                                            const Tile& tl, int n_terms,
                                            int n_blocks, int* lo, int* hi) {
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    const int p = threadIdx.x + k * kThreads;
    lo[k] = 0;
    hi[k] = 0;
    if (p < tl.pairs) {
      const size_t at =
          (size_t)(tl.r0 * n_terms + p) * (n_blocks + 1) + tl.g;
      lo[k] = bounds[at];
      hi[k] = bounds[at + 1];
    }
  }
}

template <bool kBM25>
__device__ __forceinline__ float contrib(float ltf, const float4& cf,
                                         float dl) {
  if (kBM25) {
    const float den = __fadd_rn(__fadd_rn(ltf, cf.y), __fmul_rn(cf.z, dl));
    return __fdiv_rn(__fmul_rn(ltf, cf.x), den);
  }
  return __fmul_rn(ltf, cf.x);
}

// a.<s> += c and b.<s> |= bit for lane s (0-3) of a slot's vector.
__device__ __forceinline__ void add_lane(float4& a, uint4& b, int s, float c,
                                         uint32_t bit) {
  if (s == 0) {
    a.x = __fadd_rn(a.x, c);
    b.x |= bit;
  } else if (s == 1) {
    a.y = __fadd_rn(a.y, c);
    b.y |= bit;
  } else if (s == 2) {
    a.z = __fadd_rn(a.z, c);
    b.z |= bit;
  } else {
    a.w = __fadd_rn(a.w, c);
    b.w |= bit;
  }
}

template <bool kBM25, bool kMask>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
segsum_kernel(const int32_t* __restrict__ pslot,   // [P] slot-sorted per term
              const float* __restrict__ pltf,      // [P]
              const float* __restrict__ dlen,      // [S], 16-byte aligned
              const float* __restrict__ alive,     // [S] 0/1, 16-byte aligned
              const int32_t* __restrict__ bounds,  // [N, Q, G + 1]
              const float4* __restrict__ coef,     // [N, Q]: idf, C1, C2, 0
              float* __restrict__ out,             // [N, S]
              uint32_t* __restrict__ bits_out,     // [N, S]
              int n_rows, int n_terms, int n_blocks, int tile_rows,
              int n_chunks, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* rng = reinterpret_cast<int2*>(smem + kOffRng);
  float4* cf_s = reinterpret_cast<float4*>(smem + kOffCoef);
  int2* list = reinterpret_cast<int2*>(smem + kOffList);
  float* acc = reinterpret_cast<float*>(smem + kOffAcc);
  uint32_t* pres = reinterpret_cast<uint32_t*>(smem + kOffPres);
  float* dl_s = reinterpret_cast<float*>(smem + kOffDl);
  float* al_s = reinterpret_cast<float*>(smem + kOffAl);
  int* pre = reinterpret_cast<int*>(smem + kOffPre);
  int* wsum = reinterpret_cast<int*>(smem + kOffWsum);
  int* flag = reinterpret_cast<int*>(smem + kOffFlag);

  const size_t n_slots = (size_t)n_blocks * kBlockSlots;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int r = tid; r < kTileRows; r += kThreads) flag[r] = 0;

  int lo[kPairsPerThread], hi[kPairsPerThread];
  int t = blockIdx.x;
  if (t < n_tiles) {
    fetch_pairs(bounds, tile_of(t, n_chunks, tile_rows, n_rows, n_terms),
                n_terms, n_blocks, lo, hi);
  }
  for (int epoch = 1; t < n_tiles; t += gridDim.x, ++epoch) {
    const Tile tl = tile_of(t, n_chunks, tile_rows, n_rows, n_terms);
    const int base = tl.g * kBlockSlots;

    // The previous tile is done with shared memory; publish this one's
    // pairs and mark the rows that hold a posting.
    __syncthreads();
    int any = 0;
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
      const int p = tid + k * kThreads;
      if (p < tl.pairs) {
        rng[p] = make_int2(lo[k], hi[k]);
        if (lo[k] < hi[k]) {
          flag[p / n_terms] = epoch;
          any = 1;
        }
      }
    }
    const bool busy = __syncthreads_or(any) != 0;

    // A tile with a posting: stage the block's columns and the pairs'
    // coef, and number the tile's postings (pair by pair, in order)
    // with an exclusive prefix of the range lengths.  A sparse tile's
    // postings (at most kListCap) are loaded now, in one round.
    int n_list = 0;
    int list_slot[kListPerThread], list_pair[kListPerThread];
    float list_ltf[kListPerThread];
    if (busy) {
#pragma unroll
      for (int k = 0; k < kVecsPerThread; ++k) {
        const int v = 4 * (tid + k * kThreads);
        cp_async16(dl_s + v, dlen + base + v);
        cp_async16(al_s + v, alive + base + v);
      }
#pragma unroll
      for (int k = 0; k < kPairsPerThread; ++k) {
        const int p = tid + k * kThreads;
        if (p < tl.pairs) {
          cp_async16(cf_s + p, coef + (size_t)tl.r0 * n_terms + p);
        }
      }
      cp_async_commit();
      int cnt[kPairsPerThread], incl[kPairsPerThread];
#pragma unroll
      for (int k = 0; k < kPairsPerThread; ++k) {
        const int p = tid + k * kThreads;
        cnt[k] = p < tl.pairs ? max(hi[k] - lo[k], 0) : 0;
        int x = cnt[k];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, d);
          if (lane >= d) x += y;
        }
        incl[k] = x;
        if (lane == 31) wsum[k * kWarps + warp] = x;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPairsPerThread; ++k) {
        const int p = tid + k * kThreads;
        int before = 0;
        for (int i = 0; i < k * kWarps + warp; ++i) before += wsum[i];
        if (p < tl.pairs) pre[p] = before + incl[k] - cnt[k];
      }
      for (int i = 0; i < kPairsPerThread * kWarps; ++i) n_list += wsum[i];
      if (tid == 0) pre[tl.pairs] = n_list;
      __syncthreads();
      if (n_list <= kListCap) {
#pragma unroll
        for (int k = 0; k < kListPerThread; ++k) {
          const int e = tid + k * kThreads;
          list_pair[k] = -1;
          if (e < n_list) {
            // The pair whose range holds posting e: the last p with
            // pre[p] <= e (empty pairs share their successor's prefix).
            int a = 0, b = tl.pairs;
            while (b - a > 1) {
              const int m = (a + b) >> 1;
              if (pre[m] <= e) {
                a = m;
              } else {
                b = m;
              }
            }
            const int j = rng[a].x + (e - pre[a]);
            list_pair[k] = a;
            list_slot[k] = pslot[j];
            list_ltf[k] = pltf[j];
          }
        }
      }
    }
    if (t + (int)gridDim.x < n_tiles) {
      fetch_pairs(bounds,
                  tile_of(t + gridDim.x, n_chunks, tile_rows, n_rows,
                          n_terms),
                  n_terms, n_blocks, lo, hi);
    }

    // Empty rows: zeros from registers.
    for (int r = 0; r < tl.rows; ++r) {
      if (flag[r] == epoch) continue;
      const size_t at = (size_t)(tl.r0 + r) * n_slots + base;
#pragma unroll
      for (int k = 0; k < kVecsPerThread; ++k) {
        const int v = tid + k * kThreads;
        __stcs(reinterpret_cast<float4*>(out + at) + v,
                make_float4(0.f, 0.f, 0.f, 0.f));
        __stcs(reinterpret_cast<uint4*>(bits_out + at) + v,
                make_uint4(0u, 0u, 0u, 0u));
      }
    }
    if (!busy) continue;

    if (n_list <= kListCap) {
      // Sparse tile: the list of (slot offset, pair) and ltf; each
      // thread then sums its own slots of each occupied row, walking
      // the row's postings in term order, in registers.
#pragma unroll
      for (int k = 0; k < kListPerThread; ++k) {
        const int e = tid + k * kThreads;
        if (e < n_list) {
          const int o = list_slot[k] - base;
          const int key = (o >= 0 && o < kBlockSlots)
                              ? (o | (list_pair[k] << 10)) : -1;
          list[e] = make_int2(key, __float_as_int(list_ltf[k]));
        }
      }
      cp_async_wait_all();
      __syncthreads();
      for (int r = 0; r < tl.rows; ++r) {
        if (flag[r] != epoch) continue;
        const int e1 = pre[(r + 1) * n_terms];
        float4 a[kVecsPerThread];
        uint4 b[kVecsPerThread];
#pragma unroll
        for (int k = 0; k < kVecsPerThread; ++k) {
          a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
          b[k] = make_uint4(0u, 0u, 0u, 0u);
        }
        for (int e = pre[r * n_terms]; e < e1; ++e) {
          const int2 ent = list[e];
          if (ent.x < 0) continue;
          const int o = ent.x & (kBlockSlots - 1);
          const int v = o >> 2;
          if ((v & (kThreads - 1)) != tid) continue;
          const int p = ent.x >> 10;
          const float c = contrib<kBM25>(__int_as_float(ent.y), cf_s[p],
                                         dl_s[o]);
          const uint32_t bit = kMask ? 1u << min(p - r * n_terms, 31) : 0u;
#pragma unroll
          for (int k = 0; k < kVecsPerThread; ++k) {
            if (k == v / kThreads) add_lane(a[k], b[k], o & 3, c, bit);
          }
        }
        const size_t at = (size_t)(tl.r0 + r) * n_slots + base;
#pragma unroll
        for (int k = 0; k < kVecsPerThread; ++k) {
          const int v = tid + k * kThreads;
          const float4 f = reinterpret_cast<const float4*>(al_s)[v];
          __stcs(reinterpret_cast<float4*>(out + at) + v,
                  make_float4(__fmul_rn(a[k].x, f.x), __fmul_rn(a[k].y, f.y),
                              __fmul_rn(a[k].z, f.z),
                              __fmul_rn(a[k].w, f.w)));
          __stcs(reinterpret_cast<uint4*>(bits_out + at) + v, b[k]);
        }
      }
      continue;
    }

    // Dense tile: each occupied row accumulates in shared memory,
    // terms in order.
    cp_async_wait_all();
    for (int r = 0; r < tl.rows; ++r) {
      if (flag[r] != epoch) continue;
      const int n = tl.r0 + r;
      const int2* rr = rng + r * n_terms;
      const float4* cr = cf_s + r * n_terms;
      // Each thread zeroes the words it stores at the end; the barrier
      // below orders them before any add.
#pragma unroll
      for (int k = 0; k < kVecsPerThread; ++k) {
        const int v = tid + k * kThreads;
        reinterpret_cast<float4*>(acc)[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        reinterpret_cast<uint4*>(pres)[v] = make_uint4(0u, 0u, 0u, 0u);
      }
      int longest = 0;
      for (int q = 0; q < n_terms; ++q) {
        longest = max(longest, rr[q].y - rr[q].x);
      }
      if (n_terms <= kTermRegs && longest <= kThreads) {
        // One round: this thread's posting of every term, loaded
        // together; then the adds, term by term.
        int off[kTermRegs];
        float ltf[kTermRegs];
#pragma unroll
        for (int q = 0; q < kTermRegs; ++q) {
          off[q] = -1;
          ltf[q] = 0.f;
          if (q < n_terms) {
            const int2 b = rr[q];
            const int j = b.x + tid;
            if (j < b.y) {
              off[q] = pslot[j] - base;
              ltf[q] = pltf[j];
            }
          }
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kTermRegs; ++q) {
          if (q >= n_terms) break;
          const int2 b = rr[q];
          if (b.x >= b.y) continue;   // uniform across the CTA
          const int o = off[q];
          if (o >= 0 && o < kBlockSlots) {
            acc[o] = __fadd_rn(acc[o], contrib<kBM25>(ltf[q], cr[q],
                                                      dl_s[o]));
            if (kMask) pres[o] |= 1u << min(q, 31);
          }
          __syncthreads();   // the next term adds after this one
        }
      } else {
        __syncthreads();
        for (int q = 0; q < n_terms; ++q) {
          const int2 b = rr[q];
          if (b.x >= b.y) continue;   // uniform across the CTA
          const uint32_t bit = 1u << min(q, 31);
          for (int j = b.x + tid; j < b.y; j += kThreads) {
            const int o = pslot[j] - base;
            if (o < 0 || o >= kBlockSlots) continue;
            acc[o] = __fadd_rn(acc[o], contrib<kBM25>(pltf[j], cr[q],
                                                      dl_s[o]));
            if (kMask) pres[o] |= bit;
          }
          __syncthreads();   // the next term adds after this one
        }
      }
      const size_t at = (size_t)n * n_slots + base;
#pragma unroll
      for (int k = 0; k < kVecsPerThread; ++k) {
        const int v = tid + k * kThreads;
        const float4 a = reinterpret_cast<const float4*>(acc)[v];
        const float4 f = reinterpret_cast<const float4*>(al_s)[v];
        __stcs(reinterpret_cast<float4*>(out + at) + v,
                make_float4(__fmul_rn(a.x, f.x), __fmul_rn(a.y, f.y),
                            __fmul_rn(a.z, f.z), __fmul_rn(a.w, f.w)));
        __stcs(reinterpret_cast<uint4*>(bits_out + at) + v,
                reinterpret_cast<const uint4*>(pres)[v]);
      }
    }
  }
}

template <bool kBM25, bool kMask>
int launch(cudaStream_t stream, const void* pslot, const void* pltf,
           const void* dlen, const void* alive, const void* bounds,
           const void* coef, void* out, void* bits, int n_rows, int n_terms,
           int n_blocks) {
  auto kernel = segsum_kernel<kBM25, kMask>;
  if (kSmemBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
  }
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e != cudaSuccess) return (int)e;
  const int tile_rows = std::min(
      {n_rows, kTileRows, std::max(1, kMaxPairs / std::max(n_terms, 1))});
  const int n_chunks = (n_rows + tile_rows - 1) / tile_rows;
  const long long tiles = (long long)n_blocks * n_chunks;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)tiles;
  const int grid = (int)std::min((long long)sms * kCtasPerSm, tiles);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      (const int32_t*)pslot, (const float*)pltf, (const float*)dlen,
      (const float*)alive, (const int32_t*)bounds, (const float4*)coef,
      (float*)out, (uint32_t*)bits, n_rows, n_terms, n_blocks, tile_rows,
      n_chunks, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  algo: 0 BM25, 1 TF-IDF.
// doc lengths and alive factors must be 16-byte aligned (cp.async).
// Launches on ``stream`` and returns the CUDA error of the launch (or
// of setting the kernel's shared-memory size): 0 on success;
// cudaErrorInvalidValue for more terms than one tile's pairs hold.
extern "C" int nxs_segsum_blockdense(const void* pslot, const void* pltf,
                                     const void* dlen, const void* alive,
                                     const void* bounds, const void* coef,
                                     void* out, void* bits, int n_queries,
                                     int n_terms, int n_blocks, int algo,
                                     int use_mask, void* stream) {
  if (n_queries <= 0 || n_blocks <= 0) return 0;
  if (n_terms < 0 || n_terms > kMaxPairs) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (algo == 0) {
    return use_mask
        ? launch<true, true>(s, pslot, pltf, dlen, alive, bounds, coef, out,
                             bits, n_queries, n_terms, n_blocks)
        : launch<true, false>(s, pslot, pltf, dlen, alive, bounds, coef,
                              out, bits, n_queries, n_terms, n_blocks);
  }
  return use_mask
      ? launch<false, true>(s, pslot, pltf, dlen, alive, bounds, coef, out,
                            bits, n_queries, n_terms, n_blocks)
      : launch<false, false>(s, pslot, pltf, dlen, alive, bounds, coef, out,
                             bits, n_queries, n_terms, n_blocks);
}
