// classify_lca and rank_hist: the tail of every classification step for
// Hopper (sm_90a).
//
// classify_lca: the ranked LCA of a read's top candidates, which JAX
// leaves to XLA (metacache_tpu/ops/pipeline.py:317-361,
// classify_candidates), and in its lookup form also the candidate-taxon
// lookup before it (metacache_tpu/ops/rows.py:171-173). Per read: the
// float32 threshold (hits0 - hits_min) * frac where hits0 > hits_min,
// else 0; candidate k is included while every candidate up to it exists
// (taxon != 0) and has more hits than the threshold (candidate 0 is
// included where it exists); r0 is the first rank >= merge_rank at which
// candidate 0's lineage is set; the LCA rank is the first rank >= r0 at
// which candidate 0's lineage is set and every included candidate's
// lineage agrees with it; the read's taxon is candidate 0's lineage at
// that rank where candidate 0 exists with hits0 >= hits_min and the rank
// is at most highest_rank, else 0.
//
// One warp a read, one lane a rank (R <= 32): lane k loads candidate
// k's target, hits and taxon (one coalesced load each, 32 candidates at
// a time), the warp walks the candidates in order by shuffles and stops
// at the first one left out, each included candidate's lineage row is
// one coalesced R-lane load, the agreement is one compare a lane, and
// r0 and the LCA rank are two ballots (__ffs). The threshold is
// __int2float_rn and __fmul_rn, so that no contraction changes a
// rounding against the plain version's float32 multiply. Lineage rows
// and lookups are clamped into their tables, as XLA's gathers clamp.
// Bound: device-memory bytes, the candidates' three ints and the
// included candidates' lineage rows a read (about 1.6 MB at 8192 reads
// and K = 2), so a launch sits at its launch floor.
//
// rank_hist: the summary's rank histogram, which JAX leaves to XLA
// (metacache_tpu/classify/runner.py:76-128): each read's taxon searched
// in the ascending taxon ids (lower bound, clamped to the last), its
// rank where found and not 0, else num_ranks; reads at or past n, and
// reads whose bit is set in the overflow mask (32 reads a word), count
// in bin num_ranks + 1. Each block counts in shared memory, a warp's
// lanes of one bin added at once (__match_any_sync, the group's leader
// adds the group's size), then adds each bin once to the zeroed int64
// output; integer counts, so the order of the atomics changes nothing.
// Bound: device-memory bytes, 4 bytes a read and the tables once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBins = 64;
constexpr int kMaxHistBlocks = 512;

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t nrows) {
  return r < 0 ? 0 : (r >= nrows ? nrows - 1 : r);
}

template <bool LOOKUP>
__global__ void __launch_bounds__(kThreads)
lca_kernel(const int32_t* __restrict__ tgt, const int32_t* __restrict__ hits,
           const int32_t* __restrict__ tax_in,
           const int32_t* __restrict__ merge_tax, int64_t ntax,
           const int32_t* __restrict__ lin, int64_t nlin, int r, int64_t b,
           int k, int hits_min, float frac, int highest, int merge_rank,
           int32_t* __restrict__ tax_out, int32_t* __restrict__ cls) {
  const int64_t read = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (read >= b) return;  // the whole warp: one read a warp
  const int64_t row = read * k;
  bool inc = true;        // every candidate so far is included
  bool agree = false;     // this lane's rank is set and agreed on
  bool valid0 = false;
  float thr = 0.f;
  int32_t lin0 = 0;
  for (int base = 0; base < k; base += 32) {
    const int c = base + lane;
    int32_t t = -1, h = 0, x = 0;
    if (c < k) {
      t = tgt[row + c];
      h = hits[row + c];
      if constexpr (LOOKUP) {
        x = t >= 0 ? merge_tax[clamp_row(t, ntax)] : 0;
        tax_out[row + c] = x;
      } else {
        x = tax_in[row + c];
      }
    }
    const int m = k - base < 32 ? k - base : 32;
    for (int j = 0; j < m && inc; ++j) {   // inc is the warp's
      const int32_t tj = __shfl_sync(kFull, t, j);
      const int32_t hj = __shfl_sync(kFull, h, j);
      const bool ej = __shfl_sync(kFull, x, j) != 0;
      if (base + j == 0) {
        valid0 = ej && hj >= hits_min;
        thr = hj > hits_min
                  ? __fmul_rn(__int2float_rn(hj - hits_min), frac)
                  : 0.f;
        inc = ej;
      } else {
        inc = ej && __int2float_rn(hj) > thr;
      }
      if (!inc) break;
      const int32_t lj =
          lane < r ? lin[clamp_row(tj < 0 ? 0 : tj, nlin) * r + lane] : 0;
      if (base + j == 0) {
        lin0 = lj;
        agree = lj != 0;
      } else {
        agree = agree && lj == lin0;
      }
    }
  }
  const unsigned e0 = __ballot_sync(kFull, lin0 != 0 && lane >= merge_rank);
  const int r0 = e0 ? __ffs(e0) - 1 : r;
  const unsigned el = __ballot_sync(kFull, agree && lane >= r0);
  const int lca = el ? __ffs(el) - 1 : r;
  const int32_t tax = __shfl_sync(kFull, lin0, lca < r ? lca : r - 1);
  if (lane == 0) cls[read] = valid0 && el && lca <= highest ? tax : 0;
}

__global__ void __launch_bounds__(kThreads)
rank_hist_kernel(const int32_t* __restrict__ cls, int64_t m, int64_t n,
                 const int32_t* __restrict__ taxid, int nt,
                 const int32_t* __restrict__ rank_of,
                 const int32_t* __restrict__ over, int num_ranks,
                 unsigned long long* __restrict__ out) {
  __shared__ unsigned bins[kMaxBins];
  const int nbins = num_ranks + 2;
  for (int i = threadIdx.x; i < nbins; i += kThreads) bins[i] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  // every lane of a warp takes the same number of turns (the shuffles)
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < m;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    int bin = -1;
    if (i < m) {
      if (i >= n || (over && (((uint32_t)over[i >> 5] >> (i & 31)) & 1u))) {
        bin = num_ranks + 1;
      } else {
        const int32_t c = cls[i];
        int lo = 0, hi = nt;   // the first id >= c
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (taxid[mid] < c)
            lo = mid + 1;
          else
            hi = mid;
        }
        const int pos = lo < nt ? lo : nt - 1;
        bin = c != 0 && taxid[pos] == c ? rank_of[pos] : num_ranks;
      }
      if (bin >= nbins) bin = -1;    // past the bins kept, as bincount's
    }
    const unsigned peers = __match_any_sync(kFull, bin);
    if (bin >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&bins[bin], (unsigned)__popc(peers));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += kThreads)
    if (bins[i]) atomicAdd(&out[i], (unsigned long long)bins[i]);
}

}  // namespace

// tax null: the lookup form (merge_tax, ntax rows), which writes the
// candidates' taxa to tax_out; else tax holds them
extern "C" int mc_classify_lca(const void* tgt, const void* hits,
                               const void* tax, const void* merge_tax,
                               int64_t ntax, const void* lin, int64_t nlin,
                               int r, int64_t b, int k, int hits_min,
                               float frac, int highest, int merge_rank,
                               void* tax_out, void* cls, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (k < 1 || r < 1 || r > 32 || nlin < 1 ||
      (tax == nullptr && (merge_tax == nullptr || ntax < 1 ||
                          tax_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((b * 32 + kThreads - 1) / kThreads);
  auto kernel = tax ? lca_kernel<false> : lca_kernel<true>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tgt, (const int32_t*)hits, (const int32_t*)tax,
      (const int32_t*)merge_tax, ntax, (const int32_t*)lin, nlin, r, b, k,
      hits_min, frac, highest, merge_rank, (int32_t*)tax_out,
      (int32_t*)cls);
  return (int)cudaGetLastError();
}

// out: num_ranks + 2 zeroed int64 bins; over null: no overflow mask
extern "C" int mc_rank_hist(const void* cls, int64_t m, int64_t n,
                            const void* taxid, int64_t nt,
                            const void* rank_of, const void* over,
                            int num_ranks, void* out, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  if (nt < 1 || nt > 0x7FFFFFFF || num_ranks < 0 ||
      num_ranks + 2 > kMaxBins)
    return (int)cudaErrorInvalidValue;
  int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > kMaxHistBlocks) blocks = kMaxHistBlocks;
  rank_hist_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cls, m, n, (const int32_t*)taxid, (int)nt,
      (const int32_t*)rank_of, (const int32_t*)over, num_ranks,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}
