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
// A group of 8 lanes a read, 4 reads a warp; lane g of a group holds
// ranks 4g .. 4g + 3 (R <= 32). The candidates go in turns of 8, lane g
// holding candidate g of the turn. A turn issues its loads in two
// rounds and decides nothing before both: first every candidate's
// target and hits (and taxon where given), then, at once, the lookup's
// merge_tax[t] and every candidate's lineage chunk (up to four 4-byte
// loads a lane, in place at the rows' stride), so a read waits on two
// round trips, not on one a candidate. Then the group walks the turn's
// candidates in registers (their hits and taxa by shuffles within the
// group) and stops at the first one left out; agreement is kept as a
// bit a rank, and r0 and the LCA rank are the first set bits of the
// group's 32-bit masks (OR-reduced over the group by three shuffles).
// The threshold is __int2float_rn and __fmul_rn, so that no contraction
// changes a rounding against the plain version's float32 multiply.
// Lineage rows and lookups are clamped into their tables, as XLA's
// gathers clamp. It launches as a programmatic dependent: it may start
// while the kernel before it runs and waits (griddepcontrol.wait)
// before its first read of the candidates, which that kernel wrote.
// Bound: device-memory bytes, the candidates' ints and the included
// candidates' lineage rows a read (about 1.6 MB at 8192 reads and
// K = 2).
//
// rank_hist: the summary's rank histogram, which JAX leaves to XLA
// (metacache_tpu/classify/runner.py:76-128): each read's taxon searched
// in the ascending taxon ids (lower bound, clamped to the last), its
// rank where found and not 0, else num_ranks; reads at or past n, and
// reads whose bit is set in the overflow mask (32 reads a word), count
// in bin num_ranks + 1; bins past num_ranks + 1 are dropped. One launch
// writes every bin. Each block stages the taxon table in shared memory
// (ids and ranks, up to kSmemTaxa taxa; past that every 2^s-th id, at
// most kPivots, so the search's first levels run in shared memory and
// its last s in device memory), reads the taxa 16 bytes a thread (a
// quad of reads on the 16-byte grid, the ragged quads at either end by
// 4-byte loads), loads each overflow word once a warp and shuffles it to
// the lanes, searches a thread's four taxa in lockstep (binary lifting,
// so that their loads overlap) and counts in shared memory, a warp's
// lanes of one bin added at once (__match_any_sync). The blocks' counts
// are combined in the same launch: each block adds its bins into sums
// in scratch (device atomics) and takes a ticket after a release fence;
// the last block moves the sums to the output and leaves the sums and
// the ticket at 0, so the scratch needs no fill before a launch; it must
// not be shared by launches that can run at once (the wrapper keeps one
// a stream, and one a captured CUDA graph). Integer counts, so the
// order of the additions changes nothing. It launches as a programmatic
// dependent and waits before its first read. Bound: device-memory
// bytes, 4 bytes a read (and the overflow words) and the tables once.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLcaThreads = 256;
constexpr int kGroup = 8;        // lanes a read
constexpr int kTurn = 8;         // candidates a turn: one a lane
constexpr int kMaxBins = 64;
constexpr int kHistThreads = 512;
constexpr int kMaxHistBlocks = 264;     // two blocks on each of 132 SMs
constexpr int kSmemTaxa = 4096;         // taxa staged whole (ids, ranks)
constexpr int kPivots = 2 * kSmemTaxa;  // pivot ids past that
constexpr int kTicketWords = 4;         // the ticket, then the sums
constexpr int kScratchWords = kTicketWords + 2 * kMaxBins;

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t nrows) {
  return r < 0 ? 0 : (r >= nrows ? nrows - 1 : r);
}

// with a strong write after it a release, with a strong read before it
// an acquire, at device scope (lighter than __threadfence's fence.sc)
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// ranks 4g .. 4g + 3 of a lineage row from ``off`` (left of them in the
// row: the rest read as 0)
__device__ __forceinline__ int4 lin_chunk(const int32_t* __restrict__ lin,
                                          int64_t off, int left) {
  int4 v = make_int4(lin[off], 0, 0, 0);
  if (left > 1) v.y = lin[off + 1];
  if (left > 2) v.z = lin[off + 2];
  if (left > 3) v.w = lin[off + 3];
  return v;
}

__device__ __forceinline__ int at(const int4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// bit q: component q of the chunk is set (of ``ok`` ranks)
__device__ __forceinline__ unsigned set_bits(const int4& v, unsigned ok) {
  return ((v.x != 0) | (v.y != 0) << 1 | (v.z != 0) << 2 |
          (v.w != 0) << 3) & ok;
}

__device__ __forceinline__ unsigned eq_bits(const int4& a, const int4& b) {
  return (a.x == b.x) | (a.y == b.y) << 1 | (a.z == b.z) << 2 |
         (a.w == b.w) << 3;
}

template <bool LOOKUP>
__global__ void __launch_bounds__(kLcaThreads)
lca_kernel(const int32_t* __restrict__ tgt, const int32_t* __restrict__ hits,
           const int32_t* __restrict__ tax_in,
           const int32_t* __restrict__ merge_tax, int64_t ntax,
           const int32_t* __restrict__ lin, int64_t nlin, int64_t lstride,
           int r, int64_t b, int k, int hits_min, float frac, int highest,
           int merge_rank, int32_t* __restrict__ tax_out,
           int32_t* __restrict__ cls) {
  const int64_t read =
      ((int64_t)blockIdx.x * kLcaThreads + threadIdx.x) / kGroup;
  const int g = threadIdx.x & (kGroup - 1);
  const bool live = read < b;    // the whole warp stays for the shuffles
  const int rank0 = 4 * g;       // this lane's first rank
  const int left = r - rank0;    // this lane's ranks in the row
  const unsigned ok = left >= 4 ? 0xfu : left > 0 ? (1u << left) - 1 : 0u;
  const int64_t row = read * k;
  grid_dependency_wait();
  bool inc = live;               // every candidate so far is included
  bool valid0 = false;
  float thr = 0.f;
  int4 lin0 = make_int4(0, 0, 0, 0);
  unsigned agree = 0;            // bit q: rank rank0 + q set and agreed
  for (int base = 0; base < k; base += kTurn) {
    const int m = k - base < kTurn ? k - base : kTurn;   // the warp's
    const int c = base + g;
    const bool mine = live && g < m;
    // round one: the candidates
    int32_t t = -1, h = 0, x = 0;
    if (mine) {
      t = tgt[row + c];
      h = hits[row + c];
      if constexpr (!LOOKUP) x = tax_in[row + c];
    }
    // round two, before any decision: the taxa and every lineage chunk
    if constexpr (LOOKUP) {
      if (mine) x = t >= 0 ? merge_tax[clamp_row(t, ntax)] : 0;
    }
    int4 lj[kTurn];
#pragma unroll
    for (int j = 0; j < kTurn; ++j) {
      lj[j] = make_int4(0, 0, 0, 0);
      if (j < m) {
        const int32_t tj = __shfl_sync(kFull, t, j, kGroup);
        if (inc && left > 0)
          lj[j] = lin_chunk(
              lin, clamp_row(tj < 0 ? 0 : tj, nlin) * lstride + rank0, left);
      }
    }
    if constexpr (LOOKUP) {
      if (mine) tax_out[row + c] = x;
    }
    // the walk, in registers
#pragma unroll
    for (int j = 0; j < kTurn; ++j) {
      if (j < m) {
        const int32_t hj = __shfl_sync(kFull, h, j, kGroup);
        const bool ej = __shfl_sync(kFull, x, j, kGroup) != 0;
        if (inc) {
          if (base + j == 0) {
            valid0 = ej && hj >= hits_min;
            thr = hj > hits_min
                      ? __fmul_rn(__int2float_rn(hj - hits_min), frac)
                      : 0.f;
            inc = ej;
            if (inc) {
              lin0 = lj[j];
              agree = set_bits(lin0, ok);
            }
          } else {
            inc = ej && __int2float_rn(hj) > thr;
            if (inc) agree &= eq_bits(lj[j], lin0);
          }
        }
      }
    }
  }
  // the group's masks of 32 ranks: rank 4g + q at bit 4g + q
  const unsigned lo = merge_rank <= rank0 ? 0xfu
                      : merge_rank >= rank0 + 4
                          ? 0u
                          : (0xfu << (merge_rank - rank0)) & 0xfu;
  unsigned e0 = (set_bits(lin0, ok) & lo) << rank0;
  unsigned ea = agree << rank0;
#pragma unroll
  for (int s = 1; s < kGroup; s <<= 1) {
    e0 |= __shfl_xor_sync(kFull, e0, s);
    ea |= __shfl_xor_sync(kFull, ea, s);
  }
  const int r0 = e0 ? __ffs(e0) - 1 : r;
  const unsigned el = r0 < 32 ? ea & (kFull << r0) : 0u;
  const int lca = el ? __ffs(el) - 1 : r;
  const int at_rank = lca < r ? lca : r - 1;
  const int32_t tax =
      __shfl_sync(kFull, at(lin0, at_rank & 3), at_rank >> 2, kGroup);
  if (live && g == 0) cls[read] = valid0 && el && lca <= highest ? tax : 0;
}

struct HistArgs {
  const int32_t* cls;
  int64_t m, n;
  const int32_t* taxid;
  const int32_t* rank_of;
  const int32_t* over;
  int nt;
  int shift;      // -1: the whole table in shared memory; else pivots
  int np;         // pivots: every 2^shift-th id
  int top;        // the largest power of two <= nt (np with pivots)
  int head;       // reads before cls in its 16-byte segment
  int num_ranks;
};

// the bins of four taxa: each one's rank where found and not 0, else
// num_ranks, -1 past the bins kept (as bincount's). Each lower bound is
// the count of ids < c, found by binary lifting, the four searches in
// lockstep so that their loads overlap: over the whole table in shared
// memory, or over the pivots there and then the 2^shift - 1 ids after
// the pivot found, in device memory.
__device__ __forceinline__ void hist_bins4(const HistArgs& a,
                                           const int32_t* s_tab,
                                           const int32_t (&c)[4],
                                           int (&bin)[4]) {
  int64_t at[4];
  int32_t id[4], rk[4];
  if (a.shift < 0) {
    int p[4] = {0, 0, 0, 0};
    for (int s = a.top; s > 0; s >>= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (p[i] + s <= a.nt && s_tab[p[i] + s - 1] < c[i]) p[i] += s;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      at[i] = p[i] < a.nt ? p[i] : a.nt - 1;
      id[i] = s_tab[at[i]];
      rk[i] = s_tab[kSmemTaxa + at[i]];
    }
  } else {
    int q[4] = {0, 0, 0, 0};   // the pivots < c
    for (int s = a.top; s > 0; s >>= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (q[i] + s <= a.np && s_tab[q[i] + s - 1] < c[i]) q[i] += s;
    }
    int64_t j[4], lim[4];      // j: the last id known < c (-1: none)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      j[i] = q[i] ? (int64_t)(q[i] - 1) << a.shift : -1;
      lim[i] = (int64_t)q[i] << a.shift;
      if (lim[i] > a.nt) lim[i] = a.nt;
    }
    for (int64_t s = a.shift ? (int64_t)1 << (a.shift - 1) : 0; s > 0;
         s >>= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (j[i] >= 0 && j[i] + s < lim[i] && a.taxid[j[i] + s] < c[i])
          j[i] += s;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      at[i] = j[i] + 1 < a.nt ? j[i] + 1 : a.nt - 1;
      id[i] = a.taxid[at[i]];
      rk[i] = a.rank_of[at[i]];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = c[i] != 0 && id[i] == c[i] ? rk[i] : a.num_ranks;
    bin[i] = b >= 0 && b < a.num_ranks + 2 ? b : -1;
  }
}

// stage the table, count this block's quads into bins (shared memory)
__device__ __forceinline__ void hist_count(const HistArgs& a,
                                           int32_t* s_tab, unsigned* bins,
                                           int64_t first, int64_t stride) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nbins = a.num_ranks + 2;
  for (int i = tid; i < nbins; i += kHistThreads) bins[i] = 0;
  grid_dependency_wait();
  const int64_t nq = (a.m + a.head + 3) >> 2;
  const int4* quads = reinterpret_cast<const int4*>(a.cls - a.head);
  const int64_t nwords = (a.m + 31) >> 5;
  bool staged = false;
  for (int64_t q0 = first; q0 < nq; q0 += stride) {   // the block's
    const int64_t q = q0 + tid;
    const int64_t p0 = 4 * q - a.head;    // the position of its first read
    // the quad's taxa first, so that their loads overlap the staging
    int32_t c[4] = {0, 0, 0, 0};
    if (q < nq) {
      if (p0 >= 0 && p0 + 3 < a.m) {
        const int4 v = __ldg(quads + q);
        c[0] = v.x, c[1] = v.y, c[2] = v.z, c[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (p0 + i >= 0 && p0 + i < a.m) c[i] = a.cls[p0 + i];
      }
    }
    // the overflow words of the warp's 128 reads (at most 5), one load
    // each, shuffled to the lanes
    unsigned wa = 0, wb = 0;
    if (a.over) {
      const int64_t wbase = (4 * (q - lane) - a.head) >> 5;
      const int64_t w = wbase + lane;
      const unsigned word =
          lane < 5 && w >= 0 && w < nwords ? (unsigned)a.over[w] : 0u;
      wa = __shfl_sync(kFull, word, (int)((p0 >> 5) - wbase));
      wb = __shfl_sync(kFull, word, (int)(((p0 + 3) >> 5) - wbase));
    }
    if (!staged) {
      if (a.shift < 0) {
        for (int i = tid; i < a.nt; i += kHistThreads) {
          s_tab[i] = a.taxid[i];
          s_tab[kSmemTaxa + i] = a.rank_of[i];
        }
      } else {
        for (int i = tid; i < a.np; i += kHistThreads)
          s_tab[i] = a.taxid[(int64_t)i << a.shift];
      }
      __syncthreads();
      staged = true;
    }
    int bin[4];
    hist_bins4(a, s_tab, c, bin);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t p = p0 + i;
      if (q >= nq || p < 0 || p >= a.m) {
        bin[i] = -1;
      } else {
        const unsigned w = (p >> 5) == (p0 >> 5) ? wa : wb;
        if (p >= a.n || ((w >> (p & 31)) & 1u)) bin[i] = a.num_ranks + 1;
      }
      const unsigned peers = __match_any_sync(kFull, bin[i]);
      if (bin[i] >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&bins[bin[i]], (unsigned)__popc(peers));
    }
  }
  __syncthreads();
}

// every block adds its bins into the scratch's sums (device atomics);
// the last block to take a ticket moves the sums to the output and
// leaves the scratch zeroed. Warp 0 of a block does it all.
__global__ void __launch_bounds__(kHistThreads)
rank_hist_kernel(HistArgs a, unsigned* __restrict__ scratch,
                 unsigned long long* __restrict__ out) {
  __shared__ int32_t s_tab[kPivots];
  __shared__ unsigned bins[kMaxBins];
  hist_count(a, s_tab, bins, (int64_t)blockIdx.x * kHistThreads,
             (int64_t)gridDim.x * kHistThreads);
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int nbins = a.num_ranks + 2;
  unsigned long long* sums =
      reinterpret_cast<unsigned long long*>(scratch + kTicketWords);
  for (int b = lane; b < nbins; b += 32)
    if (bins[b]) atomicAdd(sums + b, (unsigned long long)bins[b]);
  fence_acq_rel();
  __syncwarp();          // every lane's sums before lane 0's ticket
  unsigned ticket = 0;
  if (lane == 0) ticket = atomicAdd(scratch, 1u);
  if (__shfl_sync(kFull, ticket, 0) != gridDim.x - 1) return;
  fence_acq_rel();
  for (int b = lane; b < nbins; b += 32) {
    out[b] = __ldcg(sums + b);
    sums[b] = 0;
  }
  if (lane == 0) scratch[0] = 0;    // the ticket, for the next launch
}

unsigned lca_blocks(int64_t b) {
  return (unsigned)((b * kGroup + kLcaThreads - 1) / kLcaThreads);
}

unsigned hist_blocks(int64_t m) {
  const int64_t nq = (m + 3 + 3) / 4;     // at most one ragged quad more
  int64_t blocks = (nq + kHistThreads - 1) / kHistThreads;
  return (unsigned)(blocks < 1 ? 1 : blocks > kMaxHistBlocks
                                         ? kMaxHistBlocks : blocks);
}

}  // namespace

// tax null: the lookup form (merge_tax, ntax rows), which writes the
// candidates' taxa to tax_out; else tax holds them. lin: nlin rows of r
// ranks, lstride ints apart.
extern "C" int mc_classify_lca(const void* tgt, const void* hits,
                               const void* tax, const void* merge_tax,
                               int64_t ntax, const void* lin, int64_t nlin,
                               int r, int64_t lstride, int64_t b, int k,
                               int hits_min, float frac, int highest,
                               int merge_rank, void* tax_out, void* cls,
                               void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (k < 1 || r < 1 || r > 32 || nlin < 1 || lstride < r ||
      (tax == nullptr && (merge_tax == nullptr || ntax < 1 ||
                          tax_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  return (int)launch_dependent(
      lca_blocks(b), kLcaThreads, stream,
      tax == nullptr ? lca_kernel<true> : lca_kernel<false>,
      (const int32_t*)tgt, (const int32_t*)hits, (const int32_t*)tax,
      (const int32_t*)merge_tax, ntax, (const int32_t*)lin, nlin, lstride,
      r, b, k, hits_min, frac, highest, merge_rank, (int32_t*)tax_out,
      (int32_t*)cls);
}

// the bytes of one launch's scratch
extern "C" int64_t mc_rank_hist_scratch_bytes() {
  return (int64_t)kScratchWords * 4;
}

// out: num_ranks + 2 int64 bins, every one written (m may be 0); over
// null: no overflow mask; scratch: mc_rank_hist_scratch_bytes, 8-byte
// aligned, zeroed once before its first launch, which no launch that
// can run at the same time may share.
extern "C" int mc_rank_hist(const void* cls, int64_t m, int64_t n,
                            const void* taxid, int64_t nt,
                            const void* rank_of, const void* over,
                            int num_ranks, void* out, void* scratch,
                            void* stream) {
  if (m < 0 || nt < 1 || nt > 0x7FFFFFFF || num_ranks < 0 ||
      num_ranks + 2 > kMaxBins || scratch == nullptr ||
      ((uintptr_t)scratch & 7))
    return (int)cudaErrorInvalidValue;
  HistArgs a = {};
  a.cls = (const int32_t*)cls;
  a.m = m;
  a.n = n;
  a.taxid = (const int32_t*)taxid;
  a.rank_of = (const int32_t*)rank_of;
  a.over = (const int32_t*)over;
  a.nt = (int)nt;
  a.shift = -1;
  a.np = a.nt;
  if (nt > kSmemTaxa) {
    a.shift = 0;
    while (((nt - 1) >> a.shift) + 1 > kPivots) ++a.shift;
    a.np = (int)(((nt - 1) >> a.shift) + 1);
  }
  a.top = 1;
  while (a.top <= a.np / 2) a.top *= 2;
  a.head = (int)(((uintptr_t)cls >> 2) & 3);
  a.num_ranks = num_ranks;
  return (int)launch_dependent(hist_blocks(m), kHistThreads, stream,
                               rank_hist_kernel, a, (unsigned*)scratch,
                               (unsigned long long*)out);
}

// the launch floor: an empty kernel, launched as the kernel of kind 0
// (classify_lca at n reads) or 1 (rank_hist at n reads) is
extern "C" int mc_launch_floor(int kind, int64_t n, void* stream) {
  if (kind < 0 || kind > 1) return (int)cudaErrorInvalidValue;
  return (int)launch_dependent(
      kind == 0 ? lca_blocks(n < 1 ? 1 : n) : hist_blocks(n),
      kind == 0 ? kLcaThreads : kHistThreads, stream, empty_kernel);
}
