// B4 and B5 on rows wider than one block's shared memory holds, for
// Hopper (sm_90a).
//
// Same contracts as candidates.cu::mc_candidates_packed (B4, packed i32
// slots, rows above 32,768 lanes) and
// candidates_unpacked.cu::mc_candidates_unpacked (B5, (tgt, win) pairs,
// rows above 16,384 lanes): (B, L2) slots, L2 a power of two, (B,) mwir
// -> (B, K, 4) i32 [tgt, hits, beg, end] per round, tgt -1 when empty.
// The TPU kernels (candidates_pallas.py:264, :429) take a row of any
// width in one grid step; here a row is cut into C = L2 / T tiles of
// T = 32,768 packed slots or 16,384 u64 pair keys (B5's key: the sign
// bits flipped, so that the unsigned order is the signed (tgt, win)
// order), one tile a block, each sorted by B3's block merge sort
// (row_sort.cuh) after a load that reverses the probe's odd runs. The
// shape alone picks one of two routes:
//
// The cluster route, C in {2, 4, 8} (rows up to 262,144 packed slots or
// 131,072 pairs: every fused long-read row), one launch: a thread block
// cluster of C blocks a row (cudaLaunchKernelExC), each holding its tile
// in shared memory, which the cluster's blocks read from each other
// (distributed shared memory, DSMEM). The row is read from device
// memory once, nothing else touches it, and no work space is needed:
// 1. load (16-byte loads; one by one from rows not 16-byte aligned)
//    and tile sort, skipped for rows that arrive sorted (presorted =
//    L2); each block counts its slots that match (padding sorts last),
//    which gives the row's nm;
// 2. log2(C) merge levels. A block's outputs of a level are split at
//    its half: for each half a warp finds on the merge path of the
//    level's two runs where the half's inputs start (a 32-way search
//    over the peers' tiles), the block copies them (a stretch of each
//    run) into its staging area with coalesced DSMEM loads, and every
//    thread merges its share from there into registers (DSMEM loads
//    issued one by one along a serial merge ran at a fraction of this);
//    between two cluster barriers the block writes its tile. The last
//    level deals the nm matching lanes out evenly, w = nm / C a block,
//    so that no block sweeps padding while another sweeps twice its
//    share;
// 3. dedup mode: each block lists its run starts as u16 lanes (S[c] of
//    the row is one load from the block that holds it), its first lane
//    compared with the previous block's last key, and rewrites its tile
//    in place as the keys of its run starts; the blocks' counts give
//    each its offset in the compacted row;
// 4. the sweep of each block's compacted lanes: lane c's first counted
//    lane f is the smallest j in [max(0, c - ne + 1), c) whose slot is in
//    range of lane c's (a binary search: along the sorted row the test is
//    false and then true), read from this block or an earlier one through
//    DSMEM (a run of equal slots, or the lanes that hits counts, may span
//    several tiles); hits = 1 + c - f (walk) or S[c + 1] - S[f] (dedup,
//    S[n] = nm), key hits * L2 + (L2 - 1 - c). Each thread keeps the best
//    key of the top K targets of its lanes; K rounds of a block max give
//    the block's K records;
// 5. the block of rank 0 picks the row's top K from the C x K records in
//    one warp, in the same K rounds; a last cluster barrier keeps every
//    tile alive until its peers are done reading.
// The row's k-th target is among its tiles' (and its threads') top K: a
// target whose best lane loses to K others there loses to them in the
// row, so the picks equal the one-block kernels' rounds. Time goes, in
// order, to the merge levels (the staging copy runs at the DSMEM rate),
// the block sort and the sweep; one block an SM (about 200 KB of shared
// memory), so the card holds 15 clusters of 8 blocks at once.
//
// The multi-pass route, C > 8 (up to L2 = 2^24), six kernels:
// tile sort into device memory, log2(C) merge passes in device memory
// (ping-pong between two buffers: a thread finds where its 8 outputs
// start on the merge path and merges them serially), in dedup mode the
// run starts counted per 4,096 lanes, the counts scanned into each
// tile's offset once a row, the run starts compacted (S[c] the lane of
// the c-th distinct slot, S[total] = L2), then the sweep per 4,096
// (compacted) lanes with each tile's K records, and one block a row
// picking from them; work space of two slot buffers, the run starts,
// the offsets and the records (mc_candidates_wide_work).
//
// The keys are int64: hits * L2 overflows int32 at L2 = 2^20 once a
// target holds 2,048 slots in range (a 19 kbp read's own genome), where
// the one-block kernels' int32 keys cannot overflow (hits <= L2 <=
// 32,768). Both routes have the row's bytes (read once) as their bound.
#include <cooperative_groups.h>

#include "row_sort.cuh"

using namespace mc;
namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kSign = 0x80000000u;
constexpr int kTile = 4096;       // lanes of a count, compaction, sweep
constexpr int kTileThreads = 256;
constexpr int kTileE = kTile / kTileThreads;
constexpr int kMergeE = 8;        // outputs of a merge-pass thread
constexpr int kMergeThreads = 256;
constexpr int kMaxWideL2 = 1 << 24;
constexpr int kMaxCluster = 8;    // blocks of a portable cluster
static_assert(kMaxWideL2 / kTile <= 4 * kMaxThreads,
              "tile_scan_kernel scans up to 4 tiles a thread");

__device__ __forceinline__ uint64_t key_of(int32_t t, int32_t w) {
  return ((uint64_t)((uint32_t)t ^ kSign) << 32) | ((uint32_t)w ^ kSign);
}

__device__ __forceinline__ int32_t tgt_of(uint64_t k) {
  return (int32_t)((uint32_t)(k >> 32) ^ kSign);
}

__device__ __forceinline__ int32_t win_of(uint64_t k) {
  return (int32_t)((uint32_t)k ^ kSign);
}

// packed slots pk = (tgt << wbits) | win, signed order, padding I32_MAX
struct Packed {
  using K = int32_t;
  static constexpr int kSortTile = 32768;   // 135 KB of shared memory
  static constexpr int kSortE = 32;
  const int32_t* pk;
  int wbits;
  __device__ K load(int64_t i) const { return pk[i]; }
  __device__ bool aligned() const { return (uintptr_t)pk % 16 == 0; }
  // the 4 keys from lane i on (i a multiple of 4, aligned())
  __device__ void load4(int64_t i, K (&v)[4]) const {
    const int4 x = *reinterpret_cast<const int4*>(pk + i);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  __device__ bool match(K p) const { return p != kI32Max; }
  __device__ int32_t tgt(K p) const { return shr_logical(p, wbits); }
  __device__ int32_t win(K p) const {
    return p & (int32_t)((1u << wbits) - 1u);
  }
  // slot q, at or before p in the sorted row, counts toward p's range
  __device__ bool in_range(K q, K p, int32_t mw1) const {
    return q >= wrap_sub(p, mw1);
  }
};

// (tgt, win) pairs as B5's u64 keys, padding (I32_MAX, I32_MAX)
struct Pairs {
  using K = uint64_t;
  static constexpr int kSortTile = 16384;   // 139 KB of shared memory
  static constexpr int kSortE = 16;
  const int32_t* t;
  const int32_t* w;
  __device__ K load(int64_t i) const { return key_of(t[i], w[i]); }
  __device__ bool aligned() const {
    return (uintptr_t)t % 16 == 0 && (uintptr_t)w % 16 == 0;
  }
  __device__ void load4(int64_t i, K (&v)[4]) const {
    const int4 x = *reinterpret_cast<const int4*>(t + i);
    const int4 y = *reinterpret_cast<const int4*>(w + i);
    v[0] = key_of(x.x, y.x), v[1] = key_of(x.y, y.y);
    v[2] = key_of(x.z, y.z), v[3] = key_of(x.w, y.w);
  }
  __device__ bool match(K p) const { return tgt_of(p) != kI32Max; }
  __device__ int32_t tgt(K p) const { return tgt_of(p); }
  __device__ int32_t win(K p) const { return win_of(p); }
  __device__ bool in_range(K q, K p, int32_t mw1) const {
    return tgt_of(q) == tgt_of(p) && win_of(q) >= wrap_sub(win_of(p), mw1);
  }
};

__device__ __forceinline__ long long warp_max64(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, d));
  return v;
}

// ------------------------------------------------------ cluster route

// shared-memory bytes of a cluster block: the tile (row_sort.cuh's
// padded layout), then a region that stages half a tile's merge inputs
// (T / 2 + 1 keys, in the same padded layout, so that the merge's
// loads of a warp fall in distinct banks) during the merge levels and
// holds the run starts as u16 local lanes after them
template <typename P>
__host__ __device__ __forceinline__ size_t cluster_row_bytes() {
  using K = typename P::K;
  return ((size_t)(slot<K>(P::kSortTile) + 1) * sizeof(K) + 15) & ~(size_t)15;
}

template <typename P>
inline size_t cluster_smem() {
  using K = typename P::K;
  const size_t stage = (slot<K>(P::kSortTile / 2) + 1) * sizeof(K);
  const size_t starts = (size_t)P::kSortTile * 2;
  return cluster_row_bytes<P>() +
         ((stage > starts ? stage : starts) + 15) / 16 * 16;
}

// key of lane j of the cluster's row: lane j % T of the tile of block
// j / T, a shared-memory load when that block is this one (rank), else
// a DSMEM load
template <typename K, int T>
__device__ __forceinline__ K lane_key(K* sm, int rank, int j) {
  const int q = j / T;
  if (q == rank) return sm[slot<K>(j & (T - 1))];
  return cg::this_cluster().map_shared_rank(sm, q)[slot<K>(j & (T - 1))];
}

// the keys of run a among the first diag outputs of the merge of the
// row's runs a (from lane a0) and b (from a0 + run); ties take run a.
// One warp: each round tests 32 points of the interval left, so a run
// of 2^17 lanes takes 4 rounds of DSMEM loads, not 18.
template <typename K, int T>
__device__ __forceinline__ int path_split(K* sm, int rank, int a0, int run,
                                          int diag) {
  const int lane = threadIdx.x & 31, b0 = a0 + run;
  // the first m in [lo, hi) whose b key before the diagonal is below
  // its a key, else hi
  int lo = max(0, diag - run), hi = min(diag, run);
  while (lo < hi) {
    const int span = hi - lo;
    const int m = lo + (int)(((long long)span * lane) >> 5);
    const bool p = lane_key<K, T>(sm, rank, b0 + diag - 1 - m) <
                   lane_key<K, T>(sm, rank, a0 + m);
    const unsigned t = __ballot_sync(0xFFFFFFFFu, p);
    const int f = t ? __ffs(t) - 1 : 32;
    const int nlo = f ? lo + (int)(((long long)span * (f - 1)) >> 5) + 1 : lo;
    hi = f == 32 ? hi : lo + (int)(((long long)span * f) >> 5);
    lo = nlo;
  }
  return lo;
}

// outputs d .. d + E - 1 of the merge of the staged runs st[0, la) and
// st[la, la + lb) (lane i at slot(i), one spare key past them), into v:
// row_sort.cuh's merge_runs on two runs of any lengths
template <typename K, int E>
__device__ __forceinline__ void merge_staged(const K* st, int la, int lb,
                                             int d, K (&v)[E]) {
  int lo = max(0, d - lb), hi = min(d, la);
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (st[slot<K>(la + d - 1 - m)] < st[slot<K>(m)])
      hi = m;
    else
      lo = m + 1;
  }
  int ia = lo, ib = d - lo;
  K ka = st[slot<K>(ia)], kb = st[slot<K>(la + ib)];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const bool tb = ib < lb && (ia >= la || kb < ka);
    v[k] = tb ? kb : ka;
    ib += tb;
    ia += !tb;
    const K x = st[slot<K>(tb ? la + ib : ia)];
    kb = tb ? x : kb;
    ka = tb ? ka : x;
  }
}

// a thread's best key of each of its top KK targets (distinct targets;
// key -1: empty), with the compacted lane f its hits start from and the
// lane's window; keys are unique. Every index is a constant of an unrolled
// loop, so the lists stay in registers. ``lo``, the lowest of the KK
// keys (-1 while one is empty), turns most lanes away at one compare: a
// key at or below it neither enters nor raises a held target's.
template <int KK>
struct TopK {
  long long key[KK], lo;
  int32_t tgt[KK], beg[KK], end[KK];

  __device__ void init() {
#pragma unroll
    for (int j = 0; j < KK; ++j) key[j] = -1, tgt[j] = beg[j] = end[j] = 0;
    lo = -1;
  }
  __device__ void add(long long k, int32_t t, int32_t f, int32_t e) {
    if (k <= lo) return;
    bool held = false;
#pragma unroll
    for (int j = 0; j < KK; ++j)
      if (key[j] >= 0 && tgt[j] == t) {
        held = true;
        if (k > key[j]) key[j] = k, beg[j] = f, end[j] = e;
      }
    if (!held) {  // replace the lowest key (an empty entry first)
      long long mn = key[0];
      int at = 0;
#pragma unroll
      for (int j = 1; j < KK; ++j)
        if (key[j] < mn) mn = key[j], at = j;
#pragma unroll
      for (int j = 0; j < KK; ++j)
        if (j == at) key[j] = k, tgt[j] = t, beg[j] = f, end[j] = e;
    }
    lo = key[0];
#pragma unroll
    for (int j = 1; j < KK; ++j) lo = min(lo, key[j]);
  }
};

// One cluster of C = L2 / T blocks a row, T / E = 1,024 threads a block,
// KK candidates. ne: the walk or dedup width; dedup: run starts
// compacted first.
template <typename P, int KK>
__global__ void __launch_bounds__(kMaxThreads, 1)
wide_cluster_kernel(P pol, const int32_t* __restrict__ mwir,
                    int32_t* __restrict__ out, int l2, int r, int ne,
                    int dedup, int lshift) {
  using K = typename P::K;
  constexpr int T = P::kSortTile, E = P::kSortE, NT = T / E;
  static_assert(NT == kMaxThreads, "one lane group a thread");
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), nc = (int)cl.num_blocks();
  const int64_t row = blockIdx.x / nc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char smraw[];
  K* sm = reinterpret_cast<K*>(smraw);
  uint16_t* S = reinterpret_cast<uint16_t*>(smraw + cluster_row_bytes<P>());
  __shared__ int red[33];
  __shared__ long long part[32];
  __shared__ long long rkey[KK];
  __shared__ int32_t rinfo[KK][3];
  __shared__ int offs[kMaxCluster + 1];
  __shared__ int starts_here, matches_here, nm_here;
  __shared__ int split[3];

  // 1. load, odd runs reversed, and tile sort
  const int64_t base = row * l2 + (int64_t)rank * T;
  const bool vec = pol.aligned();  // 16-byte loads, else one by one
  for (int i = 4 * tid; i < T; i += 4 * NT) {
    K v[4];
    if (vec) {
      pol.load4(base + i, v);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = pol.load(base + i + k);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) sm[slot<K>(run_lane(i + k, r))] = v[k];
  }
  if (tid == 0) sm[slot<K>(T)] = 0;
  __syncthreads();
  if (r < l2) block_sort_row<K, E>(sm, T, r > 0 ? r : 1);
  {  // the tile's slots that match (padding sorts last)
    int m = 0;
#pragma unroll
    for (int k = 0; k < E; ++k) m += pol.match(sm[slot<K>(tid * E + k)]);
    int total;
    block_excl_scan(m, red, &total);
    if (tid == 0) matches_here = total;
  }
  cl.sync();  // every tile sorted and counted (and every block running)
  // the row's matching lanes [0, nm) are dealt out w a block: block q
  // owns lanes [q * w, q * w + own) of the sorted row and holds them
  // from its tile's lane 0 on, padding in none (the rows that arrive
  // sorted keep their tiles: w = T)
  if (tid == 0) {
    int s = 0;
    for (int q = 0; q < nc; ++q) s += *cl.map_shared_rank(&matches_here, q);
    nm_here = s;
  }
  __syncthreads();
  const int nm = nm_here;
  const int w = r < l2 ? max(1, (nm + nc - 1) / nc) : T;
  const int own = max(0, min(w, nm - rank * w));

  // 2. merge levels across the tiles: this block's T outputs of the
  // merge of the level's two runs in two halves of H, each half's inputs
  // (a stretch of run a and one of run b, H keys together) copied into
  // stg with coalesced DSMEM reads, then merged from there by every
  // thread, E / 2 outputs each. Block q's outputs start at lane q * T of
  // the level's pair of runs, and at the last level (the whole row) at
  // lane q * w.
  if (r < l2) {
    constexpr int H = T / 2;
    K* stg = reinterpret_cast<K*>(smraw + cluster_row_bytes<P>());
    for (int run = T; run < l2; run <<= 1) {
      const int t0 = 2 * run == l2 ? rank * w : rank * T;
      const int a0 = t0 & ~(2 * run - 1), b0 = a0 + run;
      if (warp < 3) {
        const int x = path_split<K, T>(sm, rank, a0, run, t0 - a0 + warp * H);
        if (lane == 0) split[warp] = x;
      }
      __syncthreads();
      K v0[E / 2], v1[E / 2];  // outputs h * H + tid * E / 2 on of half h
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sa = split[h], la = split[h + 1] - sa;
        const int ia0 = a0 + sa, ib0 = b0 + (t0 - a0 + h * H) - sa - la;
        // all H / NT loads of a thread in flight, neighbouring threads on
        // neighbouring lanes
#pragma unroll
        for (int j0 = tid; j0 < H; j0 += 8 * NT) {
          K x[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int j = j0 + u * NT;
            x[u] = lane_key<K, T>(sm, rank, j < la ? ia0 + j : ib0 + j);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) stg[slot<K>(j0 + u * NT)] = x[u];
        }
        __syncthreads();
        if (h == 0)
          merge_staged<K, E / 2>(stg, la, H - la, tid * (E / 2), v0);
        else
          merge_staged<K, E / 2>(stg, la, H - la, tid * (E / 2), v1);
        __syncthreads();  // stg is free for the next half
      }
      cl.sync();  // every block has read the level's input
#pragma unroll
      for (int k = 0; k < E / 2; ++k) {
        sm[slot<K>(tid * (E / 2) + k)] = v0[k];
        sm[slot<K>(H + tid * (E / 2) + k)] = v1[k];
      }
      cl.sync();
    }
  }

  // 3. run starts (dedup): this block's compacted lanes [c0, c1) of n
  // (walk mode: its lanes); the tile rewritten in place as the keys of
  // its run starts
  int c0 = rank * w, c1 = c0 + own, n = nm;
  if (dedup) {
    const int i0 = tid * E;
    // the previous block's last lane: lane w - 1 of its tile
    K prev = i0     ? sm[slot<K>(i0 - 1)]
             : rank ? cl.map_shared_rank(sm, rank - 1)[slot<K>(w - 1)]
                    : K(0);
    K v[E];
    unsigned st = 0;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      v[k] = sm[slot<K>(i0 + k)];
      st |= (unsigned)(i0 + k < own &&
                       ((rank == 0 && i0 + k == 0) || v[k] != prev)) << k;
      prev = v[k];
    }
    int total;
    int c = block_excl_scan(__popc(st), red, &total);
    if (tid == 0) starts_here = total;
    // the scan's barriers: every thread has read its lanes; the cluster
    // barrier: the next block has read this tile's last key
    cl.sync();
#pragma unroll
    for (int k = 0; k < E; ++k)
      if ((st >> k) & 1) {
        S[c] = (uint16_t)(i0 + k);
        sm[slot<K>(c++)] = v[k];
      }
    if (tid == 0) {
      int s = 0;
      for (int q = 0; q < nc; ++q) {
        offs[q] = s;
        s += *cl.map_shared_rank(&starts_here, q);
      }
      offs[nc] = s;
    }
    cl.sync();  // every block's run starts, keys and count written
    c0 = offs[rank], c1 = offs[rank + 1], n = offs[nc];
  } else {
    if (tid <= nc) offs[tid] = min(tid * w, nm);
    __syncthreads();
  }
  // the block that holds compacted lane m < n, another than this one
  auto owner = [&](int m) -> int {
    int q = rank;
    while (m < offs[q]) --q;
    while (m >= offs[q + 1]) ++q;
    return q;
  };
  // the key of compacted lane m (its block's tile holds them in order)
  auto key_at = [&](int m) -> K {
    if (m >= c0 && m < c1) return sm[slot<K>(m - c0)];
    const int q = owner(m);
    return cl.map_shared_rank(sm, q)[slot<K>(m - offs[q])];
  };
  // the raw lane of compacted lane m (S[m] of the row; S[n] = nm, the
  // first padding lane)
  auto s_at = [&](int m) -> int {
    if (!dedup) return m;
    if (m >= c0 && m < c1) return rank * w + S[m - c0];
    if (m >= n) return nm;
    const int q = owner(m);
    return q * w + cl.map_shared_rank(S, q)[m - offs[q]];
  };

  // 4. the sweep of this block's compacted lanes, a thread's top K
  const int32_t mw1 = wrap_sub(mwir[row], 1);
  TopK<KK> top;
  top.init();
  for (int c = c0 + tid; c < c1; c += NT) {  // all match
    const K p = sm[slot<K>(c - c0)];
    int a = max(0, c - ne + 1), b = c;
    while (a < b) {
      const int m = (a + b) >> 1;
      if (pol.in_range(key_at(m), p, mw1))
        b = m;
      else
        a = m + 1;
    }
    const int hits = dedup ? s_at(c + 1) - s_at(a) : 1 + c - a;
    top.add((long long)hits * l2 + (l2 - 1 - c), pol.tgt(p), a, pol.win(p));
  }
  // the block's K rounds: records (key, tgt, beg, end), key -1 when the
  // round finds nothing
  for (int rd = 0; rd < KK; ++rd) {
    long long m = -1;
#pragma unroll
    for (int j = 0; j < KK; ++j) m = max(m, top.key[j]);
    m = warp_max64(m);
    if (lane == 0) part[warp] = m;
    __syncthreads();
    const long long best = warp_max64(part[lane]);
    if (best > 0) {
#pragma unroll
      for (int j = 0; j < KK; ++j)
        if (top.key[j] == best) {
          rkey[rd] = best;
          rinfo[rd][0] = top.tgt[j];
          rinfo[rd][1] = pol.win(key_at(top.beg[j]));
          rinfo[rd][2] = top.end[j];
        }
    } else if (tid == 0) {
      rkey[rd] = -1;
      rinfo[rd][0] = -1;
      rinfo[rd][1] = rinfo[rd][2] = 0;
    }
    // the next round writes part again only after this barrier, which
    // every thread passes after reading it
    __syncthreads();
    const int32_t t = rinfo[rd][0];
#pragma unroll
    for (int j = 0; j < KK; ++j)
      if (top.key[j] >= 0 && top.tgt[j] == t) top.key[j] = -1;
  }
  cl.sync();  // every block's records written

  // 5. rank 0 picks the row's top K from the C x K records, one a lane
  if (rank == 0 && warp == 0) {
    long long k = -1;
    int32_t t = -1, bg = 0, en = 0;
    if (lane < nc * KK) {
      const int q = lane / KK, rd = lane % KK;
      k = cl.map_shared_rank(rkey, q)[rd];
      const int32_t* info = cl.map_shared_rank(&rinfo[0][0], q) + 3 * rd;
      t = info[0], bg = info[1], en = info[2];
    }
    for (int rd = 0; rd < KK; ++rd) {
      const long long best = warp_max64(k);
      const bool ok = best > 0;
      const unsigned who = __ballot_sync(0xFFFFFFFFu, ok && k == best);
      const int src = who ? __ffs(who) - 1 : 0;
      const int32_t tw = __shfl_sync(0xFFFFFFFFu, t, src);
      const int32_t bw = __shfl_sync(0xFFFFFFFFu, bg, src);
      const int32_t ew = __shfl_sync(0xFFFFFFFFu, en, src);
      if (lane == 0) {
        int32_t* o = out + (row * KK + rd) * 4;
        o[0] = ok ? tw : -1;
        o[1] = ok ? (int32_t)(best >> lshift) : 0;
        o[2] = ok ? bw : 0;
        o[3] = ok ? ew : 0;
      }
      if (ok && t == tw) k = -1;
    }
  }
  cl.sync();  // no block leaves while a peer may read its tile
}

template <typename P>
cudaLaunchConfig_t cluster_config(int64_t b, int nc, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b * nc));
  cfg.blockDim = dim3(P::kSortTile / P::kSortE);
  cfg.dynamicSmemBytes = cluster_smem<P>();
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)nc;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the cluster kernel of kk candidates
template <typename P>
const void* cluster_fn(int kk) {
  switch (kk) {
    case 1: return (const void*)wide_cluster_kernel<P, 1>;
    case 2: return (const void*)wide_cluster_kernel<P, 2>;
    case 3: return (const void*)wide_cluster_kernel<P, 3>;
    default: return (const void*)wide_cluster_kernel<P, 4>;
  }
}

template <typename P>
cudaError_t run_cluster(P pol, const int32_t* mwir, int32_t* out, int64_t b,
                        int l2, int r, int walk, int dwalk, int kk,
                        cudaStream_t st) {
  const void* fn = cluster_fn<P>(kk);
  cudaError_t err = set_smem(fn, cluster_smem<P>());
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config<P>(b, l2 / P::kSortTile, st, &attr);
  int lshift = 0;
  while ((1 << lshift) < l2) ++lshift;
  int ne = dwalk ? dwalk : walk, dedup = dwalk > 0;
  void* args[] = {&pol, &mwir, &out, &l2, &r, &ne, &dedup, &lshift};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// --------------------------------------------------- multi-pass route

// step 1: one block sorts one tile of P::kSortTile lanes
template <typename P>
__global__ void __launch_bounds__(kMaxThreads)
tile_sort_kernel(P pol, typename P::K* __restrict__ out, int r) {
  using K = typename P::K;
  constexpr int T = P::kSortTile;
  extern __shared__ __align__(16) unsigned char smraw[];
  K* sm = reinterpret_cast<K*>(smraw);
  const int64_t base = (int64_t)blockIdx.x * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x)
    sm[slot<K>(run_lane(i, r))] = pol.load(base + i);
  if (threadIdx.x == 0) sm[slot<K>(T)] = 0;
  __syncthreads();
  block_sort_row<K, P::kSortE>(sm, T, r > 0 ? r : 1);
  for (int i = threadIdx.x; i < T; i += blockDim.x)
    out[base + i] = sm[slot<K>(i)];
}

// rows that arrive sorted: their keys as they are
template <typename P>
__global__ void copy_keys_kernel(P pol, typename P::K* __restrict__ out,
                                 int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = pol.load(i);
}

// step 2: ascending runs of `run` keys -> runs of 2 * run; a pair of
// runs never crosses a row (L2 is a multiple of 2 * run)
template <typename K>
__global__ void __launch_bounds__(kMergeThreads)
merge_pass_kernel(const K* __restrict__ in, K* __restrict__ out, int run) {
  const int64_t t0 =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kMergeE;
  const int64_t a0 = t0 & ~(int64_t)(2 * run - 1), b0 = a0 + run;
  const int64_t be = b0 + run;
  const int diag = (int)(t0 - a0);
  // keys of run a among the pair's first diag outputs; ties take run a
  int lo = max(0, diag - run), hi = min(diag, run);
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (in[b0 + diag - 1 - m] < in[a0 + m])
      hi = m;
    else
      lo = m + 1;
  }
  int64_t ia = a0 + lo, ib = b0 + diag - lo;
  K ka = ia < b0 ? in[ia] : K(0), kb = ib < be ? in[ib] : K(0);
#pragma unroll
  for (int k = 0; k < kMergeE; ++k) {
    const bool tb = ib < be && (ia >= b0 || kb < ka);
    out[t0 + k] = tb ? kb : ka;
    if (tb) {
      if (++ib < be) kb = in[ib];
    } else {
      if (++ia < b0) ka = in[ia];
    }
  }
}

// step 3: distinct-slot runs starting in each tile of kTile lanes, into
// off[row * (ntiles + 1) + tile]
template <typename K>
__global__ void __launch_bounds__(kTileThreads)
run_count_kernel(const K* __restrict__ s, int l2, int* __restrict__ off) {
  __shared__ int red[33];
  const int ntiles = l2 / kTile;
  const int64_t row = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int i0 = tile * kTile + threadIdx.x * kTileE;
  const K* r = s + row * l2;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kTileE; ++k) {
    const int i = i0 + k;
    c += i == 0 || r[i] != r[i - 1];
  }
  int total;
  block_excl_scan(c, red, &total);
  if (threadIdx.x == 0) off[row * (ntiles + 1) + tile] = total;
}

// step 3b: one block a row turns its tiles' counts into their offsets
// in the compacted row, in place, and off[ntiles] into the row's total
__global__ void __launch_bounds__(kMaxThreads)
tile_scan_kernel(int* __restrict__ off, int ntiles) {
  __shared__ int red[33];
  int* o = off + blockIdx.x * (int64_t)(ntiles + 1);
  const int per = (ntiles + blockDim.x - 1) / blockDim.x;  // <= 4
  const int j0 = threadIdx.x * per;
  int v[4], s = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = k < per && j0 + k < ntiles ? o[j0 + k] : 0;
    s += v[k];
  }
  int total;
  int c = block_excl_scan(s, red, &total);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < per && j0 + k < ntiles) {
      o[j0 + k] = c;
      c += v[k];
    }
  if (threadIdx.x == 0) o[ntiles] = total;
}

// step 4: S[c] = the lane of the c-th run start of the row, in lane
// order; S[total] = l2
template <typename K>
__global__ void __launch_bounds__(kTileThreads)
compact_kernel(const K* __restrict__ s, int l2, const int* __restrict__ off,
               int* __restrict__ S) {
  __shared__ int red[33];
  const int ntiles = l2 / kTile;
  const int64_t row = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int base = off[row * (ntiles + 1) + tile];
  const K* r = s + row * l2;
  int* Sr = S + row * (int64_t)(l2 + 1);
  const int i0 = tile * kTile + threadIdx.x * kTileE;
  K prev = i0 ? r[i0 - 1] : K(0);
  unsigned starts = 0;
#pragma unroll
  for (int k = 0; k < kTileE; ++k) {
    const K v = r[i0 + k];
    starts |= (unsigned)(i0 + k == 0 || v != prev) << k;
    prev = v;
  }
  int total;
  int c = base + block_excl_scan(__popc(starts), red, &total);
#pragma unroll
  for (int k = 0; k < kTileE; ++k)
    if ((starts >> k) & 1) Sr[c++] = i0 + k;
  if (tile == ntiles - 1 && threadIdx.x == 0) Sr[base + total] = l2;
}

// step 5: the sweep over one tile of kTile (compacted) lanes, lanes
// tid + q * kTileThreads of it, and the tile's top K: records
// (key, tgt, beg, end) at rkey / rinfo[blockIdx.x * kk + round], key -1
// when the round finds nothing
template <typename P>
__global__ void __launch_bounds__(kTileThreads)
sweep_kernel(P pol, const typename P::K* __restrict__ s,
             const int* __restrict__ S, const int* __restrict__ off,
             const int32_t* __restrict__ mwir, int l2, int lshift, int ne,
             int kk, long long* __restrict__ rkey,
             int32_t* __restrict__ rinfo) {
  using K = typename P::K;
  __shared__ long long part[2][kTileThreads / 32];
  const int ntiles = l2 / kTile;
  const int64_t row = blockIdx.x / ntiles;
  const int base = (blockIdx.x % ntiles) * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const K* r = s + row * l2;
  const int* Sr = S ? S + row * (int64_t)(l2 + 1) : nullptr;
  const int n = S ? off[row * (ntiles + 1) + ntiles] : l2;
  const int32_t mw1 = wrap_sub(mwir[row], 1);
  auto val = [&](int c) -> K { return Sr ? r[Sr[c]] : r[c]; };
  long long lk[kTileE];
  int32_t lt[kTileE];
#pragma unroll
  for (int q = 0; q < kTileE; ++q) {
    const int i = base + tid + q * kTileThreads;
    lk[q] = -1;
    lt[q] = -1;
    if (i < n) {
      const K p = val(i);
      if (pol.match(p)) {
        int a = max(0, i - ne + 1), b = i;
        while (a < b) {
          const int m = (a + b) >> 1;
          if (pol.in_range(val(m), p, mw1))
            b = m;
          else
            a = m + 1;
        }
        const int hits = Sr ? Sr[i + 1] - Sr[a] : 1 + i - a;
        lk[q] = (long long)hits * l2 + (l2 - 1 - i);
        lt[q] = pol.tgt(p);
      }
    }
  }
  for (int rd = 0; rd < kk; ++rd) {
    long long m = -1;
#pragma unroll
    for (int q = 0; q < kTileE; ++q) m = max(m, lk[q]);
    m = warp_max64(m);
    // one barrier a round: round rd + 2 writes this buffer again only
    // after every thread has passed round rd + 1's barrier
    if (lane == 0) part[rd & 1][warp] = m;
    __syncthreads();
    long long best = part[rd & 1][0];
#pragma unroll
    for (int w = 1; w < kTileThreads / 32; ++w)
      best = max(best, part[rd & 1][w]);
    const bool ok = best > 0;
    const int bc = ok ? (l2 - 1) - (int)(best & (l2 - 1)) : 0;
    const K pb = val(bc);
    const int32_t tbest = ok ? pol.tgt(pb) : -1;
    if (tid == 0) {
      const int64_t o = (int64_t)blockIdx.x * kk + rd;
      const int h = (int)(best >> lshift);
      rkey[o] = ok ? best : -1;
      rinfo[3 * o] = tbest;
      rinfo[3 * o + 1] =
          ok ? pol.win(r[Sr ? Sr[bc + 1] - h : bc + 1 - h]) : 0;
      rinfo[3 * o + 2] = ok ? pol.win(pb) : 0;
    }
#pragma unroll
    for (int q = 0; q < kTileE; ++q)
      if (lt[q] == tbest) lk[q] = -1;
  }
}

// step 6: one block a row, the K rounds over its tiles' records
__global__ void __launch_bounds__(kTileThreads)
pick_kernel(long long* __restrict__ rkey, const int32_t* __restrict__ rinfo,
            int nrec, int kk, int lshift, int32_t* __restrict__ out) {
  __shared__ long long part[kTileThreads / 32];
  __shared__ int32_t win_t;
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long* k = rkey + row * nrec;
  const int32_t* info = rinfo + row * nrec * 3;
  for (int rd = 0; rd < kk; ++rd) {
    long long m = -1;
    for (int j = tid; j < nrec; j += kTileThreads) m = max(m, k[j]);
    m = warp_max64(m);
    if (lane == 0) part[warp] = m;
    __syncthreads();
    long long best = part[0];
    for (int w = 1; w < kTileThreads / 32; ++w) best = max(best, part[w]);
    const bool ok = best > 0;
    int32_t* o = out + (row * kk + rd) * 4;
    if (!ok && tid == 0) {
      o[0] = -1;
      o[1] = o[2] = o[3] = 0;
      win_t = -1;
    }
    for (int j = tid; ok && j < nrec; j += kTileThreads) {
      if (k[j] == best) {  // keys are unique: one record wins
        o[0] = info[3 * j];
        o[1] = (int32_t)(best >> lshift);
        o[2] = info[3 * j + 1];
        o[3] = info[3 * j + 2];
        win_t = info[3 * j];
      }
    }
    __syncthreads();
    const int32_t t = win_t;
    for (int j = tid; ok && j < nrec; j += kTileThreads)
      if (info[3 * j] == t) k[j] = -1;
    __syncthreads();  // masks done, part and win_t free for the next round
  }
}

size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

// work space: two slot buffers, the run starts, the tile offsets, the
// tiles' record keys and infos
size_t work_bytes(int64_t b, int l2, size_t key_bytes, int kk) {
  const int64_t ntiles = l2 / kTile;
  return 2 * align256(b * l2 * key_bytes) +
         align256(b * (int64_t)(l2 + 1) * 4) +
         align256(b * (ntiles + 1) * 4) + align256(b * ntiles * kk * 8) +
         align256(b * ntiles * kk * 12);
}

template <typename P>
cudaError_t run_passes(P pol, const int32_t* mwir, int32_t* out, void* work,
                       int64_t b, int l2, int r, int walk, int dwalk, int kk,
                       cudaStream_t st) {
  using K = typename P::K;
  constexpr int T = P::kSortTile;
  const int64_t n = b * l2, ntiles = l2 / kTile;
  char* w = (char*)work;
  K* buf[2] = {(K*)w, (K*)(w + align256(n * sizeof(K)))};
  w += 2 * align256(n * sizeof(K));
  int* S = (int*)w;
  w += align256(b * (int64_t)(l2 + 1) * 4);
  int* off = (int*)w;
  w += align256(b * (ntiles + 1) * 4);
  long long* rkey = (long long*)w;
  w += align256(b * ntiles * kk * 8);
  int32_t* rinfo = (int32_t*)w;
  cudaError_t err;
  const K* sorted = buf[0];
  if (r < l2) {
    const size_t smem = row_bytes<K>(T);
    err = set_smem((const void*)tile_sort_kernel<P>, smem);
    if (err != cudaSuccess) return err;
    tile_sort_kernel<P><<<(unsigned)(n / T), T / P::kSortE, smem, st>>>(
        pol, buf[0], r);
    int cur = 0;
    for (int run = T; run < l2; run <<= 1, cur ^= 1)
      merge_pass_kernel<K><<<(unsigned)(n / (kMergeE * kMergeThreads)),
                             kMergeThreads, 0, st>>>(buf[cur], buf[cur ^ 1],
                                                     run);
    sorted = buf[cur];
  } else {  // rows that arrive sorted: the keys as they are
    const unsigned nb = (unsigned)((n + 255) / 256);
    copy_keys_kernel<P><<<nb, 256, 0, st>>>(pol, buf[0], n);
  }
  if (dwalk) {
    run_count_kernel<K><<<(unsigned)(b * ntiles), kTileThreads, 0, st>>>(
        sorted, l2, off);
    tile_scan_kernel<<<(unsigned)b, kMaxThreads, 0, st>>>(off, (int)ntiles);
    compact_kernel<K><<<(unsigned)(b * ntiles), kTileThreads, 0, st>>>(
        sorted, l2, off, S);
  }
  int lshift = 0;
  while ((1 << lshift) < l2) ++lshift;
  sweep_kernel<P><<<(unsigned)(b * ntiles), kTileThreads, 0, st>>>(
      pol, sorted, dwalk ? S : nullptr, off, mwir, l2, lshift,
      dwalk ? dwalk : walk, kk, rkey, rinfo);
  pick_kernel<<<(unsigned)b, kTileThreads, 0, st>>>(
      rkey, rinfo, (int)(ntiles * kk), kk, lshift, out);
  return cudaGetLastError();
}

// The route of a row of l2 lanes: the cluster route for C = l2 / T
// tiles up to a portable cluster, the multi-pass route above
bool cluster_route(int l2, int tile) { return l2 / tile <= kMaxCluster; }

template <typename P>
cudaError_t run_wide(P pol, const int32_t* mwir, int32_t* out, void* work,
                     int64_t b, int l2, int r, int walk, int dwalk, int kk,
                     cudaStream_t st) {
  if (cluster_route(l2, P::kSortTile))
    return run_cluster(pol, mwir, out, b, l2, r, walk, dwalk, kk, st);
  if (work == nullptr) return cudaErrorInvalidValue;
  return run_passes(pol, mwir, out, work, b, l2, r, walk, dwalk, kk, st);
}

bool args_ok(int l2, int min_l2, int presorted, int tile, int walk, int dwalk,
             int kk) {
  return pow2_in(l2, min_l2, kMaxWideL2) &&
         (presorted == 0 || presorted == l2 ||
          pow2_in(presorted, 1, tile / 2)) &&
         kk >= 1 && kk <= 4 && walk >= 0 && dwalk >= 0 &&
         (walk > 0 || dwalk > 0);
}

template <typename P>
int cluster_info(int nc, int kk, int* info) {
  const void* fn = cluster_fn<P>(kk);
  cudaError_t err = set_smem(fn, cluster_smem<P>());
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<P>(1, nc, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return (int)err;
  info[0] = clusters;
  info[1] = fa.numRegs;
  info[2] = (int)fa.localSizeBytes;
  info[3] = (int)(cluster_smem<P>() + fa.sharedSizeBytes);
  return (int)cudaSuccess;
}

}  // namespace

// device bytes of the work space of a call: 0 on the cluster route
extern "C" size_t mc_candidates_wide_work(int64_t b, int l2, int pairs,
                                          int kk) {
  if (cluster_route(l2, pairs ? Pairs::kSortTile : Packed::kSortTile))
    return 0;
  return work_bytes(b, l2, pairs ? 8 : 4, kk);
}

// The cluster kernel for packed slots (pairs = 0) or pairs and kk
// candidates at nc blocks a cluster: info[0] the clusters that can be
// resident at once (cudaOccupancyMaxActiveClusters), info[1] registers
// a thread, info[2] local memory bytes a thread (spills), info[3] shared
// bytes a block.
extern "C" int mc_candidates_wide_cluster_info(int pairs, int nc, int kk,
                                               int* info) {
  if (nc < 2 || nc > kMaxCluster || (nc & (nc - 1)) || kk < 1 || kk > 4)
    return (int)cudaErrorInvalidValue;
  return pairs ? cluster_info<Pairs>(nc, kk, info)
               : cluster_info<Packed>(nc, kk, info);
}

extern "C" int mc_candidates_packed_wide(const void* pk, const void* mwir,
                                         void* out, void* work, int64_t b,
                                         int l2, int presorted, int wbits,
                                         int walk, int dwalk, int kk,
                                         void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (!args_ok(l2, 2 * Packed::kSortTile, presorted, Packed::kSortTile, walk,
               dwalk, kk) ||
      wbits < 1 || wbits > 30)
    return (int)cudaErrorInvalidValue;
  return (int)run_wide(Packed{(const int32_t*)pk, wbits},
                       (const int32_t*)mwir, (int32_t*)out, work, b, l2,
                       presorted, walk, dwalk, kk, (cudaStream_t)stream);
}

extern "C" int mc_candidates_unpacked_wide(const void* tgt, const void* win,
                                           const void* mwir, void* out,
                                           void* work, int64_t b, int l2,
                                           int presorted, int walk, int dwalk,
                                           int kk, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (!args_ok(l2, 2 * Pairs::kSortTile, presorted, Pairs::kSortTile, walk,
               dwalk, kk))
    return (int)cudaErrorInvalidValue;
  return (int)run_wide(Pairs{(const int32_t*)tgt, (const int32_t*)win},
                       (const int32_t*)mwir, (int32_t*)out, work, b, l2,
                       presorted, walk, dwalk, kk, (cudaStream_t)stream);
}
