// B4 and B5 on rows wider than one block's shared memory holds, for
// Hopper (sm_90a).
//
// Same contracts as candidates.cu::mc_candidates_packed (B4, packed i32
// slots, rows above 32,768 lanes) and
// candidates_unpacked.cu::mc_candidates_unpacked (B5, (tgt, win) pairs,
// rows above 16,384 lanes): (B, L2) slots, L2 a power of two, (B,) mwir
// -> (B, K, 4) i32 [tgt, hits, beg, end] per round, tgt -1 when empty.
// The TPU kernels (candidates_pallas.py:264, :429) take a row of any
// width in one grid step; here a row that does not fit one block's
// shared memory is split over blocks, in six steps on the card:
// 1. tile sort: B3's block merge sort (row_sort.cuh) on tiles of 32,768
//    packed slots or 16,384 u64 pair keys (B5's key: the sign bits
//    flipped, so that the unsigned order is the signed (tgt, win)
//    order), the probe's odd runs reversed on the load; skipped for rows
//    that arrive sorted (presorted = L2);
// 2. log2(L2 / tile) merge passes in device memory, ping-pong between
//    two buffers: a thread finds where its 8 outputs start on the merge
//    path of the two runs it merges (a binary search along its output
//    diagonal) and merges them serially;
// 3. dedup mode: run starts counted per tile of 4,096 lanes;
// 4. dedup mode: the run starts compacted in lane order, S[c] the lane
//    of the c-th distinct slot (the tile's offset is the sum of the
//    counts of the tiles before it in the row), S[total] = L2;
// 5. the sweep, per tile of 4,096 (compacted) lanes: lane i's first
//    counted lane f is the smallest j in [max(0, i - ne + 1), i) whose
//    slot is in range of lane i's (a binary search: along the sorted
//    row the test is false and then true, as in B4 and B5), hits =
//    1 + i - f (walk) or S[i + 1] - S[f] (dedup); then the tile's own
//    top K targets: K rounds of a block max over the lanes' keys
//    hits * L2 + (L2 - 1 - i), each masking the winner's target;
// 6. one block a row picks the top K targets from the tiles' records in
//    the same K rounds. The row's k-th target is among its tiles' top K
//    (a target whose best lane loses to K others in that lane's tile
//    loses to them in the row), so the picks equal the one-block
//    kernels' rounds.
// The keys are int64: hits * L2 overflows int32 at L2 = 2^20 once a
// target holds 2,048 slots in range (a 19 kbp read's own genome), where
// the one-block kernels' int32 keys cannot overflow (hits <= L2 <=
// 32,768). Device memory: the slots read once by the tile sort and read
// and written once per merge pass, the sorted row read again by the
// count, the compaction and the sweep; work space of two slot buffers,
// the run starts and the tiles' records (mc_candidates_wide_work).
#include "row_sort.cuh"

using namespace mc;

namespace {

constexpr uint32_t kSign = 0x80000000u;
constexpr int kTile = 4096;       // lanes of a count, compaction or sweep block
constexpr int kTileThreads = 256;
constexpr int kTileE = kTile / kTileThreads;
constexpr int kMergeE = 8;        // outputs of a merge-pass thread
constexpr int kMergeThreads = 256;
constexpr int kMaxWideL2 = 1 << 24;

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
  __device__ bool match(K p) const { return tgt_of(p) != kI32Max; }
  __device__ int32_t tgt(K p) const { return tgt_of(p); }
  __device__ int32_t win(K p) const { return win_of(p); }
  __device__ bool in_range(K q, K p, int32_t mw1) const {
    return tgt_of(q) == tgt_of(p) && win_of(q) >= wrap_sub(win_of(p), mw1);
  }
};

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

// step 3: distinct-slot runs starting in each tile of kTile lanes
template <typename K>
__global__ void __launch_bounds__(kTileThreads)
run_count_kernel(const K* __restrict__ s, int l2, int* __restrict__ cnt) {
  __shared__ int red[33];
  const int ntiles = l2 / kTile;
  const int64_t row = blockIdx.x / ntiles;
  const int i0 = (blockIdx.x % ntiles) * kTile + threadIdx.x * kTileE;
  const K* r = s + row * l2;
  int c = 0;
#pragma unroll
  for (int k = 0; k < kTileE; ++k) {
    const int i = i0 + k;
    c += i == 0 || r[i] != r[i - 1];
  }
  int total;
  block_excl_scan(c, red, &total);
  if (threadIdx.x == 0) cnt[blockIdx.x] = total;
}

// step 4: S[c] = the lane of the c-th run start of the row, in lane
// order; S[total] = l2
template <typename K>
__global__ void __launch_bounds__(kTileThreads)
compact_kernel(const K* __restrict__ s, int l2, const int* __restrict__ cnt,
               int* __restrict__ S) {
  __shared__ int red[33];
  const int ntiles = l2 / kTile;
  const int64_t row = blockIdx.x / ntiles;
  const int tile = blockIdx.x % ntiles;
  const int* rc = cnt + row * ntiles;
  int off = 0;
  for (int j = 0; j < tile; ++j) off += rc[j];
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
  int c = off + block_excl_scan(__popc(starts), red, &total);
#pragma unroll
  for (int k = 0; k < kTileE; ++k)
    if ((starts >> k) & 1) Sr[c++] = i0 + k;
  if (tile == ntiles - 1 && threadIdx.x == 0) Sr[off + total] = l2;
}

__device__ __forceinline__ long long warp_max64(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, d));
  return v;
}

// step 5: the sweep over one tile of kTile (compacted) lanes, lanes
// tid + q * kTileThreads of it, and the tile's top K: records
// (key, tgt, beg, end) at rkey / rinfo[blockIdx.x * kk + round], key -1
// when the round finds nothing
template <typename P>
__global__ void __launch_bounds__(kTileThreads)
sweep_kernel(P pol, const typename P::K* __restrict__ s,
             const int* __restrict__ S, const int* __restrict__ cnt,
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
  int n = l2;
  if (S) {
    n = 0;
    for (int j = 0; j < ntiles; ++j) n += cnt[row * ntiles + j];
  }
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

// work space: two slot buffers, the run starts, the tile counts, the
// tiles' record keys and infos
size_t work_bytes(int64_t b, int l2, size_t key_bytes, int kk) {
  const int64_t ntiles = l2 / kTile;
  return 2 * align256(b * l2 * key_bytes) +
         align256(b * (int64_t)(l2 + 1) * 4) + align256(b * ntiles * 4) +
         align256(b * ntiles * kk * 8) + align256(b * ntiles * kk * 12);
}

template <typename P>
cudaError_t run_wide(P pol, const int32_t* mwir, int32_t* out, void* work,
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
  int* cnt = (int*)w;
  w += align256(b * ntiles * 4);
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
        sorted, l2, cnt);
    compact_kernel<K><<<(unsigned)(b * ntiles), kTileThreads, 0, st>>>(
        sorted, l2, cnt, S);
  }
  int lshift = 0;
  while ((1 << lshift) < l2) ++lshift;
  sweep_kernel<P><<<(unsigned)(b * ntiles), kTileThreads, 0, st>>>(
      pol, sorted, dwalk ? S : nullptr, cnt, mwir, l2, lshift,
      dwalk ? dwalk : walk, kk, rkey, rinfo);
  pick_kernel<<<(unsigned)b, kTileThreads, 0, st>>>(
      rkey, rinfo, (int)(ntiles * kk), kk, lshift, out);
  return cudaGetLastError();
}

bool args_ok(int l2, int min_l2, int presorted, int tile, int walk, int dwalk,
             int kk) {
  return pow2_in(l2, min_l2, kMaxWideL2) &&
         (presorted == 0 || presorted == l2 ||
          pow2_in(presorted, 1, tile / 2)) &&
         kk >= 1 && kk <= 4 && walk >= 0 && dwalk >= 0 &&
         (walk > 0 || dwalk > 0);
}

}  // namespace

extern "C" size_t mc_candidates_wide_work(int64_t b, int l2, int pairs,
                                          int kk) {
  return work_bytes(b, l2, pairs ? 8 : 4, kk);
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
