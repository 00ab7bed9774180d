// B3 and B4: per-row candidate generation over packed match slots,
// pk = (tgt << wbits) | win, padding I32_MAX, for Hopper (sm_90a).
//
// B3 replaces metacache_tpu/ops/candidates_pallas.py::sort_pallas_packed
// (_sort_kernel / _sort1_lanes): ascending per-row sort of (B, L2) i32
// slots. The probe emits each feature's slots as sorted runs of r lanes
// in alternating directions (presorted = r); the TPU kernel starts its
// bitonic network at phase 2r. Here one block of L2 / E threads sorts a
// row by the block merge sort of row_sort.cuh between a coalesced load
// (load_row, 16 bytes a thread at a time, shared with B4), which
// reverses the odd runs into shared memory, and a coalesced store:
// log2(L2 / r) merge levels (a register network first when r < E).
// Bound: device memory sees one read and one write of the slot matrix
// (~80 us at 8192 x 4096 on 3.35 TB/s). What the card spends beyond it:
// the merge levels' shared-memory reads (a binary search a thread and
// level, then one read a key) and one barrier pair a level (8 barriers
// at L2 = 4096, r = 256, where the bitonic network took 42).
//
// B4 replaces candidates_pallas_packed (_packed_kernel: the lane sort
// when split=False, _compact_runs_packed, the walk or dedup sweep and
// the top-k rounds). One block of L2 / E threads per row, E lanes a
// thread (consecutive ones for the sort and the compaction, every
// (L2 / E)-th for the sweep and the top-k, so that a warp's probes fall
// on neighbouring slots), over one row array in shared memory
// (row_sort.cuh's padded slots) that each thread loads 16 bytes at a
// time:
// - sort, fused in when presorted < L2 (JAX's unsplit route,
//   MC_SPLIT_CAND=0): the load reverses the odd runs and
//   block_sort_row sorts the row in place, B3's own code, so the sorted
//   row never reaches device memory; presorted = L2 takes rows that B3
//   sorted (the split route) and skips it;
// - walk mode: lane i counts the earlier lanes j > i - walk_elems with
//   pk[j] >= wrap_sub(pk[i], mwir - 1) (the packing makes that one
//   compare test target and window range together). Along a sorted row
//   the test is false and then true, wrap-around included, so those
//   lanes form one run ending at i - 1, whose first lane f binary
//   lifting finds (5 probes at walk 32, 6 at walk 48, where a scan read
//   walk - 1 lanes): hits = 1 + i - f;
// - dedup mode: lane i starts a run when its slot differs from lane
//   i - 1; a block prefix sum compacts the run starts S[c] (u16 lane
//   numbers) in lane order, the row itself stays, and compacted lane c
//   is slot pk[S[c]]. The same search over at most dedup_walk compacted
//   lanes gives f, and hits = S[c + 1] - S[f];
// - top-k: each lane's key hits * L2 + (L2 - 1 - lane) and its target
//   stay in registers; K rounds of a thread max, a warp shuffle max and
//   one block step (one barrier: the partial maxima alternate between
//   two buffers), gated best > 0. The winner's key holds its own f
//   (walk: bc + 1 - hits; dedup: the lane S[bc + 1] - hits), so its
//   begin window is one shared read; lanes of its target are masked in
//   registers.
// Bound: device memory sees one read of the slots (sorted or not) and a
// (B, K, 4) result, 40 us at 8192 x 4096 on 3.35 TB/s. Beyond it the
// card spends its time on the sort's merge levels (fused form) and the
// sweep's shared-memory probes; rows of 128 and 256 lanes keep a whole
// warp (E = 4 and 8). Shared memory: 4.1 B a lane, plus 2 B in dedup
// mode, 196 KB at the widest row.
#include "row_sort.cuh"

using namespace mc;

namespace {

constexpr int kMaxSortL2 = 32768;       // 132 KB of shared memory
constexpr int kMaxCandL2 = 32768;       // the row and u16 run starts: 196 KB

// The row of l2 slots from device memory into shared memory, odd runs
// of r lanes reversed: E / 4 16-byte loads a thread, all issued before
// their stores (with one pad slot per 32 lanes, the four stores of a
// warp's loads each hit 32 distinct banks).
template <int E>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ src,
                                         int32_t* A, int r) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int4 x[E / 4];
#pragma unroll
  for (int q = 0; q < E / 4; ++q)
    x[q] = reinterpret_cast<const int4*>(src)[tid + q * nt];
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const int i = 4 * (tid + q * nt);
    A[slot<int32_t>(run_lane(i, r))] = x[q].x;
    A[slot<int32_t>(run_lane(i + 1, r))] = x[q].y;
    A[slot<int32_t>(run_lane(i + 2, r))] = x[q].z;
    A[slot<int32_t>(run_lane(i + 3, r))] = x[q].w;
  }
}

template <int E>
__global__ void __launch_bounds__(kMaxThreads)
sort_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
            int l2, int r) {
  extern __shared__ int32_t sm[];
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  load_row<E>(in + row * l2, sm, r);
  if (tid == 0) sm[slot<int32_t>(l2)] = 0;
  __syncthreads();
  block_sort_row<int32_t, E>(sm, l2, r > 0 ? r : 1);
  for (int i = tid; i < l2; i += nt) out[row * l2 + i] = sm[slot<int32_t>(i)];
}

template <int E>
cudaError_t launch_sort(const int32_t* in, int32_t* out, int64_t b, int l2,
                        int r, cudaStream_t stream) {
  const size_t smem = row_bytes<int32_t>(l2);
  cudaError_t err = set_smem((const void*)sort_kernel<E>, smem);
  if (err != cudaSuccess) return err;
  sort_kernel<E><<<(unsigned)b, l2 / E, smem, stream>>>(in, out, l2, r);
  return cudaGetLastError();
}

// The sweep over lanes tid + q * nt (q < E) of n sorted lanes, val(j)
// the slot of lane j: per lane its key (-1 for padding and lanes >= n)
// and its target. Neighbouring threads take neighbouring lanes, so a
// warp's probes fall on neighbouring slots. f, the first lane that lane
// i counts, is the smallest j in [max(0, i - ne + 1), i] with
// val(j) >= wrap_sub(val(i), mw1): binary lifting from i by steps top,
// top / 2, .., 1 (top the largest power of two <= ne - 1, so the steps
// reach ne - 1 lanes), kSub lanes at a time so that their shared-memory
// probes overlap; padding lanes (most of a query's row) and lanes >= n
// skip the search, and a warp whose kSub lanes are all such skips the
// loop. hits(i, f) is the lane's count.
template <int E, typename Val, typename Hits>
__device__ __forceinline__ void sweep(Val val, Hits hits, int n, int ne,
                                      int top, int32_t mw1, int l2,
                                      int wbits, int (&lk)[E],
                                      int32_t (&lt)[E]) {
  constexpr int kSub = E < 8 ? E : 8;
  const int tid = threadIdx.x, nt = blockDim.x;
#pragma unroll
  for (int q0 = 0; q0 < E; q0 += kSub) {
    int32_t p[kSub], lo[kSub];
    int f[kSub], lim[kSub];
    bool live = false;
#pragma unroll
    for (int q = 0; q < kSub; ++q) {
      const int i = tid + (q0 + q) * nt;
      p[q] = i < n ? val(i) : kI32Max;
      lo[q] = wrap_sub(p[q], mw1);
      f[q] = i;
      lim[q] = p[q] != kI32Max ? max(0, i - ne + 1) : i;
      live |= lim[q] < i;
    }
    if (__any_sync(0xFFFFFFFFu, live)) {
      for (int step = top; step > 0; step >>= 1) {
#pragma unroll
        for (int q = 0; q < kSub; ++q) {
          const int j = f[q] - step;
          if (j >= lim[q] && val(j) >= lo[q]) f[q] = j;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kSub; ++q) {
      const int i = tid + (q0 + q) * nt;
      lt[q0 + q] = shr_logical(p[q], wbits);
      lk[q0 + q] = p[q] != kI32Max ? hits(i, f[q]) * l2 + (l2 - 1 - i) : -1;
    }
  }
}

// The K rounds of the top-k. lk / lt: the keys and targets of this
// thread's lanes; val(c): the slot of (compacted) lane c; begin(c, h):
// the slot of the first lane counted by lane c, whose count is h.
template <int E, typename Val, typename Begin>
__device__ __forceinline__ void top_k(Val val, Begin begin, int (&lk)[E],
                                      const int32_t (&lt)[E], int l2,
                                      int lshift, int wbits, int kk,
                                      int32_t* __restrict__ out) {
  __shared__ int part[2][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int32_t wmask = (int32_t)((1u << wbits) - 1u);
  for (int rd = 0; rd < kk; ++rd) {
    int m = INT_MIN;
#pragma unroll
    for (int k = 0; k < E; ++k) m = max(m, lk[k]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      m = max(m, __shfl_xor_sync(0xFFFFFFFFu, m, d));
    // one barrier a round: round rd + 2 writes this buffer again only
    // after every thread has passed round rd + 1's barrier
    if (lane == 0) part[rd & 1][warp] = m;
    __syncthreads();
    int best = part[rd & 1][0];
    for (int w = 1; w < nw; ++w) best = max(best, part[rd & 1][w]);
    const bool ok = best > 0;
    const int bc = ok ? (l2 - 1) - (best & (l2 - 1)) : 0;
    const int32_t pb = val(bc);
    const int32_t tbest = ok ? shr_logical(pb, wbits) : -1;
    if (tid == (bc & (blockDim.x - 1))) {  // the winner's thread
      int32_t* o = out + rd * 4;
      o[0] = tbest;
      o[1] = ok ? best >> lshift : 0;
      o[2] = ok ? begin(bc, best >> lshift) & wmask : 0;
      o[3] = ok ? pb & wmask : 0;
    }
#pragma unroll
    for (int k = 0; k < E; ++k)
      if (lt[k] == tbest) lk[k] = -1;
  }
}

template <int E, int T>
__global__ void __launch_bounds__(T)
candidates_kernel(const int32_t* __restrict__ pk,
                  const int32_t* __restrict__ mwir,
                  int32_t* __restrict__ out, int l2, int lshift, int r,
                  int wbits, int walk, int dwalk, int kk) {
  extern __shared__ int32_t sm[];
  __shared__ int red[33];
  int32_t* A = sm;                                   // lane i at slot(i)
  uint16_t* S = (uint16_t*)(sm + slot<int32_t>(l2) + 1);   // run starts
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x, t0 = tid * E;
  load_row<E>(pk + row * l2, A, r);
  if (tid == 0) A[slot<int32_t>(l2)] = 0;
  const int32_t mw1 = wrap_sub(mwir[row], 1);
  const int ne = dwalk ? dwalk : walk;
  int top = ne > 1 ? 1 : 0;
  while (top && 2 * top <= ne - 1) top *= 2;
  __syncthreads();
  if (r < l2) block_sort_row<int32_t, E>(A, l2, r > 0 ? r : 1);

  int lk[E];
  int32_t lt[E];
  int32_t* o = out + row * kk * 4;
  if (dwalk) {
    int32_t v[E];
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = A[slot<int32_t>(t0 + k)];
    const int32_t before = t0 ? A[slot<int32_t>(t0 - 1)] : ~v[0];
    unsigned starts = 0;
#pragma unroll
    for (int k = 0; k < E; ++k)
      starts |= (unsigned)(v[k] != (k ? v[k - 1] : before)) << k;
    int total;
    int c = block_excl_scan(__popc(starts), red, &total);
#pragma unroll
    for (int k = 0; k < E; ++k)
      if ((starts >> k) & 1) S[c++] = (uint16_t)(t0 + k);
    if (tid == 0) S[total] = (uint16_t)l2;
    __syncthreads();
    auto val = [&](int c) { return A[slot<int32_t>(S[c])]; };
    sweep<E>(val, [&](int i, int f) { return (int)S[i + 1] - (int)S[f]; },
             total, ne, top, mw1, l2, wbits, lk, lt);
    top_k<E>(val, [&](int c, int h) {
      return A[slot<int32_t>((int)S[c + 1] - h)]; },
      lk, lt, l2, lshift, wbits, kk, o);
  } else {
    auto val = [&](int i) { return A[slot<int32_t>(i)]; };
    sweep<E>(val, [](int i, int f) { return 1 + i - f; }, l2, ne, top, mw1,
             l2, wbits, lk, lt);
    top_k<E>(val, [&](int c, int h) { return A[slot<int32_t>(c + 1 - h)]; },
             lk, lt, l2, lshift, wbits, kk, o);
  }
}

template <int E, int T>
cudaError_t launch_candidates(const int32_t* pk, const int32_t* mwir,
                              int32_t* out, int64_t b, int l2, int lshift,
                              int r, int wbits, int walk, int dwalk, int kk,
                              cudaStream_t stream) {
  const size_t smem = row_bytes<int32_t>(l2) +
                      (dwalk ? (size_t)(l2 + 1) * sizeof(uint16_t) : 0);
  cudaError_t err = set_smem((const void*)candidates_kernel<E, T>, smem);
  if (err != cudaSuccess) return err;
  candidates_kernel<E, T><<<(unsigned)b, l2 / E, smem, stream>>>(
      pk, mwir, out, l2, lshift, r, wbits, walk, dwalk, kk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mc_sort_packed(const void* in, void* out, int64_t b, int l2,
                              int presorted, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (!pow2_in(l2, 128, kMaxSortL2) ||
      (presorted && !pow2_in(presorted, 1, l2)))
    return (int)cudaErrorInvalidValue;
  // E = 16 lanes a thread (256 threads at L2 = 4096), 32 at the widest
  // row so that the block stays within 1024 threads
  const auto* src = (const int32_t*)in;
  auto* dst = (int32_t*)out;
  const auto st = (cudaStream_t)stream;
  return (int)(l2 <= 16 * kMaxThreads
                   ? launch_sort<16>(src, dst, b, l2, presorted, st)
                   : launch_sort<32>(src, dst, b, l2, presorted, st));
}

extern "C" int mc_candidates_packed(const void* pk, const void* mwir,
                                    void* out, int64_t b, int l2,
                                    int presorted, int wbits, int walk,
                                    int dwalk, int kk, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (!pow2_in(l2, 128, kMaxCandL2) ||
      (presorted && !pow2_in(presorted, 1, l2)) || wbits < 1 ||
      wbits > 30 || kk < 1 || kk > 4 || walk < 0 || dwalk < 0 ||
      (walk == 0 && dwalk == 0))
    return (int)cudaErrorInvalidValue;
  int lshift = 0;
  while ((1 << lshift) < l2) ++lshift;
  // E = 16 lanes a thread (256 threads at L2 = 4096; the launch bound
  // leaves those blocks their registers), 32 at the widest row; rows of
  // 128 and 256 lanes take 4 and 8, so that the block keeps a warp
  const auto* p = (const int32_t*)pk;
  const auto* mw = (const int32_t*)mwir;
  auto* o = (int32_t*)out;
  const auto st = (cudaStream_t)stream;
  cudaError_t err;
  if (l2 == 128)
    err = launch_candidates<4, 32>(p, mw, o, b, l2, lshift, presorted,
                                   wbits, walk, dwalk, kk, st);
  else if (l2 == 256)
    err = launch_candidates<8, 32>(p, mw, o, b, l2, lshift, presorted,
                                   wbits, walk, dwalk, kk, st);
  else if (l2 <= 4096)
    err = launch_candidates<16, 256>(p, mw, o, b, l2, lshift, presorted,
                                     wbits, walk, dwalk, kk, st);
  else if (l2 <= 16384)
    err = launch_candidates<16, 1024>(p, mw, o, b, l2, lshift, presorted,
                                      wbits, walk, dwalk, kk, st);
  else
    err = launch_candidates<32, 1024>(p, mw, o, b, l2, lshift, presorted,
                                      wbits, walk, dwalk, kk, st);
  return (int)err;
}
