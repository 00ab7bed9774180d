// B5: per-row candidates from unpacked (tgt, win) match slots, for
// Hopper (sm_90a).
//
// Replaces metacache_tpu/ops/candidates_pallas.py::candidates_pallas
// (_candidates_kernel: _sort2_lanes, _compact_runs, the walk or dedup
// sweep and the top-k rounds). It serves databases whose slots do not
// pack into one int32 (pack_bits = 0: many targets, long genomes). Same
// contract: (B, L2) i32 targets, (B, L2) i32 windows, padding
// (I32_MAX, I32_MAX), L2 a power of two >= 128, (B,) i32 mwir ->
// (B, K, 4) i32 [tgt, hits, beg, end] per round, tgt -1 when empty.
//
// Each slot is one 64-bit key k = (tgt ^ 2^31) << 32 | (win ^ 2^31):
// flipping the sign bits makes the unsigned order of k the signed
// lexicographic (tgt, win) order of _sort2_lanes for every i32 input.
// One block of L2 / E threads per row, E consecutive lanes a thread:
// - sort: the block merge sort of row_sort.cuh on the u64 keys (the
//   load reverses the probe's odd runs; log2(L2 / presorted) merge
//   levels; presorted = L2 skips it), the sorted keys left in shared
//   memory in lane order;
// - walk sweep as a search: lane i counts the lanes j, i - walk < j < i,
//   of its own target whose window is >= wrap_sub(win, mwir - 1). Along
//   the sorted row that test is false and then true, wrap-around
//   included (key(j1) <= key(j2) <= key(i)), so those lanes form one run
//   ending at i - 1 whose first lane f a binary search finds (5 probes
//   at walk 32, where the scan read 31 keys): hits = 1 + i - f, and the
//   begin window is win(f);
// - dedup sweep: runs of equal keys are compacted with a block prefix
//   sum to (key, run start); the same search over the compacted keys
//   (at most dedup_walk of them) gives f, and hits is the difference
//   of two run starts, the exclusive prefix sum of the run counts;
// - top-k: K rounds of a block max over hits * L2 + (L2 - 1 - lane) of
//   matching lanes, held in registers, gated best > 0; the winner's
//   begin window is searched again at its lane, and its whole target
//   group is masked.
// Bound on the card: device memory sees one read of both slot matrices
// (8 B/slot) and a (B, K, 4) result, ~80 us at 8192 x 4096 on
// 3.35 TB/s. Beyond it the card spends its time on the merge levels'
// shared-memory reads of 8-byte keys (one barrier pair a level) and the
// sweep's binary searches: on an H100 SXM at 700 W, at 8192 x 4096 and
// walk 32, the load and sort take 0.26 ms of 0.37, the sweep 0.09 and
// the top-k 0.03 (chip_smoke.py --split). Shared memory: the padded keys
// and one i32 run start a lane, 51 KB at L2 = 4096, 200 KB at 16384.
#include "row_sort.cuh"

using namespace mc;

namespace {

constexpr int kMaxL2 = 16384;           // 12.5 B/slot: 200 KB of shared memory
constexpr uint32_t kSign = 0x80000000u;

__device__ __forceinline__ uint64_t key_of(int32_t t, int32_t w) {
  return ((uint64_t)((uint32_t)t ^ kSign) << 32) | ((uint32_t)w ^ kSign);
}

__device__ __forceinline__ int32_t tgt_of(uint64_t k) {
  return (int32_t)((uint32_t)(k >> 32) ^ kSign);
}

__device__ __forceinline__ int32_t win_of(uint64_t k) {
  return (int32_t)((uint32_t)k ^ kSign);
}

// First lane f of the run that lane i of the sorted keys A counts: the
// lanes j, max(0, i - ne + 1) <= j < i, of p's target whose window is
// >= wrap_sub(win(p), mw1); i when there are none.
__device__ __forceinline__ int run_first(const uint64_t* A, int i, uint64_t p,
                                         int ne, int32_t mw1) {
  const int32_t t = tgt_of(p), lo = wrap_sub(win_of(p), mw1);
  int a = max(0, i - ne + 1), b = i;
  while (a < b) {
    const int m = (a + b) >> 1;
    const uint64_t q = A[slot<uint64_t>(m)];
    if (tgt_of(q) == t && win_of(q) >= lo)
      b = m;
    else
      a = m + 1;
  }
  return a;
}

template <int E>
__global__ void __launch_bounds__(kMaxThreads)
candidates_unpacked_kernel(const int32_t* __restrict__ tgt,
                           const int32_t* __restrict__ win,
                           const int32_t* __restrict__ mwir,
                           int32_t* __restrict__ out, int l2, int lshift,
                           int r, int walk, int dwalk, int kk) {
  extern __shared__ uint64_t smu[];
  __shared__ int red[33];
  uint64_t* A = smu;                                  // keys, lane i at slot(i)
  int32_t* S = (int32_t*)(smu + slot<uint64_t>(l2) + 1);   // run starts
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, t0 = tid * E;
  for (int i = tid; i < l2; i += nt)
    A[slot<uint64_t>(run_lane(i, r))] =
        key_of(tgt[row * l2 + i], win[row * l2 + i]);
  if (tid == 0) A[slot<uint64_t>(l2)] = 0;
  const int32_t mw1 = wrap_sub(mwir[row], 1);
  __syncthreads();
  block_sort_row<uint64_t, E>(A, l2, r > 0 ? r : 1);

  // per lane t0 + k: its target and its key for the top-k rounds
  int32_t lt[E], lk[E];
  if (dwalk) {
    // lane i starts a run when i == 0 or key(i) != key(i - 1); the
    // starts are compacted in lane order to A[c] (key) and S[c] (lane)
    uint64_t v[E];
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = A[slot<uint64_t>(t0 + k)];
    const uint64_t before = t0 ? A[slot<uint64_t>(t0 - 1)] : ~v[0];
    unsigned starts = 0;
#pragma unroll
    for (int k = 0; k < E; ++k)
      starts |= (unsigned)(v[k] != (k ? v[k - 1] : before)) << k;
    int total;
    int c = block_excl_scan(__popc(starts), red, &total);
    // the scan's barriers: every thread has read its neighbour's key
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if ((starts >> k) & 1) {
        A[slot<uint64_t>(c)] = v[k];
        S[c++] = t0 + k;
      }
    }
    if (tid == 0) S[total] = l2;
    __syncthreads();
    // compacted lane i < total: count S[i + 1] - S[i], and the counts of
    // lanes f .. i add up to S[i + 1] - S[f]
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int i = t0 + k;
      const uint64_t p = i < total ? A[slot<uint64_t>(i)] : ~0ull;
      lt[k] = tgt_of(p);
      lk[k] = -1;
      if (lt[k] != kI32Max) {
        const int f = run_first(A, i, p, dwalk, mw1);
        lk[k] = (S[i + 1] - S[f]) * l2 + (l2 - 1 - i);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int i = t0 + k;
      const uint64_t p = A[slot<uint64_t>(i)];
      lt[k] = tgt_of(p);
      lk[k] = -1;
      if (lt[k] != kI32Max)
        lk[k] = (1 + i - run_first(A, i, p, walk, mw1)) * l2 + (l2 - 1 - i);
    }
  }

  for (int rd = 0; rd < kk; ++rd) {
    int m = INT_MIN;
#pragma unroll
    for (int k = 0; k < E; ++k) m = max(m, lk[k]);
    const int best = block_max(m, red);
    const bool ok = best > 0;
    const int bc = ok ? (l2 - 1) - (best & (l2 - 1)) : 0;
    const uint64_t pb = A[slot<uint64_t>(bc)];
    const int32_t tbest = ok ? tgt_of(pb) : -1;
    if (tid == 0) {
      const int f = run_first(A, bc, pb, dwalk ? dwalk : walk, mw1);
      int32_t* o = out + (row * kk + rd) * 4;
      o[0] = tbest;
      o[1] = ok ? best >> lshift : 0;
      o[2] = ok ? win_of(A[slot<uint64_t>(f)]) : 0;
      o[3] = ok ? win_of(pb) : 0;
    }
#pragma unroll
    for (int k = 0; k < E; ++k)
      if (lt[k] == tbest) lk[k] = -1;
  }
}

template <int E>
cudaError_t launch_unpacked(const int32_t* tgt, const int32_t* win,
                            const int32_t* mwir, int32_t* out, int64_t b,
                            int l2, int lshift, int r, int walk, int dwalk,
                            int kk, cudaStream_t stream) {
  const size_t smem = row_bytes<uint64_t>(l2) + (l2 + 1) * sizeof(int32_t);
  cudaError_t err = set_smem((const void*)candidates_unpacked_kernel<E>, smem);
  if (err != cudaSuccess) return err;
  candidates_unpacked_kernel<E><<<(unsigned)b, l2 / E, smem, stream>>>(
      tgt, win, mwir, out, l2, lshift, r, walk, dwalk, kk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mc_candidates_unpacked(const void* tgt, const void* win,
                                      const void* mwir, void* out, int64_t b,
                                      int l2, int presorted, int walk,
                                      int dwalk, int kk, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (!pow2_in(l2, 128, kMaxL2) || (presorted && !pow2_in(presorted, 1, l2)) ||
      kk < 1 || kk > 4 || walk < 0 || dwalk < 0 || (walk == 0 && dwalk == 0))
    return (int)cudaErrorInvalidValue;
  int lshift = 0;
  while ((1 << lshift) < l2) ++lshift;
  // E = 16 lanes a thread (256 threads at L2 = 4096); narrower rows take
  // fewer, so that the block keeps a whole warp for its reductions
  const auto* t = (const int32_t*)tgt;
  const auto* w = (const int32_t*)win;
  const auto* mw = (const int32_t*)mwir;
  auto* o = (int32_t*)out;
  const auto st = (cudaStream_t)stream;
  cudaError_t err;
  if (l2 >= 512)
    err = launch_unpacked<16>(t, w, mw, o, b, l2, lshift, presorted, walk,
                              dwalk, kk, st);
  else if (l2 == 256)
    err = launch_unpacked<8>(t, w, mw, o, b, l2, lshift, presorted, walk,
                             dwalk, kk, st);
  else
    err = launch_unpacked<4>(t, w, mw, o, b, l2, lshift, presorted, walk,
                             dwalk, kk, st);
  return (int)err;
}
