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
// Design: the code of B3 + B4 (candidates.cu) on one 64-bit key per
// slot, k = (tgt ^ 2^31) << 32 | (win ^ 2^31). Flipping the sign bits
// makes the unsigned order of k the signed lexicographic (tgt, win)
// order of _sort2_lanes for every i32 input, so one u64 compare-exchange
// replaces the TPU kernel's two-array select chain. One block per row;
// the keys (8 B/slot) and one i32 word per slot (run starts and counts,
// then lane keys) sit in shared memory for the whole kernel: 48 KB at
// L2 = 4096, 192 KB at the limit L2 = 16384.
// - sort: the bitonic network from phase 2r when the probe emits
//   alternating sorted runs of r lanes (presorted = r), as _sort2_lanes;
//   presorted = L2 skips it for rows that arrive sorted;
// - walk sweep: lane i counts the earlier lanes i - e (e < walk) of its
//   own target whose window is >= win[i] - (mwir - 1); the begin window
//   is that of the last such lane. The test keeps the TPU kernel's two
//   compares (target equal, window in range), so it is exact for any
//   mwir and needs no slot-packing bound;
// - dedup sweep: runs of equal keys are compacted with a block prefix
//   sum to (key, count), then the same sweep adds counts over at most
//   dedup_walk distinct entries;
// - top-k: K rounds of a block max over hits * L2 + (L2 - 1 - lane) of
//   matching lanes, gated best > 0; the winner's begin window is
//   recomputed at its lane, and its whole target group is masked.
//
// Bound on the card: device memory sees one read of both slot matrices
// (8 B/slot) and a (B, K, 4) result, so HBM bounds it at 3.35 TB/s
// (~80 us at 8192 x 4096); the bitonic stages (42 at L2 = 4096,
// r = 256), each ending in __syncthreads, are what the kernel spends
// its time on.
#include "block.cuh"

using namespace mc;

namespace {

constexpr int kMaxL2 = 16384;           // 12 B/slot: 192 KB of shared memory
constexpr int kMaxPerThread = kMaxL2 / kMaxThreads;
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

// hits of the slot at lane i: earlier lanes of the same target whose
// window reaches win - (mwir - 1); dedup adds their run counts. *beg
// receives the window of the last such lane (its own window if none).
__device__ __forceinline__ int32_t sweep(const uint64_t* A, const int32_t* C,
                                         int i, int ne, bool dedup,
                                         int32_t mw1, int32_t* beg) {
  const uint64_t p = A[i];
  const int32_t t = tgt_of(p), w = win_of(p);
  const int32_t lo = wrap_sub(w, mw1);
  int32_t hits = dedup ? C[i] : 1;
  int32_t b = w;
  for (int e = 1; e < ne && e <= i; ++e) {
    const uint64_t q = A[i - e];
    if (tgt_of(q) == t && win_of(q) >= lo) {
      hits += dedup ? C[i - e] : 1;
      b = win_of(q);
    }
  }
  *beg = b;
  return hits;
}

__global__ void __launch_bounds__(kMaxThreads)
candidates_unpacked_kernel(const int32_t* __restrict__ tgt,
                           const int32_t* __restrict__ win,
                           const int32_t* __restrict__ mwir,
                           int32_t* __restrict__ out, int l2, int lshift,
                           int kstart, int walk, int dwalk, int kk) {
  extern __shared__ uint64_t smu[];
  __shared__ int red[33];
  uint64_t* A = smu;                          // slot keys
  int32_t* B = (int32_t*)(smu + l2);          // run starts / counts, lane keys
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < l2; i += nt)
    A[i] = key_of(tgt[row * l2 + i], win[row * l2 + i]);
  const int32_t mw1 = wrap_sub(mwir[row], 1);
  __syncthreads();

  for (int k = kstart; k <= l2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < (l2 >> 1); t += nt) {
        const int lo = 2 * t - (t & (j - 1));
        const int hi = lo + j;
        const uint64_t a = A[lo], b = A[hi];
        const bool asc = (lo & k) == 0;
        if ((a > b) == asc) {
          A[lo] = b;
          A[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  const uint64_t pad = key_of(kI32Max, kI32Max);
  if (dwalk) {
    // contiguous lane chunk per thread, so the scan order is lane order
    const int per = l2 / nt;
    const int base = tid * per;
    int ns = 0;
    for (int q = 0; q < per; ++q) {
      const int i = base + q;
      ns += (i == 0 || A[i] != A[i - 1]);
    }
    int total;
    int off = block_excl_scan(ns, red, &total);
    for (int q = 0; q < per; ++q) {
      const int i = base + q;
      if (i == 0 || A[i] != A[i - 1]) B[off++] = i;
    }
    __syncthreads();
    uint64_t cpv[kMaxPerThread];
    int32_t ccv[kMaxPerThread];
    for (int q = 0; q < per; ++q) {
      const int c = base + q;
      if (c < total) {
        const int st = B[c];
        const int nx = c + 1 < total ? B[c + 1] : l2;
        cpv[q] = A[st];
        ccv[q] = nx - st;
      } else {
        cpv[q] = pad;
        ccv[q] = 0;
      }
    }
    __syncthreads();
    for (int q = 0; q < per; ++q) {
      A[base + q] = cpv[q];
      B[base + q] = ccv[q];
    }
    __syncthreads();
    int32_t keyv[kMaxPerThread];
    for (int q = 0; q < per; ++q) {
      const int i = base + q;
      int32_t beg;
      const bool match = tgt_of(A[i]) != kI32Max;
      const int32_t hits = match ? sweep(A, B, i, dwalk, true, mw1, &beg) : 0;
      keyv[q] = match ? hits * l2 + (l2 - 1 - i) : -1;
    }
    __syncthreads();
    for (int q = 0; q < per; ++q) B[base + q] = keyv[q];
    __syncthreads();
  } else {
    for (int i = tid; i < l2; i += nt) {
      int32_t beg;
      const int32_t hits = sweep(A, nullptr, i, walk, false, mw1, &beg);
      B[i] = tgt_of(A[i]) != kI32Max ? hits * l2 + (l2 - 1 - i) : -1;
    }
    __syncthreads();
  }

  for (int r = 0; r < kk; ++r) {
    int m = INT_MIN;
    for (int i = tid; i < l2; i += nt) m = max(m, B[i]);
    const int best = block_max(m, red);
    const bool ok = best > 0;
    const int bc = ok ? (l2 - 1) - (best & (l2 - 1)) : 0;
    const int32_t tbest = ok ? tgt_of(A[bc]) : -1;
    if (tid == 0) {
      int32_t beg = 0;
      if (ok) sweep(A, B, bc, dwalk ? dwalk : walk, false, mw1, &beg);
      int32_t* o = out + (row * kk + r) * 4;
      o[0] = tbest;
      o[1] = ok ? best >> lshift : 0;
      o[2] = beg;
      o[3] = ok ? win_of(A[bc]) : 0;
    }
    for (int i = tid; i < l2; i += nt)
      if (tgt_of(A[i]) == tbest) B[i] = -1;
    __syncthreads();
  }
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
  const size_t smem = (size_t)l2 * (sizeof(uint64_t) + sizeof(int32_t));
  cudaError_t err = set_smem((const void*)candidates_unpacked_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = l2 < kMaxThreads ? l2 : kMaxThreads;
  int lshift = 0;
  while ((1 << lshift) < l2) ++lshift;
  const int kstart = presorted ? 2 * presorted : 2;
  candidates_unpacked_kernel<<<(unsigned)b, threads, smem,
                               (cudaStream_t)stream>>>(
      (const int32_t*)tgt, (const int32_t*)win, (const int32_t*)mwir,
      (int32_t*)out, l2, lshift, kstart, walk, dwalk, kk);
  return (int)cudaGetLastError();
}
