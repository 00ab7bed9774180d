// B3 and B4: per-row candidate generation over packed match slots,
// pk = (tgt << wbits) | win, padding I32_MAX, for Hopper (sm_90a).
//
// B3 replaces metacache_tpu/ops/candidates_pallas.py::sort_pallas_packed
// (_sort_kernel / _sort1_lanes): ascending per-row sort of (B, L2) i32
// slots. The probe emits each feature's slots as sorted runs of r lanes
// in alternating directions (presorted = r); the TPU kernel starts its
// bitonic network at phase 2r. Here one block of L2 / E threads sorts a
// row by the block merge sort of row_sort.cuh between a coalesced load,
// which reverses the odd runs into shared memory, and a coalesced store:
// log2(L2 / r) merge levels (a register network first when r < E).
// Bound: device memory sees one read and one write of the slot matrix
// (~80 us at 8192 x 4096 on 3.35 TB/s). What the card spends beyond it:
// the merge levels' shared-memory reads (a binary search a thread and
// level, then one read a key) and one barrier pair a level (8 barriers
// at L2 = 4096, r = 256, where the bitonic network took 42).
//
// B4 replaces candidates_pallas_packed's sweep + top-k
// (_packed_kernel with the sort skipped, _compact_runs_packed) and
// takes rows that B3 sorted. One block per row over the row in shared
// memory:
// - walk mode: lane i counts the earlier lanes i - e (e < walk_elems)
//   with pk[i - e] >= pk[i] - (mwir - 1); its begin slot is the last
//   such lane (the packing makes that one compare test target and
//   window range together);
// - dedup mode: runs of equal slots are compacted with a block prefix
//   sum to (slot, count) pairs, then the same sweep adds counts over at
//   most dedup_walk distinct entries;
// - top-k: K rounds of a block max over key = hits * L2 + (L2 - 1 - lane)
//   of matching lanes, gated best > 0; the winner's slot gives target
//   and end window, its begin window is recomputed at that lane, and
//   every lane of the winner's target is masked before the next round.
// Bound: the sweep's walk_elems shared-memory reads per lane and K
// block reductions; device memory sees one read of the sorted slots and
// a (B, K, 4) result.
#include "row_sort.cuh"

using namespace mc;

namespace {

constexpr int kMaxSortL2 = 32768;       // 132 KB of shared memory
constexpr int kMaxCandL2 = 16384;       // two 64 KB row arrays
constexpr int kMaxPerThread = kMaxCandL2 / kMaxThreads;

template <int E>
__global__ void __launch_bounds__(kMaxThreads)
sort_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
            int l2, int r) {
  extern __shared__ int32_t sm[];
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < l2; i += nt)
    sm[slot<int32_t>(run_lane(i, r))] = in[row * l2 + i];
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

__global__ void __launch_bounds__(kMaxThreads)
candidates_kernel(const int32_t* __restrict__ pk,
                  const int32_t* __restrict__ mwir,
                  int32_t* __restrict__ out, int l2, int lshift, int wbits,
                  int walk, int dwalk, int kk) {
  extern __shared__ int32_t sm[];
  __shared__ int red[33];
  int32_t* A = sm;        // sorted (or compacted) slots
  int32_t* B = sm + l2;   // run starts / counts, then lane keys
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < l2; i += nt) A[i] = pk[row * l2 + i];
  const int32_t mw1 = mwir[row] - 1;
  __syncthreads();

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
    int32_t cpv[kMaxPerThread], ccv[kMaxPerThread];
    for (int q = 0; q < per; ++q) {
      const int c = base + q;
      if (c < total) {
        const int st = B[c];
        const int nx = c + 1 < total ? B[c + 1] : l2;
        cpv[q] = A[st];
        ccv[q] = nx - st;
      } else {
        cpv[q] = kI32Max;
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
      const int32_t p = A[i];
      const bool match = p != kI32Max;
      const int32_t lo = wrap_sub(p, mw1);
      int32_t hits = match ? B[i] : 0;
      for (int e = 1; e < dwalk; ++e)
        if (i >= e && match && A[i - e] >= lo) hits += B[i - e];
      keyv[q] = match ? hits * l2 + (l2 - 1 - i) : -1;
    }
    __syncthreads();
    for (int q = 0; q < per; ++q) B[base + q] = keyv[q];
    __syncthreads();
  } else {
    for (int i = tid; i < l2; i += nt) {
      const int32_t p = A[i];
      const int32_t lo = wrap_sub(p, mw1);
      int32_t hits = 1;
      for (int e = 1; e < walk; ++e)
        if (i >= e && A[i - e] >= lo) ++hits;
      B[i] = p != kI32Max ? hits * l2 + (l2 - 1 - i) : -1;
    }
    __syncthreads();
  }

  const int32_t wmask = (int32_t)((1u << wbits) - 1u);
  for (int r = 0; r < kk; ++r) {
    int m = INT_MIN;
    for (int i = tid; i < l2; i += nt) m = max(m, B[i]);
    const int best = block_max(m, red);
    const bool ok = best > 0;
    const int bc = ok ? (l2 - 1) - (best & (l2 - 1)) : 0;
    const int32_t pbest = A[bc];
    const int32_t tbest = ok ? shr_logical(pbest, wbits) : -1;
    if (tid == 0) {
      int32_t b = pbest;
      const int32_t lo = wrap_sub(pbest, mw1);
      const bool match = !dwalk || pbest != kI32Max;
      const int ne = dwalk ? dwalk : walk;
      for (int e = 1; e < ne; ++e)
        if (bc >= e && match && A[bc - e] >= lo) b = A[bc - e];
      int32_t* o = out + (row * kk + r) * 4;
      o[0] = tbest;
      o[1] = ok ? best >> lshift : 0;
      o[2] = ok ? (b & wmask) : 0;
      o[3] = ok ? (pbest & wmask) : 0;
    }
    for (int i = tid; i < l2; i += nt)
      if (shr_logical(A[i], wbits) == tbest) B[i] = -1;
    __syncthreads();
  }
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
                                    void* out, int64_t b, int l2, int wbits,
                                    int walk, int dwalk, int kk,
                                    void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (!pow2_in(l2, 128, kMaxCandL2) || wbits < 1 || wbits > 30 ||
      kk < 1 || kk > 4 || walk < 0 || dwalk < 0 || (walk == 0 && dwalk == 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)l2 * sizeof(int32_t);
  cudaError_t err = set_smem((const void*)candidates_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = l2 < kMaxThreads ? l2 : kMaxThreads;
  int lshift = 0;
  while ((1 << lshift) < l2) ++lshift;
  candidates_kernel<<<(unsigned)b, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)pk, (const int32_t*)mwir, (int32_t*)out, l2, lshift,
      wbits, walk, dwalk, kk);
  return (int)cudaGetLastError();
}
