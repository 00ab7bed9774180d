// Block merge sort of one row in shared memory, shared by B3
// (candidates.cu::sort_kernel, i32 slots) and B5
// (candidates_unpacked.cu, u64 (tgt, win) keys), for Hopper (sm_90a).
//
// One block sorts one row of l2 keys (a power of two) with l2 / E
// threads, E consecutive lanes a thread. The row sits in shared memory
// with one pad slot every 128 bytes (slot()), so that the E lanes of the
// threads of a warp fall in distinct banks when each thread writes or
// reads its own lanes. The row enters as ascending runs of `run` lanes
// (run_lane() reverses the probe's descending runs while the caller
// loads them):
// - runs shorter than E: each thread sorts its own E keys in registers
//   with a bitonic compare-exchange network of compile-time indices;
// - then log2(l2 / run) merge levels. In each, a thread finds where its
//   E outputs start on the merge path of the two runs it merges from (a
//   binary search along its output diagonal), merges them serially into
//   registers, and after a barrier writes them back; a second barrier
//   ends the level.
// At l2 = 4096 with runs of 256 that is 4 levels, 8 barriers and about
// 4 x 4096 key moves, where a bitonic network takes 42 barriers and
// 86 K compare-exchanges. A sorted row of whole keys is unique, so the
// result equals any other correct sort bit for bit.
#pragma once

#include "block.cuh"

namespace mc {

// shared-memory slot of lane i: one pad slot per 128 bytes of keys
template <typename K>
__host__ __device__ __forceinline__ int slot(int i) {
  return i + (i >> (sizeof(K) == 8 ? 4 : 5));
}

// bytes of a row of l2 keys, with a spare slot past the end that the
// serial merge may read (and never uses)
template <typename K>
inline size_t row_bytes(int l2) {
  return (size_t)(slot<K>(l2) + 1) * sizeof(K);
}

// lane at which input lane i is stored: the probe emits alternating
// sorted runs of r lanes, odd runs descending, so those are reversed
__device__ __forceinline__ int run_lane(int i, int r) {
  return r > 1 && (i & r) ? i ^ (r - 1) : i;
}

// ascending bitonic sort of the E keys of one thread, in registers
template <typename K, int E>
__device__ __forceinline__ void sort_regs(K (&v)[E]) {
#pragma unroll
  for (int size = 2; size <= E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const K a = v[i], b = v[j];
          const bool up = (i & size) == 0;
          v[i] = (a < b) == up ? a : b;
          v[j] = (a < b) == up ? b : a;
        }
      }
    }
  }
}

// outputs t0 .. t0 + E - 1 of the merge of the two ascending runs of
// `run` lanes that hold lane t0 (run a from the pair's first lane, run b
// after it), into v
template <typename K, int E>
__device__ __forceinline__ void merge_runs(const K* sm, int run, int t0,
                                           K (&v)[E]) {
  const int a0 = t0 & ~(2 * run - 1), b0 = a0 + run;
  const int diag = t0 - a0;
  // keys of run a among the pair's first diag outputs; ties take run a
  int lo = max(0, diag - run), hi = min(diag, run);
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (sm[slot<K>(b0 + diag - 1 - m)] < sm[slot<K>(a0 + m)])
      hi = m;
    else
      lo = m + 1;
  }
  int ia = a0 + lo, ib = b0 + diag - lo;
  K ka = sm[slot<K>(ia)], kb = sm[slot<K>(ib)];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const bool tb = ib < b0 + run && (ia >= b0 || kb < ka);
    v[k] = tb ? kb : ka;
    ib += tb;
    ia += !tb;
    const K x = sm[slot<K>(tb ? ib : ia)];
    kb = tb ? x : kb;
    ka = tb ? ka : x;
  }
}

// Sorts the row in sm (lane i at slot(i), l2 / E threads) ascending. On
// entry it holds ascending runs of `run` lanes (1: none), and the block
// has passed a barrier since they were written; on return the sorted row
// is in sm, after a barrier.
template <typename K, int E>
__device__ __forceinline__ void block_sort_row(K* sm, int l2, int run) {
  const int t0 = threadIdx.x * E;
  K v[E];
  if (run < E) {  // each thread reads and writes its own lanes only
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = sm[slot<K>(t0 + k)];
    sort_regs<K, E>(v);
#pragma unroll
    for (int k = 0; k < E; ++k) sm[slot<K>(t0 + k)] = v[k];
    __syncthreads();
    run = E;
  }
  for (; run < l2; run <<= 1) {
    merge_runs<K, E>(sm, run, t0, v);
    __syncthreads();  // every thread has read the level's input
#pragma unroll
    for (int k = 0; k < E; ++k) sm[slot<K>(t0 + k)] = v[k];
    __syncthreads();
  }
}

}  // namespace mc
