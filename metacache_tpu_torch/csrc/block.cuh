// Block-wide helpers shared by the candidate kernels (candidates.cu,
// candidates_unpacked.cu): one block works on one row of match slots.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace mc {

constexpr int32_t kI32Max = 0x7FFFFFFF;
constexpr int kMaxThreads = 1024;

// x - y with two's-complement wrap-around, as the i32 lane math of the
// TPU kernel (signed overflow is undefined in C++)
__device__ __forceinline__ int32_t wrap_sub(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x - (uint32_t)y);
}

__device__ __forceinline__ int32_t shr_logical(int32_t x, int bits) {
  return (int32_t)((uint32_t)x >> bits);
}

__device__ __forceinline__ int block_max(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, d));
  __syncthreads();  // earlier readers of red[32] are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int x = lane < nw ? red[lane] : INT_MIN;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x = max(x, __shfl_xor_sync(0xFFFFFFFFu, x, d));
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  return red[32];
}

// exclusive block prefix sum of x; *total receives the block sum
__device__ __forceinline__ int block_excl_scan(int x, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += t;
  }
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int y = lane < nw ? red[lane] : 0;
    int yi = y;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xFFFFFFFFu, yi, d);
      if (lane >= d) yi += t;
    }
    if (lane < nw) red[lane] = yi - y;
    if (lane == nw - 1) red[32] = yi;
  }
  __syncthreads();
  *total = red[32];
  return red[warp] + incl - x;
}

inline bool pow2_in(int x, int lo, int hi) {
  return x >= lo && x <= hi && (x & (x - 1)) == 0;
}

// Dynamic shared memory above the default 48 KB needs the attribute;
// set it on every launch, since the default also counts the kernel's
// static shared memory (48 KB of dynamic memory plus a reduction buffer
// is refused without it).
inline cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace mc
