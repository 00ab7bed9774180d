// Programmatic dependent launch (PDL) for Hopper (sm_90a), shared by the
// kernels that launch that way (classify.cu: classify_lca, rank_hist;
// probe_decode.cu: B8). Such a kernel may start while the kernel before
// it on the stream still runs; it must call grid_dependency_wait before
// its first read of anything that kernel wrote (and before any write),
// which returns once that kernel has finished and its writes are
// visible. empty_kernel, launched the same way on a kernel's grid, is
// that kernel's launch floor (classify.cu's mc_launch_floor,
// probe_decode.cu's mc_oidx_launch_floor).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// wait for the grids this one depends on
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__global__ void empty_kernel() {}

// a launch of ``blocks`` x ``threads`` on the stream as a programmatic
// dependent of the stream's previous kernel
template <typename... E, typename... A>
cudaError_t launch_dependent(unsigned blocks, int threads, void* stream,
                             void (*kernel)(E...), A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if constexpr (sizeof...(A) == 0)
    err = cudaLaunchKernelExC(&cfg, (const void*)kernel, nullptr);
  else
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
