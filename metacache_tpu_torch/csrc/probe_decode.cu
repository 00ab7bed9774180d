// B6 and B7: the two-tier probe decode for Hopper (sm_90a).
//
// The two-tier layout keeps one head row per feature,
// [feature, count, ovf_idx, slot * (W - 3)], and one overflow row per
// feature whose bucket is deeper than the head's hsl slots (row 0 is a
// dummy that every other feature points at). Slots are packed
// pk = (tgt << wbits) | win; I32_MAX pads.
//
// B6 replaces metacache_tpu/ops/probe_pallas.py::head_decode
// (_head_kernel, escalation phase 1); B7 replaces ::full_decode
// (_full_kernel, the escalation redo and the per-read path). On the TPU
// XLA gathers the rows into device memory first and the Pallas kernels
// decode the gathered copy. Here each kernel takes the tables and the
// probe indices and reads every row straight from device memory, so
// the gathered copy is never written: one warp per probe row reads the
// row's three meta lanes (one broadcast load), then only the slots the
// feature's count keeps, and writes the probe's rl output lanes, lane l
// of the warp at positions l, l + 32, ... (coalesced stores; odd
// features' runs are written reversed, which reads the row backwards).
// Bound: device-memory bytes. The output, rl lanes per probe, is most of
// them (33.5 MB for B6 and 134 MB for B7 at 131,072 probes); rows of
// features that miss cost the meta lanes only.
//
// Both kernels clamp probe and overflow indices into their tables, as
// the XLA gathers in front of the Pallas kernels do. A probe is odd when
// (probe index % f) is odd, the _odd_rows rule; f = 1 writes no run
// reversed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kI32Max = 0x7FFFFFFF;
constexpr int kThreads = 256;  // 8 probes per block

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t nrows) {
  return r < 0 ? 0 : (r >= nrows ? nrows - 1 : r);
}

__global__ void __launch_bounds__(kThreads)
head_decode_kernel(const int32_t* __restrict__ head, int64_t nf, int hw,
                   const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ flat, int64_t n, int hsl,
                   int rl, int f, int32_t* __restrict__ pk,
                   int32_t* __restrict__ cnt_out) {
  const int64_t probe = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (probe >= n) return;
  const int32_t* row = head + clamp_row(idx[probe], nf) * hw;
  const int32_t fv = flat[probe];
  const bool found = row[0] == fv && fv != -1;
  const int cnt = found ? row[1] : 0;
  const int lim = cnt < hsl ? cnt : hsl;
  const bool odd = (probe % f) & 1;
  int32_t* out = pk + probe * rl;
  for (int p = lane; p < rl; p += 32) {
    const int j = odd ? rl - 1 - p : p;
    out[p] = j < lim ? row[3 + j] : kI32Max;
  }
  if (lane == 0) cnt_out[probe] = cnt;
}

__global__ void __launch_bounds__(kThreads)
full_decode_kernel(const int32_t* __restrict__ head, int64_t nf, int hw,
                   const int32_t* __restrict__ ovf, int64_t novf, int ow,
                   const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ flat, int64_t n, int hsl,
                   int c, int rl, int f, int32_t* __restrict__ pk) {
  const int64_t probe = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (probe >= n) return;
  const int32_t* row = head + clamp_row(idx[probe], nf) * hw;
  const int32_t fv = flat[probe];
  const bool found = row[0] == fv && fv != -1;
  const int cnt = found ? row[1] : 0;
  const int32_t* orow = ovf + clamp_row(found ? row[2] : 0, novf) * ow;
  // slot j: head lane 3 + j below hsl, overflow lane j - hsl below c
  const int lim = cnt < c ? cnt : c;
  const bool odd = (probe % f) & 1;
  int32_t* out = pk + probe * rl;
  for (int p = lane; p < rl; p += 32) {
    const int j = odd ? rl - 1 - p : p;
    out[p] = j >= lim ? kI32Max : (j < hsl ? row[3 + j] : orow[j - hsl]);
  }
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n * 32 + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int mc_head_decode(const void* head, int64_t nf, int hw,
                              const void* idx, const void* flat, int64_t n,
                              int hsl, int rl, int f, void* pk, void* cnt,
                              void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nf <= 0 || hsl < 0 || hw < 3 + hsl || rl < hsl || rl <= 0 || f < 1)
    return (int)cudaErrorInvalidValue;
  head_decode_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)head, nf, hw, (const int32_t*)idx,
      (const int32_t*)flat, n, hsl, rl, f, (int32_t*)pk, (int32_t*)cnt);
  return (int)cudaGetLastError();
}

extern "C" int mc_full_decode(const void* head, int64_t nf, int hw,
                              const void* ovf, int64_t novf, int ow,
                              const void* idx, const void* flat, int64_t n,
                              int hsl, int c, int rl, int f, void* pk,
                              void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nf <= 0 || novf <= 0 || hsl < 0 || hw < 3 + hsl || c < hsl ||
      ow < c - hsl || rl < c || f < 1)
    return (int)cudaErrorInvalidValue;
  full_decode_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)head, nf, hw, (const int32_t*)ovf, novf, ow,
      (const int32_t*)idx, (const int32_t*)flat, n, hsl, c, rl, f,
      (int32_t*)pk);
  return (int)cudaGetLastError();
}
