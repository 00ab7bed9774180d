// B6 to B9: the probe decode for Hopper (sm_90a).
//
// The two-tier layout keeps one head row per feature,
// [feature, count, ovf_idx, slot * (W - 3)], and one overflow row per
// feature whose bucket is deeper than the head's hsl slots (row 0 is a
// dummy that every other feature points at). Slots are packed
// pk = (tgt << wbits) | win; I32_MAX pads. The bucket-row index holds,
// for each hash prefix h, the logical 64-lane row [start, features...]
// (-1 pads). Rows the device builder pair-packs (two 64-lane rows a
// 128-lane row) are the same memory as 64-lane rows, and are read so.
//
// B6 replaces metacache_tpu/ops/probe_pallas.py::head_decode
// (_head_kernel, escalation phase 1); B7 replaces ::full_decode
// (_full_kernel, the escalation redo and the per-read path); B8 replaces
// ::oidx_decode (_oidx_kernel, the overflow row of a full-depth probe);
// B9 replaces ::bucket_decode (_bucket_kernel, the bucket-row probe). On
// the TPU XLA gathers the rows into device memory first and the Pallas
// kernels decode the gathered copy. Here each kernel takes the tables
// and the probe indices (B9: the features) and reads every row straight
// from device memory, so the gathered copy is never written.
//
// B6/B7: one warp per probe row reads the row's three meta lanes (one
// broadcast load), then only the slots the feature's count keeps, and
// writes the probe's rl output lanes, lane l of the warp at positions
// l, l + 32, ... (coalesced stores; odd features' runs are written
// reversed, which reads the row backwards). Bound: device-memory bytes.
// The output, rl lanes per probe, is most of them (33.5 MB for B6 and
// 134 MB for B7 at 131,072 probes); rows of features that miss cost the
// meta lanes only. B7 reads each probe's overflow row id from head lane
// 2, or from B8's output when it is given one.
//
// B8: one thread per probe reads lanes 0 and 2 of its head row (two
// loads of one 32-byte sector) and writes one int. B9: one warp per
// probe reads its 256-byte bucket row as one 8-byte load a lane (two
// logical lanes a lane, coalesced), matches the feature with a ballot
// (__any_sync) and sums the matching lanes' ranks with a shuffle
// reduction; lane 0 broadcasts the row's start. Both are bound by
// device-memory bytes: B9's 256-byte row a probe is nearly all of its
// traffic, B8's row sector and its 12 bytes of index, feature and
// output a probe are all of its.
//
// The kernels clamp probe and overflow indices into their tables, as
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
                   const int32_t* __restrict__ flat,
                   const int32_t* __restrict__ oidx, int64_t n, int hsl,
                   int c, int rl, int f, int32_t* __restrict__ pk) {
  const int64_t probe = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (probe >= n) return;
  const int32_t* row = head + clamp_row(idx[probe], nf) * hw;
  const int32_t fv = flat[probe];
  const bool found = row[0] == fv && fv != -1;
  const int cnt = found ? row[1] : 0;
  const int32_t o = oidx ? oidx[probe] : (found ? row[2] : 0);
  const int32_t* orow = ovf + clamp_row(o, novf) * ow;
  // slot j: head lane 3 + j below hsl, overflow lane j - hsl below c
  const int lim = cnt < c ? cnt : c;
  const bool odd = (probe % f) & 1;
  int32_t* out = pk + probe * rl;
  for (int p = lane; p < rl; p += 32) {
    const int j = odd ? rl - 1 - p : p;
    out[p] = j >= lim ? kI32Max : (j < hsl ? row[3 + j] : orow[j - hsl]);
  }
}

__global__ void __launch_bounds__(kThreads)
oidx_decode_kernel(const int32_t* __restrict__ head, int64_t nf, int hw,
                   const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ flat, int64_t n,
                   int32_t* __restrict__ oidx) {
  const int64_t probe = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (probe >= n) return;
  const int32_t* row = head + clamp_row(idx[probe], nf) * hw;
  const int32_t fv = flat[probe];
  oidx[probe] = (row[0] == fv && fv != -1) ? row[2] : 0;
}

__global__ void __launch_bounds__(kThreads)
bucket_decode_kernel(const int32_t* __restrict__ brows, int bits,
                     const int32_t* __restrict__ flat, int64_t n,
                     int32_t* __restrict__ idx, bool* __restrict__ found) {
  const int64_t probe = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (probe >= n) return;  // the whole warp: one probe a warp
  const int32_t fv = flat[probe];
  const uint32_t h = (uint32_t)fv >> (32 - bits);
  // logical lanes 2 * lane (.x) and 2 * lane + 1 (.y) of row h; lane 0
  // of the row is the bucket's start, lane j >= 1 in-bucket rank j - 1
  const int2 v = reinterpret_cast<const int2*>(brows + (int64_t)h * 64)[lane];
  const bool m0 = lane > 0 && v.x == fv;
  const bool m1 = v.y == fv;
  int local = (m0 ? 2 * lane - 1 : 0) + (m1 ? 2 * lane : 0);
  for (int o = 16; o > 0; o >>= 1)
    local += __shfl_xor_sync(0xffffffffu, local, o);
  const bool any = __any_sync(0xffffffffu, m0 || m1);
  const int32_t start = __shfl_sync(0xffffffffu, v.x, 0);
  if (lane == 0) {
    idx[probe] = start + local;
    found[probe] = any && fv != -1;
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
                              const void* idx, const void* flat,
                              const void* oidx, int64_t n, int hsl, int c,
                              int rl, int f, void* pk, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nf <= 0 || novf <= 0 || hsl < 0 || hw < 3 + hsl || c < hsl ||
      ow < c - hsl || rl < c || f < 1)
    return (int)cudaErrorInvalidValue;
  full_decode_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)head, nf, hw, (const int32_t*)ovf, novf, ow,
      (const int32_t*)idx, (const int32_t*)flat, (const int32_t*)oidx, n,
      hsl, c, rl, f, (int32_t*)pk);
  return (int)cudaGetLastError();
}

extern "C" int mc_oidx_decode(const void* head, int64_t nf, int hw,
                              const void* idx, const void* flat, int64_t n,
                              void* oidx, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nf <= 0 || hw < 3) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  oidx_decode_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)head, nf, hw, (const int32_t*)idx,
      (const int32_t*)flat, n, (int32_t*)oidx);
  return (int)cudaGetLastError();
}

extern "C" int mc_bucket_decode(const void* brows, int bits,
                                const void* flat, int64_t n, void* idx,
                                void* found, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (bits < 1 || bits > 31) return (int)cudaErrorInvalidValue;
  bucket_decode_kernel<<<blocks_for(n), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)brows, bits, (const int32_t*)flat, n, (int32_t*)idx,
      (bool*)found);
  return (int)cudaGetLastError();
}
