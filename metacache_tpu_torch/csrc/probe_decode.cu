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
// B6: one warp takes 32 consecutive probes, so their index, feature and
// meta loads (lanes 0-3 of each row as one 16-byte load) are 32
// independent loads in flight, not a dependent chain per probe; each
// lane writes its probe's count. The rows are then copied by groups of
// 16 threads a probe at rl = 64 (two probes at a time; 32 threads at rl
// 128 and 256), one aligned int4 of row lanes a thread, loaded only
// where it holds a slot below min(count, hsl): output lanes 4t..4t+3 are
// row lanes 4t+3..4t+6, so each thread takes three of them from its
// neighbour's int4 by shuffles, and odd probes store their int4s in
// mirrored order, values reversed. Four probes' loads are issued before
// their stores. Heads whose width or alignment does not allow 16-byte
// loads take the same kernel's 4-byte path (one probe at a time, a lane
// per output lane). Bound: device-memory bytes, the output's rl lanes a
// probe (33.5 MB at 131,072 probes and rl 64) most of them; rows of
// features that miss cost the meta load only.
//
// B7: one warp per probe row reads the row's three meta lanes (one
// broadcast load), then only the slots the feature's count keeps, and
// writes the probe's rl output lanes, lane l of the warp at positions
// l, l + 32, ... (coalesced stores; odd features' runs are written
// reversed, which reads the row backwards). Bound: device-memory bytes,
// the output (134 MB at 131,072 probes) most of them. B7 reads each
// probe's overflow row id from head lane 2, or from B8's output when it
// is given one.
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
constexpr int kThreads = 256;  // B7, B9: 8 probes a block; B6: 256

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t nrows) {
  return r < 0 ? 0 : (r >= nrows ? nrows - 1 : r);
}

// B6's row int4 q (row lanes 4q..4q+3) where a slot below lim needs
// it (4q < 3 + lim; 3 + lim <= hw keeps it in the row), else zeros.
__device__ __forceinline__ int4 row_quad(const int32_t* __restrict__ row,
                                         int q, int lim) {
  return 4 * q < 3 + lim ? reinterpret_cast<const int4*>(row)[q]
                         : make_int4(0, 0, 0, 0);
}

// B6's output int4 q of one probe from thread t of its group of g: slots
// 4q..4q+3 are row lanes 4q+3..4q+6, the last lane of the thread's row
// int4 q (cur) and the first three of int4 q + 1, taken from thread t + 1
// by shuffles (the group's last thread loaded its own, nxt); slots at or
// past lim are I32_MAX. Odd probes store the int4 mirrored, values
// reversed. Every lane of the warp calls it (the shuffles); live = the
// probe exists and q < the probe's nq int4s.
__device__ __forceinline__ void put_quad(int4 cur, int4 nxt, int t, int g,
                                         int q, int lim, bool odd, int nq,
                                         bool live, int32_t* out) {
  int nx = __shfl_down_sync(0xffffffffu, cur.x, 1, g);
  int ny = __shfl_down_sync(0xffffffffu, cur.y, 1, g);
  int nz = __shfl_down_sync(0xffffffffu, cur.z, 1, g);
  if (t == g - 1) {
    nx = nxt.x;
    ny = nxt.y;
    nz = nxt.z;
  }
  if (!live) return;
  const int j = 4 * q;
  const int a = j < lim ? cur.w : kI32Max;
  const int b = j + 1 < lim ? nx : kI32Max;
  const int c = j + 2 < lim ? ny : kI32Max;
  const int d = j + 3 < lim ? nz : kI32Max;
  int4* dst = reinterpret_cast<int4*>(out);
  if (odd)
    dst[nq - 1 - q] = make_int4(d, c, b, a);
  else
    dst[q] = make_int4(a, b, c, d);
}

// B6: one warp takes 32 consecutive probes. Lane i loads probe
// p0 + i's index and feature and its row's meta (VEC: lanes 0-3 as one
// 16-byte load), writes its count, and keeps (row, lim = min(count, hsl),
// parity), which the probes' copies take by __shfl_sync. VEC (hw and rl
// multiples of 4, 16-byte aligned head): a probe's rl / 4 output int4s
// go to a group of g = 16 threads (rl <= 64: two probes at a time) or 32
// (several int4s a thread), U probes' row loads issued before their
// stores; else the whole warp copies one probe at a time, 4 bytes a
// lane.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
head_decode_kernel(const int32_t* __restrict__ head, int64_t nf, int hw,
                   const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ flat, int64_t n, int hsl,
                   int rl, int f, int32_t* __restrict__ pk,
                   int32_t* __restrict__ cnt_out) {
  const int lane = threadIdx.x & 31;
  const int64_t p0 =
      (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) << 5;
  if (p0 >= n) return;  // uniform per warp
  const int64_t p = p0 + lane;
  int32_t ri = 0;
  int meta = 0;  // (lim << 1) | parity
  if (p < n) {
    ri = (int32_t)clamp_row(idx[p], nf);
    const int32_t fv = flat[p];
    const int32_t* row = head + (int64_t)ri * hw;
    int32_t feat, count;
    if constexpr (VEC) {
      const int4 m = *reinterpret_cast<const int4*>(row);
      feat = m.x;
      count = m.y;
    } else {
      feat = row[0];
      count = row[1];
    }
    const int cnt = feat == fv && fv != -1 ? count : 0;
    cnt_out[p] = cnt;
    const int lim = cnt < hsl ? (cnt > 0 ? cnt : 0) : hsl;
    meta = (lim << 1) | (int)((p % f) & 1);
  }
  if constexpr (!VEC) {
    for (int i = 0; i < 32 && p0 + i < n; ++i) {
      const int64_t r = __shfl_sync(0xffffffffu, ri, i);
      const int mt = __shfl_sync(0xffffffffu, meta, i);
      const int lim = mt >> 1;
      const bool odd = mt & 1;
      const int32_t* row = head + r * hw;
      int32_t* out = pk + (p0 + i) * rl;
      for (int c = lane; c < rl; c += 32) {
        const int j = odd ? rl - 1 - c : c;
        out[c] = j < lim ? row[3 + j] : kI32Max;
      }
    }
  } else {
    constexpr int U = 4;
    const int g = rl > 64 ? 32 : 16;
    const int per = 32 / g;          // probes a step
    const int t = lane & (g - 1);
    const int h = lane / g;
    const int nq = rl >> 2;
    const int4 none = make_int4(kI32Max, kI32Max, kI32Max, kI32Max);
    for (int i0 = 0; i0 < 32; i0 += per * U) {
      int4 cur[U], nxt[U];
      int lim[U];
      bool odd[U];
      const int32_t* row[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * per + h;
        const int mt = __shfl_sync(0xffffffffu, meta, i);
        row[u] = head + (int64_t)__shfl_sync(0xffffffffu, ri, i) * hw;
        lim[u] = mt >> 1;
        odd[u] = mt & 1;
        cur[u] = row_quad(row[u], t, lim[u]);
        nxt[u] = t == g - 1 ? row_quad(row[u], g, lim[u])
                            : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t pi = p0 + i0 + u * per + h;
        const bool live = pi < n;
        int32_t* out = pk + pi * rl;
        put_quad(cur[u], nxt[u], t, g, t, lim[u], odd[u], nq,
                 live && t < nq, out);
        // int4s past the first g: rl > 64 (uniform loop)
        for (int q0 = g; q0 < nq; q0 += g) {
          const int q = q0 + t;
          if (4 * q0 < hsl) {  // uniform: the block may hold slots
            const int4 c = row_quad(row[u], q, lim[u]);
            const int4 x = t == g - 1 ? row_quad(row[u], q + 1, lim[u])
                                      : make_int4(0, 0, 0, 0);
            put_quad(c, x, t, g, q, lim[u], odd[u], nq, live && q < nq,
                     out);
          } else if (live && q < nq) {
            reinterpret_cast<int4*>(out)[odd[u] ? nq - 1 - q : q] = none;
          }
        }
      }
    }
  }
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
  const bool vec = hw % 4 == 0 && rl % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(head) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pk) % 16 == 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  auto kernel = vec ? head_decode_kernel<true> : head_decode_kernel<false>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
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
