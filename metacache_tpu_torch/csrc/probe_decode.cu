// B6 to B9, csr_decode, dense_decode, classed_bucket and
// classed_decode: the probe decode for Hopper (sm_90a).
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
// B8: one thread a probe reads its index and feature, then its row's
// lanes 0 and 2 by 4-byte loads (one sector), and writes one int. It
// launches as a programmatic dependent (its launch overlaps the kernel
// before it) and waits for that kernel before its first read. Bound:
// device-memory bytes, 20 a probe (index, feature, lanes 0 and 2,
// output; 2.6 MB at 131,072 probes), about the launch floor on this
// card; what it pays is its chain of round trips and, on a table past
// the TLB's reach, the translation of its random rows
// (tools/torch_b9_ab.py's footprints).
// Two or four probes a thread, with 16-byte index, feature and output
// loads and stores, timed 2-5% slower; one 16-byte load of lanes 0-3
// timed within the spread of the turns.
//
// B9, the bucket probe of every index (JAX's probe_bucket and
// probe_bucket64 too): one warp per probe reads its bucket row in chunks
// of 64 logical lanes, one 8-byte load a lane where the width is even
// (the pair-packed rows and the host's 64 lanes: one chunk, 256 bytes),
// two 4-byte loads a lane where it is odd (the host's 65 or 1 + 2^k
// lanes), matches the feature (u64: its low 32 bits) with a ballot
// (__any_sync) and sums the matching lanes' ranks with a shuffle
// reduction; lane 0's first load is the row's start, broadcast; the
// clamp into the feature table is folded in. Bound: device-memory
// bytes, the row a probe nearly all of them.
//
// classed_bucket and classed_decode: the size-classed layout's probe,
// which JAX leaves to XLA (metacache_tpu/ops/probe.py:167-212,
// ops/rows.py:469-575). classed_bucket: one warp takes 32 consecutive
// probes, loads their features at once (one coalesced load) and reads
// their 64-lane rows [a16_A, a16_B, a16_C, 61 lanes of two 16-bit
// entries] kCBLanes lanes a probe (8: two 16-byte loads a lane, four
// probes a step), kCBSteps steps' rows loaded before any is reduced (2:
// 2 KB of rows in flight a warp, not one 256-byte row behind two
// dependent loads, in few enough registers that every block of a batch
// is resident at once); the entries' match, JAX's sums of the matching
// entries' index and class (one packed reduction over the probe's lanes)
// and the rank among the valid entries of that class (a second) give the
// cell address, which goes back to the probe's own lane, so the warp
// stores 128 bytes of pidx and 32 of found at once. classed_decode's head
// form (escalation phase 1) is B6's design on the cells: lane i reads
// probe i's address, feature and its cell's first two lanes (one 8-byte
// load), writes the count; then groups of 16 threads copy a probe's
// min(count, hsl) slots, one aligned int4 of the cell's 64-lane half a
// thread, loaded only where it holds a kept slot (zero past the half),
// the slots' shift of 2 (classes A, B) or 3 lanes (class C) against the
// int4s taken from the neighbour's int4 by shuffles, odd probes'
// int4s stored mirrored, eight steps' loads issued before their stores;
// cells or outputs that are not 16-byte aligned take its 4-byte path.
// The full form (the redo) keeps dense_decode's design: one warp a
// probe, broadcast loads of the cell's meta lanes, lane l then takes
// output lanes l, l + 32, ..., reads slot j (mirrored for odd features)
// from the cell below hsl and from class C's overflow row past it, only
// where j < the count, re-encodes it and writes each output lane once.
// Bound: device-memory bytes, the 256-byte bucket row a probe
// (classed_bucket) and the rl output lanes a probe (classed_decode).
//
// csr_decode: the CSR layout's per-slot gathers, which JAX leaves to
// XLA (metacache_tpu/ops/rows.py:784-838: an (N, C) index tensor, two
// gathers, masks, the pack, a concatenate to rl and a flip). One warp a
// probe, as B7: every lane reads the probe's row id, found flag and
// offsets pair (one broadcast load each), lane l then takes output
// lanes l, l + 32, ..., reads slot j (mirrored for odd features) from
// loc_tgt and loc_win only where j < min(count, c), so a warp's loads
// are the bucket's contiguous slots, packs pk in registers and writes
// each output lane once (coalesced). Bound: device-memory bytes, the
// output's rl lanes a probe (134 MB at 131,072 probes, rl 256, packed)
// most of them; the slots read are 8 bytes each.
//
// dense_decode: the dense and two-tier lane rows' probe, which JAX
// leaves to XLA (metacache_tpu/ops/rows.py:624-838: a row gather, the
// overflow row's gather, masks, the slot encoding, a concatenate to rl
// and a flip). Rows: u32 dense [feat, count, slots], u32 two-tier heads
// [feat, count, ovf_idx, slots] with overflow rows [slots], and the u64
// forms with two meta lanes [flo, fhi, ...]; slots are one pk lane each
// (slot_bits > 0) or tgt lanes then win lanes (slot_bits = 0), C of them
// in a dense row, H in a head and C - H in an overflow row. One warp a
// probe, as csr_decode: every lane reads the probe's row id, feature and
// meta lanes (broadcast loads of one sector), lane l then takes output
// lanes l, l + 32, ..., reads slot j (mirrored for odd features) only
// where j < min(count, C), from the head below H and from the overflow
// row past it, re-encodes it in registers (MODE: pk passed through,
// re-based onto pack_bits, unpacked to (tgt, win), or (tgt, win) packed)
// and writes each output lane once (coalesced). Bound: device-memory
// bytes, the output's rl lanes a probe (134 MB at 131,072 probes, rl
// 256, packed) most of them; a probe reads only the slots its count
// keeps.
//
// The kernels clamp probe and overflow indices into their tables, as
// the XLA gathers in front of the Pallas kernels do. A probe is odd when
// (probe index % f) is odd, the _odd_rows rule; f = 1 writes no run
// reversed.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

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

// B6's and classed_decode's output int4 q of one probe from thread t of
// its group of g: slots 4q..4q+3 are row lanes 4q+shift..4q+shift+3
// (shift 3: B6's rows; 2 or 3: the classed cells), the last 4 - shift
// lanes of the thread's row int4 q (cur) and the first shift of int4
// q + 1, taken from thread t + 1 by shuffles (the group's last thread
// loaded its own, nxt); slots at or past lim are I32_MAX. Odd probes
// store the int4 mirrored, values reversed. Every lane of the warp calls
// it (the shuffles); live = the probe exists and q < the probe's nq
// int4s.
__device__ __forceinline__ void put_quad(int4 cur, int4 nxt, int t, int g,
                                         int q, int lim, bool odd, int nq,
                                         bool live, int32_t* out,
                                         int shift = 3) {
  int nx = __shfl_down_sync(0xffffffffu, cur.x, 1, g);
  int ny = __shfl_down_sync(0xffffffffu, cur.y, 1, g);
  int nz = __shfl_down_sync(0xffffffffu, cur.z, 1, g);
  if (t == g - 1) {
    nx = nxt.x;
    ny = nxt.y;
    nz = nxt.z;
  }
  if (!live) return;
  const bool s3 = shift == 3;
  const int j = 4 * q;
  const int a = j < lim ? (s3 ? cur.w : cur.z) : kI32Max;
  const int b = j + 1 < lim ? (s3 ? nx : cur.w) : kI32Max;
  const int c = j + 2 < lim ? (s3 ? ny : nx) : kI32Max;
  const int d = j + 3 < lim ? (s3 ? nz : ny) : kI32Max;
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

// B8's threads a block (tools/torch_b9_ab.py times other counts)
constexpr int kOidxThreads = 256;

// B8: one probe a thread. After the wait for the kernel before it, it
// reads its index and feature and its row's lanes 0 and 2, then writes
// its result.
__global__ void __launch_bounds__(kOidxThreads)
oidx_decode_kernel(const int32_t* __restrict__ head, int64_t nf, int hw,
                   const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ flat, int64_t n,
                   int32_t* __restrict__ oidx) {
  const int64_t probe = (int64_t)blockIdx.x * kOidxThreads + threadIdx.x;
  grid_dependency_wait();
  if (probe >= n) return;
  const int32_t* row = head + clamp_row(idx[probe], nf) * hw;
  const int32_t fv = flat[probe];
  oidx[probe] = (row[0] == fv && fv != -1) ? row[2] : 0;
}

unsigned oidx_blocks(int64_t n) {
  return (unsigned)((n + kOidxThreads - 1) / kOidxThreads);
}

// B9 on logical rows of L lanes (the pair-packed index: L = 64): lane 0
// the bucket's start, lane j >= 1 in-bucket rank j - 1, -1 pads. WIDE:
// int64 u64 bit patterns, the row of the top ``bits`` of 64, the match on
// the low 32 bits. FIXED: L known at compile time (64: one chunk, the
// loop unrolled), 0 = the runtime width L. VEC (L even, 8-byte aligned
// rows): each chunk of 64 lanes is one 8-byte load a lane (logical lanes
// c0 + 2 * lane and c0 + 2 * lane + 1); else two 4-byte loads (c0 + lane,
// c0 + 32 + lane). Lane 0's first load holds the start. idx = start + the
// sum of every matching lane's rank (JAX's sum, not the first match: the
// sentinel matches every padding lane), in wrapping int32 arithmetic,
// then clamped into [0, hi] where hi >= 0.
template <bool WIDE, bool VEC, int FIXED>
__global__ void __launch_bounds__(kThreads)
bucket_decode_kernel(const int32_t* __restrict__ brows, int64_t nrows,
                     int width, int bits, const void* __restrict__ flat,
                     int64_t n, int64_t hi, int32_t* __restrict__ idx,
                     bool* __restrict__ found) {
  const int L = FIXED ? FIXED : width;
  const int64_t probe = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (probe >= n) return;  // the whole warp: one probe a warp
  int32_t key;
  int64_t h;
  bool sentinel;
  if constexpr (WIDE) {
    const int64_t fv = static_cast<const int64_t*>(flat)[probe];
    h = (int64_t)((uint64_t)fv >> (64 - bits));
    key = (int32_t)fv;
    sentinel = fv == -1;
  } else {
    const int32_t fv = static_cast<const int32_t*>(flat)[probe];
    h = (int64_t)((uint32_t)fv >> (32 - bits));
    key = fv;
    sentinel = fv == -1;
  }
  const int32_t* row = brows + clamp_row(h, nrows) * L;
  uint32_t local = 0;
  bool any = false;
  int32_t start = 0;
#pragma unroll
  for (int c0 = 0; c0 < L; c0 += 64) {  // uniform
    int j0, j1;
    int32_t v0 = 0, v1 = 0;
    if constexpr (VEC) {
      j0 = c0 + 2 * lane;
      j1 = j0 + 1;
      if (j0 < L) {  // L even: j1 < L too
        const int2 v = reinterpret_cast<const int2*>(row + c0)[lane];
        v0 = v.x;
        v1 = v.y;
      }
    } else {
      j0 = c0 + lane;
      j1 = j0 + 32;
      if (j0 < L) v0 = row[j0];
      if (j1 < L) v1 = row[j1];
    }
    if (c0 == 0) start = v0;
    const bool m0 = j0 >= 1 && j0 < L && v0 == key;
    const bool m1 = j1 < L && v1 == key;
    local += (m0 ? (uint32_t)(j0 - 1) : 0u) + (m1 ? (uint32_t)(j1 - 1) : 0u);
    any |= m0 || m1;
  }
  for (int o = 16; o > 0; o >>= 1)
    local += __shfl_xor_sync(0xffffffffu, local, o);
  any = __any_sync(0xffffffffu, any);
  start = __shfl_sync(0xffffffffu, start, 0);
  if (lane == 0) {
    int32_t r = (int32_t)((uint32_t)start + local);
    if (hi >= 0) r = r < 0 ? 0 : (r > hi ? (int32_t)hi : r);
    idx[probe] = r;
    found[probe] = any && !sentinel;
  }
}

template <bool WIDE>
auto bucket_decode_for(int L, bool vec) {
  if (L == 64 && vec) return bucket_decode_kernel<WIDE, true, 64>;
  return vec ? bucket_decode_kernel<WIDE, true, 0>
             : bucket_decode_kernel<WIDE, false, 0>;
}

// classed_bucket's lanes a probe (32: one 8-byte load a lane; 4, 8 or
// 16: 64 / P row lanes a lane in 16-byte loads, 32 / P probes a step) and
// the steps whose rows a warp loads before it reduces any
// (tools/torch_classed_ab.py times the other choices)
constexpr int kCBLanes = 8;
constexpr int kCBSteps = 2;
// classed_decode's head form: the steps (two probes each) whose loads a
// warp issues before their stores
constexpr int kCHSteps = 8;

// Row lane of word r of lane l of a probe's P lanes: P = 32 holds row
// lanes 2l, 2l + 1 (one int2); P <= 16 the row's int4s l, l + P, ...
// (each load instruction reads 16 P contiguous bytes of the row), row
// lanes 4l + 4P (r >> 2) + (r & 3).
template <int P>
__device__ __forceinline__ int cb_row_lane(int l, int r) {
  return P == 32 ? 2 * l + r : 4 * l + 4 * P * (r >> 2) + (r & 3);
}

// Entry q of lane l's words w (half q & 1 of word q >> 1) -> its 16-bit
// value; idx2 = its entry index, negative for the base lanes 0-2.
template <int P>
__device__ __forceinline__ uint32_t cb_entry(const uint32_t* w, int l, int q,
                                             int& idx2) {
  idx2 = 2 * (cb_row_lane<P>(l, q >> 1) - 3) + (q & 1);
  return (q & 1) ? (w[q >> 1] >> 16) : (w[q >> 1] & 0xFFFFu);
}

// classed_bucket: the size-classed bucket probe. Logical row h (64
// lanes) = [a16_A, a16_B, a16_C, 61 entry lanes], two 16-bit entries a
// lane, entry = ((cls << 14) | feat_low) + 1, 0 = empty; entry index
// idx2 = 2 * (lane - 3) + half. One warp takes 32 consecutive probes
// (lane i loads probe p0 + i's feature) and decodes G = 32 / P of them a
// step, P lanes each, U steps' rows loaded before their reductions. j and
// cls are JAX's sums over the matching entries (one reduction of j | cls
// << 16 over the probe's P lanes: j's sum stays below 2^16), pre counts
// the valid entries of class cls before j (a second), and pidx = found ?
// ((base_cls + pre * w16_cls) << 2) | cls : 0, which lane i takes from
// its probe's first lane; the warp then stores every probe's pidx and
// found at once.
template <int P, int U>
__global__ void __launch_bounds__(kThreads)
classed_bucket_kernel(const int32_t* __restrict__ brows, int64_t nrows,
                      int bits, const int32_t* __restrict__ flat, int64_t n,
                      int32_t* __restrict__ pidx, bool* __restrict__ found) {
  constexpr int G = 32 / P;  // probes a step
  constexpr int R = 64 / P;  // row lanes a lane
  constexpr unsigned kAll = 0xffffffffu;
  static_assert((P == 4 || P == 8 || P == 16 || P == 32) &&
                    32 % (G * U) == 0,
                "lanes, steps");
  const int lane = threadIdx.x & 31;
  const int64_t p0 =
      (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) << 5;
  if (p0 >= n) return;  // uniform per warp
  const int32_t fv = p0 + lane < n ? flat[p0 + lane] : -1;
  const uint32_t kmask = (1u << (32 - bits)) - 1u;
  const int g = lane / P;        // the lane's probe of a step
  const int l = lane & (P - 1);  // its place among the probe's lanes
  const int src = lane - l;      // the probe's first lane
  const unsigned seg = P == 32 ? kAll : ((1u << P) - 1u) << src;
  int32_t mine = 0;  // lane i's probe's pidx
  bool mine_hit = false;
  for (int i0 = 0; i0 < 32; i0 += G * U) {
    uint32_t w[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * G + g;
      const int64_t h = (int64_t)((uint32_t)__shfl_sync(kAll, fv, i) >>
                                  (32 - bits));
      const int32_t* row = brows + clamp_row(h, nrows) * 64;
      if (p0 + i < n) {
        if constexpr (P == 32) {
          const int2 v = reinterpret_cast<const int2*>(row)[l];
          w[u][0] = (uint32_t)v.x;
          w[u][1] = (uint32_t)v.y;
        } else {
#pragma unroll
          for (int k = 0; k < R / 4; ++k) {
            const int4 v = reinterpret_cast<const int4*>(row)[l + P * k];
            w[u][4 * k] = (uint32_t)v.x;
            w[u][4 * k + 1] = (uint32_t)v.y;
            w[u][4 * k + 2] = (uint32_t)v.z;
            w[u][4 * k + 3] = (uint32_t)v.w;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) w[u][r] = 0;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int32_t f = __shfl_sync(kAll, fv, i0 + u * G + g);
      const int32_t key = (int32_t)((uint32_t)f & kmask);
      uint32_t acc = 0;
      bool any = false;
#pragma unroll
      for (int q = 0; q < 2 * R; ++q) {
        int idx2;
        const uint32_t x = cb_entry<P>(w[u], l, q, idx2);
        const uint32_t e = x - 1u;
        if (idx2 >= 0 && x != 0 && (int32_t)(e & 0x3FFFu) == key) {
          acc += (uint32_t)idx2 + ((e >> 14) << 16);
          any = true;
        }
      }
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(kAll, acc, o);
      const bool hit = (__ballot_sync(kAll, any) & seg) != 0 && f != -1;
      const int j = (int)(acc & 0xFFFFu);
      const uint32_t cls = acc >> 16;
      int pre = 0;
#pragma unroll
      for (int q = 0; q < 2 * R; ++q) {
        int idx2;
        const uint32_t x = cb_entry<P>(w[u], l, q, idx2);
        pre += idx2 >= 0 && x != 0 && ((x - 1u) >> 14) == cls && idx2 < j;
      }
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1)
        pre += __shfl_xor_sync(kAll, pre, o);
      // the bases: row lanes 0-2, in the probe's first lanes
      const int32_t a = __shfl_sync(kAll, (int32_t)w[u][0], src);
      const int32_t b = __shfl_sync(kAll, (int32_t)w[u][1], src);
      const int32_t c = __shfl_sync(kAll, (int32_t)w[u][2 % R],
                                    src + (P == 32 ? 1 : 0));
      const int32_t base = cls == 0 ? a : (cls == 1 ? b : c);
      const uint32_t w16 = cls == 0 ? 1u : (cls == 1 ? 2u : 4u);
      const uint32_t addr = (uint32_t)base + (uint32_t)pre * w16;
      const int32_t res = hit ? (int32_t)((addr << 2) | cls) : 0;
      // lane i's probe is probe (i % G) of step (i % (G U)) / G of
      // iteration i / (G U)
      const int from = (lane % G) * P;
      const int32_t rv = __shfl_sync(kAll, res, from);
      const bool rh = __shfl_sync(kAll, (int)hit, from);
      if (lane / (G * U) == i0 / (G * U) && (lane % (G * U)) / G == u) {
        mine = rv;
        mine_hit = rh;
      }
    }
  }
  if (p0 + lane < n) {
    pidx[p0 + lane] = mine;
    found[p0 + lane] = mine_hit;
  }
}

// classed_decode's output encodings (mc_classed_decode picks one; the
// cells store pk slots)
enum ClassedMode { kCPass = 0, kCRebase = 1, kCUnpack = 2 };

// classed_decode's head form: pidx = (a16 << 2) | cls; the cell starts
// at lane sh = 16 * (a16 & 3) of 64-lane half a16 >> 2 (clamped) of the
// (P, 128) cells (cells are 16/32/64 lanes at width-aligned offsets, so
// none crosses a half). Cell lanes 0 and 1 are the feature and the count;
// slot j lies at cell lane j + s, s = 3 for class C (lane 2 holds its
// overflow row id) and 2 for the others; lanes past the half read 0. Lane
// i reads probe p0 + i's address, feature and count (VEC: one 8-byte
// load), writes its count and keeps (half, lim = min(count, hsl), s,
// parity). VEC (rl a multiple of 4, 16-byte aligned cells and output):
// a group of 16 threads copies a probe (two probes a step), thread t the
// half's int4 sh / 4 + t, cell lanes 4t..4t+3, which put_quad shifts by
// s; hsl <= 61 puts slot 60, the last, in the group's 16th int4, so no
// group needs the int4 past its own, and output int4s from 16 on are
// padding. U steps' loads are issued before their stores. Else the warp
// copies one probe at a time, a lane per output lane.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
classed_head_kernel(const int32_t* __restrict__ cells, int64_t nhalf,
                    const int32_t* __restrict__ pidx,
                    const int32_t* __restrict__ flat, int64_t n, int hsl,
                    int rl, int f, int32_t* __restrict__ pk,
                    int32_t* __restrict__ cnt_out) {
  const int lane = threadIdx.x & 31;
  const int64_t p0 =
      (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) << 5;
  if (p0 >= n) return;  // uniform per warp
  const int64_t p = p0 + lane;
  int32_t hr = 0;  // the cell's half
  int meta = 0;    // (lim << 6) | sh | (s == 3) << 1 | parity
  if (p < n) {
    const uint32_t pi = (uint32_t)pidx[p];
    const uint32_t a16 = pi >> 2;
    hr = (int32_t)clamp_row((int64_t)(a16 >> 2), nhalf);
    const int sh = 16 * (int)(a16 & 3u);
    const int32_t* cell = cells + (int64_t)hr * 64 + sh;
    const int32_t fv = flat[p];
    int32_t feat, count;
    if constexpr (VEC) {
      const int2 m = *reinterpret_cast<const int2*>(cell);
      feat = m.x;
      count = m.y;
    } else {
      feat = cell[0];
      count = cell[1];
    }
    const int cnt = feat == fv && fv != -1 ? count : 0;
    cnt_out[p] = cnt;
    const int lim = cnt < hsl ? (cnt > 0 ? cnt : 0) : hsl;
    meta = (lim << 6) | sh | ((pi & 3u) == 2u ? 2 : 0) | (int)((p % f) & 1);
  }
  if constexpr (!VEC) {
    for (int i = 0; i < 32 && p0 + i < n; ++i) {
      const int32_t* half =
          cells + (int64_t)__shfl_sync(0xffffffffu, hr, i) * 64;
      const int mt = __shfl_sync(0xffffffffu, meta, i);
      const int lim = mt >> 6;
      const int sb = (mt & 0x3C) + ((mt & 2) ? 3 : 2);  // half lane of slot 0
      const bool odd = mt & 1;
      int32_t* out = pk + (p0 + i) * rl;
      for (int c = lane; c < rl; c += 32) {
        const int j = odd ? rl - 1 - c : c;
        out[c] = j < lim ? (sb + j < 64 ? half[sb + j] : 0) : kI32Max;
      }
    }
  } else {
    constexpr int U = kCHSteps;
    constexpr int g = 16;
    const int t = lane & (g - 1);
    const int h = lane / g;
    const int nq = rl >> 2;
    const int4 zero = make_int4(0, 0, 0, 0);
    const int4 none = make_int4(kI32Max, kI32Max, kI32Max, kI32Max);
    for (int i0 = 0; i0 < 32; i0 += 2 * U) {
      int4 cur[U];
      int mt[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + 2 * u + h;
        mt[u] = __shfl_sync(0xffffffffu, meta, i);
        const int4* half = reinterpret_cast<const int4*>(
            cells + (int64_t)__shfl_sync(0xffffffffu, hr, i) * 64);
        const int k = ((mt[u] & 0x3C) >> 2) + t;  // the half's int4
        const int s = (mt[u] & 2) ? 3 : 2;
        cur[u] = k < 16 && 4 * t < s + (mt[u] >> 6) ? half[k] : zero;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t pi = p0 + i0 + 2 * u + h;
        const bool live = pi < n;
        const bool odd = mt[u] & 1;
        int32_t* out = pk + pi * rl;
        put_quad(cur[u], zero, t, g, t, mt[u] >> 6, odd, nq,
                 live && t < nq, out, (mt[u] & 2) ? 3 : 2);
        if (live)
          for (int q = g + t; q < nq; q += g)
            reinterpret_cast<int4*>(out)[odd ? nq - 1 - q : q] = none;
      }
    }
  }
}

// classed_decode's full form (the redo): one warp a probe, as
// dense_decode. The cell as in the head form; class C's overflow row id
// is its lane 2. Slot j < hsl comes from the cell, j >= hsl from the
// overflow row: the first min(count, c), then the caller's encoding
// (MODE), the padding to rl and the reversed odd runs, each output lane
// stored once (coalesced).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
classed_decode_kernel(const int32_t* __restrict__ cells, int64_t nhalf,
                      const int32_t* __restrict__ ovf, int64_t novf, int ow,
                      const int32_t* __restrict__ pidx,
                      const int32_t* __restrict__ flat, int64_t n, int hsl,
                      int c, int rl, int f, int slot_bits, int pack_bits,
                      int32_t* __restrict__ out0, int32_t* __restrict__ out1) {
  const int64_t probe = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (probe >= n) return;  // the whole warp: one probe a warp
  const uint32_t pi = (uint32_t)pidx[probe];
  const uint32_t a16 = pi >> 2;
  const int sh = 16 * (int)(a16 & 3u);
  const int32_t* half = cells + clamp_row((int64_t)(a16 >> 2), nhalf) * 64;
  const int32_t fv = flat[probe];
  const bool found = half[sh] == fv && fv != -1;
  const int cnt = found ? half[sh + 1] : 0;
  const bool isC = (pi & 3u) == 2u;
  const int lim = cnt < c ? (cnt > 0 ? cnt : 0) : c;
  const int sb = sh + (isC ? 3 : 2);  // half lane of slot 0
  const int32_t* orow = nullptr;
  if (lim > hsl)
    orow = ovf + clamp_row(found && isC ? half[sh + 2] : 0, novf) * ow;
  const bool odd = (probe % f) & 1;
  const uint32_t smask = (1u << slot_bits) - 1u;
  int32_t* o0 = out0 + probe * rl;
  int32_t* o1 = MODE == kCUnpack ? out1 + probe * rl : nullptr;
  for (int p = lane; p < rl; p += 32) {
    const int j = odd ? rl - 1 - p : p;
    int32_t a = kI32Max;
    if (j < lim) {
      if (j < hsl)
        a = sb + j < 64 ? half[sb + j] : 0;  // zero filled past the half
      else
        a = orow[j - hsl];
    }
    const uint32_t u = (uint32_t)a;
    if constexpr (MODE == kCPass) {
      o0[p] = a;
    } else if constexpr (MODE == kCRebase) {
      o0[p] = a == kI32Max ? kI32Max
                           : (int32_t)(((u >> slot_bits) << pack_bits) |
                                       (u & smask));
    } else {
      o0[p] = a == kI32Max ? kI32Max : (int32_t)(u >> slot_bits);
      o1[p] = a == kI32Max ? kI32Max : (int32_t)(u & smask);
    }
  }
}

template <bool PACK>
__global__ void __launch_bounds__(kThreads)
csr_decode_kernel(const int32_t* __restrict__ idx,
                  const bool* __restrict__ found,
                  const int64_t* __restrict__ offsets, int64_t nf,
                  const int32_t* __restrict__ ltgt,
                  const int32_t* __restrict__ lwin, int64_t nloc, int64_t n,
                  int c, int rl, int f, int pack_bits,
                  int32_t* __restrict__ out0, int32_t* __restrict__ out1) {
  const int64_t probe = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (probe >= n) return;  // the whole warp: one probe a warp
  int64_t beg = 0;
  int lim = 0;
  if (found[probe] && nf > 0 && nloc > 0) {
    const int64_t r = clamp_row(idx[probe], nf);
    beg = offsets[r];
    const int64_t cnt = offsets[r + 1] - beg;
    lim = cnt < c ? (int)cnt : c;
  }
  const bool odd = (probe % f) & 1;
  int32_t* o0 = out0 + probe * rl;
  int32_t* o1 = PACK ? nullptr : out1 + probe * rl;
  for (int p = lane; p < rl; p += 32) {
    const int j = odd ? rl - 1 - p : p;
    int32_t t = kI32Max, w = kI32Max;
    if (j < lim) {
      const int64_t li = beg + j < nloc ? beg + j : nloc - 1;
      t = ltgt[li];
      w = lwin[li];
      if constexpr (PACK)
        t = (int32_t)(((uint32_t)t << pack_bits) | (uint32_t)w);
    }
    o0[p] = t;
    if constexpr (!PACK) o1[p] = w;
  }
}

// dense_decode's output encodings (mc_dense_decode picks one)
enum DenseMode {
  kPass = 0,    // stored pk, pack_bits = slot_bits
  kRebase = 1,  // stored pk re-based onto pack_bits
  kUnpack = 2,  // stored pk -> (tgt, win)
  kPack = 3,    // stored (tgt, win) -> pk
  kLanes = 4    // stored (tgt, win) -> (tgt, win)
};

// WIDE: u64 features (int64 bit patterns, two meta lanes). ovf null:
// dense rows (H = C). Slot j lives at head lane hb + j below H, else at
// overflow lane j - H; a win lane sits H (head) or C - H (overflow)
// lanes past its tgt lane. Masked and padding lanes are I32_MAX, which
// every encoding maps to I32_MAX.
template <bool WIDE, int MODE>
__global__ void __launch_bounds__(kThreads)
dense_decode_kernel(const int32_t* __restrict__ head, int64_t nf, int hw,
                    const int32_t* __restrict__ ovf, int64_t novf, int ow,
                    const int32_t* __restrict__ idx,
                    const void* __restrict__ flat, int64_t n, int hsl,
                    int c, int rl, int f, int slot_bits, int pack_bits,
                    int32_t* __restrict__ out0, int32_t* __restrict__ out1) {
  constexpr bool kStoredPk = MODE <= kUnpack;
  constexpr int kMeta = WIDE ? 2 : 1;
  const int64_t probe = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (probe >= n) return;  // the whole warp: one probe a warp
  const int32_t* row = head + clamp_row(idx[probe], nf) * hw;
  bool found;
  if constexpr (WIDE) {
    const int64_t fv = static_cast<const int64_t*>(flat)[probe];
    found = row[0] == (int32_t)fv && row[1] == (int32_t)(fv >> 32) &&
            fv != -1;
  } else {
    const int32_t fv = static_cast<const int32_t*>(flat)[probe];
    found = row[0] == fv && fv != -1;
  }
  const int cnt = found ? row[kMeta] : 0;
  const int lim = cnt < c ? (cnt > 0 ? cnt : 0) : c;
  const bool two = ovf != nullptr;
  const int hs = two ? hsl : c;          // slots in the head
  const int os = c - hs;                 // slots in the overflow row
  const int32_t* hrow = row + kMeta + (two ? 2 : 1);
  const int32_t* orow =
      two && lim > hs ? ovf + clamp_row(found ? row[kMeta + 1] : 0, novf) * ow
                      : nullptr;
  const bool odd = (probe % f) & 1;
  const uint32_t smask = (1u << slot_bits) - 1u;
  int32_t* o0 = out0 + probe * rl;
  int32_t* o1 = MODE == kUnpack || MODE == kLanes ? out1 + probe * rl
                                                  : nullptr;
  for (int p = lane; p < rl; p += 32) {
    const int j = odd ? rl - 1 - p : p;
    int32_t a = kI32Max, b = kI32Max;
    if (j < lim) {
      const int32_t* src = j < hs ? hrow + j : orow + (j - hs);
      a = src[0];
      if constexpr (!kStoredPk) b = src[j < hs ? hs : os];
    }
    const uint32_t u = (uint32_t)a;
    if constexpr (MODE == kPass) {
      o0[p] = a;
    } else if constexpr (MODE == kRebase) {
      o0[p] = a == kI32Max ? kI32Max
                           : (int32_t)(((u >> slot_bits) << pack_bits) |
                                       (u & smask));
    } else if constexpr (MODE == kUnpack) {
      o0[p] = a == kI32Max ? kI32Max : (int32_t)(u >> slot_bits);
      o1[p] = a == kI32Max ? kI32Max : (int32_t)(u & smask);
    } else if constexpr (MODE == kPack) {
      o0[p] = a == kI32Max ? kI32Max
                           : (int32_t)((u << pack_bits) | (uint32_t)b);
    } else {
      o0[p] = a;
      o1[p] = b;
    }
  }
}

template <bool WIDE>
auto dense_decode_for(int mode) {
  switch (mode) {
    case kPass: return dense_decode_kernel<WIDE, kPass>;
    case kRebase: return dense_decode_kernel<WIDE, kRebase>;
    case kUnpack: return dense_decode_kernel<WIDE, kUnpack>;
    case kPack: return dense_decode_kernel<WIDE, kPack>;
    default: return dense_decode_kernel<WIDE, kLanes>;
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

// a programmatic dependent launch
extern "C" int mc_oidx_decode(const void* head, int64_t nf, int hw,
                              const void* idx, const void* flat, int64_t n,
                              void* oidx, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nf <= 0 || hw < 3) return (int)cudaErrorInvalidValue;
  return (int)launch_dependent(oidx_blocks(n), kOidxThreads, stream,
                               oidx_decode_kernel, (const int32_t*)head, nf,
                               hw, (const int32_t*)idx, (const int32_t*)flat,
                               n, (int32_t*)oidx);
}

// B8's launch floor: an empty kernel launched as B8 is at n probes
extern "C" int mc_oidx_launch_floor(int64_t n, void* stream) {
  return (int)launch_dependent(oidx_blocks(n < 1 ? 1 : n), kOidxThreads,
                               stream, empty_kernel);
}

extern "C" int mc_bucket_decode(const void* brows, int64_t nrows, int L,
                                int bits, const void* flat, int wide,
                                int64_t n, int64_t hi, void* idx,
                                void* found, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (bits < 1 || bits > (wide ? 63 : 31) || L < 2 || nrows <= 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = L % 2 == 0 && reinterpret_cast<uintptr_t>(brows) % 8 == 0;
  auto kernel = wide ? bucket_decode_for<true>(L, vec)
                     : bucket_decode_for<false>(L, vec);
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)brows, nrows, L, bits, flat, n, hi, (int32_t*)idx,
      (bool*)found);
  return (int)cudaGetLastError();
}

extern "C" int mc_classed_bucket(const void* brows, int64_t nrows, int bits,
                                 const void* flat, int64_t n, void* pidx,
                                 void* found, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (bits < 1 || bits > 31 || nrows <= 0 ||
      reinterpret_cast<uintptr_t>(brows) % (kCBLanes == 32 ? 8 : 16) != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  classed_bucket_kernel<kCBLanes, kCBSteps>
      <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const int32_t*)brows, nrows, bits, (const int32_t*)flat, n,
          (int32_t*)pidx, (bool*)found);
  return (int)cudaGetLastError();
}

extern "C" int mc_classed_decode(const void* cells, int64_t nhalf,
                                 const void* ovf, int64_t novf, int ow,
                                 const void* pidx, const void* flat,
                                 int64_t n, int hsl, int c, int rl, int f,
                                 int slot_bits, int pack_bits, int head,
                                 void* out0, void* out1, void* cnt,
                                 void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int width = head ? hsl : c;
  if (nhalf <= 0 || hsl < 1 || hsl > 61 || c < 1 || rl < width || f < 1 ||
      slot_bits < 1 || slot_bits > 30 || pack_bits < 0 || pack_bits > 30 ||
      (!head && c > hsl && (ovf == nullptr || novf <= 0 || ow < c - hsl)) ||
      (head && (pack_bits != slot_bits || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (head) {
    const bool vec = rl % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(cells) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out0) % 16 == 0;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    auto kernel = vec ? classed_head_kernel<true> : classed_head_kernel<false>;
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)cells, nhalf, (const int32_t*)pidx,
        (const int32_t*)flat, n, hsl, rl, f, (int32_t*)out0, (int32_t*)cnt);
    return (int)cudaGetLastError();
  }
  const int mode = pack_bits == slot_bits ? kCPass
                   : pack_bits ? kCRebase : kCUnpack;
  if (mode == kCUnpack && out1 == nullptr) return (int)cudaErrorInvalidValue;
  auto kernel = mode == kCPass ? classed_decode_kernel<kCPass>
                : mode == kCRebase ? classed_decode_kernel<kCRebase>
                                   : classed_decode_kernel<kCUnpack>;
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cells, nhalf, (const int32_t*)ovf, novf, ow,
      (const int32_t*)pidx, (const int32_t*)flat, n, hsl, c, rl, f,
      slot_bits, pack_bits, (int32_t*)out0, (int32_t*)out1);
  return (int)cudaGetLastError();
}

extern "C" int mc_csr_decode(const void* idx, const void* found,
                             const void* offsets, int64_t nf,
                             const void* ltgt, const void* lwin,
                             int64_t nloc, int64_t n, int c, int rl, int f,
                             int pack_bits, void* out0, void* out1,
                             void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (nf < 0 || nloc < 0 || c < 1 || rl < c || f < 1 || pack_bits < 0 ||
      pack_bits > 30 || (pack_bits == 0 && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = pack_bits ? csr_decode_kernel<true> : csr_decode_kernel<false>;
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const bool*)found, (const int64_t*)offsets, nf,
      (const int32_t*)ltgt, (const int32_t*)lwin, nloc, n, c, rl, f,
      pack_bits, (int32_t*)out0, (int32_t*)out1);
  return (int)cudaGetLastError();
}

extern "C" int mc_dense_decode(const void* head, int64_t nf, int hw,
                               const void* ovf, int64_t novf, int ow,
                               const void* idx, const void* flat, int wide,
                               int64_t n, int hsl, int c, int rl, int f,
                               int slot_bits, int pack_bits, void* out0,
                               void* out1, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int lanes = slot_bits ? 1 : 2;   // stored lanes a slot
  const int meta = (wide ? 2 : 1) + (ovf ? 2 : 1);
  const int hs = ovf ? hsl : c;
  if (nf <= 0 || c < 1 || rl < c || f < 1 || slot_bits < 0 ||
      slot_bits > 30 || pack_bits < 0 || pack_bits > 30 || hs < 0 ||
      hs > c || hw < meta + lanes * hs ||
      (ovf && (novf <= 0 || ow < lanes * (c - hs))))
    return (int)cudaErrorInvalidValue;
  const int mode = slot_bits ? (pack_bits == slot_bits ? kPass
                                : pack_bits ? kRebase : kUnpack)
                             : (pack_bits ? kPack : kLanes);
  if ((mode == kUnpack || mode == kLanes) && out1 == nullptr)
    return (int)cudaErrorInvalidValue;
  auto kernel = wide ? dense_decode_for<true>(mode)
                     : dense_decode_for<false>(mode);
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)head, nf, hw, (const int32_t*)ovf, novf, ow,
      (const int32_t*)idx, flat, n, hsl, c, rl, f, slot_bits, pack_bits,
      (int32_t*)out0, (int32_t*)out1);
  return (int)cudaGetLastError();
}
