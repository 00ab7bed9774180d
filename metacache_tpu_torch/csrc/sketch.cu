// B1 and B2: fused window sketchers for Hopper (sm_90a).
//
// B1 replaces metacache_tpu/ops/sketch_pallas.py::sketch_windows_pallas
// (kernel _sketch_kernel: _kmerize, _bitonic_sort_lanes,
// _compact_unique). Same contract: (N, 128) u8 window codes (>= 4 is
// ambiguous / padding) and (N,) i32 valid lengths -> (N, s) u32 sketch,
// ascending, deduplicated, sentinel (0xFFFFFFFF) padded, at most
// max(valid - k + 1, 0) features.
//
// B2 replaces sketch_pallas.py::sketch_windows_pallas_long, the sketcher
// of windows wider than 128 characters (the 255 and 511 presets): the
// same contract on (N, W > 128) codes, rows `row_stride` bytes apart.
//
// B1's design (the reference's warp_kmerize + warp_sort_128 +
// unique_sketch): one warp per window, element i = 4 * lane + j (j < 4)
// held in registers. A chunk of 128 codes is staged in shared memory;
// each lane builds its four k-mers from there, canonicalizes and hashes
// them in native u32 arithmetic, then the warp runs a 128-element
// bitonic sort (distances >= 4 by __shfl_xor_sync, distances 1 and 2
// inside the thread), marks duplicates against the left neighbour, and
// compacts the first s distinct values with a warp prefix sum of
// per-lane counts.
//
// B2 sketches the s smallest distinct canonical hashes over all k-mer
// starts p with p + k <= span = min(valid, W) and no code >= 4, which is
// what the TPU kernel's 128-char chunks at stride 128 - (k - 1) compute
// (their starts partition the window's). One warp per window takes the
// whole span in one pass of 32 * VPL positions, VPL = 4, 8 or 16 values
// a lane for spans up to 128, 256 or 512 (the choice is per window, so a
// 100 bp read in a 256-wide row costs one 128-position pass): the warp
// stages the codes in shared memory with coalesced byte loads (rows of
// any width and alignment are read in place); each lane packs its VPL
// codes 2 bits a code with a mask of its ambiguous ones, takes the next
// 16 codes' from the following lanes by shuffles, and rolls its k-mer
// and its reverse complement one code a step over VPL + k - 1 codes in
// registers; then one bitonic sort of 32 * VPL values and one
// compaction. Spans above 512 walk 512-char chunks at stride
// 512 - (k - 1) and keep a running sketch of the s smallest distinct
// values so far in shared memory, stored in descending order behind the
// chunk's compacted ascending s: the 256 values form a bitonic sequence,
// so one merge phase (8 steps, 8 values a lane) sorts them, and the
// compaction drops the duplicates across chunks. The loop stops at the
// first chunk with no k-mer start before span - (k - 1).
//
// Bound on the card: integer ALU and shuffles. B1 reads 132 bytes and
// writes 4 s bytes a window; B2 reads W + 4 bytes. The sorting networks
// (and for B1 the k-loop over shared memory) are the cost, and nothing
// leaves registers or shared memory between them.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxSketch = 128;
constexpr uint32_t kSent = 0xFFFFFFFFu;
constexpr uint32_t kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t thomas_mueller(uint32_t h) {
  h = ((h >> 16) ^ h) * 0x45D9F3Bu;
  h = ((h >> 16) ^ h) * 0x45D9F3Bu;
  return (h >> 16) ^ h;
}

__device__ __forceinline__ uint32_t revcomp(uint32_t s, int k) {
  s = ((s >> 2) & 0x33333333u) | ((s & 0x33333333u) << 2);
  s = ((s >> 4) & 0x0F0F0F0Fu) | ((s & 0x0F0F0F0Fu) << 4);
  s = ((s >> 8) & 0x00FF00FFu) | ((s & 0x00FF00FFu) << 8);
  s = ((s >> 16) & 0x0000FFFFu) | ((s & 0x0000FFFFu) << 16);
  // (0xFFFFFFFF - s) >> (32 - 2k); k <= 16 so the shift is < 32
  return (~s) >> (32 - (k << 1));
}

// The hashed canonical k-mers at chunk positions 4 * lane + j from the
// staged codes `sc` (128 + 16 entries); positions at or past `nvalid`
// and k-mers with an ambiguous code give the sentinel.
__device__ __forceinline__ void hash_kmers(const uint8_t* sc, int lane,
                                           int nvalid, int k,
                                           uint32_t (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = lane * 4 + j;
    uint32_t h = kSent;
    if (p < nvalid) {
      uint32_t kmer = 0;
      bool amb = false;
      for (int q = 0; q < k; ++q) {
        const uint32_t c = sc[p + q];
        amb |= c >= 4;
        kmer = (kmer << 2) | (c < 4 ? c : 0);
      }
      if (!amb) {
        const uint32_t rc = revcomp(kmer, k);
        h = thomas_mueller(kmer <= rc ? kmer : rc);
      }
    }
    v[j] = h;
  }
}

// Ascending bitonic network over the warp's 32 * VPL values (unsigned
// order), element i = VPL * lane + j, from merge size FIRST up: FIRST = 2
// sorts, FIRST = 32 * VPL only merges an ascending-then-descending input.
template <int VPL, int FIRST>
__device__ __forceinline__ void bitonic(uint32_t (&v)[VPL], int lane) {
  constexpr int kN = 32 * VPL;
#pragma unroll
  for (int size = FIRST; size <= kN; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= VPL) {
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const int i = lane * VPL + j;
          const uint32_t pv = __shfl_xor_sync(kFull, v[j], stride / VPL);
          const bool keep_min = ((i & size) == 0) == ((i & stride) == 0);
          const uint32_t lo = v[j] < pv ? v[j] : pv;
          const uint32_t hi = v[j] < pv ? pv : v[j];
          v[j] = keep_min ? lo : hi;
        }
      } else {
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          if ((j & stride) == 0) {
            const int jj = j | stride;
            const bool asc = (((lane * VPL + j) & size) == 0);
            const uint32_t a = v[j], b = v[jj];
            const uint32_t lo = a < b ? a : b, hi = a < b ? b : a;
            v[j] = asc ? lo : hi;
            v[jj] = asc ? hi : lo;
          }
        }
      }
    }
  }
}

// Drop duplicates of the left neighbour in the warp's sorted values and
// store the first s distinct ones at dst[0], dst[step], dst[2 step], ...
template <int VPL>
__device__ __forceinline__ void compact_unique(const uint32_t (&v)[VPL],
                                               int lane, int s,
                                               uint32_t* dst, int step) {
  const uint32_t prev = __shfl_up_sync(kFull, v[VPL - 1], 1);
  bool keep[VPL];
  int nd = 0;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const bool dup =
        (lane * VPL + j > 0) && (v[j] == (j ? v[j - 1] : prev));
    keep[j] = !dup;
    nd += keep[j];
  }
  int incl = nd;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  int dest = incl - nd;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    if (keep[j]) {
      if (dest < s) dst[dest * step] = v[j];
      ++dest;
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sketch_kernel(const uint8_t* __restrict__ codes,
              const int32_t* __restrict__ valid,
              uint32_t* __restrict__ out, int64_t n, int k, int s) {
  // 16 extra pad lanes of code 4 keep every k-mer read in bounds
  __shared__ uint8_t sc[kWarpsPerBlock][kLanes + 16];
  __shared__ uint32_t so[kWarpsPerBlock][kMaxSketch];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (w >= n) return;  // uniform per warp

  const uint32_t c4 =
      reinterpret_cast<const uint32_t*>(codes + w * kLanes)[lane];
#pragma unroll
  for (int j = 0; j < 4; ++j) sc[warp][lane * 4 + j] = (c4 >> (8 * j)) & 0xFF;
  if (lane < 16) sc[warp][kLanes + lane] = 4;
  for (int c = lane; c < s; c += 32) so[warp][c] = kSent;
  __syncwarp();

  const int vl = valid[w];
  const int nvalid = vl - (k - 1) > 0 ? vl - (k - 1) : 0;

  uint32_t v[4];
  hash_kmers(sc[warp], lane, nvalid, k, v);
  bitonic<4, 2>(v, lane);
  compact_unique<4>(v, lane, s, so[warp], 1);
  __syncwarp();
  for (int c = lane; c < s; c += 32)
    out[w * s + c] = c >= nvalid ? kSent : so[warp][c];
}

// The hashed canonical k-mers of positions lo + VPL * lane + j
// (j < VPL) of the row, sorted ascending across the warp: the sentinel
// at starts >= nv = min(span - lo, 32 VPL) - (k - 1) and for k-mers with
// an ambiguous code. sc: the warp's 512-byte staging buffer.
template <int VPL>
__device__ __forceinline__ void span_hashes(const uint8_t* __restrict__ row,
                                            uint8_t* sc, int lo, int span,
                                            int k, int lane,
                                            uint32_t (&v)[VPL]) {
  constexpr int kN = 32 * VPL;
#pragma unroll
  for (int q = 0; q < VPL; ++q) {
    const int p = lo + 32 * q + lane;
    sc[32 * q + lane] = p < span ? row[p] : 4;   // codes past span: unused
  }
  __syncwarp();
  uint32_t w[VPL / 4];
  if constexpr (VPL == 16) {
    const uint4 x = reinterpret_cast<const uint4*>(sc)[lane];
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (VPL == 8) {
    const uint2 x = reinterpret_cast<const uint2*>(sc)[lane];
    w[0] = x.x; w[1] = x.y;
  } else {
    w[0] = reinterpret_cast<const uint32_t*>(sc)[lane];
  }
  __syncwarp();  // the buffer is free for the next chunk
  // own codes, 2 bits each, first code highest; mask of ambiguous ones
  uint32_t pc = 0, am = 0;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const uint32_t c = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
    pc = (pc << 2) | (c < 4 ? c : 0);
    am = (am << 1) | (c >= 4);
  }
  // the next 16 codes from the following lanes (lanes past 31 feed only
  // starts >= nv)
  uint64_t win = (uint64_t)pc << (64 - 2 * VPL);
  uint32_t amb = am << (32 - VPL);
#pragma unroll
  for (int d = 1; d <= 16 / VPL; ++d) {
    win |= (uint64_t)__shfl_down_sync(kFull, pc, d) << (64 - 2 * VPL * (d + 1));
    amb |= __shfl_down_sync(kFull, am, d) << (32 - VPL * (d + 1));
  }
  int nv = span - lo < kN ? span - lo : kN;
  nv -= k - 1;
  const uint32_t kmask = k == 16 ? kFull : (1u << (2 * k)) - 1u;
  const int top = 2 * k - 2;
  uint32_t fw = 0, rc = 0;
  for (int t = 0; t < k - 1; ++t) {
    const uint32_t c = (uint32_t)(win >> (62 - 2 * t)) & 3u;
    fw = (fw << 2) | c;
    rc = (rc >> 2) | ((3u - c) << top);
  }
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const uint32_t c = (uint32_t)(win >> (62 - 2 * (j + k - 1))) & 3u;
    fw = ((fw << 2) | c) & kmask;
    rc = (rc >> 2) | ((3u - c) << top);
    const bool amb_j = ((amb << j) >> (32 - k)) != 0;
    v[j] = VPL * lane + j < nv && !amb_j
               ? thomas_mueller(fw <= rc ? fw : rc) : kSent;
  }
  bitonic<VPL, 2>(v, lane);
}

// One pass over a span of at most 32 VPL positions: the first s
// distinct values into run[0, s), which holds sentinels on entry.
template <int VPL>
__device__ __forceinline__ void sketch_span(const uint8_t* __restrict__ row,
                                            uint8_t* sc, uint32_t* run,
                                            int span, int k, int s,
                                            int lane) {
  uint32_t v[VPL];
  span_hashes<VPL>(row, sc, 0, span, k, lane, v);
  compact_unique<VPL>(v, lane, s, run, 1);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sketch_long_kernel(const uint8_t* __restrict__ codes,
                   const int32_t* __restrict__ valid,
                   uint32_t* __restrict__ out, int64_t n, int width,
                   int64_t row_stride, int k, int s) {
  __shared__ __align__(16) uint8_t sc[kWarpsPerBlock][4 * kLanes];
  // one pass: the sketch in [0, s). Chunks: [0, 128) the chunk's first
  // s distinct values, [128, 256) the running sketch, descending (its
  // t-th smallest value at 255 - t)
  __shared__ uint32_t sm[kWarpsPerBlock][2 * kLanes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (w >= n) return;  // uniform per warp

  const uint8_t* row = codes + w * row_stride;
  uint32_t* run = sm[warp];
  const int vl = valid[w];
  const int span = vl < 0 ? 0 : (vl < width ? vl : width);
  for (int c = lane; c < 2 * kLanes; c += 32) run[c] = kSent;
  __syncwarp();
  if (span <= 4 * kLanes) {  // uniform per warp
    if (span <= kLanes)
      sketch_span<4>(row, sc[warp], run, span, k, s, lane);
    else if (span <= 2 * kLanes)
      sketch_span<8>(row, sc[warp], run, span, k, s, lane);
    else
      sketch_span<16>(row, sc[warp], run, span, k, s, lane);
    __syncwarp();
    for (int c = lane; c < s; c += 32) out[w * s + c] = run[c];
    return;
  }
  const int stride = 4 * kLanes - (k - 1);
  for (int lo = 0; lo < span - (k - 1); lo += stride) {
    uint32_t v[16];
    span_hashes<16>(row, sc[warp], lo, span, k, lane, v);
    compact_unique<16>(v, lane, s, run, 1);
    __syncwarp();
    uint32_t m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = run[lane * 8 + j];
    __syncwarp();
    bitonic<8, 2 * kLanes>(m, lane);
    for (int c = lane; c < 2 * kLanes; c += 32) run[c] = kSent;
    __syncwarp();
    compact_unique<8>(m, lane, s, run + 2 * kLanes - 1, -1);
    __syncwarp();
  }
  for (int c = lane; c < s; c += 32) out[w * s + c] = run[2 * kLanes - 1 - c];
}

}  // namespace

extern "C" int mc_sketch_windows(const void* codes, const void* valid,
                                 void* out, int64_t n, int k, int s,
                                 void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > 16 || s < 1 || s > kMaxSketch)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sketch_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                  (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)valid, (uint32_t*)out, n, k, s);
  return (int)cudaGetLastError();
}

extern "C" int mc_sketch_windows_long(const void* codes, const void* valid,
                                      void* out, int64_t n, int w,
                                      int64_t row_stride, int k, int s,
                                      void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > 16 || s < 1 || s > kMaxSketch || w < 1 || row_stride < w)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sketch_long_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)valid, (uint32_t*)out, n, w,
      row_stride, k, s);
  return (int)cudaGetLastError();
}

extern "C" const char* mc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
