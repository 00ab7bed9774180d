// B1 and B2: fused window sketchers for Hopper (sm_90a).
//
// B1 replaces metacache_tpu/ops/sketch_pallas.py::sketch_windows_pallas
// (kernel _sketch_kernel: _kmerize, then _bitonic_sort_lanes +
// _compact_unique, or _extract_sketch under mode "extract"; both give
// the same sketch, and B1 takes the extract form). Same
// contract: (N, 128) u8 window codes (>= 4 is ambiguous / padding) and
// (N,) i32 valid lengths -> (N, s) u32 sketch, ascending, deduplicated,
// sentinel (0xFFFFFFFF) padded: the s smallest distinct canonical hashes
// over the starts p < max(valid - k + 1, 0) with no code >= 4. It also
// reads the runner's 2-bit infeed in place: (N, W / 4) bytes, W <= 128,
// four codes a byte, low bits first, no ambiguous code.
//
// B2 replaces sketch_pallas.py::sketch_windows_pallas_long, the sketcher
// of windows wider than 128 characters (the 255 and 511 presets): the
// same contract on (N, W > 128) codes, rows `row_stride` bytes apart.
//
// B1's design: one warp per window, positions 4 * lane + j (j < 4) held
// in registers. Each lane loads its 4 codes as one word (or, packed,
// its one byte: one coalesced load of the row), packs them 2 bits a
// code with an ambiguity mask, and rolls its k-mers from there as B2
// does (roll_hashes, below). Selection takes s warp minima
// (__reduce_min_sync, sm_80+ redux.sync): each lane first sorts its 4
// values and drops its own duplicates, so that a round is one redux of
// the lanes' first values and a pop in the lanes holding the minimum,
// which clears every copy of it; the rounds stop at the first sentinel
// minimum, and lane r % 32 keeps round r's value, so the stores are
// coalesced.
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
// Bound on the card: integer ALU and shuffles. B1 reads 132 bytes (W / 4
// + 4 packed) and writes 4 s bytes a window; B2 reads W + 4 bytes. The
// selection (B1: s rounds of a few instructions; B2: the sort) and the
// k - 1 + VPL rolling steps are the cost, and nothing leaves registers
// (or shared memory, for B2's sort) between them.
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

// This lane's VPL codes (positions VPL * lane + j) from VPL / 4 words
// of byte codes, low byte first: packed 2 bits a code, first code
// highest, and a mask of the ambiguous ones (code >= 4), first highest.
template <int VPL>
__device__ __forceinline__ void pack_codes(const uint32_t (&w)[VPL / 4],
                                           uint32_t& pc, uint32_t& am) {
  pc = 0;
  am = 0;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const uint32_t c = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
    pc = (pc << 2) | (c < 4 ? c : 0);
    am = (am << 1) | (c >= 4);
  }
}

// The reverse complement of the n codes of x (2 bits each, first code
// highest in the low 2n bits), 0 < n < 16: the codes' bit reversal with
// each code's two bits swapped back, complemented.
__device__ __forceinline__ uint32_t revcomp_codes(uint32_t x, int n) {
  uint32_t r = __brev(x << (32 - 2 * n));
  r = ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
  return r ^ ((1u << (2 * n)) - 1u);
}

// The hashed canonical k-mers at starts VPL * lane + j (j < VPL) of the
// warp's span, from each lane's packed codes (pc, am as pack_codes
// leaves them): the next 16 codes come from the following lanes by
// shuffles (lanes past 31 feed only starts >= nv). The k-mer and its
// reverse complement start from the first k - 1 codes, read off the
// window whole, and roll one code a step over the lane's VPL starts in
// registers. The sentinel at starts >= nv and for k-mers with an
// ambiguous code; AMB = false: no code is ambiguous (am is ignored).
template <int VPL, bool AMB>
__device__ __forceinline__ void roll_hashes(uint32_t pc, uint32_t am,
                                            int nv, int k, int lane,
                                            uint32_t (&v)[VPL]) {
  uint64_t win = (uint64_t)pc << (64 - 2 * VPL);
  uint32_t amb = AMB ? am << (32 - VPL) : 0;
#pragma unroll
  for (int d = 1; d <= 16 / VPL; ++d) {
    win |= (uint64_t)__shfl_down_sync(kFull, pc, d) << (64 - 2 * VPL * (d + 1));
    if (AMB) amb |= __shfl_down_sync(kFull, am, d) << (32 - VPL * (d + 1));
  }
  const uint32_t kmask = k == 16 ? kFull : (1u << (2 * k)) - 1u;
  const int top = 2 * k - 2;
  // codes 0 .. k - 2 of the window, then the VPL codes the steps add
  uint32_t fw = 0, rc = 0;
  if (k > 1) {
    fw = (uint32_t)(win >> (66 - 2 * k));
    rc = revcomp_codes(fw, k - 1) << 2;
  }
  const uint32_t next = (uint32_t)((win << top) >> (64 - 2 * VPL));
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const uint32_t c = (next >> (2 * (VPL - 1 - j))) & 3u;
    fw = ((fw << 2) | c) & kmask;
    rc = (rc >> 2) | ((3u - c) << top);
    const bool amb_j = AMB && ((amb << j) >> (32 - k)) != 0;
    v[j] = VPL * lane + j < nv && !amb_j
               ? thomas_mueller(fw <= rc ? fw : rc) : kSent;
  }
}

__device__ __forceinline__ void order(uint32_t& a, uint32_t& b) {
  const uint32_t lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// The s smallest distinct of the warp's 4 values a lane, ascending and
// sentinel padded, into dst[0, s). Each lane sorts its 4 values and
// drops its own duplicates, so its minimum is v[0]; round r takes the
// warp's minimum of those (redux.sync), and the lanes that hold it pop
// it, which drops its copies across lanes too. Lane r % 32 keeps round
// r's value, stored 32 rounds at a time (coalesced). The rounds stop at
// the first sentinel minimum, uniformly.
__device__ __forceinline__ void extract_sketch(uint32_t (&v)[4], int lane,
                                               int s,
                                               uint32_t* __restrict__ dst) {
  order(v[0], v[1]); order(v[2], v[3]); order(v[0], v[2]); order(v[1], v[3]);
  order(v[1], v[2]);
  if (v[3] == v[2]) v[3] = kSent;
  if (v[2] == v[1]) v[2] = kSent;
  if (v[1] == v[0]) v[1] = kSent;
  order(v[1], v[2]); order(v[2], v[3]); order(v[1], v[2]);
  uint32_t kept = kSent;
  int r = 0;
  for (; r < s; ++r) {
    const uint32_t m = __reduce_min_sync(kFull, v[0]);
    if (m == kSent) break;
    if (v[0] == m) {
      v[0] = v[1];
      v[1] = v[2];
      v[2] = v[3];
      v[3] = kSent;
    }
    kept = (r & 31) == lane ? m : kept;
    if ((r & 31) == 31) {
      dst[r - 31 + lane] = kept;
      kept = kSent;
    }
  }
  for (int c = (r & ~31) + lane; c < s; c += 32) {
    dst[c] = kept;
    kept = kSent;
  }
}

// B1: one warp a 128-wide window, 4 positions a lane. PACKED: rows of
// `width` <= 32 bytes, four 2-bit codes a byte, low bits first (no
// ambiguous code), lane l reading byte l; the span ends at 4 width
// characters, as if the row were unpacked and padded with code 4. Else
// rows of 128 byte codes, loaded as one word a lane.
template <bool PACKED>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sketch_kernel(const uint8_t* __restrict__ codes,
              const int32_t* __restrict__ valid,
              uint32_t* __restrict__ out, int64_t n, int width, int k,
              int s) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (w >= n) return;  // uniform per warp

  uint32_t pc = 0, am = 0;
  int span = kLanes;
  if constexpr (PACKED) {
    // bytes past the row feed only starts >= nv
    const uint32_t b = lane < width ? codes[w * width + lane] : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) pc = (pc << 2) | ((b >> (2 * j)) & 3u);
    span = 4 * width;
  } else {
    const uint32_t c4[1] = {
        reinterpret_cast<const uint32_t*>(codes + w * kLanes)[lane]};
    pack_codes<4>(c4, pc, am);
  }
  const int vl = valid[w];
  const int nv = (vl < span ? vl : span) - (k - 1);
  uint32_t v[4];
  roll_hashes<4, !PACKED>(pc, am, nv, k, lane, v);
  extract_sketch(v, lane, s, out + w * s);
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
  uint32_t pc, am;
  pack_codes<VPL>(w, pc, am);
  const int nv = (span - lo < kN ? span - lo : kN) - (k - 1);
  roll_hashes<VPL, true>(pc, am, nv, k, lane, v);
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

// packed: rows of `width` bytes (1..32); else width must be 128
extern "C" int mc_sketch_windows(const void* codes, const void* valid,
                                 void* out, int64_t n, int width, int k,
                                 int s, int packed, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > 16 || s < 1 || s > kMaxSketch ||
      (packed ? width < 1 || width > kLanes / 4 : width != kLanes))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  auto kernel = packed ? sketch_kernel<true> : sketch_kernel<false>;
  kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)valid, (uint32_t*)out, n, width,
      k, s);
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
