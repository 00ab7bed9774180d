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


// ---------------------------------------------------------------------
// The 64-bit sketch (k 17..32): the k > 16 branch of
// metacache_tpu/ops/sketch_jax.py::sketch_windows (:103-152), which JAX
// leaves to XLA (its Pallas sketcher B1/B2 is k <= 16 only). Contract:
// (N, W) u8 codes of any width (>= 4 is ambiguous), rows `row_stride`
// bytes apart, or the runner's 2-bit packed rows of W / 4 <= 32 bytes,
// and (N,) i32 valid lengths -> (N, s) u64 features: the s smallest
// distinct murmur3_fmix64 hashes of the canonical k-mers (unsigned
// min of the k-mer and its reverse complement) over the starts
// p + k <= min(valid, W) with no ambiguous code, ascending, sentinel
// (all ones) padded.
//
// Design: B1's, on 64-bit values. One warp per window, walking its
// starts 128 a chunk, starts lo + 4 lane + j (j < 4) in lane `lane`.
// Codes stay in registers: each lane loads its 4 codes (coded rows: one
// word where the row is 4-byte aligned, else 4 bytes; packed rows: byte
// `lane`, one coalesced load of the row) and, in lanes 0-7, the 4 codes
// 128 further on that the chunk's last lanes need, and packs each 4 2
// bits a code, low bits first as the packed rows hold them, with a 4-bit
// mask of the ambiguous ones. A lane's starts need its codes 4 lane ..
// 4 lane + k + 2, at most 35: its own 4 and the next 8 lanes' (one
// shuffle each, which carries both of that lane's groups), a 72-bit
// window. Low bits first, the reverse complement of the k-mer at start j
// is the complement of window bits [2j, 2j + 2k), read off whole; the
// forward k-mer of codes 0 .. k - 2 is the window's code order reversed
// (__brevll, each code's two bits swapped back), then 4 roll steps.
// Selection is B1's: each lane sorts its 4 hashes and drops its own
// duplicates; round r is the warp's minimum of the lanes' heads (two
// 32-bit redux.sync: the high words, then the low words of the lanes
// holding the high minimum), popped in every lane that holds it, which
// drops its copies; lane r % 32 keeps round r's value, and the rounds
// stop at the first sentinel minimum. A window of one chunk (W <= 128 +
// k - 1, every window of the summary path and of the build) stores its
// rounds 32 at a time, coalesced. A wider window keeps a running sketch
// of the s smallest distinct values so far where the rounds leave them,
// value 32 q + lane in slot q of lane `lane` (ascending in each lane):
// a chunk's round takes the minimum of both heads, so duplicates
// within and across chunks drop out, and its rounds make the next
// running sketch. Rows that can hold such a window (coded, wider than
// 128 + k - 1) take a kernel instance of their own: the running sketch
// needs 64 registers a thread, the one-chunk instances 30 (ptxas, H100
// build). No shared memory.
//
// Bound on the card: integer ALU (64-bit arithmetic is two 32-bit
// instructions a step, the hash's two 64-bit products more) and the s
// rounds of two reductions; a window reads W + 4 bytes (W / 4 + 4
// packed) and writes 8 s.
constexpr uint64_t kSent64 = ~0ull;
constexpr int kChunk64 = kLanes;          // k-mer starts a chunk

__device__ __forceinline__ uint64_t murmur3_fmix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDull;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ull;
  x ^= x >> 33;
  return x;
}

// The warp's minimum of one u64 value a lane (unsigned order).
__device__ __forceinline__ uint64_t warp_min64(uint64_t x) {
  const uint32_t h = (uint32_t)(x >> 32);
  const uint32_t hi = __reduce_min_sync(kFull, h);
  const uint32_t lo = __reduce_min_sync(kFull, h == hi ? (uint32_t)x : kFull);
  return ((uint64_t)hi << 32) | lo;
}

// Codes p .. p + 3 of a coded row: 2 bits a code, low bits first, in
// bits 0-7 and the mask of the ambiguous ones in bits 8-11. Codes at or
// past `span` read as 0 (they feed no start below span - k + 1).
__device__ __forceinline__ uint32_t code_group(const uint8_t* __restrict__ row,
                                               int p, int span, bool al4) {
  uint32_t word = 0;
  if (al4 && p + 4 <= span) {
    word = *reinterpret_cast<const uint32_t*>(row + p);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      word |= (p + j < span ? (uint32_t)row[p + j] : 0u) << (8 * j);
  }
  uint32_t g = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t c = (word >> (8 * j)) & 0xFFu;
    g |= c < 4 ? c << (2 * j) : 0x100u << j;
  }
  return g;
}

// The hashed canonical k-mers at starts lo + 4 lane + j (j < 4) of the
// row: the sentinel at chunk starts >= nv and for k-mers with an
// ambiguous code (PACKED rows have none).
template <bool PACKED>
__device__ __forceinline__ void chunk_hashes64(const uint8_t* __restrict__ row,
                                               int width, int lo, int span,
                                               int nv, int k, int lane,
                                               uint64_t (&v)[4]) {
  // this lane's group of 4 codes in bits 0-11, lanes 0-7 the group 128
  // codes further on in bits 16-27
  uint32_t x;
  if constexpr (PACKED) {
    x = lane < width ? row[lane] : 0u;   // no ambiguous code; one chunk
  } else {
    const bool al4 = (reinterpret_cast<uintptr_t>(row) & 3) == 0;
    const int p = lo + 4 * lane;
    x = code_group(row, p, span, al4);
    if (lane < 8 && p + kChunk64 < span)
      x |= code_group(row, p + kChunk64, span, al4) << 16;
  }
  // codes 4 lane .. 4 lane + 35 of the chunk, low bits first: codes 0-31
  // in cw, 32-35 in ch; their ambiguity bits in am
  uint64_t cw = x & 0xFFu;
  uint32_t ch = 0;
  uint64_t am = PACKED ? 0 : (x >> 8) & 0xFu;
#pragma unroll
  for (int d = 1; d <= 8; ++d) {
    const uint32_t y = __shfl_sync(kFull, x, (lane + d) & 31);
    const uint32_t g = lane + d < 32 ? y & 0xFFFu : y >> 16;
    if (d < 8)
      cw |= (uint64_t)(g & 0xFFu) << (8 * d);
    else
      ch = g & 0xFFu;
    if (!PACKED) am |= (uint64_t)((g >> 8) & 0xFu) << (4 * d);
  }
  const uint64_t kmask = k == 32 ? kSent64 : (1ull << (2 * k)) - 1ull;
  const uint64_t amask = (1ull << k) - 1ull;
  // the forward k-mer of codes 0 .. k - 2 (first code highest), then the
  // 4 codes k - 1 .. k + 2 that the roll steps add
  uint64_t fw = __brevll(cw);
  fw = ((fw >> 1) & 0x5555555555555555ull) |
       ((fw & 0x5555555555555555ull) << 1);
  fw >>= 66 - 2 * k;
  const int sn = 2 * k - 2;                       // 32 .. 62
  const uint32_t next = (uint32_t)((cw >> sn) | ((uint64_t)ch << (64 - sn)));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    fw = ((fw << 2) | ((next >> (2 * j)) & 3u)) & kmask;
    const uint64_t lw = j ? (cw >> (2 * j)) | ((uint64_t)ch << (64 - 2 * j))
                          : cw;
    const uint64_t rc = ~lw & kmask;
    const bool ok = 4 * lane + j < nv && (PACKED || ((am >> j) & amask) == 0);
    v[j] = ok ? murmur3_fmix64(fw < rc ? fw : rc) : kSent64;
  }
}

__device__ __forceinline__ void order64(uint64_t& a, uint64_t& b) {
  const uint64_t lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

__device__ __forceinline__ void pop64(uint64_t (&v)[4]) {
  v[0] = v[1];
  v[1] = v[2];
  v[2] = v[3];
  v[3] = kSent64;
}

// The s smallest distinct of the warp's 4 values a lane (and, RUN, of
// the running sketch `run`, value 32 q + lane in run[q]), as
// extract_sketch takes them: RUN = false stores them ascending and
// sentinel padded into dst[0, s); RUN leaves them in `run` instead.
template <bool RUN>
__device__ __forceinline__ void select64(uint64_t (&v)[4], uint64_t (&run)[4],
                                         int lane, int s,
                                         uint64_t* __restrict__ dst) {
  order64(v[0], v[1]); order64(v[2], v[3]); order64(v[0], v[2]);
  order64(v[1], v[3]); order64(v[1], v[2]);
  if (v[3] == v[2]) v[3] = kSent64;
  if (v[2] == v[1]) v[2] = kSent64;
  if (v[1] == v[0]) v[1] = kSent64;
  order64(v[1], v[2]); order64(v[2], v[3]); order64(v[1], v[2]);
  uint64_t kept = kSent64;
  uint64_t nxt[4] = {kSent64, kSent64, kSent64, kSent64};
  int r = 0;
  for (; r < s; ++r) {
    const uint64_t head = RUN && run[0] < v[0] ? run[0] : v[0];
    const uint64_t m = warp_min64(head);
    if (m == kSent64) break;                  // uniform per warp
    if (v[0] == m) pop64(v);
    if (RUN && run[0] == m) pop64(run);
    kept = (r & 31) == lane ? m : kept;
    if ((r & 31) == 31) {
      if (RUN) {
        // selects: stores under a branch left nxt in local memory
#pragma unroll
        for (int q = 0; q < 4; ++q) nxt[q] = q == r >> 5 ? kept : nxt[q];
      } else {
        dst[r - 31 + lane] = kept;
      }
      kept = kSent64;
    }
  }
  if (RUN) {
#pragma unroll
    for (int q = 0; q < 4; ++q) run[q] = q == r >> 5 ? kept : nxt[q];
  } else {
    for (int c = (r & ~31) + lane; c < s; c += 32) {
      dst[c] = kept;
      kept = kSent64;
    }
  }
}

// MULTI: rows may hold windows of several chunks (coded rows wider than
// 128 + k - 1); the one-chunk instances leave out the running sketch's
// registers.
template <bool PACKED, bool MULTI>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sketch64_kernel(const uint8_t* __restrict__ codes,
                const int32_t* __restrict__ valid,
                uint64_t* __restrict__ out, int64_t n, int width,
                int64_t row_stride, int k, int s) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (w >= n) return;  // uniform per warp

  const uint8_t* row = codes + w * row_stride;
  uint64_t* dst = out + w * s;
  const int wc = PACKED ? 4 * width : width;    // codes a row
  const int vl = valid[w];
  const int span = vl < 0 ? 0 : (vl < wc ? vl : wc);
  const int nstarts = span - (k - 1);           // starts [0, nstarts)
  uint64_t v[4];
  uint64_t run[4] = {kSent64, kSent64, kSent64, kSent64};
  if (!MULTI || nstarts <= kChunk64) {          // uniform per warp
    chunk_hashes64<PACKED>(row, width, 0, span, nstarts, k, lane, v);
    select64<false>(v, run, lane, s, dst);
    return;
  }
  if constexpr (MULTI) {
    for (int lo = 0; lo < nstarts; lo += kChunk64) {
      chunk_hashes64<PACKED>(row, width, lo, span, nstarts - lo, k, lane, v);
      select64<true>(v, run, lane, s, dst);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (32 * q + lane < s) dst[32 * q + lane] = run[q];
  }
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

// The 64-bit sketch, 16 < k <= 32: rows of `w` codes `row_stride` bytes
// apart, or (packed) of w <= 32 bytes of 2-bit codes
extern "C" int mc_sketch_windows64(const void* codes, const void* valid,
                                   void* out, int64_t n, int w,
                                   int64_t row_stride, int k, int s,
                                   int packed, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k <= 16 || k > 32 || s < 1 || s > kMaxSketch || w < 1 ||
      row_stride < w || (packed && w > kLanes / 4))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  auto kernel = packed                 ? sketch64_kernel<true, false>
                : w - (k - 1) > kChunk64 ? sketch64_kernel<false, true>
                                         : sketch64_kernel<false, false>;
  kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const int32_t*)valid, (uint64_t*)out, n, w,
      row_stride, k, s);
  return (int)cudaGetLastError();
}

// The 64-bit sketch kernel on packed (1) or coded (0) rows, of one chunk
// (multi = 0) or several: info[0] its registers a thread, info[1] local
// (spill) bytes a thread, info[2] static shared bytes a block
extern "C" int mc_sketch64_info(int packed, int multi, int* info) {
  if (packed && multi) return (int)cudaErrorInvalidValue;
  auto kernel = packed  ? sketch64_kernel<true, false>
                : multi ? sketch64_kernel<false, true>
                        : sketch64_kernel<false, false>;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  info[0] = fa.numRegs;
  info[1] = (int)fa.localSizeBytes;
  info[2] = (int)fa.sharedSizeBytes;
  return (int)cudaSuccess;
}

extern "C" const char* mc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
