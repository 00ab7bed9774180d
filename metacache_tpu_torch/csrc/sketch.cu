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
// Design (the reference's warp_kmerize + warp_sort_128 + unique_sketch,
// and for B2 its warp_make_sketch chunk loop): one warp per window,
// element i = 4 * lane + j (j < 4) held in registers. A chunk of 128
// codes is staged in shared memory; each lane builds its four k-mers
// from there, canonicalizes and hashes them in native u32 arithmetic,
// then the warp runs a 128-element bitonic sort (distances >= 4 by
// __shfl_xor_sync, distances 1 and 2 inside the thread), marks
// duplicates against the left neighbour, and compacts the first s
// distinct values with a warp prefix sum of per-lane counts.
//
// B2 walks the window in 128-char chunks at stride 128 - (k - 1), so the
// chunks' k-mer starts partition the window's. It keeps a running sketch
// of the s smallest distinct values so far in shared memory, stored in
// descending order behind the chunk's ascending 128 values: the 256
// values form a bitonic sequence, so one merge phase (8 steps, 8 values
// a lane) sorts them, and the compaction drops the duplicates within the
// chunk and across chunks alike. Codes load a byte at a time, so rows
// of any width and alignment (255, 511) are read in place. A chunk whose
// first k-mer start is at or past valid - (k - 1) holds only sentinels,
// and so do all later ones: the loop stops there, and a 100 bp read in a
// 256-wide row costs one chunk.
//
// Bound on the card: integer ALU and shuffles. B1 reads 132 bytes and
// writes 4 s bytes a window; B2 reads W + 4 bytes. The sorting networks
// and the k-loop over shared memory are the cost, and nothing leaves
// registers or shared memory between them.
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

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sketch_long_kernel(const uint8_t* __restrict__ codes,
                   const int32_t* __restrict__ valid,
                   uint32_t* __restrict__ out, int64_t n, int width,
                   int64_t row_stride, int k, int s) {
  __shared__ uint8_t sc[kWarpsPerBlock][kLanes + 16];
  // [0, 128): the chunk's sorted values; [128, 256): the running sketch,
  // descending (its t-th smallest value at 255 - t)
  __shared__ uint32_t sm[kWarpsPerBlock][2 * kLanes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (w >= n) return;  // uniform per warp

  const uint8_t* row = codes + w * row_stride;
  uint32_t* run = sm[warp];
  for (int c = lane; c < kLanes; c += 32) run[kLanes + c] = kSent;
  if (lane < 16) sc[warp][kLanes + lane] = 4;
  const int vl = valid[w];
  const int stride = kLanes - (k - 1);

  // the last chunk starts before width - (k - 1); later starts are only
  // reached when valid exceeds the width, and hold no k-mer either
  for (int lo = 0; lo < width - (k - 1) || lo == 0; lo += stride) {
    int cv = vl - lo;
    cv = cv < 0 ? 0 : (cv > kLanes ? kLanes : cv);
    const int nvalid = cv - (k - 1);
    if (nvalid <= 0) break;  // this chunk and all later ones: sentinels
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = lo + lane * 4 + j;
      sc[warp][lane * 4 + j] = p < width ? row[p] : 4;
    }
    __syncwarp();
    uint32_t v[4];
    hash_kmers(sc[warp], lane, nvalid, k, v);
    bitonic<4, 2>(v, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) run[lane * 4 + j] = v[j];
    __syncwarp();
    uint32_t m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = run[lane * 8 + j];
    __syncwarp();
    bitonic<8, 2 * kLanes>(m, lane);
    for (int c = lane; c < kLanes; c += 32) run[kLanes + c] = kSent;
    __syncwarp();
    compact_unique<8>(m, lane, s, run + 2 * kLanes - 1, -1);
    __syncwarp();
  }
  __syncwarp();  // the loop may have stopped before its first chunk
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
