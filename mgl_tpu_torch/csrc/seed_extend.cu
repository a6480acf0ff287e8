// Seed-extend fast-path scores (the PairHMM engine's tier-0 estimator),
// for Hopper.
//
// Replaces the XLA device function mgl_tpu/ops/seed_extend.py:
// _fast_scores_device (:52), a lax.scan over hap offsets, not a Pallas
// kernel.  For a pair (read of rl bases, hap of hl bases) and each offset
// p = 0 .. hl - rl in order: n_mm = the read positions k < rl whose base
// differs from hap base p + k, neither being 'N', and pos0 the first of
// them; the offset adds rm (n_mm = 0), rm * corr[pos0] (n_mm = 1) or
// nothing (n_mm >= 2) to a float accumulator, and the score is acc / hl.
// The scan adds +0.0 for the offsets past hl - rl and for n_mm >= 2,
// which changes no bit, so skipping them keeps the result equal to the
// plain version (ops/seed_extend.py:fast_scores_plain) bit for bit: the
// sum keeps p order, the product and the division are IEEE float ops and
// nvcc runs with --fmad=false, so rm * corr is not fused into the add.
//
// One warp a pair, kWarps pairs a block, and one offset a lane: a step
// takes the 32 offsets p0 .. p0 + 31.  The warp first stages its read and
// hap in shared memory as 32-bit words of four bases (coalesced byte
// loads; past the read's end 'N', which never mismatches, so no compare
// needs a mask there).  A compare takes four positions a word operation:
// the hap word at p + k is a funnel shift of two staged words, and a byte
// of the read word mismatches when it differs from the hap's and neither
// is 'N' - both tests on all four bytes at once, exact for every byte
// value.  Each lane first compares its offset's first kLead words alone,
// stopping at its second mismatch: nearly every offset stops there.  The
// few that do not (the read's true offsets) are balloted, and the warp
// compares the rest of each one's read with a word a lane, the mismatches
// counted by __reduce_add_sync and pos0 taken from the first lane that
// has one - a ~38-word serial scan becomes two warp-wide steps.  The
// lanes whose offset has n_mm <= 1 are balloted and their contributions
// added into the sum in lane order by __shfl_sync, so the sum keeps p
// order; every lane holds the same accumulator and lane 0 writes it.
//
// No length is limited.  A warp stages at most kReadCap read bases and
// kHapCap hap bases at once: a longer read is compared in chunks of
// kReadCap bases, and a longer hap is staged anew, from the step's first
// base, whenever a step's window leaves what is staged - the same loop at
// every length.  At the engine's shapes (151 x 420) everything is staged
// once.
//
// What bounds it on an H100: the card's issue rate, ~100 instructions a
// step of 32 offsets and ~30 a survivor's 32 words, and the staging's
// loads from L2 (~0.6 KB a pair).  Capping the registers at 40, so that a
// region's 6,144 warps are all resident at once, spilled and ran 6%
// slower than 48 registers in two waves.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;        // pairs a block
constexpr int kReadCap = 1024;   // read bases a warp holds at once
constexpr int kHapCap = 4096;    // hap bases a warp holds at once
constexpr int kLead = 2;         // words a lane compares alone at an offset
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kAmbig4 = 0x4e4e4e4eu;  // 'N' in each byte
constexpr uint32_t kLow7 = 0x7f7f7f7fu;
constexpr uint32_t kHigh = 0x80808080u;

// 0x80 in each byte of x that is not zero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & kLow7) + kLow7) | x) & kHigh;
}

// 0x80 in each byte where read and hap bases differ and neither is 'N'
__device__ __forceinline__ uint32_t mismatch_bytes(uint32_t r, uint32_t h) {
  return nonzero_bytes(r ^ h) & nonzero_bytes(r ^ kAmbig4) & nonzero_bytes(h ^ kAmbig4);
}

// the hap word at staged base q + 4 j: a funnel shift of two staged words
__device__ __forceinline__ uint32_t hap_word(const uint32_t* hs, int q, int j) {
  const uint32_t* w = hs + (q >> 2) + j;
  return __funnelshift_r(w[0], w[1], 8 * (q & 3));
}

// The warp copies bases [from, from + 4 * n_words) of a row of len bases
// into n_words words of dst, four bases a word in order, ``fill`` past len.
__device__ __forceinline__ void stage(uint32_t* dst, const uint8_t* src, int from, int n_words,
                                      int len, uint32_t fill, int lane) {
#pragma unroll 4
  for (int w = lane; w < n_words; w += 32) {
    const int q = from + 4 * w;
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      v |= static_cast<uint32_t>(q + b < len ? src[q + b] : fill) << (8 * b);
    dst[w] = v;
  }
}

// words a warp stages: (read, hap); the hap's whole row when it fits
__host__ __device__ inline int read_words(int r_stride) {
  return ((r_stride < kReadCap ? r_stride : kReadCap) + 3) / 4;
}
__host__ __device__ inline int hap_words(int h_stride) {
  const int whole = (h_stride + 3) / 4 + 2;
  return whole < kHapCap / 4 ? whole : kHapCap / 4;
}

__global__ void __launch_bounds__(kWarps * 32)
    seed_extend_kernel(const uint8_t* __restrict__ rbases, const int* __restrict__ rslen,
                       const float* __restrict__ corr, const float* __restrict__ rm,
                       const uint8_t* __restrict__ haps, const int* __restrict__ haplen,
                       const int64_t* __restrict__ ridx, const int64_t* __restrict__ hidx,
                       int n_pairs, int r_stride, int h_stride, float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pair = blockIdx.x * kWarps + warp;
  if (pair >= n_pairs) return;  // the whole warp
  const int rw = read_words(r_stride);
  const int hw = hap_words(h_stride);
  uint32_t* rs = smem + warp * (rw + hw);
  uint32_t* hs = rs + rw;
  // the pair's rows, as offsets from the arguments (fewer registers than
  // three row pointers)
  const int64_t ri = ridx[pair];
  const int64_t hi = hidx[pair];
  const int rl = rslen[ri];
  const int hl = haplen[hi];
  const float match = rm[ri];
  const int64_t r_row = ri * r_stride;
  const int64_t h_row = hi * h_stride;
  const int last = hl - rl;  // the last offset
  const int chunk = 4 * rw;  // read bases a chunk
  int r_from = -1;  // first read base staged
  int h_from = -1;  // first hap base staged (a multiple of 4)
  float acc = 0.0f;
  for (int p0 = 0; p0 <= last; p0 += 32) {
    const int p = p0 + lane;
    const int p_last = min(p0 + 31, last);
    int n_mm = p <= last ? 0 : 2;  // a lane past the last offset takes no part
    int pos0 = 0;
    for (int k0 = 0; k0 < rl; k0 += chunk) {
      if (!__any_sync(kFull, n_mm < 2)) break;
      const int n_words = (min(k0 + chunk, rl) - k0 + 3) >> 2;
      if (r_from != k0) {
        __syncwarp();
        stage(rs, rbases + r_row, k0, rw, rl, 'N', lane);
        r_from = k0;
      }
      // the hap words the step's lanes read: from base p0 + k0 to the word
      // after the last lane's last one
      if (h_from < 0 || p0 + k0 < h_from || ((p_last + k0 - h_from) >> 2) + n_words >= hw) {
        __syncwarp();
        h_from = (p0 + k0) & ~3;
        stage(hs, haps + h_row, h_from, hw, hl, 0, lane);
      }
      __syncwarp();
      // each lane its offset's first kLead words: most offsets reach their
      // second mismatch there
      const int q = p + k0 - h_from;
      const int lead = min(kLead, n_words);
      if (n_mm < 2) {
        for (int j = 0; j < lead; ++j) {
          const uint32_t m = mismatch_bytes(rs[j], hap_word(hs, q, j));
          if (m) {
            if (n_mm == 0) pos0 = k0 + 4 * j + (__ffs(m) >> 3) - 1;
            n_mm += __popc(m);
            if (n_mm >= 2) break;
          }
        }
      }
      // then the warp compares the rest of each surviving offset's read,
      // 32 words at a time (the total count can pass 2, which changes no
      // result; pos0 is the first mismatching byte)
      for (unsigned alive = __ballot_sync(kFull, n_mm < 2 && n_words > lead); alive;
           alive &= alive - 1) {
        const int src = __ffs(alive) - 1;
        const int qs = __shfl_sync(kFull, q, src);
        int n = __shfl_sync(kFull, n_mm, src);
        int at = __shfl_sync(kFull, pos0, src);
        for (int j0 = lead; j0 < n_words && n < 2; j0 += 32) {
          const int j = j0 + lane;
          const uint32_t m = j < n_words ? mismatch_bytes(rs[j], hap_word(hs, qs, j)) : 0u;
          const unsigned hit = __ballot_sync(kFull, m != 0);
          if (hit) {
            const int f = __ffs(hit) - 1;
            const uint32_t mf = __shfl_sync(kFull, m, f);
            if (n == 0) at = k0 + 4 * (j0 + f) + (__ffs(mf) >> 3) - 1;
            n += __reduce_add_sync(kFull, static_cast<unsigned>(__popc(m)));
          }
        }
        if (lane == src) {
          n_mm = n;
          pos0 = at;
        }
      }
    }
    // the step's contributions, added in offset order
    float c = 0.0f;
    if (n_mm == 0) {
      c = match;
    } else if (n_mm == 1) {
      c = match * corr[r_row + pos0];
    }
    for (unsigned adds = __ballot_sync(kFull, n_mm < 2); adds; adds &= adds - 1)
      acc = acc + __shfl_sync(kFull, c, __ffs(adds) - 1);
  }
  if (lane == 0) out[pair] = acc / static_cast<float>(hl);
}

// (blocks, threads a block, dynamic shared bytes a block) of a launch
void layout(int n_pairs, int r_stride, int h_stride, int* geo) {
  geo[0] = (n_pairs + kWarps - 1) / kWarps;
  geo[1] = kWarps * 32;
  geo[2] = kWarps * (read_words(r_stride) + hap_words(h_stride)) * 4;
}

}  // namespace

// rbases (n, r_stride) uint8 and corr (n, r_stride) float by read, rslen
// and rm by read, haps (m, h_stride) uint8 and haplen by hap, ridx/hidx
// (n_pairs,) int64; out (n_pairs,) float.  Launches on ``stream`` and
// returns cudaGetLastError().
extern "C" int mgl_seed_extend(const void* rbases, const void* rslen, const void* corr,
                               const void* rm, const void* haps, const void* haplen,
                               const void* ridx, const void* hidx, int n_pairs, int r_stride,
                               int h_stride, void* out, void* stream) {
  if (n_pairs < 1 || r_stride < 1 || h_stride < 1) return static_cast<int>(cudaErrorInvalidValue);
  int geo[3];
  layout(n_pairs, r_stride, h_stride, geo);
  seed_extend_kernel<<<geo[0], geo[1], geo[2], static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rbases), static_cast<const int*>(rslen),
      static_cast<const float*>(corr), static_cast<const float*>(rm),
      static_cast<const uint8_t*>(haps), static_cast<const int*>(haplen),
      static_cast<const int64_t*>(ridx), static_cast<const int64_t*>(hidx), n_pairs, r_stride,
      h_stride, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The launch's (blocks, threads a block, dynamic shared bytes a block)
// into geo[0..2], for the smoke's report; returns 0.
extern "C" int mgl_seed_extend_layout(int n_pairs, int r_stride, int h_stride, void* geo) {
  layout(n_pairs, r_stride, h_stride, static_cast<int*>(geo));
  return 0;
}
