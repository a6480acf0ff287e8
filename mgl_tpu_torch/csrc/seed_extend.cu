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
// One warp a pair, kWarps pairs a block.  At each offset the lanes take
// read positions in chunks of 32 and __ballot_sync the mismatch
// predicate: n_mm is the sum of __popc over the chunks, pos0 __ffs - 1 of
// the first non-zero ballot plus its chunk's base, and the offset stops
// once n_mm >= 2 (a warp-uniform test: every lane holds the same counts).
// Every lane keeps the same accumulator; lane 0 writes it.  Read and hap
// are read from global memory through L1, so no length is limited.
//
// What bounds it on an H100: the dependent chain of an offset (two loads,
// the compare, the ballot) a warp, with most offsets stopping in their
// first chunk - not bytes (a region ships ~0.4 MB) nor the card's integer
// rate.  Keeping the read's first chunk in registers, or several offsets
// a warp in flight, is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // pairs a block
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kAmbig = 'N';

__global__ void __launch_bounds__(kWarps * 32)
    seed_extend_kernel(const uint8_t* __restrict__ rbases, const int* __restrict__ rslen,
                       const float* __restrict__ corr, const float* __restrict__ rm,
                       const uint8_t* __restrict__ haps, const int* __restrict__ haplen,
                       const int64_t* __restrict__ ridx, const int64_t* __restrict__ hidx,
                       int n_pairs, int r_stride, int h_stride, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (pair >= n_pairs) return;  // the whole warp
  const int64_t ri = ridx[pair];
  const int64_t hi = hidx[pair];
  const int rl = rslen[ri];
  const int hl = haplen[hi];
  const uint8_t* rd = rbases + ri * r_stride;
  const uint8_t* hp = haps + hi * h_stride;
  const float* cr = corr + ri * r_stride;
  const float match = rm[ri];
  float acc = 0.0f;
  for (int p = 0; p <= hl - rl; ++p) {
    int n_mm = 0;
    int pos0 = 0;
    for (int c = 0; c < rl && n_mm < 2; c += 32) {
      const int k = c + lane;
      bool mm = false;
      if (k < rl) {
        const uint8_t r = rd[k];
        const uint8_t h = hp[p + k];
        mm = r != h && r != kAmbig && h != kAmbig;
      }
      const unsigned ballot = __ballot_sync(kFull, mm);
      if (n_mm == 0 && ballot) pos0 = c + __ffs(ballot) - 1;
      n_mm += __popc(ballot);
    }
    if (n_mm == 0) {
      acc = acc + match;
    } else if (n_mm == 1) {
      acc = acc + match * cr[pos0];
    }
  }
  if (lane == 0) out[pair] = acc / static_cast<float>(hl);
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
  if (n_pairs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_pairs + kWarps - 1) / kWarps;
  seed_extend_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rbases), static_cast<const int*>(rslen),
      static_cast<const float*>(corr), static_cast<const float*>(rm),
      static_cast<const uint8_t*>(haps), static_cast<const int*>(haplen),
      static_cast<const int64_t*>(ridx), static_cast<const int64_t*>(hidx), n_pairs, r_stride,
      h_stride, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
