// Banded affine-gap Smith-Waterman with on-device ScoreMax, for Hopper.
//
// Replaces the TPU kernel mgl_tpu/kernels/sw_pallas.py:_sw_banded_kernel
// (wrapper sw_pallas_banded, :930).  Same recurrence, tie rules and
// outputs; the kernel is the wavefront of sw_wavefront.cuh (one block a
// pair of W warps, a lane a row, bands pipelined across the warps through
// one carry row), launched with the per-pair banded traceback layout
// (kBandedWords) or score-only (kBandedScore):
//
// * ez (6, B): ScoreMax rows mqe, mqe_t, max, max_t, max_q, seg_length.
// * Traceback words (B, G, 32) with G = NB * WPB: cell (i, j) -> word
//   (i-1)/32 * WPB + (j-1+s)/8, lane s = (i-1)%32, nibble (j-1+s)%8 - what
//   the host decoder (csrc/host/cigar_decode.cpp) reads.  Lanes also store
//   nibbles for the steps before the wavefront reaches their row and past
//   ql; no decode reads them, and the plain version's differ there.
//
// What bounds it on an H100: the step's dependent chain and, once 8-16
// warps share an SM, its instruction count (sw_wavefront.cuh).

#include "sw_wavefront.cuh"

// warps_per_pair is W, 1 to 32; carry holds (2, carry_cols) ints a pair,
// used when the launcher keeps the carry row in global memory
extern "C" int mgl_sw_banded(const void* tgt, const void* qry, const void* tlen,
                             const void* qlen, int n_pairs, int t_stride, int q_stride,
                             int match, int mismatch, int gap_open, int gap_ext,
                             int indel_init, int with_traceback, int words_per_band,
                             int n_words, int carry_cols, int warps_per_pair,
                             void* carry, void* ez, void* words, void* stream) {
  if (warps_per_pair < 1 || warps_per_pair > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto run =
      with_traceback ? launch_wavefront<kBandedWords> : launch_wavefront<kBandedScore>;
  return static_cast<int>(run(tgt, qry, tlen, qlen, n_pairs, t_stride, q_stride, match,
                              mismatch, gap_open, gap_ext, indel_init, words_per_band,
                              n_words, carry_cols, warps_per_pair, carry, ez,
                              with_traceback ? words : nullptr,
                              static_cast<cudaStream_t>(stream)));
}

// 1 if mgl_sw_banded would keep this launch's carry row in shared memory,
// 0 if in global memory, or minus a CUDA error code
extern "C" int mgl_sw_banded_carry_in_shared(int n_pairs, int carry_cols,
                                             int warps_per_pair, int with_traceback) {
  if (warps_per_pair < 1 || warps_per_pair > kMaxWarps)
    return -static_cast<int>(cudaErrorInvalidValue);
  bool shared = false;
  const cudaError_t e =
      with_traceback
          ? wavefront_carry_in_shared<kBandedWords>(n_pairs, carry_cols, warps_per_pair, &shared)
          : wavefront_carry_in_shared<kBandedScore>(n_pairs, carry_cols, warps_per_pair, &shared);
  return e != cudaSuccess ? -static_cast<int>(e) : static_cast<int>(shared);
}

extern "C" const char* mgl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
