// Full-height ("plane") affine-gap Smith-Waterman for Hopper: traceback,
// samples and best-score modes.
//
// Replaces the TPU kernels mgl_tpu/kernels/sw_pallas.py:_sw_kernel
// (wrapper sw_pallas_forward, :824; traceback and samples modes) and
// sw_pallas.py:_sw_score_kernel (wrapper sw_pallas_scores, :769; best
// score).  Same recurrence, tie rules and outputs as the plain versions
// mgl_tpu_torch/ops/sw.py (sw_plane_plain, sw_plane_scores_plain).  The
// TPU kernel ran all rows of 128 pairs in lockstep, one anti-diagonal a
// step; here the kernel is the wavefront of sw_wavefront.cuh, shared with
// the banded kernel: one block a pair of W warps, lane s on row 32b + s + 1
// and every lane of a warp on one anti-diagonal, the bands pipelined
// across the warps through one carry row, with no block barrier a
// diagonal and nothing of a pair's length in shared memory but that row.
// What a step stores is the mode's:
//
// * traceback (kPlaneWords): ez (6, B) as the banded kernel's, and the
//   nibble of cell (r, c) in word (r+c-2)/8 of row r, nibble (r+c-2)%8, of
//   the pair's (n_words, T+1) block - what the host decoder
//   (csrc/host/cigar_decode.cpp) reads.  A lane packs the 8 nibbles of a
//   word in a register and stores it once; a warp's store covers 32
//   consecutive rows.  Words without a cell of the pair are left as the
//   wrapper zeroed them, and nibbles outside the pair's cells are 0.
// * samples (kPlaneSamples): the scores of diagonal d's last-column cell
//   (d - qlen, qlen) and last-row cell (tlen, d - tlen) at entry d - 2 of
//   the pair's two rows of T+Q-1, stored by the lane that computes each;
//   entries without a real cell are left as the wrapper zeroed them.
// * best score (kPlaneBest): the largest of those cells' scores, a
//   running maximum a lane reduced over the warp and the block.
//
// What bounds it on an H100: the step's dependent chain and, once 8-16
// warps share an SM, its instruction count (sw_wavefront.cuh); for long
// pairs in traceback mode also the plane words, T+1 rows of (T+Q)/8 words
// a pair (2.56 GB at 64 x 8000x2000), of which the kernel writes the ~Q/8
// a row that hold cells and the wrapper's fill the rest.

#include "sw_wavefront.cuh"

// mode 0: traceback, out0 = ez (6, B), out1 = words (B, n_words, T+1);
// mode 1: samples, out0 / out1 = last-column / last-row (B, T+Q-1);
// mode 2: best score, out0 = (B,).  warps_per_pair is W, 1 to 32; carry
// holds (2, carry_cols) ints a pair, used when the launcher keeps the
// carry row in global memory.
extern "C" int mgl_sw_plane(const void* tgt, const void* qry, const void* tlen,
                            const void* qlen, int n_pairs, int t_stride, int q_stride,
                            int match, int mismatch, int gap_open, int gap_ext,
                            int indel_init, int mode, int n_words, int carry_cols,
                            int warps_per_pair, void* carry, void* out0, void* out1,
                            void* stream) {
  if (warps_per_pair < 1 || warps_per_pair > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&launch_wavefront<kPlaneWords>) run;
  switch (mode) {
    case 0: run = launch_wavefront<kPlaneWords>; break;
    case 1: run = launch_wavefront<kPlaneSamples>; break;
    case 2: run = launch_wavefront<kPlaneBest>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(run(tgt, qry, tlen, qlen, n_pairs, t_stride, q_stride, match,
                              mismatch, gap_open, gap_ext, indel_init, 0, n_words,
                              carry_cols, warps_per_pair, carry, out0, out1,
                              static_cast<cudaStream_t>(stream)));
}

// 1 if mgl_sw_plane would keep this launch's carry row in shared memory,
// 0 if in global memory, or minus a CUDA error code
extern "C" int mgl_sw_plane_carry_in_shared(int n_pairs, int carry_cols,
                                            int warps_per_pair, int mode) {
  if (warps_per_pair < 1 || warps_per_pair > kMaxWarps)
    return -static_cast<int>(cudaErrorInvalidValue);
  decltype(&wavefront_carry_in_shared<kPlaneWords>) query;
  switch (mode) {
    case 0: query = wavefront_carry_in_shared<kPlaneWords>; break;
    case 1: query = wavefront_carry_in_shared<kPlaneSamples>; break;
    case 2: query = wavefront_carry_in_shared<kPlaneBest>; break;
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
  bool shared = false;
  const cudaError_t e = query(n_pairs, carry_cols, warps_per_pair, &shared);
  return e != cudaSuccess ? -static_cast<int>(e) : static_cast<int>(shared);
}
