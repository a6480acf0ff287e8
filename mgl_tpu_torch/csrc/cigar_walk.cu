// The CIGAR traceback walk over the banded SW kernel's words, for Hopper.
//
// Replaces the XLA device function mgl_tpu/ops/cigar_device.py:
// _walk_segments (:47), a lax.scan that steps every lane of the TPU's
// traceback one matrix cell an iteration; not a Pallas kernel.  The walk
// is the reference's run-length backtrack (sw.cpp:182-214) as an automaton
// of three modes: NORMAL takes a cell's move (nibble & 3: 0 diagonal,
// 1 INS, 2 DEL); a DEL run walks up the rows while the E-extend bit (4)
// holds, an INS run left along the columns while the F-extend bit (8)
// holds.  A change of state pushes the finished run as one packed segment,
// state | length << 2.  The plain version, cigar_walk_plain in
// mgl_tpu_torch/ops/cigar_device.py, defines every output bit; this kernel
// equals it.
//
// Input: the words of csrc/sw_banded.cu, (B, G, 32) uint32 a pair (held as
// int32), cell (i, j) in word ((i-1)/32)*WPB + ((j-1+s)>>3) of lane
// s = (i-1)%32 at nibble (j-1+s)&7; ez (6, B) int32 (mqe, mqe_t, max,
// max_t, max_q, seg_length).  Output: segs (B, seg_cap), tail (B, 5) =
// [nseg, cur_state, cur_len, I, J], over (B,).
//
// One thread a pair, its automaton in registers, 128 pairs a block.  A
// step is one word read at an address that depends on the step before:
// the walk is a serial chain of up to tlen + qlen dependent loads, from a
// pair's ~20 KB of words that no cache holds across the batch (8,192
// mapper windows hold ~169 MB).  What bounds it on an H100 is the latency
// of those loads, not bytes or operations: a step reads 4 B and does ~20
// integer operations.  Many pairs in flight (a thread each) hide the
// latency as far as the batch allows.  Each pushed segment is stored
// straight to segs; slots the walk never reached are zeroed at its end,
// so the wrapper allocates the outputs without a fill.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // pairs a block
constexpr int kBand = 32;      // target rows a band of the layout
// the strategies' codes (OverhangStrategy) that move the walk's start
constexpr int kIndel = 0x02;
constexpr int kLeadingIndel = 0x04;
// the automaton's modes
constexpr int kNormal = 0;
constexpr int kInsRun = 1;
constexpr int kDelRun = 2;

__global__ void __launch_bounds__(kThreads)
    cigar_walk_kernel(const uint32_t* __restrict__ words, const int* __restrict__ ez,
                      const int* __restrict__ tlen, const int* __restrict__ qlen, int n_pairs,
                      int64_t pair_words, int words_per_band, int strategy, int n_steps,
                      int seg_cap, int* __restrict__ segs, int* __restrict__ tail,
                      uint8_t* __restrict__ over) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_pairs) return;
  // the strategy's start (sw.cpp:155-170)
  int I, J;
  if (strategy == kIndel) {
    I = tlen[b];
    J = qlen[b];
  } else if (strategy == kLeadingIndel) {
    I = ez[n_pairs + b];  // mqe_t
    J = qlen[b];
  } else {
    I = ez[3 * n_pairs + b];  // max_t
    J = ez[4 * n_pairs + b];  // max_q
  }
  const uint32_t* w = words + static_cast<int64_t>(b) * pair_words;
  int* seg = segs + static_cast<int64_t>(b) * seg_cap;
  int mode = kNormal, cur_state = 0, cur_len = 0, nseg = 0;
  bool overflow = false;
  bool done = !(I > 0 && J > 0);  // a pair that starts outside never walks
  for (int step = 0; step < n_steps && !done; ++step) {
    const int s = (I - 1) & (kBand - 1);
    const int t = J - 1 + s;
    const uint32_t word = w[(static_cast<int64_t>((I - 1) / kBand) * words_per_band + (t >> 3)) *
                                kBand +
                            s];
    const int nib = static_cast<int>((word >> (4 * (t & 7))) & 0xFu);
    int cell_state, dI, dJ, next_mode;
    if (mode == kNormal) {
      const int move = nib & 3;
      cell_state = move;
      dI = (move == 0) | (move == 2);
      dJ = (move == 0) | (move == 1);
      next_mode = (move == 2 && (nib & 4)) ? kDelRun : (move == 1 && (nib & 8)) ? kInsRun : kNormal;
    } else if (mode == kDelRun) {
      cell_state = 2;
      dI = 1;
      dJ = 0;
      next_mode = (nib & 4) ? kDelRun : kNormal;
    } else {
      cell_state = 1;
      dI = 0;
      dJ = 1;
      next_mode = (nib & 8) ? kInsRun : kNormal;
    }
    if (cell_state == cur_state) {
      ++cur_len;
    } else {
      // the last slot takes every push past the cap; nseg counts on
      seg[min(nseg, seg_cap - 1)] = cur_state | (cur_len << 2);
      overflow |= nseg >= seg_cap;
      ++nseg;
      cur_len = 1;
      cur_state = cell_state;
    }
    I -= dI;
    J -= dJ;
    done = !(I > 0 && J > 0);
    mode = next_mode;
  }
  for (int k = min(nseg, seg_cap); k < seg_cap; ++k) seg[k] = 0;
  int* tl = tail + static_cast<int64_t>(b) * 5;
  tl[0] = nseg;
  tl[1] = cur_state;
  tl[2] = cur_len;
  tl[3] = I;
  tl[4] = J;
  over[b] = static_cast<uint8_t>(overflow || !done);  // unfinished: host decode
}

}  // namespace

// words: (n_pairs, pair_words) uint32; ez: (6, n_pairs) int32; tlen,
// qlen: (n_pairs,) int32; segs (n_pairs, seg_cap) and tail (n_pairs, 5)
// int32 and over (n_pairs,) uint8 outputs.  Launches on ``stream`` and
// returns cudaGetLastError().
extern "C" int mgl_cigar_walk(const void* words, const void* ez, const void* tlen,
                              const void* qlen, int n_pairs, int64_t pair_words,
                              int words_per_band, int strategy, int n_steps, int seg_cap,
                              void* segs, void* tail, void* over, void* stream) {
  if (n_pairs < 1 || words_per_band < 1 || n_steps < 0 || seg_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_pairs + kThreads - 1) / kThreads;
  cigar_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int*>(ez),
      static_cast<const int*>(tlen), static_cast<const int*>(qlen), n_pairs, pair_words,
      words_per_band, strategy, n_steps, seg_cap, static_cast<int*>(segs),
      static_cast<int*>(tail), static_cast<uint8_t*>(over));
  return static_cast<int>(cudaGetLastError());
}
