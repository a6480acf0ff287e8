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
// A group of kGroup lanes a pair, 32 / kGroup pairs a warp.  The walk is
// serial, so every lane of a group runs the pair's automaton on the same
// values (its first lane writes the results) and the group's lanes share
// the copies.  A step reads one nibble from a window of the pair's words
// in shared memory, never from device memory:
//   - The walk only moves up and left, and each step lowers the diagonal
//     t = J - 1 + s of its band by 1 (INS, DEL) or 2 (a match), so from a
//     cell (s_ref, t_ref) of a band it reaches, in row s' = s_ref - d,
//     only t <= t_ref - d, and t = t_ref - 2d if every step is a match.
//   - A window of a band holds, for each row s' <= s_ref, the word
//     columns from (t_ref - 2d - kSlackLo) / 8 to (t_ref - d + kSlackHi)
//     / 8, copied by whole 32 B sectors (8 rows of a word column) with
//     16 B cp.async: ~1 KB a band, against the band's ~3 KB.  It sits in
//     the layout's own order (column-major, rows on the fast axis) from
//     its first column, kCols columns of 32 words.
//   - Two windows a pair: at row kPrefetchRow of a band the group starts
//     the copy of the next band's window, at the cell a walk of matches
//     would enter it, and walks on; on entering that band it waits for
//     the copy and swaps the windows.  So a band's device-memory round
//     trip overlaps the walk of the band before it.
//   - A step outside its window (a long insertion or deletion, an entry
//     away from the predicted cell, the first band) copies the window
//     from that cell and waits for it.
//   - The steps inside a window run in a loop of their own, whose chain
//     from one word to the next is short: the nibble, the state, the moves
//     (which follow from the state, no branch), the next address, the
//     shared load - the next word is loaded from an address masked into the
//     buffers before the test that keeps the walk in the window.
// What bounds it on an H100: the latency of a step over the ~151 steps of
// a mapper window.  Every pair of a chunk is resident at once (8,192 pairs
// are ~8 warps an SM), so little hides it: a step takes ~290 cycles on
// the card, against ~70 for its chain's operations.  Then the ~4 KB of
// window sectors a pair from device memory.  Four lanes a pair: two ran
// within 5% of it, eight 25% slower (more instructions a pair).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBand = 32;                   // target rows a band of the layout
constexpr int kGroup = 4;                   // lanes a pair
constexpr int kWarps = 2;                   // warps a block
constexpr int kPairs = kWarps * 32 / kGroup;  // pairs a block
constexpr int kSlackLo = 8;                 // diagonals a window reaches below matches
constexpr int kSlackHi = 8;                 // and above deletions
// word columns a window spans: row 0's first to row 31's last
constexpr int kCols = ((2 * (kBand - 1) + kSlackLo + kSlackHi) >> 3) + 2;
constexpr int kWindow = kCols * kBand;      // words a window
constexpr int kPad = 512;                   // a step's load before its window test: slot & (kPad - 1)
constexpr int kPrefetchRow = 15;            // the next band's copy starts here
// the strategies' codes (OverhangStrategy) that move the walk's start
constexpr int kIndel = 0x02;
constexpr int kLeadingIndel = 0x04;

// the first and last word columns a window from (s_ref, t_ref) holds in
// row s_ref - d; columns at most ``cols`` - 1 (the pair's words)
__device__ __forceinline__ int window_lo(int t_ref, int d) {
  return max(t_ref - 2 * d - kSlackLo, 0) >> 3;
}
__device__ __forceinline__ int window_hi(int t_ref, int d, int cols) {
  return min((t_ref - d + kSlackHi) >> 3, cols - 1);
}

__device__ __forceinline__ void copy_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src) : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The group's lanes start copying the window of ``band`` from (s_ref,
// t_ref) out of the pair's words ``w`` into ``win``: for each group of 8
// rows, the sectors of the columns its rows reach, half a sector a copy.
// Word (c, s) goes to win[(c - window_lo(t_ref, s_ref)) * kBand + s].
__device__ __forceinline__ void fetch(uint32_t* win, const uint32_t* w, int band, int s_ref,
                                      int t_ref, int wpb, int n_cols, int gl) {
  const uint32_t* bw = w + static_cast<int64_t>(band) * wpb * kBand;
  const int cols = n_cols - band * wpb;
  const int base = window_lo(t_ref, s_ref);
  for (int r0 = 0; r0 <= s_ref; r0 += 8) {
    const int c0 = window_lo(t_ref, s_ref - r0);
    const int c1 = window_hi(t_ref, s_ref - min(r0 + 7, s_ref), cols);
    for (int k = gl; k < 2 * (c1 - c0 + 1); k += kGroup) {
      const int c = c0 + (k >> 1);
      const int row = r0 + 4 * (k & 1);
      copy_async16(win + (c - base) * kBand + row, bw + c * kBand + row);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A window's bounds, fixed when it is made: row s' of it holds the
// columns max(a + 2 s', 0) / 8 .. min((h + s') / 8, last) for s' <= row
// (window_lo and window_hi of the reference (row, t_ref)), word (c, s')
// at ((c - col0) << 5) + s' of buffer ``at`` of the pair's two.
struct Window {
  int band, row, a, h, last, col0, at;
};

__device__ __forceinline__ Window make_window(int band, int s_ref, int t_ref, int cols, int at) {
  return Window{band, s_ref, t_ref - 2 * s_ref - kSlackLo, t_ref - s_ref + kSlackHi, cols - 1,
                window_lo(t_ref, s_ref), at};
}

__device__ __forceinline__ bool holds(const Window& v, int band, int s, int col) {
  return band == v.band && s <= v.row && col >= (max(v.a + 2 * s, 0) >> 3) &&
         col <= min((v.h + s) >> 3, v.last);
}

__global__ void __launch_bounds__(kWarps * 32)
    cigar_walk_kernel(const uint32_t* __restrict__ words, const int* __restrict__ ez,
                      const int* __restrict__ tlen, const int* __restrict__ qlen, int n_pairs,
                      int64_t pair_words, int words_per_band, int strategy, int n_steps,
                      int seg_cap, int* __restrict__ segs, int* __restrict__ tail,
                      uint8_t* __restrict__ over) {
  __shared__ __align__(16) uint32_t windows[kPairs * 2 * kWindow + kPad];
  const int gl = threadIdx.x & (kGroup - 1);
  const int slot = threadIdx.x / kGroup;
  const int b = blockIdx.x * kPairs + slot;
  if (b >= n_pairs) return;  // the whole group
  const unsigned group = ((1u << kGroup) - 1u) << (threadIdx.x & 31 & ~(kGroup - 1));
  const bool first = gl == 0;
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
  const int n_cols = static_cast<int>(pair_words / kBand);
  int* const seg = segs + static_cast<int64_t>(b) * seg_cap;
  const int cap = seg_cap - 1;
  uint32_t* const win = windows + slot * 2 * kWindow;
  Window cur{-1, 0, 0, 0, 0, 0, 0};      // the window the walk reads
  Window next{-1, 0, 0, 0, 0, 0, 0};     // the next band's, being copied
  bool armed = false;                    // the next band's copy is still to start
  int mode = 0, cur_state = 0, cur_len = 0, nseg = 0;  // mode: 0 NORMAL, 1 INS run, 2 DEL run
  bool overflow = false;
  bool done = !(I > 0 && J > 0);  // a pair that starts outside never walks
  int step = 0;
  while (!done && step < n_steps) {
    // the cell's window: the one in use, the next band's, or a new copy
    const int band = (I - 1) >> 5;
    int s = (I - 1) & (kBand - 1);
    int t = J - 1 + s;
    if (!holds(cur, band, s, t >> 3)) {
      if (band == next.band) {  // into the band copied ahead
        wait_copies();
        __syncwarp(group);
        cur = next;
        next.band = -1;
      }
      if (!holds(cur, band, s, t >> 3)) {
        // outside the window: copy the one from this cell and wait for it
        __syncwarp(group);
        cur = make_window(band, s, t, n_cols - band * words_per_band, cur.at);
        fetch(win + cur.at, w, band, s, t, words_per_band, n_cols, gl);
        wait_copies();
        __syncwarp(group);
        if (next.band != band - 1) next.band = -1;
      }
      armed = next.band < 0 && band > 0;
    }
    if (armed && s <= kPrefetchRow) {
      // the next band's window, from where a walk of matches enters it
      const int nt = max(J - s - 1, 1) - 1 + kBand - 1;
      next = make_window(band - 1, kBand - 1, nt, n_cols - (band - 1) * words_per_band,
                         cur.at ^ kWindow);
      fetch(win + next.at, w, band - 1, kBand - 1, nt, words_per_band, n_cols, gl);
      armed = false;
    }
    // the steps inside this window, until one leaves it (a new band, a
    // column outside its row's range) or reaches the row where the next
    // band's copy starts: each step's next word is loaded from an address
    // masked into the buffers before its test, so the chain from one word
    // to the next is the nibble, the state, the moves and the address
    const int lim = armed ? kPrefetchRow + 1 : 0;
    int row = s - (cur.col0 << 5);  // word (c, s) at win[cur.at + (c << 5) + row]
    uint32_t word = win[cur.at + ((t >> 3) << 5) + row];
    for (;;) {
      // the automaton: NORMAL takes the cell's move (nibble & 3), a run its
      // own state; a DEL run (2) goes on under the E-extend bit 2, an INS
      // run (1) under the F-extend bit 3, so the next mode is the state
      // when the bit 4 - state is set (never for states 0 and 3)
      const uint32_t x = word >> ((t & 7) << 2);
      const int cell_state = static_cast<int>(x & (mode ? 0u : 3u)) | mode;
      const int dI = ~cell_state & 1;       // a match (0) or a DEL (2) moves up
      const int dJ = (cell_state >> 1) ^ 1;  // a match or an INS (1) moves left
      const int nib = static_cast<int>(x & 0xFu);
      const bool push = cell_state != cur_state;
      // the last slot takes every push past the cap; nseg counts on
      if (push && first) seg[min(nseg, cap)] = cur_state | (cur_len << 2);
      overflow |= push && nseg > cap;
      nseg += push;
      cur_len = push ? 1 : cur_len + 1;
      cur_state = cell_state;
      mode = (cell_state != 3 && ((nib >> (4 - cell_state)) & 1)) ? cell_state : 0;
      I -= dI;
      J -= dJ;
      s -= dI;
      row -= dI;
      t -= dI + dJ;
      ++step;
      done = !(I > 0 && J > 0);
      if (done || step >= n_steps) break;
      const int col = t >> 3;
      word = win[cur.at + (((col << 5) + row) & (kPad - 1))];
      if (s < lim || col < (max(cur.a + 2 * s, 0) >> 3) || col > min((cur.h + s) >> 3, cur.last))
        break;
    }
  }
  wait_copies();  // no copy outlives the walk
  for (int k = min(nseg, seg_cap) + gl; k < seg_cap; k += kGroup) seg[k] = 0;
  if (first) {
    int* tl = tail + static_cast<int64_t>(b) * 5;
    tl[0] = nseg;
    tl[1] = cur_state;
    tl[2] = cur_len;
    tl[3] = I;
    tl[4] = J;
    over[b] = static_cast<uint8_t>(overflow || !done);  // unfinished: host decode
  }
}

// (blocks, threads a block, static shared bytes a block, lanes a pair)
// of a launch
void layout(int n_pairs, int* geo) {
  geo[0] = (n_pairs + kPairs - 1) / kPairs;
  geo[1] = kWarps * 32;
  geo[2] = static_cast<int>(sizeof(uint32_t)) * (kPairs * 2 * kWindow + kPad);
  geo[3] = kGroup;
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
  if (n_pairs < 1 || words_per_band < 1 || n_steps < 0 || seg_cap < 1 || pair_words < kBand)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(words) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  int geo[4];
  layout(n_pairs, geo);
  cigar_walk_kernel<<<geo[0], geo[1], 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int*>(ez),
      static_cast<const int*>(tlen), static_cast<const int*>(qlen), n_pairs, pair_words,
      words_per_band, strategy, n_steps, seg_cap, static_cast<int*>(segs),
      static_cast<int*>(tail), static_cast<uint8_t*>(over));
  return static_cast<int>(cudaGetLastError());
}

// The launch's (blocks, threads a block, shared bytes a block, lanes a
// pair) into geo[0..3], for the smoke's report; returns 0.
extern "C" int mgl_cigar_walk_layout(int n_pairs, void* geo) {
  layout(n_pairs, static_cast<int*>(geo));
  return 0;
}
