// The affine-gap Smith-Waterman wavefront of both SW kernels for Hopper:
// one kernel template whose step and band loop are written once, with what
// a step stores chosen when compiling (Out below).  sw_banded.cu launches
// it with the per-pair banded traceback layout or score-only, sw_plane.cu
// with the plane traceback layout, the last-row / last-column samples or
// the best score.  Same recurrence and tie rules as the plain versions in
// mgl_tpu_torch/ops/sw.py.
//
// * One block a pair, W warps (W = 1, 2, 4 .. 32, chosen by the wrapper).
//   Lane s holds matrix row r = 32*b + s + 1 of band b, and warp w runs
//   bands w, w+W, w+2W, ...; on step t a lane computes column
//   c = t - s + 1, so every lane of a warp is on anti-diagonal
//   d = 32*b + t + 2, and the cell above (r-1, c) was computed by lane s-1
//   on step t-1 and arrives by one lane shuffle (the TPU kernels' sublane
//   roll).
// * Between bands one (A, H) row per column goes through one carry row a
//   pair: lane 31 writes the band's bottom row at column t - 30 on step t,
//   and lane 0 of the band below takes column t + 2 on step t.  A band
//   reads a column 32 steps before it writes it, and waits for the band
//   above, so one row serves any W.  The launcher puts the row in shared
//   memory (8 * (Q + 34) bytes a block) when that leaves an SM as many
//   resident blocks as the batch can use with the row in global memory,
//   and in global memory otherwise: many long queries (2,048 of 10,000
//   bases: 2 blocks an SM with the row in shared memory, 16 without) or
//   a row over the block's opt-in limit (Q above ~29,000).  Shared is
//   11-21% faster at 10,000 x 150 bp with banded traceback (PERF.md).
// * Carry and query off the step's critical path: each lane stages one
//   value of the next 32 columns (carry A and H, query base) in registers
//   a chunk ahead, and on step t lane 0 takes its three by shuffles from
//   lane t & 31, which depend on nothing computed in the step.
// * Handoff between warps: every 32 steps lane 31 publishes how many carry
//   columns of its band it has written (a release store to its warp's
//   counter in shared memory); before staging a chunk, each lane of the
//   band below polls that counter with acquire loads.  A band runs 64-96
//   steps behind the band above.  No step waits on a block barrier.
// * The vertical-gap stream is pre-combined as A = max(H - open, E - ext)
//   with the E-extend bit in the LSB (traceback layouts), as on the TPU.
// * Traceback: each lane packs 8 nibbles (move | ebit<<2 | fbit<<3) per
//   register, the nibble of step t at t % 8, and stores one 32-bit word
//   every 8 steps (and on the band's last).  Banded layout (G, 32) a pair
//   with G = NB * WPB: word b * WPB + t/8 at lane s, so a warp stores 128
//   contiguous bytes; lanes also store nibbles for the steps before the
//   wavefront reaches their row and past ql, which no decode reads.  Plane
//   layout (n_words, T+1) a pair: cell (r, c) lies in word (d-2)/8 =
//   4*b + t/8 of row r at nibble t % 8 - the same nibble and phase - so a
//   warp's store again covers 32 consecutive rows, 128 contiguous bytes.
//   There nibbles of columns outside 1 .. ql are 0, and a lane stores only
//   words that hold a cell of the pair (its row <= tlen, a column in
//   1 .. ql); the wrapper's zeros stand for the rest.
// * ScoreMax (banded both modes, plane traceback): the last-column best is
//   kept per lane (rows ascend within a lane, so '>=' keeps the last row)
//   and the last row lives in one lane, which scans it in column order
//   with the reference's '>' / closer-to-diagonal rule; both are reduced
//   over the warp, then over the block's warps, on total orders, so the
//   tie rules hold for any W.  Samples: the lane whose column reaches ql
//   stores the last-column score of its diagonal, the lane of row tlen the
//   last-row score.  Best score: one running maximum a lane over both, then
//   a maximum over the warp and the block.
// * Two kinds of step: the first 32 of a band and those where a column
//   reaches ql check the column-0 boundary, the columns past ql and the
//   last column; the steps between, where every lane's column lies in
//   1 .. ql-1, check none of them (the last row only in the band holding
//   row tlen) and run 8 at a time, so a nibble's place in its word is a
//   constant and a word holds steps of one kind only.
//
// What bounds it on an H100: a step is a chain of ~8 dependent integer
// ops and a shuffle per lane, with no memory access on it.  One warp
// cannot hide that chain, so the wrapper picks W to put 8-16 warps on
// each SM (many short pairs take W = 1, a few long pairs up to 32); there
// the step's instruction count - the recurrence, the nibble, six shuffles
// and lane 31's carry stores - sets the time.  The plane layout's words
// (T+1 rows of (T+Q)/8 words a pair, mostly zeros) bound it by bytes only
// for long pairs, and then in the wrapper's zero fill.
#pragma once

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "band_pipeline.cuh"

namespace {

constexpr int kBand = 32;
constexpr int kMaxWarps = 32;
constexpr int kNeg = -(1 << 30);       // DP_NEG_INF (mgl_tpu_torch/core/params.py)
constexpr int kBig = 0x3FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;
// ints of shared memory before the carry row: a progress counter and the
// five ScoreMax fields of each warp
constexpr int kHead = 6 * kMaxWarps;

// What a launch stores.  out0 / out1 of the kernel:
// kBandedWords  ez (6, B) / words (B, G, 32), the per-pair banded layout
// kBandedScore  ez (6, B) / -
// kPlaneWords   ez (6, B) / words (B, n_words, T+1), the plane layout
// kPlaneSamples last-column / last-row scores (B, T+Q-1), int32
// kPlaneBest    best score (B,) / -
enum Out { kBandedWords, kBandedScore, kPlaneWords, kPlaneSamples, kPlaneBest };

__device__ __forceinline__ int border(int k, int indel_init, int go, int ge) {
  // first-row / first-column score at index k (sw.cpp:29-40)
  return (indel_init && k >= 1) ? -go - (k - 1) * ge : 0;
}

__device__ __forceinline__ int pack_a(int v, int ext_bit) {
  return static_cast<int>((static_cast<unsigned>(v) << 1) |
                          static_cast<unsigned>(ext_bit));
}

// max on (value, row) for the last column; on (value, -distance, -column)
// for the last row - total orders, so any reduction order gives one answer
__device__ __forceinline__ void reduce_warp(int& mqe, int& mqe_t, int& rmax,
                                            int& rdist, int& rj) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, mqe, off);
    const int ot = __shfl_xor_sync(kFull, mqe_t, off);
    if (ov > mqe || (ov == mqe && ot > mqe_t)) {
      mqe = ov;
      mqe_t = ot;
    }
    const int rv = __shfl_xor_sync(kFull, rmax, off);
    const int rd = __shfl_xor_sync(kFull, rdist, off);
    const int rc = __shfl_xor_sync(kFull, rj, off);
    if (rv > rmax || (rv == rmax && (rd < rdist || (rd == rdist && rc < rj)))) {
      rmax = rv;
      rdist = rd;
      rj = rc;
    }
  }
}

template <int kOut, bool kSharedCarry>
__global__ void __launch_bounds__(kBand * kMaxWarps)
sw_wavefront_kernel(const uint8_t* __restrict__ tgt, const uint8_t* __restrict__ qry,
                    const int* __restrict__ tlen, const int* __restrict__ qlen,
                    int n_pairs, int t_stride, int q_stride,
                    int match, int mismatch, int go, int ge, int indel_init,
                    int words_per_band, int n_words, int carry_cols,
                    int* carry, int* __restrict__ out0, uint32_t* __restrict__ out1) {
  constexpr bool kNibbles = kOut == kBandedWords || kOut == kPlaneWords;
  constexpr bool kPlane = kOut == kPlaneWords || kOut == kPlaneSamples || kOut == kPlaneBest;
  constexpr bool kTies = kOut == kBandedWords || kOut == kBandedScore || kOut == kPlaneWords;
  extern __shared__ int smem[];
  int* progress = smem;                  // [kMaxWarps]
  int* red = smem + kMaxWarps;           // [5][kMaxWarps]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int pair = blockIdx.x;

  const int tl = min(tlen[pair], t_stride);
  const int ql = min(qlen[pair], q_stride);
  const uint8_t* tp = tgt + static_cast<size_t>(pair) * t_stride;
  const uint8_t* qp = qry + static_cast<size_t>(pair) * q_stride;
  int* c_a = kSharedCarry ? smem + kHead
                          : carry + static_cast<size_t>(pair) * 2 * carry_cols;
  int* c_h = c_a + carry_cols;
  // the plane layout's rows of a word index (a pair's n_words * (T+1)
  // words fit int32 offsets: the wrapper says so), and the samples'
  // diagonals
  const int row_words = t_stride + 1;
  const size_t n_samples = static_cast<size_t>(t_stride) + q_stride - 1;
  uint32_t* wp = kPlane ? out1 + static_cast<size_t>(pair) * n_words * row_words
                        : out1 + static_cast<size_t>(pair) * n_words * kBand;

  // row 0 of the DP (sw.cpp:29-40): H(0, c) and A(0, c) with the open bit;
  // columns past ql keep it for good (no band writes them)
  for (int c = threadIdx.x; c < carry_cols; c += blockDim.x) {
    const int bc = border(c, indel_init, go, ge);
    c_a[c] = kNibbles ? pack_a(bc - go, 0) : bc - go;
    c_h[c] = bc;
  }
  if (threadIdx.x < kMaxWarps) progress[threadIdx.x] = 0;
  __syncthreads();

  const int n_bands = (tl + kBand - 1) / kBand;
  const int n_steps = ql + kBand - 1;
  // a warp's counter reads k * span + x once it has written carry columns
  // 1 .. x of its k-th band
  const int span = ql + 1;
  int mqe = kNeg, mqe_t = 1;             // this lane's last-column best
  int rmax = kNeg, rdist = kBig, rj = 1;  // last-row best (one lane)
  int best = kNeg;                       // best-score mode: both at once

  for (int b = warp, k = 0; b < n_bands; b += n_warps, ++k) {
    const int* above = progress + (b + n_warps - 1) % n_warps;
    const int above_done = b > 0 ? (b - 1) / n_warps * span : 0;
    // carry columns 32*chunk + 2 + lane and query base 32*chunk + 1 + lane:
    // what lane 0 takes on step 32*chunk + lane.  Chunk 0 also waits for
    // column 1, which lane 0 reads before its first step; a later chunk
    // waits only if it holds a column the band above writes (<= ql).
    auto stage = [&](int chunk, int& sa, int& sh, int& sq) {
      if (b > 0 && (chunk == 0 || kBand * chunk + 2 <= ql))
        wait_for(above, above_done + min(kBand * chunk + kBand + 1, ql));
      const int col = min(kBand * chunk + 2 + lane, carry_cols - 1);
      const int qi = kBand * chunk + 1 + lane;
      sa = c_a[col];
      sh = c_h[col];
      sq = qi < ql ? qp[qi] : 0;
    };
    int cur_a, cur_h, cur_q, nxt_a, nxt_h, nxt_q;
    stage(0, cur_a, cur_h, cur_q);
    stage(1, nxt_a, nxt_h, nxt_q);

    const int r = b * kBand + lane + 1;
    const int tch = r <= tl ? tp[r - 1] : 0;
    const int br = border(r, indel_init, go, ge);        // H(r, 0)
    const int br_up = border(r - 1, indel_init, go, ge);  // H(r-1, 0)
    const int a_fill = kNibbles ? pack_a(br - go, 0) : br - go;
    int h_un = br;                                         // H(r, c-1)
    int f_un = kNeg;                                       // F(r, c-1)
    int a_p = lane == 0 ? c_a[1] : a_fill;                 // A(r-1, c)
    int h_p = lane == 0 ? c_h[1] : br_up;                  // H(r-1, c)
    int h_pp = br_up;                                      // H(r-1, c-1)
    int qd = lane == 0 ? qp[0] : 0;                        // query[c-1]
    uint32_t word = 0;
    // the lane's word of step 0: banded word b * WPB at lane s; plane word
    // 4b of row r.  Samples: diagonal 32b + 2 at step 0.
    uint32_t* wband = kPlane ? wp + 4 * b * row_words + r
                             : wp + static_cast<size_t>(b) * words_per_band * kBand + lane;
    int* lc = out0 + static_cast<size_t>(pair) * n_samples + b * kBand;
    int* lr = reinterpret_cast<int*>(out1) + static_cast<size_t>(pair) * n_samples + b * kBand;

    // One step of the band.  kEdges: some lane's column is <= 0 or >= ql,
    // so the column-0 boundary and the last column are checked (and in the
    // plane layout the columns past ql); without it every column lies in
    // 1 .. ql-1 and only the lane holding row tl (kLastRow) updates the
    // last row.
    auto step = [&](int t, int phase, auto edges, auto last_row) {
      constexpr bool kEdges = decltype(edges)::value;
      constexpr bool kLastRow = decltype(last_row)::value;
      const int c = t - lane + 1;
      const int e = kNibbles ? (a_p >> 1) : a_p;
      const int open_h = h_un - go;
      const int ext_h = f_un - ge;
      const bool open_wins_h = open_h > ext_h;           // strict > (sw.cpp:84)
      int f = open_wins_h ? open_h : ext_h;
      const int diag = h_pp + (qd == tch ? match : mismatch);
      const int ef_max = max(e, f);
      int h = max(diag, ef_max);                         // diag >= INS >= DEL
      const int open_v = h - go;
      const int ext_v = e - ge;
      const bool open_wins_v = open_v > ext_v;           // strict > (sw.cpp:73)
      int a = kNibbles ? pack_a(open_wins_v ? open_v : ext_v, open_wins_v ? 0 : 1)
                       : max(open_v, ext_v);
      if (kNibbles) {
        uint32_t nib =
            (diag >= ef_max ? 0u : (f >= e ? 1u : 2u)) |
            (static_cast<uint32_t>(a_p & 1) << 2) | (open_wins_h ? 0u : 8u);
        if (kPlane && kEdges && (c < 1 || c > ql)) nib = 0;  // not a cell of the pair
        word = phase == 0 ? nib : (word | (nib << (4 * phase)));
        if (phase == 7 || (kEdges && t == n_steps - 1)) {
          if constexpr (kPlane) {
            // the word's columns (t & ~7) - lane + 1 .. t - lane + 1 meet
            // 1 .. ql, on a row of the pair
            if (r <= tl && (!kEdges || (t >= lane && (t & ~7) < ql + lane)))
              wband[(t >> 3) * row_words] = word;
          } else {
            wband[(t >> 3) * kBand] = word;
          }
        }
      }
      if (kEdges && c <= 0) {
        // before the wavefront reaches this row: hold the column-0 boundary
        h = br;
        f = kNeg;
        a = a_fill;
      } else if (kEdges || kLastRow) {
        if (kEdges && c == ql && r <= tl) {
          if (kTies) {
            if (h >= mqe) {                              // '>=': last row wins
              mqe = h;
              mqe_t = r;
            }
          } else if (kOut == kPlaneSamples) {
            lc[t] = h;
          } else {
            best = max(best, h);
          }
        }
        if (r == tl && (!kEdges || c <= ql)) {
          if (kTies) {
            const int dist = abs(tl - c);                // '>' or closer to diagonal
            if (h > rmax || (h == rmax && dist < rdist)) {
              rmax = h;
              rdist = dist;
              rj = c;
            }
          } else if (kOut == kPlaneSamples) {
            lr[t] = h;
          } else {
            best = max(best, h);
          }
        }
      }

      // hand the new cells one lane down; lane 0 takes the staged carry
      int a_sh = __shfl_sync(kFull, a, (lane + 31) & 31);
      int h_sh = __shfl_sync(kFull, h, (lane + 31) & 31);
      int q_sh = __shfl_up_sync(kFull, qd, 1);
      const int a_in = __shfl_sync(kFull, cur_a, t & 31);
      const int h_in = __shfl_sync(kFull, cur_h, t & 31);
      const int q_in = __shfl_sync(kFull, cur_q, t & 31);
      if (lane == kBand - 1 && (!kEdges || t >= kBand - 1)) {
        c_a[t - (kBand - 2)] = a;
        c_h[t - (kBand - 2)] = h;
      }
      if (lane == 0) {
        a_sh = a_in;
        h_sh = h_in;
        q_sh = q_in;
      }
      h_un = h;
      f_un = f;
      a_p = a_sh;
      h_pp = h_p;
      h_p = h_sh;
      qd = q_sh;

      if (phase == 7 && (t & 31) == 31) {
        // a chunk ends: publish this band's columns, move to the staged
        // chunk and stage the one after it
        if (lane == kBand - 1) store_release(progress + warp, k * span + t - (kBand - 2));
        cur_a = nxt_a;
        cur_h = nxt_h;
        cur_q = nxt_q;
        if (t + 1 + kBand < n_steps) stage((t >> 5) + 2, nxt_a, nxt_h, nxt_q);
      }
    };
    auto steady = [&](int& t, auto last_row) {
      // the steps where every lane's column lies in 1 .. ql-1, 8 at a time
      // so that the nibble's place in the word is known when compiling
      for (; t + 8 <= ql - 1; t += 8) {
#pragma unroll
        for (int j = 0; j < 8; ++j) step(t + j, j, std::false_type{}, last_row);
      }
    };

    int t = 0;
    for (; t < min(kBand, n_steps); ++t) step(t, t & 7, std::true_type{}, std::true_type{});
    if ((tl - 1) / kBand == b)
      steady(t, std::true_type{});
    else
      steady(t, std::false_type{});
    for (; t < n_steps; ++t) step(t, t & 7, std::true_type{}, std::true_type{});
    if (lane == kBand - 1) store_release(progress + warp, k * span + ql);
    __syncwarp();
  }

  if constexpr (kTies) {
    reduce_warp(mqe, mqe_t, rmax, rdist, rj);
    if (lane == 0) {
      red[0 * kMaxWarps + warp] = mqe;
      red[1 * kMaxWarps + warp] = mqe_t;
      red[2 * kMaxWarps + warp] = rmax;
      red[3 * kMaxWarps + warp] = rdist;
      red[4 * kMaxWarps + warp] = rj;
    }
    __syncthreads();
    if (warp != 0) return;
    const bool mine = lane < n_warps;
    mqe = mine ? red[0 * kMaxWarps + lane] : kNeg;
    mqe_t = mine ? red[1 * kMaxWarps + lane] : 1;
    rmax = mine ? red[2 * kMaxWarps + lane] : kNeg;
    rdist = mine ? red[3 * kMaxWarps + lane] : kBig;
    rj = mine ? red[4 * kMaxWarps + lane] : 1;
    reduce_warp(mqe, mqe_t, rmax, rdist, rj);
    if (lane == 0) {
      // the reference seeds its last-row scan with (mqe, mqe_t, qlen)
      const bool row_wins = rmax > mqe || (rmax == mqe && rdist < abs(mqe_t - ql));
      out0[0 * n_pairs + pair] = mqe;
      out0[1 * n_pairs + pair] = mqe_t;
      out0[2 * n_pairs + pair] = row_wins ? rmax : mqe;
      out0[3 * n_pairs + pair] = row_wins ? tl : mqe_t;
      out0[4 * n_pairs + pair] = row_wins ? rj : ql;
      out0[5 * n_pairs + pair] = row_wins ? ql - rj : 0;
    }
  } else if constexpr (kOut == kPlaneBest) {
    best = __reduce_max_sync(kFull, best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp != 0) return;
    best = __reduce_max_sync(kFull, lane < n_warps ? red[lane] : kNeg);
    if (lane == 0) out0[pair] = best;
  }
}

// Whether the carry row goes to shared memory (band_pipeline.cuh)
template <int kOut>
cudaError_t wavefront_carry_in_shared(int n_pairs, int carry_cols, int warps, bool* shared) {
  return carry_in_shared(sw_wavefront_kernel<kOut, false>, sw_wavefront_kernel<kOut, true>,
                         n_pairs, kBand * warps, sizeof(int) * kHead,
                         sizeof(int) * 2 * static_cast<size_t>(carry_cols), shared);
}

// warps is W, 1 to 32; carry holds (2, carry_cols) ints a pair, used when
// the carry row lies in global memory; out0 / out1 as Out says
template <int kOut>
cudaError_t launch_wavefront(const void* tgt, const void* qry, const void* tlen,
                             const void* qlen, int n_pairs, int t_stride, int q_stride,
                             int match, int mismatch, int gap_open, int gap_ext,
                             int indel_init, int words_per_band, int n_words,
                             int carry_cols, int warps, void* carry, void* out0,
                             void* out1, cudaStream_t stream) {
  bool shared = false;
  const cudaError_t e = wavefront_carry_in_shared<kOut>(n_pairs, carry_cols, warps, &shared);
  if (e != cudaSuccess) return e;
  const auto kernel = shared ? sw_wavefront_kernel<kOut, true>
                             : sw_wavefront_kernel<kOut, false>;
  kernel<<<n_pairs, kBand * warps,
           sizeof(int) * (kHead + (shared ? 2 * static_cast<size_t>(carry_cols) : 0)), stream>>>(
      static_cast<const uint8_t*>(tgt), static_cast<const uint8_t*>(qry),
      static_cast<const int*>(tlen), static_cast<const int*>(qlen), n_pairs,
      t_stride, q_stride, match, mismatch, gap_open, gap_ext, indel_init,
      words_per_band, n_words, carry_cols, static_cast<int*>(carry),
      static_cast<int*>(out0), static_cast<uint32_t*>(out1));
  return cudaGetLastError();
}

}  // namespace
