// Full-height ("plane") affine-gap Smith-Waterman for Hopper: traceback,
// samples and best-score modes of one kernel template.
//
// Replaces the TPU kernels mgl_tpu/kernels/sw_pallas.py:_sw_kernel
// (wrapper sw_pallas_forward, :824; traceback and samples modes) and
// sw_pallas.py:_sw_score_kernel (wrapper sw_pallas_scores, :769; best
// score).  Same recurrence, tie rules and outputs as the plain version
// mgl_tpu_torch/ops/sw.py (sw_plane_plain, sw_plane_scores_plain); the
// layout is rethought for a thread block:
//
// * One block per pair.  On anti-diagonal d the block's threads take the
//   real cells of that diagonal, rows lo..hi with lo = max(1, d - qlen)
//   and hi = min(tlen, d - 1), consecutive threads on consecutive rows,
//   and the block meets at one __syncthreads() a diagonal.  The TPU kernel
//   instead ran all R1p rows of 128 pairs in lockstep and rolled the rows
//   down by one sublane a step; here the query base is read directly as
//   query[d - r - 1] and no cell outside the pair's own matrix is run.
// * State lives in shared memory, indexed by row modulo a power-of-two
//   ring of more than min(T, Q) + 1 slots (a diagonal holds at most
//   min(tlen, qlen) real cells, and a row's slot is free again once the
//   row below has read its last cell): H and E of the two latest
//   diagonals (by parity), F and the H above-left of each row's next
//   cell, and in traceback mode the word being packed.  At 8000 x 2000
//   that is 7 x 2048 ints (57 KB): the state of a long target does not
//   grow with the target.
// * Traceback: a row's nibbles (move | E-extend << 2 | F-extend << 3) of 8
//   diagonals pack into one word, stored when full or at the row's last
//   cell, at word (d-2)/8 of row r in the pair's (n_words, T+1) block -
//   what the host decoder (csrc/host/cigar_decode.cpp) reads.  Threads on
//   neighbouring rows store neighbouring words.  Words of cells outside
//   the pair's matrix are left as the wrapper zeroed them.
// * ScoreMax: each diagonal has one last-column cell (r = d - qlen) and at
//   most one last-row cell (r = tlen), so the thread that computes it
//   updates the running best in shared memory under the reference's rules
//   ('>=' in ascending rows; '>' or equal-and-closer-to-diagonal in
//   ascending columns), with no reduction; the barrier of each diagonal
//   orders the updates.  Samples mode stores those two cells' scores a
//   diagonal; best-score mode keeps only the largest.
//
// What bounds it on an H100: ~30 dependent integer ops a cell between one
// barrier and the next, with the block's state in shared memory and each
// cell's two bases read from L1, so it is latency-bound per diagonal and
// issue-bound once enough blocks share an SM; the traceback bytes (T+1
// words a row, 4 bytes per 8 diagonals) bound it first only for long
// pairs.  Many small blocks (one a pair, 32 threads a warp of rows) keep
// the SMs full at GATK's 150 bp; a long pair has min(T, Q) threads.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);       // DP_NEG_INF (mgl_tpu_torch/core/params.py)
constexpr int kBig = 0x3FFFFFFF;
enum Mode { kTraceback = 0, kSamples = 1, kScore = 2 };

__device__ __forceinline__ int border(int k, int indel_init, int go, int ge) {
  // first-row / first-column score at index k (sw.cpp:29-40)
  return (indel_init && k >= 1) ? -go - (k - 1) * ge : 0;
}

template <int kMode>
__global__ void __launch_bounds__(1024)
sw_plane_kernel(const uint8_t* __restrict__ tgt, const uint8_t* __restrict__ qry,
                const int* __restrict__ tlen, const int* __restrict__ qlen,
                int n_pairs, int t_stride, int q_stride,
                int match, int mismatch, int go, int ge, int indel_init,
                int ring, int n_words,
                int* __restrict__ out0, int* __restrict__ out1) {
  extern __shared__ int smem[];
  int* h_buf = smem;                   // [2][ring] H of diagonals by parity
  int* e_buf = smem + 2 * ring;        // [2][ring] E (vertical gap, DEL)
  int* f_row = smem + 4 * ring;        // [ring] F (horizontal gap, INS)
  int* h_diag_row = smem + 5 * ring;   // [ring] H(r-1, j-1) of the next cell
  uint32_t* word_row = reinterpret_cast<uint32_t*>(smem + 6 * ring);
  // ScoreMax: last column (value, row), last row (value, distance, column);
  // best-score mode keeps only s_mqe and s_rmax
  __shared__ int s_mqe, s_mqe_t, s_rmax, s_rdist, s_rj;

  const int pair = blockIdx.x;
  const int mask = ring - 1;
  const int tl = min(tlen[pair], t_stride);
  const int ql = min(qlen[pair], q_stride);
  const uint8_t* tp = tgt + static_cast<size_t>(pair) * t_stride;
  const uint8_t* qp = qry + static_cast<size_t>(pair) * q_stride;
  const int n_samples = t_stride + q_stride - 1;
  if (threadIdx.x == 0) {
    s_mqe = kNeg;
    s_mqe_t = 1;
    s_rmax = kNeg;
    s_rdist = kBig;
    s_rj = 1;
  }
  __syncthreads();

  for (int d = 2; d <= tl + ql; ++d) {
    const int* h_prev = h_buf + ((d - 1) & 1) * ring;
    const int* e_prev = e_buf + ((d - 1) & 1) * ring;
    int* h_cur = h_buf + (d & 1) * ring;
    int* e_cur = e_buf + (d & 1) * ring;
    const int hi = min(tl, d - 1);
    for (int r = max(1, d - ql) + threadIdx.x; r <= hi; r += blockDim.x) {
      const int j = d - r;
      const int s = r & mask;
      const int su = (r - 1) & mask;
      // the cells above, to the left and above-left; row 0 and column 0
      // are the borders (sw.cpp:29-40), with E and F at minus infinity
      const int h_up = r == 1 ? border(j, indel_init, go, ge) : h_prev[su];
      const int e_up = r == 1 ? kNeg : e_prev[su];
      const int h_left = j == 1 ? border(r, indel_init, go, ge) : h_prev[s];
      const int f_left = j == 1 ? kNeg : f_row[s];
      const int h_ul = r == 1   ? border(j - 1, indel_init, go, ge)
                       : j == 1 ? border(r - 1, indel_init, go, ge)
                                : h_diag_row[s];

      const int open_v = h_up - go;
      const int ext_v = e_up - ge;
      const bool open_wins_v = open_v > ext_v;           // strict > (sw.cpp:73)
      const int e = open_wins_v ? open_v : ext_v;
      const int open_h = h_left - go;
      const int ext_h = f_left - ge;
      const bool open_wins_h = open_h > ext_h;           // strict > (sw.cpp:84)
      const int f = open_wins_h ? open_h : ext_h;
      const int diag = h_ul + (qp[j - 1] == tp[r - 1] ? match : mismatch);
      const int ef_max = max(e, f);
      const int h = max(diag, ef_max);                   // diag >= INS >= DEL

      h_cur[s] = h;
      e_cur[s] = e;
      f_row[s] = f;
      h_diag_row[s] = h_up;

      if (kMode == kTraceback) {
        const uint32_t nib = (diag >= ef_max ? 0u : (f >= e ? 1u : 2u)) |
                             (open_wins_v ? 0u : 4u) | (open_wins_h ? 0u : 8u);
        const int phase = (d - 2) & 7;
        const uint32_t word =
            ((phase == 0 || j == 1) ? 0u : word_row[s]) | (nib << (4 * phase));
        if (phase == 7 || j == ql) {
          reinterpret_cast<uint32_t*>(out1)[(static_cast<size_t>(pair) * n_words +
                                             ((d - 2) >> 3)) * (t_stride + 1) + r] = word;
        } else {
          word_row[s] = word;
        }
        if (j == ql && h >= s_mqe) {                     // '>=': last row wins
          s_mqe = h;
          s_mqe_t = r;
        }
        if (r == tl) {                                   // '>' or closer to diagonal
          const int dist = abs(tl - j);
          if (h > s_rmax || (h == s_rmax && dist < s_rdist)) {
            s_rmax = h;
            s_rdist = dist;
            s_rj = j;
          }
        }
      } else if (kMode == kSamples) {
        if (j == ql) out0[static_cast<size_t>(pair) * n_samples + d - 2] = h;
        if (r == tl) out1[static_cast<size_t>(pair) * n_samples + d - 2] = h;
      } else {
        if (j == ql) s_mqe = max(s_mqe, h);
        if (r == tl) s_rmax = max(s_rmax, h);
      }
    }
    __syncthreads();
  }

  if (threadIdx.x != 0) return;
  if (kMode == kTraceback) {
    // the reference seeds its last-row scan with (mqe, mqe_t, qlen)
    const bool row_wins =
        s_rmax > s_mqe || (s_rmax == s_mqe && s_rdist < abs(s_mqe_t - ql));
    out0[0 * n_pairs + pair] = s_mqe;
    out0[1 * n_pairs + pair] = s_mqe_t;
    out0[2 * n_pairs + pair] = row_wins ? s_rmax : s_mqe;
    out0[3 * n_pairs + pair] = row_wins ? tl : s_mqe_t;
    out0[4 * n_pairs + pair] = row_wins ? s_rj : ql;
    out0[5 * n_pairs + pair] = row_wins ? ql - s_rj : 0;
  } else if (kMode == kScore) {
    out0[pair] = max(s_mqe, s_rmax);
  }
}

template <int kMode>
int launch(const void* tgt, const void* qry, const void* tlen, const void* qlen,
           int n_pairs, int t_stride, int q_stride, int match, int mismatch,
           int gap_open, int gap_ext, int indel_init, int ring, int n_words,
           void* out0, void* out1, void* stream) {
  // a diagonal has at most min(T, Q) real cells: one thread each, a warp
  // at least, and the block's limit of 1024 at most
  const int window = std::min(t_stride, q_stride);
  const int threads = std::min(1024, (window + 31) / 32 * 32);
  const size_t smem = static_cast<size_t>(kMode == kTraceback ? 7 : 6) * ring * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      sw_plane_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sw_plane_kernel<kMode><<<n_pairs, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tgt), static_cast<const uint8_t*>(qry),
      static_cast<const int*>(tlen), static_cast<const int*>(qlen), n_pairs, t_stride,
      q_stride, match, mismatch, gap_open, gap_ext, indel_init, ring, n_words,
      static_cast<int*>(out0), static_cast<int*>(out1));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode 0: traceback, out0 = ez (6, B), out1 = words (B, n_words, T+1);
// mode 1: samples, out0 / out1 = last-column / last-row (B, T+Q-1);
// mode 2: best score, out0 = (B,).
extern "C" int mgl_sw_plane(const void* tgt, const void* qry, const void* tlen,
                            const void* qlen, int n_pairs, int t_stride, int q_stride,
                            int match, int mismatch, int gap_open, int gap_ext,
                            int indel_init, int mode, int ring, int n_words, void* out0,
                            void* out1, void* stream) {
  switch (mode) {
    case kTraceback:
      return launch<kTraceback>(tgt, qry, tlen, qlen, n_pairs, t_stride, q_stride, match,
                                mismatch, gap_open, gap_ext, indel_init, ring, n_words,
                                out0, out1, stream);
    case kSamples:
      return launch<kSamples>(tgt, qry, tlen, qlen, n_pairs, t_stride, q_stride, match,
                              mismatch, gap_open, gap_ext, indel_init, ring, n_words, out0,
                              out1, stream);
    case kScore:
      return launch<kScore>(tgt, qry, tlen, qlen, n_pairs, t_stride, q_stride, match,
                            mismatch, gap_open, gap_ext, indel_init, ring, n_words, out0,
                            out1, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
