// Banded affine-gap Smith-Waterman with on-device ScoreMax, for Hopper.
//
// Replaces the TPU kernel mgl_tpu/kernels/sw_pallas.py:_sw_banded_kernel
// (wrapper sw_pallas_banded, :930).  Same recurrence, tie rules and
// outputs; the layout is rethought for a warp:
//
// * One warp per pair.  Lane s holds matrix row r = 32*b + s + 1 of band b;
//   on step t it computes column c = t - s + 1, so the cell above (r-1, c)
//   was computed by lane s-1 on step t-1 and arrives by one lane shuffle
//   (the TPU kernel's sublane roll).
// * Between bands one (A, H) row per column goes through a per-pair carry
//   in global memory: lane 31 writes the band's bottom row, lane 0 of the
//   next band reads it.  Reads run 32 columns ahead of writes, so one
//   buffer serves, and no length needs a tier of its own.
// * The vertical-gap stream is pre-combined as A = max(H - open, E - ext)
//   with the E-extend bit in the LSB (traceback mode), as on the TPU.
// * Traceback: each lane packs 8 nibbles (move | ebit<<2 | fbit<<3) per
//   register and stores one 32-bit word every 8 steps, so a warp stores
//   128 contiguous bytes.  Layout per pair (G, 32) with G = NB * WPB:
//   cell (i, j) -> word (i-1)/32 * WPB + (j-1+s)/8, lane s = (i-1)%32,
//   nibble (j-1+s)%8 - what the host decoder (csrc/host/cigar_decode.cpp)
//   reads.
// * ScoreMax: the last-column best is kept per lane (rows ascend within a
//   lane, so '>=' keeps the last row) and reduced over the warp on the
//   key (value, row); the last row lives in one lane, which scans it in
//   column order with the reference's '>' / closer-to-diagonal rule.
//
// What bounds it on an H100: each step is ~40 dependent integer ops and
// three shuffles per lane, with no reuse of memory beyond the carry, so
// it is issue-bound; one warp per pair keeps every lane busy once the
// 31-step ramp of each band is over.  The carry is read one value per
// step by lane 0 and lies in L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBand = 32;
constexpr int kNeg = -(1 << 30);       // DP_NEG_INF (mgl_tpu/core/params.py)
constexpr int kBig = 0x3FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int border(int k, int indel_init, int go, int ge) {
  // first-row / first-column score at index k (sw.cpp:29-40)
  return (indel_init && k >= 1) ? -go - (k - 1) * ge : 0;
}

__device__ __forceinline__ int pack_a(int v, int ext_bit) {
  return static_cast<int>((static_cast<unsigned>(v) << 1) |
                          static_cast<unsigned>(ext_bit));
}

template <bool kTraceback>
__global__ void __launch_bounds__(128)
sw_banded_kernel(const uint8_t* __restrict__ tgt, const uint8_t* __restrict__ qry,
                 const int* __restrict__ tlen, const int* __restrict__ qlen,
                 int n_pairs, int t_stride, int q_stride,
                 int match, int mismatch, int go, int ge, int indel_init,
                 int words_per_band, int n_words, int carry_cols,
                 int* __restrict__ carry, int* __restrict__ ez,
                 uint32_t* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  const int pair = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (pair >= n_pairs) return;  // whole warp leaves together

  const int tl = min(tlen[pair], t_stride);
  const int ql = min(qlen[pair], q_stride);
  const uint8_t* tp = tgt + static_cast<size_t>(pair) * t_stride;
  const uint8_t* qp = qry + static_cast<size_t>(pair) * q_stride;
  int* c_a = carry + static_cast<size_t>(pair) * 2 * carry_cols;
  int* c_h = c_a + carry_cols;
  uint32_t* wp = words + static_cast<size_t>(pair) * n_words * kBand;

  // row 0 of the DP (sw.cpp:29-40): H(0, c) and A(0, c) with the open bit
  for (int c = lane; c < carry_cols; c += kBand) {
    const int bc = border(c, indel_init, go, ge);
    c_a[c] = kTraceback ? pack_a(bc - go, 0) : bc - go;
    c_h[c] = bc;
  }
  __syncwarp();

  const int n_bands = (tl + kBand - 1) / kBand;
  const int n_steps = ql + kBand - 1;
  int mqe = kNeg, mqe_t = 1;             // this lane's last-column best
  int rmax = kNeg, rdist = kBig, rj = 1;  // last-row best (one lane)

  for (int b = 0; b < n_bands; ++b) {
    const int r = b * kBand + lane + 1;
    const int tch = r <= tl ? tp[r - 1] : 0;
    const int br = border(r, indel_init, go, ge);        // H(r, 0)
    const int br_up = border(r - 1, indel_init, go, ge);  // H(r-1, 0)
    const int a_fill = kTraceback ? pack_a(br - go, 0) : br - go;
    int h_un = br;                                         // H(r, c-1)
    int f_un = kNeg;                                       // F(r, c-1)
    int a_p = lane == 0 ? c_a[1] : a_fill;                 // A(r-1, c)
    int h_p = lane == 0 ? c_h[1] : br_up;                  // H(r-1, c)
    int h_pp = br_up;                                      // H(r-1, c-1)
    int qd = lane == 0 ? qp[0] : 0;                        // query[c-1]
    uint32_t word = 0;

    for (int t = 0; t < n_steps; ++t) {
      const int c = t - lane + 1;
      const int e = kTraceback ? (a_p >> 1) : a_p;
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
      int a = kTraceback ? pack_a(open_wins_v ? open_v : ext_v, open_wins_v ? 0 : 1)
                         : max(open_v, ext_v);
      if (kTraceback) {
        const uint32_t nib =
            (diag >= ef_max ? 0u : (f >= e ? 1u : 2u)) |
            (static_cast<uint32_t>(a_p & 1) << 2) | (open_wins_h ? 0u : 8u);
        const int phase = t & 7;
        word = phase == 0 ? nib : (word | (nib << (4 * phase)));
        if (phase == 7 || t == n_steps - 1)
          wp[static_cast<size_t>(b * words_per_band + (t >> 3)) * kBand + lane] = word;
      }
      if (c <= 0) {
        // before the wavefront reaches this row: hold the column-0 boundary
        h = br;
        f = kNeg;
        a = a_fill;
      } else {
        if (c == ql && r <= tl && h >= mqe) {            // '>=': last row wins
          mqe = h;
          mqe_t = r;
        }
        if (r == tl && c <= ql) {                        // '>' or closer to diagonal
          const int dist = abs(tl - c);
          if (h > rmax || (h == rmax && dist < rdist)) {
            rmax = h;
            rdist = dist;
            rj = c;
          }
        }
      }

      // hand the new cells one lane down; lane 0 takes the carry instead
      int a_sh = __shfl_sync(kFull, a, (lane + 31) & 31);
      int h_sh = __shfl_sync(kFull, h, (lane + 31) & 31);
      int q_sh = __shfl_up_sync(kFull, qd, 1);
      if (lane == kBand - 1 && t - (kBand - 2) >= 1) {
        c_a[t - (kBand - 2)] = a;
        c_h[t - (kBand - 2)] = h;
      }
      if (lane == 0) {
        a_sh = c_a[t + 2];
        h_sh = c_h[t + 2];
        q_sh = t + 1 < ql ? qp[t + 1] : 0;
      }
      h_un = h;
      f_un = f;
      a_p = a_sh;
      h_pp = h_p;
      h_p = h_sh;
      qd = q_sh;
    }
    __syncwarp();  // the next band's lane 0 reads what lane 31 wrote
  }

  // warp reductions on total orders, so the tie rules survive any lane order
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
  if (lane == 0) {
    // the reference seeds its last-row scan with (mqe, mqe_t, qlen)
    const bool row_wins = rmax > mqe || (rmax == mqe && rdist < abs(mqe_t - ql));
    ez[0 * n_pairs + pair] = mqe;
    ez[1 * n_pairs + pair] = mqe_t;
    ez[2 * n_pairs + pair] = row_wins ? rmax : mqe;
    ez[3 * n_pairs + pair] = row_wins ? tl : mqe_t;
    ez[4 * n_pairs + pair] = row_wins ? rj : ql;
    ez[5 * n_pairs + pair] = row_wins ? ql - rj : 0;
  }
}

}  // namespace

extern "C" int mgl_sw_banded(const void* tgt, const void* qry, const void* tlen,
                             const void* qlen, int n_pairs, int t_stride, int q_stride,
                             int match, int mismatch, int gap_open, int gap_ext,
                             int indel_init, int with_traceback, int words_per_band,
                             int n_words, int carry_cols, void* carry, void* ez,
                             void* words, void* stream) {
  const int threads = 128;
  const int blocks = (n_pairs * kBand + threads - 1) / threads;
  auto s = static_cast<cudaStream_t>(stream);
  if (with_traceback) {
    sw_banded_kernel<true><<<blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(tgt), static_cast<const uint8_t*>(qry),
        static_cast<const int*>(tlen), static_cast<const int*>(qlen), n_pairs,
        t_stride, q_stride, match, mismatch, gap_open, gap_ext, indel_init,
        words_per_band, n_words, carry_cols, static_cast<int*>(carry),
        static_cast<int*>(ez), static_cast<uint32_t*>(words));
  } else {
    sw_banded_kernel<false><<<blocks, threads, 0, s>>>(
        static_cast<const uint8_t*>(tgt), static_cast<const uint8_t*>(qry),
        static_cast<const int*>(tlen), static_cast<const int*>(qlen), n_pairs,
        t_stride, q_stride, match, mismatch, gap_open, gap_ext, indel_init,
        words_per_band, n_words, carry_cols, static_cast<int*>(carry),
        static_cast<int*>(ez), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mgl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
