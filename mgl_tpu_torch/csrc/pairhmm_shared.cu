// Shared-hap-set PairHMM forward with prefix sharing, for Hopper (float).
//
// Replaces mgl_tpu/kernels/pairhmm_pallas.py:_pairhmm_shared_kernel (:611,
// wrapper pairhmm_pallas_shared :797): every read against one hap set,
// sweeping only the columns each hap does not share with its predecessor,
// the TPU form of the reference's haplotype column cache
// (compute_prob_avxf.cc:943-967 save, 1068-1071 partial-sum seed).  Scores
// are the avxf variant: one yInitial = 2^120 / COLS_MAX for the whole set;
// the host rescales by COLS_MAX / haplen (avxf.cc:661, 1086).
//
// Layout:
// * One warp per read, sweeping the whole hap set; the read's planes sit
//   in registers for a band.  Lane s holds row r = 32*b + s + 1 of band b.
//   Band loop outside, segment loop inside, as on the TPU.
// * Segment j is hap j's distinct suffix, columns pos_j+1 .. len_j, at
//   stream slots base_j .. base_j + len_j - pos_j - 1.  On step t of
//   segment j lane s computes column pos_j + t + 1 - s, in
//   T_j = len_j - pos_j + 31 steps.  The recurrence is the per-pair
//   kernel's (csrc/pairhmm_banded.cu): pre-multiplied U/W streams,
//   M = distm * U(r-1,c-1), X = W(r-1,c), Y = M(r,c-1)*pMY + Y(r,c-1)*pZZ.
// * Checkpoint and restore: at step ts_j = pos_{j+1} - pos_j every lane's
//   state (m, y, w_p, u_p, u_pp, hd, acc) is the state a full sweep of
//   hap j+1 holds there, since the two haps share columns <= pos_{j+1}.
//   Each lane saves its own 7 values in registers, before that step's
//   compute (or after the loop when ts == T), and segment j+1 starts from
//   them; only lane 0's look-ahead (u_p, w_p from the band above, and
//   hd) is taken from segment j+1's own stream, at slot base_{j+1}.  The
//   checkpointed acc seeds hap j+1's last-row sum.
// * The (U, W) row that crosses bands lives in a per-read carry in global
//   memory indexed by stream slot: lane 31 writes slot base_j + t - 31
//   (column pos_j + t - 30) once it is inside the segment, lane 0 of the
//   next band reads slot base_j + t + 1, with a __syncwarp() per band.
//   Reads run 32 slots ahead of writes and no segment reads below its own
//   base, so one buffer of S + 34 slots serves every hap set; band 0 reads
//   U = yInit*pGapM[1], W = 0 in every column without touching it.
// * Each read loops over its own length, not a bucket's.  The last-row
//   (M + X) sum is kept by the lane that holds the read's last row, in
//   ascending columns, for each hap in turn.
// * Built with --fmad=false and without -ftz, so it equals the plain torch
//   version (ops/pairhmm.py:shared_forward_plain) bit for bit, and both
//   equal the per-pair forward run with yInit = y_shared for every hap.
//
// What bounds it on an H100: about 11 dependent FP32 operations a cell
// (7 multiplies, 4 adds, as in pairhmm_banded.cu) plus 3 shuffles, so it
// is issue- and latency-bound.  The design keeps the read in registers
// and sweeps only the distinct-suffix columns: at GATK's region shape
// (12 haps, one SNP apart, sorted) about 2.2x fewer cells than the full
// product.  Known limit: one warp per read is 512 warps at that shape,
// about 4 per SM, too few to hide the dependent chain's latency.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBand = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPlanes = 7;  // pMM, pGapM, pMX, pMY, pZZ, distm-match, distm-mismatch

__global__ void __launch_bounds__(128)
pairhmm_shared_kernel(const float* __restrict__ planes, const int* __restrict__ rchar,
                      const int* __restrict__ rslen, const int* __restrict__ hstream,
                      const int* __restrict__ segtab, int n_reads, int plane_rows,
                      int n_haps, int stream_cols, float y_shared,
                      float* __restrict__ carry, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int read = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (read >= n_reads) return;  // whole warp leaves together

  const float* p = planes + static_cast<size_t>(read) * kPlanes * plane_rows;
  const int* rc = rchar + static_cast<size_t>(read) * plane_rows;
  const int rl = min(rslen[read], plane_rows - 2);
  const float u0 = y_shared * p[1 * plane_rows + 1];  // yInit * pGapM[1]
  float* c_u = carry + static_cast<size_t>(read) * 2 * stream_cols;
  float* c_w = c_u + stream_cols;
  float* o = out + static_cast<size_t>(read) * n_haps;
  const int* seg_base = segtab;
  const int* seg_pos = segtab + n_haps;
  const int* seg_len = segtab + 2 * n_haps;
  const int* seg_steps = segtab + 3 * n_haps;
  const int* seg_chk = segtab + 4 * n_haps;

  const int n_bands = (rl + kBand - 1) / kBand;
  for (int b = 0; b < n_bands; ++b) {
    const int r = b * kBand + lane + 1;
    const float pmm_u = p[0 * plane_rows + r + 1];
    const float pgapm_u = p[1 * plane_rows + r + 1];
    const float pmx_u = p[2 * plane_rows + r + 1];
    const float pzz_u = p[4 * plane_rows + r + 1];
    const float pmy = p[3 * plane_rows + r];
    const float pzz = p[4 * plane_rows + r];
    const float dm = p[5 * plane_rows + r];
    const float dmm = p[6 * plane_rows + r];
    const int rch = rc[r];
    const bool is_last = r == rl;
    const bool last_band = b == n_bands - 1;

    // the checkpoint: this lane's wavefront state at the next hap's
    // shared-prefix boundary
    float k_m = 0.f, k_y = 0.f, k_wp = 0.f, k_up = 0.f, k_upp = 0.f, k_acc = 0.f;
    int k_hd = 0;

    for (int j = 0; j < n_haps; ++j) {
      const int base = seg_base[j];
      const int pos = seg_pos[j];
      const int hl = seg_len[j];
      const int n_steps = seg_steps[j];
      const int chk = seg_chk[j];
      const bool fresh = pos == 0;

      float m_un = fresh ? 0.f : k_m;    // M of (r, c-1)
      float y_un = fresh ? 0.f : k_y;    // Y of (r, c-1)
      float w_p = fresh ? 0.f : k_wp;    // W(r-1, c)
      float u_p = fresh ? 0.f : k_up;    // U(r-1, c)
      float u_pp = fresh ? ((lane == 0 && b == 0) ? u0 : 0.f) : k_upp;  // U(r-1, c-1)
      int hd = fresh ? 0 : k_hd;         // hap[c-1], one-hot
      float acc = fresh ? 0.f : k_acc;
      if (lane == 0) {                   // look-ahead from this segment's stream
        u_p = b == 0 ? u0 : c_u[base];
        w_p = b == 0 ? 0.f : c_w[base];
        hd = hstream[base];
      }
      const int ts = chk < 0 ? n_steps : min(max(chk, 0), n_steps);

      for (int t = 0;; ++t) {
        if (t == ts) {
          k_m = m_un; k_y = y_un; k_wp = w_p; k_up = u_p; k_upp = u_pp;
          k_hd = hd; k_acc = acc;
        }
        if (t == n_steps) break;
        const float distm = (rch & hd) != 0 ? dm : dmm;
        const float m = distm * u_pp;
        const float x = w_p;
        const float y = m_un * pmy + y_un * pzz;
        if (is_last) {
          const int c = pos + t + 1 - lane;
          if (c >= 1 && c <= hl) acc = acc + (m + x);
        }
        const float u = m * pmm_u + (x + y) * pgapm_u;
        const float w = m * pmx_u + x * pzz_u;

        float u_sh = __shfl_sync(kFull, u, (lane + 31) & 31);
        float w_sh = __shfl_sync(kFull, w, (lane + 31) & 31);
        int h_sh = __shfl_up_sync(kFull, hd, 1);
        if (lane == kBand - 1 && t >= kBand - 1 && pos + t + 2 - kBand <= hl) {
          c_u[base + t + 1 - kBand] = u;
          c_w[base + t + 1 - kBand] = w;
        }
        if (lane == 0) {
          const int s = base + t + 1;
          u_sh = b == 0 ? u0 : c_u[s];
          w_sh = b == 0 ? 0.f : c_w[s];
          h_sh = hstream[s];
        }
        m_un = m;
        y_un = y;
        w_p = w_sh;
        u_pp = u_p;
        u_p = u_sh;
        hd = h_sh;
      }
      if (last_band && is_last) o[j] = acc;
    }
    __syncwarp();  // the next band's lane 0 reads what lane 31 wrote
  }
}

}  // namespace

extern "C" int mgl_pairhmm_shared_f32(const void* planes, const void* rchar,
                                      const void* rslen, const void* hstream,
                                      const void* segtab, int n_reads, int plane_rows,
                                      int n_haps, int stream_cols, float y_shared,
                                      void* carry, void* out, void* stream) {
  const int threads = 128;
  const int blocks = (n_reads * kBand + threads - 1) / threads;
  pairhmm_shared_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const int*>(rchar),
      static_cast<const int*>(rslen), static_cast<const int*>(hstream),
      static_cast<const int*>(segtab), n_reads, plane_rows, n_haps, stream_cols,
      y_shared, static_cast<float*>(carry), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
