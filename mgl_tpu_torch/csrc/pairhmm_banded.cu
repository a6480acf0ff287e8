// Banded PairHMM forward for Hopper, one template for float and double.
//
// float replaces mgl_tpu/kernels/pairhmm_pallas.py:_pairhmm_banded_kernel
// (wrapper pairhmm_pallas_banded, :479): the main f32 pass, scores scaled
// by 2^120.  double replaces mgl_tpu/kernels/pairhmm_xf_pallas.py:
// _pairhmm_banded_xf_kernel (:61), the rescue tier for pairs under 1e-28:
// Hopper has native f64, so the TPU's (hi, lo, exponent) triples go, and
// scores are scaled by 2^1020 from the CTX_F64 tables.  A score below
// f64's range underflows to 0, as the reference's double kernel does.
//
// Layout:
// * One warp per (read, hap) pair; the warp reads ridx[pair]'s planes and
//   hidx[pair]'s hap, so the product is expanded here and not by a copy.
// * Lane s holds read row r = 32*b + s + 1 of band b and on step t
//   computes hap column c = t - s + 1.  The next row's coefficients are
//   pre-multiplied into two streams (docs/DESIGN.md section 3):
//      U(r,c) = M(r,c)*pMM[r+1] + (X(r,c)+Y(r,c))*pGapM[r+1]
//      W(r,c) = M(r,c)*pMX[r+1] +  X(r,c)        *pZZ[r+1]
//   so M(r+1,c+1) = distm * U(r,c) and X(r+1,c) = W(r,c): the spec's op
//   order (mgl_tpu/ops/pairhmm.py:260-266) computed one step earlier.
// * One (U, W) row per column crosses bands through a per-pair carry in
//   global memory (lane 31 writes, lane 0 of the next band reads), so one
//   code path serves every length.  Row 0 enters as U = yInit*pGapM[1],
//   W = 0 in every column; column 0 stays zero by itself.
// * The last-row (M + X) sum is kept by the one lane that holds the read's
//   last row, in ascending columns, as the spec sums it.
// * Built with --fmad=false and without -ftz: every product and sum is
//   rounded on its own and denormals are kept, like torch's elementwise
//   CUDA ops, so the kernel equals the plain torch forward bit for bit.
//
// What bounds it on an H100: about 12 dependent flops and three shuffles
// per cell, with the planes held in registers for a band and one carry
// value read and written per step, so it is issue- and latency-bound, not
// memory-bound; in f64 the H100's halved FP64 rate bounds it first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBand = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPlanes = 7;  // pMM, pGapM, pMX, pMY, pZZ, distm-match, distm-mismatch

template <typename T>
__global__ void __launch_bounds__(128)
pairhmm_banded_kernel(const T* __restrict__ planes, const int* __restrict__ rchar,
                      const int* __restrict__ rslen, const int* __restrict__ haps,
                      const int* __restrict__ haplen, const T* __restrict__ y_init,
                      const int64_t* __restrict__ ridx, const int64_t* __restrict__ hidx,
                      int n_pairs, int plane_rows, int hap_cols, int carry_cols,
                      T* __restrict__ carry, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int pair = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (pair >= n_pairs) return;  // whole warp leaves together

  const int64_t ri = ridx[pair];
  const int64_t hi = hidx[pair];
  const T* p = planes + ri * kPlanes * plane_rows;
  const int* rc = rchar + ri * plane_rows;
  const int* hp = haps + hi * hap_cols;
  const int rl = min(rslen[ri], plane_rows - 2);
  const int hl = min(haplen[hi], hap_cols);
  const T u0 = y_init[hi] * p[1 * plane_rows + 1];  // yInit * pGapM[1]
  T* c_u = carry + static_cast<size_t>(pair) * 2 * carry_cols;
  T* c_w = c_u + carry_cols;

  for (int c = lane; c < carry_cols; c += kBand) {
    c_u[c] = u0;
    c_w[c] = T(0);
  }
  __syncwarp();

  const int n_bands = (rl + kBand - 1) / kBand;
  const int n_steps = hl + kBand - 1;
  const int last_lane = (rl - 1) & (kBand - 1);
  T acc = T(0);

  for (int b = 0; b < n_bands; ++b) {
    const int r = b * kBand + lane + 1;
    const T pmm_u = p[0 * plane_rows + r + 1];
    const T pgapm_u = p[1 * plane_rows + r + 1];
    const T pmx_u = p[2 * plane_rows + r + 1];
    const T pzz_u = p[4 * plane_rows + r + 1];
    const T pmy = p[3 * plane_rows + r];
    const T pzz = p[4 * plane_rows + r];
    const T dm = p[5 * plane_rows + r];
    const T dmm = p[6 * plane_rows + r];
    const int rch = rc[r];
    const bool is_last = r == rl;

    T u_pp = (lane == 0 && b == 0) ? u0 : T(0);  // U(r-1, c-1)
    T u_p = lane == 0 ? c_u[1] : T(0);           // U(r-1, c)
    T w_p = lane == 0 ? c_w[1] : T(0);           // W(r-1, c)
    T m_un = T(0), y_un = T(0);                  // M, Y of (r, c-1)
    int hd = lane == 0 ? hp[0] : 0;              // hap[c-1], one-hot

    for (int t = 0; t < n_steps; ++t) {
      const T distm = (rch & hd) != 0 ? dm : dmm;
      const T m = distm * u_pp;
      const T x = w_p;
      const T y = m_un * pmy + y_un * pzz;
      if (is_last) {
        const int c = t - lane + 1;
        if (c >= 1 && c <= hl) acc = acc + (m + x);
      }
      const T u = m * pmm_u + (x + y) * pgapm_u;
      const T w = m * pmx_u + x * pzz_u;

      T u_sh = __shfl_sync(kFull, u, (lane + 31) & 31);
      T w_sh = __shfl_sync(kFull, w, (lane + 31) & 31);
      int h_sh = __shfl_up_sync(kFull, hd, 1);
      if (lane == kBand - 1 && t - (kBand - 2) >= 1) {
        c_u[t - (kBand - 2)] = u;
        c_w[t - (kBand - 2)] = w;
      }
      if (lane == 0) {
        u_sh = c_u[t + 2];
        w_sh = c_w[t + 2];
        h_sh = t + 1 < hl ? hp[t + 1] : 0;
      }
      m_un = m;
      y_un = y;
      w_p = w_sh;
      u_pp = u_p;
      u_p = u_sh;
      hd = h_sh;
    }
    __syncwarp();  // the next band's lane 0 reads what lane 31 wrote
  }

  acc = __shfl_sync(kFull, acc, last_lane);
  if (lane == 0) out[pair] = acc;
}

template <typename T>
int launch(const void* planes, const void* rchar, const void* rslen, const void* haps,
           const void* haplen, const void* y_init, const void* ridx, const void* hidx,
           int n_pairs, int plane_rows, int hap_cols, int carry_cols, void* carry,
           void* out, void* stream) {
  const int threads = 128;
  const int blocks = (n_pairs * kBand + threads - 1) / threads;
  pairhmm_banded_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(planes), static_cast<const int*>(rchar),
      static_cast<const int*>(rslen), static_cast<const int*>(haps),
      static_cast<const int*>(haplen), static_cast<const T*>(y_init),
      static_cast<const int64_t*>(ridx), static_cast<const int64_t*>(hidx), n_pairs,
      plane_rows, hap_cols, carry_cols, static_cast<T*>(carry), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mgl_pairhmm_banded_f32(const void* planes, const void* rchar,
                                      const void* rslen, const void* haps,
                                      const void* haplen, const void* y_init,
                                      const void* ridx, const void* hidx, int n_pairs,
                                      int plane_rows, int hap_cols, int carry_cols,
                                      void* carry, void* out, void* stream) {
  return launch<float>(planes, rchar, rslen, haps, haplen, y_init, ridx, hidx, n_pairs,
                       plane_rows, hap_cols, carry_cols, carry, out, stream);
}

extern "C" int mgl_pairhmm_banded_f64(const void* planes, const void* rchar,
                                      const void* rslen, const void* haps,
                                      const void* haplen, const void* y_init,
                                      const void* ridx, const void* hidx, int n_pairs,
                                      int plane_rows, int hap_cols, int carry_cols,
                                      void* carry, void* out, void* stream) {
  return launch<double>(planes, rchar, rslen, haps, haplen, y_init, ridx, hidx, n_pairs,
                        plane_rows, hap_cols, carry_cols, carry, out, stream);
}
