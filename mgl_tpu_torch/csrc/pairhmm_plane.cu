// Full-height ("plane") PairHMM forward in float for Hopper.
//
// Replaces the TPU kernel mgl_tpu/kernels/pairhmm_pallas.py:_pairhmm_kernel
// (wrapper pairhmm_pallas_forward, :135): the f32 M/X/Y forward one
// anti-diagonal of the whole matrix a step, scores scaled by 2^120.  Its
// plain version is mgl_tpu_torch/ops/pairhmm.py:forward_plain, which is
// this full-height recurrence already (and is also the plain version of
// the banded kernel, csrc/pairhmm_banded.cu, so the two kernels are held
// to one another through it).
//
// Layout, rethought for a thread block:
// * One block per (read, hap) pair; the block reads ridx[pair]'s planes
//   and hidx[pair]'s hap, so the product is expanded here and not by a
//   copy, and it takes the banded kernel's staged arguments as they are
//   (pairhmm_cuda.stage_pairs).  The TPU's lane-major padding of 128 pairs
//   (pairhmm_pallas.py:1284 prepare_inputs) has no counterpart.
// * Thread t takes read rows t+1, t+1+blockDim, ... (one row a thread up
//   to 1024-base reads); on diagonal d a row r computes column c = d - r
//   when 1 <= c <= haplen, and the block meets at one __syncthreads() a
//   diagonal.
// * M, X and Y of the three latest diagonals sit in shared memory, one
//   slot a row (9 x (rows - 1) floats, 5.8 KB at 151-base reads): cell
//   (r, c) reads (r-1, c-1) from diagonal d-2, (r-1, c) and (r, c-1) from
//   d-1, and writes d, three distinct buffers, so one barrier a diagonal
//   orders everything.  Row 0 holds M = X = 0, Y = yInit in every buffer,
//   and column 0 is the zero every row holds before its first cell.
// * The op order of _pairhmm_kernel :103-107 and forward_plain :99-103:
//      M = distm * (M_d2[r-1]*pMM + (X_d2[r-1] + Y_d2[r-1]) * pGapM)
//      Y = M_d1[r]*pMY + Y_d1[r]*pZZ
//      X = M_d1[r-1]*pMX + X_d1[r-1]*pZZ
//   Built with --fmad=false and without -ftz, so each product and sum is
//   rounded on its own and denormals are kept, as in torch's ops.
// * The last-row (M + X) sum is added by whichever thread holds row
//   rslen, into one shared float, in ascending columns: no reduction, so
//   the order is the plain version's and the result bit-exact.
//
// What bounds it on an H100: ~12 dependent flops a cell between one
// barrier and the next, with 7 shared loads and 3 stores and the row's
// 8 plane values read from L1 each step; latency-bound per diagonal and
// issue-bound once enough blocks share an SM.  Device memory is touched
// only for the planes (L1/L2-resident) and one score.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanes = 7;  // pMM, pGapM, pMX, pMY, pZZ, distm-match, distm-mismatch

__global__ void __launch_bounds__(1024)
pairhmm_plane_kernel(const float* __restrict__ planes, const int* __restrict__ rchar,
                     const int* __restrict__ rslen, const int* __restrict__ haps,
                     const int* __restrict__ haplen, const float* __restrict__ y_init,
                     const int64_t* __restrict__ ridx, const int64_t* __restrict__ hidx,
                     int plane_rows, int hap_cols, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float s_acc;
  const int slots = plane_rows - 1;  // matrix rows 0 .. plane_rows-2
  // buffer k of M, X, Y: smem[(3k + 0|1|2) * slots + r], diagonal d in k = d % 3
  auto mxy = [&](int k, int which) { return smem + (3 * k + which) * slots; };

  const int pair = blockIdx.x;
  const int64_t ri = ridx[pair];
  const int64_t hi = hidx[pair];
  const float* p = planes + ri * kPlanes * plane_rows;
  const int* rc = rchar + ri * plane_rows;
  const int* hp = haps + hi * hap_cols;
  const int rl = min(rslen[ri], plane_rows - 2);
  const int hl = min(haplen[hi], hap_cols);
  const float yi = y_init[hi];

  for (int i = threadIdx.x; i < 3 * slots; i += blockDim.x) {
    const int k = i / slots, r = i - k * slots;
    mxy(k, 0)[r] = 0.0f;
    mxy(k, 1)[r] = 0.0f;
    mxy(k, 2)[r] = r == 0 ? yi : 0.0f;
  }
  if (threadIdx.x == 0) s_acc = 0.0f;
  __syncthreads();

  for (int d = 2; d <= rl + hl; ++d) {
    const float* m1 = mxy((d + 2) % 3, 0);   // diagonal d-1
    const float* x1 = mxy((d + 2) % 3, 1);
    const float* y1 = mxy((d + 2) % 3, 2);
    const float* m2 = mxy((d + 1) % 3, 0);   // diagonal d-2
    const float* x2 = mxy((d + 1) % 3, 1);
    const float* y2 = mxy((d + 1) % 3, 2);
    float* m0 = mxy(d % 3, 0);
    float* x0 = mxy(d % 3, 1);
    float* y0 = mxy(d % 3, 2);
    for (int r = threadIdx.x + 1; r <= rl; r += blockDim.x) {
      const int c = d - r;
      if (c < 1 || c > hl) continue;
      const float distm = (rc[r] & hp[c - 1]) != 0 ? p[5 * plane_rows + r]
                                                   : p[6 * plane_rows + r];
      const float m = distm * (m2[r - 1] * p[0 * plane_rows + r] +
                               (x2[r - 1] + y2[r - 1]) * p[1 * plane_rows + r]);
      const float y = m1[r] * p[3 * plane_rows + r] + y1[r] * p[4 * plane_rows + r];
      const float x = m1[r - 1] * p[2 * plane_rows + r] + x1[r - 1] * p[4 * plane_rows + r];
      m0[r] = m;
      x0[r] = x;
      y0[r] = y;
      if (r == rl) s_acc = s_acc + (m + x);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[pair] = s_acc;
}

}  // namespace

extern "C" int mgl_pairhmm_plane_f32(const void* planes, const void* rchar,
                                     const void* rslen, const void* haps,
                                     const void* haplen, const void* y_init,
                                     const void* ridx, const void* hidx, int n_pairs,
                                     int plane_rows, int hap_cols, void* out,
                                     void* stream) {
  const int threads = std::min(1024, (plane_rows - 2 + 31) / 32 * 32);
  const size_t smem = static_cast<size_t>(9) * (plane_rows - 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pairhmm_plane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pairhmm_plane_kernel<<<n_pairs, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const int*>(rchar),
      static_cast<const int*>(rslen), static_cast<const int*>(haps),
      static_cast<const int*>(haplen), static_cast<const float*>(y_init),
      static_cast<const int64_t*>(ridx), static_cast<const int64_t*>(hidx), plane_rows,
      hap_cols, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
