// Full-height ("plane") PairHMM forward in float for Hopper: a pair's
// bands pipelined on the warps of a block, R read rows a lane.
//
// Replaces the TPU kernel mgl_tpu/kernels/pairhmm_pallas.py:_pairhmm_kernel
// (wrapper pairhmm_pallas_forward, :135): the f32 M/X/Y forward over the
// whole matrix, scores scaled by 2^120.  Its plain version is
// mgl_tpu_torch/ops/pairhmm.py:forward_plain, the full-height recurrence,
// which is the banded kernel's (csrc/pairhmm_banded.cu) plain version too:
// the two kernels are two designs of one function, held to one another
// through it, so this one shares no code with that one but the band
// handoff and the carry placement of band_pipeline.cuh.
//
// The recurrence, as pairhmm_banded.cu computes it (the same op order, so
// the same bits):
//      U(r,c) = M(r,c)*pMM[r+1] + (X(r,c)+Y(r,c))*pGapM[r+1]
//      W(r,c) = M(r,c)*pMX[r+1] +  X(r,c)        *pZZ[r+1]
//      M(r+1,c+1) = distm * U(r,c),  X(r+1,c) = W(r,c),
//      Y(r,c) = M(r,c-1)*pMY[r] + Y(r,c-1)*pZZ[r].
// Row 0 is the constant U = yInit*pGapM[1], W = 0; column 0 is zero by
// itself (cells left of column 1 compute from zeros and give zeros).
//
// Layout on the card:
// * One block a pair (read ridx[b] against hap hidx[b], so the product is
//   expanded here and not by a copy; the banded kernels' staged arguments,
//   pairhmm_cuda.stage_pairs), of W warps (1 to MGL_BANDED_MAX_WARPS, the
//   wrapper's choice); warp w runs bands w, w+W, ...
// * A band is 32R consecutive read rows, R (2 or 4, a template parameter)
//   a lane: lane s holds rows 32R*b + R*s + j + 1, j = 0 .. R-1, and its
//   sub-row j computes hap column c = t - (R*s + j) + 1 on step t, so a
//   band takes hl + 32R - 1 steps.  Sub-row j+1 takes (U, W) and the hap
//   base of sub-row j's previous step in registers; only the lane's last
//   sub-row hands them to the next lane (three shuffles), and only lane 0's
//   first sub-row takes the carry row.  A step is R independent cells, so
//   their chains interleave, and its six shuffles serve R cells.
// * A lane reads its R rows' plane values once a band into registers
//   (8R + 2: pMY, pZZ, both distm, the read base, and the next row's pMM,
//   pGapM, pMX, pZZ[r+1] being the next sub-row's pZZ); rows at or past
//   the planes' end read 0 (a band of 32R rows can pass the 32k + 2 rows
//   staged, and lane 31's last sub-row reads the next band's first row).
// * One (U, W) carry row a pair (a float2 a hap column) crosses the bands:
//   lane 31's last sub-row writes column c at slot c - 1; lane 0 of the
//   band below takes slot t + 1 on step t, staged a 32-step chunk ahead in
//   registers (a slot a lane) and shuffled from lane t & 31, so nothing on
//   a step's dependency chain loads from memory.  Past the hap's end the
//   look-ahead reads 0 (those columns reach no summed cell).  At each
//   chunk's end lane 31 publishes how many slots its band has written; the
//   band below waits on that counter before it stages a chunk
//   (band_pipeline.cuh), so a band runs ~32R + 64 steps behind the one
//   above, and there is no block barrier after the first.  The row lies in
//   shared memory when that costs no resident blocks, else in global
//   memory (band_pipeline.cuh decides, the wrapper asks once a shape).
//   Nothing else is kept a row, so no read length is refused: only the
//   int32 progress counter bounds a pair (the wrapper checks it).
// * Two kinds of step: the first and the last 32R - 1 of a band check the
//   column range (for the last-row sum and lane 31's write); the steps
//   between (32R - 1 <= t < hl, every sub-row's column in 1 .. hl) check
//   nothing and run unrolled by 4, in runs cut at each chunk's end.
// * The last-row (M + X) sum is kept by the one sub-row that holds row
//   rslen, in ascending columns, as the plain version sums it.
// * Built with --fmad=false and without -ftz: every product and sum is
//   rounded on its own and denormals are kept, like torch's elementwise
//   CUDA ops, so the kernel equals the plain torch forward bit for bit.
//
// What bounds it on an H100: a cell is 11 dependent flops (7 multiplies,
// 4 adds) and a select; a step adds, for all R cells together, six
// shuffles, the row store and the register moves of the sub-row handoff.
// At the plane path's 6,144 pairs of 151 x 420 (R = 2, one warp a pair,
// 93-95 registers) each SM holds as many warps as its registers allow, so
// the schedulers' issue rate sets the time: fewer instructions a cell (the
// shuffles shared by R cells) is what R buys, and ramp steps (32R - 1 a
// band) and rows past the read are what it costs.  An R = 4 step took
// 1.7-1.9x an R = 2 step on the card, so R = 4 pays only from a few
// hundred rows on (pairhmm_cuda.plane_layout, PERF.md section 6).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "band_pipeline.cuh"

namespace {

constexpr int kLanes = 32;
// at most this many warps a block, set by the build
// (_build.BANDED_MAX_WARPS, the one place that limit is written)
#ifndef MGL_BANDED_MAX_WARPS
#error "build with -DMGL_BANDED_MAX_WARPS (mgl_tpu_torch/_build.py)"
#endif
constexpr int kMaxWarps = MGL_BANDED_MAX_WARPS;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPlanes = 7;  // pMM, pGapM, pMX, pMY, pZZ, distm-match, distm-mismatch
// bytes of shared memory before the carry row: a progress counter a warp,
// padded so the row is 16-byte aligned
constexpr size_t kHeadBytes = (sizeof(int) * kMaxWarps + 15) / 16 * 16;

template <int R, bool kSharedCarry>
__global__ void __launch_bounds__(kLanes * kMaxWarps)
pairhmm_plane_kernel(const float* __restrict__ planes, const int* __restrict__ rchar,
                     const int* __restrict__ rslen, const int* __restrict__ haps,
                     const int* __restrict__ haplen, const float* __restrict__ y_init,
                     const int64_t* __restrict__ ridx, const int64_t* __restrict__ hidx,
                     int plane_rows, int hap_cols, float2* carry, float* __restrict__ out) {
  constexpr int kBand = kLanes * R;  // read rows a band
  extern __shared__ __align__(16) unsigned char smem[];
  int* progress = reinterpret_cast<int*>(smem);  // [kMaxWarps]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int pair = blockIdx.x;

  const int64_t ri = ridx[pair];
  const int64_t hi = hidx[pair];
  const float* p = planes + ri * kPlanes * plane_rows;
  const int* rc = rchar + ri * plane_rows;
  const int* hp = haps + hi * hap_cols;
  const int rl = min(rslen[ri], plane_rows - 2);
  const int hl = min(haplen[hi], hap_cols);
  const float u0 = y_init[hi] * p[1 * plane_rows + 1];  // yInit * pGapM[1]
  float2* row = kSharedCarry ? reinterpret_cast<float2*>(smem + kHeadBytes)
                             : carry + static_cast<size_t>(pair) * hap_cols;

  if (threadIdx.x < kMaxWarps) progress[threadIdx.x] = 0;
  __syncthreads();

  const int n_bands = (rl + kBand - 1) / kBand;
  if (n_bands == 0) {  // an empty read scores 0
    if (threadIdx.x == 0) out[pair] = 0.0f;
    return;
  }
  const int n_steps = hl + kBand - 1;
  // a warp's counter reads k * span + x once its k-th band has written
  // slots 0 .. x-1 of the row
  const int span = hl + 1;
  // plane value k of row r; 0 at or past the planes' end
  auto plane = [&](int k, int r) { return r < plane_rows ? p[k * plane_rows + r] : 0.0f; };

  for (int b = warp, k = 0; b < n_bands; b += n_warps, ++k) {
    const bool top = b == 0;
    const int* above = progress + (b + n_warps - 1) % n_warps;
    const int above_done = top ? 0 : (b - 1) / n_warps * span;
    const int r0 = b * kBand + lane * R + 1;  // the lane's first row
    float pmm_u[R], pgapm_u[R], pmx_u[R], pmy[R], dm[R], dmm[R];
    float pzz[R + 1];  // pZZ of rows r0 .. r0 + R: pzz[j + 1] is sub-row j's next row
    int rch[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = r0 + j;
      pmm_u[j] = plane(0, r + 1);
      pgapm_u[j] = plane(1, r + 1);
      pmx_u[j] = plane(2, r + 1);
      pmy[j] = plane(3, r);
      pzz[j] = plane(4, r);
      dm[j] = plane(5, r);
      dmm[j] = plane(6, r);
      rch[j] = r < plane_rows ? rc[r] : 0;
    }
    pzz[R] = plane(4, r0 + R);

    // kLast: this band holds the read's last row, so one sub-row sums it
    auto sweep = [&](auto last_band) {
      constexpr bool kLast = decltype(last_band)::value;
      const int j_last = rl - r0;  // the sub-row of row rl, if in 0 .. R-1

      // (U, W) above slot s: row 0 for band 0, 0 past the hap's end
      auto above_at = [&](int s) -> float2 {
        if (top) return make_float2(u0, 0.0f);
        return s < hl ? row[s] : make_float2(0.0f, 0.0f);
      };
      // slot 32*chunk + 1 + lane: what lane 0's first sub-row takes on step
      // 32*chunk + lane.  Waits until the band above has written every
      // such slot inside the hap.
      auto stage = [&](int chunk, float2& suw, int& sh) {
        const int s = kLanes * chunk + 1 + lane;
        if (!top) wait_for(above, above_done + min(s - lane + kLanes, hl));
        suw = above_at(s);
        sh = s < hl ? hp[s] : 0;
      };
      float2 cur_uw, nxt_uw = make_float2(0.0f, 0.0f);
      int cur_h, nxt_h = 0;
      stage(0, cur_uw, cur_h);
      if (kLanes < n_steps) stage(1, nxt_uw, nxt_h);

      float m_un[R], y_un[R];    // M, Y of (r, c-1)
      float w_p[R], u_p[R];      // W, U of (r-1, c)
      float u_pp[R];             // U(r-1, c-1)
      int hd[R];                 // hap[c-1], one-hot
#pragma unroll
      for (int j = 0; j < R; ++j) {
        m_un[j] = y_un[j] = w_p[j] = u_p[j] = u_pp[j] = 0.0f;
        hd[j] = 0;
      }
      float acc = 0.0f;
      if (lane == 0) {  // column 1 from above, and the hap's first base
        const float2 uw = above_at(0);
        u_p[0] = uw.x;
        w_p[0] = uw.y;
        u_pp[0] = top ? u0 : 0.0f;
        hd[0] = hp[0];
      }

      // One step.  kSteady: 32R - 1 <= t < hl, so every sub-row's column
      // lies in 1 .. hl - no range checks, and lane 31 writes its slot.
      auto step = [&](int t, auto steady) {
        constexpr bool kSteady = decltype(steady)::value;
        float u[R], w[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float distm = (rch[j] & hd[j]) != 0 ? dm[j] : dmm[j];
          const float m = distm * u_pp[j];
          const float x = w_p[j];
          const float y = m_un[j] * pmy[j] + y_un[j] * pzz[j];
          if (kLast && j == j_last) {
            const int c = t + 1 - (lane * R + j);
            if (kSteady || (c >= 1 && c <= hl)) acc = acc + (m + x);
          }
          u[j] = m * pmm_u[j] + (x + y) * pgapm_u[j];
          w[j] = m * pmx_u[j] + x * pzz[j + 1];
          m_un[j] = m;
          y_un[j] = y;
        }

        // the last sub-row's cells one lane down; lane 0 takes the staged
        // slot
        float u_sh = __shfl_sync(kFull, u[R - 1], (lane + 31) & 31);
        float w_sh = __shfl_sync(kFull, w[R - 1], (lane + 31) & 31);
        int h_sh = __shfl_sync(kFull, hd[R - 1], (lane + 31) & 31);
        const float u_in = __shfl_sync(kFull, cur_uw.x, t & 31);
        const float w_in = __shfl_sync(kFull, cur_uw.y, t & 31);
        const int h_in = __shfl_sync(kFull, cur_h, t & 31);
        if (lane == kLanes - 1 && (kSteady || (t >= kBand - 1 && t - (kBand - 1) < hl)))
          row[t - (kBand - 1)] = make_float2(u[R - 1], w[R - 1]);
        if (lane == 0) {
          u_sh = u_in;
          w_sh = w_in;
          h_sh = h_in;
        }
        // each sub-row takes the one above it; sub-row 0 the lane above
#pragma unroll
        for (int j = R - 1; j > 0; --j) {
          u_pp[j] = u_p[j];
          u_p[j] = u[j - 1];
          w_p[j] = w[j - 1];
          hd[j] = hd[j - 1];
        }
        u_pp[0] = u_p[0];
        u_p[0] = u_sh;
        w_p[0] = w_sh;
        hd[0] = h_sh;
      };

      // Runs of steps between events: a chunk's end (after a step t with
      // t & 31 == 31: publish this band's slots, move to the staged chunk,
      // stage the one after it) and the change between edge and steady
      // steps (t = 32R - 1, t = hl).
      for (int t = 0; t < n_steps;) {
        int stop = min((t | 31) + 1, n_steps);
        if (t >= kBand - 1 && t < hl) {
          stop = min(stop, hl);
#pragma unroll 4
          for (; t < stop; ++t) step(t, std::true_type{});
        } else {
          if (t < kBand - 1) stop = min(stop, kBand - 1);
          for (; t < stop; ++t) step(t, std::false_type{});
        }
        if ((t & 31) == 0) {
          // slots written so far; never below 0, so the counter only grows
          // (a band's first chunks write none when R > 1)
          if (lane == kLanes - 1)
            store_release(progress + warp,
                          k * span + max(min(t - (kBand - 1), hl), 0));
          cur_uw = nxt_uw;
          cur_h = nxt_h;
          if (t + kLanes < n_steps) stage((t >> 5) + 1, nxt_uw, nxt_h);
        }
      }
      if (lane == kLanes - 1) store_release(progress + warp, k * span + hl);
      if (kLast && j_last >= 0 && j_last < R) out[pair] = acc;
    };
    if (b == n_bands - 1)
      sweep(std::true_type{});
    else
      sweep(std::false_type{});
    __syncwarp();
  }
}

size_t row_bytes(int hap_cols) { return sizeof(float2) * static_cast<size_t>(hap_cols); }

template <int R>
int launch(const void* planes, const void* rchar, const void* rslen, const void* haps,
           const void* haplen, const void* y_init, const void* ridx, const void* hidx,
           int n_pairs, int plane_rows, int hap_cols, int warps_per_pair,
           int row_in_shared, void* carry, void* out, void* stream) {
  const auto kernel =
      row_in_shared ? pairhmm_plane_kernel<R, true> : pairhmm_plane_kernel<R, false>;
  const size_t smem = kHeadBytes + (row_in_shared ? row_bytes(hap_cols) : 0);
  const cudaError_t e = allow_shared_memory(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_pairs, kLanes * warps_per_pair, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const int*>(rchar),
      static_cast<const int*>(rslen), static_cast<const int*>(haps),
      static_cast<const int*>(haplen), static_cast<const float*>(y_init),
      static_cast<const int64_t*>(ridx), static_cast<const int64_t*>(hidx), plane_rows,
      hap_cols, static_cast<float2*>(carry), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int placement(int n_pairs, int hap_cols, int warps_per_pair) {
  bool shared = false;
  const cudaError_t e = carry_in_shared(
      pairhmm_plane_kernel<R, false>, pairhmm_plane_kernel<R, true>, n_pairs,
      kLanes * warps_per_pair, kHeadBytes, row_bytes(hap_cols), &shared);
  return e != cudaSuccess ? -static_cast<int>(e) : static_cast<int>(shared);
}

bool valid(int warps_per_pair, int rows_per_lane) {
  return warps_per_pair >= 1 && warps_per_pair <= kMaxWarps &&
         (rows_per_lane == 2 || rows_per_lane == 4);
}

}  // namespace

// warps_per_pair is W, 1 to kMaxWarps; rows_per_lane is R, 2 or 4;
// row_in_shared is the answer of mgl_pairhmm_plane_carry_in_shared for
// this launch, and when it is 0, carry holds (hap_cols, 2) floats a pair
// for the row in global memory
extern "C" int mgl_pairhmm_plane_f32(const void* planes, const void* rchar,
                                     const void* rslen, const void* haps,
                                     const void* haplen, const void* y_init,
                                     const void* ridx, const void* hidx, int n_pairs,
                                     int plane_rows, int hap_cols, int warps_per_pair,
                                     int rows_per_lane, int row_in_shared, void* carry,
                                     void* out, void* stream) {
  if (!valid(warps_per_pair, rows_per_lane)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows_per_lane == 2)
    return launch<2>(planes, rchar, rslen, haps, haplen, y_init, ridx, hidx, n_pairs,
                     plane_rows, hap_cols, warps_per_pair, row_in_shared, carry, out, stream);
  return launch<4>(planes, rchar, rslen, haps, haplen, y_init, ridx, hidx, n_pairs, plane_rows,
                   hap_cols, warps_per_pair, row_in_shared, carry, out, stream);
}

// 1 if the carry row of this launch goes to shared memory, 0 if to global
// memory (band_pipeline.cuh: carry_in_shared), or minus a CUDA error code
extern "C" int mgl_pairhmm_plane_carry_in_shared(int n_pairs, int hap_cols,
                                                 int warps_per_pair, int rows_per_lane) {
  if (!valid(warps_per_pair, rows_per_lane)) return -static_cast<int>(cudaErrorInvalidValue);
  return rows_per_lane == 2 ? placement<2>(n_pairs, hap_cols, warps_per_pair)
                            : placement<4>(n_pairs, hap_cols, warps_per_pair);
}
