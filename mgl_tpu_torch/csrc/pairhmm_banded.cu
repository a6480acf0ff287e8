// Banded PairHMM forward for Hopper, one template for float and double.
//
// float replaces mgl_tpu/kernels/pairhmm_pallas.py:_pairhmm_banded_kernel
// (:175, wrapper pairhmm_pallas_banded :479): the main f32 pass, scores
// scaled by 2^120.  double replaces mgl_tpu/kernels/pairhmm_xf_pallas.py:
// _pairhmm_banded_xf_kernel (:61), the rescue tier for pairs under 1e-28:
// Hopper has native f64, so the TPU's (hi, lo, exponent) triples go, and
// scores are scaled by 2^1020 from the CTX_F64 tables.  A score below
// f64's range underflows to 0, as the reference's double kernel does.
//
// The recurrence, which the plain version (ops/pairhmm.py:forward_plain)
// computes too:
// * Pair b is read ridx[b] against hap hidx[b], so the product is expanded
//   here and not by a copy.  Lane s holds read row r = 32*k + s + 1 of
//   band k and on step t computes hap column c = t - s + 1, in
//   hl + 31 steps a band.  The next row's coefficients are pre-multiplied
//   into two streams (docs/DESIGN.md section 3):
//      U(r,c) = M(r,c)*pMM[r+1] + (X(r,c)+Y(r,c))*pGapM[r+1]
//      W(r,c) = M(r,c)*pMX[r+1] +  X(r,c)        *pZZ[r+1]
//   so M(r+1,c+1) = distm * U(r,c) and X(r+1,c) = W(r,c): the spec's op
//   order (mgl_tpu/ops/pairhmm.py:260-266) computed one step earlier, and
//   Y(r,c) = M(r,c-1)*pMY + Y(r,c-1)*pZZ.
// * One (U, W) row crosses the bands: lane 31 writes column c at slot
//   c - 1 (columns 1 .. hl), and lane 0 of the band below takes slot t + 1
//   on step t.  Past the hap's end that look-ahead reads 0 (those columns
//   reach no summed cell).  Band 0 reads U = yInit*pGapM[1], W = 0 (row
//   0); column 0 stays zero by itself.
// * The last-row (M + X) sum is kept by the one lane that holds the read's
//   last row, in ascending columns, as the spec sums it.
// * Built with --fmad=false and without -ftz: every product and sum is
//   rounded on its own and denormals are kept, like torch's elementwise
//   CUDA ops, so the kernel equals the plain torch forward bit for bit.
//
// Layout on the card, as pairhmm_shared.cu's (one segment, no
// checkpoints):
// * One block a pair, W warps (1 to MGL_BANDED_MAX_WARPS, chosen by the
//   wrapper); warp w runs bands w, w+W, ..., so the 5 bands of a 151 bp
//   read run side by side at W = 5, and a read of more than W bands wraps.
// * One carry row a pair, pipelined between the bands: at each 32-step
//   chunk's end lane 31 publishes how many slots of the row its band has
//   written (a release store to its warp's counter in shared memory);
//   before staging a chunk, the band below polls that counter with
//   acquire loads (band_pipeline.cuh).  A band reads a slot 32 steps
//   before it writes it, so one row serves any W, and a band runs ~96
//   steps behind the band above.
// * The row (a float2 or double2 a column: 3.4 or 6.7 KB at 420 columns)
//   lies in shared memory when that leaves each SM as many resident
//   blocks as the batch can use with it in global memory, else in global
//   memory (haps over ~14.5 kb in f64, ~29 kb in f32, cannot have it in
//   shared memory at all); band_pipeline.cuh decides, and the wrapper
//   asks once a shape.
// * Carry and hap off the step's critical path: each lane stages one slot
//   of the next 32 (U, W and the hap base) in registers a chunk ahead;
//   lane 0 takes its three on step t by shuffles from lane t & 31, which
//   depend on nothing the step computes.  Nothing on a step's dependency
//   chain loads from memory.  (Lane 0 reading the row from shared memory
//   two steps ahead, in place of the staged (U, W) and their four or two
//   shuffles, was timed on the card and was 1.4-1.7x slower: PERF.md.)
// * Two kinds of step: the first 31 and the last 31 of a band check the
//   column range and lane 31's write; the steps between (31 <= t < hl,
//   where every lane's column lies in 1 .. hl) check neither and run
//   unrolled by 4, in runs cut at each chunk's end.
//
// What bounds it on an H100: a step is 11 dependent operations (7
// multiplies, 4 adds) and, in f32, six shuffles; in f64 every shuffle of a
// double is two, so ten, and the FP64 pipe takes a warp's instruction in
// two clocks.  A steady step compiles (nvcc 12.9, sm_90a, row in shared
// memory, a band without the last row) to 36 SASS instructions in f64 -
// 7 DMUL, 4 DADD, 10 SHFL, 7 FSEL/SEL (distm and lane 0's inputs), one
// STS.128 and 7 integer and move ops - and to 28 in f32 (7 FMUL, 4 FADD,
// 6 SHFL, 4 SEL, one STS.64); the band with the last row adds two adds.
// With one warp a band the card holds 5 x 384 / 132 ~ 15 warps an SM at
// the rescue tier's shape (384 pairs of 151 x 420), ~4 a scheduler, so the
// schedulers' issue rate (4 x 36 instructions a step) sets the time, not
// one warp's chain; the ramp of the bands' ~96-step lags adds to it.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "band_pipeline.cuh"

namespace {

constexpr int kBand = 32;
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

// (U, W) of one column
template <typename T> struct UwOf;
template <> struct UwOf<float> { using type = float2; };
template <> struct UwOf<double> { using type = double2; };
template <typename T> using Uw = typename UwOf<T>::type;

template <typename T, bool kSharedCarry>
__global__ void __launch_bounds__(kBand * kMaxWarps)
pairhmm_banded_kernel(const T* __restrict__ planes, const int* __restrict__ rchar,
                      const int* __restrict__ rslen, const int* __restrict__ haps,
                      const int* __restrict__ haplen, const T* __restrict__ y_init,
                      const int64_t* __restrict__ ridx, const int64_t* __restrict__ hidx,
                      int plane_rows, int hap_cols, Uw<T>* carry, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* progress = reinterpret_cast<int*>(smem);  // [kMaxWarps]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int pair = blockIdx.x;

  const int64_t ri = ridx[pair];
  const int64_t hi = hidx[pair];
  const T* p = planes + ri * kPlanes * plane_rows;
  const int* rc = rchar + ri * plane_rows;
  const int* hp = haps + hi * hap_cols;
  const int rl = min(rslen[ri], plane_rows - 2);
  const int hl = min(haplen[hi], hap_cols);
  const T u0 = y_init[hi] * p[1 * plane_rows + 1];  // yInit * pGapM[1]
  Uw<T>* row = kSharedCarry ? reinterpret_cast<Uw<T>*>(smem + kHeadBytes)
                            : carry + static_cast<size_t>(pair) * hap_cols;

  if (threadIdx.x < kMaxWarps) progress[threadIdx.x] = 0;
  __syncthreads();

  const int n_bands = (rl + kBand - 1) / kBand;
  if (n_bands == 0) {  // an empty read scores 0
    if (threadIdx.x == 0) out[pair] = T(0);
    return;
  }
  const int n_steps = hl + kBand - 1;
  // a warp's counter reads k * span + x once its k-th band has written
  // slots 0 .. x-1 of the row
  const int span = hl + 1;

  for (int b = warp, k = 0; b < n_bands; b += n_warps, ++k) {
    const bool top = b == 0;
    const int* above = progress + (b + n_warps - 1) % n_warps;
    const int above_done = top ? 0 : (b - 1) / n_warps * span;
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

    // kLast: this band holds the read's last row, so one lane sums it
    auto sweep = [&](auto last_band) {
      constexpr bool kLast = decltype(last_band)::value;
      const bool is_last = kLast && r == rl;

      // (U, W) above slot s: row 0 for band 0, 0 past the hap's end
      auto above_at = [&](int s) -> Uw<T> {
        if (top) return {u0, T(0)};
        return s < hl ? row[s] : Uw<T>{T(0), T(0)};
      };
      // slot 32*chunk + 1 + lane: what lane 0 takes on step
      // 32*chunk + lane.  Waits until the band above has written every
      // such slot inside the hap.
      auto stage = [&](int chunk, Uw<T>& suw, int& sh) {
        const int s = kBand * chunk + 1 + lane;
        if (!top) wait_for(above, above_done + min(s - lane + kBand, hl));
        suw = above_at(s);
        sh = s < hl ? hp[s] : 0;
      };
      Uw<T> cur_uw, nxt_uw{T(0), T(0)};
      int cur_h, nxt_h = 0;
      stage(0, cur_uw, cur_h);
      if (kBand < n_steps) stage(1, nxt_uw, nxt_h);

      T m_un = T(0), y_un = T(0);                  // M, Y of (r, c-1)
      T w_p = T(0), u_p = T(0);                    // W, U of (r-1, c)
      T u_pp = (lane == 0 && top) ? u0 : T(0);     // U(r-1, c-1)
      int hd = 0;                                  // hap[c-1], one-hot
      T acc = T(0);
      if (lane == 0) {  // column 1 from above, and the hap's first base
        const Uw<T> uw = above_at(0);
        u_p = uw.x;
        w_p = uw.y;
        hd = hp[0];
      }

      // One step.  kSteady: 31 <= t < hl, so every lane's column lies in
      // 1 .. hl - no range checks, and lane 31 writes its slot.
      auto step = [&](int t, auto steady) {
        constexpr bool kSteady = decltype(steady)::value;
        const T distm = (rch & hd) != 0 ? dm : dmm;
        const T m = distm * u_pp;
        const T x = w_p;
        const T y = m_un * pmy + y_un * pzz;
        if (kLast && is_last) {
          const int c = t + 1 - lane;
          if (kSteady || (c >= 1 && c <= hl)) acc = acc + (m + x);
        }
        const T u = m * pmm_u + (x + y) * pgapm_u;
        const T w = m * pmx_u + x * pzz_u;

        // hand the new cells one lane down; lane 0 takes the staged slot
        T u_sh = __shfl_sync(kFull, u, (lane + 31) & 31);
        T w_sh = __shfl_sync(kFull, w, (lane + 31) & 31);
        int h_sh = __shfl_up_sync(kFull, hd, 1);
        const T u_in = __shfl_sync(kFull, cur_uw.x, t & 31);
        const T w_in = __shfl_sync(kFull, cur_uw.y, t & 31);
        const int h_in = __shfl_sync(kFull, cur_h, t & 31);
        if (lane == kBand - 1 && (kSteady || (t >= kBand - 1 && t - (kBand - 1) < hl)))
          row[t - (kBand - 1)] = Uw<T>{u, w};
        if (lane == 0) {
          u_sh = u_in;
          w_sh = w_in;
          h_sh = h_in;
        }
        m_un = m;
        y_un = y;
        w_p = w_sh;
        u_pp = u_p;
        u_p = u_sh;
        hd = h_sh;
      };

      // Runs of steps between events: a chunk's end (after a step t with
      // t & 31 == 31: publish this band's slots, move to the staged chunk,
      // stage the one after it) and the change between edge and steady
      // steps (t = 31, t = hl).
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
          if (lane == kBand - 1)
            store_release(progress + warp, k * span + min(t - (kBand - 1), hl));
          cur_uw = nxt_uw;
          cur_h = nxt_h;
          if (t + kBand < n_steps) stage((t >> 5) + 1, nxt_uw, nxt_h);
        }
      }
      if (lane == kBand - 1) store_release(progress + warp, k * span + hl);
      if (kLast && is_last) out[pair] = acc;
    };
    if (b == n_bands - 1)
      sweep(std::true_type{});
    else
      sweep(std::false_type{});
    __syncwarp();
  }
}

template <typename T>
size_t row_bytes(int hap_cols) {
  return sizeof(Uw<T>) * static_cast<size_t>(hap_cols);
}

// warps_per_pair is W, 1 to kMaxWarps; row_in_shared is the answer of
// mgl_pairhmm_banded_carry_in_shared for this launch, and when it is 0,
// carry holds (hap_cols, 2) values a pair for the row in global memory
template <typename T>
int launch(const void* planes, const void* rchar, const void* rslen, const void* haps,
           const void* haplen, const void* y_init, const void* ridx, const void* hidx,
           int n_pairs, int plane_rows, int hap_cols, int warps_per_pair,
           int row_in_shared, void* carry, void* out, void* stream) {
  if (warps_per_pair < 1 || warps_per_pair > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      row_in_shared ? pairhmm_banded_kernel<T, true> : pairhmm_banded_kernel<T, false>;
  const size_t smem = kHeadBytes + (row_in_shared ? row_bytes<T>(hap_cols) : 0);
  const cudaError_t e = allow_shared_memory(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_pairs, kBand * warps_per_pair, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(planes), static_cast<const int*>(rchar),
      static_cast<const int*>(rslen), static_cast<const int*>(haps),
      static_cast<const int*>(haplen), static_cast<const T*>(y_init),
      static_cast<const int64_t*>(ridx), static_cast<const int64_t*>(hidx), plane_rows,
      hap_cols, static_cast<Uw<T>*>(carry), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int placement(int n_pairs, int hap_cols, int warps_per_pair) {
  if (warps_per_pair < 1 || warps_per_pair > kMaxWarps)
    return -static_cast<int>(cudaErrorInvalidValue);
  bool shared = false;
  const cudaError_t e = carry_in_shared(
      pairhmm_banded_kernel<T, false>, pairhmm_banded_kernel<T, true>, n_pairs,
      kBand * warps_per_pair, kHeadBytes, row_bytes<T>(hap_cols), &shared);
  return e != cudaSuccess ? -static_cast<int>(e) : static_cast<int>(shared);
}

}  // namespace

extern "C" int mgl_pairhmm_banded_f32(const void* planes, const void* rchar,
                                      const void* rslen, const void* haps,
                                      const void* haplen, const void* y_init,
                                      const void* ridx, const void* hidx, int n_pairs,
                                      int plane_rows, int hap_cols, int warps_per_pair,
                                      int row_in_shared, void* carry, void* out,
                                      void* stream) {
  return launch<float>(planes, rchar, rslen, haps, haplen, y_init, ridx, hidx, n_pairs,
                       plane_rows, hap_cols, warps_per_pair, row_in_shared, carry, out,
                       stream);
}

extern "C" int mgl_pairhmm_banded_f64(const void* planes, const void* rchar,
                                      const void* rslen, const void* haps,
                                      const void* haplen, const void* y_init,
                                      const void* ridx, const void* hidx, int n_pairs,
                                      int plane_rows, int hap_cols, int warps_per_pair,
                                      int row_in_shared, void* carry, void* out,
                                      void* stream) {
  return launch<double>(planes, rchar, rslen, haps, haplen, y_init, ridx, hidx, n_pairs,
                        plane_rows, hap_cols, warps_per_pair, row_in_shared, carry, out,
                        stream);
}

// 1 if the carry row of this launch (f64 != 0: the double instance) goes
// to shared memory, 0 if to global memory (band_pipeline.cuh:
// carry_in_shared), or minus a CUDA error code
extern "C" int mgl_pairhmm_banded_carry_in_shared(int n_pairs, int hap_cols,
                                                  int warps_per_pair, int f64) {
  return f64 ? placement<double>(n_pairs, hap_cols, warps_per_pair)
             : placement<float>(n_pairs, hap_cols, warps_per_pair);
}
