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
// The sweep, which the plain version (ops/pairhmm.py:shared_forward_plain)
// computes too:
// * Lane s holds row r = 32*b + s + 1 of band b, with the read's planes in
//   registers.  A band runs the segments in order; segment j is hap j's
//   distinct suffix, columns pos_j+1 .. len_j, at stream slots base_j ..
//   base_j + len_j - pos_j - 1.  On step t of segment j lane s computes
//   column pos_j + t + 1 - s, in T_j = len_j - pos_j + 31 steps, with the
//   per-pair kernel's recurrence (csrc/pairhmm_banded.cu): pre-multiplied
//   U/W streams, M = distm * U(r-1,c-1), X = W(r-1,c),
//   Y = M(r,c-1)*pMY + Y(r,c-1)*pZZ.
// * Checkpoint and restore: at step ts_j = pos_{j+1} - pos_j every lane's
//   state (m, y, w_p, u_p, u_pp, hd, acc) is the state a full sweep of
//   hap j+1 holds there, since the two haps share columns <= pos_{j+1}.
//   Each lane saves it before that step (or after the segment when
//   ts == T) and segment j+1 starts from it; only lane 0's look-ahead
//   (u_p, w_p from the band above, and hd) comes from segment j+1's own
//   stream, at slot base_{j+1}.
// * The (U, W) row that crosses bands is indexed by stream slot: lane 31
//   writes slot base_j + t - 31 (column pos_j + t - 30) while that column
//   is in the segment, and lane 0 of the band below takes slot
//   base_j + t + 1 on step t.  Past the segment's end (columns above
//   len_j, which reach no summed cell and no checkpoint) that look-ahead
//   reads 0, not the next segment's slots, so no band reads a slot the
//   band above has not written.  Band 0 reads U = yInit*pGapM[1], W = 0.
// * The last-row (M + X) sum is kept by the lane holding the read's last
//   row, in ascending columns, and written at each segment's end by the
//   warp that runs the read's last band.
// * Built with --fmad=false and without -ftz, so it equals the plain
//   version bit for bit, and both equal the per-pair forward run with
//   yInit = y_shared for every hap.
//
// Layout on the card:
// * One block a read, W warps (1 to 24, chosen by the wrapper); warp w
//   runs bands w, w+W, ..., so the 5 bands of a 151 bp read run side by
//   side at W = 5, and a read of more than W bands wraps.
// * One carry row a read, pipelined between the bands: at each 32-step
//   chunk's end lane 31 publishes how many slots of the row its band has
//   written (a release store to its warp's counter in shared memory);
//   before staging a chunk, the band below polls that counter with
//   acquire loads.  A band reads a slot 32 steps before it writes it, so
//   one row serves any W, and a band runs ~95 steps behind the band above.
// * The row (one float2 a slot) lies in shared memory - 8 * (S + 34)
//   bytes a block, 17 KB at GATK's region shape - when that leaves each
//   SM as many resident blocks as the batch can use with it in global
//   memory, else in global memory (long hap sets: 24 haps of 1 kb with
//   resets is a row of ~129 KB); band_pipeline.cuh decides, and the
//   wrapper asks once a shape.  The shared row is 10-46% faster than the
//   global one at the engine's shapes (PERF.md).  The checkpoints (7
//   values a lane, saved and restored once a segment) sit in shared
//   memory too, which frees their registers.
// * Carry and hap stream off the step's critical path: each lane stages
//   one slot of the next 32 (U, W and the hap base) in registers a chunk
//   ahead, restarting at each segment's base; lane 0 takes its three on
//   step t by shuffles from lane t & 31, which depend on nothing the step
//   computes.
// * Two kinds of step: the first 31 of a segment and the last 31 check
//   the column range and lane 31's write; the steps between (31 <= t <
//   len_j, where every lane's column lies inside the segment) check
//   neither and run unrolled by 4, in runs cut at the checkpoint and at
//   each chunk's end, so no step tests for either.
//
// What bounds it on an H100: a step is ~11 dependent FP32 operations (7
// multiplies, 4 adds), six shuffles and a few selects, with no memory
// access on its chain - a chain one warp cannot hide, and one warp a read
// leaves 4 warps an SM at GATK's region shape (512 reads).  One warp a
// band puts 5 x 512 / 132 ~ 19 on each SM there, where the instruction
// rate (~30 a steady step) sets the time; small launches (32 reads) stay
// latency-bound.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "band_pipeline.cuh"

namespace {

constexpr int kBand = 32;
// at most this many warps a block, set by the build
// (_build.SHARED_MAX_WARPS, the one place that limit is written)
#ifndef MGL_SHARED_MAX_WARPS
#error "build with -DMGL_SHARED_MAX_WARPS (mgl_tpu_torch/_build.py)"
#endif
constexpr int kMaxWarps = MGL_SHARED_MAX_WARPS;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPlanes = 7;  // pMM, pGapM, pMX, pMY, pZZ, distm-match, distm-mismatch
// a warp's checkpoint in shared memory: 7 values a lane
constexpr int kCheck = 7 * kBand;

// ints of shared memory before the carry row: a progress counter a warp,
// then each of the block's warps' checkpoints
__host__ __device__ constexpr int head_ints(int warps) { return kMaxWarps + kCheck * warps; }
// slots of zero padding after the stream (the look-ahead past its end)
constexpr int kPad = kBand + 2;

template <bool kSharedCarry>
__global__ void __launch_bounds__(kBand * kMaxWarps)
pairhmm_shared_kernel(const float* __restrict__ planes, const int* __restrict__ rchar,
                      const int* __restrict__ rslen, const int* __restrict__ hstream,
                      const int* __restrict__ segtab, int plane_rows, int n_haps,
                      int stream_cols, float y_shared, float2* carry,
                      float* __restrict__ out) {
  extern __shared__ int smem[];
  int* progress = smem;  // [kMaxWarps]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int read = blockIdx.x;

  const float* p = planes + static_cast<size_t>(read) * kPlanes * plane_rows;
  const int* rc = rchar + static_cast<size_t>(read) * plane_rows;
  const int rl = min(rslen[read], plane_rows - 2);
  const float u0 = y_shared * p[1 * plane_rows + 1];  // yInit * pGapM[1]
  // the (U, W) row, one float2 a stream slot
  float2* row = kSharedCarry ? reinterpret_cast<float2*>(smem + head_ints(n_warps))
                             : carry + static_cast<size_t>(read) * stream_cols;
  float* o = out + static_cast<size_t>(read) * n_haps;
  const int* seg_base = segtab;
  const int* seg_pos = segtab + n_haps;
  const int* seg_len = segtab + 2 * n_haps;
  const int* seg_steps = segtab + 3 * n_haps;
  const int* seg_chk = segtab + 4 * n_haps;

  if (threadIdx.x < kMaxWarps) progress[threadIdx.x] = 0;
  __syncthreads();

  const int n_bands = (rl + kBand - 1) / kBand;
  // a warp's counter reads k * span + x once its k-th band has written
  // slots 0 .. x-1 of the row
  const int n_slots = stream_cols - kPad;
  const int span = n_slots + 1;

  for (int b = warp, k = 0; b < n_bands; b += n_warps, ++k) {
    const bool top = b == 0;
    const int* above = progress + (b + n_warps - 1) % n_warps;
    const int above_done = top ? 0 : (b - 1) / n_warps * span;
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

    // the checkpoint: this lane's wavefront state at the next hap's
    // shared-prefix boundary, saved once a segment (every segment saves
    // one, and the first has pos 0, so none is read unwritten)
    int* ck = smem + kMaxWarps + warp * kCheck + lane;

    // kLast: this band holds the read's last row, so one lane sums it
    auto sweep = [&](auto last_band) {
      constexpr bool kLast = decltype(last_band)::value;
      const bool is_last = kLast && r == rl;
      for (int j = 0; j < n_haps; ++j) {
        const int base = seg_base[j];
        const int pos = seg_pos[j];
        const int hl = seg_len[j];
        const int n_steps = seg_steps[j];
        const int chk = seg_chk[j];
        const int len = hl - pos;           // the segment's slots
        const int seg_end = base + len;     // base_{j+1}
        float2* seg_row = row + base;

        // (U, W) above slot s: 0 past the segment's end
        auto above_at = [&](int s) {
          return top ? make_float2(u0, 0.f) : (s < seg_end ? row[s] : make_float2(0.f, 0.f));
        };
        // slot base + 32*chunk + 1 + lane: what lane 0 takes on step
        // 32*chunk + lane.  Waits until the band above has written every
        // such slot inside the segment.
        auto stage = [&](int chunk, float2& suw, int& sh) {
          const int s = base + kBand * chunk + 1 + lane;
          if (!top) wait_for(above, above_done + min(s - lane + kBand, seg_end));
          suw = above_at(s);
          sh = hstream[min(s, stream_cols - 1)];
        };
        float2 cur_uw, nxt_uw = make_float2(0.f, 0.f);
        int cur_h, nxt_h = 0;
        stage(0, cur_uw, cur_h);
        if (kBand < n_steps) stage(1, nxt_uw, nxt_h);

        const bool fresh = pos == 0;
        float m_un = fresh ? 0.f : __int_as_float(ck[0 * kBand]);  // M of (r, c-1)
        float y_un = fresh ? 0.f : __int_as_float(ck[1 * kBand]);  // Y of (r, c-1)
        float w_p = fresh ? 0.f : __int_as_float(ck[2 * kBand]);   // W(r-1, c)
        float u_p = fresh ? 0.f : __int_as_float(ck[3 * kBand]);   // U(r-1, c)
        float u_pp = fresh ? ((lane == 0 && top) ? u0 : 0.f)       // U(r-1, c-1)
                           : __int_as_float(ck[4 * kBand]);
        int hd = fresh ? 0 : ck[5 * kBand];                        // hap[c-1], one-hot
        float acc = fresh ? 0.f : __int_as_float(ck[6 * kBand]);
        if (lane == 0) {                   // look-ahead from this segment's stream
          const float2 uw = above_at(base);
          u_p = uw.x;
          w_p = uw.y;
          hd = hstream[base];
        }
        const int ts = chk < 0 ? n_steps : min(max(chk, 0), n_steps);
        auto save = [&] {
          ck[0 * kBand] = __float_as_int(m_un);
          ck[1 * kBand] = __float_as_int(y_un);
          ck[2 * kBand] = __float_as_int(w_p);
          ck[3 * kBand] = __float_as_int(u_p);
          ck[4 * kBand] = __float_as_int(u_pp);
          ck[5 * kBand] = hd;
          ck[6 * kBand] = __float_as_int(acc);
        };

        // One step.  kSteady: 31 <= t < len, so every lane's column lies in
        // pos+1 .. len_j - no range checks, and lane 31 writes its slot.
        auto step = [&](int t, auto steady) {
          constexpr bool kSteady = decltype(steady)::value;
          const float distm = (rch & hd) != 0 ? dm : dmm;
          const float m = distm * u_pp;
          const float x = w_p;
          const float y = m_un * pmy + y_un * pzz;
          if (kLast && is_last) {
            const int c = pos + t + 1 - lane;
            if (kSteady || (c >= 1 && c <= hl)) acc = acc + (m + x);
          }
          const float u = m * pmm_u + (x + y) * pgapm_u;
          const float w = m * pmx_u + x * pzz_u;

          // hand the new cells one lane down; lane 0 takes the staged slot
          float u_sh = __shfl_sync(kFull, u, (lane + 31) & 31);
          float w_sh = __shfl_sync(kFull, w, (lane + 31) & 31);
          int h_sh = __shfl_up_sync(kFull, hd, 1);
          const float u_in = __shfl_sync(kFull, cur_uw.x, t & 31);
          const float w_in = __shfl_sync(kFull, cur_uw.y, t & 31);
          const int h_in = __shfl_sync(kFull, cur_h, t & 31);
          if (lane == kBand - 1 && (kSteady || (t >= kBand - 1 && t - (kBand - 1) < len)))
            seg_row[t - (kBand - 1)] = make_float2(u, w);
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

        // Runs of steps between events: the checkpoint (before step ts), a
        // chunk's end (after a step t with t & 31 == 31: publish this
        // band's slots, move to the staged chunk, stage the one after it)
        // and the change between edge and steady steps (t = 31, t = len).
        for (int t = 0; t < n_steps;) {
          if (t == ts) save();
          int stop = min((t | 31) + 1, n_steps);
          if (ts > t && ts < stop) stop = ts;
          if (t >= kBand - 1 && t < len) {
            stop = min(stop, len);
#pragma unroll 4
            for (; t < stop; ++t) step(t, std::true_type{});
          } else {
            if (t < kBand - 1) stop = min(stop, kBand - 1);
            for (; t < stop; ++t) step(t, std::false_type{});
          }
          if ((t & 31) == 0) {
            if (lane == kBand - 1)
              store_release(progress + warp, k * span + base + min(t - (kBand - 1), len));
            cur_uw = nxt_uw;
            cur_h = nxt_h;
            if (t + kBand < n_steps) stage((t >> 5) + 1, nxt_uw, nxt_h);
          }
        }
        if (ts == n_steps) save();
        if (lane == kBand - 1) store_release(progress + warp, k * span + seg_end);
        if (kLast && is_last) o[j] = acc;
      }
    };
    if (b == n_bands - 1)
      sweep(std::true_type{});
    else
      sweep(std::false_type{});
    __syncwarp();
  }
}

size_t head_bytes(int warps) { return sizeof(int) * head_ints(warps); }
size_t row_bytes(int stream_cols) { return sizeof(float2) * static_cast<size_t>(stream_cols); }

}  // namespace

// warps_per_read is W, 1 to kMaxWarps; row_in_shared is the answer of
// mgl_pairhmm_shared_carry_in_shared for this launch, and when it is 0,
// carry holds (stream_cols, 2) floats a read for the row in global memory
extern "C" int mgl_pairhmm_shared_f32(const void* planes, const void* rchar,
                                      const void* rslen, const void* hstream,
                                      const void* segtab, int n_reads, int plane_rows,
                                      int n_haps, int stream_cols, float y_shared,
                                      int warps_per_read, int row_in_shared, void* carry,
                                      void* out, void* stream) {
  if (warps_per_read < 1 || warps_per_read > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = row_in_shared ? pairhmm_shared_kernel<true> : pairhmm_shared_kernel<false>;
  const size_t smem = head_bytes(warps_per_read) + (row_in_shared ? row_bytes(stream_cols) : 0);
  const cudaError_t e = allow_shared_memory(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_reads, kBand * warps_per_read, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(planes), static_cast<const int*>(rchar),
      static_cast<const int*>(rslen), static_cast<const int*>(hstream),
      static_cast<const int*>(segtab), plane_rows, n_haps, stream_cols, y_shared,
      static_cast<float2*>(carry), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// 1 if the carry row of this launch goes to shared memory, 0 if to global
// memory (band_pipeline.cuh: carry_in_shared), or minus a CUDA error code
extern "C" int mgl_pairhmm_shared_carry_in_shared(int n_reads, int stream_cols,
                                                  int warps_per_read) {
  if (warps_per_read < 1 || warps_per_read > kMaxWarps)
    return -static_cast<int>(cudaErrorInvalidValue);
  bool shared = false;
  const cudaError_t e = carry_in_shared(
      pairhmm_shared_kernel<false>, pairhmm_shared_kernel<true>, n_reads,
      kBand * warps_per_read, head_bytes(warps_per_read), row_bytes(stream_cols), &shared);
  return e != cudaSuccess ? -static_cast<int>(e) : static_cast<int>(shared);
}
