// Reference-window gather of the read mapper's verify stage, for Hopper.
//
// Replaces the XLA device function mgl_tpu/pipelines/mapper.py:
// _windowed_scores_fn (:757, inner fn :776), the gather in front of the
// banded SW kernel, not a Pallas kernel.  The reference lives on the card
// word-packed, 8 bases a 32-bit word, base 8w + j in nibble j of word w
// (4-bit codes: 0-3 ACGT, 4 ambiguous, 5 the pad past the end), either
// flat (one row) or as overlapping rows of row_words words.  A window of
// wlen bases starts at nibble s (0-7) of word w0 of its row: window base j
// is nibble (s + j) & 7 of word w0 + ((s + j) >> 3).  A read arrives as
// packed 4-bit codes, the high nibble of byte j >> 1 for even j and the
// low nibble for odd j; the pad nibble of an odd-length read is cut.  The
// outputs are what csrc/sw_banded.cu takes: (B, wlen) target codes and
// (B, L) query codes, one byte a base.
//
// One warp a window, kWarps windows a block: a warp's lanes stride over
// the window's wlen bases, then over its read's qlen bases.  Neighbouring
// lanes read the same word or the next one and write neighbouring bytes.
// Words are shifted as unsigned, so a word whose top nibble is 8 or more
// does not sign-extend.
//
// What bounds it on an H100: bytes.  Per window it reads (wlen + 7) / 8 +
// 1 words and ceil(L / 2) read bytes and writes wlen + L bytes; a base
// costs a few integer ops, far under the card's integer rate.  Two first
// designs were far from that (PERF.md section 6): one thread a base over the
// whole batch, which spent most of its time in the 64-bit division that
// found each thread's window, and one block of 128 threads a window,
// whose 131,072 short blocks a mapper chunk ran in ~60 waves of block
// turnover.  Writing one byte a lane keeps this one from the bound;
// fusing the gather into sw_banded's target load, so the codes never go
// to device memory, is the later step.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // windows a block

__global__ void __launch_bounds__(kWarps * 32)
    window_gather_kernel(const uint32_t* __restrict__ ref, const int* __restrict__ row,
                         const int* __restrict__ w0, const int* __restrict__ shift,
                         const uint8_t* __restrict__ packed, int64_t row_words, int n_windows,
                         int wlen, int qlen, int packed_cols, uint8_t* __restrict__ tgt,
                         uint8_t* __restrict__ qry) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= n_windows) return;  // the whole warp
  const int s = shift[b];
  const uint32_t* words =
      ref + (row == nullptr ? 0 : static_cast<int64_t>(row[b]) * row_words) + w0[b];
  uint8_t* t_out = tgt + static_cast<int64_t>(b) * wlen;
  for (int j = lane; j < wlen; j += 32) {
    const int t = s + j;
    t_out[j] = static_cast<uint8_t>((words[t >> 3] >> (4 * (t & 7))) & 0xFu);
  }
  const uint8_t* rd = packed + static_cast<int64_t>(b) * packed_cols;
  uint8_t* q_out = qry + static_cast<int64_t>(b) * qlen;
  for (int j = lane; j < qlen; j += 32) {
    const uint8_t byte = rd[j >> 1];
    q_out[j] = (j & 1) ? static_cast<uint8_t>(byte & 0xFu) : static_cast<uint8_t>(byte >> 4);
  }
}

}  // namespace

// ref: the packed reference words (flat when row is null, else rows of
// row_words words); row (blocked only), w0, shift: (n_windows,) int32
// window starts; packed: (n_windows, packed_cols) uint8 reads; tgt
// (n_windows, wlen) and qry (n_windows, qlen) uint8 outputs.  Launches on
// ``stream`` and returns cudaGetLastError().
extern "C" int mgl_window_gather(const void* ref, const void* row, const void* w0,
                                 const void* shift, const void* packed, int64_t row_words,
                                 int n_windows, int wlen, int qlen, int packed_cols, void* tgt,
                                 void* qry, void* stream) {
  if (n_windows < 1 || wlen < 1 || qlen < 1 || packed_cols < (qlen + 1) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_windows + kWarps - 1) / kWarps;
  window_gather_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ref), static_cast<const int*>(row),
      static_cast<const int*>(w0), static_cast<const int*>(shift),
      static_cast<const uint8_t*>(packed), row_words, n_windows, wlen, qlen, packed_cols,
      static_cast<uint8_t*>(tgt), static_cast<uint8_t*>(qry));
  return static_cast<int>(cudaGetLastError());
}
