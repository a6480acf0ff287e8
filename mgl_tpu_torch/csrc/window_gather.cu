// Reference-window gather of the read mapper's verify stage, for Hopper.
//
// Replaces the XLA device function mgl_tpu/pipelines/mapper.py:
// _windowed_scores_fn (:757, inner fn :776), the gather in front of the
// banded SW kernel, not a Pallas kernel.  The reference lives on the card
// word-packed, 8 bases a 32-bit word, base 8w + j in nibble j of word w
// (4-bit codes: 0-3 ACGT, 4 ambiguous, 5 the pad past the end), either
// flat (one row) or as overlapping rows of row_words words.  A window of
// wlen bases starts at nibble s (0-7) of word w0 of its row: window base j
// is nibble (s + j) & 7 of word w0 + ((s + j) >> 3).
//
// The reads arrive as the caller holds them: (n_reads, L) ASCII bytes,
// forward, one row a read.  Window b takes row read_row[b]; where rc[b] is
// set it takes that read's reverse complement, base j being read byte
// L - 1 - j.  Each byte is encoded here, as the mapper's encode() does on
// the host: ACGTacgt to 0-3, every other byte to 4; a reverse-complemented
// base c < 4 becomes 3 - c and 4 stays 4.  That is encode(revcomp(read))
// bit for bit, since revcomp maps ACGTacgt to TGCATGCA and every other
// byte to N or 0, both of which encode as 4.  So the host makes no
// oriented, encoded or packed copy of a chunk's reads: it uploads them
// once, and a read whose primary and competitor windows lie on other
// strands is read twice, each time the way round its window wants.  The
// outputs are what csrc/sw_banded.cu takes: (B, wlen) target codes and
// (B, L) query codes, one byte a base.
//
// One warp a window, kWarps windows a block: a warp's lanes stride over
// the window's wlen bases, then over its read's L bases.  Neighbouring
// lanes read the same word or the next one (the same 32 read bytes, in
// either order) and write neighbouring bytes.  Words are shifted as
// unsigned, so a word whose top nibble is 8 or more does not sign-extend.
//
// What bounds it on an H100: bytes.  Per window it reads (wlen + 7) / 8 +
// 1 words, its start indices, its read row and rc byte, and L read bytes,
// and writes wlen + L bytes; a base costs a few integer ops, far under
// the card's integer rate.  Reading ASCII costs L / 2 bytes a window more
// than the packed reads it replaced, which the host packed at ~100 ms a
// chunk.  Two first designs were far from the bound (PERF.md section 6):
// one thread a base over the whole batch, which spent most of its time in
// the 64-bit division that found each thread's window, and one block of
// 128 threads a window, whose 131,072 short blocks a mapper chunk ran in
// ~60 waves of block turnover.  Writing one byte a lane keeps this one
// from the bound; fusing the gather into sw_banded's target load, so the
// codes never go to device memory, is the later step.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // windows a block

// ACGTacgt -> 0-3, every other byte -> 4 (x | 0x20 is 'a' only for 'A'
// and 'a', and so on)
__device__ __forceinline__ uint32_t base_code(uint32_t x) {
  switch (x | 0x20u) {
    case 'a': return 0;
    case 'c': return 1;
    case 'g': return 2;
    case 't': return 3;
    default: return 4;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    window_gather_kernel(const uint32_t* __restrict__ ref, const int* __restrict__ ref_row,
                         const int* __restrict__ w0, const int* __restrict__ shift,
                         const uint8_t* __restrict__ reads, const int* __restrict__ read_row,
                         const uint8_t* __restrict__ rc, int64_t row_words, int n_windows,
                         int wlen, int qlen, uint8_t* __restrict__ tgt,
                         uint8_t* __restrict__ qry) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= n_windows) return;  // the whole warp
  const int s = shift[b];
  const uint32_t* words =
      ref + (ref_row == nullptr ? 0 : static_cast<int64_t>(ref_row[b]) * row_words) + w0[b];
  uint8_t* t_out = tgt + static_cast<int64_t>(b) * wlen;
  for (int j = lane; j < wlen; j += 32) {
    const int t = s + j;
    t_out[j] = static_cast<uint8_t>((words[t >> 3] >> (4 * (t & 7))) & 0xFu);
  }
  const uint8_t* rd = reads + static_cast<int64_t>(read_row[b]) * qlen;
  const bool flip = rc[b] != 0;
  uint8_t* q_out = qry + static_cast<int64_t>(b) * qlen;
  for (int j = lane; j < qlen; j += 32) {
    const uint32_t c = base_code(rd[flip ? qlen - 1 - j : j]);
    q_out[j] = static_cast<uint8_t>(flip && c < 4 ? 3 - c : c);
  }
}

}  // namespace

// ref: the packed reference words (flat when ref_row is null, else rows
// of row_words words); ref_row (blocked only), w0, shift: (n_windows,)
// int32 window starts; reads: (n_reads, qlen) uint8 ASCII; read_row:
// (n_windows,) int32 rows of reads, each under n_reads (not checked); rc:
// (n_windows,) uint8, non-zero for a reverse-complemented read; tgt
// (n_windows, wlen) and qry (n_windows, qlen) uint8 outputs.  Launches on
// ``stream`` and returns cudaGetLastError().
extern "C" int mgl_window_gather(const void* ref, const void* ref_row, const void* w0,
                                 const void* shift, const void* reads, const void* read_row,
                                 const void* rc, int64_t row_words, int n_windows, int wlen,
                                 int qlen, void* tgt, void* qry, void* stream) {
  if (n_windows < 1 || wlen < 1 || qlen < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_windows + kWarps - 1) / kWarps;
  window_gather_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ref), static_cast<const int*>(ref_row),
      static_cast<const int*>(w0), static_cast<const int*>(shift),
      static_cast<const uint8_t*>(reads), static_cast<const int*>(read_row),
      static_cast<const uint8_t*>(rc), row_words, n_windows, wlen, qlen,
      static_cast<uint8_t*>(tgt), static_cast<uint8_t*>(qry));
  return static_cast<int>(cudaGetLastError());
}
