// Host CIGAR decoder of the SW path (C ABI, loaded with ctypes).
//
// The port's copy of the banded decoder of mgl_tpu/native/src/mgl_native.cpp
// (decode_one, decode_batch_impl, cigar_decode_batch_banded): it walks the
// SW kernel's 4-bit traceback nibbles into run-length CIGARs with the
// reference's walk semantics (sw.cpp:149-255).  Only the per-pair banded
// layout is kept: it is the one csrc/sw_banded.cu writes.  Built with g++
// by mgl_tpu_torch/_build.py.
//
// Nibbles: bits0-1 move (0 diag, 1 INS, 2 DEL), bit2 E-extend, bit3
// F-extend.  Threading uses std::thread over an atomic work queue.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

namespace {

struct Seg { char state; int32_t len; };

int decode_one(
    const uint32_t* words,   // ONE pair: (nb*words_per_band, band_h) band-major
    int64_t word_row_stride, // elements between word rows
    int32_t tlen, int32_t qlen, int32_t strategy,
    int32_t max_t, int32_t max_q, int32_t seg_length, int32_t mqe_t,
    char* cigar_out, int32_t cigar_cap, int32_t* offset_out,
    int32_t band_h, int32_t words_per_band, int64_t sub_stride)
{
    // banded layout: band (i-1)/band_h, sublane s=(i-1)%band_h,
    // step t=(j-1)+s -> word band*words_per_band + t/8, nibble t%8;
    // sub_stride = elements between sublanes
    auto nib = [&](int32_t i, int32_t j) -> uint32_t {
        int32_t s = (i - 1) % band_h;
        int32_t t = (j - 1) + s;
        int64_t g = (int64_t)((i - 1) / band_h) * words_per_band + (t >> 3);
        return (words[g * word_row_stride + (int64_t)s * sub_stride]
                >> ((t & 7) * 4)) & 0xF;
    };

    int32_t I, J, seg = 0;
    // strategy codes: 1 SOFTCLIP, 2 INDEL, 4 LEADING_INDEL, 8 IGNORE
    if (strategy == 2) { I = tlen; J = qlen; }
    else if (strategy != 4) { I = max_t; J = max_q; seg = seg_length; }
    else { I = mqe_t; J = qlen; }

    std::vector<Seg> segs;
    segs.reserve(16);
    if (seg > 0 && strategy == 1) { segs.push_back({'S', seg}); seg = 0; }

    char state = 'M';
    for (;;) {
        uint32_t n = nib(I, J);
        char next_state;
        int32_t L;
        switch (n & 3) {
        case 2: {               // DEL run: walk E-extend bits upward
            L = 1;
            int32_t k = I;
            while (nib(k, J) & 4) { k--; L++; }
            next_state = 'D';
            I -= L;
            break;
        }
        case 1: {               // INS run: walk F-extend bits leftward
            L = 1;
            int32_t k = J;
            while (nib(I, k) & 8) { k--; L++; }
            next_state = 'I';
            J -= L;
            break;
        }
        default:
            next_state = 'M'; L = 1; I--; J--;
        }
        if (next_state == state) seg += L;
        else { segs.push_back({state, seg}); seg = L; state = next_state; }
        if (!(I > 0 && J > 0)) break;
    }

    int32_t offset;
    if (strategy == 1) {                       // SOFTCLIP
        segs.push_back({state, seg});
        if (J > 0) segs.push_back({'S', J});
        offset = I;
    } else if (strategy == 8) {                // IGNORE
        segs.push_back({state, seg + J});
        offset = I - J;
    } else {                                   // INDEL / LEADING_INDEL
        segs.push_back({state, seg});
        if (I > 0) segs.push_back({'D', I});
        else if (J > 0) segs.push_back({'I', J});
        offset = 0;
    }

    // emit reversed, skipping zero-length
    char* p = cigar_out;
    char* end = cigar_out + cigar_cap - 1;
    for (auto it = segs.rbegin(); it != segs.rend(); ++it) {
        if (it->len <= 0) continue;
        int wrote = snprintf(p, end - p, "%d%c", it->len, it->state);
        if (wrote < 0 || p + wrote >= end) return -1;
        p += wrote;
    }
    *p = 0;
    *offset_out = offset;
    return (int)(p - cigar_out);
}

void decode_batch_impl(
    int32_t n_pairs,
    const uint32_t* words, int64_t pair_stride, int64_t word_row_stride,
    const int32_t* tlen, const int32_t* qlen, int32_t strategy,
    const int32_t* max_t, const int32_t* max_q,
    const int32_t* seg_length, const int32_t* mqe_t,
    char* cigars_out, int32_t cigar_cap, int32_t* offsets_out,
    int32_t n_threads, int32_t band_h, int32_t words_per_band,
    int64_t sub_stride)
{
    std::atomic<int32_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int32_t i = next.fetch_add(1);
            if (i >= n_pairs) return;
            decode_one(words + (int64_t)i * pair_stride, word_row_stride,
                       tlen[i], qlen[i], strategy,
                       max_t[i], max_q[i], seg_length[i], mqe_t[i],
                       cigars_out + (int64_t)i * cigar_cap, cigar_cap,
                       offsets_out + i, band_h, words_per_band, sub_stride);
        }
    };
    if (n_threads <= 1) { worker(); return; }
    std::vector<std::thread> pool;
    for (int32_t k = 0; k < n_threads; k++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" void cigar_decode_batch_banded(
    int32_t n_pairs,
    const uint32_t* words,      // (n_pairs, nb*words_per_band, band_h)
    int64_t pair_stride,
    int64_t word_row_stride,    // = band_h
    const int32_t* tlen, const int32_t* qlen, int32_t strategy,
    const int32_t* max_t, const int32_t* max_q,
    const int32_t* seg_length, const int32_t* mqe_t,
    char* cigars_out, int32_t cigar_cap, int32_t* offsets_out,
    int32_t n_threads, int32_t band_h, int32_t words_per_band,
    int64_t sub_stride)
{
    decode_batch_impl(n_pairs, words, pair_stride, word_row_stride,
                      tlen, qlen, strategy, max_t, max_q, seg_length, mqe_t,
                      cigars_out, cigar_cap, offsets_out, n_threads,
                      band_h, words_per_band, sub_stride);
}
