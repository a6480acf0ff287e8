// Host side of the SW path (C ABI, loaded with ctypes).
//
// The port's copy of the CIGAR decoder and the ScoreMax scan of
// mgl_tpu/native/src/mgl_native.cpp (decode_one, decode_batch_impl,
// cigar_decode_batch, cigar_decode_batch_banded, score_max_batch): it
// walks the SW kernels' 4-bit traceback nibbles into run-length CIGARs
// with the reference's walk semantics (sw.cpp:149-255).  Two per-pair
// layouts: banded (csrc/sw_banded.cu) and plane (csrc/sw_plane.cu).  Built
// with g++ by mgl_tpu_torch/_build.py.
//
// Nibbles: bits0-1 move (0 diag, 1 INS, 2 DEL), bit2 E-extend, bit3
// F-extend.  Threading uses std::thread over an atomic work queue.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

struct Seg { char state; int32_t len; };

int decode_one(
    const uint32_t* words,   // ONE pair: (n_words, r1) plane, or
                             // (nb*words_per_band, band_h) band-major
    int64_t word_row_stride, // elements between word rows (r1 or band_h)
    int32_t tlen, int32_t qlen, int32_t strategy,
    int32_t max_t, int32_t max_q, int32_t seg_length, int32_t mqe_t,
    char* cigar_out, int32_t cigar_cap, int32_t* offset_out,
    int32_t band_h, int32_t words_per_band, int64_t sub_stride)
{
    // banded layout (band_h > 0): band (i-1)/band_h, sublane
    // s=(i-1)%band_h, step t=(j-1)+s -> word band*words_per_band + t/8,
    // nibble t%8; sub_stride = elements between sublanes.  Plane layout
    // (band_h == 0): diagonal k = i+j-2 -> word k/8 of row i, nibble k%8.
    auto nib = [&](int32_t i, int32_t j) -> uint32_t {
        if (band_h == 0) {
            int32_t k = i + j - 2;
            return (words[(int64_t)(k >> 3) * word_row_stride + i]
                    >> ((k & 7) * 4)) & 0xF;
        }
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

extern "C" void cigar_decode_batch(
    int32_t n_pairs,
    const uint32_t* words,      // (n_pairs, n_words, r1) contiguous
    int64_t pair_stride,        // = n_words * r1
    int64_t word_row_stride,    // = r1
    const int32_t* tlen, const int32_t* qlen, int32_t strategy,
    const int32_t* max_t, const int32_t* max_q,
    const int32_t* seg_length, const int32_t* mqe_t,
    char* cigars_out, int32_t cigar_cap, int32_t* offsets_out,
    int32_t n_threads)
{
    decode_batch_impl(n_pairs, words, pair_stride, word_row_stride,
                      tlen, qlen, strategy, max_t, max_q, seg_length, mqe_t,
                      cigars_out, cigar_cap, offsets_out, n_threads, 0, 0, 1);
}

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

// ScoreMax (ez) from per-diagonal last-column / last-row samples, with
// the reference's '>=' last-column rule and its last-row
// tie-closer-to-diagonal rule (sw.cpp:100-127).  Sample k of pair b is
// lc[b * pair_stride + k * diag_stride], diagonal k + 2.
extern "C" void score_max_batch(
    int32_t n_pairs,
    const int32_t* lc, const int32_t* lr,
    int64_t pair_stride, int64_t diag_stride,
    const int32_t* tlen, const int32_t* qlen,
    int32_t* mqe, int32_t* mqe_t,
    int32_t* max_, int32_t* max_t, int32_t* max_q, int32_t* seg_length)
{
    for (int32_t b = 0; b < n_pairs; b++) {
        const int32_t tl = tlen[b], ql = qlen[b];
        const int32_t* c = lc + (int64_t)b * pair_stride;
        const int32_t* r = lr + (int64_t)b * pair_stride;
        int32_t best = INT32_MIN, best_t = -1;
        for (int32_t i = 1; i <= tl; i++) {
            int32_t v = c[(int64_t)(i + ql - 2) * diag_stride];
            if (v >= best) { best = v; best_t = i; }
        }
        int32_t mx = best, mx_t = best_t, mx_q = ql, seg = 0;
        for (int32_t j = 1; j <= ql; j++) {
            int32_t v = r[(int64_t)(tl + j - 2) * diag_stride];
            if (v > mx || (v == mx && std::abs(tl - j) < std::abs(mx_t - mx_q))) {
                mx = v; mx_t = tl; mx_q = j; seg = ql - j;
            }
        }
        mqe[b] = best; mqe_t[b] = best_t;
        max_[b] = mx; max_t[b] = mx_t; max_q[b] = mx_q; seg_length[b] = seg;
    }
}
