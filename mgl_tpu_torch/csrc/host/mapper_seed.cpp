// Host seeding of the read mapper (C ABI, loaded with ctypes).
//
// The port's copy of the mapper's native seeding in
// mgl_tpu/native/src/mgl_native.cpp (kmer_scan_canonical,
// kmer_prefix_table, the read-coding helpers, map_seed_vote,
// exact_nm_batch, radix_sort_kmer_index), unchanged in meaning: the
// canonical k-mer index build, its 13-base prefix jump table, the fused
// seed -> lookup -> diagonal vote of a chunk of reads, and the exact tier's
// mismatch count (which here also reads a reverse-strand read the other
// way round, so the caller makes no oriented copy).  Each is bit-identical
// to the NumPy path of mgl_tpu_torch/pipelines/mapper.py, which the tests
// hold it against.
// Built with g++ by mgl_tpu_torch/_build.py beside the CIGAR decoder.
//
// Threading uses std::thread over an atomic work queue.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Single-pass canonical k-mer scan (k <= 16).  Rolls the forward value
// ((v << 2) | code, masked to 2k bits) and its reverse complement
// ((v >> 2) | (3 - code) << 2(k-1)) together, tracks the distance since
// the last ambiguous base for validity, and emits
// (min(fwd, rc), position, fwd <= rc) rows for every valid k-mer —
// exactly the rows the numpy _kmers/_rc_kmers/mask pipeline produces,
// without its log-doubling temporaries.  Returns the row count.
// ---------------------------------------------------------------------------

int64_t kmer_scan_canonical(int64_t ref_len, const uint8_t* code, int32_t k,
                            uint32_t* keys, uint32_t* pos, uint8_t* fwd)
{
    const uint32_t mask = (k == 16) ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1u);
    const int rc_shift = 2 * (k - 1);
    uint32_t fv = 0, rv = 0;
    int64_t run = 0, n = 0;
    for (int64_t i = 0; i < ref_len; i++) {
        const uint32_t c = code[i];
        if (c >= 4) {
            run = 0;
            continue;
        }
        fv = ((fv << 2) | c) & mask;
        rv = (rv >> 2) | ((3u - c) << rc_shift);
        if (++run >= k) {
            const uint32_t canon = fv < rv ? fv : rv;
            keys[n] = canon;
            pos[n] = (uint32_t)(i - k + 1);
            fwd[n] = fv <= rv;
            n++;
        }
    }
    return n;
}

// Prefix jump table over the SORTED key column: table[b] = number of
// keys whose (key >> shift) bucket is < b, so [table[p], table[p+1]) is
// bucket p's row range.  Counting over sorted keys walks the table
// monotonically (cache-resident), unlike np.bincount's int64 temp +
// 536 MB scatter.  table has buckets+1 uint32 entries (n < 2^32).
void kmer_prefix_table(int64_t n, const uint32_t* keys, int32_t shift,
                       int64_t buckets, uint32_t* table)
{
    std::memset(table, 0, (buckets + 1) * sizeof(uint32_t));
    for (int64_t i = 0; i < n; i++)
        table[(keys[i] >> shift) + 1]++;
    uint64_t sum = 0;
    for (int64_t b = 1; b <= buckets; b++) {
        sum += table[b];
        table[b] = (uint32_t)sum;
    }
}

// ---------------------------------------------------------------------------
// Fused seeding engine: seed k-mers -> canonical index lookup -> diagonal
// voting, one pass per read.  The exact single-core replacement for the
// NumPy pipeline mapper._seed_kmers + ReferenceIndex.lookup +
// mapper._vote_diagonals (two-strand canonical mode): that path makes ~14
// full-array passes per chunk (seed value build, prefix gathers, hit
// expansion via np.repeat, two np.unique sorts over millions of hit keys);
// here every read's <=S*max_hits hits stay in L1 and are voted in place.
// Outputs are bit-identical to the NumPy path (regression-tested), rows
// laid out like _vote_diagonals: forward rows [0,N) then reverse [N,2N).
// counts (2 int64, or NULL) gains the index entries the kept seeds
// returned into the vote and the valid seeds dropped for more than
// max_hits entries, as _vote_diagonals counts them.
// ---------------------------------------------------------------------------

static const uint8_t* code_table()
{
    static uint8_t t[256];
    static bool init = false;
    if (!init) {
        std::memset(t, 4, sizeof(t));
        const char* b = "ACGTacgt";
        for (int i = 0; i < 8; i++) t[(uint8_t)b[i]] = i & 3;
        init = true;
    }
    return t;
}

static inline uint32_t rc_kmer32(uint32_t v, int32_t k)
{
    v = ~v;
    v = ((v >> 2) & 0x33333333u) | ((v & 0x33333333u) << 2);
    v = ((v >> 4) & 0x0F0F0F0Fu) | ((v & 0x0F0F0F0Fu) << 4);
    v = __builtin_bswap32(v);
    return v >> (32 - 2 * k);
}

// Vote one row's diagonals: best bin (diag>>3) by count, ties -> largest
// bin; exact diagonal = most-supported diag inside the best bin, ties ->
// largest diag; runner-up = same rule over bins NOT adjacent to the winner.
// Mirrors mapper._best_locus's lexsort tie-breaking exactly.
static void vote_row(int64_t* d, int32_t n, int64_t ref_len,
                     int64_t* pos, int32_t* votes,
                     int32_t* votes2, int64_t* pos2)
{
    *pos = -1; *votes = 0; *votes2 = 0; *pos2 = -1;
    if (n == 0) return;
    std::sort(d, d + n);

    auto best_of = [&](bool skip_adj, int64_t win_bin,
                       int32_t* out_votes, int64_t* out_pos) {
        int32_t best_cnt = 0;
        int32_t bs = -1, be = -1;           // winning bin's [start, end)
        for (int32_t i = 0; i < n;) {
            const int64_t bin = d[i] >> 3;
            int32_t j = i;
            while (j < n && (d[j] >> 3) == bin) j++;
            const bool adj = skip_adj &&
                (bin - win_bin <= 1 && win_bin - bin <= 1);
            if (!adj && (j - i) >= best_cnt) {
                best_cnt = j - i; bs = i; be = j;
            }
            i = j;
        }
        if (best_cnt == 0) return (int64_t)(-(1ll << 60));
        // most-supported exact diagonal inside the winning bin
        int32_t dc = 0;
        int64_t dd = -1;
        for (int32_t i = bs; i < be;) {
            int32_t j = i;
            while (j < be && d[j] == d[i]) j++;
            if ((j - i) >= dc) { dc = j - i; dd = d[i]; }
            i = j;
        }
        *out_votes = best_cnt;
        *out_pos = (dd >= 0) ? (dd < ref_len ? dd : ref_len - 1) : -1;
        return d[bs] >> 3;                  // the winning bin id
    };

    const int64_t win_bin = best_of(false, 0, votes, pos);
    best_of(true, win_bin, votes2, pos2);
}

void map_seed_vote(
    int32_t n_reads, int32_t read_len,
    const uint8_t* reads,                 // (N, L) ASCII
    int32_t k, int32_t stride,
    const uint32_t* sorted_kmers,         // (M,) canonical values
    const uint32_t* positions,            // (M,) ref offsets
    const uint8_t* canon_fwd,             // (M,) fwd-is-canonical bits
    int64_t M,
    const uint32_t* ptable,               // (buckets+1,) or NULL
    int32_t pshift,
    int32_t max_hits, int64_t ref_len,
    int32_t n_threads,
    // outputs: 2N rows (forward rows then reverse rows)
    int64_t* pos, int32_t* votes, int32_t* votes2, int64_t* pos2,
    int64_t* counts)
{
    const uint8_t* ct = code_table();
    const int32_t S = (read_len - k) / stride + 1;
    std::atomic<int32_t> next(0);
    std::atomic<int64_t> n_hits(0), n_capped(0);
    const int32_t BLOCK = 256;

    auto worker = [&]() {
        int64_t hits = 0, capped = 0;
        std::vector<int64_t> fw, rc;
        fw.reserve((size_t)S * max_hits);
        rc.reserve((size_t)S * max_hits);
        // Per-read seed slots: the lookup chain (ptable -> sorted_kmers
        // -> positions/canon_fwd) is one dependent cache miss after
        // another into multi-GB tables at genome scale; staging all S
        // seeds per read with prefetches between stages keeps ~S
        // independent misses in flight instead of serializing them.
        // Outputs are byte-identical (same hits, same s/j order).
        struct Slot {
            uint32_t look;
            int64_t lo, hi;
            int32_t off;
            uint8_t valid, b_read;
        };
        std::vector<Slot> sl((size_t)S);
        for (;;) {
            const int32_t b0 = next.fetch_add(BLOCK);
            if (b0 >= n_reads) {
                n_hits += hits;
                n_capped += capped;
                return;
            }
            const int32_t b1 = b0 + BLOCK < n_reads ? b0 + BLOCK : n_reads;
            for (int32_t r = b0; r < b1; r++) {
                const uint8_t* rd = reads + (int64_t)r * read_len;
                fw.clear(); rc.clear();
                // stage A: decode k-mers, prefetch jump-table entries
                for (int32_t s = 0; s < S; s++) {
                    const int32_t off = s * stride;
                    uint32_t fv = 0;
                    bool valid = true;
                    for (int32_t j = 0; j < k; j++) {
                        const uint32_t c = ct[rd[off + j]];
                        if (c >= 4) { valid = false; break; }
                        fv = (fv << 2) | c;
                    }
                    sl[s].valid = valid;
                    if (!valid) continue;
                    const uint32_t rv = rc_kmer32(fv, k);
                    const uint32_t look = fv < rv ? fv : rv;
                    sl[s].look = look;
                    sl[s].b_read = fv <= rv;
                    sl[s].off = off;
                    if (ptable)
                        __builtin_prefetch(ptable + (look >> pshift));
                }
                // stage B: bucket ranges, prefetch the key scan window
                for (int32_t s = 0; s < S; s++) {
                    if (!sl[s].valid) continue;
                    if (ptable) {
                        const uint32_t p = sl[s].look >> pshift;
                        sl[s].lo = ptable[p]; sl[s].hi = ptable[p + 1];
                    } else {
                        sl[s].lo = 0; sl[s].hi = M;
                    }
                    if (sl[s].hi > sl[s].lo) {
                        __builtin_prefetch(sorted_kmers + sl[s].lo);
                        __builtin_prefetch(sorted_kmers + sl[s].lo + 16);
                    }
                }
                // stage C: narrow to the exact [lo, hi) run, prefetch
                // the payload rows it will gather
                for (int32_t s = 0; s < S; s++) {
                    if (!sl[s].valid) continue;
                    int64_t lo = sl[s].lo, hi = sl[s].hi;
                    const uint32_t look = sl[s].look;
                    if (hi - lo > 128) {
                        const uint32_t* a = sorted_kmers;
                        auto* l = std::lower_bound(a + lo, a + hi, look);
                        auto* u = std::upper_bound(l, a + hi, look);
                        lo = l - a; hi = u - a;
                    } else {
                        while (lo < hi && sorted_kmers[lo] < look) lo++;
                        int64_t e = lo;
                        while (e < hi && sorted_kmers[e] == look) e++;
                        hi = e;
                    }
                    const int64_t cnt = hi - lo;
                    if (cnt == 0 || cnt > max_hits) {
                        capped += cnt > max_hits;
                        sl[s].valid = 0;
                        continue;
                    }
                    hits += cnt;
                    sl[s].lo = lo; sl[s].hi = hi;
                    __builtin_prefetch(positions + lo);
                    __builtin_prefetch(canon_fwd + lo);
                }
                // stage D: gather hits (original order preserved)
                for (int32_t s = 0; s < S; s++) {
                    if (!sl[s].valid) continue;
                    const int32_t off = sl[s].off;
                    const bool b_read = sl[s].b_read != 0;
                    const int64_t roff = read_len - k - off;
                    for (int64_t j = sl[s].lo; j < sl[s].hi; j++) {
                        const int64_t hp = (int64_t)positions[j];
                        if ((canon_fwd[j] != 0) != b_read)   // reverse hit
                            rc.push_back(hp - roff);
                        else
                            fw.push_back(hp - off);
                    }
                }
                vote_row(fw.data(), (int32_t)fw.size(), ref_len,
                         pos + r, votes + r, votes2 + r, pos2 + r);
                vote_row(rc.data(), (int32_t)rc.size(), ref_len,
                         pos + n_reads + r, votes + n_reads + r,
                         votes2 + n_reads + r, pos2 + n_reads + r);
            }
        }
    };
    if (n_threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        for (int32_t t = 0; t < n_threads; t++) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    if (counts != nullptr) {
        counts[0] += n_hits.load();
        counts[1] += n_capped.load();
    }
}

// Mismatch count of each read vs the reference at its predicted start
// (the certified-diagonal / exact-tier input).  Read r of the count is row
// rows[r] of reads (row r where rows is null); where strand is given and
// strand[r] is 1, it is that row's reverse complement, base j being
// kRevComp[read[L - 1 - j]] - the bytes mapper.revcomp would have made,
// compared as they would have been.  Out-of-range columns are clamped to
// the last reference byte, matching the NumPy np.clip(rd_idx, 0,
// ref_len-1) gather exactly (those rows are edge-clipped and handled
// separately by the caller).
static const struct RevCompTable {
    uint8_t t[256];
    RevCompTable() : t() {
        const char* from = "ACGTacgtNn";
        const char* to = "TGCATGCANN";
        for (int i = 0; from[i]; i++) t[(uint8_t)from[i]] = (uint8_t)to[i];
    }
} kRevComp;

void exact_nm_batch(int32_t n, int32_t L, const uint8_t* reads,
                    const int64_t* rows, const int8_t* strand,
                    const uint8_t* ref, int64_t ref_len,
                    const int64_t* pos, int32_t* nm, int32_t n_threads)
{
    std::atomic<int32_t> next(0);
    const int32_t BLOCK = 1024;
    auto worker = [&]() {
        std::vector<uint8_t> flip(L);
        for (;;) {
            const int32_t b0 = next.fetch_add(BLOCK);
            if (b0 >= n) return;
            const int32_t b1 = b0 + BLOCK < n ? b0 + BLOCK : n;
            for (int32_t r = b0; r < b1; r++) {
                const uint8_t* rd =
                    reads + (rows == nullptr ? (int64_t)r : rows[r]) * L;
                if (strand != nullptr && strand[r] == 1) {
                    for (int32_t j = 0; j < L; j++)
                        flip[j] = kRevComp.t[rd[L - 1 - j]];
                    rd = flip.data();
                }
                const int64_t p = pos[r];
                int32_t bad = 0;
                if (p >= 0 && p + L <= ref_len) {
                    const uint8_t* rf = ref + p;
                    for (int32_t j = 0; j < L; j++) bad += rf[j] != rd[j];
                } else {
                    for (int32_t j = 0; j < L; j++) {
                        int64_t i = p + j;
                        if (i < 0) i = 0;
                        if (i >= ref_len) i = ref_len - 1;
                        bad += ref[i] != rd[j];
                    }
                }
                nm[r] = bad;
            }
        }
    };
    if (n_threads <= 1) { worker(); return; }
    std::vector<std::thread> pool;
    for (int32_t t = 0; t < n_threads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
}

void radix_sort_kmer_index(int64_t n, int32_t key_bits,
                           uint32_t* keys, uint32_t* pos, uint8_t* fwd)
{
    if (n <= 1) return;
    const int passes = (key_bits + 15) / 16;
    std::vector<uint32_t> kscr(n), pscr(n);
    std::vector<uint8_t> fscr(n);
    std::vector<int64_t> count(65536);
    uint32_t* ksrc = keys;        uint32_t* psrc = pos;
    uint8_t*  fsrc = fwd;
    uint32_t* kdst = kscr.data(); uint32_t* pdst = pscr.data();
    uint8_t*  fdst = fscr.data();

    for (int p = 0; p < passes; p++) {
        const int shift = 16 * p;
        std::memset(count.data(), 0, 65536 * sizeof(int64_t));
        for (int64_t i = 0; i < n; i++)
            count[(ksrc[i] >> shift) & 0xFFFF]++;
        bool constant = false;
        int64_t sum = 0;
        for (int b = 0; b < 65536; b++) {
            if (count[b] == n) { constant = true; break; }
            const int64_t c = count[b];
            count[b] = sum;
            sum += c;
        }
        if (constant) continue;  // digit identical everywhere: order kept
        for (int64_t i = 0; i < n; i++) {
            const int64_t d = count[(ksrc[i] >> shift) & 0xFFFF]++;
            kdst[d] = ksrc[i];
            pdst[d] = psrc[i];
            fdst[d] = fsrc[i];
        }
        std::swap(ksrc, kdst);
        std::swap(psrc, pdst);
        std::swap(fsrc, fdst);
    }
    if (ksrc != keys) {
        std::memcpy(keys, ksrc, n * sizeof(uint32_t));
        std::memcpy(pos, psrc, n * sizeof(uint32_t));
        std::memcpy(fwd, fsrc, n * sizeof(uint8_t));
    }
}


}  // extern "C"
