"""Seed-and-extend read mapper (BASELINE.json config 4): score and CIGAR
mode.

The port of ``mgl_tpu/pipelines/mapper.py``: map reads to a reference
sequence, on the card unless the caller asks for ``device="cpu"``.

Stages:
1. **Index** (host, NumPy and the port's native seeding): sorted
   canonical k-mer table of the reference with a 13-base prefix jump
   table, built by the native scan and radix sort
   (``csrc/host/mapper_seed.cpp``).
2. **Seed** (host, vectorized): non-overlapping read k-mers -> candidate
   diagonals; majority vote picks a candidate position per read and a
   runner-up locus (native ``map_seed_vote``).
3. **Verify** (device): the reference lives on the card word-packed, 8
   bases a word; the window gather (``csrc/window_gather.cu``, the
   counterpart of the XLA gather at mapper.py:757) cuts each read's window
   there and feeds the banded SW kernel (``csrc/sw_banded.cu``) in
   score-only mode.  On ``device="cpu"`` their plain torch versions run.
4. **CIGARs** (``with_cigar=True``): a read whose kernel score equals its
   seeded diagonal's score is certified "<L>M"; the rest go through
   :func:`sw_cigar_windows` - the gather, ``sw_banded`` in traceback mode,
   the device CIGAR walk (``csrc/cigar_walk.cu``, counterpart of
   ``mgl_tpu/ops/cigar_device.py:47``) and the host's strategy tail, with
   the host decoder for walks that overflow their segment buffer.

Each native host function keeps its NumPy path beside it
(``_index_rows_numpy``, ``_prefix_table_numpy``,
``_seed_candidates_numpy``, ``_nm_at_numpy``): the path where the native
one does not apply, and what the tests hold it against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mgl_tpu_torch.core.params import STANDARD_NGS, OverhangStrategy
from mgl_tpu_torch.device import resolve_device
from mgl_tpu_torch.native import (cigar_decode_bulk_banded, exact_nm,
                                  kmer_index_rows, kmer_prefix_table,
                                  map_seed_vote)
from mgl_tpu_torch.ops.sw import BAND, EZ_KEYS, banded_layout
from mgl_tpu_torch.utils.metrics import METRICS

_CODE = np.full(256, 4, np.uint8)
for i, b in enumerate(b"ACGT"):
    _CODE[b] = i
    _CODE[ord(chr(b).lower())] = i


def encode(seq: np.ndarray) -> np.ndarray:
    """ASCII -> 2-bit codes (4 = ambiguous)."""
    return _CODE[np.asarray(seq, dtype=np.uint8)]


def _kmers(code: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All k-mers of a 2-bit coded sequence; returns (values, valid).

    Log-doubling combine (span-1 -> 2 -> 4 -> ... mers) does ceil(log2 k)
    full-array passes instead of k, in uint32 for k <= 16 - the index
    build at genome scale is memory-bandwidth-bound here."""
    n = len(code) - k + 1
    dtype = np.uint32 if k <= 16 else np.uint64
    if n <= 0:
        return np.zeros(0, dtype), np.zeros(0, bool)
    need = {p for p in (1 << j for j in range(k.bit_length())) if k & p}
    w = code.astype(dtype)                 # span-1 values per start
    spans = {1: w} if 1 in need else {}
    span = 1
    while span * 2 <= k:
        nxt = w[: len(w) - span] << dtype(2 * span)
        nxt |= w[span:]            # in-place: one temp, not two
        w = nxt
        span *= 2
        if span in need:
            spans[span] = w
    # binary decomposition of k: concatenate the power-of-two pieces
    acc, done = None, 0
    for s in sorted(spans, reverse=True):
        if done + s > k:
            continue
        arr = spans[s]
        if acc is None:
            acc = arr
        else:
            m = len(arr) - done
            acc = acc[:m] << dtype(2 * s)
            acc |= arr[done: done + m]
        done += s
        if done == k:
            break
    w = acc[:n]
    isn = (code >= 4).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(isn)])
    valid = (cs[k:] - cs[:-k]) == 0
    return w, valid


_PREFIX_BASES = 13                     # 4^13 = 67M jump-table buckets
_SCAN_WIDTH = 4                        # minimum in-bucket scan width; the
                                       # effective width scales with the
                                       # table's average bucket load (4x
                                       # the mean covers the Poisson tail)
                                       # so large references don't fall
                                       # back to binary search over a
                                       # multi-GB table for most lookups


@dataclasses.dataclass
class ReferenceIndex:
    """Sorted k-mer index of one reference sequence with a 13-base prefix
    jump table: lookups are O(1) direct addressing plus a short vectorized
    in-bucket scan (binary search over tens of millions of k-mers was the
    mapper's bottleneck at chromosome scale)."""

    k: int
    ref: np.ndarray              # ASCII uint8 (contigs N-joined)
    sorted_kmers: np.ndarray     # (M,) uint64 (canonical values when
                                 # canon_fwd is not None)
    positions: np.ndarray        # (M,) uint32 (int64 past 4.29 Gbp) -
                                 # ref offset of each kmer; all consumers
                                 # widen to int64 before arithmetic
    max_hits: int = 64
    prefix_table: np.ndarray | None = None   # (4^13 + 1,) int64 bucket starts
    canon_fwd: np.ndarray | None = None      # (M,) bool: ref fwd kmer is
                                             # its own canonical form
    contig_names: list | None = None
    contig_offsets: np.ndarray | None = None  # start of each contig in ref
    contig_lengths: np.ndarray | None = None
    # the word-packed reference on each device it was asked for, and
    # whether its layout is blocked (see _ref_device)
    _ref_dev: dict | None = None
    _ref_blocked: bool = False

    @staticmethod
    def build_multi(contigs: list[tuple[str, np.ndarray]], k: int = 16,
                    max_hits: int = 64) -> "ReferenceIndex":
        """Index several contigs as one coordinate space.  Contigs are
        joined with max(k, 48) ambiguous bases: k so no k-mer spans a
        boundary (the N-validity mask in _kmers drops them), 48 = 2x the
        default window_pad so an SW verify window at a contig end never
        reaches real bases of the next contig."""
        sep = np.full(max(k, 48), ord("N"), np.uint8)
        parts, names, offs, lens = [], [], [], []
        at = 0
        for name, seq in contigs:
            s = (np.frombuffer(bytes(seq), np.uint8)
                 if not isinstance(seq, np.ndarray) else seq.astype(np.uint8))
            names.append(name)
            offs.append(at)
            lens.append(len(s))
            parts.append(s)
            parts.append(sep)
            at += len(s) + len(sep)
        idx = ReferenceIndex.build(np.concatenate(parts), k=k,
                                   max_hits=max_hits)
        idx.contig_names = names
        idx.contig_offsets = np.asarray(offs, np.int64)
        idx.contig_lengths = np.asarray(lens, np.int64)
        return idx

    def locate(self, pos: np.ndarray):
        """Global positions -> (contig_id, local_pos); single-contig
        indexes report contig 0.  Unmapped (pos < 0) stays (-1, -1)."""
        pos = np.asarray(pos, np.int64)
        if self.contig_offsets is None:
            cid = np.where(pos >= 0, 0, -1)
            return cid, np.where(pos >= 0, pos, -1)
        cid = np.searchsorted(self.contig_offsets, pos, "right") - 1
        local = pos - self.contig_offsets[np.clip(cid, 0, None)]
        bad = pos < 0
        return np.where(bad, -1, cid), np.where(bad, -1, local)

    @staticmethod
    def build(ref_seq, k: int = 16, max_hits: int = 64) -> "ReferenceIndex":
        ref = np.frombuffer(bytes(ref_seq), np.uint8) if not isinstance(
            ref_seq, np.ndarray) else ref_seq.astype(np.uint8)
        code = encode(ref)
        # native fast path (k <= 16, offsets fit uint32 - covers the
        # human genome): one C pass emits canonical (value, position,
        # fwd-bit) rows, a fused stable radix sort orders them - no
        # log-doubling temporaries, no argsort, no gather passes.
        # Bit-identical to _index_rows_numpy (regression-tested).
        rows = kmer_index_rows(code, k)
        if rows is None:
            rows = _index_rows_numpy(code, k)
        vals, pos, fwd = rows
        if k <= 16:
            # 2k bits fit in 32: halves table memory and, more important,
            # the per-lookup gather bandwidth (the seeding bottleneck)
            vals = vals.astype(np.uint32, copy=False)
        ptable = None
        # the 4^13-entry jump table costs ~270 MB; only worth it once the
        # k-mer set is big enough that binary search is the bottleneck
        if k >= _PREFIX_BASES and len(vals) >= 1_000_000:
            shift = 2 * (k - _PREFIX_BASES)
            if vals.dtype == np.uint32:
                # single cache-friendly pass over the sorted keys
                ptable = kmer_prefix_table(vals, shift, 4 ** _PREFIX_BASES)
            if ptable is None:
                ptable = _prefix_table_numpy(vals, shift, 4 ** _PREFIX_BASES)
        return ReferenceIndex(k=k, ref=ref, sorted_kmers=vals,
                              positions=pos,
                              max_hits=max_hits, prefix_table=ptable,
                              canon_fwd=fwd)

    def lookup(self, kmer_vals: np.ndarray):
        """Hit index ranges [lo, hi) for a flat array of k-mer values."""
        kmer_vals = kmer_vals.astype(self.sorted_kmers.dtype, copy=False)
        if self.prefix_table is None:
            lo = np.searchsorted(self.sorted_kmers, kmer_vals, "left")
            hi = np.searchsorted(self.sorted_kmers, kmer_vals, "right")
            return lo, hi
        shift = kmer_vals.dtype.type(2 * (self.k - _PREFIX_BASES))
        pfx = (kmer_vals >> shift).astype(np.int64)
        plo = self.prefix_table[pfx].astype(np.int64)
        phi = self.prefix_table[pfx + 1].astype(np.int64)
        M = len(self.sorted_kmers)
        # in-bucket scan width: 4x the table's mean bucket load (capped)
        # so the binary-search fallback stays rare at genome scale
        W = int(np.clip(4 * M // 4 ** _PREFIX_BASES, _SCAN_WIDTH, 64))
        wide = (phi - plo) > W
        idx = plo[:, None] + np.arange(W, dtype=np.int64)[None, :]
        in_rng = idx < phi[:, None]
        vals = self.sorted_kmers[np.minimum(idx, M - 1)]
        lt = ((vals < kmer_vals[:, None]) & in_rng).sum(1)
        eq = ((vals == kmer_vals[:, None]) & in_rng).sum(1)
        lo = plo + lt
        hi = lo + eq
        if wide.any():   # repetitive prefixes: exact search on the few
            lo[wide] = np.searchsorted(self.sorted_kmers, kmer_vals[wide],
                                       "left")
            hi[wide] = np.searchsorted(self.sorted_kmers, kmer_vals[wide],
                                       "right")
        return lo, hi


def _index_rows_numpy(code: np.ndarray, k: int):
    """The index rows of a 2-bit coded reference by NumPy: (values,
    positions, fwd) sorted stably by value - canonical values and the
    forward bit for k <= 16, forward values and None above.  What the
    native kmer_index_rows is held against, and the path past it."""
    vals, valid = _kmers(code, k)
    # uint32 offsets reach 4.29 Gbp (human genome: 3.1 Gbp) at
    # half the table memory of int64; consumers widen on load
    pos_dtype = np.uint32 if len(code) < 2**32 else np.int64
    pos = np.nonzero(valid)[0].astype(pos_dtype)
    vals = vals[valid]
    fwd = None
    if k <= 16:
        # canonical k-mers: index min(kmer, rc(kmer)) plus a bit
        # for which form was the forward one - a single table
        # lookup then serves BOTH strands of a read (the lookup
        # gathers are the seeding bottleneck; this halves them)
        rcv = _rc_kmers(vals, k)
        fwd = vals <= rcv
        vals = np.minimum(vals, rcv)
    order = np.argsort(vals, kind="stable")
    vals = vals[order]
    pos = pos[order]
    if fwd is not None:
        fwd = fwd[order]
    return vals, pos, fwd


def _prefix_table_numpy(vals: np.ndarray, shift: int,
                        buckets: int) -> np.ndarray:
    """The prefix jump table by NumPy: table[b] = the number of sorted
    keys whose (key >> shift) is below b, uint32 under 2^32 keys, else
    int64 - what the native kmer_prefix_table is held against."""
    counts = np.bincount((vals >> vals.dtype.type(shift)).astype(np.int64),
                         minlength=buckets)
    ptable = np.zeros(buckets + 1, np.int64)
    np.cumsum(counts, out=ptable[1:])
    return ptable.astype(np.uint32 if len(vals) < 2**32 else np.int64)


_RC = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTacgtNn", b"TGCATGCANN"):
    _RC[_a] = _b


def revcomp(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of ASCII bases (vectorized; rows if 2-D)."""
    a = np.asarray(seq, np.uint8)
    return _RC[a[..., ::-1]]


def _seed_kmers(reads: np.ndarray, k: int, stride: int):
    """Forward-seed k-mer values/validity: (vals (N,S) u64, valid (N,S),
    offsets (S,))."""
    N, read_len = reads.shape
    offsets = np.arange(0, read_len - k + 1, stride, dtype=np.int32)
    code = encode(reads.reshape(-1)).reshape(N, read_len)
    vals = np.zeros((N, len(offsets)), np.uint64)
    valid = np.ones((N, len(offsets)), bool)
    for i in range(k):
        col = code[:, offsets + i]
        vals = (vals << np.uint64(2)) | col.astype(np.uint64)
        valid &= col < 4
    return vals, valid, offsets


def _rc_kmers(vals: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement k-mer values (k <= 16) by 2-bit-group reversal
    of the complement - the rc seeds of a read are a pure bit transform
    of its forward seeds, no second encode/shift pass needed."""
    v = (~vals.astype(np.uint64)).astype(np.uint32)
    v = ((v >> 2) & np.uint32(0x33333333)) | ((v & np.uint32(0x33333333)) << 2)
    v = ((v >> 4) & np.uint32(0x0F0F0F0F)) | ((v & np.uint32(0x0F0F0F0F)) << 4)
    v = v.byteswap()
    # stay in uint32: the index build sorts/permutes these values at
    # genome scale, and a uint64 upcast here (via np.minimum with the
    # forward values) doubles the radix-sort and gather traffic - ~35%
    # of the whole build time at 64 Mbp
    return v >> np.uint32(32 - 2 * k)


def _vote_diagonals(index: ReferenceIndex, read_len: int,
                    vals: np.ndarray, valid: np.ndarray,
                    seed_off: np.ndarray,
                    rc_seed_off: np.ndarray | None = None):
    """Diagonal voting over precomputed seed k-mers.

    vals/valid: (N, S) FORWARD seed values; seed_off: (S,) or (N, S) read
    offsets of each seed.  Returns (pos, votes, votes2, pos2): per read
    the exact best diagonal (the most-supported single diagonal inside
    the winning +-8 bin), its vote count, the runner-up locus' count, and
    the runner-up's exact diagonal (-1 if none) - the competitor the
    verify stage rescores for score-based MAPQ.

    On a canonical index, one lookup serves both strands: each hit's
    strand is ``ref_fwd_bit != read_fwd_bit``.  With ``rc_seed_off``
    (two-strand mode) the results come back as 2N rows - forward rows
    then reverse rows, hit diagonals computed with the matching strand's
    seed offsets.  Without it, reverse-strand hits are dropped.
    """
    N, S = vals.shape
    if seed_off.ndim == 1:
        seed_off = np.broadcast_to(seed_off[None, :], (N, S))
    canonical = index.canon_fwd is not None
    if canonical:
        rc_vals = _rc_kmers(vals, index.k)
        b_read = (vals <= rc_vals).reshape(-1)
        look = np.minimum(vals, rc_vals)
    else:
        if rc_seed_off is not None:
            raise ValueError("two-strand single-lookup needs a canonical "
                             "index")
        look = vals

    lo, hi = index.lookup(look.reshape(-1))
    cnt = hi - lo
    keep = (cnt > 0) & (cnt <= index.max_hits) & valid.reshape(-1)
    lo, hi = lo[keep], hi[keep]
    seed_read = np.repeat(np.arange(N, dtype=np.int64), S)[keep]
    seed_off = seed_off.reshape(-1)[keep]

    n_rows = 2 * N if rc_seed_off is not None else N
    pos = np.full(n_rows, -1, np.int64)
    votes = np.zeros(n_rows, np.int32)
    votes2 = np.zeros(n_rows, np.int32)
    total = int((hi - lo).sum())
    if total == 0:
        return pos, votes, votes2, pos.copy()
    reps = (hi - lo).astype(np.int64)
    flat_idx = np.repeat(lo, reps) + (
        np.arange(total) - np.repeat(np.cumsum(reps) - reps, reps))
    hit_pos = index.positions[flat_idx].astype(np.int64)
    hit_read = np.repeat(seed_read, reps)
    hit_off = np.repeat(seed_off, reps)
    if canonical:
        strand = index.canon_fwd[flat_idx] != np.repeat(b_read[keep], reps)
        if rc_seed_off is None:
            hit_read = hit_read[~strand]
            hit_diag = hit_pos[~strand] - hit_off[~strand]
        else:
            if rc_seed_off.ndim == 1:
                rc_seed_off = np.broadcast_to(rc_seed_off[None, :], (N, S))
            hit_roff = np.repeat(rc_seed_off.reshape(-1)[keep], reps)
            hit_read = hit_read + N * strand
            hit_diag = hit_pos - np.where(strand, hit_roff, hit_off)
    else:
        hit_diag = hit_pos - hit_off            # candidate read start
    if len(hit_read) == 0:
        return pos, votes, votes2, pos.copy()
    N = n_rows

    # vote: most-supported diagonal bin per read (+-indel tolerance //8),
    # then the runner-up = best bin among hits NOT adjacent to the winner
    # (adjacent bins are support for the same locus, not competition).
    # The second pass scans every non-adjacent hit, so a competitor can't
    # hide behind same-locus bins - and its exact diagonal comes back too,
    # which the verify stage rescoring (score-based MAPQ) needs.
    p1, votes[:], bins = _best_locus(hit_read, hit_diag, N)
    pos[:] = np.where(p1 >= 0, np.clip(p1, 0, len(index.ref) - 1), -1)
    adj = np.abs(hit_diag // 8 - bins[hit_read]) <= 1
    p2, votes2[:], _ = _best_locus(hit_read[~adj], hit_diag[~adj], N)
    pos2 = np.where(p2 >= 0, np.clip(p2, 0, len(index.ref) - 1), -1)
    return pos, votes, votes2, pos2


def _best_locus(hit_read: np.ndarray, hit_diag: np.ndarray, N: int):
    """Most-supported diagonal bin per read plus the most-supported exact
    diagonal inside it.  Returns (pos, votes, bins): best diagonal (int64,
    -1 where no hits), its bin's vote count, and the winning bin id
    (sentinel -2^60 where none)."""
    pos = np.full(N, -1, np.int64)
    votes = np.zeros(N, np.int32)
    bins = np.full(N, np.int64(-(1 << 60)))
    if len(hit_read) == 0:
        return pos, votes, bins
    diag_bin = hit_diag // 8
    key = hit_read * np.int64(1 << 40) + (diag_bin + np.int64(1 << 32))
    uniq, counts = np.unique(key, return_counts=True)
    u_read = (uniq >> 40).astype(np.int64)
    u_bin = (uniq & np.int64((1 << 40) - 1)) - np.int64(1 << 32)
    order = np.lexsort((counts, u_read))
    u_read_s, u_bin_s, counts_s = u_read[order], u_bin[order], counts[order]
    last = np.nonzero(np.diff(np.concatenate([u_read_s, [-1]])) != 0)[0]
    best_read = u_read_s[last]
    bins[best_read] = u_bin_s[last]
    votes[best_read] = counts_s[last].astype(np.int32)

    # exact diagonal: most-supported single diagonal within the best bin
    in_best = diag_bin == bins[hit_read]
    hr, hd = hit_read[in_best], hit_diag[in_best]
    dkey = hr * np.int64(1 << 40) + (hd + np.int64(1 << 32))
    du, dc = np.unique(dkey, return_counts=True)
    dr = (du >> 40).astype(np.int64)
    dd = (du & np.int64((1 << 40) - 1)) - np.int64(1 << 32)
    dorder = np.lexsort((dc, dr))
    dlast = np.nonzero(np.diff(np.concatenate([dr[dorder], [-1]])) != 0)[0]
    pos[dr[dorder][dlast]] = dd[dorder][dlast]
    return pos, votes, bins


def seed_candidates(index: ReferenceIndex, reads: np.ndarray,
                    read_len: int, stride: int | None = None,
                    both_strands: bool = False, full: bool = False):
    """Vectorized candidate position per read by diagonal voting.

    reads: (N, read_len) ASCII.  Returns (pos, votes) or, with
    ``both_strands``, (pos, votes, strand, votes2): best reference offset
    (int64, -1 if unmapped; the *exact* winning diagonal, not a bin
    estimate), its vote count, the winning strand (0 forward / 1
    reverse-complement), and the best competing vote count across both
    strands and non-adjacent diagonals (the MAPQ denominator).

    ``full=True`` (with both_strands) appends (pos2, strand2): the
    runner-up locus' diagonal and strand (-1/-1 if no competitor) - what
    the verify stage rescores for score-based MAPQ.
    """
    stride = stride or index.k
    if both_strands and index.canon_fwd is not None:
        # fused native seeding (seed kmers + lookup + vote in one pass per
        # read; bit-identical to _seed_candidates_numpy) - the host-side
        # hot path at scale
        rows = map_seed_vote(reads, index, stride)
        if rows is not None:
            pos, votes, votes2, p2 = rows
            return _combine_strand_rows(pos, votes, votes2, p2,
                                        reads.shape[0], full)
    return _seed_candidates_numpy(index, reads, read_len, stride,
                                  both_strands, full)


def _seed_candidates_numpy(index: ReferenceIndex, reads: np.ndarray,
                           read_len: int, stride: int | None = None,
                           both_strands: bool = False, full: bool = False):
    """:func:`seed_candidates` by the NumPy pipeline (_seed_kmers,
    ReferenceIndex.lookup, _vote_diagonals): what the native
    map_seed_vote is held against, and the path where it does not
    apply."""
    stride = stride or index.k
    k = index.k
    N = reads.shape[0]
    fvals, fvalid, offsets = _seed_kmers(reads, k, stride)
    if not both_strands:
        pos, votes, _, _ = _vote_diagonals(index, read_len, fvals, fvalid,
                                           offsets)
        return pos, votes
    if index.canon_fwd is not None:
        # canonical index: ONE lookup serves both strands (hits split by
        # the stored forward bit); rc-read offset of forward seed j is
        # L - k - offsets[j]
        roff = (read_len - k - offsets).astype(np.int32)
        pos, votes, votes2, p2 = _vote_diagonals(index, read_len, fvals,
                                                 fvalid, offsets,
                                                 rc_seed_off=roff)
    else:
        # rc seeds by bit transform: seed j of the rc read covers forward
        # offset offsets[S-1-j], i.e. rc-read offset L - k - offsets[S-1-j]
        if k <= 16:
            rvals = _rc_kmers(fvals[:, ::-1], k)
            rvalid = fvalid[:, ::-1]
            roff = (read_len - k - offsets[::-1]).astype(np.int32)
        else:  # wide k-mers: recompute on the rc reads
            rvals, rvalid, roff = _seed_kmers(revcomp(reads), k, stride)
        vals = np.concatenate([fvals, rvals], axis=0)
        valid = np.concatenate([fvalid, rvalid], axis=0)
        seed_off = np.concatenate(
            [np.broadcast_to(offsets[None, :], fvals.shape),
             np.broadcast_to(roff[None, :], rvals.shape)], axis=0)
        pos, votes, votes2, p2 = _vote_diagonals(index, read_len, vals,
                                                 valid, seed_off)
    return _combine_strand_rows(pos, votes, votes2, p2, N, full)


def _combine_strand_rows(pos, votes, votes2, p2, N, full):
    """Fold the 2N per-strand vote rows (forward rows then reverse rows)
    into per-read outputs: winning strand, best/second vote counts, and
    (with ``full``) the runner-up locus the verify stage rescores."""
    fw, rc = slice(0, N), slice(N, 2 * N)
    rc_wins = votes[rc] > votes[fw]
    strand = rc_wins.astype(np.int8)
    best_pos = np.where(rc_wins, pos[rc], pos[fw])
    best_votes = np.where(rc_wins, votes[rc], votes[fw])
    within = np.where(rc_wins, votes2[rc], votes2[fw])
    other = np.where(rc_wins, votes[fw], votes[rc])
    second = np.maximum(within, other).astype(np.int32)
    if not full:
        return best_pos, best_votes, strand, second
    # runner-up locus: the winning strand's non-adjacent runner-up vs the
    # LOSING strand's best - whichever has more support
    within_pos = np.where(rc_wins, p2[rc], p2[fw])
    other_pos = np.where(rc_wins, pos[fw], pos[rc])
    use_other = other > within
    pos2 = np.where(use_other, other_pos, within_pos)
    strand2 = np.where(use_other, 1 - strand, strand).astype(np.int8)
    strand2 = np.where(pos2 >= 0, strand2, -1).astype(np.int8)
    return best_pos, best_votes, strand, second, pos2, strand2


def mapq_from_votes(votes: np.ndarray, votes2: np.ndarray,
                    max_votes: int | None = None) -> np.ndarray:
    """Mapping quality from best-vs-second-best seed support.

    A repeat-aware gap model (the reference library has no mapper; this
    follows the minimap2-style shape): full confidence needs both a
    clear margin over the runner-up locus and enough absolute support.
    """
    v1 = np.asarray(votes, np.float64)
    v2 = np.asarray(votes2, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(v1 > 0, (v1 - v2) / np.maximum(v1, 1), 0.0)
    conf = np.minimum(1.0, v1 / 4.0)
    q = 60.0 * frac * conf
    return np.clip(np.rint(q), 0, 60).astype(np.int32)


def mapq_rescore(score1: np.ndarray, score2: np.ndarray, votes: np.ndarray,
                 params) -> np.ndarray:
    """Mapping quality from the SW score gap of the two best loci.

    Seed votes saturate (~9 non-overlapping seeds/read), so a
    near-duplicate locus one seed short of the winner still leaves a
    large vote fraction - vote-only MAPQ overcalls on repeats.  Here the
    verify stage has SW-scored BOTH loci, and confidence comes from the
    score deficit of the runner-up: one substitution costs
    ``match - mismatch`` score units and is worth ~6 phred of
    discrimination at typical sequencing error rates (the BWA-MEM scale,
    mapq ~ 6 * (s1-s2)/a), so

        mapq = clip(6 * (score1 - score2) / (match - mismatch), 0, 60)

    scaled by the absolute-support prior min(1, votes/4) - votes act as
    a prior only; the score gap is the evidence.  An exact repeat
    (score2 == score1) maps to 0 regardless of votes.
    """
    c = float(params.match) - float(params.mismatch)
    delta = np.asarray(score1, np.float64) - np.asarray(score2, np.float64)
    conf = np.minimum(1.0, np.asarray(votes, np.float64) / 4.0)
    q = 6.0 * np.maximum(delta, 0.0) / max(c, 1.0) * conf
    return np.clip(np.rint(q), 0, 60).astype(np.int32)



def _exact_tier(windows: np.ndarray, rsub: np.ndarray, window_pad: int,
                wlen: int, L: int, clipped: np.ndarray | None = None):
    """Exact-match fast tier: returns (exact mask, per-read window offset,
    -1 where inexact).  A read equal to a window substring provably attains
    the SW optimum (read_len * match), so SW verification is redundant.
    The diagonal-vote bin bounds the candidate offsets to [pad, pad+8);
    windows clipped at a reference edge can hold the hit anywhere, so the
    still-unmatched clipped ones get a full-range scan."""
    exact = np.zeros(len(rsub), bool)
    exact_o = np.full(len(rsub), -1, np.int64)

    def scan(cand: np.ndarray, offsets):
        for o in offsets:
            m = cand & ~exact
            m[m] = (windows[m, o: o + L] == rsub[m]).all(axis=1)
            exact_o[m] = o
            exact[m] = True

    allc = np.ones(len(rsub), bool)
    scan(allc, range(window_pad, min(window_pad + 8, wlen - L + 1)))
    if clipped is not None and (clipped & ~exact).any():
        scan(clipped, range(0, wlen - L + 1))
    return exact, exact_o


def map_reads(index: ReferenceIndex, reads: np.ndarray,
              window_pad: int = 24, params=None, strategy=None,
              with_cigar: bool = False,
              device: str | torch.device = "cuda"):
    """Full map: seed -> window extract -> SW verify of each read's
    window, gathered on ``device``.

    Returns dict with pos (candidate window start), score (SW best score),
    votes, votes2, strand, mapq, offset (window offset where the exact
    tier pinned it) and window_pad (unmapped: pos=-1).  ``with_cigar``
    adds cigar, each mapped read's CIGAR and offset from
    :func:`sw_cigar_windows` under ``strategy`` (default SOFTCLIP), with
    score 0 (as ``mgl_tpu``'s device path gives it); score mode does not
    read ``strategy``.

    Read and reference bases are compared as 4-bit codes (:func:`encode`),
    so a lowercase base matches its uppercase one, as on the JAX package's
    TPU route (``impl="pallas"``, its mapper.py:757); its XLA route
    (``impl="xla"``) compares ASCII and scores 'a' against 'A' as a
    mismatch.  :func:`map_reads_stream` compares the same way.
    """
    dev = resolve_device(device)
    params = params or STANDARD_NGS
    strategy = strategy or OverhangStrategy.SOFTCLIP
    N, L = reads.shape
    pos, votes, strand, votes2 = seed_candidates(index, reads, L,
                                                 both_strands=True)
    mapped = np.nonzero(pos >= 0)[0]

    out = {
        "pos": np.full(N, -1, np.int64),
        "score": np.full(N, -(2**30), np.int64),
        "votes": votes,
        "votes2": votes2,
        "strand": strand,
        "mapq": mapq_from_votes(votes, votes2),
        "offset": np.full(N, -1, np.int64),   # window offset where known
        "window_pad": window_pad,
    }
    if with_cigar:
        out["cigar"] = np.array([""] * N, dtype=object)
        out["offset"] = np.zeros(N, np.int64)
    if len(mapped) == 0:
        return out

    wlen = L + 2 * window_pad
    start = np.clip(pos[mapped] - window_pad, 0,
                    max(len(index.ref) - wlen, 0)).astype(np.int64)
    # verify in aligned orientation: reverse-strand reads run as their
    # reverse complement (SAM stores SEQ/CIGAR in this orientation)
    rsub = np.where(strand[mapped, None] == 1,
                    revcomp(reads[mapped]), reads[mapped])
    out["pos"][mapped] = start
    if with_cigar:
        res = sw_cigar_windows(index, start, rsub, wlen, params, strategy,
                               device=dev)
        for j, i in enumerate(mapped):
            out["cigar"][i], out["offset"][i] = res[j]
        out["score"][mapped] = 0
        return out
    # the exact tier reads host windows; SW reads the device's.  Exact-tier
    # offsets are recorded so coordinates/SAM don't have to guess.
    win_idx = start[:, None] + np.arange(wlen)[None, :]
    windows = index.ref[np.clip(win_idx, 0, len(index.ref) - 1)]
    clipped = start != (pos[mapped] - window_pad)
    exact, exact_o = _exact_tier(windows, rsub, window_pad, wlen, L, clipped)
    out["offset"][mapped[exact]] = exact_o[exact]
    out["score"][mapped[exact]] = L * int(params.match)
    rest = ~exact
    if rest.any():
        out["score"][mapped[rest]] = sw_score_windows(
            index, start[rest], rsub[rest], wlen, params, device=dev)
    return out


# The device reference is word-packed: 8 bases per uint32 (4-bit codes,
# little nibble = lower ref offset), held as int32 (the same bits).  A
# window gather reads ~26 aligned words per window instead of ~200 single
# bytes, halves the reference's device footprint, and keeps flat int32
# WORD indices valid to 8.6 Gbp (so the human genome rides the flat
# path).  Past _BLOCK_GATE the words live as overlapping 2^_BLOCK_BITS-bp
# rows and a window start becomes a (row, word-offset, nibble) int32
# triple.  The gate is monkeypatched small in tests to exercise the
# blocked path against the flat one.
_BLOCK_BITS = 27
_BLOCK_GATE = 2**33
_BLOCK_OVERLAP = 4096    # bp, > any wlen: a window never leaves its row


_REF_PAD = 5   # outside code space 0..4: padding never matches any read
_PAD_WORD = np.uint32(0x55555555)        # eight _REF_PAD nibbles


def _pack_ref_words(code: np.ndarray) -> np.ndarray:
    """(n,) uint8 codes -> (ceil(n/8),) uint32 words, nibble j of word w
    = code[8w + j]; the ragged tail is _REF_PAD-filled.  Chunked so the
    widened uint32 packing temp stays ~128 MB (4M words x 8 lanes x 4 B)
    even at genome scale."""
    n = len(code)
    nw = -(-n // 8)
    padded = np.full(nw * 8, _REF_PAD, np.uint8)
    padded[:n] = code
    out = np.empty(nw, np.uint32)
    step = 1 << 22
    for lo in range(0, nw, step):
        blk = padded[lo * 8: (lo + step) * 8].reshape(-1, 8).astype(
            np.uint32)
        acc = blk[:, 0]
        for j in range(1, 8):
            acc |= blk[:, j] << np.uint32(4 * j)
        out[lo: lo + len(acc)] = acc
    return out


def _ref_device(index: ReferenceIndex, device: torch.device):
    """The word-packed reference on ``device``: (int32 tensor, blocked).
    A flat padded vector up to _BLOCK_GATE bases; an overlapping (n_rows,
    words_per_row) matrix above.  Made once a device and cached on the
    index."""
    cache = index._ref_dev
    if cache is None:
        cache = index._ref_dev = {}
    if device in cache:
        return cache[device], index._ref_blocked
    n = len(index.ref)
    words = _pack_ref_words(encode(index.ref))
    ov_w = _BLOCK_OVERLAP // 8 + 8
    if n <= _BLOCK_GATE:
        host = np.concatenate([words, np.full(ov_w, _PAD_WORD, np.uint32)])
        index._ref_blocked = False
    else:
        S_w = 1 << (_BLOCK_BITS - 3)               # words per row
        n_rows = -(-len(words) // S_w)
        padded = np.concatenate(
            [words, np.full(S_w + ov_w, _PAD_WORD, np.uint32)])
        rows = np.lib.stride_tricks.as_strided(
            padded, shape=(n_rows, S_w + ov_w), strides=(4 * S_w, 4))
        host = np.ascontiguousarray(rows)
        index._ref_blocked = True
    cache[device] = torch.from_numpy(host.view(np.int32)).to(device)
    return cache[device], index._ref_blocked


def _pack_codes(reads: np.ndarray) -> np.ndarray:
    """(B, L) ASCII reads -> (B, ceil(L/2)) packed 4-bit codes (hi nibble
    = even column): half the bytes to copy to the card."""
    codes = encode(reads.reshape(-1)).reshape(reads.shape)
    if codes.shape[1] % 2:
        codes = np.concatenate(
            [codes, np.full((len(codes), 1), _REF_PAD, np.uint8)], axis=1)
    return (codes[:, 0::2] << 4) | codes[:, 1::2]


def _split_starts(starts: np.ndarray, blocked: bool):
    """int64 bp window starts -> int32 device index arrays for the
    word-packed reference: flat (word, nibble) pair or blocked
    (row, word-offset, nibble) triple."""
    starts = np.asarray(starts, np.int64)
    nib = (starts & 7).astype(np.int32)
    if not blocked:
        return ((starts >> 3).astype(np.int32), nib)
    off = starts & ((1 << _BLOCK_BITS) - 1)
    return ((starts >> _BLOCK_BITS).astype(np.int32),
            (off >> 3).astype(np.int32), nib)


def _sw_windows(index: ReferenceIndex, starts: np.ndarray,
                reads: np.ndarray, wlen: int, params, device: torch.device,
                indel_init: bool = False, with_traceback: bool = False):
    """Launch the window gather and the banded SW kernel on ``device``
    without waiting: (ez (6, B) int32, traceback words (B, G, 32) or
    None), still on the device, so host work for the next chunk overlaps
    this chunk's device time.  No padding of the batch: nothing here
    recompiles for a new size."""
    from mgl_tpu_torch.kernels.sw_cuda import sw_banded
    from mgl_tpu_torch.kernels.window_cuda import window_gather

    ref_dev, blocked = _ref_device(index, device)
    B, L = reads.shape
    st = tuple(torch.from_numpy(s).to(device)
               for s in _split_starts(starts, blocked))
    packed = torch.from_numpy(_pack_codes(reads)).to(device)
    tgt, qry = window_gather(ref_dev, st, packed, wlen, L)
    return sw_banded(
        tgt, qry, torch.full((B,), wlen, dtype=torch.int32, device=device),
        torch.full((B,), L, dtype=torch.int32, device=device),
        params.match, params.mismatch, params.gap_open, params.gap_extend,
        indel_init=indel_init, with_traceback=with_traceback)


def _sw_score_windows_async(index: ReferenceIndex, starts: np.ndarray,
                            reads: np.ndarray, wlen: int, params,
                            device: torch.device) -> torch.Tensor:
    """The (B,) int32 best scores (row 2 of the kernel's ez, ``max``) of
    :func:`_sw_windows` in score-only mode, still on the device."""
    return _sw_windows(index, starts, reads, wlen, params, device)[0][2]


def sw_score_windows(index: ReferenceIndex, starts: np.ndarray,
                     reads: np.ndarray, wlen: int, params,
                     device: str | torch.device = "cuda") -> np.ndarray:
    """(B,) int64 best SW score of each read vs its reference window of
    wlen bases from ``starts``, with the window gather on ``device`` (the
    reference resident there)."""
    sc = _sw_score_windows_async(index, starts, reads, wlen, params,
                                 resolve_device(device))
    return sc.cpu().numpy().astype(np.int64)


def _nm_at(ref: np.ndarray, pos: np.ndarray, oriented: np.ndarray
           ) -> np.ndarray:
    """Mismatch count of each oriented read vs the reference at its
    predicted start (out-of-range columns clamp to the last ref byte -
    such rows are edge-clipped and the caller handles them separately):
    one native pass (``exact_nm``), bit-equal to :func:`_nm_at_numpy`."""
    return exact_nm(oriented, ref, pos).astype(np.int64)


def _nm_at_numpy(ref: np.ndarray, pos: np.ndarray, oriented: np.ndarray
                 ) -> np.ndarray:
    """:func:`_nm_at` by a NumPy gather."""
    L = oriented.shape[1]
    rd_idx = pos[:, None] + np.arange(L)[None, :]
    eq = ref[np.clip(rd_idx, 0, len(ref) - 1)] == oriented
    return (L - eq.sum(axis=1)).astype(np.int64)


def map_reads_stream(index: ReferenceIndex, reads: np.ndarray,
                     chunk: int = 131072, window_pad: int = 24,
                     params=None, with_cigar: bool = False,
                     strategy=None,
                     device: str | torch.device = "cuda") -> dict:
    """Chunked mapping with host/device overlap: while the card verifies
    chunk k, the host seeds and exact-tiers chunk k+1 (kernels launch
    without a sync; chunk k's scores come back into pinned memory behind a
    CUDA event, fetched one chunk behind).

    Reads whose seeding found a competing locus (pos2) get that locus
    SW-scored in the SAME launch as the primary windows, and their MAPQ is
    rescored from the score gap (mapq_rescore); unambiguous reads keep
    vote-based MAPQ.  Same outputs as map_reads without with_cigar, plus
    pos2/score2 diagnostics.  Host stages are timed in ``METRICS`` as
    map.seed, map.host_tier, map.dispatch and map.sync.

    ``with_cigar=True`` adds full CIGARs by a certified-diagonal tier: the
    SW recurrence pins alignment starts to the matrix boundary, so a
    full-length diagonal alignment scores exactly ``(L-nm)*match +
    nm*mismatch``; where the kernel's best equals that, "<L>M" is provably
    an optimal CIGAR.  Only reads where a gapped path beats the diagonal
    (indels, mis-seeds, window-edge clips), and under the INDEL and
    LEADING_INDEL strategies every non-exact read, go through
    :func:`sw_cigar_windows` in a post-pass (``METRICS`` map.tb_reads,
    map.traceback, and map.tb_overflow for the walks that overflowed
    their segment buffer).  Score mode does not read ``strategy``.
    """
    from mgl_tpu_torch.kernels.pairhmm_cuda import to_host

    dev = resolve_device(device)
    params = params or STANDARD_NGS
    strategy = strategy or OverhangStrategy.SOFTCLIP
    # the certified tier's score model assumes the zero boundary rows of
    # the non-indel-init strategies; INDEL/LEADING_INDEL windows take the
    # traceback for every read
    cert_ok = not (strategy & (OverhangStrategy.INDEL
                               | OverhangStrategy.LEADING_INDEL))
    N, L = reads.shape
    wlen = L + 2 * window_pad
    out = {
        "pos": np.full(N, -1, np.int64),
        "score": np.full(N, -(2**30), np.int64),
        "votes": np.zeros(N, np.int32),
        "votes2": np.zeros(N, np.int32),
        "strand": np.zeros(N, np.int8),
        "mapq": np.zeros(N, np.int32),
        "offset": np.full(N, -1, np.int64),
        "pos2": np.full(N, -1, np.int64),
        "score2": np.full(N, -(2**30), np.int64),
        "window_pad": window_pad,
    }
    if with_cigar:
        out["cigar"] = np.array([""] * N, dtype=object)
    tb_idx: list = []            # reads needing the traceback tier
    pending = None

    def finalize(p):
        fetch, n1, idx1, idx2, diag1 = p
        with METRICS.timer("map.sync"):
            scores = fetch().astype(np.int64)
        out["score"][idx1] = scores[:n1]
        if with_cigar and n1:
            cert = cert_ok & (diag1 >= 0) & (scores[:n1] == diag1)
            for i in idx1[cert]:
                out["cigar"][i] = f"{L}M"
            out["offset"][idx1[cert]] = window_pad
            tb_idx.extend(idx1[~cert])
        if len(idx2):
            out["score2"][idx2] = scores[n1:]
            out["mapq"][idx2] = mapq_rescore(out["score"][idx2],
                                             scores[n1:],
                                             out["votes"][idx2], params)

    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        sub = reads[lo:hi]
        with METRICS.timer("map.seed"):
            pos, votes, strand, votes2, pos2, strand2 = seed_candidates(
                index, sub, L, both_strands=True, full=True)
        out["votes"][lo:hi] = votes
        out["votes2"][lo:hi] = votes2
        out["strand"][lo:hi] = strand
        out["mapq"][lo:hi] = mapq_from_votes(votes, votes2)
        mapped = np.nonzero(pos >= 0)[0]
        if len(mapped) == 0:
            if pending is not None:
                finalize(pending)
                pending = None
            continue
        with METRICS.timer("map.host_tier"):
            start = np.clip(pos[mapped] - window_pad, 0,
                            max(len(index.ref) - wlen, 0)).astype(np.int64)
            rsub = np.where(strand[mapped, None] == 1,
                            revcomp(sub[mapped]), sub[mapped])
            clipped = start != (pos[mapped] - window_pad)
            # seeds pin the exact best diagonal, so the exact tier needs
            # one equality check at the predicted read start (a read that
            # differs there can't be exact at any other offset); only
            # edge-clipped windows (rare) still take the full-range scan
            nm = _nm_at(index.ref, pos[mapped], rsub)
            exact = ~clipped & (nm == 0)
            exact_o = np.where(exact, np.int64(window_pad), np.int64(-1))
            # certified-diagonal score: what a full-length gap-free
            # alignment at the seeded diagonal scores (valid where the
            # window isn't edge-clipped)
            diag_score = np.where(
                clipped, np.int64(-1),
                (L - nm) * np.int64(params.match)
                + nm * np.int64(params.mismatch))
            if clipped.any():
                ci = np.nonzero(clipped)[0]
                wi = start[ci, None] + np.arange(wlen)[None, :]
                win_c = index.ref[np.clip(wi, 0, len(index.ref) - 1)]
                e2, o2 = _exact_tier(win_c, rsub[ci], window_pad, wlen, L,
                                     np.ones(len(ci), bool))
                exact[ci] = e2
                exact_o[ci] = o2
            # competitor loci of mapped reads ride the same launch
            amb = np.nonzero((pos >= 0) & (pos2 >= 0))[0]
            start2 = np.clip(pos2[amb] - window_pad, 0,
                             max(len(index.ref) - wlen, 0)).astype(np.int64)
            rsub2 = np.where(strand2[amb, None] == 1,
                             revcomp(sub[amb]), sub[amb])
        out["pos"][lo + mapped] = start
        out["pos2"][lo + amb] = start2
        out["offset"][lo + mapped[exact]] = exact_o[exact]
        out["score"][lo + mapped[exact]] = L * int(params.match)
        if with_cigar:
            for i in lo + mapped[exact]:
                out["cigar"][i] = f"{L}M"
        rest = ~exact
        launched = None
        if rest.any() or len(amb):
            with METRICS.timer("map.dispatch"):
                sc = _sw_score_windows_async(
                    index, np.concatenate([start[rest], start2]),
                    np.concatenate([rsub[rest], rsub2], axis=0),
                    wlen, params, dev)
                launched = (to_host(sc), int(rest.sum()),
                            lo + mapped[rest], lo + amb, diag_score[rest])
        if pending is not None:
            finalize(pending)
        pending = launched
    if pending is not None:
        finalize(pending)
    if with_cigar and tb_idx:
        # traceback tier: the minority of reads whose optimal alignment
        # isn't the seeded diagonal (indels / edge clips / mis-seeds)
        METRICS.count("map.tb_reads", len(tb_idx))
        with METRICS.timer("map.traceback"):
            tb = np.asarray(tb_idx, np.int64)
            rsub_tb = np.where(out["strand"][tb, None] == 1,
                               revcomp(reads[tb]), reads[tb])
            res = sw_cigar_windows(index, out["pos"][tb], rsub_tb, wlen,
                                   params, strategy, device=dev)
            for j, i in enumerate(tb):
                out["cigar"][i], out["offset"][i] = res[j]
    return out


def sw_cigar_windows(index: ReferenceIndex, starts: np.ndarray,
                     reads: np.ndarray, wlen: int, params, strategy,
                     band: int = 32, chunk: int = 8192,
                     device: str | torch.device = "cuda") -> list:
    """[(cigar, offset)] of each read against its reference window of
    ``wlen`` bases from ``starts``, in chunks of ``chunk`` reads: the
    window gather and the banded SW kernel in traceback mode on
    ``device`` (``indel_init`` for INDEL and LEADING_INDEL), the CIGAR
    walk there (``ops.cigar_device.decode_cigars_device``), and for the
    pairs whose walk overflowed its segments, those pairs' words alone
    fetched and decoded by the host decoder (``native``), as ``mgl_tpu``
    does (mapper.py:1032).  The port's SW kernel has bands of 32 rows
    only."""
    from mgl_tpu_torch.ops.cigar_device import decode_cigars_device

    if band != BAND:
        raise ValueError(f"the banded SW kernel has bands of {BAND} rows, "
                         f"not {band}")
    dev = resolve_device(device)
    out = []
    for lo in range(0, len(reads), chunk):
        ez, words, wpb = _sw_traceback_windows(
            index, starts[lo: lo + chunk], reads[lo: lo + chunk], wlen,
            params, strategy, dev)
        res = decode_cigars_device(words, ez, wlen, reads.shape[1],
                                   strategy, wpb)
        out.extend(decode_overflow(res, words, ez, wlen, reads.shape[1],
                                   strategy, wpb))
    return out


def _sw_traceback_windows(index: ReferenceIndex, starts: np.ndarray,
                          reads: np.ndarray, wlen: int, params, strategy,
                          device: torch.device):
    """(ez (6, B), words (B, G, 32), words a band) of :func:`_sw_windows`
    in traceback mode, with ``indel_init`` for INDEL and LEADING_INDEL."""
    ez, words = _sw_windows(
        index, starts, reads, wlen, params, device,
        indel_init=bool(strategy & (OverhangStrategy.INDEL
                                    | OverhangStrategy.LEADING_INDEL)),
        with_traceback=True)
    return ez, words, banded_layout(wlen, reads.shape[1])[1]


def decode_overflow(res: list, words: torch.Tensor, ez: torch.Tensor,
                    wlen: int, qlen: int, strategy, words_per_band: int
                    ) -> list:
    """``res`` with each None (a pair whose device walk overflowed) replaced
    by the host decoder's (cigar, offset) from that pair's words and
    ScoreMax, selected on their device and fetched alone."""
    need = [b for b, r in enumerate(res) if r is None]
    if not need:
        return res
    METRICS.count("map.tb_overflow", len(need))
    from mgl_tpu_torch.kernels.pairhmm_cuda import to_host

    sel = torch.tensor(need, device=words.device)
    w_fetch = to_host(words[sel].contiguous())
    ez_fetch = to_host(ez[:, sel].contiguous())
    ez_h = dict(zip(EZ_KEYS, ez_fetch().astype(np.int64)))
    host = cigar_decode_bulk_banded(
        w_fetch().view(np.uint32), ez_h, np.full(len(need), wlen, np.int32),
        np.full(len(need), qlen, np.int32), int(strategy), BAND,
        words_per_band)
    res = list(res)
    for b, r in zip(need, host):
        res[b] = r
    return res


def sw_score_batch(targets: np.ndarray, queries: np.ndarray, params,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """(B,) int64 best SW score per pair of already-gathered windows and
    reads (max over the last row and column), by the banded SW kernel in
    score-only mode on ``device``.  Bases are compared as given (ASCII
    here, where the window gather compares 4-bit codes)."""
    from mgl_tpu_torch.kernels.sw_cuda import sw_banded

    dev = resolve_device(device)
    B, T = targets.shape
    Q = queries.shape[1]
    ez, _ = sw_banded(
        torch.from_numpy(np.ascontiguousarray(targets, np.uint8)).to(dev),
        torch.from_numpy(np.ascontiguousarray(queries, np.uint8)).to(dev),
        torch.full((B,), T, dtype=torch.int32, device=dev),
        torch.full((B,), Q, dtype=torch.int32, device=dev),
        params.match, params.mismatch, params.gap_open, params.gap_extend,
        indel_init=False, with_traceback=False)
    return ez[2].cpu().numpy().astype(np.int64)
