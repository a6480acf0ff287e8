"""The seed-and-vote read mapper with CIGARs, in NumPy and plain torch.

The semantics of ``mgl-map --cigar`` (the port's ``map_reads_stream(...,
with_cigar=True)``), worked out again from the reference sequence and the
reads alone:

1. Index: every k-mer of the reference without an ambiguous base, under
   its canonical value min(forward, reverse complement), with a bit for
   whether the forward form is the canonical one.
2. Seeds: the read's k-mers at offsets 0, k, 2k, ... that lie wholly in
   the read and hold no ambiguous base, looked up by canonical value; a
   seed with no hit or with more than ``max_hits`` hits is dropped.  A hit
   lies on the reverse strand where its forward bit differs from the
   seed's; its diagonal is the hit's position less the seed's offset in
   the read as oriented (L - k - offset on the reverse strand).
3. Vote, per read and strand: the bin (diagonal // 8) with the most hits,
   the highest bin on ties; in it, the diagonal with the most hits, the
   highest on ties.  The reverse strand wins only with more votes than the
   forward one.  A read with no vote, or whose winning diagonal lies
   before the reference, is unmapped.
4. Window: start = clip(diagonal - pad, 0, len(ref) - (L + 2 pad)); the
   read is scored in its aligned orientation (reverse-complemented on the
   reverse strand).
5. A read equal to the reference at its diagonal, in a window not clipped
   at the reference's end, is exact: score L * match, CIGAR "<L>M" at
   offset pad (a clipped window looks for the read at offsets pad..pad+7,
   then anywhere).  Every other read takes the best SW score of the read
   against its window (``reference.sw``, SOFTCLIP); where that score
   equals the gap-free score at the diagonal, (L - nm) * match +
   nm * mismatch, in an unclipped window, the CIGAR is "<L>M" at offset
   pad, else the SW walk's CIGAR and offset.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference import sw as ref_sw

_CODE = np.full(256, 4, np.int64)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
    _CODE[_b + 32] = _i
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTNacgtn", b"TGCANTGCAN"):
    _COMP[_a] = _b


def revcomp(reads: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(reads, np.uint8)[..., ::-1]]


class KmerIndex:
    """Canonical k-mers of the reference, sorted by value, on ``device``."""

    def __init__(self, ref: np.ndarray, k: int, device):
        self.k, self.device = k, device
        self.ref = np.asarray(ref, np.uint8)
        code = torch.from_numpy(_CODE[self.ref]).to(device)
        n = len(code) - k + 1
        fwd = torch.zeros(n, dtype=torch.int64, device=device)
        rev = torch.zeros(n, dtype=torch.int64, device=device)
        bad = torch.zeros(n, dtype=torch.bool, device=device)
        for t in range(k):
            c = code[t:t + n]
            bad |= c > 3
            fwd = fwd * 4 + c.clamp(max=3)
            rev = rev + ((3 - c.clamp(max=3)) << (2 * t))
        keep = torch.nonzero(~bad)[:, 0]
        canon = torch.minimum(fwd, rev)[keep]
        order = torch.argsort(canon, stable=True)
        self.values = canon[order]
        self.positions = keep[order]
        self.fwd_bit = (fwd <= rev)[keep][order]

    def seed_values(self, reads: np.ndarray):
        """(forward values, reverse-complement values, valid, offsets)
        of the reads' seeds, as int64 arrays (N, S)."""
        N, L = reads.shape
        k = self.k
        offsets = np.arange(0, L - k + 1, k)
        code = _CODE[reads]
        fv = np.zeros((N, len(offsets)), np.int64)
        rv = np.zeros_like(fv)
        valid = np.ones(fv.shape, bool)
        for t in range(k):
            c = code[:, offsets + t]
            valid &= c <= 3
            cc = np.minimum(c, 3)
            fv = fv * 4 + cc
            rv = rv + ((3 - cc) << (2 * t))
        return fv, rv, valid, offsets


def _best(rows: np.ndarray, keys: np.ndarray, n_rows: int):
    """Per row, the key with the most entries (the highest on ties) and
    its count; -1 / 0 where a row has none."""
    best = np.full(n_rows, -1, np.int64)
    count = np.zeros(n_rows, np.int64)
    if len(rows) == 0:
        return best, count, np.zeros(n_rows, bool)
    pair = np.stack([rows, keys], axis=1)
    uniq, cnt = np.unique(pair, axis=0, return_counts=True)
    # sort by row, then count, then key: the last of each row wins
    order = np.lexsort((uniq[:, 1], cnt, uniq[:, 0]))
    uniq, cnt = uniq[order], cnt[order]
    last = np.nonzero(np.diff(np.append(uniq[:, 0], -1)) != 0)[0]
    best[uniq[last, 0]] = uniq[last, 1]
    count[uniq[last, 0]] = cnt[last]
    has = np.zeros(n_rows, bool)
    has[uniq[last, 0]] = True
    return best, count, has


def seed(index: KmerIndex, reads: np.ndarray, max_hits: int
         ) -> tuple[np.ndarray, np.ndarray]:
    """(diagonal, strand) of each read: -1 / 0 where unmapped."""
    N, L = reads.shape
    k = index.k
    fv, rv, valid, offsets = index.seed_values(reads)
    canon = np.minimum(fv, rv)
    read_fwd = fv <= rv
    q = torch.from_numpy(canon.reshape(-1)).to(index.device)
    lo = torch.searchsorted(index.values, q, right=False)
    hi = torch.searchsorted(index.values, q, right=True)
    cnt = (hi - lo).cpu().numpy()
    keep = (cnt > 0) & (cnt <= max_hits) & valid.reshape(-1)
    seed_id = np.nonzero(keep)[0]
    reps = cnt[seed_id]
    lo_h = lo.cpu().numpy()[seed_id]
    total = int(reps.sum())
    first = np.repeat(lo_h, reps) + (np.arange(total)
                                     - np.repeat(np.cumsum(reps) - reps, reps))
    first_t = torch.from_numpy(first).to(index.device)
    hit_pos = index.positions[first_t].cpu().numpy()
    hit_fwd = index.fwd_bit[first_t].cpu().numpy()
    sid = np.repeat(seed_id, reps)
    read = sid // len(offsets)
    off = offsets[sid % len(offsets)]
    strand = (hit_fwd != read_fwd.reshape(-1)[sid]).astype(np.int64)
    diag = hit_pos - np.where(strand == 1, L - k - off, off)
    row = read * 2 + strand
    bin_best, votes, has = _best(row, diag // 8, 2 * N)
    in_bin = (diag // 8) == bin_best[row]
    diag_best, _, _ = _best(row[in_bin], diag[in_bin], 2 * N)
    pos = np.where(has & (diag_best >= 0),
                   np.minimum(diag_best, len(index.ref) - 1), -1)
    votes = votes.reshape(N, 2)
    pos = pos.reshape(N, 2)
    rc = votes[:, 1] > votes[:, 0]
    return np.where(rc, pos[:, 1], pos[:, 0]), rc.astype(np.int64)


def map_reads(index: KmerIndex, reads: np.ndarray, pad: int, max_hits: int,
              params: tuple[int, int, int, int],
              dtype: torch.dtype = torch.int32) -> dict:
    """The expected start, strand, score, CIGAR and offset of each read
    (``pos`` -1 where unmapped); ``dtype`` is the SW scores' precision."""
    N, L = reads.shape
    ref = index.ref
    wlen = L + 2 * pad
    diag, strand = seed(index, reads, max_hits)
    out = {"pos": np.full(N, -1, np.int64), "strand": strand,
           "score": np.zeros(N, np.int64),
           "cigar": np.array([""] * N, dtype=object),
           "offset": np.full(N, -1, np.int64)}
    m = np.nonzero(diag >= 0)[0]
    if not len(m):
        return out
    start = np.clip(diag[m] - pad, 0, max(len(ref) - wlen, 0))
    clipped = start != diag[m] - pad
    rd = np.where(strand[m, None] == 1, revcomp(reads[m]), reads[m])
    at = np.clip(diag[m, None] + np.arange(L)[None, :], 0, len(ref) - 1)
    nm = (ref[at] != rd).sum(1)
    windows = ref[np.clip(start[:, None] + np.arange(wlen)[None, :], 0,
                          len(ref) - 1)]
    exact = ~clipped & (nm == 0)
    ex_off = np.where(exact, pad, -1)
    for b in np.nonzero(clipped)[0]:
        for o in list(range(pad, min(pad + 8, wlen - L + 1))) + list(
                range(0, wlen - L + 1)):
            if (windows[b, o:o + L] == rd[b]).all():
                exact[b], ex_off[b] = True, o
                break
    match, mismatch = params[0], params[1]
    got, best = ref_sw.align(list(windows), list(rd), params,
                             ref_sw.SOFTCLIP, index.device, dtype,
                             block=4096)
    gap_free = np.where(clipped, -1, (L - nm) * match + nm * mismatch)
    out["pos"][m] = start
    for b, i in enumerate(m):
        if exact[b]:
            out["score"][i] = L * match
            out["cigar"][i], out["offset"][i] = f"{L}M", ex_off[b]
        else:
            out["score"][i] = best[b]
            if best[b] == gap_free[b]:
                out["cigar"][i], out["offset"][i] = f"{L}M", pad
            else:
                out["cigar"][i], out["offset"][i] = got[b]
    return out
