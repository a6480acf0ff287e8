"""Fixtures and checks shared by the port's tests, ``chip_smoke.py`` and
``mgl_tpu_torch.profile_e2e``: seeded SW pairs and GATK-shaped PairHMM
regions, hap sets for the shared kernel's edges, the seed-extend
scorer's edge pairs, simulated references and reads for the mapper and
the window starts that reach every edge of its gather, golden rows,
tensor packers, traceback comparisons of both layouts, CUDA-event
timers, the sharded step's inputs at a GATK shape, and the functions that
the parallel layer's tests run in spawned ranks and worker processes.
Nothing on the main path imports this module.
"""

from __future__ import annotations

import functools
import json
import pathlib
import time

import numpy as np
import torch

from mgl_tpu_torch.ops.sw import BAND, plane_words

ACGT = np.frombuffer(b"ACGT", np.uint8)
GOLDEN = pathlib.Path(__file__).resolve().parents[1] / "tests" / "golden"


def u8(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), np.uint8)


def load_golden(name: str) -> list[dict]:
    """The rows of ``tests/golden/<name>`` (``.json`` list or ``.jsonl``)."""
    text = (GOLDEN / name).read_text()
    if name.endswith(".jsonl"):
        return [json.loads(line) for line in text.splitlines()]
    return json.loads(text)


def golden_read(row: dict) -> dict:
    """A read dict (uint8 bases/q/i/d/c) from a KAT or PairHMM golden row."""
    read = {k: np.array(row[k], np.uint8) for k in "qidc"}
    read["bases"] = u8(row["read"])
    return read


def golden_groups(rows: list[dict]) -> dict:
    """SW golden rows grouped by (match, mismatch, open, ext, strategy)."""
    groups: dict = {}
    for r in rows:
        key = (r["match"], r["mismatch"], r["open"], r["ext"], r["strategy"])
        groups.setdefault(key, []).append(r)
    return groups


def sw_pairs(seed: int, n: int, tlen_range: tuple[int, int],
             qlen_range: tuple[int, int], err: float = 0.03
             ) -> tuple[list[bytes], list[bytes]]:
    """n pairs whose query is a mutated slice of its target: SNPs at rate
    ``err`` and one 3-base indel once the query passes 20 bases; lengths
    drawn from the inclusive ranges."""
    rng = np.random.default_rng(seed)
    targets, queries = [], []
    for _ in range(n):
        tl = int(rng.integers(tlen_range[0], tlen_range[1] + 1))
        ql = int(rng.integers(qlen_range[0], qlen_range[1] + 1))
        t = rng.choice(ACGT, tl)
        q = t[int(rng.integers(0, max(tl - ql, 0) + 1)):][:ql].copy()
        q[rng.random(len(q)) < err] = rng.choice(ACGT)
        if len(q) > 20:
            p = int(rng.integers(5, len(q) - 5))
            q = (np.concatenate([q[:p], rng.choice(ACGT, 3), q[p:]])
                 if rng.random() < 0.5 else np.delete(q, slice(p, p + 3)))
        q = q[:ql] if len(q) >= ql else np.concatenate(
            [q, rng.choice(ACGT, ql - len(q))])
        targets.append(t.tobytes())
        queries.append(q.tobytes())
    return targets, queries


def sw_edge_pairs(seed: int) -> tuple[list[bytes], list[bytes]]:
    """Pairs of 1-700 x 1-300 bases, with tlen 1, 31, 32, 33 and 95 among
    them and one pair at tlen = T = 700: one launch of the pipelined SW
    kernels mixes pairs of 1 to 22 bands, fewer and more than W.  The
    last pair's one-base query makes row 33's E-extend bit depend on band
    0's bottom row at column 1, which band 1 reads before its first
    step."""
    targets, queries = sw_pairs(seed, 120, (1, 700), (1, 300), err=0.08)
    rng = np.random.default_rng(seed)
    for tl, ql in ((1, 1), (31, 7), (32, 300), (33, 1), (95, 150), (1, 300),
                   (700, 2), (64, 33)):
        targets.append(rng.choice(ACGT, tl).tobytes())
        queries.append(rng.choice(ACGT, ql).tobytes())
    targets.append(b"C" * 30 + b"AC" + b"ACGT" * 10)
    queries.append(b"A")
    return targets, queries


def sw_tensors(targets: list[bytes], queries: list[bytes], device
               ) -> tuple[torch.Tensor, ...]:
    """(tgt, qry, tlen, qlen) on ``device``, as the SW kernel takes them."""
    from mgl_tpu_torch.kernels.sw_cuda import pack_sequences

    tlen = np.array([len(t) for t in targets], np.int32)
    qlen = np.array([len(q) for q in queries], np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (
        pack_sequences(targets), pack_sequences(queries), tlen, qlen))


def engine_region(seed: int, n_reads: int = 512, n_haps: int = 12,
                  rdlen: int = 151, haplen: int = 420
                  ) -> tuple[list[dict], list[np.ndarray]]:
    """A GATK-shaped assembly region: haps that differ by single SNPs,
    reads drawn from the first with one error each, and every 16th read
    random with high qualities - a tail whose f32 score underflows into
    the f64 rescue (the shape of bench.py's engine fixture)."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, haplen)
    haps = [base.copy()]
    for p in sorted(int(x) for x in
                    rng.integers(haplen // 3, haplen - 10, n_haps - 1)):
        haps.append(snp(haps[-1], p))
    reads = []
    for k in range(n_reads):
        st = int(rng.integers(0, haplen - rdlen))
        b = base[st: st + rdlen].copy()
        if k % 16 == 0:
            b = rng.choice(ACGT, rdlen)
            q = rng.integers(45, 60, rdlen).astype(np.uint8)
        else:
            b[rng.integers(0, rdlen)] = ACGT[rng.integers(0, 4)]
            q = rng.integers(15, 45, rdlen).astype(np.uint8)
        reads.append(dict(bases=b, q=q, i=q, d=q,
                          c=np.full(rdlen, 10, np.uint8)))
    return reads, haps


def no_hit_region(seed: int, n_reads: int = 128, n_haps: int = 12,
                  rdlen: int = 151, haplen: int = 420
                  ) -> tuple[list[dict], list[np.ndarray]]:
    """:func:`engine_region`'s haps and qualities with every read's bases
    random: no pair has an offset with fewer than two mismatches, so
    under ``fast_path`` no pair hits and a full product that the work
    estimate sends to the shared kernel takes it."""
    reads, haps = engine_region(seed, n_reads, n_haps, rdlen, haplen)
    rng = np.random.default_rng(seed + 1)
    return [{**r, "bases": rng.choice(ACGT, rdlen)} for r in reads], haps


def snp(h: np.ndarray, p: int) -> np.ndarray:
    """``h`` with base p changed to the next of A, C, G, T."""
    h = h.copy()
    h[p] = ACGT[(int(np.searchsorted(ACGT, h[p])) + 1) % 4]
    return h


def _tiled_read(rng, base: np.ndarray, n: int, random: bool) -> dict:
    """A read of n bases: a slice of ``base`` (tiled when n is longer) or
    random bases, with mid qualities."""
    if random:
        b = rng.choice(ACGT, n)
    else:
        tiled = np.tile(base, n // len(base) + 2)
        st = int(rng.integers(0, len(base)))
        b = tiled[st:st + n].copy()
    q = rng.integers(10, 50, n).astype(np.uint8)
    return dict(bases=b, q=q, i=q, d=q, c=np.full(n, 10, np.uint8))


def shared_edge_set(seed: int, read_lens, hap_len: int = 120
                    ) -> tuple[list[dict], list[np.ndarray]]:
    """Reads of ``read_lens`` bases against a hap set with every edge of
    the shared kernel's segments: haps one SNP apart that share prefixes,
    a reset (a hap sharing less than its predecessor did), an exact
    duplicate right after its twin (a zero-length segment), a hap under 8
    bases (the next one starts afresh) and a prefix of the first hap.
    Every third read is random, the others slices of the first hap."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, hap_len)
    haps = [base] + [snp(base, int(f * hap_len))
                     for f in (0.75, 0.6, 0.85, 0.5)]
    haps.insert(3, haps[2].copy())
    haps += [rng.choice(ACGT, 7), base[:hap_len - 10].copy(),
             base[:hap_len // 3].copy()]
    reads = [_tiled_read(rng, base, n, k % 3 == 2)
             for k, n in enumerate(read_lens)]
    return reads, haps


def pair_edge_set(seed: int, read_lens, hap_lens
                  ) -> tuple[list[dict], list[np.ndarray], list[tuple]]:
    """Reads of ``read_lens`` bases against haps of ``hap_lens`` bases, all
    pairs (read-major): the haps are prefixes of one random sequence, each
    with one SNP past its first base, and every third read is random, the
    others slices of that sequence (tiled where longer) - the per-pair
    kernels' edges of read bands and hap lengths."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, max(hap_lens))
    haps = [snp(base[:n], int(rng.integers(1, n))) if n > 1 else base[:1]
            for n in hap_lens]
    reads = [_tiled_read(rng, base, n, k % 3 == 2)
             for k, n in enumerate(read_lens)]
    pairs = [(r, h) for r in range(len(reads)) for h in range(len(haps))]
    return reads, haps, pairs


def _fast_read(rng, b: np.ndarray) -> dict:
    """A read of bases ``b`` for the seed-extend scorer: random base
    qualities of 10-49, gap qualities 45, GCP 10."""
    q = rng.integers(10, 50, len(b)).astype(np.uint8)
    return dict(bases=b, q=q, i=np.full(len(b), 45, np.uint8),
                d=np.full(len(b), 45, np.uint8), c=np.full(len(b), 10, np.uint8))


def seed_extend_edge_set(seed: int, long_hap: int = 30_000
                         ) -> tuple[list[dict], list[np.ndarray], list[tuple]]:
    """Reads and haps at the seed-extend scorer's edges, all pairs
    (read-major): haps of 30, 40 and 20 bases, one of 200 with two N and
    one of ``long_hap`` bases; a 50-base read (longer than the 30- and
    40-base haps: no offset), a copy of the 40-base hap (one offset, an
    exact match), a one-base read (whose sum over the long hap's offsets
    overflows to inf), an 80-base read with two N, and a 151-base read
    with one SNP on a Q0 base (corr = inf and resultMatch = 0, so its one
    mismatch adds NaN).  Bases are uppercase ACGTN, as the engine
    normalizes them."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, max(long_hap, 400))
    n_hap = base[:200].copy()
    n_hap[[17, 120]] = ord("N")
    haps = [base[:30].copy(), base[:40].copy(), base[:20].copy(), n_hap,
            base[:long_hap].copy()]
    n_read = base[50:130].copy()
    n_read[[3, 60]] = ord("N")
    bases = [base[7:57].copy(), base[:40].copy(), base[5:6].copy(), n_read,
             snp(base[100:251], 70)]
    reads = [_fast_read(rng, b) for b in bases]
    reads[-1]["q"][70] = 0
    pairs = [(r, h) for r in range(len(reads)) for h in range(len(haps))]
    return reads, haps, pairs


def seed_extend_order_set(seed: int
                          ) -> tuple[list[dict], list[np.ndarray], list[tuple]]:
    """Pairs at the edges of the seed-extend kernel's offsets-on-lanes
    design (listed pairs, not a product):

    - reads of 1, 8, 9, 255, 256 and 257 bases (words of four bases, a
      word boundary on each side of 8 and 256), each copied from base 13
      of a random sequence and paired with haps of that sequence that give
      it 1, 31, 32, 33 and 270 offsets (a step of 32 offsets a warp, and
      one past it): the read equals its hap at offset 13, not a multiple
      of 8 (or at offset 0 where it has one);
    - tandem-repeat haps (periods 3 and 7) with reads cut from them, one
      with a SNP: every offset of the read's phase matches with 0 or 1
      mismatches, so many offsets of one step add to the sum;
    - N at the same position in read and hap at the matching offset, an N
      in the read only and an N in the hap only.

    Bases are uppercase ACGTN, as the engine normalizes them."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, 900)
    reads: list[dict] = []
    haps: list[np.ndarray] = []
    pairs: list[tuple] = []
    for rl in (1, 8, 9, 255, 256, 257):
        reads.append(_fast_read(rng, base[13:13 + rl].copy()))
        for n_off in (1, 31, 32, 33, 270):
            st = 13 if n_off == 1 else 0
            haps.append(base[st:st + rl + n_off - 1].copy())
            pairs.append((len(reads) - 1, len(haps) - 1))
    for period in (3, 7):
        unit = rng.choice(ACGT, period)
        hap = np.tile(unit, 500 // period + 1)[:500]
        haps.append(hap)
        for st, rl, mut in ((2, 9, None), (5, 100, None), (1, 256, None),
                            (4, 150, 77)):
            b = hap[st:st + rl].copy()
            if mut is not None:
                b = snp(b, mut)
            reads.append(_fast_read(rng, b))
            pairs.append((len(reads) - 1, len(haps) - 1))
    n_hap = base[100:400].copy()
    n_hap[13 + 40] = ord("N")
    n_hap[13 + 90] = ord("N")
    haps.append(n_hap)
    for n_at in ((40,), (60,), (40, 90), ()):
        b = base[113:263].copy()
        b[list(n_at)] = ord("N")
        reads.append(_fast_read(rng, snp(b, 120) if not n_at else b))
        pairs.append((len(reads) - 1, len(haps) - 1))
    return reads, haps, pairs


def same_scores(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two float tensors hold the same bits, NaN matching any NaN
    (the card's NaN and the host's differ in sign and payload)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.masked_fill(nan, 0).view(torch.int32),
        b.masked_fill(nan, 0).view(torch.int32)))


def long_read_pairs(seed: int, read_lens, hap_len: int
                    ) -> tuple[list[dict], list[np.ndarray], list[tuple]]:
    """Reads of ``read_lens`` bases (each under ``hap_len``), slices of a
    random hap at Q45, against that hap and a copy with one SNP in its
    middle, all pairs: long reads whose f32 scores stay far above 0,
    where reads at mixed qualities underflow."""
    rng = np.random.default_rng(seed)
    base = rng.choice(ACGT, hap_len)
    haps = [base, snp(base, hap_len // 2)]
    reads = []
    for n in read_lens:
        st = int(rng.integers(0, hap_len - n + 1))
        q = np.full(n, 45, np.uint8)
        reads.append(dict(bases=base[st:st + n].copy(), q=q, i=q, d=q,
                          c=np.full(n, 10, np.uint8)))
    pairs = [(r, h) for r in range(len(reads)) for h in range(2)]
    return reads, haps, pairs


def long_hap_set(seed: int, n_reads: int = 300, n_haps: int = 24,
                 hap_len: int = 1000, read_len: int = 100
                 ) -> tuple[list[dict], list[np.ndarray]]:
    """A long hap set: haps one SNP apart at shuffled positions, so that
    about half share less than their predecessor and start afresh - a
    stream of ~16k slots at the defaults, a carry row of ~129 KB a read,
    which the launcher keeps in global memory for 300 reads."""
    rng = np.random.default_rng(seed)
    haps = [rng.choice(ACGT, hap_len)]
    for p in rng.integers(8, hap_len - 8, n_haps - 1):
        haps.append(snp(haps[-1], int(p)))
    reads = [_tiled_read(rng, haps[0], read_len, k % 16 == 0)
             for k in range(n_reads)]
    return reads, haps


def shared_on_and_off(reads: list[dict], haps: list[np.ndarray], device
                      ) -> tuple[tuple, tuple]:
    """The shared kernel's arguments for reads x haps (normalized), and the
    same with every hap starting afresh (sharing off)."""
    from mgl_tpu_torch.kernels.pairhmm_cuda import segment_table, stage_shared

    on = stage_shared(reads, haps, device)
    hstream, segtab = segment_table(haps, np.zeros(len(haps), np.int64))
    off = (*on[:3], torch.from_numpy(hstream).to(device),
           torch.from_numpy(segtab).to(device), on[5])
    return on, off


def traceback_mismatches(words_a: torch.Tensor, words_b: torch.Tensor,
                         tlen: torch.Tensor, qlen: torch.Tensor,
                         words_per_band: int) -> int:
    """How many real cells (1 <= i <= tlen, 1 <= j <= qlen) - the cells a
    CIGAR decode may read - hold different nibbles in two (B, G, 32)
    traceback outputs of the same pairs."""
    dev = words_a.device
    B, G, _ = words_a.shape
    nb, wpb = G // words_per_band, words_per_band
    chunk = max(1, (1 << 24) // (G * BAND))   # pairs per pass, ~16M words
    i = (torch.arange(nb, device=dev)[:, None, None] * BAND
         + torch.arange(BAND, device=dev)[None, :, None] + 1)   # (nb, 32, 1)
    s = torch.arange(BAND, device=dev)[None, :, None]
    w = torch.arange(wpb, device=dev)[None, None, :]
    bad = 0
    for b0 in range(0, B, chunk):
        tl = tlen[b0:b0 + chunk].to(dev).long()[:, None, None, None]
        ql = qlen[b0:b0 + chunk].to(dev).long()[:, None, None, None]
        diff = (words_a[b0:b0 + chunk].long()
                ^ words_b[b0:b0 + chunk].long()) & 0xFFFFFFFF
        diff = diff.reshape(-1, nb, wpb, BAND).transpose(2, 3)  # (b, nb, 32, wpb)
        for n in range(8):
            t = 8 * w + n                                        # j - 1 + s
            real = (i <= tl) & (t >= s) & (t - s < ql)
            bad += int((((diff >> (4 * n)) & 0xF) != 0)[real].sum())
    return bad


def plane_traceback_mismatches(words_a: torch.Tensor, words_b: torch.Tensor,
                               tlen: torch.Tensor, qlen: torch.Tensor) -> int:
    """How many real cells (1 <= i <= tlen, 1 <= j <= qlen) hold different
    nibbles in two (B, n_words, R1) traceback outputs of the same pairs in
    the plane layout (the nibble of cell (i, j) in word (i+j-2)//8 of row
    i, nibble (i+j-2)%8)."""
    dev = words_a.device
    B, W, R1 = words_a.shape
    chunk = max(1, (1 << 24) // (W * R1))     # pairs per pass, ~16M words
    i = torch.arange(R1, device=dev)[None, None, :]           # (1, 1, R1)
    w = torch.arange(W, device=dev)[None, :, None]            # (1, W, 1)
    bad = 0
    for b0 in range(0, B, chunk):
        tl = tlen[b0:b0 + chunk].to(dev).long()[:, None, None]
        ql = qlen[b0:b0 + chunk].to(dev).long()[:, None, None]
        diff = (words_a[b0:b0 + chunk].long()
                ^ words_b[b0:b0 + chunk].long()) & 0xFFFFFFFF
        for n in range(8):
            j = 8 * w + n + 2 - i
            real = (i >= 1) & (i <= tl) & (j >= 1) & (j <= ql)
            bad += int((((diff >> (4 * n)) & 0xF) != 0)[real].sum())
    return bad


def plane_outputs(mode: int, n: int, t: int, q: int, dev):
    """The plane kernel's outputs in ``mode`` (0 traceback, 1 samples, 2
    best score), allocated as its wrapper allocates them."""
    if mode == 0:
        return (torch.empty((6, n), dtype=torch.int32, device=dev),
                torch.zeros((n, plane_words(t, q), t + 1), dtype=torch.int32,
                            device=dev))
    if mode == 1:
        return tuple(torch.zeros((n, t + q - 1), dtype=torch.int32,
                                 device=dev) for _ in range(2))
    return (torch.empty((n,), dtype=torch.int32, device=dev),)


def simulate(rng: np.random.Generator, ref_len: int, n_reads: int,
             read_len: int, err: float = 0.01
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ref, reads, true_pos): a uniform random ACGT reference and reads
    drawn from it with substitutions at rate ``err``, the draws of
    ``tools/run_scale_configs.py:31 simulate`` in their order (BASELINE
    config 4's workload).  The reference is drawn as uint8 indices, 2 B a
    base at its peak (``rng.choice`` would hold int64 indices, 8 B)."""
    ref = ACGT[rng.integers(0, 4, size=ref_len, dtype=np.uint8)]
    true_pos = rng.integers(0, ref_len - read_len, size=n_reads)
    reads = ref[true_pos[:, None] + np.arange(read_len)[None, :]].copy()
    mut = rng.random(reads.shape) < err
    reads[mut] = ACGT[(np.searchsorted(ACGT, reads[mut])
                       + rng.integers(1, 4, int(mut.sum()))) % 4]
    return ref, reads, true_pos


def simulate_reads(seed: int, ref_len: int, n_reads: int, read_len: int,
                   err: float = 0.01
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`simulate` drawn from ``seed``."""
    return simulate(np.random.default_rng(seed), ref_len, n_reads, read_len,
                    err)


# the JAX package's long SW pairs (tests/test_streaming_kernels.py:301-304,
# :340-343): seed, target length and the query's slice of the target
LONG_SW_PAIRS = {"20k_x_5k": (11, 20_000, 7_000, 12_000),
                 "12k_x_6.5k": (23, 12_000, 2_500, 9_000)}


def long_sw_pair(seed: int, tlen: int, q_lo: int, q_hi: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(target, query) by the JAX package's long-pair recipe: a random
    target of ``tlen`` bases and its slice [q_lo, q_hi) at 1%
    substitutions."""
    rng = np.random.default_rng(seed)
    tgt = rng.choice(ACGT, tlen)
    q = tgt[q_lo:q_hi].copy()
    mut = rng.random(len(q)) < 0.01
    q[mut] = rng.choice(ACGT, int(mut.sum()))
    return tgt, q


def long_sw_batch(seed: int, n_pairs: int = 64, tlen: int = 8_000,
                  qlen: int = 2_000, n_full: int = 48
                  ) -> tuple[list[bytes], list[bytes]]:
    """``n_pairs`` pairs of up to ``tlen`` x ``qlen``: the first ``n_full``
    at exactly that size, so that one length bucket holds them all, the
    rest of 3/4 to full length each way (a bucket of its own each, as
    lengths past the bucket grid take exact-size buckets).  Each query is
    a slice of its target at 1% substitutions with a 3-base deletion and
    a 2-base insertion."""
    rng = np.random.default_rng(seed)
    targets, queries = [], []
    for k in range(n_pairs):
        tl = tlen if k < n_full else int(rng.integers(tlen * 3 // 4, tlen))
        ql = qlen if k < n_full else int(rng.integers(qlen * 3 // 4, qlen))
        t = rng.choice(ACGT, tl)
        st = int(rng.integers(0, tl - ql - 2))
        q = t[st:st + ql + 1].copy()
        q[rng.random(len(q)) < 0.01] = rng.choice(ACGT)
        p = int(rng.integers(ql // 4, ql // 2))
        q = np.concatenate([q[:p], q[p + 3:2 * p], rng.choice(ACGT, 2),
                            q[2 * p:]])[:ql]
        targets.append(t.tobytes())
        queries.append(q.tobytes())
    return targets, queries


LONG_SW_BATCH = "64 x 8000x2000"
LONG_SW_SHAPES = (*LONG_SW_PAIRS, LONG_SW_BATCH)
LONG_SW_SAMPLE = 8         # pairs of a long batch held to the plain path


def long_sw_shape(name: str) -> tuple[list[bytes], list[bytes]]:
    """(targets, queries) of the long SW shape ``name``: a pair of
    LONG_SW_PAIRS, or LONG_SW_BATCH, :func:`long_sw_batch` of seed 3."""
    if name == LONG_SW_BATCH:
        return long_sw_batch(3)
    return tuple([x.tobytes()] for x in long_sw_pair(*LONG_SW_PAIRS[name]))


def long_sw_sample(n_pairs: int) -> np.ndarray:
    """The pairs of a long SW shape held to the plain path: all of them up
    to LONG_SW_SAMPLE, else LONG_SW_SAMPLE drawn from seed 4."""
    if n_pairs <= LONG_SW_SAMPLE:
        return np.arange(n_pairs)
    return np.sort(np.random.default_rng(4).choice(n_pairs, LONG_SW_SAMPLE,
                                                   replace=False))


def sw_plain_cigars(name: str, device="cuda") -> tuple[dict, float]:
    """({strategy code: [(cigar, offset)]} of :func:`long_sw_sample`'s
    pairs of the long SW shape ``name`` by the plain path on ``device``,
    seconds it took): ``sw_banded_plain`` once a value of ``indel_init``
    (the matrix depends on nothing else), then the host decoder in each
    strategy, as ``align_batch_banded`` decodes the kernel's words.
    Importable by a spawned process."""
    from mgl_tpu_torch.core.params import OverhangStrategy
    from mgl_tpu_torch.kernels.sw_cuda import decode_cigars
    from mgl_tpu_torch.ops.sw import banded_layout, sw_banded_plain

    t0 = time.perf_counter()
    targets, queries = long_sw_shape(name)
    pick = long_sw_sample(len(targets))
    sub_t = [targets[i] for i in pick]
    sub_q = [queries[i] for i in pick]
    args = sw_tensors(sub_t, sub_q, device)
    wpb = banded_layout(args[0].shape[1], args[1].shape[1])[1]
    tlen, qlen = (np.array([len(x) for x in xs], np.int32)
                  for xs in (sub_t, sub_q))
    out = {}
    for indel in (False, True):
        ez, words = sw_banded_plain(*args, 25, -50, 110, 6, indel_init=indel)
        ez, words = ez.cpu().numpy(), words.cpu().numpy()
        for s in OverhangStrategy:
            if bool(s & (OverhangStrategy.INDEL
                         | OverhangStrategy.LEADING_INDEL)) == indel:
                out[int(s)] = decode_cigars(ez, words, tlen, qlen, s, wpb)
    return out, time.perf_counter() - t0


def long_pairhmm_set(seed: int, hap_len: int, n_reads: int = 3,
                     read_len: int = 250) -> tuple[list[dict], list]:
    """(reads, [hap]): ``n_reads`` reads of ``read_len`` bases at 2%
    substitutions, drawn from a random hap of ``hap_len`` at starts below
    hap_len - 400, qualities 20-39 - the JAX package's long-hap recipe
    (tests/test_streaming_kernels.py:375-383, seed 47, 5,600 bp)."""
    rng = np.random.default_rng(seed)
    hap = rng.choice(ACGT, hap_len)
    reads = []
    for _ in range(n_reads):
        st = int(rng.integers(0, hap_len - 400))
        b = hap[st:st + read_len].copy()
        mut = rng.random(read_len) < 0.02
        b[mut] = rng.choice(ACGT, int(mut.sum()))
        q = rng.integers(20, 40, read_len).astype(np.uint8)
        reads.append(dict(bases=b, q=q, i=q, d=q,
                          c=np.full(read_len, 10, np.uint8)))
    return reads, [hap]


def long_read_set(seed: int, n_reads: int = 4, read_len: int = 4_000,
                  n_haps: int = 3, hap_len: int = 6_000, err: float = 0.02
                  ) -> tuple[list[dict], list]:
    """(reads, haps): ``n_haps`` haps of ``hap_len``, the first random and
    each next one the one before with 8 SNPs, and ``n_reads`` reads of
    ``read_len`` drawn from them in turn at ``err`` substitutions,
    qualities 20-39: every pair related, and every likelihood far under
    the f32 pass's 1e-28 gate, so the f64 rescue takes them all."""
    rng = np.random.default_rng(seed)
    haps = [rng.choice(ACGT, hap_len)]
    for _ in range(n_haps - 1):
        h = haps[-1]
        for p in rng.integers(0, hap_len, 8):
            h = snp(h, int(p))
        haps.append(h)
    reads = []
    for k in range(n_reads):
        st = int(rng.integers(0, hap_len - read_len + 1))
        b = haps[k % n_haps][st:st + read_len].copy()
        mut = rng.random(read_len) < err
        b[mut] = rng.choice(ACGT, int(mut.sum()))
        q = rng.integers(20, 40, read_len).astype(np.uint8)
        reads.append(dict(bases=b, q=q, i=q, d=q,
                          c=np.full(read_len, 10, np.uint8)))
    return reads, haps


# the engine's three modes, and the long PairHMM sets of the size range by
# name: the JAX package's TPU test (5.6 kbp), a hap past the TPU's remote
# compiler (16 kbp), and reads past its streaming tier's length
ENGINE_MODES = {"default": {}, "use_double": {"use_double": True},
                "fast_path": {"fast_path": True}}
LONG_PAIRHMM_SETS = {"long_hap": (long_pairhmm_set, (47, 5_600)),
                     "longer_hap": (long_pairhmm_set, (47, 16_000)),
                     "long_read": (long_read_set, (5,))}


def long_pairhmm(name: str) -> tuple[list[dict], list]:
    """(reads, haps) of the long PairHMM set ``name``."""
    fn, args = LONG_PAIRHMM_SETS[name]
    return fn(*args)


def engine_on_cpu(name: str, mode: str, threads: int = 1) -> np.ndarray:
    """The engine's (R, H) log10 matrix of the long set ``name`` in
    ``mode`` on ``device="cpu"``, with ``threads`` torch threads: the
    reference a card run is held to, importable by a spawned process."""
    from mgl_tpu_torch.api import PairHmmEngine

    torch.set_num_threads(threads)
    reads, haps = long_pairhmm(name)
    return PairHmmEngine(device="cpu", **ENGINE_MODES[mode]
                         ).compute_likelihoods(reads, haps)


# GRCh38's primary assembly, chr1-chr22, chrX, chrY: the contigs' lengths
# (the assembly's public sequence report), 3,088,269,832 bases
GRCH38_CONTIGS = tuple(zip(
    [f"chr{c}" for c in [*range(1, 23), "X", "Y"]],
    (248956422, 242193529, 198295559, 190214555, 181538259, 170805979,
     159345973, 145138636, 138394717, 133797422, 135086622, 133275309,
     114364328, 107043718, 101991189, 90338345, 83257441, 80373285,
     58617616, 64444167, 46709983, 50818468, 156040895, 57227415)))
GENOME_SEGMENT = 4_000_000


def genome_coords_reference(seed: int, segment: int = GENOME_SEGMENT,
                            contigs=GRCH38_CONTIGS):
    """(contigs [(name, uint8 array)], segment starts (n,) int64): each
    contig all 'N' but for one segment of ``segment`` random bases at a
    start drawn from the seed - a reference with GRCh38's coordinate space
    whose k-mers fill n x ``segment`` bases.  ~3.1 GB at the defaults."""
    rng = np.random.default_rng(seed)
    out, starts = [], []
    for name, n in contigs:
        seq = np.full(n, ord("N"), np.uint8)
        st = int(rng.integers(0, n - segment))
        seq[st:st + segment] = ACGT[rng.integers(0, 4, segment,
                                                 dtype=np.uint8)]
        out.append((name, seq))
        starts.append(st)
    return out, np.asarray(starts, np.int64)


def genome_reads(seed: int, contigs, seg_starts: np.ndarray,
                 n_reads: int, read_len: int = 150,
                 segment: int = GENOME_SEGMENT, err: float = 0.01,
                 del_frac: float = 0.02, del_at: int = 70, max_del: int = 2,
                 sep: int = 48, head: int = 12) -> dict:
    """Reads drawn evenly over the segments of
    :func:`genome_coords_reference`, on both strands at random, at ``err``
    substitutions, ``del_frac`` of them (sorted ``del_idx``) with a 1 to
    ``max_del`` bp deletion after read position ``del_at``, as
    :func:`deletion_reads`.  Returns a dict: reads (N, L) uint8; contig,
    local start and global start (N,), the last in
    ``ReferenceIndex.build_multi``'s coordinates with ``sep`` bases between
    contigs; reverse (N,) bool; del_idx; clean_head (N,) bool, no
    substitution and no deletion among the first ``head`` bases in the
    reference's orientation, where an optimal alignment starts at the true
    start."""
    rng = np.random.default_rng(seed)
    lens = np.array([len(s) for _, s in contigs], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens + sep)[:-1]])
    contig = np.arange(n_reads) % len(contigs)
    local = seg_starts[contig] + rng.integers(
        0, segment - read_len - max_del, n_reads)
    span = np.tile(np.arange(read_len), (n_reads, 1))
    del_idx = np.sort(rng.choice(n_reads, int(n_reads * del_frac),
                                 replace=False))
    span[del_idx, del_at:] += rng.integers(1, max_del + 1,
                                           len(del_idx))[:, None]
    reads = np.empty((n_reads, read_len), np.uint8)
    for c, (_, seq) in enumerate(contigs):
        sel = np.nonzero(contig == c)[0]
        reads[sel] = seq[local[sel, None] + span[sel]]
    mut = rng.random(reads.shape) < err
    reads[mut] = ACGT[(np.searchsorted(ACGT, reads[mut])
                       + rng.integers(1, 4, int(mut.sum()))) % 4]
    reverse = rng.random(n_reads) < 0.5
    from mgl_tpu_torch.pipelines.mapper import revcomp

    reads[reverse] = revcomp(reads[reverse])
    return {"reads": reads, "contig": contig, "local": local,
            "start": offsets[contig] + local, "reverse": reverse,
            "del_idx": del_idx,
            "clean_head": ~mut[:, :min(head, del_at)].any(axis=1)}


def indel_read_set() -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """``tests/test_mapper_scale.py:116``'s reads for the CIGAR walk: 96
    of 120 bp against a 120 kbp reference, in five kinds (exact, a 3 bp
    deletion, a 4 bp insertion, 10% mismatches with a clipped head, four
    SNPs and a 2 bp deletion): (ref, window starts, reads, wlen)."""
    rng = np.random.default_rng(5)
    ref = rng.choice(ACGT, size=120_000)
    L, N = 120, 96
    wlen = L + 48
    tp = rng.integers(24, len(ref) - L - 24, N)
    reads = np.zeros((N, L), np.uint8)
    for i in range(N):
        s = tp[i]
        r = ref[s: s + L].copy()
        kind = i % 5
        if kind == 1:
            r = np.concatenate([ref[s: s + 50], ref[s + 53: s + L + 3]])
        elif kind == 2:
            r = np.concatenate([ref[s: s + 60], rng.choice(ACGT, 4),
                                ref[s + 60: s + L - 4]])
        elif kind == 3:
            m = rng.random(L) < 0.1
            r[m] = rng.choice(ACGT, int(m.sum()))
            r[:7] = rng.choice(ACGT, 7)
        elif kind == 4:
            for o in (20, 45, 70, 95):
                r[o] = ACGT[(int(np.searchsorted(ACGT, r[o])) + 1) % 4]
            r = np.concatenate([r[:30], r[32:], ref[s + L: s + L + 2]])
        reads[i] = r[:L]
    return ref, (tp - 24).astype(np.int64), reads, wlen


def deletion_sweep_set() -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """``tests/test_mapper_scale.py:160``'s reads: 32 of 120 bp, each
    with n evenly spaced 2 bp deletions, n = 10..17 four times (2n + 1 =
    21..35 walk segments, across the walk's SEG_CAP of 24), windows of
    200: (ref, window starts, reads, wlen)."""
    rng = np.random.default_rng(17)
    ref = rng.choice(ACGT, size=60_000)
    L, pad = 120, 40
    wlen = L + 2 * pad
    n_dels = list(range(10, 18)) * 4
    tp = rng.integers(pad, len(ref) - 2 * wlen, len(n_dels))
    reads = np.zeros((len(n_dels), L), np.uint8)
    for i, nd in enumerate(n_dels):
        s = int(tp[i])
        chunk = L // (nd + 1)
        span, got, parts = s, 0, []
        for j in range(nd + 1):
            take = chunk if j < nd else L - got
            parts.append(ref[span: span + take])
            got += take
            span += take + 2                      # a 2 bp deletion
        reads[i] = np.concatenate(parts)[:L]
    return ref, (tp - pad).astype(np.int64), reads, wlen


def walk_window_set() -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Reads that take the CIGAR walk kernel out of its windows: 36 of
    150 bp in windows of 198, half with one insertion of 9-40 bases and
    half with one deletion of 9-47 bases (as long as the window's 48 bases
    of slack allow: the window starts (48 - D) // 2 before the read), each
    event at target row 32k - 1, 32k or 32k + 1 of the window (k = 2, 3,
    4), so that its run crosses a band's edge or starts on one:
    (ref, window starts, reads, wlen)."""
    rng = np.random.default_rng(29)
    ref = rng.choice(ACGT, size=40_000)
    L, wlen = 150, 198
    rows = [32 * k + e for k in (2, 3, 4) for e in (-1, 0, 1)]
    ins = (9, 12, 17, 24, 31, 40)
    dels = (9, 16, 24, 33, 40, 47)
    tp = rng.integers(64, len(ref) - 2 * wlen, 36)
    reads = np.zeros((36, L), np.uint8)
    starts = np.zeros(36, np.int64)
    for i in range(36):
        s, row = int(tp[i]), rows[i % len(rows)]
        if i < 18:
            n = ins[i % len(ins)]
            pad = 24
            a = row - pad
            r = np.concatenate([ref[s:s + a], rng.choice(ACGT, n),
                                ref[s + a:s + L]])
        else:
            n = dels[i % len(dels)]
            pad = (48 - n) // 2
            a = row - pad
            r = np.concatenate([ref[s:s + a], ref[s + a + n:s + L + n]])
        reads[i] = r[:L]
        starts[i] = s - pad
    return ref, starts, reads, wlen


def deletion_reads(seed: int, ref: np.ndarray, n_reads: int, read_len: int,
                   err: float = 0.01, del_frac: float = 0.02,
                   del_at: int = 70, max_del: int = 2
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(reads, true_pos, del_idx): reads drawn from ``ref`` with
    substitutions at rate ``err``, of which ``del_frac`` (at random, sorted
    ``del_idx``) carry a 1 to ``max_del`` bp deletion after read position
    ``del_at`` - the error model of ``tools/run_scale_configs.py:117
    config4_cigar``, with the deletion reads spread over the batch."""
    rng = np.random.default_rng(seed)
    true_pos = rng.integers(0, len(ref) - read_len - max_del, size=n_reads)
    reads = ref[true_pos[:, None] + np.arange(read_len)[None, :]].copy()
    del_idx = np.sort(rng.choice(n_reads, int(n_reads * del_frac),
                                 replace=False))
    d = rng.integers(1, max_del + 1, len(del_idx))
    tail = true_pos[del_idx, None] + d[:, None] + np.arange(
        del_at, read_len)[None, :]
    reads[del_idx, del_at:] = ref[tail]
    mut = rng.random(reads.shape) < err
    reads[mut] = ACGT[(np.searchsorted(ACGT, reads[mut])
                       + rng.integers(1, 4, int(mut.sum()))) % 4]
    return reads, true_pos, del_idx


def write_map_inputs(directory, seed: int, lens=None):
    """A two-contig FASTA (20 and 15 kbp; the first 60 bases of each in
    lowercase, 70 a line) and a FASTQ of 40 reads (100 bp unless ``lens``
    gives each length) in ``directory``: exact, with two SNPs, with a 2 bp
    deletion, with a 2 bp insertion, reverse-complemented, and random
    (unmapped), in turn.  Returns the (fasta, fastq) paths."""
    import pathlib

    directory = pathlib.Path(directory)
    rng = np.random.default_rng(seed)
    contigs = {"chrA": rng.choice(ACGT, 20_000),
               "chrB": rng.choice(ACGT, 15_000)}
    fa = directory / "ref.fa"
    with open(fa, "w") as f:
        for name, seq in contigs.items():
            s = seq.tobytes().decode()
            f.write(f">{name} test contig\n")
            f.write(s[:60].lower() + "\n")
            for i in range(60, len(s), 70):
                f.write(s[i: i + 70] + "\n")
            f.write("\n")
    lens = [100] * 40 if lens is None else lens
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    fq = directory / "reads.fq"
    with open(fq, "w") as f:
        for i, L in enumerate(lens):
            seq = contigs["chrA" if i % 2 else "chrB"]
            st = int(rng.integers(0, len(seq) - L - 10))
            kind = i % 6
            if kind == 2:       # a 2 bp deletion at 50
                r = np.concatenate([seq[st: st + 50],
                                    seq[st + 52: st + L + 2]])
            elif kind == 3:     # a 2 bp insertion at 40
                r = np.concatenate([seq[st: st + 40], rng.choice(ACGT, 2),
                                    seq[st + 40: st + L - 2]])
            elif kind == 5:
                r = rng.choice(ACGT, L)
            else:
                r = seq[st: st + L].copy()
            if kind == 1:       # two SNPs
                for p in (20, L - 30):
                    r[p] = ACGT[(np.searchsorted(ACGT, r[p]) + 1) % 4]
            b = r.tobytes()
            if kind == 4:
                b = b.translate(rc)[::-1]
            q = (rng.integers(2, 41, L) + 33).astype(np.uint8).tobytes()
            f.write(f"@r{i} extra\n{b.decode()}\n+\n{q.decode()}\n")
    return fa, fq


def window_starts(seed: int, ref_len: int, wlen: int, n_random: int
                  ) -> np.ndarray:
    """int64 window starts that reach every edge of the mapper's gather:
    all eight nibble shifts in the first words, the last eight valid
    starts, starts in the reference's last word (their windows run into
    the pad words), and ``n_random`` starts anywhere up to the last
    valid one."""
    rng = np.random.default_rng(seed)
    last = ref_len - wlen
    tail = (ref_len - 1) // 8 * 8
    return np.concatenate([
        np.arange(16), np.arange(last - 7, last + 1),
        np.arange(tail, ref_len),
        rng.integers(0, last + 1, n_random)]).astype(np.int64)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() in ms: CUDA events around ``iters`` calls
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    return timed_calls(fn, iters)[1]


def timed_calls(fn, iters: int = 1):
    """(the last call's output, mean device ms of ``iters`` calls of fn()
    by CUDA events)."""
    torch.cuda.synchronize()
    return _between_events(fn, iters)


def queued_ms(fn, iters: int) -> float:
    """Mean device ms of ``iters`` calls of fn(), enqueued behind a spin of
    the card (``torch.cuda._sleep``) that outlasts their host time, so the
    events bracket the calls' device work and not the host's launch
    overhead between them, which exceeds a small kernel's time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda._sleep(int(2 * iters * host_ms * _spin_cycles_per_ms())
                      + 1_000_000)
    return _between_events(fn, iters)[1]


@functools.cache
def _spin_cycles_per_ms() -> float:
    """Cycles ``torch.cuda._sleep`` counts in a millisecond on this card."""
    cycles = 20_000_000
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    stop.synchronize()
    return cycles / start.elapsed_time(stop)


def _between_events(fn, iters: int):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop) / iters


def step_inputs(seed: int, n_reads: int = 4096, n_haps: int = 12,
                rdlen: int = 151, haplen: int = 420, n_regions: int = 8):
    """Host inputs of ``parallel/pipeline.pipeline_step`` at a GATK shape:
    ``n_regions`` :func:`engine_region` regions of ``n_reads /
    n_regions`` reads (every 16th random, in the rescue tier) stacked into
    one tile against the first region's ``n_haps`` haps; the SW window is
    that region's first hap, replicated; keys are distinct-with-high-
    probability 62-bit draws.  (reads, haps, ref_window) in the step's
    layout (``make_example_inputs``'s keys and dtypes)."""
    from mgl_tpu_torch.core.context import CTX_F32, read_transition_rows
    from mgl_tpu_torch.parallel.sort import split_u64

    per = n_reads // n_regions
    regions = [engine_region(seed + k, per, n_haps, rdlen, haplen)
               for k in range(n_regions)]
    reads = [r for rs, _ in regions for r in rs]
    haps = regions[0][1]
    track = lambda key: np.stack([r[key] for r in reads])
    t = read_transition_rows(track("q"), track("i"), track("d"), track("c"),
                             CTX_F32)
    trans = np.zeros((n_reads, 7, rdlen + 1), np.float32)
    for k in range(5):
        trans[:, k] = t[k]
    trans[:, 5] = (np.float32(1.0) - t[5]).astype(np.float32)
    trans[:, 6] = (t[5] * (np.float32(1.0) / np.float32(3.0))).astype(
        np.float32)
    bases = track("bases").astype(np.int32)
    rchar = np.zeros((n_reads, rdlen + 1), np.int32)
    rchar[:, 1:] = bases
    keys = np.random.default_rng(seed).integers(0, 2**62, n_reads).astype(
        np.uint64)
    key_hi, key_lo = split_u64(keys)
    hap = np.stack(haps).astype(np.int32)
    return ({"rchar": rchar, "rslen": np.full(n_reads, rdlen, np.int32),
             "trans": trans, "query": bases,
             "qlen": np.full(n_reads, rdlen, np.int32),
             "key_hi": key_hi, "key_lo": key_lo},
            {"hap": hap, "haplen": np.full(n_haps, haplen, np.int32),
             "y_init": np.full(n_haps, np.float32(CTX_F32.initial_constant)
                               / np.float32(haplen), np.float32)},
            {"target": hap[:1].copy(), "tlen": np.full(1, haplen, np.int32)})


# ---- the parallel layer's multi-process targets: spawned ranks
# (parallel/dryrun.run_ranks) and worker processes import them by name

def sort_keys_full_range(seed: int, n: int) -> np.ndarray:
    """n uint64 keys over the full range: random draws, some duplicated,
    some equal to the all-ones padding key of ``sort_records``, and 0."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**64 - 1, size=n, dtype=np.uint64, endpoint=True)
    keys[rng.integers(0, n, n // 16)] = np.uint64(0xFFFFFFFFFFFFFFFF)
    keys[rng.integers(0, n, n // 16)] = keys[rng.integers(0, n, n // 16)]
    keys[0] = 0
    return keys


def mesh_suite(rank: int, pipelines, sorts, out_dir: str) -> None:
    """One rank of the parallel layer's CPU tests: for each (n_dp, n_hp,
    seed, kwargs) of ``pipelines`` the step on that mesh over
    ``make_example_inputs``, and for each (n_dp, n_hp, keys) of ``sorts``
    ``sort_records`` over dp; rank 0 saves the gathered outputs as
    ``pipe_<n_dp>x<n_hp>_<seed>.npz`` and ``sort_<n_dp>x<n_hp>.npz``."""
    from mgl_tpu_torch.parallel.launcher import collect_global
    from mgl_tpu_torch.parallel.mesh import AXES, make_mesh
    from mgl_tpu_torch.parallel.pipeline import (make_example_inputs,
                                                 pipeline_step)
    from mgl_tpu_torch.parallel.sort import sort_records

    out = pathlib.Path(out_dir)
    for n_dp, n_hp, seed, kw in pipelines:
        mesh = make_mesh(n_dp, n_hp)
        _, local = make_example_inputs(mesh, seed=seed, **kw)
        got = {k: collect_global(mesh, v,
                                 AXES if k == "likelihoods" else ("dp",))
               for k, v in pipeline_step(mesh)(*local).items()}
        if rank == 0:
            np.savez(out / f"pipe_{n_dp}x{n_hp}_{seed}.npz", **got)
    for n_dp, n_hp, keys in sorts:
        mesh = make_mesh(n_dp, n_hp)
        ks, vs = sort_records(keys, np.arange(len(keys), dtype=np.int32),
                              mesh)
        if rank == 0:
            np.savez(out / f"sort_{n_dp}x{n_hp}.npz", keys=ks, vals=vs)


def spmd_suite(rank: int, workload: str, shapes, out_dir: str) -> None:
    """One rank of the SPMD test: ``ChunkRunner`` over the whole workload
    on each (n_dp, n_hp) mesh of ``shapes``; every rank saves the global
    outputs it got as ``spmd_<n_dp>x<n_hp>_<rank>.npz``."""
    from mgl_tpu_torch.parallel.launcher import ChunkRunner, load_workload
    from mgl_tpu_torch.parallel.mesh import make_mesh

    reads, haps, ref = load_workload(workload)
    for n_dp, n_hp in shapes:
        runner = ChunkRunner(make_mesh(n_dp, n_hp), haps, ref)
        got = runner.run(reads, 0, len(reads["rslen"]))
        np.savez(pathlib.Path(out_dir) / f"spmd_{n_dp}x{n_hp}_{rank}.npz",
                 **got)


def align_sort_rank(rank: int, ref: np.ndarray, reads: np.ndarray,
                    out_dir: str) -> None:
    """One rank of ``align_and_sort`` on a (world, 1) mesh on the CPU; rank
    0 saves its keys and order as ``align_sort.npz``."""
    from mgl_tpu_torch.parallel.mesh import make_mesh
    from mgl_tpu_torch.pipelines.align_sort import align_and_sort
    from mgl_tpu_torch.pipelines.mapper import ReferenceIndex

    got = align_and_sort(ReferenceIndex.build(ref, k=16), reads,
                         mesh=make_mesh(), device="cpu")
    if rank == 0:
        np.savez(pathlib.Path(out_dir) / "align_sort.npz", keys=got["keys"],
                 order=got["order"])


def elastic_worker(host: str, port: int, name: str, heartbeat_ttl: float
                   ) -> int:
    """A worker process of the transport's kill -9 test (the port's copy of
    ``tests/helpers/elastic_worker.py``): each shard sleeps payload["t"]
    seconds and returns payload["x"] squared; a payload whose "hang_for"
    is this worker's name sleeps until the worker is killed."""
    from mgl_tpu_torch.parallel.transport import run_worker

    def work(payload):
        if payload.get("hang_for") == name:
            time.sleep(3600)
        time.sleep(payload.get("t", 0))
        return payload["x"] ** 2

    n = run_worker((host, port), work, name, heartbeat_ttl=heartbeat_ttl)
    print(f"{name} committed {n}", flush=True)
    return n
