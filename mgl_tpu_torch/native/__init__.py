"""Host runtime of the port: the bulk CIGAR decoders and the ScoreMax scan
of the SW path, and the read mapper's seeding.

The port's copies of ``mgl_tpu.native.cigar_decode_bulk``,
``cigar_decode_bulk_banded`` and ``score_max_bulk`` (ctypes bindings of
``csrc/host/cigar_decode.cpp``), and of ``kmer_index_rows``,
``kmer_prefix_table``, ``radix_sort_kmers``, ``map_seed_vote`` and
``exact_nm`` (``csrc/host/mapper_seed.cpp``), with the same signatures.
``_build`` compiles both sources with g++ at first use.  If the library
cannot be built or loaded, the call raises; there is no Python fallback.
The seeding bindings return None only where ``mgl_tpu``'s do for the
shape of their input (k over 16, a reference of 2^32 bases or more), and
the mapper then takes its NumPy path, as ``mgl_tpu``'s does.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from mgl_tpu_torch import _build


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _threads(n_threads: int | None) -> int:
    return n_threads or min(8, os.cpu_count() or 1)


def _decode(entry: str, words: np.ndarray, pair_stride: int,
            row_stride: int, ez: dict, tlen: np.ndarray, qlen: np.ndarray,
            strategy: int, n_threads: int | None, *layout
            ) -> list[tuple[str, int]]:
    """Run the C decoder ``entry`` over B pairs; ``layout`` is what the
    banded entry takes after the thread count."""
    lib = _build.load_host_library()
    B = len(tlen)
    cap = 16 * max(int(tlen.max()), int(qlen.max())) + 16
    cigars = np.zeros((B, cap), np.uint8)
    offsets = np.zeros(B, np.int32)
    tl, ql = _i32(tlen), _i32(qlen)
    mx_t, mx_q = _i32(ez["max_t"]), _i32(ez["max_q"])
    seg, mq_t = _i32(ez["seg_length"]), _i32(ez["mqe_t"])
    getattr(lib, entry)(
        B, _ptr(words), pair_stride, row_stride,
        _ptr(tl), _ptr(ql), int(strategy),
        _ptr(mx_t), _ptr(mx_q), _ptr(seg), _ptr(mq_t),
        _ptr(cigars), cap, _ptr(offsets),
        _threads(n_threads), *layout)
    out = []
    for b in range(B):
        row = cigars[b]
        n = int(np.argmax(row == 0))
        out.append((row[:n].tobytes().decode(), int(offsets[b])))
    return out


def cigar_decode_bulk(words: np.ndarray, ez: dict, tlen: np.ndarray,
                      qlen: np.ndarray, strategy: int,
                      n_threads: int | None = None
                      ) -> list[tuple[str, int]]:
    """[(cigar, offset)] of B pairs from the plane SW kernel's outputs.

    ``words``: (B, n_words, R1) traceback words, per pair contiguous, in
    the plane layout (the nibble of cell (i, j) in word (i+j-2)//8 of row
    i); ``ez`` and ``strategy`` as :func:`cigar_decode_bulk_banded`."""
    words = np.ascontiguousarray(words, np.uint32)
    B, n_words, r1 = words.shape
    if (len(tlen) != B or len(qlen) != B or int(np.max(tlen)) >= r1
            or (int(np.max(np.add(tlen, qlen))) - 2) // 8 >= n_words):
        raise ValueError(f"words {words.shape} do not fit {len(tlen)} / "
                         f"{len(qlen)} lengths up to {int(np.max(tlen))} x "
                         f"{int(np.max(qlen))}")
    return _decode("cigar_decode_batch", words, n_words * r1, r1, ez, tlen,
                   qlen, strategy, n_threads)


def cigar_decode_bulk_banded(words: np.ndarray, ez: dict, tlen: np.ndarray,
                             qlen: np.ndarray, strategy: int, band_h: int,
                             words_per_band: int,
                             n_threads: int | None = None
                             ) -> list[tuple[str, int]]:
    """[(cigar, offset)] of B pairs from the banded SW kernel's outputs.

    ``words``: (B, G, band_h) traceback words, per pair contiguous, in the
    layout of :func:`mgl_tpu_torch.ops.sw.banded_layout`; ``ez``: dict of
    (B,) ScoreMax rows max_t, max_q, seg_length, mqe_t; ``strategy``: the
    OverhangStrategy code."""
    words = np.ascontiguousarray(words, np.uint32)
    B, G, BH = words.shape
    if BH != band_h or len(tlen) != B or len(qlen) != B:
        raise ValueError(f"words {words.shape} do not fit band_h {band_h} "
                         f"and {len(tlen)} / {len(qlen)} lengths")
    return _decode("cigar_decode_batch_banded", words, G * BH, BH, ez, tlen,
                   qlen, strategy, n_threads, int(band_h),
                   int(words_per_band), 1)


def score_max_bulk(last_col: np.ndarray, last_row: np.ndarray,
                   tlen: np.ndarray, qlen: np.ndarray) -> dict:
    """ScoreMax (ez) of B pairs from per-diagonal samples: ``last_col`` /
    ``last_row`` (B, D-2) int32, entry k holding diagonal k + 2's cell in
    the last column / last row.  Returns a dict of (B,) int64 rows mqe,
    mqe_t, max, max_t, max_q, seg_length."""
    lib = _build.load_host_library()
    lc, lr = _i32(last_col), _i32(last_row)
    B = len(tlen)
    if lc.shape != lr.shape or lc.ndim != 2 or lc.shape[0] != B:
        raise ValueError(f"samples {lc.shape} / {lr.shape} do not fit {B} "
                         f"pairs")
    tl, ql = _i32(tlen), _i32(qlen)
    if B and int((tl + ql).max()) - 1 > lc.shape[1]:
        raise ValueError(f"{lc.shape[1]} diagonals do not cover lengths "
                         f"{int(tl.max())} + {int(ql.max())}")
    outs = {k: np.zeros(B, np.int32) for k in
            ("mqe", "mqe_t", "max", "max_t", "max_q", "seg_length")}
    lib.score_max_batch(
        B, _ptr(lc), _ptr(lr), lc.shape[1], 1, _ptr(tl), _ptr(ql),
        *(_ptr(v) for v in outs.values()))
    return {k: v.astype(np.int64) for k, v in outs.items()}


def kmer_index_rows(code: np.ndarray, k: int):
    """Sorted canonical k-mer index rows of a 2-bit coded reference (k <=
    16): one C pass emits (canonical value, position, fwd-bit) for every
    valid (N-free) window, then the fused radix sort orders them.  Returns
    (keys uint32, pos uint32, fwd bool), or None for k over 16 or a
    reference of 2^32 bases or more."""
    if not (1 <= k <= 16) or len(code) >= 2**32:
        return None
    lib = _build.load_host_library()
    code = np.ascontiguousarray(code, np.uint8)
    cap = max(len(code) - k + 1, 0)
    keys = np.empty(cap, np.uint32)
    pos = np.empty(cap, np.uint32)
    fwd = np.empty(cap, np.uint8)
    n = lib.kmer_scan_canonical(len(code), _ptr(code), int(k), _ptr(keys),
                                _ptr(pos), _ptr(fwd))
    keys, pos, fwd = keys[:n], pos[:n], fwd[:n]
    radix_sort_kmers(keys, pos, fwd, 2 * k)
    return keys, pos, fwd.view(np.bool_)


def kmer_prefix_table(sorted_keys: np.ndarray, shift: int,
                      buckets: int) -> np.ndarray | None:
    """Prefix jump table (buckets+1 uint32 cumulative counts) over the
    sorted uint32 key column, or None for 2^32 keys or more."""
    if len(sorted_keys) >= 2**32:
        return None
    if sorted_keys.dtype != np.uint32 or not sorted_keys.flags.c_contiguous:
        raise ValueError("kmer_prefix_table takes contiguous uint32 keys")
    lib = _build.load_host_library()
    table = np.empty(buckets + 1, np.uint32)
    lib.kmer_prefix_table(len(sorted_keys), _ptr(sorted_keys), int(shift),
                          int(buckets), _ptr(table))
    return table


def radix_sort_kmers(keys: np.ndarray, pos: np.ndarray, fwd: np.ndarray,
                     key_bits: int) -> bool:
    """In-place stable LSD radix sort of parallel (uint32 keys, uint32
    positions, uint8/bool strand bits) rows by key: the index build's sort
    with the permutation fused into the scatter.  Returns True."""
    if keys.dtype != np.uint32 or pos.dtype != np.uint32 or (
            fwd.dtype not in (np.uint8, np.bool_)):
        raise ValueError("radix_sort_kmers takes uint32 keys and positions "
                         "and one-byte strand bits")
    if not all(a.flags.c_contiguous and a.flags.writeable
               for a in (keys, pos, fwd)):
        raise ValueError("radix_sort_kmers sorts contiguous writeable rows "
                         "in place")
    lib = _build.load_host_library()
    lib.radix_sort_kmer_index(len(keys), int(key_bits), _ptr(keys),
                              _ptr(pos), _ptr(fwd))
    return True


def map_seed_vote(reads: np.ndarray, index, stride: int,
                  n_threads: int | None = None):
    """Fused seed -> canonical lookup -> diagonal vote for a chunk of
    reads: the single-pass native form of the mapper's _seed_kmers +
    ReferenceIndex.lookup + _vote_diagonals (two-strand canonical mode).
    Returns (pos, votes, votes2, pos2) with 2N rows (forward rows then
    reverse rows), bit-identical to the NumPy path, or None when the index
    shape doesn't qualify (not canonical, k over 16, keys, positions or
    jump table wider than uint32)."""
    if (index.canon_fwd is None or index.k > 16
            or index.sorted_kmers.dtype != np.uint32
            or index.positions.dtype != np.uint32
            or len(index.ref) >= 2**32):
        return None
    ptable = index.prefix_table
    if ptable is not None and ptable.dtype != np.uint32:
        return None
    lib = _build.load_host_library()
    reads = np.ascontiguousarray(reads, np.uint8)
    N, L = reads.shape
    fwd = np.ascontiguousarray(index.canon_fwd.view(np.uint8))
    pos = np.empty(2 * N, np.int64)
    votes = np.empty(2 * N, np.int32)
    votes2 = np.empty(2 * N, np.int32)
    pos2 = np.empty(2 * N, np.int64)
    # shift so (kmer >> shift) indexes the jump table's buckets
    pshift = (2 * index.k - ((len(ptable) - 1).bit_length() - 1)
              if ptable is not None else 0)
    lib.map_seed_vote(
        N, L, _ptr(reads), int(index.k), int(stride),
        _ptr(index.sorted_kmers), _ptr(index.positions), _ptr(fwd),
        len(index.sorted_kmers),
        _ptr(ptable) if ptable is not None else None, pshift,
        int(index.max_hits), len(index.ref), _threads(n_threads),
        _ptr(pos), _ptr(votes), _ptr(votes2), _ptr(pos2))
    return pos, votes, votes2, pos2


def exact_nm(reads: np.ndarray, ref: np.ndarray, pos: np.ndarray,
             n_threads: int | None = None) -> np.ndarray:
    """(N,) int32 mismatch count of each (oriented) read vs the reference
    at its predicted start; columns outside the reference clamp to its
    first or last byte."""
    lib = _build.load_host_library()
    reads = np.ascontiguousarray(reads, np.uint8)
    ref = np.ascontiguousarray(ref, np.uint8)
    N, L = reads.shape
    pos = np.ascontiguousarray(pos, np.int64)
    nm = np.empty(N, np.int32)
    lib.exact_nm_batch(N, L, _ptr(reads), _ptr(ref), len(ref), _ptr(pos),
                       _ptr(nm), _threads(n_threads))
    return nm
