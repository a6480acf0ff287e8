"""Host runtime of the port: the bulk CIGAR decoders and the ScoreMax scan
of the SW path.

The port's copies of ``mgl_tpu.native.cigar_decode_bulk``,
``cigar_decode_bulk_banded`` and ``score_max_bulk``: ctypes bindings of
``csrc/host/cigar_decode.cpp``, which ``_build`` compiles with g++ at
first use.  If the library cannot be built or loaded, the call raises;
there is no Python fallback.
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
        n_threads or min(8, os.cpu_count() or 1), *layout)
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
