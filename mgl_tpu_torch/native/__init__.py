"""Host runtime of the port: the bulk CIGAR decoder of the SW path.

The port's copy of ``mgl_tpu.native.cigar_decode_bulk_banded``: a ctypes
binding of ``csrc/host/cigar_decode.cpp``, which ``_build`` compiles with
g++ at first use.  If the library cannot be built or loaded, the call
raises; there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from mgl_tpu_torch import _build


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


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
    lib = _build.load_host_library()
    words = np.ascontiguousarray(words, np.uint32)
    B, G, BH = words.shape
    if BH != band_h or len(tlen) != B or len(qlen) != B:
        raise ValueError(f"words {words.shape} do not fit band_h {band_h} "
                         f"and {len(tlen)} / {len(qlen)} lengths")
    cap = 16 * max(int(tlen.max()), int(qlen.max())) + 16
    cigars = np.zeros((B, cap), np.uint8)
    offsets = np.zeros(B, np.int32)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    tl, ql = i32(tlen), i32(qlen)
    mx_t, mx_q = i32(ez["max_t"]), i32(ez["max_q"])
    seg, mq_t = i32(ez["seg_length"]), i32(ez["mqe_t"])
    lib.cigar_decode_batch_banded(
        B, _ptr(words), G * BH, BH,
        _ptr(tl), _ptr(ql), int(strategy),
        _ptr(mx_t), _ptr(mx_q), _ptr(seg), _ptr(mq_t),
        _ptr(cigars), cap, _ptr(offsets),
        n_threads or min(8, os.cpu_count() or 1),
        int(band_h), int(words_per_band), 1,
    )
    out = []
    for b in range(B):
        row = cigars[b]
        n = int(np.argmax(row == 0))
        out.append((row[:n].tobytes().decode(), int(offsets[b])))
    return out
