"""Packed request wire format of GATK's PairHMM binding.

The port's copy of ``mgl_tpu/batch/packed.py``: the buffer layout the
reference's Java binding builds and its JNI layer reads
(MicrosoftPairHmm.java:69-102 packing;
com_microsoft_mgl_pairhmm_MicrosoftPairHmm.cc:83-120 unpacking):

* lengths (int32): [numReads, readLen..., numHaps, hapLen...]
* reads   (bytes): per read, concatenated bases | readQuals | insGOP |
                   delGOP | overallGCP
* haps    (bytes): concatenated haplotype bases

:func:`compute_likelihoods_packed` runs the port's engine on such buffers,
on the card unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

_TRACKS = ("bases", "q", "i", "d", "c")


def pack_request(reads: list[dict], haps: list[np.ndarray]):
    """reads: dicts with uint8 arrays bases/q/i/d/c -> (lengths, reads_buf,
    haps_buf) in the reference wire format."""
    lengths = [len(reads)]
    blobs = []
    for rd in reads:
        n = len(rd["bases"])
        lengths.append(n)
        for k in _TRACKS:
            a = np.asarray(rd[k], dtype=np.uint8)
            if len(a) != n:
                raise ValueError(f"track {k} length mismatch")
            blobs.append(a)
    lengths.append(len(haps))
    hblobs = []
    for h in haps:
        h = np.asarray(h, dtype=np.uint8)
        lengths.append(len(h))
        hblobs.append(h)
    return (np.asarray(lengths, dtype=np.int32),
            np.concatenate(blobs) if blobs else np.zeros(0, np.uint8),
            np.concatenate(hblobs) if hblobs else np.zeros(0, np.uint8))


def unpack_request(lengths: np.ndarray, reads_buf: np.ndarray,
                   haps_buf: np.ndarray):
    """Inverse of :func:`pack_request`: (reads, haps) as zero-copy views
    into the buffers, walked as the JNI layer walks its pointers."""
    lengths = np.asarray(lengths, dtype=np.int32)
    reads_buf = np.asarray(reads_buf, dtype=np.uint8)
    haps_buf = np.asarray(haps_buf, dtype=np.uint8)

    k = 0
    n_reads = int(lengths[k])
    k += 1
    reads = []
    off = 0
    for _ in range(n_reads):
        n = int(lengths[k])
        k += 1
        tracks = {}
        for name in _TRACKS:
            tracks[name] = reads_buf[off: off + n]
            off += n
        reads.append(tracks)
    n_haps = int(lengths[k])
    k += 1
    haps = []
    hoff = 0
    for _ in range(n_haps):
        n = int(lengths[k])
        k += 1
        haps.append(haps_buf[hoff: hoff + n])
        hoff += n
    return reads, haps


def compute_likelihoods_packed(lengths, reads_buf, haps_buf,
                               use_double: bool = False,
                               fast_path: bool = False,
                               device: str | torch.device = "cuda"
                               ) -> np.ndarray:
    """The engine on packed buffers: the flat (R*H,) float64 array in the
    reference's likelihoodArray layout
    (com_microsoft_mgl_pairhmm_MicrosoftPairHmm.cc:155-157), empty for a
    request with no reads or no haps.

    A 0-length read or hap raises ``ValueError: empty sequence`` in every
    mode, as ``PairHmmEngine`` does: ``mgl_tpu/batch/packed.py:74-84``
    skips the engine's check and returns -inf, or raises ``IndexError`` or
    ``ZeroDivisionError``, by mode; GATK's binding never sends an empty
    sequence."""
    from mgl_tpu_torch.api import PairHmmEngine

    reads, haps = unpack_request(lengths, reads_buf, haps_buf)
    out = PairHmmEngine(use_double=use_double, fast_path=fast_path,
                        device=device).compute_likelihoods(reads, haps)
    return out.reshape(-1)
