"""Streaming BAM reader (BGZF + BAM record parsing), host side.

The port's copy of ``mgl_tpu/io/bam.py``, its code unchanged.

Enough to consume the reference repo's benchmark fixture
(src/test/resources/HiSeq.1mb.1RG.2k_lines.bam — shipped but unused by any
reference test, SURVEY.md §4) and feed reads into the PairHMM/mapper
pipelines.  BGZF is a sequence of concatenated gzip members, which
Python's gzip module decompresses *incrementally*: records are parsed
from a bounded rolling buffer, so arbitrarily large BAMs stream at
O(record) memory.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

_SEQ_NIBBLE = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
_CIGAR_OPS = "MIDNSHP=X"
_CHUNK = 1 << 20


class _Stream:
    """Bounded rolling buffer over an incrementally-decompressed file."""

    def __init__(self, fh):
        self._fh = fh
        self._buf = bytearray()
        self._pos = 0

    def take(self, n: int) -> bytes | None:
        """Next ``n`` decompressed bytes as an immutable copy (None at
        clean EOF).  Copies are required: callers hold returned slices
        across further ``take`` calls, and a live memoryview export
        would make the compaction ``del self._buf[:pos]`` raise
        BufferError (records are tiny, so the copy is cheap)."""
        while len(self._buf) - self._pos < n:
            chunk = self._fh.read(max(_CHUNK, n))
            if not chunk:                   # EOF before n bytes
                return None
            if self._pos:                   # drop consumed bytes
                del self._buf[: self._pos]
                self._pos = 0
            self._buf += chunk
        out = bytes(memoryview(self._buf)[self._pos: self._pos + n])
        self._pos += n
        return out


def _parse_record(rec: bytes) -> dict:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     _next_ref, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHiiii", rec)
    p = 32
    name = bytes(rec[p: p + l_read_name - 1]).decode()
    p += l_read_name
    cigar_ops = struct.unpack_from(f"<{n_cigar}I", rec, p)
    p += 4 * n_cigar
    cigar = "".join(f"{op >> 4}{_CIGAR_OPS[op & 0xF]}" for op in cigar_ops)
    n_seq_bytes = (l_seq + 1) // 2
    packed = np.frombuffer(rec, np.uint8, n_seq_bytes, p)
    p += n_seq_bytes
    nibbles = np.empty(n_seq_bytes * 2, np.uint8)
    nibbles[0::2] = packed >> 4
    nibbles[1::2] = packed & 0xF
    bases = _SEQ_NIBBLE[nibbles[:l_seq]]
    quals = np.frombuffer(rec, np.uint8, l_seq, p).copy()
    # remaining bytes are optional tags; skipped
    return dict(name=name, flag=flag, ref_id=ref_id, pos=pos, mapq=mapq,
                cigar=cigar, bases=bases, quals=quals)


def iter_bam(path, max_reads: int | None = None):
    """Stream a BAM file: yields (header, None) first, then (None, read)
    per record.  Memory stays O(largest record)."""
    with gzip.open(path, "rb") as fh:
        s = _Stream(fh)
        magic = s.take(4)
        if magic is None or bytes(magic) != b"BAM\x01":
            raise ValueError("not a BAM file")
        (l_text,) = struct.unpack("<i", bytes(s.take(4)))
        text = bytes(s.take(l_text)).decode(errors="replace")
        (n_ref,) = struct.unpack("<i", bytes(s.take(4)))
        refs = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", bytes(s.take(4)))
            name = bytes(s.take(l_name))[:-1].decode()
            (l_ref,) = struct.unpack("<i", bytes(s.take(4)))
            refs.append((name, l_ref))
        yield {"text": text, "refs": refs}, None

        n = 0
        while max_reads is None or n < max_reads:
            head = s.take(4)
            if head is None:
                return
            (block_size,) = struct.unpack("<i", bytes(head))
            rec = s.take(block_size)
            if rec is None:
                raise ValueError("truncated BAM record")
            yield None, _parse_record(rec)
            n += 1


def read_bam(path, max_reads: int | None = None):
    """Parse a BAM file into memory.

    Returns (header: dict, reads: list of dicts with keys
    name/flag/ref_id/pos/mapq/cigar/bases/quals).  ``pos`` is 0-based.
    For large inputs prefer :func:`iter_bam`.
    """
    it = iter_bam(path, max_reads=max_reads)
    header, _ = next(it)
    reads = [rec for _, rec in it]
    return header, reads
