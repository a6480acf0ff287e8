"""Minimal FASTA / FASTQ readers (host side, NumPy-backed).

The port's copy of ``mgl_tpu/io/fasta.py``, its code unchanged.

The reference has no IO layer (GATK feeds it arrays); these readers exist
so the mapper/align pipelines can be driven from standard files.
"""

from __future__ import annotations

import gzip
import pathlib

import numpy as np


def _open(path):
    path = pathlib.Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta(path) -> dict[str, np.ndarray]:
    """Returns {name: uint8 ASCII bases}."""
    out: dict[str, np.ndarray] = {}
    name = None
    chunks: list[bytes] = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    out[name] = np.frombuffer(b"".join(chunks), np.uint8)
                name = line[1:].split()[0].decode()
                chunks = []
            else:
                chunks.append(line.upper())
    if name is not None:
        out[name] = np.frombuffer(b"".join(chunks), np.uint8)
    return out


def read_fastq(path, max_reads: int | None = None):
    """Yields (name, bases uint8, quals uint8[phred, already -33])."""
    n = 0
    with _open(path) as f:
        while True:
            header = f.readline().strip()
            if not header:
                return
            seq = f.readline().strip().upper()
            f.readline()  # '+'
            qual = f.readline().strip()
            yield (header[1:].split()[0].decode(),
                   np.frombuffer(seq, np.uint8),
                   np.frombuffer(qual, np.uint8) - 33)
            n += 1
            if max_reads is not None and n >= max_reads:
                return
