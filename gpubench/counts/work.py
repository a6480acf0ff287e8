"""Operations and bytes that the inputs need, whatever kernel runs them.

PairHMM: 11 flops a cell (the forward's three products and sums), cells =
read length x the columns that a read must sweep.  Against a sorted hap
set a read sweeps each haplotype from the end of the prefix it shares with
the haplotype before it: the least sweep of a shared-hap-set kernel.
Bytes: the reads' five tracks and the haplotypes' bases read once, a
float32 score a pair written once.

Smith-Waterman: target x query cells a pair, 12 int32 operations a cell
for the score alone and 30 with the traceback's moves (the recurrence's
adds, compares and selects, and the move's encoding).  Bytes: both
sequences read once, the six ScoreMax ints written, and with the
traceback a 4-bit move a cell."""

from __future__ import annotations

import numpy as np

PAIRHMM_FLOPS_A_CELL = 11
SW_OPS_SCORE = 12
SW_OPS_TRACEBACK = 30


def shared_prefix(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


def pairhmm_f32(read_lens: np.ndarray, haps: list[np.ndarray]
                ) -> tuple[float, float]:
    """(flops, bytes) of a reads x sorted haps product in the f32 pass."""
    cols = sum(len(h) - (shared_prefix(haps[j - 1], h) if j else 0)
               for j, h in enumerate(haps))
    flops = PAIRHMM_FLOPS_A_CELL * float(np.sum(read_lens)) * cols
    nbytes = (5 * float(np.sum(read_lens)) + sum(len(h) for h in haps)
              + 4 * len(read_lens) * len(haps))
    return flops, nbytes


def sw(tlens, qlens, traceback: bool) -> tuple[float, float]:
    """(int32 ops, bytes) of SW pairs of these lengths."""
    t = np.asarray(tlens, float)
    q = np.asarray(qlens, float)
    cells = float(np.sum(t * q))
    ops = (SW_OPS_TRACEBACK if traceback else SW_OPS_SCORE) * cells
    nbytes = float(np.sum(t + q)) + 24 * len(t)
    if traceback:
        nbytes += cells / 2
    return ops, nbytes
