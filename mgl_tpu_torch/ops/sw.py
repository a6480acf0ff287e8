"""Plain torch Smith-Waterman: the SW kernels' plain versions.

Counterpart of ``mgl_tpu/ops/sw.py``: the anti-diagonal recurrence of
``sw_forward`` (:61) with the reference's tie rules (``ops/sw.py:17-19``,
``docs/DESIGN.md`` section 4): move priority diag >= INS >= DEL, gap open
on strictly greater only, last column by '>=' (largest row wins), last row
by '>' or equal-and-closer-to-diagonal.  The recurrence (:func:`_wavefront`)
and the ScoreMax rules (:class:`_ScoreMax`) are written once; the plain
versions differ only in how they lay out what it yields, each emitting
what its CUDA kernel emits, so the two are compared on the card bit for
bit:

* :func:`sw_banded_plain` (``csrc/sw_banded.cu``): ``ez`` (6, B) int32
  ScoreMax rows mqe, mqe_t, max, max_t, max_q, seg_length
  (``ops/sw.py:192 compute_score_max``) and the traceback nibbles in the
  per-pair banded layout (:func:`banded_layout`);
* :func:`sw_plane_plain` (``csrc/sw_plane.cu``, traceback and samples
  modes): ``ez`` and the nibbles in the per-pair plane layout, or the
  per-diagonal last-column / last-row samples;
* :func:`sw_plane_scores_plain` (``csrc/sw_plane.cu``, best-score mode):
  the best score alone.

Each runs one step per anti-diagonal over (B, rows) tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from mgl_tpu_torch.core.params import DP_NEG_INF

BAND = 32
EZ_KEYS = ("mqe", "mqe_t", "max", "max_t", "max_q", "seg_length")


def banded_layout(t_max: int, q_max: int) -> tuple[int, int]:
    """(NB, WPB) of the per-pair traceback layout for a batch padded to
    (t_max, q_max): NB bands of 32 target rows, WPB = (q_max + 31 + 7) // 8
    words per band.  Cell (i, j) lies in band (i-1)//32, lane s = (i-1)%32,
    at t = j-1+s: word band*WPB + t//8, nibble t%8.  A nibble is
    move (0 diag, 1 INS, 2 DEL) | E-extend << 2 | F-extend << 3."""
    return (t_max + BAND - 1) // BAND, (q_max + BAND - 1 + 7) // 8


def plane_words(t_max: int, q_max: int) -> int:
    """Words a row of the per-pair plane layout for a batch padded to
    (t_max, q_max): (B, n_words, t_max + 1) int32, the nibble of cell
    (i, j) in word (i+j-2)//8 of row i at nibble (i+j-2)%8 (diagonals
    2 .. t_max+q_max).  Nibbles of cells outside 1 <= i <= tlen,
    1 <= j <= qlen are 0."""
    return (t_max + q_max - 1 + 7) // 8


def _shift_down(x: torch.Tensor, fill: int) -> torch.Tensor:
    """out[:, r] = x[:, r-1]; out[:, 0] = fill."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _to_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 words holding 32 bits -> the same bits as int32."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _wavefront(tgt: torch.Tensor, qry: torch.Tensor, rows: int, match: int,
               mismatch: int, gap_open: int, gap_ext: int, indel_init: bool,
               with_nibbles: bool):
    """The SW recurrence over rows 0 .. rows-1 of B pairs, one anti-diagonal
    a step: yields (d, sc, nib) for d = 2 .. T+Q, where sc (B, rows) int32
    holds H of cell (r, d-r) and nib (B, rows) int64 its traceback nibble
    (0 on the row-0 and column-0 borders), or None.  Cells past a pair's
    lengths, and rows past d, hold values no real cell reads."""
    dev = tgt.device
    B, T = tgt.shape
    Q = qry.shape[1]
    neg = DP_NEG_INF
    i32 = torch.int32
    tchar = torch.zeros((B, rows), dtype=i32, device=dev)
    tchar[:, 1:T + 1] = tgt.to(i32)
    qpad = torch.zeros((B, Q + rows + 1), dtype=i32, device=dev)
    qpad[:, :Q] = qry.to(i32)
    row = torch.arange(rows, device=dev)

    def border(k: int) -> int:
        # first-row / first-column score at index k (sw.cpp:29-40)
        return -gap_open - (k - 1) * gap_ext if indel_init and k >= 1 else 0

    sc_prev2 = torch.full((B, rows), neg, dtype=i32, device=dev)
    sc_prev2[:, 0] = 0                                       # diag 0
    sc_prev = torch.full((B, rows), neg, dtype=i32, device=dev)
    sc_prev[:, 0] = border(1)                                # cell (0, 1)
    sc_prev[:, 1] = border(1)                                # cell (1, 0)
    e_prev = torch.full((B, rows), neg, dtype=i32, device=dev)
    f_prev = torch.full((B, rows), neg, dtype=i32, device=dev)
    qdiag = torch.zeros((B, rows), dtype=i32, device=dev)
    qdiag[:, 0] = qpad[:, 0]

    for d in range(2, T + Q + 1):
        qdiag = torch.cat([qpad[:, d - 1:d], qdiag[:, :-1]], dim=1)
        # E (vertical, DEL) from the cell above; F (horizontal, INS) from
        # the cell to the left
        open_v = _shift_down(sc_prev, neg) - gap_open
        ext_v = _shift_down(e_prev, neg) - gap_ext
        open_wins_v = open_v > ext_v                         # strict >
        e_cur = torch.where(open_wins_v, open_v, ext_v)
        open_h = sc_prev - gap_open
        ext_h = f_prev - gap_ext
        open_wins_h = open_h > ext_h                         # strict >
        f_cur = torch.where(open_wins_h, open_h, ext_h)
        sub = torch.where(qdiag == tchar, match, mismatch).to(i32)
        diag_sc = _shift_down(sc_prev2, neg) + sub
        ef_max = torch.maximum(e_cur, f_cur)
        sc_cur = torch.maximum(diag_sc, ef_max)              # diag >= INS >= DEL

        # boundaries: element 0 is row 0 (j = d), element d is column 0
        boundary = (row == 0) | (row == d)
        sc_cur = torch.where(boundary, border(d), sc_cur).to(i32)
        e_cur = torch.where(boundary, neg, e_cur).to(i32)
        f_cur = torch.where(boundary, neg, f_cur).to(i32)

        nib = None
        if with_nibbles:
            move = torch.where(diag_sc >= ef_max, 0,
                               torch.where(f_cur >= e_cur, 1, 2))
            nib = (move | torch.where(open_wins_v, 0, 4)
                   | torch.where(open_wins_h, 0, 8)).to(torch.int64)
            nib = torch.where(boundary, 0, nib)
        yield d, sc_cur, nib

        sc_prev2, sc_prev = sc_prev, sc_cur
        e_prev, f_prev = e_cur, f_cur


def _samples(d: int, sc: torch.Tensor, tl: torch.Tensor, ql: torch.Tensor):
    """(lc, lc_ok, lr, lr_ok) of diagonal d, each (B,): the score of the
    last-column cell (d - qlen, qlen) and of the last-row cell
    (tlen, d - tlen) as int64, and whether each is a real cell."""
    rows = sc.shape[1]
    i_lc = d - ql
    lc = sc.gather(1, i_lc.clamp(0, rows - 1)[:, None])[:, 0].long()
    j_lr = d - tl
    lr = sc.gather(1, tl.clamp(0, rows - 1)[:, None])[:, 0].long()
    return (lc, (i_lc >= 1) & (i_lc <= tl), lr, (j_lr >= 1) & (j_lr <= ql))


class _ScoreMax:
    """The reference's ScoreMax (sw.cpp:100-127), updated one diagonal at a
    time: last-column rows ascend, so '>=' keeps the largest row; last-row
    columns ascend, taken on '>' or equal-and-closer-to-diagonal; then the
    last-row winner is merged against the last-column one."""

    def __init__(self, tl: torch.Tensor, ql: torch.Tensor):
        self.tl, self.ql = tl, ql
        neg = torch.full_like(tl, DP_NEG_INF)
        one = torch.ones_like(tl)
        self.mqe, self.mqe_t = neg, one
        self.rmax, self.rdist, self.rj = neg, torch.full_like(tl, 0x3FFFFFFF), one

    def update(self, d: int, sc: torch.Tensor) -> None:
        lc, lc_ok, lr, lr_ok = _samples(d, sc, self.tl, self.ql)
        take = lc_ok & (lc >= self.mqe)
        self.mqe = torch.where(take, lc, self.mqe)
        self.mqe_t = torch.where(take, d - self.ql, self.mqe_t)
        j_lr = d - self.tl
        dist = (self.tl - j_lr).abs()
        rtake = lr_ok & ((lr > self.rmax)
                         | ((lr == self.rmax) & (dist < self.rdist)))
        self.rmax = torch.where(rtake, lr, self.rmax)
        self.rdist = torch.where(rtake, dist, self.rdist)
        self.rj = torch.where(rtake, j_lr, self.rj)

    def ez(self) -> torch.Tensor:
        """(6, B) int32: mqe, mqe_t, max, max_t, max_q, seg_length."""
        tl, ql, rj = self.tl, self.ql, self.rj
        mqe_dist = (self.mqe_t - ql).abs()
        row_wins = (self.rmax > self.mqe) | ((self.rmax == self.mqe)
                                             & (self.rdist < mqe_dist))
        return torch.stack([
            self.mqe, self.mqe_t,
            torch.where(row_wins, self.rmax, self.mqe),
            torch.where(row_wins, tl, self.mqe_t),
            torch.where(row_wins, rj, ql),
            torch.where(row_wins, ql - rj, torch.zeros_like(rj)),
        ]).to(torch.int32)


def sw_banded_plain(tgt: torch.Tensor, qry: torch.Tensor, tlen: torch.Tensor,
                    qlen: torch.Tensor, match: int, mismatch: int,
                    gap_open: int, gap_ext: int, *, indel_init: bool,
                    with_traceback: bool = True):
    """Banded SW outputs for B pairs.  ``tgt`` (B, T) and ``qry`` (B, Q)
    uint8, zero-padded; ``tlen``/``qlen`` (B,) int32, each >= 1.  Scores
    as :class:`mgl_tpu_torch.core.params.SWParameters` holds them (gap
    open and extend as positive magnitudes).  Returns (ez, words (B, G, 32)
    int32 or None).

    On diagonal d every cell of band k sits at the same banded position
    t = d - 2 - 32k, and t % 8 is the same for all bands, so the nibbles
    of a diagonal pack into all bands' words at once and flush together
    every 8 diagonals."""
    dev = tgt.device
    B, T = tgt.shape
    Q = qry.shape[1]
    nb, wpb = banded_layout(T, Q)
    score_max = _ScoreMax(tlen.long(), qlen.long())
    if with_traceback:
        words = torch.zeros((B, nb * wpb, BAND), dtype=torch.int32,
                            device=dev)
    for d, sc, nib in _wavefront(tgt, qry, nb * BAND + 1, match, mismatch,
                                 gap_open, gap_ext, indel_init,
                                 with_traceback):
        score_max.update(d, sc)
        if not with_traceback:
            continue
        nib = nib[:, 1:].reshape(B, nb, BAND)
        phase = (d - 2) % 8
        acc = nib if phase == 0 else acc | (nib << (4 * phase))
        if phase == 7 or d == T + Q:
            # band k's word is w0 - 4k, flat index k*WPB + w0 - 4k: the
            # bands in range form one strided slice
            w0 = (d - 2) // 8
            k_lo = max(0, (w0 - wpb) // 4 + 1)
            k_hi = min(nb - 1, w0 // 4)
            if k_lo <= k_hi:
                g0 = k_lo * wpb + w0 - 4 * k_lo
                step = wpb - 4 if k_hi > k_lo else 1
                g1 = g0 + (k_hi - k_lo) * step + 1
                words[:, g0:g1:step] = _to_i32(acc[:, k_lo:k_hi + 1])
    return score_max.ez(), (words if with_traceback else None)


def sw_plane_plain(tgt: torch.Tensor, qry: torch.Tensor, tlen: torch.Tensor,
                   qlen: torch.Tensor, match: int, mismatch: int,
                   gap_open: int, gap_ext: int, *, indel_init: bool,
                   with_traceback: bool = True):
    """Plane SW outputs for B pairs, arguments as :func:`sw_banded_plain`:
    the plain version of ``csrc/sw_plane.cu`` and the counterpart of
    ``sw_pallas.py:45 _sw_kernel``.

    Traceback mode: (ez (6, B) int32, words (B, plane_words(T, Q), T+1)
    int32 in the plane layout, zero outside the real cells).  Samples mode
    (``with_traceback=False``): (lc, lr), each (B, T+Q-1) int32, entry
    d-2 holding the score of diagonal d's last-column cell (d - qlen,
    qlen) and last-row cell (tlen, d - tlen), 0 where that cell is not
    real; :func:`compute_score_max` turns them into ez."""
    dev = tgt.device
    B, T = tgt.shape
    Q = qry.shape[1]
    tl, ql = tlen.long(), qlen.long()
    rows = T + 1
    if with_traceback:
        score_max = _ScoreMax(tl, ql)
        words = torch.zeros((B, plane_words(T, Q), rows), dtype=torch.int32,
                            device=dev)
        row = torch.arange(rows, device=dev)[None, :]
        in_t = (row >= 1) & (row <= tl[:, None])
    else:
        lc_out = torch.zeros((B, T + Q - 1), dtype=torch.int32, device=dev)
        lr_out = torch.zeros_like(lc_out)
    for d, sc, nib in _wavefront(tgt, qry, rows, match, mismatch, gap_open,
                                 gap_ext, indel_init, with_traceback):
        if not with_traceback:
            lc, lc_ok, lr, lr_ok = _samples(d, sc, tl, ql)
            lc_out[:, d - 2] = torch.where(lc_ok, lc, 0).to(torch.int32)
            lr_out[:, d - 2] = torch.where(lr_ok, lr, 0).to(torch.int32)
            continue
        score_max.update(d, sc)
        j = d - row
        nib = torch.where(in_t & (j >= 1) & (j <= ql[:, None]), nib, 0)
        phase = (d - 2) % 8
        acc = nib if phase == 0 else acc | (nib << (4 * phase))
        if phase == 7 or d == T + Q:
            words[:, (d - 2) // 8] = _to_i32(acc)
    if with_traceback:
        return score_max.ez(), words
    return lc_out, lr_out


def sw_plane_scores_plain(tgt: torch.Tensor, qry: torch.Tensor,
                          tlen: torch.Tensor, qlen: torch.Tensor, match: int,
                          mismatch: int, gap_open: int, gap_ext: int, *,
                          indel_init: bool) -> torch.Tensor:
    """(B,) int32 best alignment score of each pair - the largest score over
    its last-row and last-column cells, the value part of sw.cpp:100-127
    with no tie bookkeeping - arguments as :func:`sw_banded_plain`: the
    plain version of ``csrc/sw_plane.cu``'s best-score mode and the
    counterpart of ``sw_pallas.py:689 _sw_score_kernel``."""
    tl, ql = tlen.long(), qlen.long()
    best = torch.full_like(tl, DP_NEG_INF)
    for d, sc, _ in _wavefront(tgt, qry, tgt.shape[1] + 1, match, mismatch,
                               gap_open, gap_ext, indel_init, False):
        lc, lc_ok, lr, lr_ok = _samples(d, sc, tl, ql)
        best = torch.maximum(best, torch.where(lc_ok, lc, DP_NEG_INF))
        best = torch.maximum(best, torch.where(lr_ok, lr, DP_NEG_INF))
    return best.to(torch.int32)


def compute_score_max(last_col: np.ndarray, last_row: np.ndarray,
                      tlen: np.ndarray, qlen: np.ndarray) -> dict:
    """ScoreMax per pair from the samples of :func:`sw_plane_plain` or the
    plane kernel's samples mode ((B, D-2) int32 each): a dict of (B,)
    int64 rows mqe, mqe_t, max, max_t, max_q, seg_length.  The counterpart
    of ``mgl_tpu/ops/sw.py:192``, through the port's host scan
    (``native.score_max_bulk``)."""
    from mgl_tpu_torch.native import score_max_bulk

    return score_max_bulk(last_col, last_row, tlen, qlen)
