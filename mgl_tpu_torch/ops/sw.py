"""Plain torch banded-output Smith-Waterman (the SW kernel's plain version).

Counterpart of ``mgl_tpu/ops/sw.py``: the anti-diagonal recurrence of
``sw_forward`` (:61) with the reference's tie rules (``ops/sw.py:17-19``,
``docs/DESIGN.md`` section 4): move priority diag >= INS >= DEL, gap open
on strictly greater only, last column by '>=' (largest row wins), last row
by '>' or equal-and-closer-to-diagonal.  It emits what the CUDA kernel
(``csrc/sw_banded.cu``) emits, so the two are compared on the card bit for
bit:

* ``ez``: (6, B) int32 ScoreMax rows mqe, mqe_t, max, max_t, max_q,
  seg_length (``ops/sw.py:192 compute_score_max``);
* ``words``: (B, G, 32) int32 traceback nibbles in the per-pair banded
  layout (see :func:`banded_layout`), or None in score-only mode.

It runs one step per anti-diagonal over (B, rows) tensors.  On diagonal d
every cell of band k sits at the same banded position t = d - 2 - 32k,
and t % 8 is the same for all bands, so the nibbles of a diagonal pack
into all bands' words at once and flush together every 8 diagonals.
"""

from __future__ import annotations

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


def _shift_down(x: torch.Tensor, fill: int) -> torch.Tensor:
    """out[:, r] = x[:, r-1]; out[:, 0] = fill."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def sw_banded_plain(tgt: torch.Tensor, qry: torch.Tensor, tlen: torch.Tensor,
                    qlen: torch.Tensor, match: int, mismatch: int,
                    gap_open: int, gap_ext: int, *, indel_init: bool,
                    with_traceback: bool = True):
    """Banded SW outputs for B pairs.  ``tgt`` (B, T) and ``qry`` (B, Q)
    uint8, zero-padded; ``tlen``/``qlen`` (B,) int32, each >= 1.  Scores
    as :class:`mgl_tpu_torch.core.params.SWParameters` holds them (gap
    open and extend as positive magnitudes).  Returns (ez, words)."""
    dev = tgt.device
    B, T = tgt.shape
    Q = qry.shape[1]
    nb, wpb = banded_layout(T, Q)
    R = nb * BAND + 1                       # rows 0 .. NB*32
    D = T + Q + 1                           # diagonals 0 .. T+Q
    neg = DP_NEG_INF
    i32, i64 = torch.int32, torch.int64

    tchar = torch.zeros((B, R), dtype=i32, device=dev)
    tchar[:, 1:T + 1] = tgt.to(i32)
    qpad = torch.zeros((B, Q + R + 1), dtype=i32, device=dev)
    qpad[:, :Q] = qry.to(i32)
    rows = torch.arange(R, device=dev)
    tl = tlen.to(i64)
    ql = qlen.to(i64)

    def border(k: int) -> int:
        return -gap_open - (k - 1) * gap_ext if indel_init and k >= 1 else 0

    sc_prev2 = torch.full((B, R), neg, dtype=i32, device=dev)
    sc_prev2[:, 0] = 0                                       # diag 0
    sc_prev = torch.full((B, R), neg, dtype=i32, device=dev)
    sc_prev[:, 0] = border(1)                                # cell (0, 1)
    sc_prev[:, 1] = border(1)                                # cell (1, 0)
    e_prev = torch.full((B, R), neg, dtype=i32, device=dev)
    f_prev = torch.full((B, R), neg, dtype=i32, device=dev)
    qdiag = torch.zeros((B, R), dtype=i32, device=dev)
    qdiag[:, 0] = qpad[:, 0]

    mqe = torch.full((B,), neg, dtype=i64, device=dev)
    mqe_t = torch.ones((B,), dtype=i64, device=dev)
    rmax = torch.full((B,), neg, dtype=i64, device=dev)
    rdist = torch.full((B,), 0x3FFFFFFF, dtype=i64, device=dev)
    rj = torch.ones((B,), dtype=i64, device=dev)

    if with_traceback:
        words_flat = torch.zeros((B, nb * wpb, BAND), dtype=i32, device=dev)
        acc = torch.zeros((B, nb, BAND), dtype=i64, device=dev)

    for d in range(2, D):
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
        boundary = (rows == 0) | (rows == d)
        sc_cur = torch.where(boundary, border(d), sc_cur).to(i32)
        e_cur = torch.where(boundary, neg, e_cur).to(i32)
        f_cur = torch.where(boundary, neg, f_cur).to(i32)

        # ScoreMax samples: last column rows ascend ('>=' keeps the last),
        # last row columns ascend ('>' or closer to the diagonal)
        i_lc = d - ql
        lc = sc_cur.gather(1, i_lc.clamp(0, R - 1)[:, None])[:, 0].to(i64)
        take = (i_lc >= 1) & (i_lc <= tl) & (lc >= mqe)
        mqe = torch.where(take, lc, mqe)
        mqe_t = torch.where(take, i_lc, mqe_t)
        j_lr = d - tl
        lr = sc_cur.gather(1, tl.clamp(0, R - 1)[:, None])[:, 0].to(i64)
        dist = (tl - j_lr).abs()
        rtake = ((j_lr >= 1) & (j_lr <= ql)
                 & ((lr > rmax) | ((lr == rmax) & (dist < rdist))))
        rmax = torch.where(rtake, lr, rmax)
        rdist = torch.where(rtake, dist, rdist)
        rj = torch.where(rtake, j_lr, rj)

        if with_traceback:
            move = torch.where(diag_sc >= ef_max, 0,
                               torch.where(f_cur >= e_cur, 1, 2))
            nib = (move | torch.where(open_wins_v, 0, 4)
                   | torch.where(open_wins_h, 0, 8)).to(i64)
            nib = nib[:, 1:].reshape(B, nb, BAND)
            phase = (d - 2) % 8
            acc = nib if phase == 0 else acc | (nib << (4 * phase))
            if phase == 7 or d == D - 1:
                # band k's word is w0 - 4k, flat index k*WPB + w0 - 4k:
                # the bands in range form one strided slice
                w0 = (d - 2) // 8
                k_lo = max(0, (w0 - wpb) // 4 + 1)
                k_hi = min(nb - 1, w0 // 4)
                if k_lo <= k_hi:
                    g0 = k_lo * wpb + w0 - 4 * k_lo
                    step = wpb - 4 if k_hi > k_lo else 1
                    g1 = g0 + (k_hi - k_lo) * step + 1
                    packed = acc[:, k_lo:k_hi + 1]
                    words_flat[:, g0:g1:step] = torch.where(
                        packed >= 2 ** 31, packed - 2 ** 32, packed).to(i32)

        sc_prev2, sc_prev = sc_prev, sc_cur
        e_prev, f_prev = e_cur, f_cur

    mqe_dist = (mqe_t - ql).abs()
    row_wins = (rmax > mqe) | ((rmax == mqe) & (rdist < mqe_dist))
    ez = torch.stack([
        mqe, mqe_t,
        torch.where(row_wins, rmax, mqe),
        torch.where(row_wins, tl, mqe_t),
        torch.where(row_wins, rj, ql),
        torch.where(row_wins, ql - rj, torch.zeros_like(rj)),
    ]).to(i32)
    if not with_traceback:
        return ez, None
    return ez, words_flat
