"""NumPy reference oracle for banded affine-gap Smith-Waterman.

The port's copy of ``mgl_tpu/ref_impl/sw_scalar.py`` on the port's
``core/params``, for the opt-in self-check (``utils/debug_check``); no
other module of the port imports it.

Behavioral re-derivation of the reference scalar kernel
(the reference's ``mgl_sw/sw.cpp``) — the parity anchor for
the batched TPU kernels.  Key semantics replicated exactly:

* move priority diag >= INS(right) >= DEL(down)  (sw.cpp:60-71)
* gap open only on *strictly greater* (tie -> extend)  (sw.cpp:73-93)
* backtrack stores signed gap-run lengths (>0 DEL run, <0 INS run, 0 diag)
* last-column max uses ``>=`` so the largest row wins  (sw.cpp:100-104)
* last-row max uses ``>`` or tie-closer-to-diagonal (sw.cpp:115-127)
* CIGAR walk + overhang post-processing  (sw.cpp:149-255)

This oracle is vectorized along the query axis per target row (the E/F
row-wise recurrences are sequentialized the same way the C++ loop is), so it
is fast enough to fuzz thousands of pairs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from mgl_tpu_torch.core.params import (
    OverhangStrategy,
    STATE_CLIP,
    STATE_DEL,
    STATE_INS,
    STATE_MATCH,
    SWParameters,
    SW_NEG_INF,
)


def calculate_matrix(
    target: np.ndarray,
    query: np.ndarray,
    params: SWParameters,
    strategy: OverhangStrategy,
) -> Tuple[np.ndarray, dict]:
    """Full-matrix DP; returns (backtrack, score-max dict).

    ``target``/``query`` are uint8 arrays of ASCII bases.  The backtrack
    matrix has shape (tl+1, ql+1) with the reference encoding: 0 = diag,
    +L = DEL run of length L (move up), -L = INS run of length L (move left).
    Mirrors calculateMatrix (sw.cpp:5-146).
    """
    tl, ql = len(target), len(query)
    n, m = tl + 1, ql + 1
    w_match = np.int64(params.match)
    w_mismatch = np.int64(params.mismatch)
    w_open = np.int64(params.gap_open)
    w_ext = np.int64(params.gap_extend)

    indel_init = bool(strategy & (OverhangStrategy.INDEL | OverhangStrategy.LEADING_INDEL))

    # Row buffer sc[] = previous row's scores (sw.cpp:10-11).
    sc = np.zeros(m, dtype=np.int64)
    e = np.full(m, -w_open, dtype=np.int64)     # vertical (DEL) gap scores
    gap_v = np.ones(m, dtype=np.int64)
    if indel_init:
        j = np.arange(1, m)
        first_row = -w_open - (j - 1) * w_ext
        sc[1:] = first_row
        e[1:] += first_row

    btrack = np.zeros((n, m), dtype=np.int64)
    tgt = target.astype(np.int64)
    qry = query.astype(np.int64)
    sub_row = np.where(qry[None, :] == tgt[:, None], w_match, w_mismatch)

    mqe = SW_NEG_INF
    mqe_t = -1
    last_row = None

    for i in range(1, n):
        sc_first = np.int64(0)
        if indel_init:
            sc_first = -w_open - (i - 1) * w_ext

        # step_diag for the whole row: previous row's sc shifted + substitution
        diag = np.empty(m, dtype=np.int64)
        diag[1:] = sc[:-1] + sub_row[i - 1]

        # step_down candidates come from e[] (computed against row i-1);
        # they're fixed for the whole row before any update.
        step_down = e.copy()
        gap_down = gap_v.copy()

        # Row-wise F (INS) recurrence is serial in j; fold it together with
        # the cell selection.  f/gap_h start fresh each row (sw.cpp:20-26,36-39).
        f = -w_open + (sc_first if indel_init else 0)
        # NOTE sw.cpp:38 adds the indel term to the *initial* f[i]; the
        # non-indel case leaves f[i] = -g_open.
        if indel_init:
            f = -w_open + (-w_open - (i - 1) * w_ext)
        gap_h = 1

        row_sc = np.empty(m, dtype=np.int64)
        row_sc[0] = sc_first
        sc_prev = sc_first
        for j in range(1, m):
            step_diag = diag[j]
            sd = step_down[j]
            if step_diag >= sd and step_diag >= f:
                sc_cur = step_diag
                btrack[i, j] = 0
            elif f >= sd:
                sc_cur = f
                btrack[i, j] = -gap_h
            else:
                sc_cur = sd
                btrack[i, j] = gap_down[j]

            # update e (vertical) for the next row (sw.cpp:73-82)
            if sc_cur - w_open > e[j] - w_ext:
                e[j] = sc_cur - w_open
                gap_v[j] = 1
            else:
                e[j] -= w_ext
                gap_v[j] += 1
            # update f (horizontal) for the next column (sw.cpp:84-93)
            if sc_cur - w_open > f - w_ext:
                f = sc_cur - w_open
                gap_h = 1
            else:
                f -= w_ext
                gap_h += 1

            row_sc[j] = sc_cur
            sc_prev = sc_cur

        sc = row_sc
        # last-column max: >= so the largest i wins (sw.cpp:100-104)
        if sc_prev >= mqe:
            mqe = int(sc_prev)
            mqe_t = i
        last_row = row_sc

    # last-row max with tie-closer-to-diagonal rule (sw.cpp:115-127)
    ez = {
        "mqe": int(mqe), "mqe_t": int(mqe_t),
        "max": int(mqe), "max_t": int(mqe_t), "max_q": ql,
        "seg_length": 0,
    }
    for j in range(1, m):
        sc_cur = int(last_row[j])
        if sc_cur > ez["max"] or (
            sc_cur == ez["max"] and abs(tl - j) < abs(ez["max_t"] - ez["max_q"])
        ):
            ez["max_t"] = tl
            ez["max_q"] = j
            ez["max"] = sc_cur
            ez["seg_length"] = ql - j

    return btrack, ez


def calculate_cigar(
    btrack: np.ndarray,
    n: int,
    m: int,
    strategy: OverhangStrategy,
    ez: dict,
) -> Tuple[str, int]:
    """Run-length backtrack walk + overhang post-processing.

    Mirrors calculateCigar (sw.cpp:149-255).  Returns (cigar, offset).
    """
    ref_length, alt_length = n - 1, m - 1
    segment_length = 0

    if strategy == OverhangStrategy.INDEL:
        I, J = ref_length, alt_length
    elif strategy != OverhangStrategy.LEADING_INDEL:
        I, J = ez["max_t"], ez["max_q"]
        segment_length = ez["seg_length"]
    else:
        I, J = ez["mqe_t"], alt_length

    result = []  # appended at front, reversed at the end

    if segment_length > 0 and strategy == OverhangStrategy.SOFTCLIP:
        result.append((STATE_CLIP, segment_length))
        segment_length = 0

    state = STATE_MATCH
    while True:
        btr = int(btrack[I, J])
        if btr > 0:
            next_state, step_length = STATE_DEL, btr
        elif btr < 0:
            next_state, step_length = STATE_INS, -btr
        else:
            next_state, step_length = STATE_MATCH, 1

        if next_state == STATE_MATCH:
            I -= 1
            J -= 1
        elif next_state == STATE_INS:
            J -= step_length
        else:
            I -= step_length

        if next_state == state:
            segment_length += step_length
        else:
            result.append((state, segment_length))
            segment_length = step_length
            state = next_state

        if not (I > 0 and J > 0):
            break

    if strategy == OverhangStrategy.SOFTCLIP:
        result.append((state, segment_length))
        if J > 0:
            result.append((STATE_CLIP, J))
        alignment_offset = I
    elif strategy == OverhangStrategy.IGNORE:
        result.append((state, segment_length + J))
        alignment_offset = I - J
    else:  # INDEL / LEADING_INDEL
        result.append((state, segment_length))
        if I > 0:
            result.append((STATE_DEL, I))
        elif J > 0:
            result.append((STATE_INS, J))
        alignment_offset = 0

    cigar = "".join(
        f"{length}{st}" for st, length in reversed(result) if length > 0
    )
    return cigar, alignment_offset


def align(
    target: bytes | np.ndarray,
    query: bytes | np.ndarray,
    params: SWParameters,
    strategy: OverhangStrategy,
) -> Tuple[str, int]:
    """Single-pair alignment: (cigar, offset).  Mirrors align_scalar
    (sw.cpp:258-272)."""
    t = np.frombuffer(bytes(target), dtype=np.uint8) if not isinstance(
        target, np.ndarray) else target.astype(np.uint8)
    q = np.frombuffer(bytes(query), dtype=np.uint8) if not isinstance(
        query, np.ndarray) else query.astype(np.uint8)
    btrack, ez = calculate_matrix(t, q, params, strategy)
    return calculate_cigar(btrack, len(t) + 1, len(q) + 1, strategy, ez)
