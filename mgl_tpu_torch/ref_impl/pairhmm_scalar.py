"""NumPy reference oracle for the PairHMM forward algorithm.

The port's copy of ``mgl_tpu/ref_impl/pairhmm_scalar.py`` on the port's
``core/context``, for the opt-in self-check (``utils/debug_check``); no
other module of the port imports it.

Behavioral re-derivation of the reference full-matrix debug oracle
(the reference's ``mgl_pairhmm/pairhmm_common.h:84-171``,
``DebugCompute``) and the production recurrence
(``compute_prob_scalar.cc:39-43``):

    M[r][c] = distm * (M[r-1][c-1]*pMM[r] + (X[r-1][c-1]+Y[r-1][c-1])*pGapM[r])
    X[r][c] = M[r-1][c]*pMX[r] + X[r-1][c]*pZZ[r]
    Y[r][c] = M[r][c-1]*pMY[r] + Y[r][c-1]*pZZ[r]

Boundary: row 0 has M=X=0, Y=INITIAL_CONSTANT/haplen for every column;
column 0 is all-zero for r>=1 (X[r][0] recursively multiplies a zero seed,
pairhmm_common.h:140-145).  Result = sum over the last row of (M + X)
(compute_prob_scalar.cc:115-118, 211, 313).

The matrix sweep is vectorized column-by-column: M and Y at column c depend
only on column c-1, and the X intra-column recurrence is a first-order
linear scan handled row-by-row in NumPy (X[r] = M[r-1]*pMX + X[r-1]*pZZ
along rows within a column — but note X depends on the *previous* column's
row r... it depends on (r-1, c), same column).  We therefore sweep columns
with an inner row loop only for X — O(R) Python ops per column.
"""

from __future__ import annotations

import numpy as np

from mgl_tpu_torch.core.context import (
    CTX_F32,
    CTX_F64,
    QualityContext,
    read_transition_rows,
)

AMBIG = ord("N")


def compute_score(
    hap: np.ndarray,
    read_bases: np.ndarray,
    read_q: np.ndarray,
    read_i: np.ndarray,
    read_d: np.ndarray,
    read_c: np.ndarray,
    ctx: QualityContext = CTX_F32,
) -> float:
    """Raw (INITIAL_CONSTANT-scaled) forward probability of one read/hap pair.

    All sequence inputs are uint8 arrays (ASCII bases / raw phred bytes).
    """
    dt = ctx.dtype
    rows = len(read_bases) + 1
    cols = len(hap) + 1

    p_mm, p_gapm, p_mx, p_my, p_zz, distm_row = read_transition_rows(
        read_q, read_i, read_d, read_c, ctx
    )
    one = dt(1.0)
    third = dt(1.0) / dt(3.0)  # threeOver, in the context's own precision

    y_init = dt(ctx.initial_constant / dt(len(hap)))

    # match/mismatch emission per cell (r, c): bMatch if equal or either 'N'
    rs = read_bases.astype(np.uint8)
    hp = hap.astype(np.uint8)
    match = (rs[:, None] == hp[None, :]) | (rs[:, None] == AMBIG) | (hp[None, :] == AMBIG)
    d_col = distm_row[1:, None].astype(dt)  # per-row distm, broadcast over cols
    distm_cell = np.where(match, one - d_col, (d_col * third).astype(dt)).astype(dt)

    M_prev = np.zeros(rows, dtype=dt)
    X_prev = np.zeros(rows, dtype=dt)
    Y_prev = np.zeros(rows, dtype=dt)
    # column 0: row 0 -> (0, 0, y_init); rows >= 1 all zero
    Y_prev[0] = y_init

    result = dt(0.0) + (M_prev[-1] + X_prev[-1])  # c = 0 contribution (zeros)

    for c in range(1, cols):
        M_cur = np.zeros(rows, dtype=dt)
        X_cur = np.zeros(rows, dtype=dt)
        Y_cur = np.zeros(rows, dtype=dt)
        Y_cur[0] = y_init

        # M at column c: elementwise from column c-1 shifted down one row
        M_cur[1:] = (
            distm_cell[:, c - 1]
            * (M_prev[:-1] * p_mm[1:] + (X_prev[:-1] + Y_prev[:-1]) * p_gapm[1:])
        ).astype(dt)
        # Y at column c: elementwise from column c-1, same row
        Y_cur[1:] = (M_prev[1:] * p_my[1:] + Y_prev[1:] * p_zz[1:]).astype(dt)
        # X at column c: serial down the rows of column c
        for r in range(1, rows):
            X_cur[r] = dt(M_cur[r - 1] * p_mx[r] + X_cur[r - 1] * p_zz[r])

        result = dt(result + M_cur[-1] + X_cur[-1])
        M_prev, X_prev, Y_prev = M_cur, X_cur, Y_cur

    return float(result)


def compute_likelihoods(
    reads: list[dict],
    haps: list[np.ndarray],
    use_double: bool = False,
) -> np.ndarray:
    """Full precision-cascade likelihood matrix, log10 space.

    Mirrors the JNI layer's tiering
    (com_microsoft_mgl_pairhmm_MicrosoftPairHmm.cc:131-215): float pass
    first, pairs whose scaled score < MIN_ACCEPTED (1e-28) are recomputed in
    double.  Each read dict needs keys bases/q/i/d/c (uint8 arrays).
    Returns (num_reads, num_haps) float64 log10 likelihoods.
    """
    from mgl_tpu_torch.core.context import MIN_ACCEPTED

    out = np.zeros((len(reads), len(haps)), dtype=np.float64)
    for ri, read in enumerate(reads):
        for hi, hap in enumerate(haps):
            args = (hap, read["bases"], read["q"], read["i"], read["d"], read["c"])
            if use_double:
                score = compute_score(*args, ctx=CTX_F64)
                out[ri, hi] = np.log10(score) - CTX_F64.log10_initial_constant
            else:
                score = compute_score(*args, ctx=CTX_F32)
                if score < float(MIN_ACCEPTED):
                    score = compute_score(*args, ctx=CTX_F64)
                    out[ri, hi] = np.log10(score) - CTX_F64.log10_initial_constant
                else:
                    out[ri, hi] = np.log10(score) - CTX_F32.log10_initial_constant
    return out
