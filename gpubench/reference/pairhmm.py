"""PairHMM forward and GATK's f32 -> f64 likelihood cascade, in plain torch.

The recurrence of GATK's PairHMM (Intel GKL ``compute_prob_scalar``,
``pairhmm_common.h``), with X the gap in the read (vertical) and Y the gap
in the haplotype (horizontal):

    M[r][c] = distm(r, c) * (M[r-1][c-1] pMM[r] + (X[r-1][c-1] + Y[r-1][c-1]) pGapM[r])
    X[r][c] = M[r-1][c] pMX[r] + X[r-1][c] pZZ[r]
    Y[r][c] = M[r][c-1] pMY[r] + Y[r][c-1] pZZ[r]

row 0 holds M = X = 0 and Y = INITIAL_CONSTANT / haplen, column 0 is zero
below it, and the score is the sum over the last row of M + X, in
ascending columns.  The cascade scores every pair in float32 (scaled by
2^120); a pair whose score falls under 1e-28 is scored again in float64
(scaled by 2^1020).  log10 likelihood = log10(score) - log10(scale), with
log10(scale) rounded to the tier's precision as GKL stores it.

The quality tables are worked out here from their definitions in GKL's
``Context.h``: ph2pr[q] = 10^(-q/10); matchToMatch[i, j] =
1 - 10^approximateLog10SumLog10(-i/10, -j/10) (the Jacobian table of step
1e-4 and tolerance 8), clamped at 0 as the reference's tables are.

The sweep runs over anti-diagonals, every pair of a block at once, so it
runs on the card in plain torch.  ``dtype`` picks the precision of the
tables and of every operation: float32 / float64 for the reference,
bfloat16 / float32 for its control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MAX_QUAL = 254
JACOBIAN_STEP = 1e-4
JACOBIAN_TOLERANCE = 8.0
MIN_ACCEPTED = 1e-28
N_CODE = 4                      # an ambiguous base matches anything

_CODES = np.full(256, N_CODE, np.int64)
for _i, _b in enumerate(b"ACGT"):
    _CODES[_b] = _i
    _CODES[_b + 32] = _i


def base_codes(seq: np.ndarray) -> np.ndarray:
    """ASCII bases -> 0..3, anything but ACGT/acgt -> 4."""
    return _CODES[np.asarray(seq, np.uint8)]


def _tables64() -> tuple[np.ndarray, np.ndarray]:
    """(ph2pr (128,), matchToMatch (255 * 256 / 2,)) in float64."""
    ph2pr = 10.0 ** (-np.arange(128) / 10.0)
    n_jac = int(JACOBIAN_TOLERANCE / JACOBIAN_STEP) + 1
    jac = np.log10(1.0 + 10.0 ** (-np.arange(n_jac) * JACOBIAN_STEP))
    hi = np.concatenate([np.full(q + 1, q) for q in range(MAX_QUAL + 1)])
    lo = np.concatenate([np.arange(q + 1) for q in range(MAX_QUAL + 1)])
    big, small = -0.1 * lo, -0.1 * hi          # big >= small
    diff = big - small
    ind = np.minimum(np.floor(diff / JACOBIAN_STEP + 0.5).astype(np.int64),
                     n_jac - 1)
    log10_sum = np.where(diff >= JACOBIAN_TOLERANCE, big, big + jac[ind])
    m2m = np.maximum(1.0 - 10.0 ** log10_sum, 0.0)
    return ph2pr, m2m


_PH2PR, _M2M = _tables64()


def scale(dtype: torch.dtype) -> tuple[float, float]:
    """(INITIAL_CONSTANT, its log10 rounded to the tier) of a precision:
    2^1020 for float64, 2^120 below it."""
    exp = 1020 if dtype == torch.float64 else 120
    log10_ic = float(torch.tensor(exp * math.log10(2.0), dtype=dtype))
    return math.ldexp(1.0, exp), log10_ic


def _planes(reads: list[dict], dtype: torch.dtype, device) -> tuple:
    """(planes (n, 7, rows), codes (n, rows), lens (n,)) of the reads:
    pMM, pGapM, pMX, pMY, pZZ, 1 - distm, distm / 3 on rows 1..len; row 0
    and rows past a read are zero."""
    lens = np.array([len(r["bases"]) for r in reads], np.int64)
    rows = int(lens.max()) + 1
    tracks = {k: np.zeros((len(reads), rows), np.int64)
              for k in ("q", "i", "d", "c", "bases")}
    for n, r in enumerate(reads):
        for k in ("q", "i", "d", "c"):
            tracks[k][n, 1:lens[n] + 1] = np.asarray(r[k], np.int64) & 127
        tracks["bases"][n, 1:lens[n] + 1] = base_codes(r["bases"])
    live = np.arange(rows)[None, :] <= lens[:, None]
    live[:, 0] = False
    q, i, d, c = (tracks[k] for k in ("q", "i", "d", "c"))
    hi, lo = np.maximum(i, d), np.minimum(i, d)
    distm = _PH2PR[q]
    vals = np.stack([_M2M[(hi * (hi + 1)) // 2 + lo], 1.0 - _PH2PR[c],
                     _PH2PR[i], _PH2PR[d], _PH2PR[c], 1.0 - distm,
                     distm / 3.0], axis=1) * live[:, None, :]
    planes = torch.from_numpy(vals).to(device=device).to(dtype)
    codes = torch.from_numpy(np.where(live, tracks["bases"], -1)).to(device)
    return planes, codes, torch.from_numpy(lens).to(device)


def forward(reads: list[dict], haps: list[np.ndarray],
            pairs: np.ndarray, dtype: torch.dtype, device,
            block: int = 16384) -> np.ndarray:
    """(len(pairs),) float64 forward scores, scaled by the tier's
    INITIAL_CONSTANT / haplen, of the (read, hap) index pairs, every
    operation in ``dtype``."""
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    out = np.empty(len(pairs), np.float64)
    ic = scale(dtype)[0]
    for lo in range(0, len(pairs), block):
        blk = pairs[lo:lo + block]
        ur, ri = np.unique(blk[:, 0], return_inverse=True)
        uh, hi = np.unique(blk[:, 1], return_inverse=True)
        planes, rcode, rlen = _planes([reads[k] for k in ur], dtype, device)
        hlen = np.array([len(haps[k]) for k in uh], np.int64)
        hcode = np.full((len(uh), int(hlen.max())), -2, np.int64)
        for n, k in enumerate(uh):
            hcode[n, :hlen[n]] = base_codes(haps[k])
        ri_t = torch.from_numpy(ri.reshape(-1)).to(device)
        hi_t = torch.from_numpy(hi.reshape(-1)).to(device)
        out[lo:lo + len(blk)] = _sweep(
            planes[ri_t], rcode[ri_t], rlen[ri_t],
            torch.from_numpy(hcode).to(device)[hi_t],
            torch.from_numpy(hlen).to(device)[hi_t], ic, dtype)
    return out


def _down(x: torch.Tensor) -> torch.Tensor:
    """x[:, r-1] at row r, zero at row 0."""
    return torch.nn.functional.pad(x[:, :-1], (1, 0))


def _sweep(planes, rcode, rlen, hcode, hlen, ic: float, dtype
           ) -> np.ndarray:
    B, _, rows = planes.shape
    dev = planes.device
    p_mm, p_gapm, p_mx, p_my, p_zz, d_match, d_mis = planes.unbind(1)
    n_cols = hcode.shape[1]
    y0 = (torch.tensor(ic, dtype=dtype, device=dev)
          / hlen.to(dtype))                             # (B,)
    r_idx = torch.arange(rows, device=dev)
    zero = torch.zeros((B, rows), dtype=dtype, device=dev)
    row0 = torch.zeros((B, rows), dtype=dtype, device=dev)
    row0[:, 0] = y0
    m1 = x1 = m2 = x2 = zero
    y1 = y2 = row0
    acc = torch.zeros(B, dtype=dtype, device=dev)
    last = rlen[:, None]
    hpad = torch.nn.functional.pad(hcode, (0, rows), value=-2)
    for d in range(2, rows + n_cols):
        col = d - r_idx                                  # (rows,)
        hb = hpad[:, (col - 1).clamp(min=0)]
        match = ((rcode == hb) | (rcode == N_CODE) | (hb == N_CODE))
        distm = torch.where(match, d_match, d_mis)
        m = distm * (_down(m2) * p_mm + (_down(x2) + _down(y2)) * p_gapm)
        x = _down(m1) * p_mx + _down(x1) * p_zz
        y = m1 * p_my + y1 * p_zz
        outside = (col < 1)[None, :]
        m = torch.where(outside, zero, m)
        x = torch.where(outside, zero, x)
        y = torch.where(outside, zero, y)
        m[:, 0] = 0
        x[:, 0] = 0
        y[:, 0] = y0
        c_last = d - rlen
        on = (c_last >= 1) & (c_last <= hlen)
        tail = (m.gather(1, last) + x.gather(1, last))[:, 0]
        acc = torch.where(on, acc + tail, acc)
        m2, x2, y2 = m1, x1, y1
        m1, x1, y1 = m, x, y
    return acc.double().cpu().numpy()


def cascade(reads: list[dict], haps: list[np.ndarray], pairs: np.ndarray,
            device, tier: torch.dtype = torch.float32,
            rescue_tier: torch.dtype = torch.float64
            ) -> tuple[np.ndarray, np.ndarray]:
    """(log10 likelihoods, rescued mask) of the pairs: every pair in
    ``tier``, those under 1e-28 again in ``rescue_tier``."""
    first = forward(reads, haps, pairs, tier, device)
    rescued = ~(first >= MIN_ACCEPTED)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.log10(first) - scale(tier)[1]
        if rescued.any():
            again = forward(reads, haps, np.asarray(pairs)[rescued],
                            rescue_tier, device)
            out[rescued] = np.log10(again) - scale(rescue_tier)[1]
    return out, rescued
