"""PairHMM forward (plain torch) and the likelihood engine's cascade.

Counterpart of ``mgl_tpu/ops/pairhmm.py``:

* :func:`forward_plain` is the plain version of the banded PairHMM kernel
  (``csrc/pairhmm_banded.cu``), written once for a dtype: float32 for the
  main pass, float64 for the rescue.  It is the anti-diagonal recurrence
  of ``pairhmm_forward_f32`` (:215) in the spec's op order,
      M = distm * (M_d2 * pMM + (X_d2 + Y_d2) * pGapM)
      X = M_d1[r-1] * pMX + X_d1[r-1] * pZZ
      Y = M_d1[r]   * pMY + Y_d1[r]   * pZZ
  with the last-row (M + X) sum taken in ascending columns.  Torch's
  elementwise ops neither contract a*b+c nor flush denormals, so on the
  card it equals the kernel bit for bit.
* :func:`compute_likelihoods` is the cascade of ``compute_likelihoods``
  (:524) with the shared-hap-set kernel off (``MGL_TPU_SHARED=0``): exact-
  duplicate hap dedup, length buckets, the f32 product pass, log10, and
  the f64 rescue of pairs under ``MIN_ACCEPTED`` (1e-28).
"""

from __future__ import annotations

import numpy as np
import torch

from mgl_tpu.batch.bucketing import bucket_pairs
from mgl_tpu_torch.tables import CTX_F32, CTX_F64, MIN_ACCEPTED

AMBIG = ord("N")
N_PLANES = 7   # pMM, pGapM, pMX, pMY, pZZ, distm on match, distm on mismatch

# One alphabet for every tier: uppercase ACGT; IUPAC codes, lowercase and
# junk map to N (restated from mgl_tpu/ops/pairhmm.py:51)
BASE_NORM = np.full(256, AMBIG, np.uint8)
for _c in b"ACGT":
    BASE_NORM[_c] = _c
    BASE_NORM[_c + 32] = _c


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """out[:, r] = x[:, r-1]; out[:, 0] = 0."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def forward_plain(planes: torch.Tensor, rchar: torch.Tensor,
                  rslen: torch.Tensor, haps: torch.Tensor,
                  haplen: torch.Tensor, y_init: torch.Tensor,
                  ridx: torch.Tensor, hidx: torch.Tensor) -> torch.Tensor:
    """(B,) forward scores of pairs (ridx[b], hidx[b]) in ``planes``' dtype,
    scaled by the context's initial constant.  Arguments as
    :func:`mgl_tpu_torch.kernels.pairhmm_cuda.pairhmm_banded_f32`."""
    dev = planes.device
    p = planes[ridx]                                # (B, 7, rows)
    B, _, rows = p.shape
    R = rows - 1                                    # matrix rows 0 .. rows-2
    p_mm, p_gapm, p_mx, p_my, p_zz, dm, dmm = (p[:, k, :R] for k in range(7))
    rc = rchar[ridx][:, :R]
    rl = rslen[ridx].long()
    hl = haplen[hidx].long()
    yi = y_init[hidx]
    H = haps.shape[1]
    hpad = torch.zeros((B, H + R + 1), dtype=torch.int32, device=dev)
    hpad[:, :H] = haps[hidx]

    rows_i = torch.arange(R, device=dev)
    row0 = rows_i == 0
    zero = torch.zeros((B, R), dtype=planes.dtype, device=dev)
    y01 = zero.clone()
    y01[:, 0] = yi                  # diagonals 0 and 1: Y = yInit on row 0
    m_prev2, x_prev2, y_prev2 = zero, zero, y01
    m_prev, x_prev, y_prev = zero, zero, y01
    hapdiag = torch.zeros((B, R), dtype=torch.int32, device=dev)
    hapdiag[:, 0] = hpad[:, 0]
    acc = torch.zeros((B,), dtype=planes.dtype, device=dev)

    for d in range(2, R + H):
        hapdiag = torch.cat([hpad[:, d - 1:d], hapdiag[:, :-1]], dim=1)
        distm = torch.where((rc & hapdiag) != 0, dm, dmm)
        m_cur = distm * (_shift_down(m_prev2) * p_mm
                         + (_shift_down(x_prev2) + _shift_down(y_prev2))
                         * p_gapm)
        y_cur = m_prev * p_my + y_prev * p_zz
        x_cur = _shift_down(m_prev) * p_mx + _shift_down(x_prev) * p_zz

        # boundaries: row 0 holds M = X = 0, Y = yInit; column 0 is zero
        col0 = rows_i == d
        m_cur = torch.where(row0 | col0, zero, m_cur)
        x_cur = torch.where(row0 | col0, zero, x_cur)
        y_cur = torch.where(col0, zero,
                            torch.where(row0, yi[:, None], y_cur))

        # last-row cell (rslen, c = d - rslen), valid for 1 <= c <= haplen
        mv = m_cur.gather(1, rl[:, None])[:, 0]
        xv = x_cur.gather(1, rl[:, None])[:, 0]
        c = d - rl
        acc = acc + torch.where((c >= 1) & (c <= hl), mv + xv,
                                torch.zeros_like(acc))

        m_prev2, x_prev2, y_prev2 = m_prev, x_prev, y_prev
        m_prev, x_prev, y_prev = m_cur, x_cur, y_cur
    return acc


def _dedup_haps(haps: list[np.ndarray]) -> tuple[list[int], np.ndarray]:
    """Indices of the distinct haps, and each hap's distinct column."""
    canon: dict[bytes, int] = {}
    col = np.empty(len(haps), np.int64)
    uniq: list[int] = []
    for hi, hp in enumerate(haps):
        key = np.asarray(hp).tobytes()
        if key not in canon:
            canon[key] = len(uniq)
            uniq.append(hi)
        col[hi] = canon[key]
    return uniq, col


def normalize(reads: list[dict], haps: list[np.ndarray]):
    """Reads and haps with their bases mapped through BASE_NORM."""
    return ([{**rd, "bases": BASE_NORM[np.asarray(rd["bases"], np.uint8)]}
             for rd in reads],
            [BASE_NORM[np.asarray(h, np.uint8)] for h in haps])


def compute_likelihoods(reads: list[dict], haps: list[np.ndarray],
                        device: torch.device) -> np.ndarray:
    """(n_reads, n_haps) float64 log10 likelihoods: f32 forward on
    ``device``, f64 rescue for scores under 1e-28.  ``reads`` are dicts of
    uint8 arrays bases/q/i/d/c, ``haps`` uint8 arrays.  Identical haps
    score identically against every read, so each is scored once."""
    uniq, col = _dedup_haps([BASE_NORM[np.asarray(h, np.uint8)]
                             for h in haps])
    pairs = [(ri, hi) for ri in range(len(reads)) for hi in uniq]
    out = pair_likelihoods(reads, haps, pairs, device)
    return out.reshape(len(reads), len(uniq))[:, col]


def pair_likelihoods(reads: list[dict], haps: list[np.ndarray],
                     pairs: list[tuple[int, int]],
                     device: torch.device) -> np.ndarray:
    """(len(pairs),) float64 log10 likelihoods of (read, hap) pairs: the
    f32 scores, with the pairs under MIN_ACCEPTED recomputed by the f64
    rescue (ops/pairhmm.py:641-678)."""
    reads, haps = normalize(reads, haps)
    scores = _bucketed(CTX_F32, reads, haps, pairs, device)
    rescue = np.nonzero(scores < float(MIN_ACCEPTED))[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.log10(scores) - float(CTX_F32.log10_initial_constant)
    if len(rescue):
        vals = _bucketed(CTX_F64, reads, haps, [pairs[b] for b in rescue],
                         device)
        with np.errstate(divide="ignore"):
            out[rescue] = (np.log10(vals)
                           - float(CTX_F64.log10_initial_constant))
    return out


def _bucketed(ctx, reads, haps, pairs, device) -> np.ndarray:
    """(len(pairs),) float64 scores in ``ctx``'s precision over the pairs'
    length buckets, every bucket queued before the first is fetched."""
    from mgl_tpu_torch.kernels.pairhmm_cuda import scores

    la = [len(reads[ri]["bases"]) for ri, _ in pairs]
    lb = [len(haps[hi]) for _, hi in pairs]
    pending = [(idxs, scores(reads, haps, [pairs[k] for k in idxs], ctx,
                             device))
               for _, idxs in bucket_pairs(la, lb)]
    out = np.empty(len(pairs), np.float64)
    for idxs, s in pending:
        out[idxs] = s.cpu().numpy()
    return out
