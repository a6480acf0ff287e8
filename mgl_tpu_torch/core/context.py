"""Quality/probability context tables for PairHMM.

The port's copy of ``mgl_tpu/core/context.py``, after the GATK/Intel-GKL
quality context of the reference (``mgl_pairhmm/Context.h``):

* ``ph2pr[128]``      — Phred score -> error probability table
  (Context.h:105-107 double, 145-147 float).
* ``jacobian_log``    — Jacobian log-sum correction table, step 1e-4
  (Context.h:42-47).
* ``match_to_match``  — quantized triangular match-continuation probability
  table (Context.h:50-61).
* ``INITIAL_CONSTANT``— anti-underflow scaler, 2^1020 (double) / 2^120 (float)
  (Context.h:109, 149).
* ``QualityContext.set_mm_prob`` and :func:`read_transition_rows`, the
  per-read transition rows of the host oracles and the fast path's
  all-match probability (``ops/seed_extend.result_match``).

The tables are *value-parity critical*: likelihoods must agree with the
reference within 1e-5 in log10 space.  They are read from
``_tables/context_tables.npz``, a byte-for-byte copy of the JAX package's
dump of the compiled C++ reference's tables (bit-exact powf/log10
values), which ``tests/test_torch_pairhmm.py`` holds equal to
``mgl_tpu.core.context``.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib

import numpy as np

# Tier threshold (pairhmm_common.h:31, Context.h:111/151).
MIN_ACCEPTED = np.float32(1e-28)

_TABLES_NPZ = pathlib.Path(__file__).parent / "_tables" / "context_tables.npz"


@dataclasses.dataclass(frozen=True)
class QualityContext:
    """One precision tier's tables (mirrors Context<float> / Context<double>)."""

    dtype: type
    ph2pr: np.ndarray
    match_to_match: np.ndarray
    jacobian_log: np.ndarray
    initial_constant: float
    log10_initial_constant: float

    def set_mm_prob(self, ins_qual, del_qual) -> np.ndarray:
        """Match-continuation probability (Context.h:123-134 / 163-174).

        ``ins_qual``/``del_qual`` are integer arrays already masked to
        ``& 127`` by the caller (compute_prob_scalar.cc:76-77), so the
        MAX_QUAL overflow branch never triggers.
        """
        ins_qual = np.asarray(ins_qual, dtype=np.int64)
        del_qual = np.asarray(del_qual, dtype=np.int64)
        min_q = np.minimum(ins_qual, del_qual)
        max_q = np.maximum(ins_qual, del_qual)
        return self.match_to_match[((max_q * (max_q + 1)) >> 1) + min_q]


def _build(dtype, ic_exp: int) -> QualityContext:
    """One precision tier's context from the committed table dump."""
    ic = math.ldexp(1.0, ic_exp)
    sfx = "f32" if dtype == np.float32 else "f64"
    with np.load(_TABLES_NPZ) as z:
        ph2pr, m2m, jac = z[f"ph2pr_{sfx}"], z[f"m2m_{sfx}"], z[f"jac_{sfx}"]
    return QualityContext(
        dtype=dtype,
        ph2pr=ph2pr,
        match_to_match=m2m,
        jacobian_log=jac,
        initial_constant=dtype(ic),
        log10_initial_constant=dtype(np.log10(dtype(ic))),
    )


# Context<float>: INITIAL_CONSTANT = 2^120 (Context.h:149)
CTX_F32 = _build(np.float32, 120)
# Context<double>: INITIAL_CONSTANT = 2^1020 (Context.h:109)
CTX_F64 = _build(np.float64, 1020)


def read_transition_rows(read_q, read_i, read_d, read_c, ctx: QualityContext):
    """Per-row transition/emission vectors for one or more reads.

    Re-derivation of compute_prob_scalar.cc:74-86: given the four quality
    tracks (raw bytes), returns (pMM, pGapM, pMX, pMY, pZZ, distm) with a
    leading zero row (row 0 of the DP has no read base).  Works on any
    leading batch shape; the last axis is the read-length axis.
    """
    q = np.asarray(read_q, dtype=np.uint8) & 127
    i = np.asarray(read_i, dtype=np.uint8) & 127
    d = np.asarray(read_d, dtype=np.uint8) & 127
    c = np.asarray(read_c, dtype=np.uint8) & 127
    one = ctx.dtype(1.0)
    p_mm = ctx.set_mm_prob(i, d)
    p_gapm = (one - ctx.ph2pr[c]).astype(ctx.dtype)
    p_mx = ctx.ph2pr[i]
    p_my = ctx.ph2pr[d]
    p_zz = ctx.ph2pr[c]
    distm = ctx.ph2pr[q]

    def _prepend_zero(a):
        pad = [(0, 0)] * (a.ndim - 1) + [(1, 0)]
        return np.pad(a, pad)

    return tuple(_prepend_zero(v) for v in (p_mm, p_gapm, p_mx, p_my, p_zz,
                                            distm))
