"""Slow-mode self-verification (the reference's _UNIT_TEST analogue).

The port's copy of ``mgl_tpu/utils/debug_check.py``, on the port's own
NumPy oracles (``mgl_tpu_torch.ref_impl``).  The reference compiles a
naive full-matrix oracle into its kernels under _DEBUG and asserts every
diagonal against it (pairhmm_common.h:61-181).  Here the same idea runs
as an opt-in wrapper: set MGL_TPU_DEBUG_CHECK=1 (the JAX package's
variable) and ``SmithWatermanAligner.align_batch`` re-derives every
result with the NumPy SW oracle and compares; ``check_pairhmm_scores``
is there to call directly, and, as in the JAX package, no entry point
calls it.  A mismatch raises AssertionError, by an explicit raise, so the
check holds under ``python -O`` too.
"""

from __future__ import annotations

import math
import os


def enabled() -> bool:
    return os.environ.get("MGL_TPU_DEBUG_CHECK") == "1"


def check_pairhmm_scores(reads, haps, pair_index, scores,
                         rtol: float = 1e-4) -> None:
    """Assert device f32 scores against the NumPy full-matrix oracle."""
    from mgl_tpu_torch.core.context import CTX_F32, MIN_ACCEPTED
    from mgl_tpu_torch.ref_impl.pairhmm_scalar import compute_score

    for b, (ri, hi) in enumerate(pair_index):
        rd = reads[ri]
        want = compute_score(haps[hi], rd["bases"], rd["q"], rd["i"],
                             rd["d"], rd["c"], ctx=CTX_F32)
        got = float(scores[b])
        if want < float(MIN_ACCEPTED) or got < float(MIN_ACCEPTED):
            if (want < float(MIN_ACCEPTED)) != (got < float(MIN_ACCEPTED)):
                raise AssertionError(f"pair {b}: rescue disagreement "
                                     f"got={got} want={want}")
            continue
        err = abs(math.log10(got) - math.log10(want))
        if not err < rtol:
            raise AssertionError(f"pair {b}: log10 err {err} (got={got} "
                                 f"want={want})")


def check_sw_results(targets, queries, params, strategy, results) -> None:
    """Assert device CIGAR/offset results against the NumPy SW oracle."""
    from mgl_tpu_torch.ref_impl.sw_scalar import align

    for b, (t, q) in enumerate(zip(targets, queries)):
        want = align(t, q, params, strategy)
        got = (results[b].cigar, results[b].offset) if hasattr(
            results[b], "cigar") else tuple(results[b])
        if got != want:
            raise AssertionError(f"pair {b}: {got} != {want}")
