"""PairHMM context tables as device tensors.

The tables themselves are the port's copy of the JAX package's
(``mgl_tpu_torch.core.context``, bit-exact against the reference); this
module only moves them to a torch device, for the f32 main pass
(``CTX_F32``, 2^120 scaling) and the f64 rescue (``CTX_F64``, 2^1020
scaling).  The contexts and the rescue gate
``MIN_ACCEPTED`` (1e-28) are re-exported from here for the rest of the
port.  ``SWParameters`` needs no table: the SW kernel takes its four
scores as scalars.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mgl_tpu_torch.core.context import (CTX_F32, CTX_F64, MIN_ACCEPTED,
                                        QualityContext)

__all__ = ["BASE_ENC", "CTX_F32", "CTX_F64", "MIN_ACCEPTED",
           "QualityContext", "context_tables"]

# one-hot base codes (A=1, C=2, G=4, T=8, N=15), so a match-or-ambiguous
# test is (r & h) != 0; anything else never matches
# (restated from mgl_tpu/kernels/pairhmm_pallas.py:41)
BASE_ENC = np.zeros(256, np.int32)
for _ch, _v in ((b"Aa", 1), (b"Cc", 2), (b"Gg", 4), (b"Tt", 8), (b"Nn", 15)):
    for _c in _ch:
        BASE_ENC[_c] = _v


@functools.lru_cache(maxsize=None)
def _tables(is_f64: bool, device: torch.device) -> dict:
    ctx = CTX_F64 if is_f64 else CTX_F32
    dtype = np.float64 if is_f64 else np.float32
    return {
        "dtype": torch.float64 if is_f64 else torch.float32,
        "ph2pr": torch.from_numpy(np.asarray(ctx.ph2pr, dtype)).to(device),
        "match_to_match": torch.from_numpy(
            np.asarray(ctx.match_to_match, dtype)).to(device),
        "base_enc": torch.from_numpy(BASE_ENC.copy()).to(device),
        # the distm-mismatch factor, rounded to the context's precision
        # once, as the JAX package's plane builders use it
        "one_third": torch.tensor(dtype(1.0) / dtype(3.0),
                                  dtype=torch.float64 if is_f64
                                  else torch.float32, device=device),
    }


def context_tables(ctx: QualityContext, device) -> dict:
    """ph2pr, match_to_match, the one-hot base codes and the rounded 1/3 of
    ``ctx`` (CTX_F32 or CTX_F64) as tensors on ``device``, with the torch
    dtype of the context.  Cached per (context, device); treat the
    tensors as read-only."""
    if ctx is not CTX_F32 and ctx is not CTX_F64:
        raise ValueError("context_tables takes CTX_F32 or CTX_F64")
    return _tables(ctx is CTX_F64, torch.device(device))
