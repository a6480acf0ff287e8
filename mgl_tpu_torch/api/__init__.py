"""Public API: GATK's two native-binding calls on PyTorch.

Counterparts of ``mgl_tpu.api``, with the same signatures plus
``device=``:

* :class:`SmithWatermanAligner` - MicrosoftSmithWaterman.align: (ref, alt,
  params, strategy) -> (cigar, offset), and the batched ``align_batch``;
* :class:`PairHmmEngine` - MicrosoftPairHmm.computeLikelihoods: reads x
  haps -> log10 likelihood matrix with the f32 -> f64 rescue cascade (or
  f64 alone, ``use_double``, or behind the seed-extend estimator,
  ``fast_path``), and ``compute_likelihoods_stream``, the pipelined form
  over many regions.

On a CUDA device only the hand-written kernels run; on ``"cpu"`` only
their plain torch versions do.  Inputs are validated here, since the
kernels assume non-empty sequences.  The aligner records the JAX
package's metrics (``sw.pairs``, ``sw.buckets``, ``sw.align_batch`` in
``mgl_tpu_torch.utils.metrics.METRICS``), logs each bucket's shape and
device to the ``mgl_tpu_torch.engine`` logger at debug level, and with
``MGL_TPU_DEBUG_CHECK=1`` checks every result against the NumPy SW
oracle (``utils/debug_check``).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from mgl_tpu_torch.batch.bucketing import bucket_pairs
from mgl_tpu_torch.core.params import OverhangStrategy, SWParameters
from mgl_tpu_torch.device import resolve_device
from mgl_tpu_torch.utils import debug_check
from mgl_tpu_torch.utils.logging import get_logger
from mgl_tpu_torch.utils.metrics import METRICS

__all__ = [
    "SWResult",
    "SmithWatermanAligner",
    "PairHmmEngine",
    "OverhangStrategy",
    "SWParameters",
]


@dataclasses.dataclass(frozen=True)
class SWResult:
    cigar: str
    offset: int


def _as_u8(seq) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        a = seq.astype(np.uint8)
    else:
        a = np.frombuffer(bytes(seq), dtype=np.uint8)
    if a.size == 0:
        raise ValueError("empty sequence")
    return a


class SmithWatermanAligner:
    """Batched affine-gap SW aligner with exact reference CIGAR parity."""

    def __init__(self, max_batch: int = 2048,
                 device: str | torch.device = "cuda"):
        self.max_batch = max_batch
        self.device = resolve_device(device)

    def align(self, ref, alt, params: SWParameters,
              strategy: OverhangStrategy) -> SWResult:
        """Single-pair alignment (MicrosoftSmithWaterman.java:66-86 shape)."""
        return self.align_batch([ref], [alt], params, strategy)[0]

    def align_batch(self, refs, alts, params: SWParameters,
                    strategy: OverhangStrategy) -> list[SWResult]:
        from mgl_tpu_torch.kernels.sw_cuda import align_batch_banded

        refs = [_as_u8(r).tobytes() for r in refs]
        alts = [_as_u8(a).tobytes() for a in alts]
        if len(refs) != len(alts):
            raise ValueError("refs and alts must have equal length")
        results: list[SWResult | None] = [None] * len(refs)
        buckets = bucket_pairs([len(r) for r in refs], [len(a) for a in alts],
                               max_batch=self.max_batch)
        METRICS.count("sw.pairs", len(refs))
        METRICS.count("sw.buckets", len(buckets))
        log = get_logger("engine")
        with METRICS.timer("sw.align_batch"):
            for (pt, pq), idxs in buckets:
                log.debug("sw bucket (%d, %d) x%d on %s", pt, pq, len(idxs),
                          self.device)
                got = align_batch_banded([refs[i] for i in idxs],
                                         [alts[i] for i in idxs], params,
                                         strategy, self.device)
                for i, (cig, off) in zip(idxs, got):
                    results[i] = SWResult(cig, off)
        if debug_check.enabled():
            debug_check.check_sw_results(refs, alts, params, strategy,
                                         results)
        return results  # type: ignore[return-value]


def _checked_reads(reads: list[dict]) -> list[dict]:
    """Reads as dicts of uint8 arrays, each quality track as long as the
    read's bases."""
    checked = []
    for rd in reads:
        bases = _as_u8(rd["bases"])
        n = len(bases)
        r = {"bases": bases}
        for k in ("q", "i", "d", "c"):
            a = np.asarray(rd[k], dtype=np.uint8)
            if a.shape != (n,):
                raise ValueError(
                    f"quality track '{k}' length {a.shape} != read "
                    f"length {n}")
            r[k] = a
        checked.append(r)
    return checked


class PairHmmEngine:
    """PairHMM likelihood engine with the reference's precision cascade.

    ``use_double`` scores every pair in f64 alone (the reference's
    ``initNative(use_double=true)``), through the f64 per-pair kernel.
    ``fast_path`` enables the seed-extend tier-0 estimator (the reference
    ships it dormant; different numbers for well-matching pairs): pairs
    whose fast score clears MIN_ACCEPTED take it, the rest run the f32
    pass and the f64 rescue.  ``use_double`` wins when both are set, as in
    the JAX package.
    """

    def __init__(self, use_double: bool = False, fast_path: bool = False,
                 device: str | torch.device = "cuda"):
        self.use_double = use_double
        self.fast_path = fast_path
        self.device = resolve_device(device)

    def compute_likelihoods(self, reads: list[dict], haps: list) -> np.ndarray:
        """reads: dicts with keys bases/q/i/d/c (uint8 arrays or bytes);
        haps: list of uint8 arrays or bytes.  Returns (R, H) float64 log10
        likelihood matrix (MicrosoftPairHmm.java:104-111 layout)."""
        from mgl_tpu_torch.ops.pairhmm import compute_likelihoods

        return compute_likelihoods(_checked_reads(reads),
                                   [_as_u8(h) for h in haps], self.device,
                                   self.use_double, self.fast_path)

    def compute_likelihoods_stream(self, batches, depth: int = 2):
        """Pipelined likelihoods over a stream of (reads, haps) batches -
        GATK's call pattern, one computeLikelihoods per assembly region
        (mgl_tpu/api/__init__.py:203).

        Batch k+1's host packing and kernel dispatch run while the card
        still works on batch k.  Three stages, each one batch behind the
        one before: [dispatch f32] -> [fetch f32 + dispatch rescue] ->
        [fetch rescue + emit]; ``depth`` batches wait in the first.
        Single-threaded: the dispatch/finalize split of
        :func:`mgl_tpu_torch.ops.pairhmm.dispatch_likelihoods` does the
        overlapping.  Under ``use_double`` or ``fast_path`` every batch
        completes at its dispatch, as in the JAX package, so nothing
        overlaps.  Yields (R, H) matrices in input order, bit-identical to
        sequential :meth:`compute_likelihoods` calls."""
        depth = max(depth, 1)
        s1: collections.deque = collections.deque()
        s2: collections.deque = collections.deque()
        for reads, haps in batches:
            s1.append(self._dispatch(reads, haps))
            if len(s1) > depth:
                s2.append(s1.popleft()())
            if len(s2) > 1:
                yield s2.popleft()()
        while s1:
            s2.append(s1.popleft()())
            if len(s2) > 1:
                yield s2.popleft()()
        while s2:
            yield s2.popleft()()

    def _dispatch(self, reads: list[dict], haps: list):
        from mgl_tpu_torch.ops.pairhmm import dispatch_likelihoods

        return dispatch_likelihoods(_checked_reads(reads),
                                    [_as_u8(h) for h in haps], self.device,
                                    self.use_double, self.fast_path)

    def done(self) -> None:  # parity with PairHMMNativeBinding.done()
        pass
