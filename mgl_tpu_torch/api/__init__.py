"""Public API: GATK's two native-binding calls on PyTorch.

Counterparts of ``mgl_tpu.api``, with the same signatures plus
``device=``:

* :class:`SmithWatermanAligner` - MicrosoftSmithWaterman.align: (ref, alt,
  params, strategy) -> (cigar, offset), and the batched ``align_batch``;
* :class:`PairHmmEngine` - MicrosoftPairHmm.computeLikelihoods: reads x
  haps -> log10 likelihood matrix with the f32 -> f64 rescue cascade, and
  ``compute_likelihoods_stream``, the pipelined form over many regions.

On a CUDA device only the hand-written kernels run; on ``"cpu"`` only
their plain torch versions do.  Inputs are validated here, since the
kernels assume non-empty sequences.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from mgl_tpu_torch.batch.bucketing import bucket_pairs
from mgl_tpu_torch.core.params import OverhangStrategy, SWParameters
from mgl_tpu_torch.device import resolve_device

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
        for _, idxs in buckets:
            got = align_batch_banded([refs[i] for i in idxs],
                                     [alts[i] for i in idxs], params,
                                     strategy, self.device)
            for i, (cig, off) in zip(idxs, got):
                results[i] = SWResult(cig, off)
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

    ``use_double`` and ``fast_path`` are not ported yet and raise
    NotImplementedError rather than run another path.
    """

    def __init__(self, use_double: bool = False, fast_path: bool = False,
                 device: str | torch.device = "cuda"):
        if use_double or fast_path:
            raise NotImplementedError(
                "use_double and fast_path are not ported to mgl_tpu_torch yet")
        self.device = resolve_device(device)

    def compute_likelihoods(self, reads: list[dict], haps: list) -> np.ndarray:
        """reads: dicts with keys bases/q/i/d/c (uint8 arrays or bytes);
        haps: list of uint8 arrays or bytes.  Returns (R, H) float64 log10
        likelihood matrix (MicrosoftPairHmm.java:104-111 layout)."""
        from mgl_tpu_torch.ops.pairhmm import compute_likelihoods

        return compute_likelihoods(_checked_reads(reads),
                                   [_as_u8(h) for h in haps], self.device)

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
        overlapping.  Yields (R, H) matrices in input order, bit-identical
        to sequential :meth:`compute_likelihoods` calls."""
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
                                    [_as_u8(h) for h in haps], self.device)

    def done(self) -> None:  # parity with PairHMMNativeBinding.done()
        pass
