"""The device CIGAR walk: the kernel's wrapper.

:func:`cigar_walk` launches ``csrc/cigar_walk.cu``, the counterpart of the
XLA device function ``mgl_tpu/ops/cigar_device.py:47 _walk_segments`` (a
``lax.scan``, not a Pallas kernel); on CPU tensors it runs
:func:`mgl_tpu_torch.ops.cigar_device.cigar_walk_plain`.  Both read the
banded SW kernel's traceback words and ScoreMax rows as
``sw_cuda.sw_banded`` leaves them.
"""

from __future__ import annotations

import ctypes

import torch

from mgl_tpu_torch import _build
from mgl_tpu_torch.core.params import OverhangStrategy
from mgl_tpu_torch.kernels.pairhmm_cuda import _check
from mgl_tpu_torch.ops.cigar_device import SEG_CAP, cigar_walk_plain
from mgl_tpu_torch.ops.sw import BAND


def _check_walk(words, ez, tlen, qlen, strategy: int, n_steps: int,
                words_per_band: int, seg_cap: int) -> None:
    """Types, shapes and devices of the walk's inputs, and its scalars."""
    if words.dtype != torch.int32 or words.dim() != 3 or (
            words.shape[2] != BAND):
        raise ValueError(f"words: want int32 (B, G, {BAND}), got "
                         f"{words.dtype} {tuple(words.shape)}")
    B, G = words.shape[:2]
    dev = words.device
    _check("ez", ez, torch.int32, (6, B), dev)
    _check("tlen", tlen, torch.int32, (B,), dev)
    _check("qlen", qlen, torch.int32, (B,), dev)
    if words_per_band < 1 or G % words_per_band:
        raise ValueError(f"words_per_band {words_per_band} does not divide "
                         f"the {G} words of a pair")
    if strategy not in {int(s) for s in OverhangStrategy}:
        raise ValueError(f"strategy: an OverhangStrategy code, got "
                         f"{strategy}")
    if n_steps < 0 or seg_cap < 1:
        raise ValueError(f"n_steps >= 0 and seg_cap >= 1, got {n_steps} "
                         f"and {seg_cap}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"cigar_walk runs on cuda or cpu, not {dev}")


def cigar_walk(words: torch.Tensor, ez: torch.Tensor, tlen: torch.Tensor,
               qlen: torch.Tensor, strategy: int, n_steps: int, *,
               words_per_band: int, seg_cap: int = SEG_CAP):
    """(segs (B, seg_cap) int32, tail (B, 5) int32, over (B,) bool): each
    pair's traceback walked to packed CIGAR segments, as
    :func:`cigar_walk_plain` defines them.  ``words`` (B, G, 32) and
    ``ez`` (6, B) as ``sw_cuda.sw_banded`` returns them for targets
    padded so that G = bands x ``words_per_band``; ``tlen`` / ``qlen``
    (B,) int32.  A pair's start (from ``ez`` or its lengths, by
    ``strategy``) must lie inside that layout, as the SW kernel leaves it:
    the kernel does not check (that would synchronise).  On the card a
    group of lanes a pair, stepping through windows of its words copied
    to shared memory a band ahead (:func:`walk_layout`); launched on the
    current stream, not synchronised."""
    strategy = int(strategy)
    _check_walk(words, ez, tlen, qlen, strategy, n_steps, words_per_band,
                seg_cap)
    if words.device.type == "cpu":
        return cigar_walk_plain(words, ez, tlen, qlen, strategy=strategy,
                                n_steps=n_steps,
                                words_per_band=words_per_band,
                                seg_cap=seg_cap)
    B, G = words.shape[:2]
    if B == 0:
        raise ValueError("the CIGAR walk kernel needs pairs, got none")
    dev = words.device
    args = [x.contiguous() for x in (words, ez, tlen, qlen)]
    if args[0].data_ptr() % 16:       # the kernel copies 16 B at a time
        args[0] = args[0].clone()
    segs = torch.empty((B, seg_cap), dtype=torch.int32, device=dev)
    tail = torch.empty((B, 5), dtype=torch.int32, device=dev)
    over = torch.empty((B,), dtype=torch.bool, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.mgl_cigar_walk(
            *(a.data_ptr() for a in args), B, G * BAND, words_per_band,
            strategy, n_steps, seg_cap, segs.data_ptr(), tail.data_ptr(),
            over.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, code, "mgl_cigar_walk")
    cigar_walk.launches += 1
    return segs, tail, over


cigar_walk.launches = 0


def walk_layout(n_pairs: int) -> dict:
    """The kernel's launch for ``n_pairs`` pairs, as the launcher
    computes it: blocks, threads a block, shared bytes a block and lanes
    a pair."""
    geo = (ctypes.c_int * 4)()
    _build.load_library().mgl_cigar_walk_layout(n_pairs, geo)
    return dict(zip(("blocks", "threads", "shared_bytes", "lanes"), geo))


def walk_bytes(steps: int, n_pairs: int, seg_cap: int = SEG_CAP) -> int:
    """Bytes the walk must move: one 4 B traceback word a step taken, the
    two ScoreMax rows or lengths a pair's start reads (8 B), and its
    segments, tail and flag written (4 seg_cap + 21 B) - for its bound on
    the card."""
    return 4 * steps + n_pairs * (8 + 4 * seg_cap + 21)
