"""The seed-extend fast-path kernel's wrapper.

:func:`seed_extend_f32` launches ``csrc/seed_extend.cu``, the counterpart
of the XLA device function ``mgl_tpu/ops/seed_extend.py:52
_fast_scores_device`` (a scan, not a Pallas kernel); on CPU tensors it
runs the plain torch version ``mgl_tpu_torch.ops.seed_extend.
fast_scores_plain``.  :func:`fast_scores` stages (read, hap) pairs and
calls it: the engine's tier-0 pass under ``fast_path``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mgl_tpu_torch import _build
from mgl_tpu_torch.kernels.pairhmm_cuda import _check
from mgl_tpu_torch.ops.seed_extend import fast_scores_plain, stage_fast


def seed_extend_f32(rbases, rslen, corr, rm, haps, haplen, ridx, hidx
                    ) -> torch.Tensor:
    """(B,) float32 fast scores, 2^120-scaled, of pairs (ridx[b],
    hidx[b]).  ``rbases`` (n_reads, R) uint8 bases, ``corr`` (n_reads, R)
    float32, ``rslen`` (n_reads,) int32 <= R, ``rm`` (n_reads,) float32,
    ``haps`` (n_haps, H) uint8, ``haplen`` (n_haps,) int32 <= H,
    ``ridx``/``hidx`` (B,) int64 below n_reads / n_haps (not checked on
    the card: that would synchronise), as
    :func:`mgl_tpu_torch.ops.seed_extend.stage_fast` gives them.  On the
    card a warp a pair, its read and hap staged in shared memory and one
    hap offset a lane (:func:`seed_extend_layout`); launched on the
    current stream, not synchronised."""
    n_r, R = rbases.shape
    n_h, H = haps.shape
    B = ridx.shape[0]
    dev = rbases.device
    _check("rbases", rbases, torch.uint8, (n_r, R), dev)
    _check("rslen", rslen, torch.int32, (n_r,), dev)
    _check("corr", corr, torch.float32, (n_r, R), dev)
    _check("rm", rm, torch.float32, (n_r,), dev)
    _check("haps", haps, torch.uint8, (n_h, H), dev)
    _check("haplen", haplen, torch.int32, (n_h,), dev)
    _check("ridx", ridx, torch.int64, (B,), dev)
    _check("hidx", hidx, torch.int64, (B,), dev)
    if dev.type == "cpu":
        return fast_scores_plain(rbases, rslen, corr, rm, haps, haplen, ridx,
                                 hidx)
    if dev.type != "cuda":
        raise ValueError(f"the seed-extend kernel runs on cuda or cpu, not "
                         f"{dev}")
    if B == 0 or R == 0 or H == 0:
        raise ValueError(f"the seed-extend kernel needs pairs, read bases and "
                         f"hap bases, got {B} pairs, {R} read and {H} hap "
                         f"columns")
    args = [x.contiguous() for x in (rbases, rslen, corr, rm, haps, haplen,
                                     ridx, hidx)]
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.mgl_seed_extend(
            *(a.data_ptr() for a in args), B, R, H, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, code, "mgl_seed_extend")
    seed_extend_f32.launches += 1
    return out


seed_extend_f32.launches = 0


def seed_extend_layout(n_pairs: int, r_stride: int, h_stride: int) -> dict:
    """The kernel's launch for ``n_pairs`` pairs of (n, r_stride) reads
    and (m, h_stride) haps, as the launcher computes it: blocks, threads
    a block and dynamic shared bytes a block."""
    geo = (ctypes.c_int * 3)()
    _build.load_library().mgl_seed_extend_layout(n_pairs, r_stride, h_stride,
                                                 geo)
    return dict(zip(("blocks", "threads", "shared_bytes"), geo))


def fast_scores(reads: list[dict], haps: list[np.ndarray],
                pairs: list[tuple[int, int]], device) -> torch.Tensor:
    """(B,) float32 fast scores of (read, hap) pairs on ``device``, not
    synchronised (port of ``mgl_tpu/ops/seed_extend.py:84 fast_scores``,
    without its B x hmax host arrays).  Reads' bases and haps are already
    normalized (BASE_NORM)."""
    return seed_extend_f32(*stage_fast(reads, haps, pairs, device))
