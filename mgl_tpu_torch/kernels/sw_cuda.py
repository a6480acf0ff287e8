"""SW kernel wrappers and the aligner's bucket pipelines.

:func:`sw_banded` launches ``csrc/sw_banded.cu`` (the counterpart of
``mgl_tpu/kernels/sw_pallas.py:_sw_banded_kernel``); :func:`sw_plane`
and :func:`sw_plane_scores` launch ``csrc/sw_plane.cu`` (the counterparts
of ``sw_pallas.py:_sw_kernel`` and ``:_sw_score_kernel``).  On CPU
tensors each runs its plain torch version (``mgl_tpu_torch.ops.sw``).
The kernel sources say what bounds them on the card.
:func:`align_batch_banded` is the port of ``sw_pallas.py:1101`` and
:func:`align_batch` of ``:1164``: pack a bucket, run a kernel in
traceback mode, decode CIGARs on the host with the port's decoder of the
kernel's layout (``mgl_tpu_torch.native``).
"""

from __future__ import annotations

import numpy as np
import torch

from mgl_tpu_torch import _build
from mgl_tpu_torch.core.params import OverhangStrategy, SWParameters
from mgl_tpu_torch.device import resolve_device
from mgl_tpu_torch.kernels import WARPS_PER_SM
from mgl_tpu_torch.native import cigar_decode_bulk, cigar_decode_bulk_banded
from mgl_tpu_torch.ops.sw import (BAND, EZ_KEYS, banded_layout, plane_words,
                                  sw_banded_plain, sw_plane_plain,
                                  sw_plane_scores_plain)

# the pipelined SW kernel's warps a pair (sw_banded, sw_plane,
# sw_plane_scores): powers of two up to 32, the least that puts
# WARPS_PER_SM warps on each SM that holds a pair
BANDED_WARPS = (1, 2, 4, 8, 16, 32)
# the plane kernel's modes, as csrc/sw_plane.cu numbers them
PLANE_MODES = ("traceback", "samples", "scores")


def _check_pairs(fn: str, tgt, qry, tlen, qlen) -> None:
    """Types, shapes and devices of the SW kernels' four inputs."""
    B, T = tgt.shape
    Q = qry.shape[1]
    for name, x, dtype, shape in (("tgt", tgt, torch.uint8, (B, T)),
                                  ("qry", qry, torch.uint8, (B, Q)),
                                  ("tlen", tlen, torch.int32, (B,)),
                                  ("qlen", qlen, torch.int32, (B,))):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != tgt.device:
            raise ValueError(f"{name} is on {x.device}, tgt on {tgt.device}")
    if tgt.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on cuda or cpu, not {tgt.device}")
    if tgt.device.type == "cuda" and min(B, T, Q) == 0:
        raise ValueError(f"{fn} needs pairs and bases, got {B} pairs of "
                         f"{T} x {Q}")


def banded_warps(n_pairs: int, n_bands: int, sm_count: int) -> int:
    """Warps a pair for the banded kernel: the least power of two W (1 to
    32, at most ``n_bands`` rounded down to a power of two) for which
    ``n_pairs * W`` warps put WARPS_PER_SM on each SM that holds a pair -
    one block a pair, so ``min(n_pairs, sm_count)`` SMs."""
    cap = min(BANDED_WARPS[-1], 1 << (max(n_bands, 1).bit_length() - 1))
    target = min(n_pairs, sm_count) * WARPS_PER_SM
    w = 1
    while w < cap and n_pairs * w < target:
        w *= 2
    return w


def check_warps(warps_per_pair: int | None) -> None:
    """Refuse a forced W outside BANDED_WARPS (None: the wrapper picks)."""
    if warps_per_pair is not None and warps_per_pair not in BANDED_WARPS:
        raise ValueError(f"warps_per_pair: one of {BANDED_WARPS}, got "
                         f"{warps_per_pair}")


def pipeline_warps(fn: str, n_pairs: int, t: int, q: int,
                   warps_per_pair: int | None, sm_count: int) -> int:
    """W of one launch of the pipelined SW kernel (``fn``: sw_banded,
    sw_plane or sw_plane_scores) over n_pairs pairs padded to t x q on a
    card of sm_count SMs: ``warps_per_pair`` if given, else
    :func:`banded_warps`.  Raises if a pair's progress would overflow the
    kernel's int32 counters."""
    nb = (t + BAND - 1) // BAND
    if nb * (q + 1) >= 2 ** 31:
        raise ValueError(f"{fn} counts a pair's progress in int32: "
                         f"{t} x {q} is too large")
    return warps_per_pair or banded_warps(n_pairs, nb, sm_count)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _carry_in_shared(entry: str, n_pairs: int, q: int, warps_per_pair: int,
                     mode: int, device) -> bool:
    lib = _build.load_library()
    with torch.cuda.device(device):
        got = getattr(lib, entry)(n_pairs, q + BAND + 2, warps_per_pair, mode)
    if got < 0:
        _build.check_launch(lib, -got, entry)
    return bool(got)


def banded_carry_in_shared(n_pairs: int, q: int, warps_per_pair: int,
                           with_traceback: bool, device) -> bool:
    """Whether ``sw_banded`` keeps the carry row of n_pairs pairs of
    queries padded to q in shared memory on ``device`` (a CUDA device):
    the launcher's choice, from the block's opt-in limit and the blocks
    an SM holds either way."""
    return _carry_in_shared("mgl_sw_banded_carry_in_shared", n_pairs, q,
                            warps_per_pair, int(with_traceback), device)


def plane_carry_in_shared(n_pairs: int, q: int, warps_per_pair: int,
                          mode: int, device) -> bool:
    """The same for the plane kernel in ``mode`` (0 traceback, 1 samples,
    2 best score: the index in PLANE_MODES)."""
    return _carry_in_shared("mgl_sw_plane_carry_in_shared", n_pairs, q,
                            warps_per_pair, mode, device)


def sw_banded(tgt: torch.Tensor, qry: torch.Tensor, tlen: torch.Tensor,
              qlen: torch.Tensor, match: int, mismatch: int, gap_open: int,
              gap_ext: int, *, indel_init: bool, with_traceback: bool = True,
              warps_per_pair: int | None = None):
    """Banded SW over B pairs: (ez (6, B) int32, words (B, G, 32) int32 or
    None).  ``tgt`` (B, T) / ``qry`` (B, Q) uint8 zero-padded, ``tlen`` /
    ``qlen`` (B,) int32 with 1 <= tlen <= T and 1 <= qlen <= Q; layout as
    :func:`mgl_tpu_torch.ops.sw.banded_layout`.  Traceback and score-only
    mode are one kernel with a compile-time flag.  ``warps_per_pair``
    forces W (one of BANDED_WARPS; by default :func:`banded_warps`): every
    W gives the same bits."""
    _check_pairs("sw_banded", tgt, qry, tlen, qlen)
    check_warps(warps_per_pair)
    if tgt.device.type == "cpu":
        return sw_banded_plain(tgt, qry, tlen, qlen, match, mismatch,
                               gap_open, gap_ext, indel_init=indel_init,
                               with_traceback=with_traceback)
    B, T = tgt.shape
    Q = qry.shape[1]
    nb, wpb = banded_layout(T, Q)
    dev = tgt.device
    warps_per_pair = pipeline_warps("sw_banded", B, T, Q, warps_per_pair,
                                    _sm_count(dev))
    carry_cols = Q + BAND + 2
    tgt, qry = tgt.contiguous(), qry.contiguous()
    tlen, qlen = tlen.contiguous(), qlen.contiguous()
    ez = torch.empty((6, B), dtype=torch.int32, device=dev)
    carry = torch.empty((B, 2, carry_cols), dtype=torch.int32, device=dev)
    words = (torch.empty((B, nb * wpb, BAND), dtype=torch.int32, device=dev)
             if with_traceback else None)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.mgl_sw_banded(
            tgt.data_ptr(), qry.data_ptr(), tlen.data_ptr(), qlen.data_ptr(),
            B, T, Q, int(match), int(mismatch), int(gap_open), int(gap_ext),
            int(indel_init), int(with_traceback), wpb, nb * wpb, carry_cols,
            warps_per_pair, carry.data_ptr(), ez.data_ptr(),
            words.data_ptr() if words is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, code, "sw_banded")
    sw_banded.launches += 1
    return ez, words


sw_banded.launches = 0


def _sw_plane(mode: int, tgt, qry, tlen, qlen, match, mismatch, gap_open,
              gap_ext, indel_init: bool, outs: tuple[torch.Tensor, ...],
              warps_per_pair: int | None = None) -> None:
    """Launch ``csrc/sw_plane.cu`` in ``mode`` (0 traceback, 1 samples,
    2 best score) into the preallocated ``outs``, W as
    :func:`pipeline_warps` picks it."""
    B, T = tgt.shape
    Q = qry.shape[1]
    if mode == 0 and plane_words(T, Q) * (T + 1) >= 2 ** 31:
        raise ValueError(f"sw_plane addresses a pair's traceback words in "
                         f"int32: {T} x {Q} is too large")
    dev = tgt.device
    warps = pipeline_warps("sw_plane", B, T, Q, warps_per_pair,
                           _sm_count(dev))
    carry_cols = Q + BAND + 2
    args = [x.contiguous() for x in (tgt, qry, tlen, qlen)]
    carry = torch.empty((B, 2, carry_cols), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.mgl_sw_plane(
            *(a.data_ptr() for a in args), B, T, Q, int(match), int(mismatch),
            int(gap_open), int(gap_ext), int(indel_init), mode,
            plane_words(T, Q), carry_cols, warps, carry.data_ptr(),
            *(o.data_ptr() for o in outs), *([None] * (2 - len(outs))),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, code, "sw_plane")


def sw_plane(tgt: torch.Tensor, qry: torch.Tensor, tlen: torch.Tensor,
             qlen: torch.Tensor, match: int, mismatch: int, gap_open: int,
             gap_ext: int, *, indel_init: bool, with_traceback: bool = True,
             warps_per_pair: int | None = None):
    """Plane SW over B pairs, arguments as :func:`sw_banded`.  Traceback
    mode: (ez (6, B) int32, words (B, plane_words(T, Q), T+1) int32 in the
    plane layout); samples mode (``with_traceback=False``): (lc, lr), each
    (B, T+Q-1) int32 - as :func:`mgl_tpu_torch.ops.sw.sw_plane_plain`.
    ``warps_per_pair`` forces W as in :func:`sw_banded`; every W gives
    the same bits."""
    _check_pairs("sw_plane", tgt, qry, tlen, qlen)
    check_warps(warps_per_pair)
    if tgt.device.type == "cpu":
        return sw_plane_plain(tgt, qry, tlen, qlen, match, mismatch,
                              gap_open, gap_ext, indel_init=indel_init,
                              with_traceback=with_traceback)
    B, T = tgt.shape
    Q = qry.shape[1]
    dev = tgt.device
    if with_traceback:
        outs = (torch.empty((6, B), dtype=torch.int32, device=dev),
                torch.zeros((B, plane_words(T, Q), T + 1), dtype=torch.int32,
                            device=dev))
    else:
        outs = (torch.zeros((B, T + Q - 1), dtype=torch.int32, device=dev),
                torch.zeros((B, T + Q - 1), dtype=torch.int32, device=dev))
    _sw_plane(0 if with_traceback else 1, tgt, qry, tlen, qlen, match,
              mismatch, gap_open, gap_ext, indel_init, outs, warps_per_pair)
    sw_plane.launches += 1
    return outs


def sw_plane_scores(tgt: torch.Tensor, qry: torch.Tensor, tlen: torch.Tensor,
                    qlen: torch.Tensor, match: int, mismatch: int,
                    gap_open: int, gap_ext: int, *, indel_init: bool,
                    warps_per_pair: int | None = None) -> torch.Tensor:
    """(B,) int32 best alignment score of each pair by the plane kernel's
    best-score mode, arguments as :func:`sw_banded` - as
    :func:`mgl_tpu_torch.ops.sw.sw_plane_scores_plain`."""
    _check_pairs("sw_plane_scores", tgt, qry, tlen, qlen)
    check_warps(warps_per_pair)
    if tgt.device.type == "cpu":
        return sw_plane_scores_plain(tgt, qry, tlen, qlen, match, mismatch,
                                     gap_open, gap_ext, indel_init=indel_init)
    out = torch.empty((tgt.shape[0],), dtype=torch.int32, device=tgt.device)
    _sw_plane(2, tgt, qry, tlen, qlen, match, mismatch, gap_open, gap_ext,
              indel_init, (out,), warps_per_pair)
    sw_plane_scores.launches += 1
    return out


sw_plane.launches = 0
sw_plane_scores.launches = 0


def pack_sequences(seqs: list[bytes]) -> np.ndarray:
    """(B, longest) uint8, row b = seqs[b] zero-padded."""
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    out = np.zeros((len(seqs), int(lens.max())), np.uint8)
    out[np.arange(out.shape[1])[None, :] < lens[:, None]] = np.frombuffer(
        b"".join(seqs), np.uint8)
    return out


def _traceback(kernel, targets: list[bytes], queries: list[bytes],
               params: SWParameters, strategy: OverhangStrategy, device):
    """(tlen, qlen, ez (6, B), words) on the host: one SW kernel in
    traceback mode over the pairs padded to the batch maxima."""
    tlen = np.fromiter((len(t) for t in targets), np.int32, len(targets))
    qlen = np.fromiter((len(q) for q in queries), np.int32, len(queries))
    ez_d, words_d = kernel(
        torch.from_numpy(pack_sequences(targets)).to(device),
        torch.from_numpy(pack_sequences(queries)).to(device),
        torch.from_numpy(tlen).to(device), torch.from_numpy(qlen).to(device),
        params.match, params.mismatch, params.gap_open, params.gap_extend,
        indel_init=bool(strategy & (OverhangStrategy.INDEL
                                    | OverhangStrategy.LEADING_INDEL)))
    return tlen, qlen, ez_d.cpu().numpy(), words_d.cpu().numpy()


def align_batch_banded(targets: list[bytes], queries: list[bytes],
                       params: SWParameters, strategy: OverhangStrategy,
                       device: torch.device) -> list[tuple[str, int]]:
    """[(cigar, offset)] for one length bucket: the banded kernel in
    traceback mode, then the host's native banded CIGAR decode."""
    tlen, qlen, ez, words = _traceback(sw_banded, targets, queries, params,
                                       strategy, device)
    wpb = banded_layout(int(tlen.max()), int(qlen.max()))[1]
    return decode_cigars(ez, words, tlen, qlen, strategy, wpb)


def align_batch(targets: list[bytes], queries: list[bytes],
                params: SWParameters, strategy: OverhangStrategy,
                device: str | torch.device = "cuda"
                ) -> list[tuple[str, int]]:
    """[(cigar, offset)] of a batch through the plane kernel: the port of
    ``sw_pallas.py:1164 align_batch``, with the contract of the JAX
    package's ``ops.sw.align_batch``.  It pads to the batch maxima, so
    the caller buckets by length; then the kernel in traceback mode and
    the host's plane CIGAR decode (``native.cigar_decode_bulk``)."""
    if len(targets) != len(queries) or not targets:
        raise ValueError(f"align_batch needs as many queries as targets, "
                         f"and pairs: {len(targets)} / {len(queries)}")
    if not all(map(len, targets)) or not all(map(len, queries)):
        raise ValueError("empty sequence")
    tlen, qlen, ez, words = _traceback(sw_plane, targets, queries, params,
                                       strategy, resolve_device(device))
    return cigar_decode_bulk(words.view(np.uint32),
                             dict(zip(EZ_KEYS, ez.astype(np.int64))), tlen,
                             qlen, int(strategy))


def host_decoder_ready() -> bool:
    """Whether the port's host library that decodes CIGARs builds and
    loads (it raises if not)."""
    return _build.load_host_library() is not None


def decode_cigars(ez: np.ndarray, words: np.ndarray, tlen: np.ndarray,
                  qlen: np.ndarray, strategy: OverhangStrategy,
                  words_per_band: int) -> list[tuple[str, int]]:
    """Host CIGAR decode of the kernel's outputs - ez (6, B), words
    (B, G, 32) int32 in the per-pair banded layout - by the port's banded
    host decoder, which replays the reference's run-length walk (sw.cpp)."""
    return cigar_decode_bulk_banded(
        words.view(np.uint32), dict(zip(EZ_KEYS, ez.astype(np.int64))),
        tlen, qlen, int(strategy), BAND, words_per_band)
