"""Banded SW kernel wrapper and the aligner's bucket pipeline.

:func:`sw_banded` launches ``csrc/sw_banded.cu`` (the counterpart of
``mgl_tpu/kernels/sw_pallas.py:_sw_banded_kernel``) on CUDA tensors and
runs its plain torch version (``mgl_tpu_torch.ops.sw.sw_banded_plain``)
on CPU tensors.  The kernel source says what bounds it on the card.
:func:`align_batch_banded` is the port of ``sw_pallas.py:1101``: pack a
bucket, run the kernel in traceback mode, decode CIGARs on the host with
the port's banded decoder (``mgl_tpu_torch.native``).
"""

from __future__ import annotations

import numpy as np
import torch

from mgl_tpu_torch import _build
from mgl_tpu_torch.core.params import OverhangStrategy, SWParameters
from mgl_tpu_torch.native import cigar_decode_bulk_banded
from mgl_tpu_torch.ops.sw import BAND, EZ_KEYS, banded_layout, sw_banded_plain


def sw_banded(tgt: torch.Tensor, qry: torch.Tensor, tlen: torch.Tensor,
              qlen: torch.Tensor, match: int, mismatch: int, gap_open: int,
              gap_ext: int, *, indel_init: bool, with_traceback: bool = True):
    """Banded SW over B pairs: (ez (6, B) int32, words (B, G, 32) int32 or
    None).  ``tgt`` (B, T) / ``qry`` (B, Q) uint8 zero-padded, ``tlen`` /
    ``qlen`` (B,) int32 with 1 <= tlen <= T and 1 <= qlen <= Q; layout as
    :func:`mgl_tpu_torch.ops.sw.banded_layout`.  Traceback and score-only
    mode are one kernel with a compile-time flag."""
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
    if tgt.device.type == "cpu":
        return sw_banded_plain(tgt, qry, tlen, qlen, match, mismatch,
                               gap_open, gap_ext, indel_init=indel_init,
                               with_traceback=with_traceback)
    if tgt.device.type != "cuda":
        raise ValueError(f"sw_banded runs on cuda or cpu, not {tgt.device}")
    if min(B, T, Q) == 0:
        raise ValueError(f"sw_banded needs pairs and bases, got {B} pairs "
                         f"of {T} x {Q}")

    nb, wpb = banded_layout(T, Q)
    carry_cols = Q + BAND + 2
    tgt, qry = tgt.contiguous(), qry.contiguous()
    tlen, qlen = tlen.contiguous(), qlen.contiguous()
    dev = tgt.device
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
            carry.data_ptr(), ez.data_ptr(),
            words.data_ptr() if words is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, code, "sw_banded")
    sw_banded.launches += 1
    return ez, words


sw_banded.launches = 0


def pack_sequences(seqs: list[bytes]) -> np.ndarray:
    """(B, longest) uint8, row b = seqs[b] zero-padded."""
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    out = np.zeros((len(seqs), int(lens.max())), np.uint8)
    out[np.arange(out.shape[1])[None, :] < lens[:, None]] = np.frombuffer(
        b"".join(seqs), np.uint8)
    return out


def align_batch_banded(targets: list[bytes], queries: list[bytes],
                       params: SWParameters, strategy: OverhangStrategy,
                       device: torch.device) -> list[tuple[str, int]]:
    """[(cigar, offset)] for one length bucket: the banded kernel in
    traceback mode, then the host's native banded CIGAR decode."""
    tlen = np.fromiter((len(t) for t in targets), np.int32, len(targets))
    qlen = np.fromiter((len(q) for q in queries), np.int32, len(queries))
    ez_d, words_d = sw_banded(
        torch.from_numpy(pack_sequences(targets)).to(device),
        torch.from_numpy(pack_sequences(queries)).to(device),
        torch.from_numpy(tlen).to(device), torch.from_numpy(qlen).to(device),
        params.match, params.mismatch, params.gap_open, params.gap_extend,
        indel_init=bool(strategy & (OverhangStrategy.INDEL
                                    | OverhangStrategy.LEADING_INDEL)))
    wpb = banded_layout(int(tlen.max()), int(qlen.max()))[1]
    return decode_cigars(ez_d.cpu().numpy(), words_d.cpu().numpy(), tlen,
                         qlen, strategy, wpb)


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
