"""The mapper's reference-window gather: the kernel's wrapper and its plain
version.

:func:`window_gather` launches ``csrc/window_gather.cu``, the counterpart
of the XLA device function ``mgl_tpu/pipelines/mapper.py:757
_windowed_scores_fn`` (its gather and unpack, inner ``fn`` :776-801, not
a Pallas kernel); on CPU tensors it runs :func:`window_gather_plain`.
Both turn a word-packed reference on the device, window starts, and ASCII
reads with a read row and a strand a window into what
``sw_cuda.sw_banded`` takes: (B, wlen) uint8 window codes and (B, L)
uint8 read codes, each read encoded and, where its window asks, reverse
complemented on the way.  Codes are compared as codes, so lowercase bases
score as uppercase and the pad code 5 matches no read base.
"""

from __future__ import annotations

import torch

from mgl_tpu_torch import _build
from mgl_tpu_torch.kernels.pairhmm_cuda import _check

# the mapper's encode() table: ACGTacgt -> 0-3, every other byte -> 4
_ENCODE = torch.full((256,), 4, dtype=torch.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ENCODE[_b] = _ENCODE[_b | 0x20] = _i


def _check_gather(ref_words, starts, reads, read_row, rc, wlen: int,
                  qlen: int):
    """Types, shapes and devices of the gather's inputs; returns whether
    the reference is blocked (rows) or flat."""
    if ref_words.dtype != torch.int32 or ref_words.dim() not in (1, 2):
        raise ValueError(f"ref_words: want int32 (n_words,) or (n_rows, "
                         f"words_per_row), got {ref_words.dtype} "
                         f"{tuple(ref_words.shape)}")
    blocked = ref_words.dim() == 2
    if len(starts) != (3 if blocked else 2):
        raise ValueError(f"starts: want (row, word, nibble) for a blocked "
                         f"reference, (word, nibble) for a flat one; got "
                         f"{len(starts)} arrays")
    B = len(read_row)
    dev = ref_words.device
    _check("read_row", read_row, torch.int32, (B,), dev)
    _check("rc", rc, torch.uint8, (B,), dev)
    for k, s in enumerate(starts):
        _check(f"starts[{k}]", s, torch.int32, (B,), dev)
    _check("reads", reads, torch.uint8, (len(reads), qlen), dev)
    if wlen < 1 or qlen < 1:
        raise ValueError(f"window and read lengths must be positive, got "
                         f"{wlen} and {qlen}")
    return blocked


def window_gather_plain(ref_words: torch.Tensor, starts: tuple,
                        reads: torch.Tensor, read_row: torch.Tensor,
                        rc: torch.Tensor, wlen: int, qlen: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gather in torch ops, as ``fn`` at mapper.py:776-801: each
    window's (wlen + 7) // 8 + 1 words, widened to int64 so a word with its
    top bit set does not sign-extend, unpacked to eight nibbles each, then
    the wlen nibbles from the start's shift; each window's read row,
    reversed where ``rc`` is set, encoded by the mapper's table, and a
    reversed base's code c < 4 made 3 - c.  Returns (tgt (B, wlen), qry
    (B, qlen)) uint8."""
    blocked = _check_gather(ref_words, starts, reads, read_row, rc, wlen,
                            qlen)
    dev = ref_words.device
    nw = (wlen + 7) // 8 + 1
    iota = torch.arange(nw, device=dev)
    if blocked:
        row, w0, s = (x.long() for x in starts)
        words = ref_words[row[:, None], w0[:, None] + iota]
    else:
        w0, s = (x.long() for x in starts)
        words = ref_words[w0[:, None] + iota]
    words = words.long() & 0xFFFFFFFF
    shifts = 4 * torch.arange(8, device=dev)
    nib = ((words[:, :, None] >> shifts) & 0xF).reshape(len(words), nw * 8)
    tgt = nib.gather(1, s[:, None] + torch.arange(wlen, device=dev))
    flip = (rc != 0)[:, None]
    rd = reads[read_row.long()]
    rd = torch.where(flip, rd.flip(1), rd)
    qry = _ENCODE.to(dev)[rd.long()]
    qry = torch.where(flip & (qry < 4), 3 - qry, qry)
    return tgt.to(torch.uint8), qry


def window_gather(ref_words: torch.Tensor, starts: tuple,
                  reads: torch.Tensor, read_row: torch.Tensor,
                  rc: torch.Tensor, wlen: int, qlen: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(tgt (B, wlen), qry (B, qlen)) uint8 codes of B windows and their
    reads.  ``ref_words``: the word-packed reference as int32 (the uint32
    words' bits), flat (n_words,) or blocked (n_rows, words_per_row);
    ``starts``: int32 (B,) arrays (word, nibble) or (row, word, nibble)
    from the mapper's ``_split_starts``; ``reads``: (n_reads, qlen) uint8
    ASCII reads as they came; ``read_row``: int32 (B,) each window's row of
    ``reads``; ``rc``: uint8 (B,), non-zero where the window takes that
    read's reverse complement.  A caller holding oriented reads passes
    ``read_row = arange(B)`` and ``rc = 0``.  A window must lie inside its
    row and a read row inside ``reads``: the kernel does not check (that
    would synchronise).  On the card one warp a window, launched on the
    current stream, not synchronised."""
    blocked = _check_gather(ref_words, starts, reads, read_row, rc, wlen,
                            qlen)
    dev = ref_words.device
    if dev.type == "cpu":
        return window_gather_plain(ref_words, starts, reads, read_row, rc,
                                   wlen, qlen)
    if dev.type != "cuda":
        raise ValueError(f"the window gather runs on cuda or cpu, not {dev}")
    B = read_row.shape[0]
    if B == 0:
        raise ValueError("the window gather kernel needs windows, got none")
    ref_words, reads = ref_words.contiguous(), reads.contiguous()
    read_row, rc = read_row.contiguous(), rc.contiguous()
    starts = [s.contiguous() for s in starts]
    row = starts[0] if blocked else None
    w0, s = starts[-2:]
    tgt = torch.empty((B, wlen), dtype=torch.uint8, device=dev)
    qry = torch.empty((B, qlen), dtype=torch.uint8, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.mgl_window_gather(
            ref_words.data_ptr(), None if row is None else row.data_ptr(),
            w0.data_ptr(), s.data_ptr(), reads.data_ptr(),
            read_row.data_ptr(), rc.data_ptr(),
            ref_words.shape[1] if blocked else 0, B, wlen, qlen,
            tgt.data_ptr(), qry.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, code, "mgl_window_gather")
    window_gather.launches += 1
    return tgt, qry


window_gather.launches = 0


def window_gather_bytes(n_windows: int, wlen: int, qlen: int,
                        blocked: bool) -> int:
    """Bytes the gather must move: per window (wlen + 7) // 8 + 1 words of
    4 B read, its start indices (4 B each), its read row (4 B) and rc byte,
    and qlen ASCII read bytes, and wlen + qlen code bytes written - for its
    bound on the card."""
    per = (4 * ((wlen + 7) // 8 + 1) + 4 * (3 if blocked else 2) + 4 + 1
           + qlen + wlen + qlen)
    return n_windows * per
