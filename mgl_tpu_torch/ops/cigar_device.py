"""The CIGAR traceback walk on the device, over the banded SW kernel's words.

The port of ``mgl_tpu/ops/cigar_device.py``.  The banded SW kernel leaves
its 4-bit traceback on the device as (B, G, 32) words in the per-pair
banded layout (:func:`mgl_tpu_torch.ops.sw.banded_layout`): ~20.6 KB a
pair at the mapper's 198 x 150 windows.  Decoding on the host means
fetching all of them; the walk instead steps each pair back through its
nibbles on the device and emits packed (state, length) segments, so only
124 B a pair come back.  The host then applies the strategy's overhang
tail and formats the strings (:func:`finish_cigars`).

The walk is the reference's run-length backtrack (sw.cpp:182-214; the
JAX package's executable spec ``ops/cigar.decode_nib_fn``), as an
automaton of three modes: NORMAL takes a cell's move; a DEL run walks
rows I, I-1, ... while the E-extend bit (bit 2) holds at each row, an
INS run walks columns under the F-extend bit (bit 3).  Adjacent runs of
one state merge into one segment.  The walk ends when I or J reaches 0.

:func:`cigar_walk_plain` is the automaton in torch, all pairs a step;
``kernels/cigar_walk_cuda.cigar_walk`` launches its kernel
(``csrc/cigar_walk.cu``) on CUDA tensors and runs it on CPU ones.
"""

from __future__ import annotations

import numpy as np
import torch

from mgl_tpu_torch.core.params import (OverhangStrategy, STATE_CLIP,
                                       STATE_DEL, STATE_INS, STATE_MATCH)
from mgl_tpu_torch.ops.sw import BAND

SEG_CAP = 24          # walk segments held a pair before it overflows
_NORMAL, _INSRUN, _DELRUN = 0, 1, 2


def walk_start(ez: torch.Tensor, tlen: torch.Tensor, qlen: torch.Tensor,
               strategy: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(I0, J0) of each pair's walk (sw.cpp:155-170): INDEL from (tlen,
    qlen), LEADING_INDEL from (mqe_t, qlen), the others from (max_t,
    max_q)."""
    if strategy == OverhangStrategy.INDEL:
        return tlen, qlen
    if strategy == OverhangStrategy.LEADING_INDEL:
        return ez[1], qlen
    return ez[3], ez[4]


def cigar_walk_plain(words: torch.Tensor, ez: torch.Tensor,
                     tlen: torch.Tensor, qlen: torch.Tensor, *,
                     strategy: int, n_steps: int, words_per_band: int,
                     seg_cap: int = SEG_CAP):
    """Walk every pair's traceback: ``_walk_segments`` (JAX
    ``ops/cigar_device.py:47``) in torch, every pair a step.

    ``words``: (B, G, 32) int32 in the per-pair banded layout of
    ``words_per_band`` words a band - cell (i, j) in word
    ((i-1)//32)*WPB + ((j-1+s)>>3) of lane s = (i-1)%32, nibble
    (j-1+s)&7, the same bits as the JAX kernel's ``btr[g, s, b]``;
    ``ez`` (6, B) int32 ScoreMax rows; ``tlen`` / ``qlen`` (B,) int32.

    Returns (segs (B, seg_cap) int32, packed state | length << 2 in walk
    order, 0 past the last; tail (B, 5) int32 = nseg, cur_state, cur_len,
    I, J at the end; over (B,) bool).  A pair that starts outside the
    matrix never walks.  ``nseg`` counts on past ``seg_cap``, whose last
    slot then takes each later push, and ``over`` is set; a walk that has
    not ended after ``n_steps`` steps is ``over`` too."""
    dev = words.device
    B = words.shape[0]
    flat = words.reshape(B, -1)
    i32 = torch.int32
    I0, J0 = walk_start(ez, tlen, qlen, int(strategy))
    I, J = I0.to(i32).clone(), J0.to(i32).clone()
    mode = torch.zeros(B, dtype=i32, device=dev)
    cur_state = torch.zeros_like(mode)
    cur_len = torch.zeros_like(mode)
    nseg = torch.zeros_like(mode)
    done = ~((I > 0) & (J > 0))
    segs = torch.zeros((B, seg_cap), dtype=i32, device=dev)
    over = torch.zeros(B, dtype=torch.bool, device=dev)
    lane = torch.arange(B, device=dev)
    for _ in range(n_steps):
        if bool(done.all()):
            break              # done pairs never change: the rest is idle
        Ic = I.clamp(min=1).long() - 1
        Jc = J.clamp(min=1).long() - 1
        s = Ic % BAND
        t = Jc + s
        g = (Ic // BAND) * words_per_band + (t >> 3)
        w = flat.gather(1, (g * BAND + s)[:, None])[:, 0].long() & 0xFFFFFFFF
        n = ((w >> (4 * (t & 7))) & 0xF).to(i32)
        move = n & 3
        del_ext = (n & 4) != 0
        ins_ext = (n & 8) != 0
        normal, delrun = mode == _NORMAL, mode == _DELRUN
        norm_next = torch.where(
            (move == 2) & del_ext, _DELRUN,
            torch.where((move == 1) & ins_ext, _INSRUN, _NORMAL))
        cell_state = torch.where(normal, move, torch.where(delrun, 2, 1))
        dI = torch.where(normal, ((move == 0) | (move == 2)).to(i32),
                         delrun.to(i32))
        dJ = torch.where(normal, ((move == 0) | (move == 1)).to(i32),
                         (mode == _INSRUN).to(i32))
        next_mode = torch.where(
            normal, norm_next,
            torch.where(delrun, torch.where(del_ext, _DELRUN, _NORMAL),
                        torch.where(ins_ext, _INSRUN, _NORMAL)))
        act = ~done
        same = cell_state == cur_state
        push = act & ~same
        slot = nseg.clamp(max=seg_cap - 1).long()
        packed = cur_state | (cur_len << 2)
        segs[lane, slot] = torch.where(push, packed, segs[lane, slot])
        over |= push & (nseg >= seg_cap)
        nseg = nseg + push.to(i32)
        cur_len = torch.where(act, torch.where(same, cur_len + 1, 1),
                              cur_len).to(i32)
        cur_state = torch.where(act, cell_state, cur_state).to(i32)
        I = torch.where(act, I - dI, I).to(i32)
        J = torch.where(act, J - dJ, J).to(i32)
        done = done | (act & ~((I > 0) & (J > 0)))
        mode = torch.where(act, next_mode, mode).to(i32)
    over |= ~done              # the walk did not finish: decode on the host
    tail = torch.stack([nseg, cur_state, cur_len, I, J], dim=1)
    return segs, tail, over


_STATE_CHR = {0: STATE_MATCH, 1: STATE_INS, 2: STATE_DEL}


def finish_cigars(segs: np.ndarray, tail: np.ndarray, ez: dict,
                  tlen: np.ndarray, qlen: np.ndarray, strategy,
                  n_pairs: int) -> list:
    """Strategy tail + string formatting for the walk's segments
    (sw.cpp:224-252; ``finish_cigars`` at JAX ``ops/cigar_device.py:139``,
    reading the pair-major ``segs`` (B, cap) and ``tail`` (B, 5)).
    ``ez`` needs ``seg_length``.  Returns list[(cigar, offset)], also for
    overflowed pairs, which the caller replaces."""
    out = []
    softclip = strategy == OverhangStrategy.SOFTCLIP
    ignore = strategy == OverhangStrategy.IGNORE
    for b in range(n_pairs):
        nseg, cur_state, cur_len, I, J = (int(tail[b, k]) for k in range(5))
        result = []
        if softclip:
            seg0 = int(ez["seg_length"][b])
            if seg0 > 0:
                result.append((STATE_CLIP, seg0))
        # nseg can exceed the buffer on overflowed pairs (the walk keeps
        # counting past seg_cap); the caller replaces those pairs, but
        # this formatting pass still runs over them first
        for k in range(min(nseg, segs.shape[1])):
            p = int(segs[b, k])
            result.append((_STATE_CHR[p & 3], p >> 2))
        state = _STATE_CHR[cur_state]
        if softclip:
            result.append((state, cur_len))
            if J > 0:
                result.append((STATE_CLIP, J))
            offset = I
        elif ignore:
            result.append((state, cur_len + J))
            offset = I - J
        else:
            result.append((state, cur_len))
            if I > 0:
                result.append((STATE_DEL, I))
            elif J > 0:
                result.append((STATE_INS, J))
            offset = 0
        cigar = "".join(f"{n}{s}" for s, n in reversed(result) if n > 0)
        out.append((cigar, offset))
    return out


def decode_cigars_device(words: torch.Tensor, ez: torch.Tensor, wlen: int,
                         qlen: int, strategy, words_per_band: int) -> list:
    """[(cigar, offset) | None] of B pairs of one shape (the mapper's
    windows of ``wlen`` against reads of ``qlen``) from the banded SW
    kernel's outputs, still on their device: the walk there
    (``cigar_walk_cuda.cigar_walk``), then its segments, end states,
    overflow flags and the softclip row of ``ez`` - 124 B a pair - back
    through one pinned buffer, then :func:`finish_cigars`.  None marks a
    pair whose walk overflowed SEG_CAP segments: the caller decodes it on
    the host."""
    from mgl_tpu_torch.kernels.cigar_walk_cuda import cigar_walk
    from mgl_tpu_torch.kernels.pairhmm_cuda import to_host

    B = words.shape[0]
    dev = words.device
    full = lambda v: torch.full((B,), v, dtype=torch.int32, device=dev)
    segs, tail, over = cigar_walk(words, ez, full(wlen), full(qlen),
                                  int(strategy), wlen + qlen,
                                  words_per_band=words_per_band)
    host = to_host(torch.cat([segs, tail, ez[5][:, None],
                              over[:, None].to(torch.int32)], dim=1))()
    segs_h, tail_h = host[:, :SEG_CAP], host[:, SEG_CAP:SEG_CAP + 5]
    seg_length, over_h = host[:, SEG_CAP + 5], host[:, SEG_CAP + 6] != 0
    res = finish_cigars(segs_h, tail_h, {"seg_length": seg_length},
                        np.full(B, wlen), np.full(B, qlen), strategy, B)
    return [None if o else r for r, o in zip(res, over_h)]
