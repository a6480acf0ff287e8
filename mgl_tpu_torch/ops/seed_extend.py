"""Seed-extend fast-path scorer (tier-0 prefilter): host side and plain
version.

The port of ``mgl_tpu/ops/seed_extend.py``, after the reference's dormant
heuristic (``compute_fast_prob.cc``): for each hap offset p, the read
either matches exactly (contributing the all-match path probability
``resultMatch``) or diverges at exactly one position pos0 with the rest
matching (contributing ``resultMatch * corr[pos0]``, corr = distN /
distM of the base's quality).  Score = the sum over offsets / haplen, in
float32, scaled by 2^120 like the f32 forward.  Two bases mismatch when
they differ and neither is ``N``.  Pairs whose fast score clears
MIN_ACCEPTED skip the DP (the reference JNI layer's tier-0 gate).

* :func:`result_match` and :func:`read_corr` - the per-read factors, on
  the host in float32 with the reference's operation order (over many
  reads at once in :func:`stage_fast`);
* :func:`stage_fast` - the kernel's arguments: each distinct read's
  bases, corr and resultMatch and each distinct hap shipped once, the
  pairs picked on the device by (ridx, hidx);
* :func:`fast_scores_plain` - the plain torch version of the XLA device
  function ``_fast_scores_device`` (``mgl_tpu/ops/seed_extend.py:52``),
  which the CUDA kernel ``csrc/seed_extend.cu`` equals bit for bit
  (wrapper: ``mgl_tpu_torch.kernels.seed_extend_cuda``).
"""

from __future__ import annotations

import numpy as np
import torch

from mgl_tpu_torch.tables import CTX_F32

AMBIG = ord("N")


def _quality_tracks(reads: list[dict]) -> tuple[np.ndarray, ...]:
    """(live, q, i, d, c): the reads' quality tracks masked to & 127 in
    (n, R) uint8 arrays zero-padded to the longest read, and the (n, R)
    mask of real positions."""
    lens = np.fromiter((len(r["q"]) for r in reads), np.int64, len(reads))
    live = np.arange(int(lens.max()))[None, :] < lens[:, None]
    tracks = []
    for k in ("q", "i", "d", "c"):
        t = np.zeros(live.shape, np.uint8)
        t[live] = np.concatenate([np.asarray(r[k], np.uint8) for r in reads])
        tracks.append(t & 127)
    return (live, *tracks)


def _result_matches(live, q, i, d, c) -> np.ndarray:
    """(n,) float32 resultMatch of reads given as :func:`_quality_tracks`:
    per read the reference's sequential product, the factors of later
    positions multiplied in by a row-wise ``cumprod`` with 1.0 past the
    read's end, which changes no bit."""
    ph = CTX_F32.ph2pr
    one = np.float32(1.0)
    rm = ((one - ph[q[:, 0]]) * (one - ph[c[:, 0]])
          * CTX_F32.initial_constant).astype(np.float32)
    if q.shape[1] > 1:
        dist_m = (one - ph[q[:, 1:]]).astype(np.float32)
        p_mm = CTX_F32.set_mm_prob(i[:, 1:], d[:, 1:]).astype(np.float32)
        factors = np.where(live[:, 1:], dist_m * p_mm, one).astype(np.float32)
        rm = (rm * np.cumprod(factors, axis=1, dtype=np.float32)[:, -1]
              ).astype(np.float32)
    return rm


def read_corr(q: np.ndarray) -> np.ndarray:
    """float32 one-mismatch correction of qualities ``q`` (& 127): distN /
    distM = (dist * 1/3) / (1 - dist), dist = ph2pr[q], with 1/3 rounded
    to float32 first (``seed_extend.py:94-102``).  Q0 gives inf."""
    dist = CTX_F32.ph2pr[q].astype(np.float32)
    one = np.float32(1.0)
    third = one / np.float32(3.0)
    with np.errstate(divide="ignore"):
        return ((dist * third) / (one - dist)).astype(np.float32)


def result_match(read: dict) -> np.float32:
    """All-match path probability (compute_fast_prob.cc:15-30), f32 with the
    reference's exact sequential multiply order."""
    return _result_matches(*_quality_tracks([read]))[0]


def stage_fast(reads: list[dict], haps: list[np.ndarray],
               pairs: list[tuple[int, int]], device
               ) -> tuple[torch.Tensor, ...]:
    """The fast scorer's arguments for (read, hap) pairs on ``device``:
    rbases (n_r, R) uint8 and corr (n_r, R) float32 zero-padded, rslen
    (n_r,) int32, rm (n_r,) float32, haps (n_h, H) uint8 zero-padded,
    haplen (n_h,) int32, ridx and hidx (B,) int64.  Each distinct read
    and hap of ``pairs`` ships once, its factors computed over all reads
    at once; bases go as they are (the engine passes them normalized,
    BASE_NORM)."""
    pi = np.asarray(pairs, np.int64).reshape(-1, 2)
    ur, ridx = np.unique(pi[:, 0], return_inverse=True)
    uh, hidx = np.unique(pi[:, 1], return_inverse=True)
    rsel = [reads[k] for k in ur]
    live, q, i, d, c = _quality_tracks(rsel)
    rlens = live.sum(axis=1).astype(np.int32)
    rbases = np.zeros(live.shape, np.uint8)
    rbases[live] = np.concatenate([np.asarray(r["bases"], np.uint8)
                                   for r in rsel])
    corr = np.where(live, read_corr(q), np.float32(0.0)).astype(np.float32)
    rm = _result_matches(live, q, i, d, c)
    hsel = [np.asarray(haps[k], np.uint8) for k in uh]
    hlens = np.fromiter((len(h) for h in hsel), np.int32, len(hsel))
    hp = np.zeros((len(hsel), int(hlens.max())), np.uint8)
    hp[np.arange(hp.shape[1])[None, :] < hlens[:, None]] = np.concatenate(hsel)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (rbases, rlens, corr, rm, hp, hlens,
                           ridx.astype(np.int64), hidx.astype(np.int64)))


def fast_scores_plain(rbases: torch.Tensor, rslen: torch.Tensor,
                      corr: torch.Tensor, rm: torch.Tensor,
                      haps: torch.Tensor, haplen: torch.Tensor,
                      ridx: torch.Tensor, hidx: torch.Tensor) -> torch.Tensor:
    """(B,) float32 fast scores of pairs (ridx[b], hidx[b]); arguments as
    :func:`stage_fast` gives them.  The scan of ``_fast_scores_device``
    (``mgl_tpu/ops/seed_extend.py:52``), offset by offset in order: the
    contributions of the valid offsets p <= haplen - rslen are added into
    a float32 accumulator (the others add +0.0, so the scan stops at the
    last pair's last offset), then divided by haplen."""
    dev = rbases.device
    rc = rbases[ridx].int()
    cr = corr[ridx]
    rmv = rm[ridx]
    rl = rslen[ridx].long()
    hl = haplen[hidx].long()
    B, R = rc.shape
    H = haps.shape[1]
    hpad = torch.zeros((B, H + R), dtype=torch.int32, device=dev)
    hpad[:, :H] = haps[hidx].int()
    read_valid = torch.arange(R, device=dev)[None, :] < rl[:, None]
    rc_ok = (rc != AMBIG) & read_valid
    acc = torch.zeros((B,), dtype=torch.float32, device=dev)
    zero = torch.zeros_like(acc)
    last = int((hl - rl).max()) if B else -1
    for p in range(last + 1):
        win = hpad[:, p:p + R]
        mm = (rc != win) & rc_ok & (win != AMBIG)
        n_mm = mm.sum(dim=1)
        pos0 = mm.to(torch.uint8).argmax(dim=1)
        corr0 = cr.gather(1, pos0[:, None])[:, 0]
        contrib = torch.where(n_mm == 0, rmv,
                              torch.where(n_mm == 1, rmv * corr0, zero))
        acc = acc + torch.where(p <= hl - rl, contrib, zero)
    return acc / hl.float()
