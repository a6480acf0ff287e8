"""PairHMM forward (plain torch) and the likelihood engine's cascade.

Counterpart of ``mgl_tpu/ops/pairhmm.py``:

* :func:`forward_plain` is the plain version of the banded PairHMM kernel
  (``csrc/pairhmm_banded.cu``), written once for a dtype: float32 for the
  main pass, float64 for the rescue.  It is the anti-diagonal recurrence
  of ``pairhmm_forward_f32`` (:215) in the spec's op order,
      M = distm * (M_d2 * pMM + (X_d2 + Y_d2) * pGapM)
      X = M_d1[r-1] * pMX + X_d1[r-1] * pZZ
      Y = M_d1[r]   * pMY + Y_d1[r]   * pZZ
  with the last-row (M + X) sum taken in ascending columns.  Torch's
  elementwise ops neither contract a*b+c nor flush denormals, so on the
  card it equals the kernel bit for bit.
* :func:`shared_forward_plain` is the plain version of the shared-hap-set
  kernel (``csrc/pairhmm_shared.cu``): every read against one hap set,
  sweeping only each hap's distinct-suffix columns and restoring the
  wavefront checkpointed at the shared-prefix boundary.
* :func:`compute_likelihoods` is the cascade of ``compute_likelihoods``
  (:524): exact-duplicate hap dedup, then the shared-hap-set pass when the
  work estimate of ``_shared_product_scores`` (:389) favours it, else the
  per-pair product pass over length buckets; log10; and the f64 rescue of
  pairs under ``MIN_ACCEPTED`` (1e-28).  Its two modes: ``use_double``
  sends every pair to the f64 tier alone; ``use_fast_path`` first runs
  the seed-extend scorer (``ops/seed_extend.py``, kernel
  ``csrc/seed_extend.cu``) over the product, and pairs that clear the
  gate keep its score.  :func:`dispatch_likelihoods` is its
  dispatch/finalize split for the pipelined stream (:681).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from mgl_tpu_torch.batch.bucketing import bucket_dims, bucket_pairs
from mgl_tpu_torch.tables import CTX_F32, CTX_F64, MIN_ACCEPTED
from mgl_tpu_torch.utils.logging import get_logger
from mgl_tpu_torch.utils.metrics import METRICS

AMBIG = ord("N")
N_PLANES = 7   # pMM, pGapM, pMX, pMY, pZZ, distm on match, distm on mismatch
BAND = 32      # read rows per band (one warp's lanes)
# The shared-or-product work estimate restates the TPU kernel's geometry
# (pairhmm_pallas.py LANES = 128 reads per tile, bands of 32 rows), so the
# port picks shared mode exactly when the JAX engine does and returns the
# same variant of the numbers.  Re-tuning the choice for the H100's warps
# is later work (ROADMAP).
SHARED_LANES = 128
SHARED_BAND = 32

# One alphabet for every tier: uppercase ACGT; IUPAC codes, lowercase and
# junk map to N (restated from mgl_tpu/ops/pairhmm.py:51)
BASE_NORM = np.full(256, AMBIG, np.uint8)
for _c in b"ACGT":
    BASE_NORM[_c] = _c
    BASE_NORM[_c + 32] = _c


def _shift_down(x: torch.Tensor, first: torch.Tensor | None = None
                ) -> torch.Tensor:
    """out[:, r] = x[:, r-1]; out[:, 0] = ``first`` (n,), or 0: one row
    down, or one lane shuffle with lane 0 taking ``first``."""
    head = torch.zeros_like(x[:, :1]) if first is None else first[:, None]
    return torch.cat([head, x[:, :-1]], dim=1)


def forward_plain(planes: torch.Tensor, rchar: torch.Tensor,
                  rslen: torch.Tensor, haps: torch.Tensor,
                  haplen: torch.Tensor, y_init: torch.Tensor,
                  ridx: torch.Tensor, hidx: torch.Tensor) -> torch.Tensor:
    """(B,) forward scores of pairs (ridx[b], hidx[b]) in ``planes``' dtype,
    scaled by the context's initial constant.  Arguments as
    :func:`mgl_tpu_torch.kernels.pairhmm_cuda.pairhmm_banded_f32`."""
    dev = planes.device
    p = planes[ridx]                                # (B, 7, rows)
    B, _, rows = p.shape
    R = rows - 1                                    # matrix rows 0 .. rows-2
    p_mm, p_gapm, p_mx, p_my, p_zz, dm, dmm = (p[:, k, :R] for k in range(7))
    rc = rchar[ridx][:, :R]
    rl = rslen[ridx].long()
    hl = haplen[hidx].long()
    yi = y_init[hidx]
    H = haps.shape[1]
    hpad = torch.zeros((B, H + R + 1), dtype=torch.int32, device=dev)
    hpad[:, :H] = haps[hidx]

    rows_i = torch.arange(R, device=dev)
    row0 = rows_i == 0
    zero = torch.zeros((B, R), dtype=planes.dtype, device=dev)
    y01 = zero.clone()
    y01[:, 0] = yi                  # diagonals 0 and 1: Y = yInit on row 0
    m_prev2, x_prev2, y_prev2 = zero, zero, y01
    m_prev, x_prev, y_prev = zero, zero, y01
    hapdiag = torch.zeros((B, R), dtype=torch.int32, device=dev)
    hapdiag[:, 0] = hpad[:, 0]
    acc = torch.zeros((B,), dtype=planes.dtype, device=dev)

    for d in range(2, R + H):
        hapdiag = torch.cat([hpad[:, d - 1:d], hapdiag[:, :-1]], dim=1)
        distm = torch.where((rc & hapdiag) != 0, dm, dmm)
        m_cur = distm * (_shift_down(m_prev2) * p_mm
                         + (_shift_down(x_prev2) + _shift_down(y_prev2))
                         * p_gapm)
        y_cur = m_prev * p_my + y_prev * p_zz
        x_cur = _shift_down(m_prev) * p_mx + _shift_down(x_prev) * p_zz

        # boundaries: row 0 holds M = X = 0, Y = yInit; column 0 is zero
        col0 = rows_i == d
        m_cur = torch.where(row0 | col0, zero, m_cur)
        x_cur = torch.where(row0 | col0, zero, x_cur)
        y_cur = torch.where(col0, zero,
                            torch.where(row0, yi[:, None], y_cur))

        # last-row cell (rslen, c = d - rslen), valid for 1 <= c <= haplen
        mv = m_cur.gather(1, rl[:, None])[:, 0]
        xv = x_cur.gather(1, rl[:, None])[:, 0]
        c = d - rl
        acc = acc + torch.where((c >= 1) & (c <= hl), mv + xv,
                                torch.zeros_like(acc))

        m_prev2, x_prev2, y_prev2 = m_prev, x_prev, y_prev
        m_prev, x_prev, y_prev = m_cur, x_cur, y_cur
    return acc


def _lane0(x: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """x with its lane-0 column replaced by ``col`` (n,)."""
    return torch.cat([col[:, None], x[:, 1:]], dim=1)


def shared_forward_plain(planes: torch.Tensor, rchar: torch.Tensor,
                         rslen: torch.Tensor, hstream: torch.Tensor,
                         segtab: torch.Tensor, y_shared: float
                         ) -> torch.Tensor:
    """(n_reads, n_haps) float32 forward scores of every read against every
    hap, scaled by ``y_shared`` (the avxf variant: one yInitial for the
    whole hap set).  Arguments as
    :func:`mgl_tpu_torch.kernels.pairhmm_cuda.pairhmm_shared_f32`.

    The kernel's sweep, vectorised over reads and the 32 rows of a band:
    band by band, hap j sweeps only its stream segment (columns
    pos_j+1 .. len_j) in T_j = len_j - pos_j + 31 steps, lane s computing
    column pos_j + t + 1 - s on step t.  At step ts_j = pos_{j+1} - pos_j
    the wavefront (m, y, w_p, u_p, u_pp, hd, acc of each lane) is the one
    a full sweep of hap j+1 holds there, since both share columns
    <= pos_{j+1}; it is saved and restored as hap j+1's start, with lane
    0's look-ahead (u_p, w_p from the band above, hd) taken from hap j+1's
    own stream.  The (U, W) row that crosses bands is indexed by stream
    slot: slot base_j + o holds column pos_j + 1 + o.  Past a segment's
    end lane 0's look-ahead reads (0, 0), not the next segment's slots:
    those columns lie above len_j and reach no summed cell and no
    checkpoint, and the kernel, whose bands run side by side, need not
    wait for them."""
    dev = planes.device
    n, _, rows = planes.shape
    n_h = segtab.shape[1]
    seg = segtab.cpu().tolist()
    rl = rslen.long().clamp(max=rows - 2)
    nb = (rl + BAND - 1) // BAND
    last_lane = ((rl - 1) % BAND)[:, None]
    u0 = (torch.tensor(y_shared, dtype=torch.float32, device=dev)
          * planes[:, 1, 1])                     # yInit * pGapM[1]
    carry_u = torch.zeros((n, hstream.shape[0]), dtype=torch.float32,
                          device=dev)
    carry_w = torch.zeros_like(carry_u)
    out = torch.zeros((n, n_h), dtype=torch.float32, device=dev)
    lane = torch.arange(BAND, device=dev)
    zero = torch.zeros((n, BAND), dtype=torch.float32, device=dev)
    izero = torch.zeros((n, BAND), dtype=torch.int32, device=dev)
    zcol = zero[:, 0]

    for b in range(int(nb.max()) if n else 0):
        r = b * BAND + lane + 1
        pmm_u, pgapm_u, pmx_u, pzz_u = (planes[:, k, r + 1]
                                        for k in (0, 1, 2, 4))
        pmy, pzz, dm, dmm = (planes[:, k, r] for k in (3, 4, 5, 6))
        rch = rchar[:, r]
        is_last = r[None, :] == rl[:, None]

        def above(slot, end):
            """(U, W) of the row above lane 0 at stream ``slot``: row 0's
            (yInit * pGapM[1], 0) in band 0, else the carry, or (0, 0)
            from the segment's ``end`` on."""
            if b == 0:
                return u0, zcol
            if slot >= end:
                return zcol, zcol
            return carry_u[:, slot], carry_w[:, slot]

        def hcol(slot):
            return hstream[slot].expand(n)

        chk = None
        for j in range(n_h):
            base, pos, hl, T, tsv = (seg[k][j] for k in range(5))
            if pos == 0:
                m_un = y_un = w_p = u_p = acc = zero
                hd = izero
                u_pp = _lane0(zero, u0 if b == 0 else zcol)
            else:
                m_un, y_un, w_p, u_p, u_pp, hd, acc = chk
            end = base + hl - pos
            ua, wa = above(base, end)
            u_p, w_p = _lane0(u_p, ua), _lane0(w_p, wa)
            hd = _lane0(hd, hcol(base))
            ts = T if tsv < 0 else min(max(tsv, 0), T)
            for t in range(T + 1):
                if t == ts:
                    chk = (m_un, y_un, w_p, u_p, u_pp, hd, acc)
                if t == T:
                    break
                distm = torch.where((rch & hd) != 0, dm, dmm)
                m = distm * u_pp
                x = w_p
                y = m_un * pmy + y_un * pzz
                c = pos + t + 1 - lane
                acc = torch.where(is_last & (c >= 1) & (c <= hl), acc + (m + x),
                                  acc)
                u = m * pmm_u + (x + y) * pgapm_u
                w = m * pmx_u + x * pzz_u
                if t >= BAND - 1 and pos + t + 2 - BAND <= hl:
                    carry_u[:, base + t + 1 - BAND] = u[:, -1]
                    carry_w[:, base + t + 1 - BAND] = w[:, -1]
                ua, wa = above(base + t + 1, end)
                m_un, y_un, u_pp = m, y, u_p
                u_p, w_p = _shift_down(u, ua), _shift_down(w, wa)
                hd = _shift_down(hd, hcol(base + t + 1))
            out[:, j] = torch.where(nb == b + 1, acc.gather(1, last_lane)[:, 0],
                                    out[:, j])
    return out


def _raw_even_prefixes(haps: list[np.ndarray]) -> np.ndarray:
    """Even-rounded shared-prefix length of each hap with its
    predecessor, before the monotonic reset rule (0 when the predecessor
    is shorter than 8 bases)."""
    n = len(haps)
    raw = np.zeros(n, np.int64)
    for j in range(1, n):
        prev, cur = np.asarray(haps[j - 1]), np.asarray(haps[j])
        if len(prev) < 8:
            continue
        common = min(len(prev), len(cur))
        neq = np.nonzero(prev[:common] != cur[:common])[0]
        pos = int(neq[0]) if neq.size else common
        raw[j] = pos - pos % 2
    return raw


def compute_haplotype_similarities(
    haps: list[np.ndarray],
) -> tuple[np.ndarray, int, int]:
    """Shared-prefix structure of consecutive haplotypes (the reference's
    computeHaplotypeSimilarities, pairhmm_common.cc:3-63): position[j] is
    the even-rounded length of the prefix hap[j] shares with hap[j-1],
    reset to 0 when the predecessor is shorter than 8 bases or shares
    less than its own recorded prefix; also (cols_min, cols_max) over
    the haps' lengths."""
    raw = _raw_even_prefixes(haps)
    positions = np.zeros(len(haps), np.int64)
    for j in range(1, len(haps)):
        positions[j] = raw[j] if raw[j] >= positions[j - 1] else 0
    lens = [len(h) for h in haps] or [0]
    return positions, min(lens), max(lens)


def use_shared_kernel(read_lens: list[int], haps: list[np.ndarray]) -> bool:
    """Whether a full reads x haps product goes through the shared-hap-set
    kernel: the work estimate of ``_shared_product_scores``
    (ops/pairhmm.py:417-424), unchanged.  Per read-length bucket, shared
    mode sweeps the distinct-suffix stream plus a 31-step ramp per hap for
    every 128 reads; product mode sweeps a mean hap plus a band for every
    128 pairs.  Shared mode needs at least two haps and a read."""
    n_h = len(haps)
    if n_h < 2 or not read_lens:
        return False
    positions, _, _ = compute_haplotype_similarities(haps)
    stream = sum(len(h) - int(p) for h, p in zip(haps, positions))
    total = sum(len(h) for h in haps)
    counts: dict[int, int] = {}
    for n in read_lens:
        counts[bucket_dims(n)] = counts.get(bucket_dims(n), 0) + 1
    hap_cols = total / n_h + SHARED_BAND
    work_shared = sum(math.ceil(g / SHARED_LANES)
                      * (stream + n_h * (SHARED_BAND - 1))
                      for g in counts.values())
    work_product = sum(math.ceil(g * n_h / SHARED_LANES) * hap_cols
                       for g in counts.values())
    return work_shared <= 0.9 * work_product


def _dedup_haps(haps: list[np.ndarray]) -> tuple[list[int], np.ndarray]:
    """Indices of the distinct haps, and each hap's distinct column."""
    canon: dict[bytes, int] = {}
    col = np.empty(len(haps), np.int64)
    uniq: list[int] = []
    for hi, hp in enumerate(haps):
        key = np.asarray(hp).tobytes()
        if key not in canon:
            canon[key] = len(uniq)
            uniq.append(hi)
        col[hi] = canon[key]
    return uniq, col


def normalize(reads: list[dict], haps: list[np.ndarray]):
    """Reads and haps with their bases mapped through BASE_NORM."""
    return ([{**rd, "bases": BASE_NORM[np.asarray(rd["bases"], np.uint8)]}
             for rd in reads],
            [BASE_NORM[np.asarray(h, np.uint8)] for h in haps])


def _product(n_r: int, n_h: int) -> list[tuple[int, int]]:
    return [(ri, hi) for ri in range(n_r) for hi in range(n_h)]


def _shared_mode(reads, haps) -> bool:
    return use_shared_kernel([len(r["bases"]) for r in reads], haps)


def _f32_start(reads, haps, shared: bool, device
               ) -> Callable[[], np.ndarray]:
    """Dispatch the f32 pass of a full reads x haps product (reads and haps
    normalized, haps distinct): the shared-hap-set kernel if ``shared``,
    else the per-pair product kernel over length buckets.  Returns the
    fetch of the (n_r * n_h,) float64 scores in row-major pair order.
    The shared pass's dispatch and fetch each count in the ``engine.f32``
    timer, as the JAX engine times its shared pass (ops/pairhmm.py:594,
    :720)."""
    from mgl_tpu_torch.kernels.pairhmm_cuda import shared_scores

    if not shared:
        return _bucketed_start(CTX_F32, reads, haps,
                               _product(len(reads), len(haps)), device)
    with METRICS.timer("engine.f32"):
        fetch = shared_scores(reads, haps, device)

    def fetch_flat() -> np.ndarray:
        with METRICS.timer("engine.f32"):
            return fetch().reshape(-1)

    return fetch_flat


def _fast_start(reads, haps, device) -> Callable[[], np.ndarray]:
    """The fast path's first pass over a full reads x haps product (reads
    and haps normalized, haps distinct), as ops/pairhmm.py:571-626: the
    seed-extend scores of every pair, synchronised; pairs scoring at least
    MIN_ACCEPTED keep them, and the rest go through the f32 pass - the
    shared kernel only when no pair hits and the estimate favours it
    (:592), else the per-pair kernel over the rest.  Returns the fetch of
    the (n_r * n_h,) float64 scores."""
    from mgl_tpu_torch.kernels.pairhmm_cuda import to_host
    from mgl_tpu_torch.kernels.seed_extend_cuda import fast_scores

    pairs = _product(len(reads), len(haps))
    fs = to_host(fast_scores(reads, haps, pairs, device))()
    hit = fs >= MIN_ACCEPTED
    if not hit.any():
        return _f32_start(reads, haps, _shared_mode(reads, haps), device)
    scores = fs.astype(np.float64)
    rest = np.nonzero(~hit)[0]
    if not len(rest):
        return lambda: scores
    fetch = _bucketed_start(CTX_F32, reads, haps, [pairs[b] for b in rest],
                            device)

    def fetch_all() -> np.ndarray:
        scores[rest] = fetch()
        return scores

    return fetch_all


def _first_pass(reads, haps, device, use_double: bool, use_fast_path: bool
                ) -> Callable[[], np.ndarray]:
    """Dispatch the pass before the rescue over a full reads x haps product
    (reads and haps normalized, haps distinct) and return the fetch of its
    (n_r * n_h,) float64 scores.  ``use_double`` skips the f32 pass and the
    fast path (ops/pairhmm.py:572, :583): every score is -1, under the
    gate, so :func:`_finish_start` sends every pair to the f64 tier.  Else
    ``use_fast_path`` runs :func:`_fast_start`, and without either the
    f32 pass runs in shared mode where the estimate favours it."""
    if use_double:
        n = len(reads) * len(haps)
        return lambda: np.full(n, -1.0)
    if use_fast_path:
        return _fast_start(reads, haps, device)
    return _f32_start(reads, haps, _shared_mode(reads, haps), device)


def compute_likelihoods(reads: list[dict], haps: list[np.ndarray],
                        device: torch.device, use_double: bool = False,
                        use_fast_path: bool = False) -> np.ndarray:
    """(n_reads, n_haps) float64 log10 likelihoods: f32 forward on
    ``device``, f64 rescue for scores under 1e-28.  ``reads`` are dicts of
    uint8 arrays bases/q/i/d/c, ``haps`` uint8 arrays.  Identical haps
    score identically against every read, so each is scored once.
    ``use_double`` scores every pair in f64 alone (the reference's
    all-double configuration); ``use_fast_path`` lets pairs whose
    seed-extend score clears MIN_ACCEPTED take it and skip the DP.  An
    empty product (no read or no hap) gives an empty matrix in every
    mode, and launches nothing."""
    if not reads or not haps:
        return np.zeros((len(reads), len(haps)), np.float64)
    reads, haps = normalize(reads, haps)
    uniq, col = _dedup_haps(haps)
    haps = [haps[k] for k in uniq]
    scores = _first_pass(reads, haps, device, use_double, use_fast_path)()
    out = _finish_start(scores, reads, haps,
                        _product(len(reads), len(haps)), device)()
    return out.reshape(len(reads), len(haps))[:, col]


def dispatch_likelihoods(reads: list[dict], haps: list[np.ndarray],
                         device: torch.device, use_double: bool = False,
                         use_fast_path: bool = False):
    """Async form of :func:`compute_likelihoods` for pipelined batch
    streams (ops/pairhmm.py:681).  Dispatches the f32 pass and returns
    ``step1``; ``step1()`` fetches the f32 scores and dispatches the
    rescue, returning ``finalize``; ``finalize()`` fetches the rescue and
    returns the (n_reads, n_haps) matrix.  Kernels launch on the current
    stream without a sync; results come back by ``non_blocking`` copies
    into pinned host buffers, each waited on through its CUDA event.

    Batches outside shared mode (``use_double``, ``use_fast_path``, one
    hap, duplicate haps, or a product the work estimate prefers) complete
    synchronously here, as the JAX engine's (:705-712), and the closures
    only hand back the result, identical to compute_likelihoods; so does
    an empty product."""
    if not reads or not haps:
        out = compute_likelihoods(reads, haps, device)
        return lambda: (lambda: out)
    norm_reads, norm_haps = normalize(reads, haps)
    n_r, n_h = len(norm_reads), len(norm_haps)
    distinct = len({h.tobytes() for h in norm_haps}) == n_h
    if (use_double or use_fast_path
            or not (distinct and _shared_mode(norm_reads, norm_haps))):
        out = compute_likelihoods(reads, haps, device, use_double,
                                  use_fast_path)
        return lambda: (lambda: out)
    fetch = _f32_start(norm_reads, norm_haps, True, device)

    def step1():
        finish = _finish_start(fetch(), norm_reads, norm_haps,
                               _product(n_r, n_h), device)
        return lambda: finish().reshape(n_r, n_h)

    return step1


def pair_likelihoods(reads: list[dict], haps: list[np.ndarray],
                     pairs: list[tuple[int, int]],
                     device: torch.device) -> np.ndarray:
    """(len(pairs),) float64 log10 likelihoods of (read, hap) pairs: the
    f32 scores of the per-pair kernel, with the pairs under MIN_ACCEPTED
    recomputed by the f64 rescue."""
    reads, haps = normalize(reads, haps)
    scores = _bucketed_start(CTX_F32, reads, haps, pairs, device)()
    return _finish_start(scores, reads, haps, pairs, device)()


def _finish_start(scores: np.ndarray, reads, haps,
                  pairs: list[tuple[int, int]], device
                  ) -> Callable[[], np.ndarray]:
    """log10 of the f32 ``scores`` of ``pairs`` and the dispatch of the f64
    rescue of those under MIN_ACCEPTED (ops/pairhmm.py:641-678).  Returns
    the fetch of the (len(pairs),) float64 log10 likelihoods.  The
    rescue's dispatch and fetch each count in the ``engine.rescue``
    timer (:659, :665)."""
    rescue = np.nonzero(scores < float(MIN_ACCEPTED))[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.log10(scores) - float(CTX_F32.log10_initial_constant)
    if not len(rescue):
        return lambda: out
    with METRICS.timer("engine.rescue"):
        fetch = _bucketed_start(CTX_F64, reads, haps,
                                [pairs[b] for b in rescue], device)

    def apply() -> np.ndarray:
        with METRICS.timer("engine.rescue"):
            vals = fetch()
        with np.errstate(divide="ignore"):
            out[rescue] = (np.log10(vals)
                           - float(CTX_F64.log10_initial_constant))
        return out

    return apply


def _bucketed_start(ctx, reads, haps, pairs, device
                    ) -> Callable[[], np.ndarray]:
    """Dispatch the per-pair kernel in ``ctx``'s precision over the pairs'
    length buckets; returns the fetch of the (len(pairs),) float64
    scores.  Each f32 bucket's shape and device go to the ``engine``
    logger at debug level, as the JAX engine logs its buckets (ops/pairhmm.py:610)."""
    from mgl_tpu_torch.kernels.pairhmm_cuda import scores, to_host

    la = [len(reads[ri]["bases"]) for ri, _ in pairs]
    lb = [len(haps[hi]) for _, hi in pairs]
    log = get_logger("engine")
    pending = []
    for (pa, pb), idxs in bucket_pairs(la, lb):
        if ctx is CTX_F32:
            log.debug("pairhmm bucket (%d, %d) x%d on %s", pa, pb, len(idxs),
                      device)
        pending.append((idxs, to_host(scores(
            reads, haps, [pairs[k] for k in idxs], ctx, device))))

    def fetch() -> np.ndarray:
        out = np.empty(len(pairs), np.float64)
        for idxs, host in pending:
            out[idxs] = host()
        return out

    return fetch
