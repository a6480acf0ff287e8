"""PairHMM kernel wrappers (per-pair f32 and f64, plane f32, shared-hap-set
f32) and their host staging.

:func:`pairhmm_banded_f32` launches ``csrc/pairhmm_banded.cu`` in float,
the counterpart of ``mgl_tpu/kernels/pairhmm_pallas.py:
_pairhmm_banded_kernel``; :func:`pairhmm_banded_f64` launches it in
double, the counterpart of ``pairhmm_xf_pallas.py:_pairhmm_banded_xf_
kernel``; :func:`pairhmm_plane_f32` launches ``csrc/pairhmm_plane.cu``,
the counterpart of ``pairhmm_pallas.py:_pairhmm_kernel``;
:func:`pairhmm_shared_f32` launches ``csrc/pairhmm_shared.cu``, the
counterpart of ``pairhmm_pallas.py:_pairhmm_shared_kernel``.  On CPU
tensors each runs its plain torch version (``mgl_tpu_torch.ops.pairhmm.
forward_plain`` / ``shared_forward_plain``).  The kernel sources say what
bounds them on the card.

The host ships raw uint8 quality tracks and bases; the transition and
emission planes are built on the device by table gathers
(:func:`read_planes`, the port of ``pairhmm_pallas.py:1121
_read_planes_device``), which are plain torch ops, not a kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import numpy as np
import torch

from mgl_tpu_torch import _build
from mgl_tpu_torch.device import resolve_device
from mgl_tpu_torch.kernels import WARPS_PER_SM
from mgl_tpu_torch.ops.pairhmm import (BAND, N_PLANES,
                                       compute_haplotype_similarities,
                                       forward_plain, shared_forward_plain)
from mgl_tpu_torch.tables import (BASE_ENC, CTX_F32, CTX_F64, QualityContext,
                                  context_tables)

_TRACKS = ("q", "i", "d", "c", "bases")
# the pipelined kernels' warps a block (a read for the shared kernel, a
# pair for the banded and plane ones): 1 to the cap, aiming at
# WARPS_PER_SM warps on each SM that holds a block
SHARED_WARPS_MAX = _build.SHARED_MAX_WARPS
BANDED_WARPS_MAX = _build.BANDED_MAX_WARPS
# the plane kernel's read rows a lane (R, a template parameter of
# csrc/pairhmm_plane.cu): a band is 32R rows
PLANE_ROWS_PER_LANE = (2, 4)
# the longest read (in rows) that plane_layout gives R = 2
PLANE_R2_ROWS = 256
_PLANE = "mgl_pairhmm_plane_f32"


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the other inputs on "
                         f"{device}")


def _forward(entry: str, dtype: torch.dtype, planes, rchar, rslen, haps,
             haplen, y_init, ridx, hidx, warps_per_pair: int | None = None,
             rows_per_lane: int | None = None) -> torch.Tensor:
    """Check the per-pair kernels' arguments and launch ``entry``; on CPU
    tensors run the plain forward.  One block a pair of ``warps_per_pair``
    warps, its bands handing one (U, W) carry row down, in shared or
    global memory as the launcher's placement query says.  The banded
    kernels hold a read row a lane and take W by :func:`pair_warps`; the
    plane kernel holds ``rows_per_lane`` rows a lane, and
    :func:`plane_layout` fills in whichever of R and W is not forced."""
    n_r, n_p, rows = planes.shape
    n_h, hap_cols = haps.shape
    B = ridx.shape[0]
    dev = planes.device
    _check("planes", planes, dtype, (n_r, N_PLANES, rows), dev)
    _check("rchar", rchar, torch.int32, (n_r, rows), dev)
    _check("rslen", rslen, torch.int32, (n_r,), dev)
    _check("haps", haps, torch.int32, (n_h, hap_cols), dev)
    _check("haplen", haplen, torch.int32, (n_h,), dev)
    _check("y_init", y_init, dtype, (n_h,), dev)
    _check("ridx", ridx, torch.int64, (B,), dev)
    _check("hidx", hidx, torch.int64, (B,), dev)
    if (rows - 2) % BAND:
        raise ValueError(f"planes need 32k + 2 rows, got {rows}")
    if dev.type == "cpu":
        return forward_plain(planes, rchar, rslen, haps, haplen, y_init,
                             ridx, hidx)
    if dev.type != "cuda":
        raise ValueError(f"pairhmm kernels run on cuda or cpu, not {dev}")
    if B == 0 or hap_cols == 0:
        raise ValueError(f"the PairHMM kernel needs pairs and hap bases, got "
                         f"{B} pairs and {hap_cols} hap columns")
    args = [x.contiguous() for x in (planes, rchar, rslen, haps, haplen,
                                     y_init, ridx, hidx)]
    out = torch.empty((B,), dtype=dtype, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the placement query's last argument: R for the plane kernel, whether
    # the banded kernel runs in double
    if entry == _PLANE:
        rows_per_lane, w = plane_layout(B, rows, sms, rows_per_lane)
        n_bands = plane_bands(rows, rows_per_lane)
        query, variant = "mgl_pairhmm_plane_carry_in_shared", rows_per_lane
        layout = [rows_per_lane]
    else:
        n_bands = (rows - 2) // BAND
        w = pair_warps(B, n_bands, sms)
        query = "mgl_pairhmm_banded_carry_in_shared"
        variant = int(dtype == torch.float64)
        layout = []
    if warps_per_pair is None:
        warps_per_pair = w
    if n_bands * (hap_cols + 1) >= 2 ** 31:
        raise ValueError(f"the PairHMM kernel counts a pair's progress in "
                         f"int32: {n_bands} bands x {hap_cols} columns is "
                         f"too large")
    in_shared = _row_in_shared(dev, query, B, hap_cols, warps_per_pair,
                               variant)
    # else the (U, W) row that crosses bands lies in global memory, one
    # (U, W) pair a hap column, never read unwritten
    carry = (None if in_shared else
             torch.empty((B, hap_cols, 2), dtype=dtype, device=dev))
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = getattr(lib, entry)(
            *(a.data_ptr() for a in args), B, rows, hap_cols, warps_per_pair,
            *layout, int(in_shared), None if carry is None else carry.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, code, entry)
    return out


def _checked_warps(name: str, warps, cap: int):
    """``warps`` if it is None or an int from 1 to ``cap``, else raise."""
    if warps is not None and not (isinstance(warps, int)
                                  and 1 <= warps <= cap):
        raise ValueError(f"{name}: 1 to {cap}, got {warps!r}")
    return warps


def pairhmm_banded_f32(planes, rchar, rslen, haps, haplen, y_init, ridx,
                       hidx, warps_per_pair: int | None = None
                       ) -> torch.Tensor:
    """(B,) float32 forward scores, 2^120-scaled, of pairs
    (ridx[b], hidx[b]).  ``planes`` (n_reads, 7, 32k+2) float32 by matrix
    row (see :func:`read_planes`), ``rchar`` (n_reads, 32k+2) int32
    one-hot, ``rslen`` (n_reads,) int32 <= 32k, ``haps`` (n_haps, H) int32
    one-hot, ``haplen`` (n_haps,) int32 <= H, ``y_init`` (n_haps,) float32,
    ``ridx``/``hidx`` (B,) int64, each below n_reads / n_haps (not
    checked on the card: that would synchronise).

    One block a pair: its bands run side by side on ``warps_per_pair``
    warps, pipelined through one carry row, which lies in shared memory
    where that costs the launch no resident blocks, else in global memory
    (the launcher's query :func:`banded_carry_in_shared`).  By default
    :func:`pair_warps` picks W; forcing one (1 to BANDED_WARPS_MAX) gives
    the same bits."""
    w = _checked_warps("warps_per_pair", warps_per_pair, BANDED_WARPS_MAX)
    out = _forward("mgl_pairhmm_banded_f32", torch.float32, planes, rchar,
                   rslen, haps, haplen, y_init, ridx, hidx, warps_per_pair=w)
    if planes.device.type == "cuda":
        pairhmm_banded_f32.launches += 1
    return out


def pairhmm_banded_f64(planes, rchar, rslen, haps, haplen, y_init, ridx,
                       hidx, warps_per_pair: int | None = None
                       ) -> torch.Tensor:
    """As :func:`pairhmm_banded_f32` in float64 with CTX_F64 planes and
    2^1020 scaling: the rescue tier."""
    w = _checked_warps("warps_per_pair", warps_per_pair, BANDED_WARPS_MAX)
    out = _forward("mgl_pairhmm_banded_f64", torch.float64, planes, rchar,
                   rslen, haps, haplen, y_init, ridx, hidx, warps_per_pair=w)
    if planes.device.type == "cuda":
        pairhmm_banded_f64.launches += 1
    return out


def pairhmm_plane_f32(planes, rchar, rslen, haps, haplen, y_init, ridx,
                      hidx, warps_per_pair: int | None = None,
                      rows_per_lane: int | None = None) -> torch.Tensor:
    """(B,) float32 forward scores, 2^120-scaled, by the plane kernel
    (``csrc/pairhmm_plane.cu``, the counterpart of
    ``pairhmm_pallas.py:_pairhmm_kernel``); arguments as
    :func:`pairhmm_banded_f32`.  Its plain version is
    ``ops.pairhmm.forward_plain``, the full-height recurrence, which is
    the banded kernel's plain version too.

    One block a pair: bands of 32R read rows, R = ``rows_per_lane`` (2 or
    4) a lane, run side by side on ``warps_per_pair`` warps (1 to
    BANDED_WARPS_MAX), pipelined through one carry row, which lies in
    shared memory where that costs the launch no resident blocks, else in
    global memory (:func:`plane_carry_in_shared`).  By default
    :func:`plane_layout` picks R and W; forcing either gives the same
    bits.  No read length is refused but one whose bands x hap columns
    overflow the int32 progress counter."""
    w = _checked_warps("warps_per_pair", warps_per_pair, BANDED_WARPS_MAX)
    if rows_per_lane is not None and rows_per_lane not in PLANE_ROWS_PER_LANE:
        raise ValueError(f"rows_per_lane: one of {PLANE_ROWS_PER_LANE}, got "
                         f"{rows_per_lane!r}")
    out = _forward(_PLANE, torch.float32, planes, rchar, rslen, haps, haplen,
                   y_init, ridx, hidx, warps_per_pair=w,
                   rows_per_lane=rows_per_lane)
    if planes.device.type == "cuda":
        pairhmm_plane_f32.launches += 1
    return out


def plane_bands(rows: int, rows_per_lane: int) -> int:
    """Bands of the plane kernel over planes of ``rows`` (32k + 2) rows at
    R = ``rows_per_lane``: ceil((rows - 2) / 32R)."""
    return -(-(rows - 2) // (BAND * rows_per_lane))


def plane_layout(n_pairs: int, rows: int, sm_count: int,
                 rows_per_lane: int | None = None) -> tuple[int, int]:
    """(R, W) of the plane kernel for n_pairs pairs over planes of ``rows``
    rows on a card of ``sm_count`` SMs.  R, unless forced: 2 for reads of
    up to PLANE_R2_ROWS rows, 4 beyond.  An R = 4 step takes 1.7-1.9x an
    R = 2 step for twice the cells, but its bands add 64 steps of ramp
    and up to 127 rows past the read, and with few pairs its half as many
    bands fill fewer warps: R = 2 was 12-45% faster at 100-151 bp and at
    250 bp on 24 and 384 pairs, and within 1.2% of R = 4 at 250 bp on
    6,144; R = 4 was 18-24% faster at 1,000 and 6,000 bp (an H100 at
    700 W, the R x W sweeps of ``time_pairhmm_banded --sweep``, PERF.md
    section 6).  W by
    :func:`_pipeline_warps` over the bands of that R, at most
    BANDED_WARPS_MAX."""
    if rows_per_lane is None:
        rows_per_lane = 2 if rows - 2 <= PLANE_R2_ROWS else 4
    return rows_per_lane, _pipeline_warps(
        n_pairs, plane_bands(rows, rows_per_lane), sm_count,
        BANDED_WARPS_MAX)


def plane_carry_in_shared(n_pairs: int, hap_cols: int, warps_per_pair: int,
                          rows_per_lane: int, device) -> bool:
    """Whether :func:`pairhmm_plane_f32` keeps the carry row of n_pairs
    pairs against haps of ``hap_cols`` columns at (R, W) = (rows_per_lane,
    warps_per_pair) in shared memory on ``device`` (a CUDA device): the
    launcher's choice, asked once a shape and device."""
    return _row_in_shared(device, "mgl_pairhmm_plane_carry_in_shared",
                          n_pairs, hap_cols, warps_per_pair, rows_per_lane)


def _pipeline_warps(n_blocks: int, n_bands: int, sm_count: int,
                    cap: int) -> int:
    """Warps a block for a kernel that runs a block's bands on its warps
    (warp w runs bands w, w+W, ...).  The least W that puts WARPS_PER_SM
    warps on each SM holding a block, at most the bands, then the bands
    shared out evenly over as few rounds as that W allows (a warp runs
    ceil(n_bands / W) bands one after another, so 5 bands take W = 5, not
    4), and at most ``cap``."""
    n_bands = max(n_bands, 1)
    target = min(n_blocks, sm_count) * WARPS_PER_SM
    w = min(n_bands, cap, -(-target // max(n_blocks, 1)))
    rounds = max(n_bands // w, -(-n_bands // cap))
    return -(-n_bands // rounds)


def shared_warps(n_reads: int, n_bands: int, sm_count: int) -> int:
    """Warps a read for the shared kernel (one block a read), by
    :func:`_pipeline_warps`, at most SHARED_WARPS_MAX."""
    return _pipeline_warps(n_reads, n_bands, sm_count, SHARED_WARPS_MAX)


def pair_warps(n_pairs: int, n_bands: int, sm_count: int) -> int:
    """Warps a pair for the per-pair banded kernels (one block a pair), by
    :func:`_pipeline_warps`, at most BANDED_WARPS_MAX: 5 at the rescue
    tier's 384 pairs of 151 bp reads, 1 at 6,144."""
    return _pipeline_warps(n_pairs, n_bands, sm_count, BANDED_WARPS_MAX)


def banded_carry_in_shared(n_pairs: int, hap_cols: int, warps_per_pair: int,
                           dtype: torch.dtype, device) -> bool:
    """Whether :func:`pairhmm_banded_f32` (``dtype`` float32) or
    :func:`pairhmm_banded_f64` (float64) keeps the carry row of n_pairs
    pairs against haps of ``hap_cols`` columns in shared memory on
    ``device`` (a CUDA device): the launcher's choice, from the block's
    opt-in limit and the blocks an SM holds either way, asked once a
    shape and device."""
    return _row_in_shared(device, "mgl_pairhmm_banded_carry_in_shared",
                          n_pairs, hap_cols, warps_per_pair,
                          int(dtype == torch.float64))


def shared_carry_in_shared(n_reads: int, stream_cols: int,
                           warps_per_read: int, device) -> bool:
    """Whether :func:`pairhmm_shared_f32` keeps the carry row of n_reads
    reads against a stream of ``stream_cols`` slots (``hstream``'s length)
    in shared memory on ``device`` (a CUDA device): the launcher's choice,
    from the block's opt-in limit and the blocks an SM holds either way,
    asked once a shape and device."""
    return _row_in_shared(device, "mgl_pairhmm_shared_carry_in_shared",
                          n_reads, stream_cols, warps_per_read)


def _row_in_shared(device, query: str, *shape: int) -> bool:
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _ask_launcher(index, query, *shape)


@functools.lru_cache(maxsize=1024)
def _ask_launcher(index: int, query: str, *shape: int) -> bool:
    """The answer of a launcher's C placement query (1 shared, 0 global,
    minus a CUDA error code) on device ``index``, cached a shape."""
    lib = _build.load_library()
    with torch.cuda.device(index):
        got = getattr(lib, query)(*shape)
    if got < 0:
        _build.check_launch(lib, -got, query)
    return bool(got)


def pairhmm_shared_f32(planes, rchar, rslen, hstream, segtab,
                       y_shared: float, warps_per_read: int | None = None
                       ) -> torch.Tensor:
    """(n_reads, n_haps) float32 forward scores of every read against every
    hap of one hap set, scaled by ``y_shared`` = 2^120 / COLS_MAX (the
    caller rescales by COLS_MAX / haplen).  ``planes``, ``rchar``,
    ``rslen`` as :func:`pairhmm_banded_f32` in CTX_F32; ``hstream`` (S+34,)
    int32 one-hot distinct-suffix stream and ``segtab`` (5, n_haps) int32
    as :func:`segment_table` builds them (not checked on the card: that
    would synchronise).

    One block a read: its bands run side by side on ``warps_per_read``
    warps, pipelined through one carry row, which lies in shared memory
    where that costs the launch no resident blocks, else in global memory
    (the launcher's query :func:`shared_carry_in_shared`).  By default
    :func:`shared_warps` picks W; forcing one (1 to SHARED_WARPS_MAX)
    gives the same bits."""
    _checked_warps("warps_per_read", warps_per_read, SHARED_WARPS_MAX)
    n_r, _, rows = planes.shape
    n_h = segtab.shape[1]
    cols = hstream.shape[0]
    dev = planes.device
    _check("planes", planes, torch.float32, (n_r, N_PLANES, rows), dev)
    _check("rchar", rchar, torch.int32, (n_r, rows), dev)
    _check("rslen", rslen, torch.int32, (n_r,), dev)
    _check("hstream", hstream, torch.int32, (cols,), dev)
    _check("segtab", segtab, torch.int32, (5, n_h), dev)
    if (rows - 2) % BAND:
        raise ValueError(f"planes need 32k + 2 rows, got {rows}")
    if dev.type == "cpu":
        return shared_forward_plain(planes, rchar, rslen, hstream, segtab,
                                    y_shared)
    if dev.type != "cuda":
        raise ValueError(f"pairhmm kernels run on cuda or cpu, not {dev}")
    if n_r == 0 or n_h == 0:
        raise ValueError(f"the shared kernel needs reads and haps, got "
                         f"{n_r} reads and {n_h} haps")
    n_bands = (rows - 2) // BAND
    if n_bands * (cols + 1) >= 2 ** 31:
        raise ValueError(f"the shared kernel counts a read's progress in "
                         f"int32: {n_bands} bands x {cols} slots is too large")
    if warps_per_read is None:
        warps_per_read = shared_warps(
            n_r, n_bands,
            torch.cuda.get_device_properties(dev).multi_processor_count)
    args = [x.contiguous() for x in (planes, rchar, rslen, hstream, segtab)]
    out = torch.zeros((n_r, n_h), dtype=torch.float32, device=dev)
    in_shared = shared_carry_in_shared(n_r, cols, warps_per_read, dev)
    # else the (U, W) row that crosses bands lies in global memory, one
    # (U, W) pair a stream slot, never read unwritten
    carry = (None if in_shared else
             torch.empty((n_r, cols, 2), dtype=torch.float32, device=dev))
    lib = _build.load_library()
    with torch.cuda.device(dev):
        code = lib.mgl_pairhmm_shared_f32(
            *(a.data_ptr() for a in args), n_r, rows, n_h, cols,
            ctypes.c_float(y_shared), warps_per_read, int(in_shared),
            None if carry is None else carry.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, code, "mgl_pairhmm_shared_f32")
    pairhmm_shared_f32.launches += 1
    return out


pairhmm_banded_f32.launches = 0
pairhmm_banded_f64.launches = 0
pairhmm_shared_f32.launches = 0
pairhmm_plane_f32.launches = 0


def to_host(t: torch.Tensor) -> Callable[[], np.ndarray]:
    """Start the copy of ``t`` to the host and return its fetch.  On the
    card: a ``non_blocking`` copy into a pinned buffer on the current
    stream, guarded by a CUDA event that the fetch waits on; on the CPU
    the fetch returns ``t`` as it is."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))

    def fetch() -> np.ndarray:
        done.synchronize()
        return host.numpy()

    return fetch


def stack_tracks(reads: list[dict]) -> tuple[np.ndarray, ...]:
    """(n, rmax) uint8 matrices of q, i, d, c and bases, zero-padded, and
    (n,) int32 read lengths."""
    lens = np.fromiter((len(r["bases"]) for r in reads), np.int32, len(reads))
    rmax = int(lens.max())
    live = np.arange(rmax)[None, :] < lens[:, None]
    mats = []
    for key in _TRACKS:
        m = np.zeros((len(reads), rmax), np.uint8)
        m[live] = np.concatenate([np.asarray(r[key], np.uint8) for r in reads])
        mats.append(m)
    return (*mats, lens)


def read_planes(q, i, d, c, bases, rslen, tables: dict, rows: int):
    """Per-read planes on the tracks' device: (planes (n, 7, rows) in the
    tables' dtype, rchar (n, rows) int32 one-hot).  Row r is matrix row r
    (read base r); row 0 and rows past each read are zero.  Planes:
    pMM, pGapM, pMX, pMY, pZZ, 1 - ph2pr[q], ph2pr[q] / 3, with the same
    table values and op order as the JAX package's plane builders
    (core/context.py:read_transition_rows)."""
    n, rmax = q.shape
    ph2pr, m2m = tables["ph2pr"], tables["match_to_match"]
    qi, ii, di, ci = ((x & 127).long() for x in (q, i, d, c))
    mn, mx = torch.minimum(ii, di), torch.maximum(ii, di)
    distm = ph2pr[qi]
    vals = torch.stack([
        m2m[((mx * (mx + 1)) >> 1) + mn],     # pMM
        1.0 - ph2pr[ci],                      # pGapM
        ph2pr[ii],                            # pMX
        ph2pr[di],                            # pMY
        ph2pr[ci],                            # pZZ
        1.0 - distm,                          # distm on a match
        distm * tables["one_third"],          # distm on a mismatch
    ], dim=1)
    live = (torch.arange(rmax, device=q.device)[None, :]
            < rslen.to(q.device)[:, None])
    planes = torch.zeros((n, N_PLANES, rows), dtype=tables["dtype"],
                         device=q.device)
    planes[:, :, 1:rmax + 1] = vals * live[:, None, :]
    rchar = torch.zeros((n, rows), dtype=torch.int32, device=q.device)
    rchar[:, 1:rmax + 1] = tables["base_enc"][bases.long()] * live
    return planes, rchar


def _to_dev(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def stage_reads(reads: list[dict], ctx: QualityContext, device
                ) -> tuple[torch.Tensor, ...]:
    """(planes, rchar, rslen) of ``reads`` in ``ctx``'s precision: raw
    uint8 tracks ship to ``device`` and the planes are gathered there,
    with 32k + 2 rows."""
    q, i, d, c, bases, rlens = stack_tracks(reads)
    rows = (int(rlens.max()) + BAND - 1) // BAND * BAND + 2
    rslen = _to_dev(rlens, device)
    planes, rchar = read_planes(*(_to_dev(a, device)
                                  for a in (q, i, d, c, bases)),
                                rslen, context_tables(ctx, device), rows)
    return planes, rchar, rslen


def stage_pairs(reads: list[dict], haps: list[np.ndarray],
                pairs: list[tuple[int, int]], ctx: QualityContext, device
                ) -> tuple[torch.Tensor, ...]:
    """The kernel arguments for (read, hap) pairs in ``ctx``'s precision:
    each distinct read's tracks and each distinct hap ship once, planes
    are gathered on ``device``, and ridx/hidx expand the product in the
    kernel.  Reads' bases and haps are already normalized (BASE_NORM)."""
    pi = np.asarray(pairs, np.int64).reshape(-1, 2)
    ur, ridx = np.unique(pi[:, 0], return_inverse=True)
    uh, hidx = np.unique(pi[:, 1], return_inverse=True)
    to_dev = lambda a: _to_dev(a, device)
    planes, rchar, rslen = stage_reads([reads[k] for k in ur], ctx, device)

    hlens = np.fromiter((len(haps[k]) for k in uh), np.int32, len(uh))
    hp = np.zeros((len(uh), int(hlens.max())), np.int32)
    hp[np.arange(hp.shape[1])[None, :] < hlens[:, None]] = BASE_ENC[
        np.concatenate([np.asarray(haps[k], np.uint8) for k in uh])]
    y_init = ctx.dtype(ctx.initial_constant) / hlens.astype(ctx.dtype)
    return (planes, rchar, rslen, to_dev(hp), to_dev(hlens), to_dev(y_init),
            to_dev(ridx.astype(np.int64)), to_dev(hidx.astype(np.int64)))


def scores(reads: list[dict], haps: list[np.ndarray],
           pairs: list[tuple[int, int]], ctx: QualityContext, device
           ) -> torch.Tensor:
    """(B,) scores of (read, hap) pairs on ``device``, not synchronised.
    CTX_F32: float32 scaled by 2^120, the main pass (port of
    pairhmm_pallas.py:1237 forward_scores_product).  CTX_F64: float64
    scaled by 2^1020, the rescue tier for pairs whose f32 score fell under
    1e-28 (port of pairhmm_xf_pallas.py:694 in native f64).  Reads' bases
    and haps are already normalized (BASE_NORM)."""
    kernel = pairhmm_banded_f64 if ctx is CTX_F64 else pairhmm_banded_f32
    return kernel(*stage_pairs(reads, haps, pairs, ctx, device))


def forward_scores_plane(reads: list[dict], haps: list[np.ndarray],
                         pairs: list[tuple[int, int]],
                         device: str | torch.device = "cuda") -> torch.Tensor:
    """(B,) float32 scores, 2^120-scaled, of (read, hap) pairs through the
    plane kernel: the counterpart of ``pairhmm_pallas.py:1340
    forward_scores_plane``, with the per-pair kernels' staging
    (:func:`stage_pairs`) in place of the TPU's lane-major
    ``prepare_inputs``.  Reads' bases and haps are already normalized
    (BASE_NORM); not synchronised."""
    return pairhmm_plane_f32(*stage_pairs(reads, haps, pairs, CTX_F32,
                                          resolve_device(device)))


def segment_table(haps: list[np.ndarray], positions: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The shared kernel's hap input (pairhmm_pallas.py:923-947): the
    (S + 34,) int32 one-hot stream of each hap's distinct suffix (hap j
    from its shared-prefix position pos_j on; S in all), zero-padded for
    the sweep's look-ahead past the last segment, and the (5, n_haps)
    int32 segment table: stream base, pos_j, hap length, sweep steps
    T_j = len_j - pos_j + 31, and the checkpoint step pos_{j+1} - pos_j
    (-1 where hap j+1 starts afresh)."""
    n_h = len(haps)
    seg_len = [len(h) - int(p) for h, p in zip(haps, positions)]
    base = np.concatenate([[0], np.cumsum(seg_len)]).astype(np.int64)
    hstream = np.zeros(int(base[-1]) + BAND + 2, np.int32)
    segtab = np.full((5, n_h), -1, np.int32)
    for j, h in enumerate(haps):
        p = int(positions[j])
        hstream[base[j]:base[j + 1]] = BASE_ENC[np.asarray(h, np.uint8)[p:]]
        segtab[:4, j] = base[j], p, len(h), seg_len[j] + BAND - 1
        if j + 1 < n_h and positions[j + 1] > 0:
            segtab[4, j] = int(positions[j + 1]) - p
    return hstream, segtab


def stage_shared(reads: list[dict], haps: list[np.ndarray], device
                 ) -> tuple:
    """The arguments of :func:`pairhmm_shared_f32` for every read against
    the hap set (pairhmm_pallas.py:893 forward_scores_shared): read planes
    in CTX_F32, the stream and segment table of the haps' shared
    prefixes, and y_shared = float32(2^120) / float32(COLS_MAX)
    (:949).  The stream and table are the same for every read: on the card
    each band stages the stream's next 32 slots a chunk ahead, so it is
    shipped once and read from cache.  Reads' bases and haps are already
    normalized (BASE_NORM)."""
    positions, _, cols_max = compute_haplotype_similarities(haps)
    hstream, segtab = segment_table(haps, positions)
    y_shared = float(np.float32(CTX_F32.initial_constant)
                     / np.float32(cols_max))
    return (*stage_reads(reads, CTX_F32, device), _to_dev(hstream, device),
            _to_dev(segtab, device), y_shared)


def rescale_shared(raw: np.ndarray, haps: list[np.ndarray]) -> np.ndarray:
    """(n_reads, n_haps) float64 scores scaled by 2^120 / haplen from the
    shared kernel's raw float32 scores: raw * COLS_MAX / haplen in float64,
    with float32 factors as in the reference (compute_prob_avxf.cc:1086,
    pairhmm_pallas.py:971-975)."""
    lens = np.array([np.float32(len(h)) for h in haps], np.float64)
    cols_max = float(np.float32(max(len(h) for h in haps)))
    return raw.astype(np.float64) * cols_max / lens[None, :]


def shared_scores(reads: list[dict], haps: list[np.ndarray], device
                  ) -> Callable[[], np.ndarray]:
    """Dispatch the shared-hap-set kernel over reads x haps and start the
    copy of its scores to the host; the returned fetch yields the
    (n_reads, n_haps) float64 scores scaled by 2^120 / haplen (the avxf
    variant of the product's scores).  Reads' bases and haps are already
    normalized (BASE_NORM)."""
    host = to_host(pairhmm_shared_f32(*stage_shared(reads, haps, device)))
    return lambda: rescale_shared(host(), haps)
