#!/usr/bin/env python3
"""Drive mgl_tpu_torch's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card

The quickest proof that the port still starts on the card.  It builds the
ten CUDA kernels (eight sources) from ``mgl_tpu_torch/csrc``, one nvcc
each, all started together, and the host library (the CIGAR decoder and
the mapper's seeding) from ``csrc/host``, holds each kernel against its
plain torch version on the card, runs the goldens through both GATK
entry points
(``SmithWatermanAligner.align_batch``,
``PairHmmEngine.compute_likelihoods``, also with ``use_double`` and
``fast_path``), then drives the main path at a realistic size - the
aligner, the engine in shared and product mode, and
``PairHmmEngine.compute_likelihoods_stream`` - and times it, then the
engine's two modes over the same regions; then the
plane path, the second design of both recurrences
(``sw_cuda.align_batch``, ``sw_cuda.sw_plane_scores``,
``pairhmm_cuda.forward_scores_plane``), against the goldens and the
banded kernels; then the read mapper (``map_reads_stream``) and
``align_and_sort`` on a 64 Mbp reference, through the window gather and
the banded SW kernel in score mode; then the mapper in CIGAR mode, through
the banded SW kernel in traceback mode and the CIGAR walk kernel; then the
``mgl-map`` CLI; then the parallel layer: the sharded pipeline step on a
one-rank NCCL mesh, the elastic pipeline and map scale-outs with worker
processes on the card, and ``align_and_sort`` on the mesh.  Phases:

0. environment (card, power limit, CUDA, nvcc, the port's host library);
1. build of the kernels;
2. each kernel vs its plain version on the card, bit for bit (the five
   pipelined kernels - banded and plane SW, per-pair, plane and shared
   PairHMM - at every warps-a-block count W, the plane PairHMM kernel at
   every W and rows a lane R, with the carry row in shared and in global
   memory; the seed-extend kernel on the golden rows, a region's product,
   its edge pairs and the edges of its offsets-on-lanes design; the
   window gather at every nibble shift and both reference edges, flat and
   blocked, odd and even read lengths; the CIGAR walk in all four
   strategies, across its SEG_CAP with overflowed pairs, on indels of
   9-47 bases at band edges that leave its windows, on walks cut short,
   on pairs with zero starts and on a chunk of 8,192 windows);
3. all SW golden cases, CIGAR and offset exact;
4. PairHMM known answers and golden rows through the cascade, and
   through ``use_double`` and ``fast_path``;
5. the main path at a realistic size, with launch counts and times;
6. the stream over the same regions, bit-equal to sequential calls;
6b. the engine's ``use_double`` and ``fast_path`` modes over the same
   regions: launch counts, bit-equal to the engine on the CPU on samples,
   the stream bit-equal to sequential calls, warm pairs/s; and
   ``fast_path`` on a region with no hit, through the shared kernel;
7. the plane path: SW goldens, the 150 bp batch and PairHMM regions,
   bit-equal to the banded kernels, with launch counts;
7b. the read mapper at a realistic size (see :func:`run_mapper`): the
   index build, ``map_reads_stream`` and ``align_and_sort``, with launch
   counts, window accuracy, sampled scores against the plain path on the
   card, the sort against NumPy, warm reads/s, the host stages and the
   card's idle share over a warm chunk;
7c. the mapper in CIGAR mode at a realistic size (see
   :func:`run_cigar_mapper`): launch counts, the tier split, every CIGAR
   of the traceback tier against the plain path on the card, warm
   reads/s, the host stages and the idle share of a warm chunk;
7d. ``python -m mgl_tpu_torch.cli`` on the card in both modes;
8. kernel and plain times at the main path's shapes, with bounds, and
   the pipelined kernels' W sweeps (registers and spills, warps an SM,
   carry placement); the plane SW kernel also into preallocated outputs,
   apart from its wrapper's zero fill; the plane PairHMM kernel beside
   the banded f32 kernel on the same pairs, with its R x W sweep; the
   seed-extend kernel and the f64 per-pair kernel at a region's 6,144
   pairs; the window gather at one mapper chunk; the CIGAR walk at one
   traceback chunk of 8,192 windows, with the post-pass's host time; the
   seed-extend and walk kernels' launch geometry, shared memory,
   registers and spills (a spill fails the phase);
9a. ``parallel/pipeline.pipeline_step`` at a real size on a one-rank NCCL
   mesh (see :func:`run_step`): every output bit-equal to the same step on
   the CPU, both kernels against their plain versions at its shapes, the
   warm step's median and spread, kernel times, bound and idle share;
9b. the elastic pipeline scale-out (see :func:`run_step_scaleout`): two
   ``worker --device cuda`` processes, one killed by SIGKILL, bit-identical
   to one process;
9c. the elastic map scale-out at config 4's shape (see
   :func:`run_map_scaleout`): phase 7b's workload through two
   ``map-worker --device cuda`` processes, one killed, equal to phase 7b;
9d. ``align_and_sort`` on the one-rank mesh, equal to ``mesh=None``;
10. the size range (see :func:`run_size_range`): the JAX package's long
   SW pairs (20 kbp x 5 kbp, 12 kbp x 6.5 kbp) and 64 pairs of up to
   8,000 x 2,000 through ``align_batch`` in all four strategies, equal to
   the plain path on the card; three long PairHMM sets (5.6 kbp and 16
   kbp haps, 4 kb reads) through the engine in its three modes, against
   the scalar oracle or bit-equal to ``device="cpu"``; and the mapper on
   GRCh38's coordinate space (3.09 Gbp, half the reads past 2^31) in
   score and CIGAR mode, with ``align_and_sort`` and ``write_sam``
   checked against the truth;
11. the scale runs (see :func:`run_scale`): ``python -m
   mgl_tpu_torch.scale_configs`` in three processes - config 4 at
   1,048,576 reads on 64 Mbp and config 5's sorts (10M keys on the card),
   the three CIGAR configs (262,144 and 1,048,576 reads, and the 5% error
   sweep), and the 10M-key sort on 8 gloo ranks - with the data-dependent
   fields of ``tests/golden/scale_report.json`` held equal.

Any failed phase raises and the script exits non-zero.  The last line is
one JSON object naming the device; the line before it lists the kernels
with their launches, errors, times and bounds.  Imports nothing of jax or
of the JAX package ``mgl_tpu``.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SW_PARAMS = (25, -50, 110, 6)          # STANDARD_NGS
# H100 SXM peaks for the bounds (NVIDIA's data sheet, dense, at 700 W):
# float32 and float64 outside the tensor cores, int32 as 64 INT32 lanes
# per SM x 132 SMs x 1.98 GHz (the clock behind the 67 TFLOP/s), HBM3.
PEAK = {"f32": 67e12, "f64": 34e12, "int32": 132 * 64 * 1.98e9,
        "bytes": 3.35e12}
# operations a cell, counted from the sources: PairHMM 7 multiplies and
# 4 adds (pairhmm_banded.cu, pairhmm_shared.cu, pairhmm_plane.cu); SW 12
# integer ops for the scores and 18 more for the traceback nibble (the
# step of sw_wavefront.cuh:235-255), the same for the plane kernel's
# traceback and samples modes; its best-score mode 11 (two gaps of two
# subtractions and a maximum, the substitution's compare, select and add,
# and two maxima)
FLOPS_PER_CELL = 11
SW_OPS_PER_CELL = {True: 30, False: 12}
SW_SCORE_OPS_PER_CELL = 11
# the seed-extend scan, counted as what the function needs, not what
# seed_extend.cu issues: with each base a one-hot mask (N all ones), made
# once a base of each distinct read and hap (a shift and the N select),
# a read position compared at an offset is an AND and a test for zero,
# counted up to each offset's second mismatch, where the scan can stop;
# and one float32 add a valid offset into the pair's sum
SEED_OPS_PER_BASE = 2
SEED_MASK_OPS_PER_BASE = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def compare_sw(args, indel_init: bool, with_traceback: bool, warps) -> int:
    """Banded kernel at each W of ``warps`` (None: the wrapper's choice) vs
    plain on the card: the largest |ez| difference plus the number of real
    traceback cells that differ (0 when bit-equal)."""
    import torch

    from mgl_tpu_torch.kernels.sw_cuda import sw_banded, sw_banded_plain
    from mgl_tpu_torch.ops.sw import banded_layout
    from mgl_tpu_torch.testing import traceback_mismatches

    kw = dict(indel_init=indel_init, with_traceback=with_traceback)
    ez_p, w_p = sw_banded_plain(*args, *SW_PARAMS, **kw)
    err = 0
    for w in warps:
        ez_k, w_k = sw_banded(*args, *SW_PARAMS, **kw, warps_per_pair=w)
        torch.cuda.synchronize()
        e = int((ez_k.long() - ez_p.long()).abs().max())
        if with_traceback:
            wpb = banded_layout(args[0].shape[1], args[1].shape[1])[1]
            e += traceback_mismatches(w_k, w_p, args[2], args[3], wpb)
        err = max(err, e)
    return err


def sw_plane_mode(args, indel_init: bool, mode: str):
    """(kernel call, plain call, integer ops a cell) of the plane SW in
    ``mode`` (traceback, samples, scores); each call returns a tuple of
    output tensors, the kernel call at the W it is given (None: the
    wrapper's choice)."""
    from mgl_tpu_torch.kernels import sw_cuda
    from mgl_tpu_torch.ops.sw import sw_plane_plain, sw_plane_scores_plain

    if mode == "scores":
        kw = dict(indel_init=indel_init)
        return (lambda w=None: (sw_cuda.sw_plane_scores(
                    *args, *SW_PARAMS, **kw, warps_per_pair=w),),
                lambda: (sw_plane_scores_plain(*args, *SW_PARAMS, **kw),),
                SW_SCORE_OPS_PER_CELL)
    kw = dict(indel_init=indel_init, with_traceback=mode == "traceback")
    return (lambda w=None: sw_cuda.sw_plane(*args, *SW_PARAMS, **kw,
                                            warps_per_pair=w),
            lambda: sw_plane_plain(*args, *SW_PARAMS, **kw),
            SW_OPS_PER_CELL[mode == "traceback"])


def compare_sw_plane(args, indel_init: bool, mode: str, warps=(None,)) -> int:
    """Plane kernel at each W of ``warps`` (None: the wrapper's choice) vs
    plain on the card in ``mode``: the largest difference over every
    output (0 when bit-equal; words outside the real cells are zero in
    both)."""
    import torch

    run, run_plain, _ = sw_plane_mode(args, indel_init, mode)
    want = run_plain()
    err = 0
    for w in warps:
        got = run(w)
        torch.cuda.synchronize()
        err = max(err, *(int((g.long() - x.long()).abs().max())
                         for g, x in zip(got, want)))
    return err


def compare_pairhmm(args, kernel, layouts=({},)) -> float:
    """A per-pair PairHMM kernel vs the plain forward on the card at each
    layout of ``layouts`` (the keywords that force it, {}: the wrapper's
    choice): the largest |difference| (0.0 when bit-equal)."""
    import torch

    from mgl_tpu_torch.kernels import pairhmm_cuda as ph

    want = ph.forward_plain(*args)
    err = 0.0
    for kw in layouts:
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, float((got.double() - want.double()).abs().max()))
    return err


def compare_seed_extend(args) -> float:
    """The seed-extend kernel vs its plain version on the card: raises
    unless bit-equal (NaN where plain has NaN); returns the largest
    |difference| over the finite entries (0.0)."""
    import torch

    from mgl_tpu_torch.kernels.seed_extend_cuda import seed_extend_f32
    from mgl_tpu_torch.ops.seed_extend import fast_scores_plain
    from mgl_tpu_torch.testing import same_scores

    got = seed_extend_f32(*args)
    want = fast_scores_plain(*args)
    torch.cuda.synchronize()
    if not same_scores(got, want):
        raise AssertionError(f"seed-extend kernel != plain on "
                             f"{len(got)} pairs")
    ok = torch.isfinite(want)
    return float((got[ok].double() - want[ok].double()).abs().max())


def seed_extend_work(args, chunk: int = 256) -> tuple[int, int]:
    """(read positions, offsets) the seed-extend scan of these staged pairs
    must compare and add: at each valid offset, the positions up to and
    including its second mismatch (all of the read if it has fewer) -
    what this run's data needs, for the bound."""
    import torch

    rbases, rslen, _, _, haps, haplen, ridx, hidx = args
    R, H = rbases.shape[1], haps.shape[1]
    pos = torch.arange(R, device=rbases.device)
    total = offsets = 0
    for b0 in range(0, len(ridx), chunk):
        ri, hi = ridx[b0:b0 + chunk], hidx[b0:b0 + chunk]
        rl, hl = rslen[ri].long(), haplen[hi].long()
        offsets += int((hl - rl + 1).clamp(min=0).sum())
        n_off = int((hl - rl).max()) + 1
        if n_off < 1:
            continue
        hpad = torch.zeros((len(ri), H + R), dtype=torch.uint8,
                           device=rbases.device)
        hpad[:, :H] = haps[hi]
        win = hpad.unfold(1, R, 1)[:, :n_off]            # (b, n_off, R)
        rc = rbases[ri][:, None, :]
        live = pos[None, None, :] < rl[:, None, None]
        mm = (rc != win) & (rc != 78) & (win != 78) & live
        seen = mm.cumsum(2) - mm.int()                   # mismatches before
        valid = (torch.arange(n_off, device=rbases.device)[None, :]
                 <= (hl - rl)[:, None])
        total += int(((seen < 2) & live & valid[:, :, None]).sum())
    return total, offsets


def seed_extend_bound(args, n_pairs: int) -> tuple[float, str, int, int]:
    """(ms, "operations" or "bytes", positions, offsets): the least time
    of the seed-extend scan of these staged pairs - the int32 ops of its
    compares and masks and the float32 adds of its sum (SEED_OPS_PER_BASE
    and the counts of :func:`seed_extend_work`), against the staged
    arguments read once and the scores written once."""
    positions, offsets = seed_extend_work(args)
    mask_bases = int(args[1].sum()) + int(args[5].sum())
    t_ops = ((positions * SEED_OPS_PER_BASE
              + mask_bases * SEED_MASK_OPS_PER_BASE) / PEAK["int32"]
             + offsets / PEAK["f32"]) * 1e3
    t_bytes = (nbytes(*args) + n_pairs * 4) / PEAK["bytes"] * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", positions, offsets
    return t_bytes, "bytes", positions, offsets


def traceback_bytes(targets, queries) -> tuple[int, int]:
    """Bytes of the traceback words that come back to the host for a batch
    padded to its maxima: (plane layout, banded layout)."""
    from mgl_tpu_torch.ops.sw import BAND, banded_layout, plane_words

    T, Q = max(map(len, targets)), max(map(len, queries))
    nb, wpb = banded_layout(T, Q)
    return (len(targets) * plane_words(T, Q) * (T + 1) * 4,
            len(targets) * nb * wpb * BAND * 4)


def bound(ops: float, peak: str, n_bytes: float) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``ops`` operations at PEAK[peak] and ``n_bytes`` of traffic."""
    t_ops, t_bytes = ops / PEAK[peak] * 1e3, n_bytes / PEAK["bytes"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# the window gather, counted as what the function needs: a shift and a
# mask to take a base's nibble out of its word (the bound is bytes)
GATHER_OPS_PER_BASE = 2
# the mapper phase: BASELINE config 4's reference and reads (64 Mbp, 150
# bp at 1% error, k = 16, chunks of 131,072), cut to 262,144 reads
MAP_REF_LEN = 64_000_000
MAP_READS = 262_144
MAP_CHUNK = 131_072
MAP_READ_LEN = 150


def compare_gather(dev) -> tuple[float, str]:
    """The window gather kernel vs its plain version on the card, bit for
    bit: a 1 Mbp reference with N runs and lowercase bases, flat and
    blocked (``_BLOCK_GATE`` forced to 1 with 256 kbp rows), reads of 150
    and 151 bp with N and lowercase bases taken by row (permuted, then
    repeated) and strand (half reverse complemented, the query codes held
    to encode(revcomp(read)) too), windows at all eight nibble shifts, at
    the first and the last words and at random.  Raises on a difference;
    returns (0.0, what was held)."""
    import numpy as np
    import torch

    from mgl_tpu_torch.kernels.window_cuda import (window_gather,
                                                   window_gather_plain)
    from mgl_tpu_torch.pipelines import mapper as mp
    from mgl_tpu_torch.testing import ACGT, window_starts

    rng = np.random.default_rng(41)
    ref = ACGT[rng.integers(0, 4, 1_000_003)]
    ref[rng.integers(0, len(ref), 500)] = ord("N")
    ref[1000:1400] += ord("a") - ord("A")        # lowercase (n for N)
    mixed = np.frombuffer(b"ACGTNacgtn", np.uint8)
    saved = mp._BLOCK_GATE, mp._BLOCK_BITS
    held = []
    try:
        for layout, gate, bits in (("flat", *saved), ("blocked", 1, 18)):
            mp._BLOCK_GATE, mp._BLOCK_BITS = gate, bits
            words, blocked = mp._ref_device(mp.ReferenceIndex.build(ref),
                                            dev)
            if blocked != (layout == "blocked"):
                raise AssertionError(f"window gather: {layout} layout not "
                                     f"taken")
            for L in (150, 151):
                wlen = L + 48
                starts = window_starts(L, len(ref), wlen, 4096)
                n = len(starts)
                reads = rng.choice(mixed, (n - n // 4, L))
                rows = np.concatenate([rng.permutation(n - n // 4),
                                       rng.integers(0, n - n // 4, n // 4)])
                rc = rng.integers(0, 2, n).astype(np.uint8)
                args = (words, tuple(torch.from_numpy(s).to(dev) for s in
                                     mp._split_starts(starts, blocked)),
                        torch.from_numpy(reads).to(dev),
                        torch.from_numpy(rows.astype(np.int32)).to(dev),
                        torch.from_numpy(rc).to(dev), wlen, L)
                got = window_gather(*args)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                want = window_gather_plain(*args)
                oriented = np.where(rc[:, None] == 1, mp.revcomp(reads[rows]),
                                    reads[rows])
                if not (all(torch.equal(a, b) for a, b in zip(got, want))
                        and np.array_equal(got[1].cpu().numpy(),
                                           mp.encode(oriented))):
                    raise AssertionError(f"window gather != plain ({layout}, "
                                         f"L = {L})")
                held.append(f"{layout} L={L} {len(starts)} windows")
    finally:
        mp._BLOCK_GATE, mp._BLOCK_BITS = saved
    return 0.0, ", ".join(held)


def run_mapper(dev, drive, ref_len: int = MAP_REF_LEN,
               n_reads: int = MAP_READS, chunk: int = MAP_CHUNK,
               read_len: int = MAP_READ_LEN, n_check: int = 1024,
               workload=None) -> dict:
    """Phase 7b: the read mapper at a realistic size, through its entry
    points on ``dev``.

    The workload is BASELINE config 4's (``tools/run_scale_configs.py``):
    a simulated 64 Mbp reference made from a seed, reads of 150 bp at 1%
    substitutions, the k = 16 index by the native radix build, and
    ``map_reads_stream`` in chunks of 131,072; then ``align_and_sort`` of
    the same reads (config 5 on one card).  The cut: config 4 maps
    1,048,576 reads (``tests/golden/scale_report.json``); this phase maps
    262,144, two chunks, to stay inside the script's time limit.

    ``drive`` runs the main path with the launch counts set to 0 just
    before and read just after.  Checks: the true start lies in the
    window for at least 99% of reads; the scores of ``n_check`` sampled
    non-exact windows equal the plain path's on the same device (the plain
    gather feeding ``sw_banded_plain``); align_and_sort's positions and
    scores equal the stream's, and its keys ascend and equal a stable
    NumPy argsort of the same keys.  Then a warm pass with the ``map.*``
    stage times, and on a card the idle share over one warm chunk.

    ``workload`` = (index, reads, true global starts) maps those instead
    of a simulated reference (phase 10's GRCh38 coordinate space)."""
    import numpy as np
    import torch

    from mgl_tpu_torch.kernels.sw_cuda import sw_banded_plain
    from mgl_tpu_torch.kernels.window_cuda import window_gather_plain
    from mgl_tpu_torch.pipelines import mapper as mp
    from mgl_tpu_torch.pipelines.align_sort import (align_and_sort,
                                                    coordinate_keys)
    from mgl_tpu_torch.profile_e2e import _tally
    from mgl_tpu_torch.testing import simulate_reads
    from mgl_tpu_torch.utils.metrics import METRICS

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t_sim = t_index = 0.0
    if workload is None:
        t0 = time.perf_counter()
        ref, reads, true_pos = simulate_reads(0, ref_len, n_reads, read_len)
        t_sim = time.perf_counter() - t0
        t0 = time.perf_counter()
        index = mp.ReferenceIndex.build(ref, k=16)
        t_index = time.perf_counter() - t0
    else:
        index, reads, true_pos = workload
        n_reads, read_len = reads.shape

    def main_path():
        out = mp.map_reads_stream(index, reads, chunk=chunk, device=dev)
        srt = align_and_sort(index, reads, device=dev)
        sync()
        return out, srt

    (out, srt), launches, t_cold = drive(main_path)
    pos, pad = out["pos"], out["window_pad"]
    wlen = read_len + 2 * pad
    inside = (pos >= 0) & (true_pos >= pos) & (true_pos <= pos + wlen
                                                - read_len)
    accuracy = float(inside.mean())
    if accuracy < 0.99:
        raise AssertionError(f"mapper: the true start lies in the window for "
                             f"{accuracy:.4f} of reads (< 0.99)")
    # sampled non-exact windows against the plain path on the same device
    rest = np.nonzero((pos >= 0) & (out["offset"] < 0))[0]
    pick = np.sort(np.random.default_rng(1).choice(
        rest, min(n_check, len(rest)), replace=False))
    words, blocked = mp._ref_device(index, dev)
    tgt, qry = window_gather_plain(
        words, tuple(torch.from_numpy(s).to(dev)
                     for s in mp._split_starts(pos[pick], blocked)),
        torch.from_numpy(reads[pick]).to(dev),
        torch.arange(len(pick), dtype=torch.int32, device=dev),
        torch.from_numpy(out["strand"][pick].astype(np.uint8)).to(dev),
        wlen, read_len)
    full = lambda v: torch.full((len(pick),), v, dtype=torch.int32,
                                device=dev)
    ez, _ = sw_banded_plain(tgt, qry, full(wlen), full(read_len), *SW_PARAMS,
                            indel_init=False, with_traceback=False)
    plain = ez[2].cpu().numpy().astype(np.int64)
    if not np.array_equal(plain, out["score"][pick]):
        raise AssertionError(f"mapper: {int((plain != out['score'][pick]).sum())}"
                             f" of {len(pick)} sampled scores differ from the "
                             f"plain path")
    # align_and_sort: the stream's seeding and scores, keys in order
    for k in ("pos", "score", "strand", "offset"):
        if not np.array_equal(srt[k], out[k]):
            raise AssertionError(f"align_and_sort {k} != map_reads_stream's")
    keys = coordinate_keys(np.where(srt["contig"] >= 0, srt["contig"], 0),
                           np.where(srt["local_pos"] >= 0, srt["local_pos"],
                                    -1), np.arange(n_reads) & 0xFFFF)
    order = np.argsort(keys, kind="stable")
    if not ((srt["keys"][1:] >= srt["keys"][:-1]).all()
            and np.array_equal(srt["keys"], keys[order])
            and np.array_equal(srt["order"], order)):
        raise AssertionError("align_and_sort: keys or order != NumPy's")
    # warm: the whole stream, then one chunk under the profiler
    METRICS.reset()
    t0 = time.perf_counter()
    mp.map_reads_stream(index, reads, chunk=chunk, device=dev)
    sync()
    t_warm = time.perf_counter() - t0
    stages = {k: v for k, v in METRICS.snapshot()["timers_s"].items()
              if k.startswith("map.")}
    idle = busy_ms = wall = None
    if dev.type == "cuda":
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            mp.map_reads_stream(index, reads[:chunk], chunk=chunk,
                                device=dev)
            sync()
            wall = time.perf_counter() - t0
        busy = _tally(prof)[2]
        if busy is not None:
            busy_ms, idle = busy / 1e3, 1.0 - busy / 1e6 / wall
    return {"index": index, "reads": reads, "out": out, "wlen": wlen,
            "launches": launches, "t_sim": t_sim, "t_index": t_index,
            "n_kmers": len(index.sorted_kmers), "t_cold": t_cold,
            "t_warm": t_warm, "accuracy": accuracy,
            "mapped": float((pos >= 0).mean()),
            "exact": float((out["offset"] >= 0).mean()),
            "n_checked": len(pick), "stages": stages, "idle": idle,
            "busy_ms": busy_ms, "chunk_wall": wall, "inside": inside,
            "srt": srt}


# the CIGAR walk, counted as what the function needs: a step is one
# word's address (the band and word of the cell, ~6 ops), its nibble
# (shift and mask, 3), the automaton's next state and moves (~6), the
# run-length compare and the position update (~5)
WALK_OPS_PER_STEP = 20
# the CIGAR mapper phase: config4_cigar's error model
# (tools/run_scale_configs.py:117): 1% substitutions, 2% of the reads with
# a 1-2 bp deletion after read position 70
MAP_DEL_FRAC = 0.02
WALK_CHUNK = 8192          # sw_cigar_windows' chunk


def walk_steps(segs, tail, over, I0, J0) -> int:
    """Cells the walk visited, from its outputs: the lengths of its pushed
    segments and the run in flight; a pair that overflowed lost segments,
    so it counts max(I0 - I, J0 - J), which the walk cannot undercut."""
    import torch

    nseg = tail[:, 0].long()
    k = torch.arange(segs.shape[1], device=segs.device)
    pushed = ((segs >> 2) * (k[None, :] < nseg[:, None])).sum(1)
    exact = pushed + tail[:, 2]
    floor = torch.maximum(I0 - tail[:, 3], J0 - tail[:, 4])
    return int(torch.where(over, floor, exact).sum())


def compare_walk(dev) -> tuple[float, str]:
    """The CIGAR walk kernel vs its plain version on the card, bit for bit,
    on traceback words of the banded SW kernel: the 96 reads of
    ``testing.indel_read_set``, the deletion sweep across SEG_CAP
    (``deletion_sweep_set``, overflowed pairs present) and the 36 reads of
    ``walk_window_set`` (indels of 9-47 bases at band edges, which leave
    the kernel's windows; also cut short at 37 and 100 steps) in all four
    strategies, pairs whose start has I or J at 0, and one full chunk of
    8,192 windows of 198 x 150 (reads at 1% substitutions, 2% with a
    deletion, against a 4 Mbp reference).  Raises on a difference;
    returns (0.0, what was held)."""
    import numpy as np
    import torch

    from mgl_tpu_torch.core.params import OverhangStrategy, SWParameters
    from mgl_tpu_torch.kernels.cigar_walk_cuda import cigar_walk
    from mgl_tpu_torch.ops.cigar_device import cigar_walk_plain
    from mgl_tpu_torch.pipelines import mapper as mp
    from mgl_tpu_torch.testing import (ACGT, deletion_reads,
                                       deletion_sweep_set, indel_read_set,
                                       walk_window_set)

    params = SWParameters(*SW_PARAMS)
    rng = np.random.default_rng(43)
    ref = ACGT[rng.integers(0, 4, 4_000_000, dtype=np.uint8)]
    reads, true_pos, _ = deletion_reads(44, ref, WALK_CHUNK, MAP_READ_LEN)
    wlen = MAP_READ_LEN + 48
    chunk_set = (ref, np.clip(true_pos - 24, 0, len(ref) - wlen), reads,
                 wlen)
    held = []
    for label, (r, starts, rd, wl) in (("indel", indel_read_set()),
                                        ("SEG_CAP sweep",
                                         deletion_sweep_set()),
                                        ("window", walk_window_set()),
                                        ("8,192-window chunk", chunk_set)):
        index = mp.ReferenceIndex.build(r, k=16)
        n_over = {}
        for s in OverhangStrategy:
            ez, words, wpb = mp._sw_traceback_windows(index, starts, rd, wl,
                                                      params, s, dev)
            full = lambda v: torch.full((len(rd),), v, dtype=torch.int32,
                                        device=dev)
            args = (words, ez, full(wl), full(rd.shape[1]))
            n_steps = wl + rd.shape[1]
            got = cigar_walk(*args, s, n_steps, words_per_band=wpb)
            torch.cuda.synchronize()
            want = cigar_walk_plain(*args, strategy=int(s), n_steps=n_steps,
                                    words_per_band=wpb)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"CIGAR walk != plain ({label}, "
                                     f"{s.name})")
            n_over[s.name] = int(got[2].sum())
            if label == "indel" and s == OverhangStrategy.SOFTCLIP:
                first8 = (words[:8].clone(), ez[:, :8].clone(),
                          args[2][:8].clone(), args[3][:8].clone(), wpb,
                          n_steps)
            if label == "window" and s == OverhangStrategy.SOFTCLIP:
                for cut in (37, 100):        # walks that n_steps cuts off
                    got = cigar_walk(*args, s, cut, words_per_band=wpb)
                    want = cigar_walk_plain(*args, strategy=int(s),
                                            n_steps=cut, words_per_band=wpb)
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"CIGAR walk != plain (window, "
                                             f"cut at {cut} steps)")
        if label == "SEG_CAP sweep" and not n_over["SOFTCLIP"]:
            raise AssertionError("CIGAR walk: the SEG_CAP sweep overflowed "
                                 "no pair")
        held.append(f"{label} {len(rd)} pairs (overflowed {n_over}"
                    f"{'; also cut at 37 and 100 steps' if label == 'window' else ''})")
    # pairs 0-2 start at I = 0, J = 0 or both (SOFTCLIP reads max_t,
    # max_q); pairs 3-4 at tlen = 0 or qlen = 0 (INDEL)
    words, ez, tl, ql, wpb, n_steps = first8
    ez[3, 0] = 0
    ez[4, 1] = 0
    ez[3:5, 2] = 0
    tl[3] = 0
    ql[4] = 0
    for s in (OverhangStrategy.SOFTCLIP, OverhangStrategy.INDEL):
        got = cigar_walk(words, ez, tl, ql, s, n_steps, words_per_band=wpb)
        want = cigar_walk_plain(words, ez, tl, ql, strategy=int(s),
                                n_steps=n_steps, words_per_band=wpb)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"CIGAR walk != plain (zero starts, "
                                 f"{s.name})")
    held.append("8 pairs with zero starts")
    return 0.0, "; ".join(held)


def run_cigar_mapper(dev, drive, index, n_reads: int = MAP_READS,
                     chunk: int = MAP_CHUNK, read_len: int = MAP_READ_LEN,
                     n_check: int = 1024, workload=None) -> dict:
    """Phase 7c: the read mapper in CIGAR mode at a realistic size, through
    ``map_reads_stream(with_cigar=True)`` on ``dev``.

    The workload is ``tools/run_scale_configs.py:117 config4_cigar``'s:
    262,144 reads of 150 bp at 1% substitutions, 2% of them (spread over
    the batch) with a 1-2 bp deletion after read position 70, chunks of
    131,072.  The cut: the reads are drawn from phase 7b's 64 Mbp
    reference and mapped with its index, not a second one built from
    config4_cigar's seed.

    ``drive`` runs the main path with the launch counts set to 0 just
    before and read just after.  Checks: every mapped read has a CIGAR,
    every mapped deletion read's CIGAR has a D; the traceback tier
    (recomputed from the certification rule, its size equal to
    ``map.tb_reads``) gets the CIGARs and offsets of the plain path on the
    card - the plain gather, ``sw_banded_plain`` in traceback mode,
    ``cigar_walk_plain``, ``finish_cigars`` and the host decoder for
    overflowed walks - and ``n_check`` sampled tier reads those of the
    host decoder on the kernels' own words.  Then a warm pass with the
    ``map.*`` stage times, and the idle share over one warm chunk.

    ``workload`` = (reads, del_idx, true starts) maps those reads with
    ``index`` instead (phase 10's GRCh38 coordinate space); the D check
    then covers the deletion reads whose window holds their true start (a
    deletion read whose seeds voted for another locus has no D to find
    there)."""
    import numpy as np
    import torch

    from mgl_tpu_torch.core.params import OverhangStrategy, SWParameters
    from mgl_tpu_torch.kernels.sw_cuda import sw_banded_plain
    from mgl_tpu_torch.kernels.window_cuda import window_gather_plain
    from mgl_tpu_torch.native import cigar_decode_bulk_banded
    from mgl_tpu_torch.ops.cigar_device import cigar_walk_plain, finish_cigars
    from mgl_tpu_torch.ops.sw import BAND, EZ_KEYS, banded_layout
    from mgl_tpu_torch.pipelines import mapper as mp
    from mgl_tpu_torch.profile_e2e import _tally
    from mgl_tpu_torch.testing import deletion_reads
    from mgl_tpu_torch.utils.metrics import METRICS

    soft = OverhangStrategy.SOFTCLIP
    params = SWParameters(*SW_PARAMS)
    L = read_len
    t0 = time.perf_counter()
    true_pos = None
    if workload is None:
        reads, _, del_idx = deletion_reads(4, index.ref, n_reads, L,
                                           del_frac=MAP_DEL_FRAC)
    else:
        reads, del_idx, true_pos = workload
        n_reads, L = reads.shape
    t_sim = time.perf_counter() - t0

    def main_path():
        out = mp.map_reads_stream(index, reads, chunk=chunk, with_cigar=True,
                                  device=dev)
        torch.cuda.synchronize()
        return out

    METRICS.reset()
    out, launches, t_cold = drive(main_path)
    n_tb = int(METRICS.snapshot()["counters"].get("map.tb_reads", 0))
    pos, pad = out["pos"], out["window_pad"]
    wlen = L + 2 * pad
    mapped = np.nonzero(pos >= 0)[0]
    if not all(out["cigar"][mapped]):
        raise AssertionError("CIGAR mapper: a mapped read has no CIGAR")
    del_on = del_idx[pos[del_idx] >= 0]
    if true_pos is not None:
        del_on = del_on[(true_pos[del_on] >= pos[del_on])
                        & (true_pos[del_on] <= pos[del_on] + wlen - L)]
    no_d = [int(i) for i in del_on if "D" not in out["cigar"][i]]
    if no_d:
        raise AssertionError(f"CIGAR mapper: {len(no_d)} mapped deletion "
                             f"reads without a D, e.g. "
                             f"{[(i, out['cigar'][i]) for i in no_d[:3]]}")
    oriented = lambda idx: np.where(out["strand"][idx, None] == 1,
                                    mp.revcomp(reads[idx]), reads[idx])
    # the tiers, by the stream's own rules: exact (the best score), then
    # the certified diagonal where the window is surely not edge-clipped
    start = pos[mapped]
    nm = mp._nm_at(index.ref, start + pad, reads, out["strand"][mapped],
                   mapped)
    diag = (L - nm) * params.match + nm * params.mismatch
    inner = (start > 0) & (start < len(index.ref) - wlen)
    exact = out["score"][mapped] == L * params.match
    cert = ~exact & inner & (out["score"][mapped] == diag)
    tier = mapped[~exact & ~cert]
    if len(tier) != n_tb:
        raise AssertionError(f"CIGAR mapper: {len(tier)} reads outside the "
                             f"exact and certified tiers, map.tb_reads "
                             f"{n_tb}")
    # the traceback tier against the plain path on the card
    words_dev, blocked = mp._ref_device(index, dev)
    wpb = banded_layout(wlen, L)[1]
    plain, n_over = [], 0
    t0 = time.perf_counter()
    for lo in range(0, len(tier), WALK_CHUNK):
        idx = tier[lo: lo + WALK_CHUNK]
        full = lambda v: torch.full((len(idx),), v, dtype=torch.int32,
                                    device=dev)
        tgt, qry = window_gather_plain(
            words_dev, tuple(torch.from_numpy(x).to(dev) for x in
                             mp._split_starts(pos[idx], blocked)),
            torch.from_numpy(reads[idx]).to(dev),
            torch.arange(len(idx), dtype=torch.int32, device=dev),
            torch.from_numpy(out["strand"][idx].astype(np.uint8)).to(dev),
            wlen, L)
        ez, words = sw_banded_plain(tgt, qry, full(wlen), full(L),
                                    *SW_PARAMS, indel_init=False,
                                    with_traceback=True)
        segs, tail, over = cigar_walk_plain(
            words, ez, full(wlen), full(L), strategy=int(soft),
            n_steps=wlen + L, words_per_band=wpb)
        res = finish_cigars(segs.cpu().numpy(), tail.cpu().numpy(),
                            {"seg_length": ez[5].cpu().numpy()},
                            np.full(len(idx), wlen), np.full(len(idx), L),
                            soft, len(idx))
        over = over.cpu().numpy()
        n_over += int(over.sum())
        plain.extend(mp.decode_overflow(
            [None if o else r for r, o in zip(res, over)], words, ez, wlen,
            L, soft, wpb))
    t_plain = time.perf_counter() - t0
    got = list(zip(out["cigar"][tier], out["offset"][tier]))
    bad = [k for k, (a, b) in enumerate(zip(got, plain)) if a != b]
    if bad:
        raise AssertionError(f"CIGAR mapper: {len(bad)} of {len(tier)} "
                             f"traceback-tier reads differ from the plain "
                             f"path, e.g. {[(got[k], plain[k]) for k in bad[:3]]}")
    # sampled tier reads: the host decoder on the kernels' own words
    pick = np.sort(np.random.default_rng(2).choice(
        tier, min(n_check, len(tier)), replace=False))
    ez, words, _ = mp._sw_traceback_windows(index, pos[pick], oriented(pick),
                                            wlen, params, soft, dev)
    host = cigar_decode_bulk_banded(
        words.cpu().numpy().view(np.uint32),
        dict(zip(EZ_KEYS, ez.cpu().numpy().astype(np.int64))),
        np.full(len(pick), wlen, np.int32), np.full(len(pick), L, np.int32),
        int(soft), BAND, wpb)
    if host != list(zip(out["cigar"][pick], out["offset"][pick])):
        raise AssertionError("CIGAR mapper: sampled tier reads differ from "
                             "the host decoder on the kernels' words")
    # warm: the whole stream, then one chunk under the profiler
    METRICS.reset()
    t0 = time.perf_counter()
    mp.map_reads_stream(index, reads, chunk=chunk, with_cigar=True,
                        device=dev)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    snap = METRICS.snapshot()
    stages = {k: v for k, v in snap["timers_s"].items()
              if k.startswith("map.")}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        mp.map_reads_stream(index, reads[:chunk], chunk=chunk,
                            with_cigar=True, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _tally(prof)[2]
    idle = busy_ms = None
    if busy is not None:
        busy_ms, idle = busy / 1e3, 1.0 - busy / 1e6 / wall
    return {"launches": launches, "t_sim": t_sim, "t_cold": t_cold,
            "t_warm": t_warm, "mapped": len(mapped), "exact": int(exact.sum()),
            "certified": int(cert.sum()), "tier": tier,
            "cert_idx": mapped[cert], "n_over": n_over,
            "n_del": len(del_idx), "t_plain": t_plain, "n_check": len(pick),
            "n_del_off": int((pos[del_idx] >= 0).sum()) - len(del_on),
            "reads": reads, "out": out, "wlen": wlen, "stages": stages,
            "tb_warm": int(snap["counters"].get("map.tb_reads", 0)),
            "idle": idle, "busy_ms": busy_ms, "chunk_wall": wall,
            "oriented": oriented}


def run_cli() -> str:
    """The CLI phase: ``python -m mgl_tpu_torch.cli`` on the card in a
    temporary directory, on ``testing.write_map_inputs``' two contigs and
    40 reads, in score mode and with ``--cigar``.  Checks the SAM's 40
    records, that most reads map, and in ``--cigar`` mode that no mapped
    record has a ``*`` CIGAR.  Returns what it held."""
    import os
    import tempfile

    from mgl_tpu_torch.testing import write_map_inputs

    held = []
    with tempfile.TemporaryDirectory() as tmp:
        fa, fq = write_map_inputs(tmp, 5)
        for mode in ("score", "cigar"):
            sam = pathlib.Path(tmp) / f"{mode}.sam"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "mgl_tpu_torch.cli", str(fa), str(fq),
                 str(sam), "--device", "cuda",
                 *(["--cigar"] if mode == "cigar" else [])],
                cwd=ROOT, capture_output=True, text=True, timeout=300,
                env={**os.environ, "PYTHONPATH": str(ROOT)})
            if proc.returncode:
                raise RuntimeError(f"CLI ({mode}) exit {proc.returncode}:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            rows = [ln.split("\t") for ln in sam.read_text().splitlines()
                    if not ln.startswith("@")]
            mapped = [r for r in rows if not int(r[1]) & 0x4]
            stars = sum(r[5] == "*" for r in mapped)
            if len(rows) != 40 or len(mapped) < 30 or (mode == "cigar"
                                                        and stars):
                raise AssertionError(f"CLI ({mode}): {len(rows)} records, "
                                     f"{len(mapped)} mapped, {stars} mapped "
                                     f"with a '*' CIGAR")
            held.append(f"{mode}: {len(rows)} records, {len(mapped)} mapped,"
                        f" {stars} '*' CIGARs among them, "
                        f"{time.perf_counter() - t0:.2f} s")
    return "; ".join(held)


# the step phase: the engine fixture's eight 512 x 12 regions of 151 bp
# reads against 420 bp haps in one tile (testing.step_inputs), SW of the
# reads against a replicated 420 bp window, 4,096 keys
STEP_READS, STEP_HAPS, STEP_READ_LEN, STEP_HAP_LEN = 4096, 12, 151, 420
STEP_CHUNK = 1024          # the scale-out's chunks: 4 of the step's reads


def _step_bound(reads, haps, ref, outs) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, operations ms, bytes ms) of one step at
    these inputs: PairHMM cells at FLOPS_PER_CELL float32 flops and SW
    cells at SW_SCORE_OPS_PER_CELL int32 ops, over their peaks, against
    each input read once and each output written once."""
    n_r, n_h = len(reads["rslen"]), len(haps["haplen"])
    ph_cells = n_r * n_h * STEP_READ_LEN * STEP_HAP_LEN
    sw_cells = n_r * int(ref["tlen"][0]) * STEP_READ_LEN
    ops_ms = (ph_cells * FLOPS_PER_CELL / PEAK["f32"]
              + sw_cells * SW_SCORE_OPS_PER_CELL / PEAK["int32"]) * 1e3
    n_bytes = (sum(a.nbytes for d in (reads, haps, ref) for a in d.values())
               + sum(t.numel() * t.element_size() for t in outs.values()))
    bytes_ms = n_bytes / PEAK["bytes"] * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms
            else "bytes", ops_ms, bytes_ms)


def run_step(drive) -> dict:
    """Phase 9a: ``parallel/pipeline.pipeline_step`` at a real size on a
    one-rank NCCL mesh (``init_runtime`` over a localhost TCP address;
    NCCL refuses two ranks on one card, so the bitonic exchanges and the
    hp reduction do not run here: the CPU tests hold them under gloo).

    Checks every output bit for bit against the same step on a 1 x 1 cpu
    mesh (the kernels' plain versions), and the two kernels at the step's
    shapes against their plain versions on the card.  Measures the warm
    step (host clock, 5 runs), both kernels (device time), the plain
    versions on the card, the bound and the idle share of a warm step."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mgl_tpu_torch.kernels.pairhmm_cuda import pairhmm_banded_f32
    from mgl_tpu_torch.kernels.sw_cuda import sw_banded, sw_banded_plain
    from mgl_tpu_torch.ops.pairhmm import forward_plain
    from mgl_tpu_torch.parallel.dryrun import free_port
    from mgl_tpu_torch.parallel.launcher import init_runtime
    from mgl_tpu_torch.parallel.mesh import make_mesh
    from mgl_tpu_torch.parallel.pipeline import (likelihood_planes,
                                                 pipeline_step)
    from mgl_tpu_torch.profile_e2e import _tally
    from mgl_tpu_torch.tables import BASE_ENC
    from mgl_tpu_torch.testing import (cuda_ms, queued_ms, step_inputs,
                                       timed_calls)

    reads, haps, ref = step_inputs(0, STEP_READS, STEP_HAPS, STEP_READ_LEN,
                                   STEP_HAP_LEN)
    # the same step on the CPU first, in a process with no process group
    t0 = time.perf_counter()
    cpu = pipeline_step(make_mesh(1, 1, device="cpu"))(reads, haps, ref)
    t_cpu = time.perf_counter() - t0

    init_runtime(f"tcp://127.0.0.1:{free_port()}", 1, 0, "cuda")
    mesh = make_mesh(1, 1)
    if dist.get_backend() != "nccl" or mesh.device.type != "cuda":
        raise AssertionError(f"the step's mesh is {dist.get_backend()} on "
                             f"{mesh.device}, not NCCL on the card")
    step = pipeline_step(mesh)

    def main_path():
        out = step(reads, haps, ref)
        torch.cuda.synchronize()
        return out

    out, launches, t_cold = drive(main_path)
    for k, v in cpu.items():
        if not torch.equal(out[k].cpu(), v):
            raise AssertionError(f"the step's {k} on the card != on the CPU")
    lik = out["likelihoods"].cpu().numpy()
    if lik.shape != (STEP_READS, STEP_HAPS) or not np.isfinite(lik).all():
        raise AssertionError("step likelihoods: shape or values")
    keys = (out["sorted_key_hi"] << 32 | out["sorted_key_lo"]).cpu().numpy()
    if not (np.diff(keys) >= 0).all():
        raise AssertionError("step keys not in order")
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        main_path()
        warm.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        main_path()
        wall = time.perf_counter() - t0
    busy = _tally(prof)[2]
    idle = None if busy is None else 1.0 - busy / 1e6 / wall

    # the two kernels at the step's shapes, each against its plain version
    # on the card, on the arguments the step gives them
    dev = mesh.device
    enc = torch.from_numpy(BASE_ENC.copy()).to(dev)
    to = lambda a, dt: torch.from_numpy(
        np.ascontiguousarray(a)).to(dev, dt)
    rslen = to(reads["rslen"], torch.int32)
    planes, rc = likelihood_planes(to(reads["rchar"], torch.int32), rslen,
                                   to(reads["trans"], torch.float32), enc)
    pair = torch.arange(STEP_READS * STEP_HAPS, device=dev)
    ph_args = (planes, rc, rslen, enc[to(haps["hap"], torch.long)],
               to(haps["haplen"], torch.int32),
               to(haps["y_init"], torch.float32), pair // STEP_HAPS,
               pair % STEP_HAPS)
    ph_ms = queued_ms(lambda: pairhmm_banded_f32(*ph_args), 5)
    ph_plain, ph_plain_ms = timed_calls(lambda: forward_plain(*ph_args))
    if not torch.equal(pairhmm_banded_f32(*ph_args), ph_plain):
        raise AssertionError("pairhmm_banded_f32 != plain at the step")
    sw_args = (to(ref["target"], torch.uint8).expand(STEP_READS, -1)
               .contiguous(), to(reads["query"], torch.uint8),
               to(np.repeat(ref["tlen"], STEP_READS), torch.int32),
               to(reads["qlen"], torch.int32), *SW_PARAMS)
    kw = dict(indel_init=False, with_traceback=False)
    sw_ms = cuda_ms(lambda: sw_banded(*sw_args, **kw), 5)
    (sw_plain, _), sw_plain_ms = timed_calls(
        lambda: sw_banded_plain(*sw_args, **kw))
    if not torch.equal(sw_banded(*sw_args, **kw)[0], sw_plain):
        raise AssertionError("sw_banded != plain at the step")
    b_ms, b_by, ops_ms, bytes_ms = _step_bound(reads, haps, ref, out)
    return {"launches": launches, "t_cold": t_cold, "t_cpu": t_cpu,
            "warm": warm, "idle": idle, "busy_ms": None if busy is None
            else busy / 1e3, "wall": wall, "ph_ms": ph_ms,
            "ph_plain_ms": ph_plain_ms, "sw_ms": sw_ms,
            "sw_plain_ms": sw_plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "ops_ms": ops_ms, "bytes_ms": bytes_ms, "mesh": mesh,
            "n_neg_sw": int((out["sw_scores"] < 0).sum())}


def _spawn_workers(role: str, address, workload, out_dir, hb_ttl,
                   procs: list) -> tuple:
    """Start a victim worker wedged on chunk 0, wait until it holds its
    lease, start a survivor, kill the victim by SIGKILL.  Returns (victim,
    survivor); both are in ``procs``."""
    import os
    import signal

    from mgl_tpu_torch.parallel.transport import CoordinatorClient

    host, port = address

    def spawn(name, *more):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mgl_tpu_torch.parallel.launcher", role,
             host, str(port), name, str(workload), str(out_dir), "--device",
             "cuda", "--heartbeat-ttl", str(hb_ttl), *more],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT),
                           "MGL_TPU_LOG": "launcher=info"},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        return procs[-1]

    victim = spawn("victim", "--hang-chunk", "0")
    c = CoordinatorClient(address)
    deadline = time.monotonic() + 300
    while c.stats()["leased"] < 1:
        if time.monotonic() > deadline or victim.poll() is not None:
            raise AssertionError(f"the {role} victim never leased a chunk: "
                                 f"{victim.poll()}")
        time.sleep(0.05)
    c.close()
    survivor = spawn("survivor")
    time.sleep(0.5)
    victim.send_signal(signal.SIGKILL)
    victim.wait(timeout=30)
    return victim, survivor


def _end_workers(procs: list, server) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.communicate(timeout=30)
    server.stop()


def run_step_scaleout(tmp: pathlib.Path, mesh) -> dict:
    """Phase 9b: the elastic pipeline scale-out on the card: a
    ``make_workload`` of the step's shapes (4,096 reads of 151 bp, 12 haps
    of 420 bp) in 4 chunks of 1,024, two ``worker --device cuda``
    processes, one wedged on chunk 0 and killed by SIGKILL; the assembled
    output must equal a single-process ``ChunkRunner`` on ``mesh`` over
    the same chunks bit for bit."""
    import numpy as np

    from mgl_tpu_torch.parallel.launcher import (ChunkRunner, assemble_output,
                                                 finish, load_workload,
                                                 make_chunks, make_workload,
                                                 run_scaleout)
    from mgl_tpu_torch.pipelines.checkpoint import CheckpointedRun

    workload = tmp / "step.npz"
    make_workload(workload, n_reads=STEP_READS, n_haps=STEP_HAPS,
                  read_len=STEP_READ_LEN, hap_len=STEP_HAP_LEN, seed=1)
    reads, haps, ref = load_workload(workload)
    t0 = time.perf_counter()
    runner = ChunkRunner(mesh, haps, ref)
    chunks = make_chunks(STEP_READS, STEP_CHUNK)
    run = CheckpointedRun(tmp / "step_base", len(chunks), tag="scaleout")
    for ch in chunks:
        run.save_chunk(ch["chunk"], runner.run(reads, ch["lo"], ch["hi"]))
    base = assemble_output(run)
    t_base = time.perf_counter() - t0

    server, run, _ = run_scaleout(str(workload), str(tmp / "step_dist"),
                                  STEP_CHUNK, lease_ttl=4.0,
                                  heartbeat_ttl=2.0)
    procs: list = []
    t0 = time.perf_counter()
    try:
        _, survivor = _spawn_workers("worker", server.address, workload,
                                     tmp / "step_dist", 2.0, procs)
        out = finish(server, run, timeout=300)
        _, err = survivor.communicate(timeout=120)
        if survivor.returncode != 0:
            raise AssertionError(f"the survivor failed: {err[-2000:]}")
        stats = server.coord.stats()
    finally:
        _end_workers(procs, server)
    t_dist = time.perf_counter() - t0
    if "victim" not in stats["dead_workers"]:
        raise AssertionError(f"the victim was not reaped: {stats}")
    for k in ("likelihoods", "best_hap_lik", "sw_scores", "sorted_keys"):
        if not np.array_equal(out[k], base[k]):
            raise AssertionError(f"scale-out {k} != the single process's")
    return {"t_base": t_base, "t_dist": t_dist, "stats": stats}


def run_map_scaleout(tmp: pathlib.Path, mapper: dict) -> dict:
    """Phase 9c: the elastic map scale-out at config 4's shape (BASELINE
    config 4, data-parallel across hosts): phase 7b's 64 Mbp reference and
    262,144 reads through ``save_map_workload``, 2 chunks of 131,072, two
    ``map-worker --device cuda`` processes, one wedged on chunk 0 and
    killed by SIGKILL; every ``MAP_OUT_KEYS`` array must equal phase 7b's
    single-process ``map_reads_stream(chunk=131072)``.  Returns the
    workers' index build and map times from their logs."""
    import numpy as np

    from mgl_tpu_torch.parallel.launcher import (MAP_OUT_KEYS,
                                                 assemble_map_output, finish,
                                                 run_scaleout_map,
                                                 save_map_workload)

    workload = tmp / "map.npz"
    save_map_workload(workload, mapper["index"].ref, mapper["reads"])
    server, run, _ = run_scaleout_map(str(workload), str(tmp / "map_dist"),
                                      MAP_CHUNK, lease_ttl=6.0,
                                      heartbeat_ttl=3.0)
    procs: list = []
    t0 = time.perf_counter()
    try:
        victim, survivor = _spawn_workers("map-worker", server.address,
                                          workload, tmp / "map_dist", 3.0,
                                          procs)
        out = finish(server, run, timeout=600, assemble=assemble_map_output)
        _, err = survivor.communicate(timeout=120)
        if survivor.returncode != 0:
            raise AssertionError(f"the survivor failed: {err[-2000:]}")
        v_err = victim.communicate(timeout=30)[1]
        stats = server.coord.stats()
    finally:
        _end_workers(procs, server)
    t_dist = time.perf_counter() - t0
    if "victim" not in stats["dead_workers"]:
        raise AssertionError(f"the victim was not reaped: {stats}")
    for k in MAP_OUT_KEYS:
        if not np.array_equal(out[k], mapper["out"][k]):
            raise AssertionError(f"map scale-out {k} != phase 7b's")
    times = [re.sub(r"^\S+ \S+ INFO \S+: ", "", line) for line in
             (v_err + err).splitlines()
             if "built the index" in line or "mapped chunk" in line]
    return {"t_dist": t_dist, "times": times, "stats": stats}


# phase 10, the size range: the JAX package's long shapes through both GATK
# entry points, and the mapper on GRCh38's coordinate space
SIZE_SW_SAMPLE = 8         # pairs of the 8000x2000 batch held to the plain path
GENOME_READS = 131_072     # reads on GRCh38's coordinate space, one chunk
GENOME_CHECK = 1024        # SAM records checked against the truth


def sw_call_split(targets, queries, strategy, dev) -> dict:
    """One bucket through ``align_batch_banded``'s steps, timed on the host
    clock with a sync after each: staging (packing and H2D), the banded
    kernel, the D2H of ez and the traceback words, the host decoder; with
    the bytes copied back and the (cigar, offset) results."""
    import numpy as np
    import torch

    from mgl_tpu_torch.core.params import OverhangStrategy
    from mgl_tpu_torch.kernels import sw_cuda
    from mgl_tpu_torch.ops.sw import banded_layout
    from mgl_tpu_torch.testing import sw_tensors

    indel = bool(strategy & (OverhangStrategy.INDEL
                             | OverhangStrategy.LEADING_INDEL))
    t = [time.perf_counter()]
    args = sw_tensors(targets, queries, dev)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    ez, words = sw_cuda.sw_banded(*args, *SW_PARAMS, indel_init=indel)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    ez_h, words_h = ez.cpu().numpy(), words.cpu().numpy()
    t.append(time.perf_counter())
    tlen = np.array([len(x) for x in targets], np.int32)
    qlen = np.array([len(x) for x in queries], np.int32)
    res = sw_cuda.decode_cigars(ez_h, words_h, tlen, qlen, strategy,
                                banded_layout(args[0].shape[1],
                                              args[1].shape[1])[1])
    t.append(time.perf_counter())
    return {"stage_s": t[1] - t[0], "kernel_s": t[2] - t[1],
            "d2h_s": t[3] - t[2], "decode_s": t[4] - t[3],
            "d2h_bytes": ez_h.nbytes + words_h.nbytes, "res": res}


def run_size_sw(dev, drive, card) -> tuple[dict, list]:
    """Phase 10, SW, on the card: the JAX package's long pairs (20 kbp x 5
    kbp and 12 kbp x 6.5 kbp, ``testing.LONG_SW_PAIRS``) and a batch of 64
    pairs of up to 8,000 x 2,000 (48 of them in one bucket) through
    ``SmithWatermanAligner(device=cuda).align_batch`` in all four
    strategies, each shape's peak device memory, and one SOFTCLIP call of
    its largest bucket split into staging, kernel, D2H (bytes) and host
    decode.  Returns (the launches, what :func:`check_size_sw` holds to
    the plain path)."""
    import torch

    from mgl_tpu_torch.api import (OverhangStrategy, SmithWatermanAligner,
                                   SWParameters)
    from mgl_tpu_torch.batch.bucketing import bucket_pairs
    from mgl_tpu_torch.testing import LONG_SW_SHAPES, long_sw_shape

    params = SWParameters(*SW_PARAMS)
    aligner = SmithWatermanAligner(device=dev)
    total, runs = {}, []
    for name in LONG_SW_SHAPES:
        targets, queries = long_sw_shape(name)
        torch.cuda.reset_peak_memory_stats(dev)
        res, n, t_all = drive(lambda: {
            s: aligner.align_batch(targets, queries, params, s)
            for s in OverhangStrategy})
        peak = torch.cuda.max_memory_allocated(dev)
        if n["sw_banded"] < 1:
            raise AssertionError(f"size range SW {name}: sw_banded never "
                                 f"launched: {n}")
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        buckets = bucket_pairs([len(x) for x in targets],
                               [len(x) for x in queries])
        (pt, pq), idx = max(buckets, key=lambda b: len(b[1]))
        split = sw_call_split([targets[i] for i in idx],
                              [queries[i] for i in idx],
                              OverhangStrategy.SOFTCLIP, dev)
        if split["res"] != [(res[OverhangStrategy.SOFTCLIP][i].cigar,
                             res[OverhangStrategy.SOFTCLIP][i].offset)
                            for i in idx]:
            raise AssertionError(f"size range SW {name}: the timed bucket "
                                 f"differs from align_batch")
        call = sum(split[k] for k in ("stage_s", "kernel_s", "d2h_s",
                                      "decode_s"))
        runs.append((name, res, len(targets)))
        log(f"[10 size range, SW] {name}: {len(targets)} pairs in "
            f"{len(buckets)} buckets (largest {len(idx)} x {pt}x{pq}), "
            f"align_batch in all four strategies {t_all:.3f} s, launches "
            f"{ {k: v for k, v in n.items() if v} }; peak device memory "
            f"{peak / 2**20:.1f} MiB; one SOFTCLIP call of the largest "
            f"bucket {call * 1e3:.1f} ms: staging "
            f"{split['stage_s'] * 1e3:.2f} ms, kernel "
            f"{split['kernel_s'] * 1e3:.2f} ms, D2H of {split['d2h_bytes']} "
            f"B {split['d2h_s'] * 1e3:.2f} ms, host decode "
            f"{split['decode_s'] * 1e3:.2f} ms; card {card}")
    return total, runs


def check_size_sw(runs, plain_refs) -> None:
    """Phase 10, SW, the check: each shape's CIGARs and offsets from
    :func:`run_size_sw` equal the plain path's on the card in all four
    strategies - every pair of the long pairs, 8 sampled pairs of the
    batch (``testing.sw_plain_cigars``, whose results ``plain_refs(name)``
    yields: a spawned process computes them on the card meanwhile)."""
    from mgl_tpu_torch.api import OverhangStrategy
    from mgl_tpu_torch.testing import long_sw_sample

    for name, res, n_pairs in runs:
        want, t_plain = plain_refs(name)
        pick = long_sw_sample(n_pairs)
        for s in OverhangStrategy:
            got = [(res[s][i].cigar, res[s][i].offset) for i in pick]
            if got != want[int(s)]:
                bad = [k for k, (a, b) in enumerate(zip(got, want[int(s)]))
                       if a != b]
                raise AssertionError(
                    f"size range SW {name} {s.name}: {len(bad)} of "
                    f"{len(got)} pairs differ from the plain path, e.g. "
                    f"{got[bad[0]][0][:80]} / {want[int(s)][bad[0]][0][:80]}")
        log(f"    SW {name}: CIGARs and offsets of {len(pick)} pairs in all "
            f"four strategies equal to the plain path's on the card "
            f"({t_plain:.2f} s in a spawned process)")


def run_size_pairhmm(dev, drive, card, cpu_refs) -> dict:
    """Phase 10, PairHMM: the long sets of ``testing.LONG_PAIRHMM_SETS``
    (three 250 bp reads against a 5.6 kbp and a 16 kbp hap, 4 reads of 4 kb
    against 3 haps of 6 kb) through ``PairHmmEngine(device=cuda)`` in the
    default mode, ``use_double`` and ``fast_path``.  On ``long_hap`` the
    default and ``use_double`` within 1e-5 log10 of the port's scalar
    oracle; every other (set, mode) bit-equal to ``device="cpu"``, whose
    matrices ``cpu_refs`` yields (computed in worker processes while the
    card runs).  Logs each run's wall time, peak device memory, the
    shared-or-product choice and the rescued pairs.  Returns the
    launches."""
    import numpy as np
    import torch

    from mgl_tpu_torch.api import PairHmmEngine
    from mgl_tpu_torch.ops.pairhmm import normalize, use_shared_kernel
    from mgl_tpu_torch.ref_impl import pairhmm_scalar
    from mgl_tpu_torch.testing import ENGINE_MODES, long_pairhmm
    from mgl_tpu_torch.utils.metrics import METRICS

    total = {}
    for name in ("long_hap", "longer_hap", "long_read"):
        reads, haps = long_pairhmm(name)
        shared = use_shared_kernel([len(r["bases"]) for r in reads],
                                   normalize(reads, haps)[1])
        txt = []
        for mode, kw in ENGINE_MODES.items():
            METRICS.reset()
            torch.cuda.reset_peak_memory_stats(dev)
            got, n, t = drive(lambda: PairHmmEngine(
                device=dev, **kw).compute_likelihoods(reads, haps))
            peak = torch.cuda.max_memory_allocated(dev)
            if not sum(n.values()):
                raise AssertionError(f"size range {name} {mode}: no kernel "
                                     f"launched")
            for k, v in n.items():
                total[k] = total.get(k, 0) + v
            if not np.isfinite(got).all():
                raise AssertionError(f"size range {name} {mode}: not finite")
            if name == "long_hap" and mode != "fast_path":
                t0 = time.perf_counter()
                want = pairhmm_scalar.compute_likelihoods(reads, haps)
                err = float(np.abs(got - want).max())
                if err >= 1e-5:
                    raise AssertionError(f"size range {name} {mode}: "
                                         f"{err} log10 from the scalar oracle")
                check = (f"max |log10 - scalar| {err:.3g} (oracle "
                         f"{time.perf_counter() - t0:.1f} s)")
            else:
                want = cpu_refs(name, mode)
                if not np.array_equal(got, want):
                    raise AssertionError(
                        f"size range {name} {mode}: card != device='cpu' "
                        f"(max diff {np.abs(got - want).max()})")
                check = "bit-equal to device='cpu'"
            rescued = int(METRICS.snapshot()["timers_s"].get(
                "engine.rescue", 0) > 0)
            txt.append(f"{mode} {t:.3f} s, launches "
                       f"{ {k: v for k, v in n.items() if v} }, peak "
                       f"{peak / 2**20:.1f} MiB, rescue tier "
                       f"{'ran' if rescued else 'not run'}, {check}")
        r_len = sorted({len(r["bases"]) for r in reads})
        log(f"[10 size range, PairHMM] {name}: {len(reads)} reads of "
            f"{r_len} bp x {len(haps)} haps of "
            f"{sorted({len(h) for h in haps})} bp, the estimate picks "
            f"{'shared' if shared else 'product'} mode; "
            f"{'; '.join(txt)}; card {card}")
    return total


def size_genome(dev) -> dict:
    """Phase 10's mapper workload (see :func:`run_size_mapper`): GRCh38's
    coordinate space with one 4 Mbp segment a contig, its reads, the index
    by ``build_multi`` and the word-packed reference on ``dev``, with the
    times each took."""
    from mgl_tpu_torch.pipelines import mapper as mp
    from mgl_tpu_torch.testing import genome_coords_reference, genome_reads

    t0 = time.perf_counter()
    contigs, seg = genome_coords_reference(0)
    g = genome_reads(1, contigs, seg, GENOME_READS)
    t_sim = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = mp.ReferenceIndex.build_multi(contigs, k=16)
    t_index = time.perf_counter() - t0
    del contigs
    t0 = time.perf_counter()
    mp._ref_device(index, dev)
    return {"index": index, "g": g, "t_sim": t_sim, "t_index": t_index,
            "t_ref": time.perf_counter() - t0}


def run_size_mapper(dev, drive, card, tmp, genome) -> dict:
    """Phase 10, the mapper on GRCh38's coordinate space: the 24 primary
    contigs' lengths (``testing.GRCH38_CONTIGS``, 3,088,269,832 bases, chr13
    across 2^31 and chr14-chrY past it), each 'N' but for one 4 Mbp
    segment of simulated sequence, indexed by ``build_multi``; 131,072
    reads of 150 bp drawn evenly over the segments on both strands at 1%
    substitutions, 2% with a 1-2 bp deletion after base 70.  Runs phase
    7b's checks (:func:`run_mapper`: score mode and ``align_and_sort``,
    the true start in the window for 0.99 of reads, sampled scores against
    the plain path, the sort against NumPy) and 7c's
    (:func:`run_cigar_mapper`: the traceback tier against the plain path
    and the host decoder), plus: the true contig and start in the window
    for 0.99 of the reads past 2^31, and ``io/sam.write_sam``'s RNAME and
    POS equal to the truth for 1,024 sampled reads whose window holds the
    truth and whose first 12 bases match it (where an optimal alignment
    starts at the true start).  ``genome`` is :func:`size_genome`'s.  Logs
    the index build, the packed reference's upload, the host's peak RSS
    and reads/s.  Returns the launches."""
    import resource

    import numpy as np

    from mgl_tpu_torch.io.sam import write_sam
    from mgl_tpu_torch.pipelines import mapper as mp
    from mgl_tpu_torch.testing import GRCH38_CONTIGS

    index, g = genome["index"], genome["g"]
    n_ref = len(index.ref)
    words, blocked = mp._ref_device(index, dev)
    layout = "blocked" if blocked else "flat"
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    names = [n for n, _ in GRCH38_CONTIGS]
    log(f"[10 size range, mapper] GRCh38's coordinate space: "
        f"{len(names)} contigs, {n_ref} positions with the separators, one "
        f"4 Mbp segment a contig (simulated with {len(g['reads'])} reads in "
        f"{genome['t_sim']:.2f} s); build_multi index (k = 16, "
        f"{len(index.sorted_kmers)} k-mers) {genome['t_index']:.2f} s; the "
        f"word-packed reference on the card ({layout}, "
        f"{words.numel() * 4} B) {genome['t_ref']:.2f} s (both in "
        f"a thread beside the SW and PairHMM shapes); host peak RSS so far "
        f"{rss:.2f} GiB")
    reads, start = g["reads"], g["start"]
    m = run_mapper(dev, drive, workload=(index, reads, start))
    past = start >= 2**31
    if not past.any():
        raise AssertionError("GRCh38 mapper: no read lies past 2^31")
    out, pad = m["out"], m["out"]["window_pad"]
    cid, _ = index.locate(out["pos"])
    inside = m["inside"] & (cid == g["contig"])
    acc_past = float(inside[past].mean())
    if acc_past < 0.99 or float(inside.mean()) < 0.99:
        raise AssertionError(f"GRCh38 mapper: the true contig and start in "
                             f"the window for {inside.mean():.4f} of reads, "
                             f"{acc_past:.4f} of those past 2^31 (< 0.99)")
    srt = m["srt"]
    n_reads = len(reads)
    log(f"    score mode + align_and_sort cold {m['t_cold']:.3f} s, launches "
        f"{m['launches']}; {int(past.sum())} reads past 2^31; true contig "
        f"and start in the window {inside.mean():.4f}, past 2^31 "
        f"{acc_past:.4f} (gate 0.99); {m['n_checked']} sampled scores equal "
        f"to the plain path; align_and_sort keys equal a stable NumPy "
        f"argsort ({int((srt['contig'] >= 12).sum())} keys on chr13-chrY); "
        f"warm {n_reads / m['t_warm']:.1f} reads/s; card {card}")
    c = run_cigar_mapper(dev, drive, index,
                         workload=(reads, g["del_idx"], start))
    sam = tmp / "grch38.sam"
    t0 = time.perf_counter()
    write_sam(sam, index, reads, c["out"])
    t_sam = time.perf_counter() - t0
    cig_inside = ((c["out"]["pos"] >= 0) & (start >= c["out"]["pos"])
                  & (start <= c["out"]["pos"] + c["wlen"] - reads.shape[1]))
    pool = np.nonzero(cig_inside & g["clean_head"])[0]
    pick = set(np.random.default_rng(5).choice(
        pool, min(GENOME_CHECK, len(pool)), replace=False).tolist())
    checked = past_checked = 0
    with open(sam) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.split("\t", 4)
            i = int(fields[0][4:])
            if i not in pick:
                continue
            want = (names[g["contig"][i]], str(int(g["local"][i]) + 1))
            if (fields[2], fields[3]) != want:
                raise AssertionError(f"GRCh38 SAM: read {i} at "
                                     f"{fields[2]}:{fields[3]}, truth "
                                     f"{want[0]}:{want[1]}")
            checked += 1
            past_checked += bool(past[i])
    if checked != len(pick):
        raise AssertionError(f"GRCh38 SAM: {checked} of {len(pick)} sampled "
                             f"records written")
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    n_total = {}
    for k in m["launches"]:
        n_total[k] = m["launches"][k] + c["launches"][k]
    log(f"    CIGAR mode cold {c['t_cold']:.3f} s, launches "
        f"{c['launches']}; every mapped read has a CIGAR, and every "
        f"deletion read whose window holds its start a D "
        f"({c['n_del_off']} deletion reads seeded elsewhere); traceback "
        f"tier {len(c['tier'])} reads equal to the plain path and "
        f"{c['n_check']} sampled to the host decoder; warm "
        f"{n_reads / c['t_warm']:.1f} reads/s; write_sam {t_sam:.2f} s, "
        f"{checked} sampled records' RNAME and POS equal to the truth "
        f"({past_checked} past 2^31); host peak RSS {rss:.2f} GiB; card "
        f"{card}")
    return n_total


def run_size_range(dev, drive, card) -> dict:
    """Phase 10: the size range (:func:`run_size_sw` and
    :func:`check_size_sw`, :func:`run_size_pairhmm`,
    :func:`run_size_mapper`).  What the card's results are held to runs
    beside them: the SW plain path on the card in one spawned process, the
    engine's ``device="cpu"`` references in two more, and, once the SW
    shapes are done, the mapper's genome, index and packed reference in a
    thread.  Returns the launches of every main-path run."""
    import concurrent.futures
    import multiprocessing
    import tempfile

    from mgl_tpu_torch.testing import (ENGINE_MODES, LONG_SW_SHAPES,
                                       engine_on_cpu, sw_plain_cigars)

    spawn = multiprocessing.get_context("spawn")
    jobs = [(n, m) for n in ("long_hap", "longer_hap", "long_read")
            for m in ENGINE_MODES if n != "long_hap" or m == "fast_path"]
    sw_pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn)
    cpu_pool = concurrent.futures.ProcessPoolExecutor(2, mp_context=spawn)
    genome_pool = concurrent.futures.ThreadPoolExecutor(1)
    pools = (sw_pool, cpu_pool, genome_pool)
    try:
        sw_refs = {n: sw_pool.submit(sw_plain_cigars, n)
                   for n in LONG_SW_SHAPES}
        cpu_refs = {job: cpu_pool.submit(engine_on_cpu, *job)
                    for job in jobs}
        sw_n, sw_runs = run_size_sw(dev, drive, card)
        # after the SW shapes, so that their peak device memory is theirs
        genome = genome_pool.submit(size_genome, dev)
        parts = [sw_n, run_size_pairhmm(
            dev, drive, card, lambda n, m: cpu_refs[(n, m)].result())]
        check_size_sw(sw_runs, lambda n: sw_refs[n].result())
        genome = genome.result()
    finally:
        for p in pools:
            p.shutdown(wait=True, cancel_futures=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp_dir:
        parts.append(run_size_mapper(dev, drive, card,
                                     pathlib.Path(tmp_dir), genome))
    total = {}
    for part in parts:
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    return total


# phase 11, the scale runs: mgl_tpu_torch.scale_configs in three processes
# of their own, so that each entry's max_rss_gb is its own; the fields of
# the JAX package's record (tests/golden/scale_report.json) that depend only
# on the seeded data and the mapper's logic, which the port must repeat
SCALE_RUNS = {"configs 4 + 5": (), "CIGAR": ("--cigar", "--cigar-mode", "all"),
              "mesh": ("--mesh-only",)}
SCALE_TIMEOUT_S = 700
SCALE_RECORD_FIELDS = {
    "config4_seed_extend_1m": ("mapped_frac", "window_accuracy"),
    "config4_cigar": ("indel_reads", "indel_cigars_with_gap",
                      "traceback_tier_reads", "traceback_tier_share"),
    "config4_cigar_1m": ("indel_reads", "indel_cigars_with_gap",
                         "traceback_tier_reads"),
    "config4_cigar_hierr": ("mapped_frac", "indel_reads",
                            "indel_cigars_with_gap", "traceback_tier_reads",
                            "traceback_tier_share"),
}


def scale_process(flags: tuple, out: str) -> tuple[int, str, float]:
    """(exit code, the end of stderr, seconds) of one ``python -m
    mgl_tpu_torch.scale_configs --out out *flags`` process."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mgl_tpu_torch.scale_configs", "--out", out,
         *flags], cwd=ROOT, capture_output=True, text=True,
        timeout=SCALE_TIMEOUT_S)
    return proc.returncode, proc.stderr[-3000:], time.perf_counter() - t0


def run_scale(launcher) -> dict:
    """Phase 11: ``python -m mgl_tpu_torch.scale_configs`` as a user runs
    it, one process each for configs 4 and 5 (1,048,576 reads on 64 Mbp,
    3 passes; the sorts of those reads' keys and of 10M keys on the card),
    the three CIGAR configs, and the 10M-key sort on 8 gloo ranks, each
    started by :func:`scale_process` in ``launcher``, a one-process pool
    made while this process was small: a process forked from this one
    would start from its peak RSS (phase 10's), not its own.  Checks
    the merged report: window accuracy at least 0.99, every mapped read
    with a CIGAR, both sorts and the mesh sort verified (scale_configs raises
    otherwise), a launch of each kernel, and the record's data-dependent
    fields.  Returns the report, each process's seconds and the launches
    of the timed passes, summed."""
    import tempfile

    record = json.loads((ROOT / "tests/golden/scale_report.json").read_text())
    secs = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        out = pathlib.Path(tmp) / "scale_report.json"
        for name, flags in SCALE_RUNS.items():
            code, err, secs[name] = launcher.submit(
                scale_process, flags, str(out)).result()
            if code != 0:
                raise AssertionError(f"scale_configs {' '.join(flags)} exit "
                                     f"{code}: {err}")
        rep = json.loads(out.read_text())
    c4 = rep["config4_seed_extend_1m"]
    if c4["window_accuracy"] < 0.99:
        raise AssertionError(f"config 4 window accuracy {c4}")
    cig = [rep[n] for n in ("config4_cigar", "config4_cigar_1m",
                            "config4_cigar_hierr")]
    if not all(c["cigar_complete"] for c in cig):
        raise AssertionError("a CIGAR config left a mapped read without one")
    if not rep["config5_mesh_sort"]["mesh_sort_verified"]:
        raise AssertionError("the mesh sort was not verified")
    if rep["config5_align_sort"]["sort_keys"] != 10_000_000:
        raise AssertionError("config 5 did not sort 10M keys")
    diff = [f"{n}.{k}: {rep[n][k]} (record {record[n][k]})"
            for n, keys in SCALE_RECORD_FIELDS.items() for k in keys
            if rep[n][k] != record[n][k]]
    if diff:
        raise AssertionError(f"scale fields differ from the JAX package's "
                             f"record: {diff}")
    launches = {}
    for entry in [c4, *cig]:
        for k, v in entry["launches"].items():
            launches[k] = launches.get(k, 0) + v
    if min(c4["launches"]["sw_banded"], c4["launches"]["window_gather"],
           *(c["launches"]["cigar_walk"] for c in cig)) < 1:
        raise AssertionError(f"a kernel of the scale runs never launched: "
                             f"{[e['launches'] for e in [c4, *cig]]}")
    return {"rep": rep, "secs": secs, "launches": launches}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from mgl_tpu_torch import _build
    from mgl_tpu_torch.api import (OverhangStrategy, PairHmmEngine,
                                   SmithWatermanAligner, SWParameters)
    from mgl_tpu_torch.batch.bucketing import bucket_pairs
    from mgl_tpu_torch.kernels import pairhmm_cuda as ph
    from mgl_tpu_torch.kernels import seed_extend_cuda as se
    from mgl_tpu_torch.kernels import sw_cuda
    from mgl_tpu_torch.kernels import cigar_walk_cuda as cw
    from mgl_tpu_torch.kernels import window_cuda as wg
    from mgl_tpu_torch.ops.seed_extend import fast_scores_plain, stage_fast
    from mgl_tpu_torch.pipelines import mapper as mp
    from mgl_tpu_torch.ops.sw import EZ_KEYS, banded_layout, compute_score_max
    from mgl_tpu_torch.ops.pairhmm import (compute_haplotype_similarities,
                                           normalize, pair_likelihoods,
                                           shared_forward_plain,
                                           use_shared_kernel)
    from mgl_tpu_torch.tables import CTX_F32, CTX_F64, MIN_ACCEPTED
    from mgl_tpu_torch.testing import (ACGT, cuda_ms, engine_region,
                                       golden_groups, golden_read,
                                       load_golden, long_hap_set,
                                       no_hit_region, pair_edge_set,
                                       plane_outputs,
                                       queued_ms, seed_extend_edge_set,
                                       seed_extend_order_set,
                                       shared_on_and_off, snp,
                                       sw_pairs,
                                       sw_tensors, timed_calls,
                                       traceback_mismatches, u8)

    kernels = {"sw_banded": sw_cuda.sw_banded,
               "pairhmm_banded_f32": ph.pairhmm_banded_f32,
               "pairhmm_banded_f64": ph.pairhmm_banded_f64,
               "pairhmm_shared_f32": ph.pairhmm_shared_f32,
               "sw_plane": sw_cuda.sw_plane,
               "sw_plane_scores": sw_cuda.sw_plane_scores,
               "pairhmm_plane_f32": ph.pairhmm_plane_f32,
               "seed_extend_f32": se.seed_extend_f32,
               "window_gather": wg.window_gather,
               "cigar_walk": cw.cigar_walk}

    def drive(fn):
        """(fn(), launches of each kernel during it, host seconds): the
        counts are set to 0 just before and read just after."""
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        out = fn()
        t = time.perf_counter() - t0
        return out, {n: k.launches for n, k in kernels.items()}, t

    # phase 11's launcher, started now, while this process is small
    import concurrent.futures
    import multiprocessing

    scale_launcher = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    scale_launcher.submit(int).result()

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # ---- phase 0: environment ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    t0 = time.perf_counter()
    if not sw_cuda.host_decoder_ready():
        raise RuntimeError("the port's host library did not load: the "
                           "aligner would have no CIGAR decoder")
    card = f"{smi} (nvidia-smi name, power.limit)"
    log(f"[0 env] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {nvcc[-1]}; the port's host library "
        f"{_build.host_library_path().name} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    log(smi)

    # ---- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[1 build] {_build.library_path().name} ready in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")

    # ---- phase 2: each kernel vs its plain version, bit for bit ----------
    err = dict.fromkeys(kernels, 0.0)
    targets, queries = sw_pairs(11, 1024, (40, 250), (40, 250))
    args = sw_tensors(targets, queries, dev)
    for strategy in OverhangStrategy:
        indel = bool(strategy & (OverhangStrategy.INDEL
                                 | OverhangStrategy.LEADING_INDEL))
        for tb in (True, False):
            e = compare_sw(args, indel, tb, (None, *sw_cuda.BANDED_WARPS))
            if e:
                raise AssertionError(f"SW kernel != plain ({strategy.name}, "
                                     f"traceback={tb}): {e}")
            err["sw_banded"] = max(err["sw_banded"], e)
        for mode in sw_cuda.PLANE_MODES:
            e = compare_sw_plane(args, indel, mode,
                                 (None, *sw_cuda.BANDED_WARPS))
            if e:
                raise AssertionError(f"SW plane kernel != plain "
                                     f"({strategy.name}, {mode}): {e}")
            name = "sw_plane_scores" if mode == "scores" else "sw_plane"
            err[name] = max(err[name], e)
    plane_placed = {m: {"shared" if sw_cuda.plane_carry_in_shared(
        len(targets), args[1].shape[1], w, k, dev) else "global"
        for w in sw_cuda.BANDED_WARPS}
        for k, m in enumerate(sw_cuda.PLANE_MODES)}
    # a bucket of 2,048 queries of 1-2 kb: with its carry row in shared
    # memory 12 blocks would fit an SM that gets 16, so the launcher keeps
    # the rows in global memory - that path against the plain version too
    long_q, short_t = sw_pairs(12, 2048, (1000, 2000), (1, 64))
    gargs = sw_tensors(short_t, long_q, dev)
    for tb in (True, False):
        if any(sw_cuda.banded_carry_in_shared(2048, gargs[1].shape[1], w, tb,
                                              dev) for w in (1, 2)):
            raise AssertionError("SW kernel: the 2,048 long queries did "
                                 "not take the global-memory carry")
        e = compare_sw(gargs, False, tb, (None, 1, 2))
        if e:
            raise AssertionError(f"SW kernel != plain (global-memory carry, "
                                 f"traceback={tb}): {e}")
    for k, mode in enumerate(sw_cuda.PLANE_MODES):
        if any(sw_cuda.plane_carry_in_shared(2048, gargs[1].shape[1], w, k,
                                             dev) for w in (1, 2)):
            raise AssertionError(f"SW plane kernel ({mode}): the 2,048 long "
                                 f"queries did not take the global-memory "
                                 f"carry")
        e = compare_sw_plane(gargs, False, mode, (None, 1, 2))
        if e:
            raise AssertionError(f"SW plane kernel != plain (global-memory "
                                 f"carry, {mode}): {e}")
    del gargs
    kat = load_golden("pairhmm_kat.json")
    kat_reads = [golden_read(c) for c in kat]
    kat_haps = [u8(c["hap"]) for c in kat]
    rng = np.random.default_rng(5)
    rnd_reads = []
    for _ in range(64):
        n = int(rng.integers(50, 160))
        q = rng.integers(10, 50, n).astype(np.uint8)
        rnd_reads.append(dict(bases=rng.choice(ACGT, n), q=q, i=q, d=q,
                              c=np.full(n, 10, np.uint8)))
    rnd_haps = [rng.choice(ACGT, int(rng.integers(100, 400)))
                for _ in range(16)]
    rnd_pairs = [(r, h) for r in range(64) for h in range(16)]
    # the random pairs go in as one ragged set: reads of 50-160 bases
    # against haps of 100-400 in one launch
    golden = load_golden("pairhmm_golden.jsonl")
    g_reads = [golden_read(r) for r in golden]
    g_haps = [u8(r["hap"]) for r in golden]
    gn_reads, gn_haps = normalize(g_reads, g_haps)
    diag = [(k, k) for k in range(len(golden))]
    # the per-pair kernels at every W the kernel takes, in f32 and f64, and
    # the plane kernel at every R and W: the KAT pairs, the random ragged
    # set and the golden rows (carry row in shared memory), then reads of
    # 1-700 bases against one hap of 16 kb (f64) or 30 kb (f32), whose row
    # cannot lie in shared memory
    pp_warps = (None, *range(1, ph.BANDED_WARPS_MAX + 1))
    pp_layouts = [{}] + [dict(warps_per_pair=w) for w in pp_warps[1:]]
    plane_layouts = [{}] + [dict(rows_per_lane=r, warps_per_pair=w)
                            for r in ph.PLANE_ROWS_PER_LANE
                            for w in pp_warps[1:]]
    pp_sets = [(kat_reads, kat_haps, [(k, k) for k in range(len(kat))]),
               (rnd_reads, rnd_haps, rnd_pairs),
               (g_reads, g_haps, diag)]
    pp_placed = []
    for ctx, name, long_len in ((CTX_F32, "pairhmm_banded_f32", 30_000),
                                (CTX_F64, "pairhmm_banded_f64", 16_000)):
        for k, (reads, haps, pairs) in enumerate(
                pp_sets + [pair_edge_set(6, (1, 33, 151, 700), (long_len,))]):
            staged = ph.stage_pairs(*normalize(reads, haps), pairs, ctx, dev)
            e = compare_pairhmm(staged, kernels[name], pp_layouts)
            if e:
                raise AssertionError(f"{name} kernel != plain (set {k}): {e}")
            err[name] = max(err[name], e)
            pp_placed.append((name, len(pairs), staged[3].shape[1], {
                "shared" if ph.banded_carry_in_shared(
                    len(pairs), staged[3].shape[1], w, staged[0].dtype, dev)
                else "global" for w in pp_warps[1:]}))
            if ctx is CTX_F32:
                e = compare_pairhmm(staged, ph.pairhmm_plane_f32,
                                    plane_layouts)
                if e:
                    raise AssertionError(f"pairhmm_plane_f32 kernel != plain "
                                         f"(set {k}): {e}")
                err["pairhmm_plane_f32"] = max(err["pairhmm_plane_f32"], e)
                pp_placed.append(("pairhmm_plane_f32", len(pairs),
                                  staged[3].shape[1], {
                    "shared" if ph.plane_carry_in_shared(
                        len(pairs), staged[3].shape[1], kw["warps_per_pair"],
                        kw["rows_per_lane"], dev)
                    else "global" for kw in plane_layouts[1:]}))
    for name in ("pairhmm_banded_f32", "pairhmm_banded_f64",
                 "pairhmm_plane_f32"):
        places = set().union(*(p for n, *_, p in pp_placed if n == name))
        if places != {"shared", "global"}:
            raise AssertionError(f"{name}: the carry row did not take both "
                                 f"placements: {pp_placed}")
    # shared-hap-set: 200 ragged reads against 10 haps with shared
    # prefixes, a duplicate right after its twin (a zero-length segment),
    # resets and a hap under 8 bases, with sharing on and off
    base = rng.choice(ACGT, 300)
    sh_haps = [base] + [snp(base, pos)
                        for pos in (200, 150, 220, 240, 100, 260)]
    sh_haps.insert(3, sh_haps[2].copy())
    sh_haps += [rng.choice(ACGT, 7), base[:250].copy()]
    sh_reads = []
    for k in range(200):
        n = int(rng.integers(50, 161))
        q = rng.integers(10, 50, n).astype(np.uint8)
        st = int(rng.integers(0, 300 - n))
        sh_reads.append(dict(bases=base[st:st + n].copy() if k % 4
                             else rng.choice(ACGT, n), q=q, i=q, d=q,
                             c=np.full(n, 10, np.uint8)))
    sh_reads, sh_haps = normalize(sh_reads, sh_haps)
    # every W the kernel takes, sharing on and off: 200 reads of <= 5 bands
    # (carry row in shared memory), then 300 reads of 60 bp against 24
    # haps of 1 kb with resets (a row of ~129 KB: global memory)
    sh_warps = (None, *range(1, ph.SHARED_WARPS_MAX + 1))
    lg_reads, lg_haps = normalize(*long_hap_set(5, read_len=60))
    placed = []
    for label, reads_, haps_, warps in (
            ("ragged", sh_reads, sh_haps, sh_warps),
            ("long hap set", lg_reads, lg_haps, (None, 1, 2))):
        outs = []
        for a in shared_on_and_off(reads_, haps_, dev):
            want = shared_forward_plain(*a)
            for w in warps:
                got = ph.pairhmm_shared_f32(*a, warps_per_read=w)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    e = float((got.double() - want.double()).abs().max())
                    raise AssertionError(f"shared kernel != plain ({label}, "
                                         f"W={w}): {e}")
            placed.append((label, len(reads_), a[3].shape[0], {
                "shared" if ph.shared_carry_in_shared(
                    len(reads_), a[3].shape[0], w, dev) else "global"
                for w in warps if w is not None}))
            outs.append(want)
        if not torch.equal(*outs):
            raise AssertionError(f"shared kernel ({label}): sharing on != "
                                 f"sharing off")
    if set().union(*(where for *_, where in placed)) != {"shared", "global"}:
        raise AssertionError(f"shared kernel: the carry row did not take "
                             f"both placements: {placed}")
    # the seed-extend kernel: the golden rows, one region's full product,
    # the edge pairs (haplen < rslen, haplen == rslen, a one-base read,
    # N in reads and haps, a 30 kb hap, a Q0 base whose one mismatch adds
    # NaN) and the edges of its design (reads of 1-257 bases at 1-270
    # offsets, tandem repeats, N at one position in read and hap)
    region_n = normalize(*engine_region(100))
    se_sets = [("golden rows", gn_reads, gn_haps, diag),
               ("a 512 x 12 region", *region_n,
                [(r, h) for r in range(512) for h in range(12)]),
               ("edge pairs", *seed_extend_edge_set(3)),
               ("the offsets-on-lanes edges", *seed_extend_order_set(4))]
    for label, rs, hs, ps in se_sets:
        err["seed_extend_f32"] = max(err["seed_extend_f32"], compare_seed_extend(
            stage_fast(rs, hs, ps, dev)))
    err["window_gather"], gather_held = compare_gather(dev)
    err["cigar_walk"], walk_held = compare_walk(dev)
    log(f"[2 kernel==plain, tolerance 0 (bit for bit)] SW {len(targets)} "
        f"pairs 40-250 bp x 4 strategies: banded x 2 modes at the wrapper's "
        f"W and at W = {', '.join(map(str, sw_cuda.BANDED_WARPS))} warps a "
        f"pair, and 2,048 pairs of 1-64 x 1,000-2,000 bp (carry row in "
        f"global memory) at W = 1, 2, ez and real-cell nibbles equal; plane "
        f"x 3 modes (traceback, samples, best score) on both sets at the "
        f"same W, every output equal (carry row of the 1,024 pairs at W = "
        f"1..32 by mode: {plane_placed}; of the 2,048: global); PairHMM "
        f"banded f32 and f64 on {len(kat)} KAT pairs, {len(rnd_pairs)} "
        f"random ragged pairs, the {len(golden)} golden rows and reads of "
        f"1-700 bp against a hap of 30 kb (f32) or 16 kb (f64) at the "
        f"wrapper's W and W = 1..{ph.BANDED_WARPS_MAX}, and PairHMM plane f32 "
        f"on the f32 sets at the wrapper's (R, W) and R = "
        f"{', '.join(map(str, ph.PLANE_ROWS_PER_LANE))} x W = 1.."
        f"{ph.BANDED_WARPS_MAX}: equal; carry rows (kernel, pairs, hap "
        f"columns, placement) {pp_placed}; "
        f"shared on {len(sh_reads)} reads of 50-160 bp x "
        f"{len(sh_haps)} haps (positions "
        f"{compute_haplotype_similarities(sh_haps)[0].tolist()}) at the "
        f"wrapper's W and W = 1.."
        f"{ph.SHARED_WARPS_MAX}, and {len(lg_reads)} reads of 60 bp x "
        f"{len(lg_haps)} haps of 1 kb at W = 1, 2, sharing on and off: "
        f"equal, and on == off; carry rows (set, reads, stream slots, "
        f"placement) {placed}; seed-extend on "
        f"{', '.join(f'{lb} ({len(ps)} pairs)' for lb, _, _, ps in se_sets)}"
        f": equal (NaN where plain has NaN); window gather at every nibble "
        f"shift, the first and last words and at random ({gather_held}): "
        f"equal; CIGAR walk on the banded kernel's words in all four "
        f"strategies ({walk_held}): segs, tail and over equal")

    # ---- phase 3: SW golden through the entry point -----------------------
    sw_rows = load_golden("sw_golden.jsonl")
    groups = golden_groups(sw_rows)
    aligner = SmithWatermanAligner(device=dev)
    exact = 0
    for (m, x, o, ext, s), rs in groups.items():
        got = aligner.align_batch([r["target"].encode() for r in rs],
                                  [r["query"].encode() for r in rs],
                                  SWParameters.normalized(m, x, o, ext),
                                  OverhangStrategy(s))
        exact += sum((g.cigar, g.offset) == (r["cigar_scalar"],
                                             r["offset_scalar"])
                     for r, g in zip(rs, got))
    if exact != len(sw_rows):
        raise AssertionError(f"SW golden: {exact}/{len(sw_rows)} exact")
    log(f"[3 sw golden] {exact}/{len(sw_rows)} CIGARs and offsets exact "
        f"(all four strategies)")

    # ---- phase 4: PairHMM goldens through the cascade ---------------------
    lik = pair_likelihoods(kat_reads, kat_haps,
                           [(k, k) for k in range(len(kat))], dev)
    kat_err = np.abs(lik - np.array([c["expected_log10"] for c in kat]))
    if not (kat_err < 1e-5).all():
        raise AssertionError(f"KAT: {(kat_err < 1e-5).sum()}/{len(kat)}")
    eng = PairHmmEngine(device=dev)
    sq = eng.compute_likelihoods(kat_reads[:4], kat_haps[:4])
    if sq.shape != (4, 4) or np.abs(
            np.diag(sq) - [c["expected_log10"] for c in kat[:4]]).max() >= 1e-5:
        raise AssertionError("compute_likelihoods product layout")
    f32 = ph.scores(gn_reads, gn_haps, diag, CTX_F32, dev).cpu().numpy()
    rescued = f32 < float(MIN_ACCEPTED)
    want = np.array([float.fromhex(r["scalarf"]) < float(MIN_ACCEPTED)
                     for r in golden])
    decisions = int((rescued == want).sum())
    glik = pair_likelihoods(g_reads, g_haps, diag, dev)
    gwant = (np.log10([float.fromhex(r["scalard"]) for r in golden])
             - float(CTX_F64.log10_initial_constant))
    g_err = np.abs(glik - gwant)
    if decisions != len(golden) or not (g_err < 1e-5).all():
        raise AssertionError(f"PairHMM golden: decisions {decisions}, "
                             f"within 1e-5 {(g_err < 1e-5).sum()}")
    # use_double: every pair in f64 alone, each pair its own call
    eng_double = PairHmmEngine(use_double=True, device=dev)
    d_kat = np.array([eng_double.compute_likelihoods([r], [h])[0, 0]
                      for r, h in zip(kat_reads, kat_haps)])
    d_kat_err = np.abs(d_kat - [c["expected_log10"] for c in kat])
    d_gold = np.array([eng_double.compute_likelihoods([r], [h])[0, 0]
                       for r, h in zip(g_reads, g_haps)])
    d_gold_err = np.abs(d_gold - gwant)
    if not ((d_kat_err < 1e-5).all() and (d_gold_err < 1e-5).all()):
        raise AssertionError(f"use_double: KAT {(d_kat_err < 1e-5).sum()}/"
                             f"{len(kat)}, golden {(d_gold_err < 1e-5).sum()}/"
                             f"{len(golden)} within 1e-5")
    # fast_path: the kernel's scores against the reference's
    # compute_fast_prob (the golden ``fast``), then each golden pair through
    # the engine: a hit takes log10(fs) - log10(2^120), the rest equal the
    # exact engine
    fs = se.fast_scores(gn_reads, gn_haps, diag, dev).cpu().numpy()
    g_fast = np.array([float.fromhex(r["fast"]) for r in golden])
    nz = g_fast != 0
    fast_rel = np.abs(fs[nz] - g_fast[nz]) / np.abs(g_fast[nz])
    if not ((fast_rel < 1e-6).all() and (np.abs(fs[~nz]) < 1e-30).all()):
        raise AssertionError(f"seed-extend vs golden fast: "
                             f"{(fast_rel < 1e-6).sum()}/{nz.sum()} within 1e-6")
    eng_fast = PairHmmEngine(fast_path=True, device=dev)
    hits = fs >= MIN_ACCEPTED
    for k, (r, h) in enumerate(zip(g_reads, g_haps)):
        got = eng_fast.compute_likelihoods([r], [h])[0, 0]
        if hits[k]:       # within 1e-9 log10, as tests/test_pairhmm_jax.py
            ok = abs(got - (np.log10(np.float64(fs[k]))
                            - float(CTX_F32.log10_initial_constant))) < 1e-9
        else:
            ok = got == eng.compute_likelihoods([r], [h])[0, 0]
        if not ok:
            raise AssertionError(f"fast_path golden row {k} (hit {hits[k]}): "
                                 f"{got}")
    log(f"[4 pairhmm golden] KAT {int((kat_err < 1e-5).sum())}/{len(kat)} "
        f"within 1e-5 log10 (max {kat_err.max():.2e}); golden rescue "
        f"decisions {decisions}/{len(golden)} ({int(rescued.sum())} rescued); "
        f"log10 vs scalard max {g_err.max():.2e}; use_double: KAT "
        f"{int((d_kat_err < 1e-5).sum())}/{len(kat)} (max "
        f"{d_kat_err.max():.2e}), golden {int((d_gold_err < 1e-5).sum())}/"
        f"{len(golden)} within 1e-5 of scalard (max {d_gold_err.max():.2e}); "
        f"fast_path: seed-extend kernel vs the golden fast max relative "
        f"{fast_rel.max():.2e} over {int(nz.sum())} non-zero rows, "
        f"{int(hits.sum())} hits within 1e-9 of log10(fs) - log10(2^120), "
        f"{int((~hits).sum())} others equal to the exact engine")

    # ---- phase 5: the main path at a realistic size -----------------------
    p_std = SWParameters(*SW_PARAMS)
    soft = OverhangStrategy.SOFTCLIP
    sw_t, sw_q = sw_pairs(21, 10_000, (150, 150), (150, 150))
    long_t, long_q = sw_pairs(22, 64, (8000, 8000), (2000, 2000))
    regions = [engine_region(100 + k) for k in range(8)]
    # a region the work estimate sends to the per-pair product kernel
    small = engine_region(108, n_reads=32)
    for rs, hs, want_shared in [(*r, True) for r in regions] + [(*small, False)]:
        if use_shared_kernel([len(r["bases"]) for r in rs], hs) != want_shared:
            raise AssertionError(f"{len(rs)} x {len(hs)}: shared mode should "
                                 f"be {want_shared}")

    (sw_out, long_out), sw_n, t_sw = drive(lambda: (
        aligner.align_batch(sw_t, sw_q, p_std, soft),
        aligner.align_batch(long_t, long_q, p_std, soft)))
    (eng_out, small_out), eng_n, t_eng = drive(lambda: (
        [eng.compute_likelihoods(r, h) for r, h in regions],
        eng.compute_likelihoods(*small)))
    for name, n, want in (("SW", sw_n, ["sw_banded"]),
                          ("engine", eng_n, ["pairhmm_banded_f32",
                                             "pairhmm_banded_f64",
                                             "pairhmm_shared_f32"])):
        if min(n[k] for k in want) < 1:
            raise AssertionError(f"a kernel of the {name} path never "
                                 f"launched: {n}")

    # what came out is right: shapes, values, and samples held to the
    # port's plain torch path on the CPU (the goldens above hold both to
    # the reference), log10 within 1e-5
    assert len(sw_out) == len(sw_t) and len(long_out) == len(long_t)
    sample = list(range(0, len(sw_t), 1250))
    want = SmithWatermanAligner(device="cpu").align_batch(
        [sw_t[k] for k in sample], [sw_q[k] for k in sample], p_std, soft)
    for k, w in zip(sample, want):
        if sw_out[k] != w:
            raise AssertionError(f"SW pair {k}: {sw_out[k]} != {w}")
    for out in eng_out:
        if out.shape != (512, 12) or np.isnan(out).any() or np.isposinf(out).any():
            raise AssertionError("engine output shape or values")
    reads0, haps0 = regions[0]
    picks = [(1, 0), (2, 5), (0, 3), (16, 11), (77, 6), (32, 2)]
    want = pair_likelihoods(reads0, haps0, picks, "cpu")
    got = np.array([eng_out[0][ri, hi] for ri, hi in picks])
    if not (np.abs(got - want) < 1e-5).all():
        raise AssertionError(f"engine sample {picks}: {got} vs {want}")
    small_cpu = PairHmmEngine(device="cpu").compute_likelihoods(*small)
    small_err = float(np.abs(small_out - small_cpu).max())
    if small_err >= 1e-5:
        raise AssertionError(f"product-mode region vs the CPU: {small_err}")
    n_resc = sum(r % 16 == 0 for r, _ in picks)     # the random reads
    n_eng = sum(o.size for o in eng_out)
    log(f"[5 main path] launches: SW path {sw_n}; engine path {eng_n}; first "
        f"run: SW {len(sw_t)} x 150 bp + {len(long_t)} x 8000x2000 "
        f"{t_sw:.3f} s, engine {len(regions)} regions 512x12 (shared mode) "
        f"+ 1 region 32x12 (product mode) {t_eng:.3f} s; {len(sample)} SW "
        f"and {len(picks)} engine pairs ({n_resc} from the random tail) "
        f"within 1e-5 of the per-pair plain path on the CPU, the product-mode "
        f"region within {small_err:.2e} of the engine on the CPU")
    # end to end once warm, host clock (results land on the host)
    t0 = time.perf_counter()
    aligner.align_batch(sw_t, sw_q, p_std, soft)
    t_sw = time.perf_counter() - t0
    t0 = time.perf_counter()
    for r, h in regions:
        eng.compute_likelihoods(r, h)
    t_eng = time.perf_counter() - t0
    log(f"    end to end, warm: SW {len(sw_t) / t_sw:.1f} pairs/s "
        f"({t_sw:.4f} s for {len(sw_t)} pairs of 150 bp, traceback + CIGAR); "
        f"engine {n_eng / t_eng:.1f} pairs/s ({t_eng:.4f} s for "
        f"{len(regions)} regions of 512 reads x 12 haps); card {card}")

    # ---- phase 6: the stream ---------------------------------------------
    stream_out, st_n, t_st = drive(
        lambda: list(eng.compute_likelihoods_stream(iter(regions))))
    if min(st_n["pairhmm_shared_f32"], st_n["pairhmm_banded_f64"]) < 1:
        raise AssertionError(f"a kernel of the stream never launched: {st_n}")
    if not all(np.array_equal(a, b) for a, b in zip(stream_out, eng_out)):
        raise AssertionError("stream != sequential compute_likelihoods")
    t0 = time.perf_counter()
    for _ in eng.compute_likelihoods_stream(iter(regions)):
        pass
    t_st = time.perf_counter() - t0
    log(f"[6 stream] launches {st_n}; {len(regions)} regions bit-equal to "
        f"sequential calls; warm: stream {n_eng / t_st:.1f} pairs/s "
        f"({t_st:.4f} s), sequential {n_eng / t_eng:.1f} pairs/s "
        f"({t_eng:.4f} s); card {card}")
    launches = {k: sw_n[k] + eng_n[k] + st_n[k] for k in kernels}

    # ---- phase 6b: the engine's use_double and fast_path modes ------------
    # the 8 regions and the 32 x 12 product region through each mode, with
    # the launch counts of that run; every output finite, rows of a region
    # (a row depends on its read and the haps alone here) and the whole
    # small region bit-equal to the same engine on the CPU; the stream
    # bit-equal to sequential calls; warm end-to-end pairs/s.  Every region
    # has hits under fast_path, so the pairs under the gate go to the
    # per-pair f32 kernel and the shared kernel never runs; a region with
    # no hit (every read random) follows, which must take the shared kernel
    sample_reads = [0, 1, 2, 16, 32, 77]
    for mode, mode_eng, must in (
            ("use_double", eng_double,
             lambda n: n["pairhmm_banded_f64"] >= 1
             and n["pairhmm_shared_f32"] == 0
             and n["pairhmm_banded_f32"] == 0),
            ("fast_path", eng_fast,
             lambda n: n["seed_extend_f32"] >= 1
             and n["pairhmm_banded_f32"] >= 1
             and n["pairhmm_shared_f32"] == 0)):
        (m_out, m_small), m_n, _ = drive(lambda: (
            [mode_eng.compute_likelihoods(r, h) for r, h in regions],
            mode_eng.compute_likelihoods(*small)))
        if not must(m_n):
            raise AssertionError(f"{mode}: launches {m_n}")
        for out in m_out:
            if out.shape != (512, 12) or not np.isfinite(out).all():
                raise AssertionError(f"{mode}: engine output shape or values")
        cpu_eng = PairHmmEngine(device="cpu", **{mode: True})
        want = cpu_eng.compute_likelihoods([reads0[k] for k in sample_reads],
                                           haps0)
        if not (np.array_equal(m_out[0][sample_reads], want)
                and np.array_equal(m_small,
                                   cpu_eng.compute_likelihoods(*small))):
            raise AssertionError(f"{mode}: card != CPU")
        m_stream, m_st_n, _ = drive(lambda: list(
            mode_eng.compute_likelihoods_stream(iter(regions))))
        if not all(np.array_equal(a, b) for a, b in zip(m_stream, m_out)):
            raise AssertionError(f"{mode}: stream != sequential calls")
        for k in kernels:
            launches[k] += m_n[k] + m_st_n[k]
        t0 = time.perf_counter()
        for r, h in regions:
            mode_eng.compute_likelihoods(r, h)
        t_mode = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in mode_eng.compute_likelihoods_stream(iter(regions)):
            pass
        t_mode_st = time.perf_counter() - t0
        log(f"[6b engine {mode}] launches {m_n}, stream {m_st_n}; "
            f"{len(regions)} regions of 512 x 12 + 1 of 32 x 12, finite; "
            f"{len(sample_reads)} reads x 12 haps of a region and the 32 x "
            f"12 region bit-equal to the engine on the CPU; stream bit-equal "
            f"to sequential calls; warm: {n_eng / t_mode:.1f} pairs/s "
            f"({t_mode:.4f} s for {len(regions)} regions), stream "
            f"{n_eng / t_mode_st:.1f} pairs/s ({t_mode_st:.4f} s); card "
            f"{card}")
    nohit = no_hit_region(120)
    if not use_shared_kernel([len(r["bases"]) for r in nohit[0]], nohit[1]):
        raise AssertionError("the no-hit region should take shared mode")
    nh_out, nh_n, _ = drive(lambda: eng_fast.compute_likelihoods(*nohit))
    if nh_n["seed_extend_f32"] != 1 or nh_n["pairhmm_shared_f32"] != 1:
        raise AssertionError(f"fast_path without hits: launches {nh_n}")
    if not np.array_equal(nh_out, PairHmmEngine(
            device="cpu", fast_path=True).compute_likelihoods(*nohit)):
        raise AssertionError("fast_path without hits: card != CPU")
    for k in kernels:
        launches[k] += nh_n[k]
    log(f"[6b engine fast_path, no hit] launches {nh_n}; "
        f"{len(nohit[0])} random reads x {len(nohit[1])} haps through the "
        f"shared kernel, bit-equal to the engine on the CPU")

    # ---- phase 7: the plane path ------------------------------------------
    # the second design of both recurrences, through its entry points: the
    # SW goldens one launch per parameter group, the 150 bp batch over the
    # aligner's buckets (traceback and best score), and the PairHMM plane
    # forward over the region's full product and the known answers
    reads0, haps0 = normalize(reads0, haps0)
    kat_n = normalize(kat_reads, kat_haps)
    kat_pairs = [(k, k) for k in range(len(kat))]
    region_pairs = [(r, h) for r in range(len(reads0))
                    for h in range(len(haps0))]
    buckets = bucket_pairs([len(t) for t in sw_t], [len(q) for q in sw_q],
                           max_batch=aligner.max_batch)

    def plane_path():
        gold = [(rs, sw_cuda.align_batch(
            [r["target"].encode() for r in rs],
            [r["query"].encode() for r in rs],
            SWParameters.normalized(m, x, o, e), OverhangStrategy(s), dev))
            for (m, x, o, e, s), rs in groups.items()]
        cigars, best = [None] * len(sw_t), torch.empty(
            len(sw_t), dtype=torch.int32, device=dev)
        for _, idx in buckets:
            ts, qs = [sw_t[k] for k in idx], [sw_q[k] for k in idx]
            for k, c in zip(idx, sw_cuda.align_batch(ts, qs, p_std, soft,
                                                     dev)):
                cigars[k] = c
            best[idx] = sw_cuda.sw_plane_scores(*sw_tensors(ts, qs, dev),
                                                *SW_PARAMS, indel_init=False)
        return (gold, cigars, best.cpu(),
                ph.forward_scores_plane(reads0, haps0, region_pairs,
                                        dev).cpu(),
                ph.forward_scores_plane(*kat_n, kat_pairs, dev).cpu())

    (gold, pl_cigars, pl_best, pl_region, pl_kat), pl_n, t_pl = drive(
        plane_path)
    for name in ("sw_plane", "sw_plane_scores", "pairhmm_plane_f32"):
        if pl_n[name] < 1:
            raise AssertionError(f"a kernel of the plane path never "
                                 f"launched: {pl_n}")
        launches[name] = pl_n[name]
    exact = sum((g == (r["cigar_scalar"], r["offset_scalar"]))
                for rs, got in gold for r, g in zip(rs, got))
    if exact != len(sw_rows):
        raise AssertionError(f"SW golden through the plane: {exact}/"
                             f"{len(sw_rows)} exact")
    if pl_cigars != [(r.cigar, r.offset) for r in sw_out]:
        raise AssertionError("plane CIGARs != the banded aligner's")
    sw_args = sw_tensors(sw_t, sw_q, dev)
    ez_plane = sw_cuda.sw_plane(*sw_args, *SW_PARAMS, indel_init=False)[0]
    ez_band = sw_cuda.sw_banded(*sw_args, *SW_PARAMS, indel_init=False,
                                with_traceback=False)[0]
    if not (torch.equal(ez_plane, ez_band)
            and torch.equal(pl_best, ez_band[2].cpu())):
        raise AssertionError("plane ez or best scores != the banded ez")
    a32_big = ph.stage_pairs(reads0, haps0, region_pairs, CTX_F32, dev)
    kat_staged = ph.stage_pairs(*kat_n, kat_pairs, CTX_F32, dev)
    if not (torch.equal(pl_region, ph.pairhmm_banded_f32(*a32_big).cpu())
            and torch.equal(pl_kat,
                            ph.pairhmm_banded_f32(*kat_staged).cpu())):
        raise AssertionError("PairHMM plane != banded f32 scores")
    d2h = [traceback_bytes([sw_t[k] for k in idx], [sw_q[k] for k in idx])
           for _, idx in buckets]
    d2h_long = traceback_bytes(long_t, long_q)
    log(f"[7 plane path] launches {pl_n}; {t_pl:.3f} s; SW goldens "
        f"{exact}/{len(sw_rows)} exact through sw_cuda.align_batch "
        f"({len(groups)} groups); {len(sw_t)} x 150 bp over {len(buckets)} "
        f"buckets: CIGARs and offsets equal to the banded aligner's, ez and "
        f"best scores equal to the banded kernel's; PairHMM plane f32 equal "
        f"to banded on {len(region_pairs)} region pairs 151x420 and "
        f"{len(kat_pairs)} KAT pairs (bit for bit); traceback words to the "
        f"host for the {len(sw_t)} x 150 bp buckets: plane "
        f"{sum(p for p, _ in d2h)} B, banded {sum(b for _, b in d2h)} B; "
        f"for {len(long_t)} x 8000x2000: plane {d2h_long[0]} B, banded "
        f"{d2h_long[1]} B")

    # ---- phase 7b: the read mapper at a realistic size ---------------------
    mapper = run_mapper(dev, drive)
    map_n = mapper["launches"]
    if min(map_n["window_gather"], map_n["sw_banded"]) < 1:
        raise AssertionError(f"a kernel of the mapper path never launched: "
                             f"{map_n}")
    for k in kernels:
        launches[k] += map_n[k]
    st_txt = ", ".join(f"{k} {v:.4f} s" for k, v in
                       sorted(mapper["stages"].items()))
    idle_txt = ("not measured (no device events in the trace)"
                if mapper["idle"] is None else
                f"{mapper['idle']:.4f} (device busy {mapper['busy_ms']:.3f} "
                f"ms of a {mapper['chunk_wall']:.4f} s warm chunk of "
                f"{MAP_CHUNK})")
    log(f"[7b mapper] {MAP_READS} reads of {MAP_READ_LEN} bp at 1% "
        f"substitutions vs a simulated {MAP_REF_LEN / 1e6:.0f} Mbp reference "
        f"(simulated in {mapper['t_sim']:.2f} s); index build (k = 16, native "
        f"scan + radix sort, {mapper['n_kmers']} k-mers) {mapper['t_index']:.3f}"
        f" s; map_reads_stream (chunks of {MAP_CHUNK}) + align_and_sort, "
        f"cold, {mapper['t_cold']:.3f} s; launches {map_n} (window_gather "
        f"{map_n['window_gather']}, sw_banded {map_n['sw_banded']}); mapped "
        f"{mapper['mapped']:.4f}, true start in the window "
        f"{mapper['accuracy']:.4f} (gate 0.99), exact tier "
        f"{mapper['exact']:.4f}; {mapper['n_checked']} sampled non-exact "
        f"scores equal to the plain gather + sw_banded_plain on the card; "
        f"align_and_sort positions and scores equal to the stream's, keys "
        f"ascending and equal to a stable NumPy argsort")
    log(f"    mapper warm: {MAP_READS / mapper['t_warm']:.1f} reads/s "
        f"({mapper['t_warm']:.4f} s for {MAP_READS} reads); stages {st_txt}; "
        f"idle share {idle_txt}; card {card}")

    # ---- phase 7c: the read mapper in CIGAR mode at a realistic size -------
    cig = run_cigar_mapper(dev, drive, mapper["index"])
    cig_n = cig["launches"]
    if min(cig_n["window_gather"], cig_n["sw_banded"],
           cig_n["cigar_walk"]) < 1:
        raise AssertionError(f"a kernel of the CIGAR mapper path never "
                             f"launched: {cig_n}")
    for k in kernels:
        launches[k] += cig_n[k]
    n_tier = len(cig["tier"])
    st_txt = ", ".join(f"{k} {v:.4f} s" for k, v in
                       sorted(cig["stages"].items()))
    idle_txt = ("not measured (no device events in the trace)"
                if cig["idle"] is None else
                f"{cig['idle']:.4f} (device busy {cig['busy_ms']:.3f} ms of a "
                f"{cig['chunk_wall']:.4f} s warm chunk of {MAP_CHUNK})")
    log(f"[7c CIGAR mapper] {MAP_READS} reads of {MAP_READ_LEN} bp at 1% "
        f"substitutions, {cig['n_del']} ({MAP_DEL_FRAC:.0%}) with a 1-2 bp "
        f"deletion after base 70, drawn from phase 7b's reference (simulated "
        f"in {cig['t_sim']:.2f} s) and mapped with its index; "
        f"map_reads_stream(with_cigar=True) (chunks of {MAP_CHUNK}), cold, "
        f"{cig['t_cold']:.3f} s; launches {cig_n}; mapped {cig['mapped']}: "
        f"exact {cig['exact']}, certified {cig['certified']}, traceback tier "
        f"{n_tier} (= map.tb_reads; {n_tier / cig['mapped']:.4f} of mapped, "
        f"{cig['n_over']} overflowed the walk's SEG_CAP); every mapped read "
        f"has a CIGAR, every mapped deletion read a D; the tier's CIGARs and "
        f"offsets equal the plain path's on the card (plain gather, "
        f"sw_banded_plain traceback, cigar_walk_plain, finish_cigars, host "
        f"decoder; {cig['t_plain']:.2f} s) and {cig['n_check']} sampled "
        f"ones the host decoder's on the kernels' words")
    log(f"    CIGAR mapper warm: {MAP_READS / cig['t_warm']:.1f} reads/s "
        f"({cig['t_warm']:.4f} s for {MAP_READS} reads, {cig['tb_warm']} "
        f"traceback reads); stages {st_txt}; idle share {idle_txt}; card "
        f"{card}")

    # ---- phase 7d: the CLI on the card -------------------------------------
    log(f"[7d CLI] python -m mgl_tpu_torch.cli --device cuda: {run_cli()}")

    # ---- phase 8: kernel and plain times at the main path's shapes --------
    ms, plain_ms, bounds = {}, {}, {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, ts, qs, iters, p_warm in (("150x150", sw_t, sw_q, 5, 1),
                                         ("8000x2000", long_t, long_q, 2, 0)):
        args = sw_tensors(ts, qs, dev)
        cells = sum(len(t) * len(q) for t, q in zip(ts, qs))
        nb, wpb = banded_layout(args[0].shape[1], args[1].shape[1])
        chosen = sw_cuda.banded_warps(len(ts), nb, sms)
        # the wrapper's W against the plain version (one run of it a mode),
        # then the sweep over every W up to the bands, each bit-equal to it
        sweep = [chosen] + [w for w in sw_cuda.BANDED_WARPS
                            if w <= nb and w != chosen]
        for tb in (True, False):
            kw = dict(indel_init=False, with_traceback=tb)
            mode = "traceback" if tb else "score-only"
            if p_warm:
                sw_cuda.sw_banded_plain(*args, *SW_PARAMS, **kw)
            (ez_p, w_p), p_ms = timed_calls(lambda: sw_cuda.sw_banded_plain(
                *args, *SW_PARAMS, **kw))
            for w in sweep:
                k_ms = cuda_ms(lambda: sw_cuda.sw_banded(
                    *args, *SW_PARAMS, **kw, warps_per_pair=w), iters)
                ez, words = sw_cuda.sw_banded(*args, *SW_PARAMS, **kw,
                                              warps_per_pair=w)
                torch.cuda.synchronize()
                if w == chosen:
                    e = int((ez.long() - ez_p.long()).abs().max())
                    if tb:
                        e += traceback_mismatches(words, w_p, args[2],
                                                  args[3], wpb)
                    ez_c, words_c = ez, words
                    held = "equal to plain"
                else:
                    e = int(not (torch.equal(ez, ez_c) and (
                        not tb or torch.equal(words, words_c))))
                    held = f"every word equal to W={chosen}'s"
                if e:
                    raise AssertionError(f"SW kernel W={w} at {label} "
                                         f"({mode}): {e} differences")
                if w == chosen:
                    b_ms, b_by = bound(cells * SW_OPS_PER_CELL[tb], "int32",
                                       nbytes(*args, ez,
                                              *([words] if tb else [])))
                    log(f"    SW {mode} {len(ts)} x {label}: plain torch "
                        f"{p_ms:.3f} ms = {cells / p_ms / 1e6:.2f} GCUPS; "
                        f"bound {b_ms:.4f} ms ({b_by}); card {card}")
                    if tb and label == "150x150":
                        ms["sw_banded"], plain_ms["sw_banded"] = k_ms, p_ms
                        bounds["sw_banded"] = (b_ms, b_by)
                carry = ("shared" if sw_cuda.banded_carry_in_shared(
                    len(ts), args[1].shape[1], w, tb, dev) else "global")
                log(f"      W={w}{' (chosen)' if w == chosen else ''}: "
                    f"kernel {k_ms:.3f} ms = {cells / k_ms / 1e6:.2f} GCUPS; "
                    f"carry row in {carry} memory; {held}; card {card}")
                del ez, words
            del ez_p, w_p, ez_c, words_c
        if label == "150x150":
            # the aligner's launches: one a bucket of <= 2,048, W its own
            bargs = [sw_tensors([ts[k] for k in idx], [qs[k] for k in idx],
                                dev) for _, idx in buckets]
            for tb in (True, False):
                b_ms = cuda_ms(lambda: [sw_cuda.sw_banded(
                    *a, *SW_PARAMS, indel_init=False, with_traceback=tb)
                    for a in bargs], iters)
                log(f"    SW {'traceback' if tb else 'score-only'} over the "
                    f"aligner's {len(bargs)} buckets (W = "
                    f"{[sw_cuda.banded_warps(a[0].shape[0], nb, sms) for a in bargs]}"
                    f"): {b_ms:.3f} ms for {len(bargs)} launches; card {card}")
            del bargs

        # the plane kernel in its three modes, held to its plain version at
        # 150 bp (which is not run at 8000 x 2000) and to the banded ez
        ez_b = sw_cuda.sw_banded(*args, *SW_PARAMS, indel_init=False,
                                 with_traceback=False)[0]
        for mode_i, mode in enumerate(sw_cuda.PLANE_MODES):
            run, run_plain, ops = sw_plane_mode(args, False, mode)
            k_ms = cuda_ms(run, iters)
            out = run()
            if mode == "traceback":
                same = torch.equal(out[0], ez_b)
            elif mode == "samples":
                ez_s = compute_score_max(*(o.cpu().numpy() for o in out),
                                         args[2].cpu().numpy(),
                                         args[3].cpu().numpy())
                same = all(np.array_equal(ez_s[k], ez_b[i].cpu().numpy())
                           for i, k in enumerate(EZ_KEYS))
            else:
                same = torch.equal(out[0], ez_b[2])
            if not same:
                raise AssertionError(f"SW plane {mode} != banded ez at "
                                     f"{label}")
            b_ms, b_by = bound(cells * ops, "int32", nbytes(*args, *out))
            p_text = "not run at this shape"
            if label == "150x150":
                p_ms = cuda_ms(run_plain, 1, warmup=p_warm)
                p_text = f"{p_ms:.3f} ms = {cells / p_ms / 1e6:.2f} GCUPS"
                e = compare_sw_plane(args, False, mode)
                if e:
                    raise AssertionError(f"SW plane kernel != plain at "
                                         f"{label} ({mode}): {e}")
                name = "sw_plane_scores" if mode == "scores" else "sw_plane"
                if mode != "samples":
                    ms[name], plain_ms[name] = k_ms, p_ms
                    bounds[name] = (b_ms, b_by)
            # the kernel alone into preallocated outputs, at the wrapper's W
            # and over every W up to the bands (each equal to the wrapper's
            # outputs), and the wrapper's zero fill alone
            T, Q = args[0].shape[1], args[1].shape[1]
            p_chosen = sw_cuda.pipeline_warps("sw_plane", len(ts), T, Q,
                                              None, sms)
            sweep = {}
            for w in [p_chosen] + [w for w in sw_cuda.BANDED_WARPS
                                   if w <= nb and w != p_chosen]:
                outs = plane_outputs(mode_i, len(ts), T, Q, dev)
                sweep[w] = cuda_ms(lambda: sw_cuda._sw_plane(
                    mode_i, *args, *SW_PARAMS, False, outs,
                    warps_per_pair=w), iters)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(outs, out)):
                    raise AssertionError(f"SW plane {mode} W={w} at {label} "
                                         f"!= the wrapper's outputs")
                del outs
            fill_ms = cuda_ms(lambda: [o.zero_() for o in out], iters)
            del out
            carry = ("shared" if sw_cuda.plane_carry_in_shared(
                len(ts), Q, p_chosen, mode_i, dev) else "global")
            log(f"    SW plane {mode} {len(ts)} x {label}: kernel {k_ms:.3f} "
                f"ms = {cells / k_ms / 1e6:.2f} GCUPS with the wrapper's "
                f"allocation and zero fill ({fill_ms:.3f} ms alone); into "
                f"preallocated outputs {sweep[p_chosen]:.3f} ms at W = "
                f"{p_chosen} (chosen, carry row in {carry} memory), by W "
                f"{ {w: round(v, 4) for w, v in sweep.items()} }; plain torch "
                f"{p_text}; bound {b_ms:.4f} ms ({b_by}); equal to "
                f"{'plain and ' if label == '150x150' else ''}the banded ez, "
                f"every W equal; card {card}")

    # the plane path's 12 golden-group launches (traceback, each group's
    # own W and indel rule), together, against their plain versions
    g_args = [(sw_tensors([r["target"].encode() for r in rs],
                          [r["query"].encode() for r in rs], dev),
               SWParameters.normalized(m, x, o, e),
               bool(s & (OverhangStrategy.INDEL | OverhangStrategy.LEADING_INDEL)))
              for (m, x, o, e, s), rs in groups.items()]

    def golden_launches(kernel):
        return [kernel(*a, p.match, p.mismatch, p.gap_open, p.gap_extend,
                       indel_init=ii) for a, p, ii in g_args]

    k_ms = cuda_ms(lambda: golden_launches(sw_cuda.sw_plane), 5)
    got = golden_launches(sw_cuda.sw_plane)
    want, p_ms = timed_calls(lambda: golden_launches(sw_cuda.sw_plane_plain))
    if not all(torch.equal(a, b) for g, w in zip(got, want)
               for a, b in zip(g, w)):
        raise AssertionError("SW plane golden groups != plain")
    g_cells = sum(len(r["target"]) * len(r["query"]) for r in sw_rows)
    g_bound = bound(g_cells * SW_OPS_PER_CELL[True], "int32",
                    sum(nbytes(*a, *o) for (a, _, _), o in zip(g_args, got)))
    log(f"    SW plane traceback, the {len(g_args)} golden-group launches "
        f"({len(sw_rows)} pairs, {g_cells} real cells; W "
        f"{[sw_cuda.pipeline_warps('sw_plane', a[0].shape[0], a[0].shape[1], a[1].shape[1], None, sms) for a, _, _ in g_args]}): "
        f"{k_ms:.3f} ms for the {len(g_args)} wrapper calls (allocation, "
        f"zero fill, kernel); plain torch {p_ms:.3f} "
        f"ms; bound {g_bound[0]:.4f} ms ({g_bound[1]}); equal; card {card}")
    del g_args, got, want

    # registers and spills of each (output layout, carry row in shared
    # memory) instance of the SW wavefront kernel, read from the build log
    regs = {tuple(map(int, re.search(r"ILi(\d)ELb(\d)E", r["entry"]).groups())):
            (r["registers"], r.get("spill_stores"), r.get("spill_loads"))
            for r in _build.kernel_resources("sw_wavefront_kernel")}
    log(f"    SW wavefront registers and spills by (Out: 0 banded words, 1 "
        f"banded score-only, 2 plane words, 3 samples, 4 best score; carry "
        f"row in shared memory): {dict(sorted(regs.items()))}")

    # the per-pair kernels: f32 at the product-mode region's 384 pairs and
    # at a 512 x 12 region's 6,144, f64 at its 384 rescue pairs (every 16th
    # read) and at its 6,144 (a region under use_double); each at the
    # wrapper's W against the plain version, then the sweep over every W up
    # to the read's bands, each bit-equal to it; all timed as
    # time_pairhmm_banded times them (testing.queued_ms)
    small_r, small_h = normalize(*small)
    a32 = ph.stage_pairs(small_r, small_h,
                         [(r, h) for r in range(32) for h in range(12)],
                         CTX_F32, dev)
    tail = [(r, h) for r in range(0, 512, 16) for h in range(12)]
    a64 = ph.stage_pairs(reads0, haps0, tail, CTX_F64, dev)
    a64_big = ph.stage_pairs(reads0, haps0, region_pairs, CTX_F64, dev)
    regs = _build.kernel_resources("pairhmm_banded")
    if any(r.get("spill_stores", 0) or r.get("spill_loads", 0) for r in regs):
        raise AssertionError(f"the per-pair kernels spill: {regs}")
    log(f"    pairhmm_banded registers and spills (f32 then f64, carry row in "
        f"global then shared memory): "
        f"{[(r['registers'], r.get('spill_stores'), r.get('spill_loads')) for r in regs]}"
        f"; at most {ph.BANDED_WARPS_MAX} warps a block")
    for name, a, kern, sweep in (
            ("pairhmm_banded_f32", a32, ph.pairhmm_banded_f32, False),
            ("pairhmm_banded_f32", a32_big, ph.pairhmm_banded_f32, True),
            ("pairhmm_banded_f64", a64, ph.pairhmm_banded_f64, True),
            ("pairhmm_banded_f64", a64_big, ph.pairhmm_banded_f64, True)):
        n_pairs, n_bands = len(a[6]), (a[0].shape[-1] - 2) // 32
        cells = int((a[2][a[6]].long() * a[4][a[7]].long()).sum())
        b_ms, b_by = bound(cells * FLOPS_PER_CELL,
                           "f64" if name.endswith("f64") else "f32",
                           nbytes(*a) + n_pairs * a[0].element_size())
        chosen = ph.pair_warps(n_pairs, n_bands, sms)
        p_ms = cuda_ms(lambda: ph.forward_plain(*a), 1)
        want = ph.forward_plain(*a)
        log(f"    {name} {n_pairs} pairs 151x420 ({n_bands} bands): plain "
            f"torch {p_ms:.3f} ms = {cells / p_ms / 1e6:.2f} GCUPS; bound "
            f"{b_ms:.4f} ms ({b_by}); card {card}")
        for w in [chosen] + ([w for w in range(1, n_bands + 1) if w != chosen]
                             if sweep else []):
            k_ms = queued_ms(lambda: kern(*a, warps_per_pair=w), 5)
            got = kern(*a, warps_per_pair=w)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                e = float((got.double() - want.double()).abs().max())
                raise AssertionError(f"{name} W={w} != plain at {n_pairs} "
                                     f"pairs: {e}")
            if w == chosen and n_pairs == 384:
                ms[name], plain_ms[name] = k_ms, p_ms
                bounds[name] = (b_ms, b_by)
            carry = ("shared" if ph.banded_carry_in_shared(
                n_pairs, a[3].shape[1], w, a[0].dtype, dev) else "global")
            log(f"      W={w}{' (chosen)' if w == chosen else ''}: kernel "
                f"{k_ms:.4f} ms = {cells / k_ms / 1e6:.2f} GCUPS; bound share "
                f"{b_ms / k_ms:.3f}; {n_pairs} blocks of {w} warps, "
                f"{n_pairs * w / sms:.1f} warps an SM over the launch; carry "
                f"row in {carry} "
                f"memory; equal to plain; card {card}")
    del a64_big

    # the seed-extend kernel at a region's 6,144 pairs (the fast path's
    # first pass over a region) against its plain version, both on the
    # staged pairs; the bound counts the positions this data needs
    a_se = stage_fast(reads0, haps0, region_pairs, dev)
    p_ms = cuda_ms(lambda: fast_scores_plain(*a_se), 1)
    k_ms = queued_ms(lambda: se.seed_extend_f32(*a_se), 20)
    e = compare_seed_extend(a_se)
    b_ms, b_by, work, n_off = seed_extend_bound(a_se, len(region_pairs))
    ms["seed_extend_f32"], plain_ms["seed_extend_f32"] = k_ms, p_ms
    bounds["seed_extend_f32"] = (b_ms, b_by)
    regs = _build.kernel_resources("seed_extend")
    if not regs or any(r.get("spill_stores", 0) or r.get("spill_loads", 0)
                       for r in regs):
        raise AssertionError(f"the seed-extend kernel spills or is not in "
                             f"the build log: {regs}")
    geo = se.seed_extend_layout(len(region_pairs), a_se[0].shape[1],
                                a_se[4].shape[1])
    log(f"    seed_extend_f32 launch: {geo['blocks']} blocks of "
        f"{geo['threads'] // 32} warps (a warp a pair), "
        f"{geo['blocks'] * geo['threads'] / 32 / sms:.1f} warps an SM over "
        f"the launch, {geo['shared_bytes']} B of dynamic shared memory a "
        f"block (the read and hap of each warp)")
    log(f"    seed_extend_f32 {len(region_pairs)} pairs 151x420 ("
        f"{work} read positions compared up to each offset's second "
        f"mismatch, {n_off} offsets): kernel {k_ms:.4f} ms; plain torch {p_ms:.3f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}); bound share {b_ms / k_ms:.3f}; max |err| "
        f"{e}; registers and spills "
        f"{[(r['registers'], r.get('spill_stores'), r.get('spill_loads')) for r in regs]}"
        f"; card {card}")
    del a_se

    # the plane kernel: at the wrapper's (R, W) against the plain version
    # and beside the banded f32 kernel on the same staged pairs (both timed
    # by testing.queued_ms) - the region's 6,144 pairs, which the plane path
    # runs, a 32 x 12 region's 384, and 24 reads of 250 bp against a hap of
    # 5.6 kb - then the sweep over every R and W up to the bands, each
    # bit-equal to plain
    regs = _build.kernel_resources("pairhmm_plane")
    if len(regs) != 2 * len(ph.PLANE_ROWS_PER_LANE) or any(
            r.get("spill_stores", 0) or r.get("spill_loads", 0) for r in regs):
        raise AssertionError(f"the plane PairHMM instances spill or are "
                             f"missing: {regs}")
    regs = {tuple(map(int, re.search(r"ILi(\d)ELb(\d)E", r["entry"]).groups())):
            (r["registers"], r.get("spill_stores"), r.get("spill_loads"))
            for r in regs}
    log(f"    pairhmm_plane registers and spills by (R, carry row in shared "
        f"memory): {dict(sorted(regs.items()))}; at most "
        f"{ph.BANDED_WARPS_MAX} warps a block")
    l_reads, l_haps, l_pairs = pair_edge_set(8, (250,) * 24, (5600,))
    a250 = ph.stage_pairs(*normalize(l_reads, l_haps), l_pairs, CTX_F32, dev)
    for label, a in (("151x420", a32_big), ("151x420", a32),
                     ("250x5600", a250)):
        n_pairs, rows = len(a[6]), a[0].shape[-1]
        cells = int((a[2][a[6]].long() * a[4][a[7]].long()).sum())
        b_ms, b_by = bound(cells * FLOPS_PER_CELL, "f32",
                           nbytes(*a) + n_pairs * 4)
        chosen = ph.plane_layout(n_pairs, rows, sms)
        if n_pairs == 24:
            want, p_text = ph.forward_plain(*a), "not timed at this shape"
        else:
            want, p_ms = timed_calls(lambda: ph.forward_plain(*a))
            p_text = f"{p_ms:.3f} ms = {cells / p_ms / 1e6:.2f} GCUPS"
        bw = ph.pair_warps(n_pairs, (rows - 2) // 32, sms)
        banded_ms = queued_ms(lambda: ph.pairhmm_banded_f32(*a), 5)
        log(f"    pairhmm_plane_f32 {n_pairs} pairs {label} (bands of 64 / "
            f"128 rows: {ph.plane_bands(rows, 2)} / {ph.plane_bands(rows, 4)})"
            f": plain torch {p_text}; the banded f32 kernel (W = {bw}) "
            f"{banded_ms:.4f} ms = {cells / banded_ms / 1e6:.2f} GCUPS; bound "
            f"{b_ms:.4f} ms ({b_by}); card {card}")
        for r, w in [chosen] + [(r, w) for r in ph.PLANE_ROWS_PER_LANE
                                for w in range(1, min(ph.plane_bands(rows, r),
                                                      ph.BANDED_WARPS_MAX) + 1)
                                if (r, w) != chosen]:
            def run():
                return ph.pairhmm_plane_f32(*a, warps_per_pair=w,
                                            rows_per_lane=r)
            k_ms = queued_ms(run, 5)
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                e = float((got.double() - want.double()).abs().max())
                raise AssertionError(f"pairhmm_plane_f32 R={r} W={w} != plain "
                                     f"at {n_pairs} pairs {label}: {e}")
            if (r, w) == chosen and n_pairs == 6144:
                ms["pairhmm_plane_f32"], plain_ms["pairhmm_plane_f32"] = (
                    k_ms, p_ms)
                bounds["pairhmm_plane_f32"] = (b_ms, b_by)
            carry = ("shared" if ph.plane_carry_in_shared(
                n_pairs, a[3].shape[1], w, r, dev) else "global")
            log(f"      R={r} W={w}{' (chosen)' if (r, w) == chosen else ''}: "
                f"kernel {k_ms:.4f} ms = {cells / k_ms / 1e6:.2f} GCUPS; bound "
                f"share {b_ms / k_ms:.3f}; {banded_ms / k_ms:.3f}x the banded "
                f"kernel's speed; {n_pairs} blocks of {w} warps, "
                f"{n_pairs * w / sms:.1f} warps an SM over the launch; carry "
                f"row in {carry} memory; equal to plain; card {card}")
    del a250

    # the shared kernel at the region shape: the wrapper's W against the
    # plain version, then the sweep over every W up to the read's bands,
    # each bit-equal to it, beside the per-pair f32 kernel on the product;
    # both timed as time_pairhmm_shared times them (testing.queued_ms)
    a_sh = ph.stage_shared(reads0, haps0, dev)
    n_sh = len(reads0)
    sh_bands = (a_sh[0].shape[-1] - 2) // 32
    chosen = ph.shared_warps(n_sh, sh_bands, sms)
    p_ms = cuda_ms(lambda: shared_forward_plain(*a_sh), 1, warmup=0)
    want = shared_forward_plain(*a_sh)
    stream_cols = int(a_sh[4][0, -1] + a_sh[4][3, -1] - 31)
    swept = int(a_sh[2].long().sum()) * stream_cols
    product = sum(len(r["bases"]) for r in reads0) * sum(map(len, haps0))
    bounds["pairhmm_shared_f32"] = bound(
        swept * FLOPS_PER_CELL, "f32",
        nbytes(*a_sh[:5]) + want.numel() * want.element_size())
    big_ms = queued_ms(lambda: ph.pairhmm_banded_f32(*a32_big), 5)
    regs = _build.kernel_resources("pairhmm_shared_kernel")
    log(f"    pairhmm_shared_f32 {n_sh} reads x {len(haps0)} haps (stream of "
        f"{stream_cols} of {sum(map(len, haps0))} columns, {sh_bands} bands "
        f"a read): plain torch {p_ms:.3f} ms; bound "
        f"{bounds['pairhmm_shared_f32'][0]:.4f} ms "
        f"({bounds['pairhmm_shared_f32'][1]}); the per-pair f32 kernel over "
        f"the same product {big_ms:.3f} ms; registers and spills "
        f"{[(r['registers'], r.get('spill_stores'), r.get('spill_loads')) for r in regs]}"
        f" (one instance a carry placement); card {card}")
    for w in [chosen] + [w for w in range(1, sh_bands + 1) if w != chosen]:
        k_ms = queued_ms(lambda: ph.pairhmm_shared_f32(
            *a_sh, warps_per_read=w), 5)
        got = ph.pairhmm_shared_f32(*a_sh, warps_per_read=w)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"shared kernel W={w} != plain at the "
                                 f"region shape")
        if w == chosen:
            ms["pairhmm_shared_f32"] = k_ms
            plain_ms["pairhmm_shared_f32"] = p_ms
        carry = ("shared" if ph.shared_carry_in_shared(
            n_sh, a_sh[3].shape[0], w, dev) else "global")
        log(f"      W={w}{' (chosen)' if w == chosen else ''}: kernel "
            f"{k_ms:.3f} ms = {product / k_ms / 1e6:.2f} GCUPS over the "
            f"product's {product} cells, {swept / k_ms / 1e6:.2f} over the "
            f"{swept} swept cells; bound share "
            f"{bounds['pairhmm_shared_f32'][0] / k_ms:.3f}; {n_sh} blocks of "
            f"{w} warps, {n_sh * w / sms:.1f} warps an SM; carry row in "
            f"{carry} memory; equal to plain; card {card}")

    # the window gather at one mapper chunk: the first chunk's reads as
    # they came and a window for each mapped one, by row and strand, as
    # map_reads_stream hands them to the kernel; the bound is the bytes it
    # must move
    m_out, m_wlen = mapper["out"], mapper["wlen"]
    sel = np.nonzero(m_out["pos"][:MAP_CHUNK] >= 0)[0]
    m_words, m_blocked = mp._ref_device(mapper["index"], dev)
    g_args = (m_words, tuple(torch.from_numpy(s).to(dev) for s in
                             mp._split_starts(m_out["pos"][sel], m_blocked)),
              torch.from_numpy(mapper["reads"][:MAP_CHUNK]).to(dev),
              torch.from_numpy(sel.astype(np.int32)).to(dev),
              torch.from_numpy(m_out["strand"][sel].astype(np.uint8)).to(dev),
              m_wlen, MAP_READ_LEN)
    k_ms = cuda_ms(lambda: wg.window_gather(*g_args), 20)
    p_ms = cuda_ms(lambda: wg.window_gather_plain(*g_args), 3)
    got = wg.window_gather(*g_args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in
               zip(got, wg.window_gather_plain(*g_args))):
        raise AssertionError("window gather != plain at one mapper chunk")
    g_bytes = wg.window_gather_bytes(len(sel), m_wlen, MAP_READ_LEN,
                                     m_blocked)
    bounds["window_gather"] = bound(
        len(sel) * (m_wlen + MAP_READ_LEN) * GATHER_OPS_PER_BASE, "int32",
        g_bytes)
    ms["window_gather"], plain_ms["window_gather"] = k_ms, p_ms
    regs = _build.kernel_resources("window_gather")
    log(f"    window_gather {len(sel)} windows of {m_wlen} + reads of "
        f"{MAP_READ_LEN} bp ({g_bytes} bytes to move): kernel {k_ms:.4f} ms "
        f"= {g_bytes / k_ms / 1e6:.1f} GB/s; plain torch {p_ms:.3f} ms; bound "
        f"{bounds['window_gather'][0]:.4f} ms ({bounds['window_gather'][1]});"
        f" bound share {bounds['window_gather'][0] / k_ms:.3f}; equal to "
        f"plain; registers and spills "
        f"{[(r['registers'], r.get('spill_stores'), r.get('spill_loads')) for r in regs]}"
        f"; card {card}")
    del g_args, got

    # the CIGAR walk at one traceback chunk of 8,192 windows: phase 7c's
    # traceback-tier reads (~2% of 262,144, so under a chunk) and certified
    # reads after them, through the gather and sw_banded in traceback mode
    # as sw_cigar_windows runs them, the kernel timed by queued_ms (its
    # wrapper's host time exceeds its device time); then the post-pass's
    # host time at that chunk split into the walk (launch to sync), the
    # fetch of its small outputs and finish_cigars, and the bytes fetched
    from mgl_tpu_torch.kernels.cigar_walk_cuda import walk_bytes
    from mgl_tpu_torch.kernels.pairhmm_cuda import to_host
    from mgl_tpu_torch.ops.cigar_device import (SEG_CAP, cigar_walk_plain,
                                                finish_cigars, walk_start)

    soft = OverhangStrategy.SOFTCLIP
    t_idx = np.concatenate([cig["tier"], cig["cert_idx"]])[:WALK_CHUNK]
    c_out, c_wlen = cig["out"], cig["wlen"]
    c_ez, c_words, c_wpb = mp._sw_traceback_windows(
        mapper["index"], c_out["pos"][t_idx], cig["oriented"](t_idx), c_wlen,
        SWParameters(*SW_PARAMS), soft, dev)
    nb = len(t_idx)
    full = lambda v: torch.full((nb,), v, dtype=torch.int32, device=dev)
    w_args = (c_words, c_ez, full(c_wlen), full(MAP_READ_LEN))
    n_steps = c_wlen + MAP_READ_LEN
    run = lambda: cw.cigar_walk(*w_args, soft, n_steps, words_per_band=c_wpb)
    run_p = lambda: cigar_walk_plain(*w_args, strategy=int(soft),
                                     n_steps=n_steps, words_per_band=c_wpb)
    k_ms = queued_ms(run, 20)
    p_ms = cuda_ms(run_p, 2)
    got, want = run(), run_p()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("CIGAR walk != plain at one traceback chunk")
    I0, J0 = walk_start(c_ez, *w_args[2:], int(soft))
    steps = walk_steps(*got, I0, J0)
    w_bytes = walk_bytes(steps, nb)
    bounds["cigar_walk"] = bound(steps * WALK_OPS_PER_STEP, "int32", w_bytes)
    ms["cigar_walk"], plain_ms["cigar_walk"] = k_ms, p_ms
    split = {"walk": [], "fetch": [], "finish_cigars": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        segs, tail, over = run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host = to_host(torch.cat([segs, tail, c_ez[5][:, None],
                                  over[:, None].to(torch.int32)], dim=1))()
        t2 = time.perf_counter()
        finish_cigars(host[:, :SEG_CAP], host[:, SEG_CAP:SEG_CAP + 5],
                      {"seg_length": host[:, SEG_CAP + 5]},
                      np.full(nb, c_wlen), np.full(nb, MAP_READ_LEN), soft,
                      nb)
        t3 = time.perf_counter()
        for k, v in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[k].append(round(v * 1e3, 3))
    regs = _build.kernel_resources("cigar_walk")
    if not regs or any(r.get("spill_stores", 0) or r.get("spill_loads", 0)
                       for r in regs):
        raise AssertionError(f"the CIGAR walk kernel spills or is not in "
                             f"the build log: {regs}")
    geo = cw.walk_layout(nb)
    log(f"    cigar_walk launch: {geo['blocks']} blocks of "
        f"{geo['threads'] // 32} warps ({geo['lanes']} lanes a pair, "
        f"{geo['threads'] // geo['lanes']} pairs a block), "
        f"{geo['blocks'] * geo['threads'] / 32 / sms:.1f} warps an SM over "
        f"the launch, {geo['shared_bytes']} B of shared memory a block (two "
        f"windows a pair)")
    log(f"    cigar_walk {nb} traceback windows of {c_wlen} x "
        f"{MAP_READ_LEN} ({min(n_tier, nb)} tier reads, the rest "
        f"certified; {steps} steps walked, {int(got[2].sum())} "
        f"overflowed; {w_bytes} bytes to move): kernel {k_ms:.4f} ms; plain "
        f"torch {p_ms:.3f} ms; bound {bounds['cigar_walk'][0]:.5f} ms "
        f"({bounds['cigar_walk'][1]}); bound share "
        f"{bounds['cigar_walk'][0] / k_ms:.4f}; equal to plain; registers "
        f"and spills "
        f"{[(r['registers'], r.get('spill_stores'), r.get('spill_loads')) for r in regs]}"
        f"; card {card}")
    log(f"    traceback post-pass at that chunk, host ms of 3 runs: {split};"
        f" fetched {host.nbytes // nb} B a pair ({host.nbytes} B) against "
        f"{c_words[0].numel() * 4} B of traceback words a pair "
        f"({c_words.numel() * 4} B); card {card}")
    del c_ez, c_words, w_args, got, want

    # B4 on one card: parallel/sort.py's stable torch.sort of the keys as
    # int64 and the payload's gather, on the card (CUDA events) and
    # through sort_records_single from host arrays to host arrays (host
    # clock), at the smoke's 262,144 keys and at 10M; the bound reads
    # each key (8 B) and payload (4 B) once and writes them once
    from mgl_tpu_torch.parallel.sort import sort_records_single

    sort_txt = []
    for n in (MAP_READS, 10_000_000):
        rng = np.random.default_rng(n)
        keys_h = rng.integers(0, 2**64 - 1, n, dtype=np.uint64)
        vals_h = np.arange(n, dtype=np.int32)
        keys_d = torch.from_numpy(keys_h.view(np.int64)).to(dev)
        vals_d = torch.from_numpy(vals_h).to(dev)

        def device_sort():
            sk, order = torch.sort(keys_d, stable=True)
            return sk, vals_d[order]

        d_ms = cuda_ms(device_sort, 10)
        sort_records_single(keys_h, vals_h, device=dev)
        t0 = time.perf_counter()
        sk, sv = sort_records_single(keys_h, vals_h, device=dev)
        h_ms = (time.perf_counter() - t0) * 1e3
        order = np.argsort(keys_h, kind="stable")
        if not (np.array_equal(sk, keys_h[order])
                and np.array_equal(sv, vals_h[order])):
            raise AssertionError(f"sort_records_single != NumPy at {n} keys")
        b_ms = bound(0, "int32", 24 * n)[0]
        sort_txt.append(f"{n} keys: device {d_ms:.4f} ms "
                        f"({n / d_ms / 1e3:.1f} Mkeys/s), host to host "
                        f"{h_ms:.3f} ms ({n / h_ms / 1e3:.1f} Mkeys/s), bound "
                        f"{b_ms:.5f} ms (bytes, {24 * n} B), share "
                        f"{b_ms / d_ms:.4f}")
        del keys_d, vals_d
    log(f"    sort_records_single (torch.sort, stable, + payload gather): "
        f"{'; '.join(sort_txt)}; equal to a stable NumPy argsort; card {card}")

    # ---- phase 9a: the sharded step at a real size ----------------------
    step = run_step(drive)
    step_n = step["launches"]
    if min(step_n["pairhmm_banded_f32"], step_n["sw_banded"]) < 1:
        raise AssertionError(f"a kernel of the step never launched: {step_n}")
    for k in kernels:
        launches[k] += step_n[k]
    warm = sorted(step["warm"])
    idle_txt = ("not measured (no device events in the trace)"
                if step["idle"] is None else
                f"{step['idle']:.4f} (device busy {step['busy_ms']:.3f} ms of "
                f"a {step['wall']:.4f} s warm step)")
    n_pairs = STEP_READS * STEP_HAPS
    log(f"[9a step] parallel/pipeline.pipeline_step on a one-rank NCCL mesh "
        f"(init_runtime over tcp://127.0.0.1): {STEP_READS} reads of "
        f"{STEP_READ_LEN} bp x {STEP_HAPS} haps of {STEP_HAP_LEN} bp "
        f"({n_pairs} pairs), SW of the reads against a replicated "
        f"{STEP_HAP_LEN} bp window ({step['n_neg_sw']} negative best "
        f"scores), {STEP_READS} keys; launches {step_n}; cold "
        f"{step['t_cold']:.3f} s; every output bit-equal to the same step on "
        f"a 1 x 1 cpu mesh ({step['t_cpu']:.2f} s on the host's CPU); keys "
        f"ascending")
    log(f"    step warm (host clock, 5 runs): median {warm[2] * 1e3:.3f} ms, "
        f"min {warm[0] * 1e3:.3f}, max {warm[-1] * 1e3:.3f} "
        f"({n_pairs / warm[2]:.1f} pairs/s); idle share {idle_txt}; "
        f"pairhmm_banded_f32 at {n_pairs} pairs {STEP_READ_LEN}x"
        f"{STEP_HAP_LEN} {step['ph_ms']:.4f} ms (plain on the card "
        f"{step['ph_plain_ms']:.3f} ms, equal); sw_banded score-only at "
        f"{STEP_READS} x {STEP_HAP_LEN}x{STEP_READ_LEN} {step['sw_ms']:.4f} "
        f"ms (plain {step['sw_plain_ms']:.3f} ms, equal); the step's bound "
        f"{step['bound_ms']:.5f} ms ({step['bound_by']}: operations "
        f"{step['ops_ms']:.5f} ms, bytes {step['bytes_ms']:.5f} ms), "
        f"share of the median {step['bound_ms'] / (warm[2] * 1e3):.4f}; "
        f"plain step on the card (the two plain versions) "
        f"{step['ph_plain_ms'] + step['sw_plain_ms']:.3f} ms; card {card}")

    import tempfile

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp_dir:
        tmp = pathlib.Path(tmp_dir)
        # ---- phase 9b: the elastic pipeline scale-out on the card -------
        sc = run_step_scaleout(tmp, step["mesh"])
        log(f"[9b step scale-out] make_workload {STEP_READS} x {STEP_HAPS} "
            f"({STEP_READ_LEN} x {STEP_HAP_LEN} bp) in "
            f"{STEP_READS // STEP_CHUNK} chunks of {STEP_CHUNK}; two `worker "
            f"--device cuda` processes, the victim wedged on chunk 0 and "
            f"killed by SIGKILL; assembled output bit-identical to one "
            f"process's ChunkRunner ({sc['t_base']:.3f} s); scale-out "
            f"{sc['t_dist']:.3f} s from the first spawn; coordinator "
            f"{sc['stats']}")
        # ---- phase 9c: the elastic map scale-out at config 4's shape -----
        ms9 = run_map_scaleout(tmp, mapper)
        log(f"[9c map scale-out] phase 7b's {MAP_REF_LEN / 1e6:.0f} Mbp "
            f"reference and {MAP_READS} reads in {MAP_READS // MAP_CHUNK} "
            f"chunks of {MAP_CHUNK}; two `map-worker --device cuda` "
            f"processes, the victim wedged on chunk 0 and killed by SIGKILL; "
            f"every MAP_OUT_KEYS array equal to phase 7b's map_reads_stream; "
            f"{ms9['t_dist']:.3f} s from the first spawn; workers: "
            f"{'; '.join(ms9['times'])}; card {card}")

    # ---- phase 9d: align_and_sort on the one-rank mesh -------------------
    from mgl_tpu_torch.pipelines.align_sort import align_and_sort

    idx7, reads7 = mapper["index"], mapper["reads"]
    srt_mesh, sort_n, t_sort = drive(
        lambda: align_and_sort(idx7, reads7, mesh=step["mesh"], device=dev))
    srt_none = align_and_sort(idx7, reads7, device=dev)
    for k in srt_none:
        if not np.array_equal(srt_mesh[k], srt_none[k]):
            raise AssertionError(f"align_and_sort(mesh=1x1) {k} != mesh=None")
    for k in kernels:
        launches[k] += sort_n[k]
    log(f"[9d align_and_sort(mesh=...)] on phase 7b's {MAP_READS} reads with "
        f"the one-rank NCCL mesh: every output equal to mesh=None; launches "
        f"{sort_n}; {t_sort:.3f} s")
    import torch.distributed as dist

    dist.destroy_process_group()

    # ---- phase 10: the size range -----------------------------------------
    t0 = time.perf_counter()
    size_n = run_size_range(dev, drive, card)
    for k in kernels:
        launches[k] += size_n.get(k, 0)
    log(f"[10 size range] {time.perf_counter() - t0:.1f} s; launches "
        f"{size_n}")

    # ---- phase 11: the scale runs ------------------------------------------
    t0 = time.perf_counter()
    try:
        scale = run_scale(scale_launcher)
    finally:
        scale_launcher.shutdown()
    for k in kernels:
        launches[k] += scale["launches"].get(k, 0)
    srep = scale["rep"]
    c4, c5 = srep["config4_seed_extend_1m"], srep["config5_align_sort"]
    secs = ", ".join(f"{n} {t:.1f} s" for n, t in scale["secs"].items())
    log(f"[11 scale runs] python -m mgl_tpu_torch.scale_configs, one process "
        f"each: {secs}; launches of the timed passes {scale['launches']}; "
        f"the record's data-dependent fields equal; card {srep['card']}")
    log(f"    config 4: {c4['n_reads']} reads on {c4['ref_mbp']:.0f} Mbp, "
        f"median {c4['reads_per_s']} reads/s (trials "
        f"{c4['trials_reads_per_s']}), stages {c4['stage_s']}, index "
        f"{c4['index_build_s']} s, warm-up {c4['warmup_s']} s, peak RSS "
        f"{c4['max_rss_gb']} GiB, window accuracy {c4['window_accuracy']}, "
        f"mapped {c4['mapped_frac']}; card {srep['card']}")
    for n in ("config4_cigar", "config4_cigar_1m", "config4_cigar_hierr"):
        c = srep[n]
        log(f"    {n}: {c['n_reads']} reads (err {c['err']}, deletions of "
            f"1-{c['max_indel']} bp in {c['indel_reads']}), "
            f"{c['reads_per_s']} reads/s, traceback tier "
            f"{c['traceback_tier_reads']} reads ({c['traceback_tier_share']}"
            f", {c['traceback_tier_s']} s, {c['traceback_overflow_reads']} "
            f"walks over SEG_CAP), mapped {c['mapped_frac']}, "
            f"{c['indel_cigars_with_gap']} deletion reads with a gap; card "
            f"{srep['card']}")
    mesh_sort = srep["config5_mesh_sort"]
    log(f"    config 5: {c5['e2e_reads']} keys host to host "
        f"{c5['e2e_sort_s']} s cold, {c5['e2e_sort_warm_s']} s warm; "
        f"{c5['sort_keys']} keys on the card {c5['sort_10m_device_s']} s "
        f"({c5['sort_10m_mkeys_per_s']} Mkeys/s; median of "
        f"{c5['sort_10m_repeats']} by {c5['sort_10m_clock']}, min and max "
        f"{c5['sort_10m_min_max_s']} s; first call "
        f"{c5['sort_10m_first_call_s']} s); mesh of "
        f"{mesh_sort['mesh_sort_10m_devices']} gloo ranks: "
        f"{mesh_sort['mesh_sort_10m_s']} s from a barrier, "
        f"{mesh_sort['mesh_sort_10m_wall_s']} s from the first spawn; card "
        f"{srep['card']}")
    log(f"[11 scale runs] {time.perf_counter() - t0:.1f} s; card {card}")

    if any(m == "jax" or m.startswith(("jax.", "mgl_tpu."))
           or m == "mgl_tpu" for m in sys.modules):
        raise AssertionError("the port's main path imported jax or mgl_tpu")
    replaces = {
        "sw_banded": ("mgl_tpu_torch/csrc/sw_banded.cu",
                      "mgl_tpu/kernels/sw_pallas.py:252"),
        "pairhmm_banded_f32": ("mgl_tpu_torch/csrc/pairhmm_banded.cu",
                               "mgl_tpu/kernels/pairhmm_pallas.py:175"),
        "pairhmm_banded_f64": ("mgl_tpu_torch/csrc/pairhmm_banded.cu",
                               "mgl_tpu/kernels/pairhmm_xf_pallas.py:61"),
        "pairhmm_shared_f32": ("mgl_tpu_torch/csrc/pairhmm_shared.cu",
                               "mgl_tpu/kernels/pairhmm_pallas.py:611"),
        "sw_plane": ("mgl_tpu_torch/csrc/sw_plane.cu",
                     "mgl_tpu/kernels/sw_pallas.py:45"),
        "sw_plane_scores": ("mgl_tpu_torch/csrc/sw_plane.cu",
                            "mgl_tpu/kernels/sw_pallas.py:689"),
        "pairhmm_plane_f32": ("mgl_tpu_torch/csrc/pairhmm_plane.cu",
                              "mgl_tpu/kernels/pairhmm_pallas.py:62"),
        # an XLA device function (a lax.scan), not a Pallas kernel
        "seed_extend_f32": ("mgl_tpu_torch/csrc/seed_extend.cu",
                            "mgl_tpu/ops/seed_extend.py:52"),
        # the mapper's window gather, an XLA device function too
        "window_gather": ("mgl_tpu_torch/csrc/window_gather.cu",
                          "mgl_tpu/pipelines/mapper.py:757"),
        # the mapper's CIGAR walk, an XLA device function (a lax.scan)
        "cigar_walk": ("mgl_tpu_torch/csrc/cigar_walk.cu",
                       "mgl_tpu/ops/cigar_device.py:47"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         # no PyTorch call computes a pair-HMM or SW recurrence, the
         # seed-extend scan, the whole window gather and unpack or the
         # CIGAR walk
         "library_ms": None}
        for name, (src, rep) in replaces.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
