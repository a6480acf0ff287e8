"""Device time of the per-pair PairHMM kernels
(``kernels.pairhmm_cuda.pairhmm_banded_f64``, the rescue tier,
``pairhmm_banded_f32``, the product-mode pass and ``pair_likelihoods``,
and ``pairhmm_plane_f32``, the plane path's second design of the f32
forward on the same staged arguments).

    python -m mgl_tpu_torch.time_pairhmm_banded [--label NAME] [--sweep]
                                                [--out FILE]

Shapes.  f64: the rescue tail of a GATK region (``testing.engine_region``
seed 7: every 16th of 512 reads of 151 bp x 12 haps of 420 bp, 384
pairs), the 225 golden rows of ``tests/golden/pairhmm_golden.jsonl``, and
24 reads of 250 bp against one hap of 5.6 kb.  f32: 384 pairs (a 32 x 12
region) and 6,144 pairs (a 512 x 12 region's product) of 151 x 420, and
128 x 4 at 60 x 100.  Plane f32: 384 and 6,144 pairs of 151 x 420, 24
reads of 250 bp against a hap of 5.6 kb, and the shapes that set its
rows-a-lane rule: 6,144 pairs of 100 x 300, 384 and 6,144 of 250 x 420,
512 of 1,000 x 1,100 and 4 of 6,000 x 9,000 (Q45 reads, the longest the
first plane kernel took).  Each wrapper call is timed by CUDA events as
``time_pairhmm_shared`` times it: after a warm-up call, the mean of 20, of
5 and of 2 calls, each by ``testing.queued_ms`` (enqueued behind a spin of
the card, so the events measure device time alone); ``ms`` is the median
of the three, ``ms_runs`` all three.  The kernels run at the wrapper's W;
``--sweep`` also times them at every W from 1 to the reads' bands, with
the carry row's placement.  Each row carries a checksum of the kernel's
output and the kernel's bound (11 flops a cell over the card's peak).
The script uses only the wrapper arguments of the first port of the
kernels, so it runs on an older tree too (with this tree's ``testing.py``
beside it; no sweep there, and no plane R where the plane kernel takes
none).  The last line is the report as one JSON
object; ``--out`` writes it to a file too.  Needs one NVIDIA GPU; imports
no jax.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json

import torch

from mgl_tpu_torch import _build
from mgl_tpu_torch.device import card_name
from mgl_tpu_torch.kernels import pairhmm_cuda as ph
from mgl_tpu_torch.ops.pairhmm import normalize
from mgl_tpu_torch.tables import CTX_F32, CTX_F64
from mgl_tpu_torch.testing import (engine_region, golden_read, load_golden,
                                   long_read_pairs, pair_edge_set, queued_ms,
                                   u8)

CALLS = (20, 5, 2)
# H100 SXM peaks outside the tensor cores (NVIDIA's data sheet, 700 W)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
FLOPS_PER_CELL = 11


def rescue_tail():
    reads, haps = engine_region(7)
    return reads, haps, [(r, h) for r in range(0, 512, 16) for h in range(12)]


def golden_rows():
    rows = load_golden("pairhmm_golden.jsonl")
    return ([golden_read(r) for r in rows], [u8(r["hap"]) for r in rows],
            [(k, k) for k in range(len(rows))])


def product(n_reads: int, n_haps: int, rdlen: int, haplen: int):
    reads, haps = engine_region(7, n_reads, n_haps, rdlen, haplen)
    return reads, haps, [(r, h) for r in range(n_reads) for h in range(n_haps)]


def long_hap():
    return pair_edge_set(8, (250,) * 24, (5600,))


# (name, kernel, pairs); contexts: the kernel's dtype
SHAPES = (("f64_384_151x420_rescue", "pairhmm_banded_f64", rescue_tail),
          ("f64_225_golden", "pairhmm_banded_f64", golden_rows),
          ("f64_24_250x5600", "pairhmm_banded_f64", long_hap),
          ("f32_384_151x420", "pairhmm_banded_f32",
           lambda: product(32, 12, 151, 420)),
          ("f32_6144_151x420", "pairhmm_banded_f32",
           lambda: product(512, 12, 151, 420)),
          ("f32_128x4_60x100", "pairhmm_banded_f32",
           lambda: product(128, 4, 60, 100)),
          ("plane_f32_384_151x420", "pairhmm_plane_f32",
           lambda: product(32, 12, 151, 420)),
          ("plane_f32_6144_151x420", "pairhmm_plane_f32",
           lambda: product(512, 12, 151, 420)),
          ("plane_f32_24_250x5600", "pairhmm_plane_f32", long_hap),
          ("plane_f32_6144_100x300", "pairhmm_plane_f32",
           lambda: product(512, 12, 100, 300)),
          ("plane_f32_384_250x420", "pairhmm_plane_f32",
           lambda: product(32, 12, 250, 420)),
          ("plane_f32_6144_250x420", "pairhmm_plane_f32",
           lambda: product(512, 12, 250, 420)),
          ("plane_f32_512_1000x1100", "pairhmm_plane_f32",
           lambda: product(128, 4, 1000, 1100)),
          ("plane_f32_4_6000x9000", "pairhmm_plane_f32",
           lambda: long_read_pairs(9, (6000, 5990), 9000)))


def timed(call) -> tuple[float, list[float]]:
    call()
    runs = [queued_ms(call, n) for n in CALLS]
    return sorted(runs)[1], runs


def checksum(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_pairhmm_banded needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = card_name()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forced = "warps_per_pair" in inspect.signature(
        ph.pairhmm_banded_f64).parameters
    plane_r = "rows_per_lane" in inspect.signature(
        ph.pairhmm_plane_f32).parameters
    rows = []

    def emit(**row):
        row = dict(label=opts.label, **row, card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)

    for name, kernel, make in SHAPES:
        reads, haps, pairs = make()
        reads, haps = normalize(reads, haps)
        kern = getattr(ph, kernel)
        ctx = CTX_F64 if kernel.endswith("f64") else CTX_F32
        a = ph.stage_pairs(reads, haps, pairs, ctx, dev)
        plane = kernel == "pairhmm_plane_f32"
        cells = int((a[2][a[6]].long() * a[4][a[7]].long()).sum())
        bound_ms = cells * FLOPS_PER_CELL / PEAK_FLOPS[a[0].dtype] * 1e3
        # (R, W) layouts to time: the wrapper's, then the sweep's
        if plane and plane_r:
            chosen = ph.plane_layout(len(pairs), a[0].shape[-1], sms)
            sweep = [(r, w) for r in ph.PLANE_ROWS_PER_LANE for w in range(
                1, min(ph.plane_bands(a[0].shape[-1], r),
                       ph.BANDED_WARPS_MAX) + 1)]
        elif forced and not plane:
            n_bands = (a[0].shape[-1] - 2) // 32
            chosen = (1, ph.pair_warps(len(pairs), n_bands, sms))
            sweep = [(1, w) for w in range(
                1, min(n_bands, ph.BANDED_WARPS_MAX) + 1)]
        else:
            chosen, sweep = (None, None), []
        ms, runs = timed(lambda: kern(*a))
        emit(shape=name, kernel=kernel, pairs=len(pairs),
             rows_per_lane=chosen[0], warps=chosen[1], ms=ms, ms_runs=runs,
             bound_ms=bound_ms, share=bound_ms / ms,
             out_sha=checksum(kern(*a)))
        for r, w in sweep if opts.sweep else []:
            kw = dict(warps_per_pair=w, **({"rows_per_lane": r} if plane
                                           else {}))
            ms, runs = timed(lambda: kern(*a, **kw))
            in_shared = (ph.plane_carry_in_shared(
                len(pairs), a[3].shape[1], w, r, dev) if plane else
                ph.banded_carry_in_shared(len(pairs), a[3].shape[1], w,
                                          a[0].dtype, dev))
            emit(shape=name, kernel=kernel, pairs=len(pairs),
                 rows_per_lane=r, warps=w, ms=ms, ms_runs=runs,
                 share=bound_ms / ms, out_sha=checksum(kern(*a, **kw)),
                 carry="shared" if in_shared else "global")
        del a
        torch.cuda.empty_cache()
    report = json.dumps({"label": opts.label, "card": card,
                         "resources": _build.kernel_resources("pairhmm_"),
                         "rows": rows})
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(report + "\n")
    print(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
