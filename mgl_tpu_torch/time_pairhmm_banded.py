"""Device time of the per-pair banded PairHMM kernels
(``kernels.pairhmm_cuda.pairhmm_banded_f64``, the rescue tier, and
``pairhmm_banded_f32``, the product-mode pass and ``pair_likelihoods``).

    python -m mgl_tpu_torch.time_pairhmm_banded [--label NAME] [--sweep]
                                                [--out FILE]

Shapes.  f64: the rescue tail of a GATK region (``testing.engine_region``
seed 7: every 16th of 512 reads of 151 bp x 12 haps of 420 bp, 384
pairs), the 225 golden rows of ``tests/golden/pairhmm_golden.jsonl``, and
24 reads of 250 bp against one hap of 5.6 kb.  f32: 384 pairs (a 32 x 12
region) and 6,144 pairs (a 512 x 12 region's product) of 151 x 420, and
128 x 4 at 60 x 100.  Each wrapper call is timed by CUDA events as
``time_pairhmm_shared`` times it: after a warm-up call, the mean of 20, of
5 and of 2 calls, each by ``testing.queued_ms`` (enqueued behind a spin of
the card, so the events measure device time alone); ``ms`` is the median
of the three, ``ms_runs`` all three.  The kernels run at the wrapper's W;
``--sweep`` also times them at every W from 1 to the reads' bands, with
the carry row's placement.  Each row carries a checksum of the kernel's
output and the kernel's bound (11 flops a cell over the card's peak).
The script uses only the wrapper arguments of the first port of the
kernels, so it runs on an older tree too (with this tree's ``testing.py``
beside it; no sweep there).  The last line is the report as one JSON
object; ``--out`` writes it to a file too.  Needs one NVIDIA GPU; imports
no jax.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess

import torch

from mgl_tpu_torch import _build
from mgl_tpu_torch.kernels import pairhmm_cuda as ph
from mgl_tpu_torch.ops.pairhmm import normalize
from mgl_tpu_torch.tables import CTX_F32, CTX_F64
from mgl_tpu_torch.testing import (engine_region, golden_read, load_golden,
                                   pair_edge_set, queued_ms, u8)

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


# (name, context, pairs)
SHAPES = (("f64_384_151x420_rescue", CTX_F64, rescue_tail),
          ("f64_225_golden", CTX_F64, golden_rows),
          ("f64_24_250x5600", CTX_F64,
           lambda: pair_edge_set(8, (250,) * 24, (5600,))),
          ("f32_384_151x420", CTX_F32, lambda: product(32, 12, 151, 420)),
          ("f32_6144_151x420", CTX_F32, lambda: product(512, 12, 151, 420)),
          ("f32_128x4_60x100", CTX_F32, lambda: product(128, 4, 60, 100)))


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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forced = "warps_per_pair" in inspect.signature(
        ph.pairhmm_banded_f64).parameters
    rows = []

    def emit(**row):
        row = dict(label=opts.label, **row, card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)

    for name, ctx, make in SHAPES:
        reads, haps, pairs = make()
        reads, haps = normalize(reads, haps)
        a = ph.stage_pairs(reads, haps, pairs, ctx, dev)
        kern = ph.pairhmm_banded_f64 if ctx is CTX_F64 else ph.pairhmm_banded_f32
        n_bands = (a[0].shape[-1] - 2) // 32
        cells = int((a[2][a[6]].long() * a[4][a[7]].long()).sum())
        bound_ms = cells * FLOPS_PER_CELL / PEAK_FLOPS[a[0].dtype] * 1e3
        chosen = ph.pair_warps(len(pairs), n_bands, sms) if forced else None
        ms, runs = timed(lambda: kern(*a))
        emit(shape=name, pairs=len(pairs), bands=n_bands, warps=chosen,
             ms=ms, ms_runs=runs, bound_ms=bound_ms, share=bound_ms / ms,
             out_sha=checksum(kern(*a)))
        if opts.sweep and forced:
            for w in range(1, min(n_bands, ph.BANDED_WARPS_MAX) + 1):
                ms, runs = timed(lambda: kern(*a, warps_per_pair=w))
                emit(shape=name, pairs=len(pairs), bands=n_bands, warps=w,
                     ms=ms, ms_runs=runs, share=bound_ms / ms,
                     out_sha=checksum(kern(*a, warps_per_pair=w)),
                     carry=("shared" if ph.banded_carry_in_shared(
                         len(pairs), a[3].shape[1], w, a[0].dtype, dev)
                         else "global"))
        del a
        torch.cuda.empty_cache()
    report = json.dumps({"label": opts.label, "card": card,
                         "resources": _build.kernel_resources("pairhmm_banded"),
                         "rows": rows})
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(report + "\n")
    print(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
