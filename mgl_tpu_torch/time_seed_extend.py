"""Device time of the seed-extend fast-path kernel
(``kernels.seed_extend_cuda.seed_extend_f32``, the engine's tier-0 pass
under ``fast_path``), with a checksum of its scores and its bound.

    python -m mgl_tpu_torch.time_seed_extend [--label NAME] [--out FILE]

Shapes: a region's 6,144 pairs of 151 x 420 (``testing.engine_region``
seed 100, 512 reads x 12 haps, normalized: the smoke's phase 8 shape),
384 pairs of a 32 x 12 region of the same fixture, and the edge pairs of
``testing.seed_extend_edge_set`` (seed 3) with their 30,000-base hap.
Each is staged once (``ops.seed_extend.stage_fast``) and timed as
``time_pairhmm_banded`` times its kernels: after a warm-up call, the mean
of 20, of 5 and of 2 calls, each by ``testing.queued_ms`` (enqueued
behind a spin of the card, so the events measure device time alone);
``ms`` is the median of the three, ``ms_runs`` all three.  The bound is
the smoke's (``chip_smoke.seed_extend_bound``: the int32 compares this
data needs up to each offset's second mismatch and the f32 adds, against
the staged bytes).  The script uses only the wrapper arguments of the
first port of the kernel, so it runs on an older tree too, with this
tree's ``testing.py`` beside it: two trees in one call give
parent / new / new / parent on one card.  The last line is the report as
one JSON object; ``--out`` writes it to a file too.  Needs one NVIDIA GPU;
imports no jax.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import pathlib
import sys

import torch

from mgl_tpu_torch import _build
from mgl_tpu_torch.device import card_name
from mgl_tpu_torch.kernels.seed_extend_cuda import seed_extend_f32
from mgl_tpu_torch.ops.pairhmm import normalize
from mgl_tpu_torch.ops.seed_extend import stage_fast
from mgl_tpu_torch.testing import (engine_region, queued_ms,
                                   seed_extend_edge_set)

CALLS = (20, 5, 2)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def region(n_reads: int):
    reads, haps = normalize(*engine_region(100, n_reads, 12))
    return reads, haps, [(r, h) for r in range(n_reads) for h in range(12)]


SHAPES = (("region_6144_151x420", lambda: region(512)),
          ("region_384_151x420", lambda: region(32)),
          ("edge_25_30kb_hap", lambda: seed_extend_edge_set(3)))


def timed(call) -> tuple[float, list[float]]:
    call()
    runs = [queued_ms(call, n) for n in CALLS]
    return sorted(runs)[1], runs


def checksum(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_seed_extend needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    smoke = importlib.import_module("chip_smoke")
    dev = torch.device("cuda")
    card = card_name()
    rows = []
    for name, make in SHAPES:
        reads, haps, pairs = make()
        a = stage_fast(reads, haps, pairs, dev)
        ms, runs = timed(lambda: seed_extend_f32(*a))
        b_ms, b_by, positions, offsets = smoke.seed_extend_bound(a, len(pairs))
        row = dict(label=opts.label, shape=name, pairs=len(pairs), ms=ms,
                   ms_runs=runs, bound_ms=b_ms, bound_by=b_by,
                   share=b_ms / ms, positions=positions, offsets=offsets,
                   out_sha=checksum(seed_extend_f32(*a)), card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    report = json.dumps({"label": opts.label, "card": card,
                         "resources": _build.kernel_resources("seed_extend"),
                         "rows": rows})
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(report + "\n")
    print(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
