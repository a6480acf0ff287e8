"""Device time of the shared-hap-set PairHMM kernel
(``kernels.pairhmm_cuda.pairhmm_shared_f32``) beside the per-pair f32
kernel (``pairhmm_banded_f32``) on the same reads x haps product.

    python -m mgl_tpu_torch.time_pairhmm_shared [--label NAME] [--sweep]
                                                [--out FILE]

Shapes (those of ``tests/test_torch_shared.py``'s engine decision test):
512 reads x 12 haps of 151 x 420 bp (GATK's assembly region), 32 x 12 at
151 x 420, 128 x 4 at 60 x 100, and 300 x 6 reads of 53-150 bp in three
length buckets against haps of 300 bp; then a long hap set, 300 reads of
100 bp x 24 haps of 1 kb with resets (``testing.long_hap_set``).  Each
wrapper call is timed by CUDA events: after a warm-up call, the mean of
20, of 5 and of 2 calls, each by ``testing.queued_ms`` (enqueued behind a
spin of the card that outlasts its host time, so the events measure
device time alone - the wrappers' host overhead exceeds the kernels' time
at the small shapes); ``ms`` is the median of the three, ``ms_runs`` all
three.  The shared kernel runs at the wrapper's W; ``--sweep`` also times
it at every W from 1 to the read's bands, with the carry row's placement.
Each row carries a checksum of the kernel's output, and says whether the
engine's work estimate picks shared mode there.  The script uses only the
wrapper arguments of the first port of the kernel, so it runs on an older
tree too (with this tree's ``testing.py`` beside it).  The last line is
the report as one JSON object; ``--out`` writes it to a file too.
Needs one NVIDIA GPU; imports no jax.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json

import torch

from mgl_tpu_torch.device import card_name
from mgl_tpu_torch.kernels import pairhmm_cuda as ph
from mgl_tpu_torch.ops.pairhmm import normalize, use_shared_kernel
from mgl_tpu_torch.tables import CTX_F32
from mgl_tpu_torch.testing import engine_region, long_hap_set, queued_ms

# (name, reads, haps, read length, hap length)
SHAPES = (("512x12_151x420", 512, 12, 151, 420),
          ("32x12_151x420", 32, 12, 151, 420),
          ("128x4_60x100", 128, 4, 60, 100),
          ("300x6_mixed", 300, 6, 100, 300),
          ("300x24_100x1000_resets", 300, 24, 100, 1000))
CALLS = (20, 5, 2)


def region(name: str, n_reads: int, n_haps: int, rdlen: int, haplen: int):
    """The shape's reads and haps (seed 7, as the engine decision test);
    the mixed shape cuts its reads to 53-150 bases in three buckets, and
    the last is ``testing.long_hap_set``."""
    if name.endswith("resets"):
        return long_hap_set(7, n_reads, n_haps, haplen, rdlen)
    reads, haps = engine_region(7, n_reads, n_haps, rdlen, haplen)
    if name.endswith("mixed"):
        for k, rd in enumerate(reads):
            n = (60, 100, 150)[k % 3] - k % 7
            reads[k] = {key: v[:n] for key, v in rd.items()}
    return reads, haps


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
        raise SystemExit("time_pairhmm_shared needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = card_name()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forced = "warps_per_read" in inspect.signature(
        ph.pairhmm_shared_f32).parameters
    rows = []

    def emit(**row):
        row = dict(label=opts.label, **row, card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)

    for name, n_r, n_h, rdlen, haplen in SHAPES:
        reads, haps = normalize(*region(name, n_r, n_h, rdlen, haplen))
        picks_shared = use_shared_kernel([len(r["bases"]) for r in reads],
                                         haps)
        a_sh = ph.stage_shared(reads, haps, dev)
        n_bands = (a_sh[0].shape[-1] - 2) // 32
        chosen = ph.shared_warps(n_r, n_bands, sms) if forced else 1
        ms, runs = timed(lambda: ph.pairhmm_shared_f32(*a_sh))
        emit(shape=name, kernel="shared", warps=chosen, ms=ms, ms_runs=runs,
             out_sha=checksum(ph.pairhmm_shared_f32(*a_sh)),
             estimate_picks_shared=picks_shared)
        if opts.sweep and forced:
            cols = a_sh[3].shape[0]
            for w in range(1, n_bands + 1):
                ms, runs = timed(
                    lambda: ph.pairhmm_shared_f32(*a_sh, warps_per_read=w))
                emit(shape=name, kernel="shared", warps=w, ms=ms,
                     ms_runs=runs, out_sha=checksum(
                         ph.pairhmm_shared_f32(*a_sh, warps_per_read=w)),
                     carry=("shared" if ph.shared_carry_in_shared(
                         n_r, cols, w, dev) else "global"))
        pairs = [(r, h) for r in range(n_r) for h in range(n_h)]
        a_pp = ph.stage_pairs(reads, haps, pairs, CTX_F32, dev)
        ms, runs = timed(lambda: ph.pairhmm_banded_f32(*a_pp))
        emit(shape=name, kernel="per_pair", ms=ms, ms_runs=runs,
             out_sha=checksum(ph.pairhmm_banded_f32(*a_pp)),
             estimate_picks_shared=picks_shared)
        del a_sh, a_pp
        torch.cuda.empty_cache()
    report = json.dumps({"label": opts.label, "card": card, "rows": rows})
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(report + "\n")
    print(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
