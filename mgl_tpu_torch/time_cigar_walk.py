"""Device time of the CIGAR walk kernel
(``kernels.cigar_walk_cuda.cigar_walk``, CIGAR mode's traceback
post-pass), with a checksum of its outputs and its bound.

    python -m mgl_tpu_torch.time_cigar_walk [--label NAME] [--out FILE]

Shapes: the smoke's 8,192-window chunk (``chip_smoke.compare_walk``: reads
of 150 bp at 1% substitutions, 2% with a 1-2 bp deletion, drawn with seed
44 from a 4 Mbp reference of seed 43, in windows of 198 starting 24 bases
before each read) and the 96 reads of ``testing.indel_read_set`` (120 bp
in windows of 168), each under SOFTCLIP (the mapper's strategy) and
INDEL, on the words of the banded SW kernel in traceback mode on the card
(``pipelines.mapper._sw_traceback_windows``).  Each walk is timed as
``time_pairhmm_banded`` times its kernels: after a warm-up call, the mean
of 20, of 5 and of 2 calls, each by ``testing.queued_ms``; ``ms`` is the
median of the three, ``ms_runs`` all three.  The bound is the smoke's: the
steps this data walks (``chip_smoke.walk_steps``) at 4 B and
``WALK_OPS_PER_STEP`` int32 operations a step, plus each pair's start,
segments and flags (``cigar_walk_cuda.walk_bytes``).  The script uses
only the wrapper arguments of the first port of the kernel, so it runs on
an older tree too, with this tree's ``testing.py`` beside it: two trees in
one call give parent / new / new / parent on one card.  The last line is
the report as one JSON object; ``--out`` writes it to a file too.  Needs
one NVIDIA GPU; imports no jax.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import pathlib
import sys

import numpy as np
import torch

from mgl_tpu_torch import _build
from mgl_tpu_torch.core.params import OverhangStrategy, SWParameters
from mgl_tpu_torch.device import card_name
from mgl_tpu_torch.kernels.cigar_walk_cuda import cigar_walk, walk_bytes
from mgl_tpu_torch.ops.cigar_device import walk_start
from mgl_tpu_torch.pipelines import mapper as mp
from mgl_tpu_torch.testing import (ACGT, deletion_reads, indel_read_set,
                                   queued_ms)

CALLS = (20, 5, 2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
READ_LEN = 150


def chunk_set():
    rng = np.random.default_rng(43)
    ref = ACGT[rng.integers(0, 4, 4_000_000, dtype=np.uint8)]
    reads, true_pos, _ = deletion_reads(44, ref, 8192, READ_LEN)
    wlen = READ_LEN + 48
    return ref, np.clip(true_pos - 24, 0, len(ref) - wlen), reads, wlen


SHAPES = (("chunk_8192_198x150", chunk_set),
          ("indel_96_168x120", indel_read_set))


def timed(call) -> tuple[float, list[float]]:
    call()
    runs = [queued_ms(call, n) for n in CALLS]
    return sorted(runs)[1], runs


def checksum(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_cigar_walk needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    smoke = importlib.import_module("chip_smoke")
    dev = torch.device("cuda")
    card = card_name()
    params = SWParameters(*smoke.SW_PARAMS)
    rows = []
    for name, make in SHAPES:
        ref, starts, reads, wlen = make()
        index = mp.ReferenceIndex.build(ref, k=16)
        for strategy in (OverhangStrategy.SOFTCLIP, OverhangStrategy.INDEL):
            ez, words, wpb = mp._sw_traceback_windows(
                index, starts, reads, wlen, params, strategy, dev)
            nb = len(reads)
            full = lambda v: torch.full((nb,), v, dtype=torch.int32,
                                        device=dev)
            args = (words, ez, full(wlen), full(reads.shape[1]))
            n_steps = wlen + reads.shape[1]
            run = lambda: cigar_walk(*args, strategy, n_steps,
                                     words_per_band=wpb)
            ms, runs = timed(run)
            out = run()
            steps = smoke.walk_steps(*out, *walk_start(ez, *args[2:],
                                                       int(strategy)))
            b_ms, b_by = smoke.bound(steps * smoke.WALK_OPS_PER_STEP, "int32",
                                     walk_bytes(steps, nb))
            row = dict(label=opts.label, shape=name, strategy=strategy.name,
                       pairs=nb, steps=steps, ms=ms, ms_runs=runs,
                       bound_ms=b_ms, bound_by=b_by, share=b_ms / ms,
                       overflowed=int(out[2].sum()), out_sha=checksum(*out),
                       card=card)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del ez, words, args, out
        torch.cuda.empty_cache()
    report = json.dumps({"label": opts.label, "card": card,
                         "resources": _build.kernel_resources("cigar_walk"),
                         "rows": rows})
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(report + "\n")
    print(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
