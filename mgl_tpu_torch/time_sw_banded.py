"""Device time of the banded SW kernel (``kernels.sw_cuda.sw_banded``) at
three shapes, in both modes, with a checksum of what it wrote.

    python -m mgl_tpu_torch.time_sw_banded [--label NAME] [--out FILE]

Shapes: 10,000 pairs of 150 x 150 bp in one launch (the aligner's short
reads), 64 pairs of 8000 x 2000 (long reads, few pairs) and 2,048 pairs
of 1,000 x 10,000 (one full aligner bucket of long queries).  Each is
timed with and without traceback by CUDA events: after a warm-up call,
three times the mean of 20, 5 and 2 calls; ``ms`` is the median of the
three, ``ms_runs`` all three.  The wrapper picks W.  Every line carries a
checksum of ez and of the traceback words, so two builds of the kernel run
one after the other on the same card can be held to each other; the
script uses only the wrapper's arguments of the first port, so it runs on
any version of the package.  The last line is the report as one JSON
object; ``--out`` writes it to a file too.  Needs one NVIDIA GPU; imports
no jax.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess

import torch

from mgl_tpu_torch.kernels import sw_cuda
from mgl_tpu_torch.testing import cuda_ms, sw_pairs, sw_tensors

SW = (25, -50, 110, 6)                  # STANDARD_NGS
# (name, pairs, target length, query length, seed, calls timed)
SHAPES = (("10000x150x150", 10_000, 150, 150, 21, 20),
          ("64x8000x2000", 64, 8000, 2000, 22, 5),
          ("2048x1000x10000", 2048, 1000, 10_000, 23, 2))


def shape_pairs(n: int, tlen: int, qlen: int, seed: int, dev):
    """n pairs of tlen x qlen, the shorter a mutated slice of the longer."""
    if qlen <= tlen:
        return sw_tensors(*sw_pairs(seed, n, (tlen, tlen), (qlen, qlen)), dev)
    queries, targets = sw_pairs(seed, n, (qlen, qlen), (tlen, tlen))
    return sw_tensors(targets, queries, dev)


def words_checksum(words: torch.Tensor) -> int:
    """A position-weighted sum of every traceback word, mod 2**61 - 1."""
    flat = words.reshape(words.shape[0], -1)
    n = flat.shape[1]
    weight = (torch.arange(n, device=words.device, dtype=torch.int64)
              * 2_654_435_761 % 2_147_483_629 + 1)
    total = 0
    for lo in range(0, flat.shape[0], 16):
        part = flat[lo:lo + 16].long() * weight
        total = (total + int(part.sum(dtype=torch.int64))) % (2 ** 61 - 1)
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_sw_banded needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, n, tlen, qlen, seed, iters in SHAPES:
        args = shape_pairs(n, tlen, qlen, seed, dev)
        warps = getattr(sw_cuda, "banded_warps", None)
        w = warps(n, -(-tlen // 32), sms) if warps else 1
        for tb in (True, False):
            kw = dict(indel_init=False, with_traceback=tb)
            call = lambda: sw_cuda.sw_banded(*args, *SW, **kw)
            runs = [cuda_ms(call, iters, warmup=int(k == 0)) for k in range(3)]
            ez, words = sw_cuda.sw_banded(*args, *SW, **kw)
            ez_sha = hashlib.sha256(ez.cpu().numpy().tobytes()).hexdigest()
            row = dict(label=opts.label, shape=name,
                       mode="traceback" if tb else "score-only", warps=w,
                       ms=sorted(runs)[1], ms_runs=runs, ez_sha=ez_sha[:16],
                       words_sum=words_checksum(words) if tb else None,
                       card=card)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del ez, words
        del args
        torch.cuda.empty_cache()
    report = json.dumps({"label": opts.label, "card": card, "rows": rows})
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(report + "\n")
    print(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
