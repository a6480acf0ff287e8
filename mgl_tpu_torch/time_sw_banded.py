"""Device time of the SW kernels - the banded kernel
(``kernels.sw_cuda.sw_banded``) and the plane kernel in its three modes
(``sw_plane`` with and without traceback, ``sw_plane_scores``) - at
three shapes, with a checksum of what each wrote.

    python -m mgl_tpu_torch.time_sw_banded [--label NAME] [--out FILE]

Shapes: 10,000 pairs of 150 x 150 bp in one launch (the aligner's short
reads), 64 pairs of 8000 x 2000 (long reads, few pairs) and 2,048 pairs
of 1,000 x 10,000 (one full aligner bucket of long queries).  Each is
timed by CUDA events: after a warm-up call, three times the mean of 20, 5
and 2 calls; ``ms`` is the median of the three, ``ms_runs`` all three.
The wrapper picks W.  The banded kernel runs with and without traceback.
The plane kernel's rows carry, beside the wrapper's time (``ms``: the
outputs' allocation and zero fill, then the kernel), the kernel alone
into preallocated outputs (``kernel_ms``, the same median) and the zero
fill of those outputs alone (``fill_ms``, the device's memset; the
wrapper's allocation is in ``ms`` only); where the wrapper takes ``warps_per_pair``, a
sweep over every W up to the bands (``sweep``: W -> kernel ms, one mean
each, every W's outputs held to the wrapper's).  Every line carries
checksums of what the kernel wrote, so two builds run one after the
other on the same card can be held to each other; the script uses only
wrapper arguments of the first port where no sweep runs, so it runs on
any version of the package.  The last line is the report as one JSON
object; ``--out`` writes it to a file too.  Needs one NVIDIA GPU;
imports no jax.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json

import torch

from mgl_tpu_torch.device import card_name
from mgl_tpu_torch.kernels import sw_cuda
from mgl_tpu_torch.testing import cuda_ms, plane_outputs, sw_pairs, sw_tensors

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


def _sha(x: torch.Tensor) -> str:
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]


def plane_checksums(mode: int, outs) -> dict:
    if mode == 0:
        return dict(ez_sha=_sha(outs[0]), words_sum=words_checksum(outs[1]))
    if mode == 1:
        return dict(lc_sum=words_checksum(outs[0]),
                    lr_sum=words_checksum(outs[1]))
    return dict(best_sha=_sha(outs[0]))


def plane_rows(label: str, name: str, args, iters: int, card: str) -> list:
    """The plane kernel's rows at one shape: wrapper, kernel alone and
    zero fill, and the W sweep where the wrapper takes W."""
    n, t = args[0].shape
    q = args[1].shape[1]
    dev = args[0].device
    sweeps = "warps_per_pair" in inspect.signature(sw_cuda._sw_plane).parameters
    rows = []
    for mode, mode_name in enumerate(("traceback", "samples", "scores")):
        if mode == 2:
            call = lambda: sw_cuda.sw_plane_scores(*args, *SW, indel_init=False)
        else:
            call = lambda: sw_cuda.sw_plane(*args, *SW, indel_init=False,
                                            with_traceback=mode == 0)
        runs = [cuda_ms(call, iters, warmup=int(k == 0)) for k in range(3)]
        outs = plane_outputs(mode, n, t, q, dev)
        kernel = lambda **kw: sw_cuda._sw_plane(
            mode, *args, *SW, False, outs, **kw)
        k_runs = [cuda_ms(kernel, iters, warmup=int(k == 0)) for k in range(3)]
        fill = cuda_ms(lambda: [o.zero_() for o in outs], iters)
        sums = plane_checksums(mode, outs)
        row = dict(label=label, shape=name, mode=f"plane {mode_name}",
                   warps=None, ms=sorted(runs)[1], ms_runs=runs,
                   kernel_ms=sorted(k_runs)[1], kernel_ms_runs=k_runs,
                   fill_ms=fill, **sums, card=card)
        if sweeps:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            row["warps"] = sw_cuda.pipeline_warps("sw_plane", n, t, q, None,
                                                  sms)
            row["sweep"] = {}
            for w in sw_cuda.BANDED_WARPS:
                if w > -(-t // 32):
                    break
                outs = plane_outputs(mode, n, t, q, dev)
                row["sweep"][w] = cuda_ms(
                    lambda: kernel(warps_per_pair=w), iters)
                if plane_checksums(mode, outs) != sums:
                    raise AssertionError(f"plane {mode_name} at {name}: "
                                         f"W={w} != the wrapper's W")
        print(json.dumps(row), flush=True)
        rows.append(row)
        del outs
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_sw_banded needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = card_name()
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
            row = dict(label=opts.label, shape=name,
                       mode="traceback" if tb else "score-only", warps=w,
                       ms=sorted(runs)[1], ms_runs=runs, ez_sha=_sha(ez),
                       words_sum=words_checksum(words) if tb else None,
                       card=card)
            print(json.dumps(row), flush=True)
            rows.append(row)
            del ez, words
        torch.cuda.empty_cache()
        rows += plane_rows(opts.label, name, args, iters, card)
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
