"""Where the time goes on the card: both entry points, warm, at the
shapes ``chip_smoke.py`` drives.

    python -m mgl_tpu_torch.profile_e2e [--repeats 3] [--out FILE]
                                        [--workloads NAME,NAME]

Workloads: ``SmithWatermanAligner.align_batch`` on 10,000 pairs of 150 bp
(traceback + host CIGAR decode); ``PairHmmEngine.compute_likelihoods``
on 8 GATK-shaped regions of 512 reads x 12 haps (151 x 420 bp, every 16th
read in the f64 rescue tier), which take the shared-hap-set kernel;
``PairHmmEngine.compute_likelihoods_stream`` over the same 8 regions,
which overlaps each region's host work with the card's work on the one
before; the same 8 regions through ``PairHmmEngine(use_double=True)``
(every pair in the f64 per-pair kernel) and ``PairHmmEngine(fast_path=
True)`` (the seed-extend kernel, then the per-pair f32 kernel over the
pairs under the gate and the f64 rescue); and the SW plane path as ``chip_smoke.py`` phase 7 drives it:
the 1,972 SW goldens through ``sw_cuda.align_batch``, one launch a
parameter group (12), and the 10,000 pairs of 150 bp over the aligner's
buckets through ``sw_cuda.align_batch`` and ``sw_cuda.sw_plane_scores``
(``--workloads`` picks some of them by name; the plane ones run on an
older tree too).  Each runs once cold, then ``--repeats``
times warm on the host clock, then once more warm under
``torch.profiler``.  For that profiled call it prints the wall time, the
device busy time (the union of the kernel and copy intervals the profiler
saw on the card), the idle share 1 - busy / wall, the host stages (each
a ``record_function`` range put around one function of the path by this
script only) and the device ops by name.  The last line is the report as
one JSON object; ``--out`` writes it to a file too.  Needs one NVIDIA
GPU; imports no jax.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import torch

from mgl_tpu_torch import api
from mgl_tpu_torch.batch.bucketing import bucket_pairs
from mgl_tpu_torch.core.params import STANDARD_NGS
from mgl_tpu_torch.device import card_name
from mgl_tpu_torch.kernels import pairhmm_cuda, seed_extend_cuda, sw_cuda
from mgl_tpu_torch.ops import pairhmm
from mgl_tpu_torch.testing import (engine_region, golden_groups, load_golden,
                                   sw_pairs, sw_tensors)

# (module, function name) put under a record_function range of that name
# (nested ranges count in their parent's total too)
STAGES = ((api, "bucket_pairs"), (api, "_checked_reads"),
          (sw_cuda, "align_batch_banded"), (sw_cuda, "pack_sequences"),
          (sw_cuda, "decode_cigars"), (sw_cuda, "align_batch"),
          (sw_cuda, "_traceback"), (sw_cuda, "cigar_decode_bulk"),
          (sw_cuda, "sw_plane_scores"),
          (pairhmm, "normalize"), (pairhmm, "_dedup_haps"),
          (pairhmm, "use_shared_kernel"), (pairhmm, "_bucketed_start"),
          (pairhmm, "bucket_pairs"), (pairhmm, "_finish_start"),
          (pairhmm, "_fast_start"), (seed_extend_cuda, "fast_scores"),
          (seed_extend_cuda, "stage_fast"),
          (seed_extend_cuda, "seed_extend_f32"),
          (pairhmm_cuda, "stage_shared"),
          (pairhmm_cuda, "compute_haplotype_similarities"),
          (pairhmm_cuda, "segment_table"), (pairhmm_cuda, "stage_pairs"),
          (pairhmm_cuda, "stage_reads"), (pairhmm_cuda, "stack_tracks"),
          (pairhmm_cuda, "read_planes"), (pairhmm_cuda, "rescale_shared"),
          (pairhmm_cuda, "pairhmm_shared_f32"),
          (pairhmm_cuda, "pairhmm_banded_f32"),
          (pairhmm_cuda, "pairhmm_banded_f64"))


WORKLOADS = ("sw_10000x150_traceback", "engine_8x512x12",
             "engine_stream_8x512x12", "engine_double_8x512x12",
             "engine_fast_8x512x12", "plane_sw_goldens",
             "plane_sw_10000x150")


def _ranged(name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(f"stage:{name}"):
            return fn(*args, **kwargs)
    return wrapper


# device-side rows of the trace that are not work on the card: ranges
# mirrored from host annotations (aten ops, this script's stages) and
# runtime bookkeeping
_NOT_WORK = ("aten::", "stage:", "cuda", "Activity Buffer")


def _tally(prof) -> tuple[dict, dict, float | None]:
    """(host stages, device ops, device busy us) of a trace: each stage's
    and op's total us and count, and the union of the device intervals
    of kernels, copies and sets."""
    stages: dict = {}
    ops: dict = {}
    spans = []
    for e in prof.events():
        us = e.time_range.end - e.time_range.start
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(_NOT_WORK)):
                continue
            spans.append((e.time_range.start, e.time_range.end))
            into = ops
        elif e.name.startswith("stage:"):
            into = stages
        else:
            continue
        tot, n = into.get(e.name, (0.0, 0))
        into[e.name] = (tot + us, n + 1)
    if not spans:
        return stages, ops, None
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    return stages, ops, busy + hi - lo


def profile(name: str, call, n_pairs: int, repeats: int) -> dict:
    call()                                        # cold: builds, caches
    torch.cuda.synchronize()
    warm = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stages, ops, busy = _tally(prof)
    stages = {k: {"cpu_ms": us / 1e3, "count": n}
              for k, (us, n) in stages.items()}
    device = sorted(({"op": k, "device_ms": us / 1e3, "count": n}
                     for k, (us, n) in ops.items()),
                    key=lambda d: -d["device_ms"])
    return {"workload": name, "pairs": n_pairs, "warm_s": warm,
            "warm_pairs_per_s": [n_pairs / t for t in warm],
            "profiled_wall_s": wall,
            "device_busy_ms": None if busy is None else busy / 1e3,
            "device_idle_share": (None if busy is None
                                  else 1.0 - busy / 1e6 / wall),
            "stages": stages, "device_ops": device[:12]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", help="also write the JSON report here")
    ap.add_argument("--workloads", default=",".join(WORKLOADS),
                    help=f"comma-separated, of {', '.join(WORKLOADS)}")
    args = ap.parse_args(argv)
    names = args.workloads.split(",")
    if not set(names) <= set(WORKLOADS):
        ap.error(f"--workloads: of {', '.join(WORKLOADS)}")
    if not torch.cuda.is_available():
        print("profile_e2e needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = card_name()
    for mod, fn in STAGES:
        setattr(mod, fn, _ranged(fn, getattr(mod, fn)))

    dev = torch.device("cuda", 0)
    aligner = api.SmithWatermanAligner(device=dev)
    engine = api.PairHmmEngine(device=dev)
    engine_double = api.PairHmmEngine(use_double=True, device=dev)
    engine_fast = api.PairHmmEngine(fast_path=True, device=dev)
    sw_t, sw_q = sw_pairs(21, 10_000, (150, 150), (150, 150))
    regions = [engine_region(100 + k) for k in range(8)]
    params = STANDARD_NGS
    soft = api.OverhangStrategy.SOFTCLIP
    gold = [([r["target"].encode() for r in rs],
             [r["query"].encode() for r in rs],
             api.SWParameters.normalized(m, x, o, e), api.OverhangStrategy(s))
            for (m, x, o, e, s), rs in
            golden_groups(load_golden("sw_golden.jsonl")).items()]
    buckets = [([sw_t[k] for k in idx], [sw_q[k] for k in idx]) for _, idx
               in bucket_pairs([len(t) for t in sw_t], [len(q) for q in sw_q],
                               max_batch=aligner.max_batch)]

    def plane_150():
        out = []
        for ts, qs in buckets:
            out += sw_cuda.align_batch(ts, qs, params, soft, dev)
            sw_cuda.sw_plane_scores(*sw_tensors(ts, qs, dev), params.match,
                                    params.mismatch, params.gap_open,
                                    params.gap_extend, indel_init=False)
        return out

    calls = {
        "sw_10000x150_traceback": (
            lambda: aligner.align_batch(sw_t, sw_q, params, soft), len(sw_t)),
        "engine_8x512x12": (
            lambda: [engine.compute_likelihoods(r, h) for r, h in regions],
            sum(len(r) * len(h) for r, h in regions)),
        "engine_stream_8x512x12": (
            lambda: list(engine.compute_likelihoods_stream(iter(regions))),
            sum(len(r) * len(h) for r, h in regions)),
        "engine_double_8x512x12": (
            lambda: [engine_double.compute_likelihoods(r, h)
                     for r, h in regions],
            sum(len(r) * len(h) for r, h in regions)),
        "engine_fast_8x512x12": (
            lambda: [engine_fast.compute_likelihoods(r, h)
                     for r, h in regions],
            sum(len(r) * len(h) for r, h in regions)),
        "plane_sw_goldens": (
            lambda: [sw_cuda.align_batch(*g, dev) for g in gold],
            sum(len(g[0]) for g in gold)),
        "plane_sw_10000x150": (plane_150, len(sw_t)),
    }
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "workloads": [
                  profile(name, *calls[name], args.repeats)
                  for name in names]}

    print(f"card: {card} (nvidia-smi name, power.limit)")
    for w in report["workloads"]:
        idle = w["device_idle_share"]
        print(f"{w['workload']}: warm {', '.join(f'{t:.4f}' for t in w['warm_s'])}"
              f" s; profiled call {w['profiled_wall_s']:.4f} s, device busy "
              + ("not measured (no device events in the trace)" if idle is None
                 else f"{w['device_busy_ms']:.3f} ms, idle share {idle:.4f}"))
        for k, v in sorted(w["stages"].items(), key=lambda kv: -kv[1]["cpu_ms"]):
            print(f"    host {k[6:]}: {v['cpu_ms']:.3f} ms over {v['count']} calls")
        for d in w["device_ops"]:
            print(f"    device {d['op'][:70]}: {d['device_ms']:.3f} ms over "
                  f"{d['count']}")
    line = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
