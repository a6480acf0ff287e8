"""Scale runs of BASELINE.json configs 4 and 5 on the card.

The port of ``tools/run_scale_configs.py``, with its configs, flags,
report keys and seeds:

* ``config4`` - 1,048,576 simulated 150 bp reads at 1% substitutions
  against a simulated 64 Mbp reference through ``map_reads_stream``
  (the window gather and ``sw_banded`` in score-only mode on the card):
  the median reads/s of ``--passes`` passes after one warm chunk, the
  trials, the host stages of the median pass, window accuracy against the
  simulation's truth, the index build, the warm-up and the process's peak
  RSS.  ``--big`` runs it at ``--big-mbp`` (512, and 3100 for the human
  genome's size).
* ``config4_cigar`` (``--cigar``) - the same mapper with
  ``with_cigar=True`` (``sw_banded`` in traceback mode and the CIGAR walk
  for the traceback tier): a quarter of ``--reads`` with 2% of them
  carrying a 1-2 bp deletion (``base``), all of ``--reads`` (``1m``), and
  a quarter at 5% substitutions with 10% carrying a 1-8 bp deletion
  (``hierr``); the tier split.  With the default flags these are
  ``tools/run_scale_configs.py``'s 262,144, 1,048,576 and 262,144 reads
  on 64 Mbp.
* ``config5`` - ``sort_records_single`` on config 4's mapped coordinates,
  cold then warm, and its device part ``parallel/sort.sort_device`` (a
  stable ``torch.sort`` and the payload gather, the counterpart of
  ``lax.sort((hi, lo, v), num_keys=2)``) on ``--sort-keys`` synthetic
  coordinate keys on the device: the first call, then the median of 20
  calls each timed between CUDA events.
* ``config5_mesh`` (``--mesh-only``) - ``parallel/sort.sort_records`` of
  ``--sort-keys`` random keys on a mesh of 8 gloo ranks on the CPU.  It is
  the counterpart of the JAX package's 8-device virtual CPU mesh, and runs
  on the CPU on every host by that config's design: the sort path of N
  hosts without N hosts.  It takes no ``--device`` but ``cpu``.

    python -m mgl_tpu_torch.scale_configs            # configs 4 and 5
    python -m mgl_tpu_torch.scale_configs --cigar --cigar-mode all
    python -m mgl_tpu_torch.scale_configs --mesh-only
    python -m mgl_tpu_torch.scale_configs --big --big-mbp 3100
    python -m mgl_tpu_torch.scale_configs --device cpu --reads 256 \\
        --ref-mbp 0.05 --sort-keys 10000 --passes 1   # plain versions

Each run merges its entries into the JSON report ``--out`` (default
``build/scale_report.json``) and prints them.  Beside the JAX report's
keys, each entry names the ``backend`` it ran on (``cuda`` or ``cpu``),
each mapper entry the ``launches`` of ``sw_banded``, ``window_gather`` and
``cigar_walk`` during its timed passes, and the report's top level the
``backend`` and ``card`` (``nvidia-smi``'s name and power limit) of its
last run on a device.  ``--device cuda`` (the default) without a card
raises; ``cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import resource
import sys
import tempfile
import time

import numpy as np
import torch

from mgl_tpu_torch.device import card_name, resolve_device
from mgl_tpu_torch.kernels.cigar_walk_cuda import cigar_walk
from mgl_tpu_torch.kernels.sw_cuda import sw_banded
from mgl_tpu_torch.kernels.window_cuda import window_gather
from mgl_tpu_torch.parallel.sort import (host_key, key_to_host,
                                         sort_device, sort_records_single)
from mgl_tpu_torch.pipelines.align_sort import coordinate_keys
from mgl_tpu_torch.pipelines.mapper import ReferenceIndex, map_reads_stream
from mgl_tpu_torch.testing import simulate
from mgl_tpu_torch.utils.metrics import METRICS

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "build" / "scale_report.json"
KERNELS = {"sw_banded": sw_banded, "window_gather": window_gather,
           "cigar_walk": cigar_walk}
MESH_RANKS = 8
# ~14x the 10M-key run on an 8-core host (21.6 s from the first spawn),
# and under chip_smoke.py's limit for the whole process, so that the
# ranks are ended here
MESH_TIMEOUT_S = 300.0
# separately timed calls of the 10M-key device sort; the median is reported
SORT_REPEATS = 20


def _check(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _launches() -> dict:
    return {n: k.launches for n, k in KERNELS.items()}


def _call_s(fn, dev: torch.device) -> float:
    """Seconds of one fn() call: between CUDA events on the card, on the
    host clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _max_rss_gb() -> float:
    """The process's peak RSS in GiB (``ru_maxrss``: a process forked from
    a larger one starts from that one's peak)."""
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
                 2)


def config4(n_reads: int, ref_len: int, chunk: int = 131072,
            read_len: int = 150, seed: int = 0, passes: int = 3,
            device: str | torch.device = "cuda"):
    """Config 4's report, and the last pass's (pos, score)."""
    from mgl_tpu_torch import _build

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    print(f"simulating ref {ref_len/1e6:.0f} Mbp + {n_reads} reads ...",
          flush=True)
    ref, reads, true_pos = simulate(rng, ref_len, n_reads, read_len)

    t0 = time.perf_counter()
    index = ReferenceIndex.build(ref, k=16)
    t_index = time.perf_counter() - t0
    print(f"index build: {t_index:.1f}s ({len(index.sorted_kmers)} kmers)",
          flush=True)

    # the first chunk pays for the CUDA context, the device reference and,
    # on a cold build directory, nvcc; then several passes, since host
    # rates spread: the median is the headline, the trials stay
    built = dev.type == "cuda" and not _build.library_path().exists()
    t_warm = time.perf_counter()
    map_reads_stream(index, reads[:chunk], chunk=chunk, device=dev)
    t_warm = time.perf_counter() - t_warm
    trials, all_stages = [], []
    _reset_launches()
    for p in range(max(passes, 1)):
        METRICS.reset()
        t0 = time.perf_counter()
        out = map_reads_stream(index, reads, chunk=chunk, device=dev)
        t_map = time.perf_counter() - t0
        trials.append(round(n_reads / t_map, 1))
        stages = {k.split(".", 1)[1]: round(v, 2)
                  for k, v in METRICS.snapshot()["timers_s"].items()
                  if k.startswith("map.")}
        # host stages that run while the card verifies the chunk before
        stages["host_while_chip_busy"] = round(
            stages.get("seed", 0) + stages.get("host_tier", 0), 2)
        all_stages.append(stages)
        print(f"  pass {p}: mapped {n_reads} in {t_map:.1f}s "
              f"({n_reads/t_map:.0f} reads/s) stages={stages}", flush=True)
    launches = _launches()
    med = float(np.median(trials))
    stages = all_stages[int(np.argsort(trials)[len(trials) // 2])]

    pos, score = out["pos"], out["score"]
    mapped = pos >= 0
    # the window start is fuzzy by design (diagonal bin + pad): a read is
    # correct if its true start lies inside its verified window
    window = read_len + 2 * 24
    ok = mapped & (true_pos >= pos) & (true_pos <= pos + window - read_len)
    return {
        "n_reads": int(n_reads),
        "ref_mbp": ref_len / 1e6,
        "index_build_s": round(t_index, 2),
        "map_s": round(n_reads / med, 2),
        "reads_per_s": round(med, 1),
        "trials_reads_per_s": trials,
        "warmup_s": round(t_warm, 2),
        "kernels_built_in_warmup": built,
        "mapped_frac": round(float(mapped.mean()), 4),
        "window_accuracy": round(float(ok.sum() / max(mapped.sum(), 1)), 4),
        "max_rss_gb": _max_rss_gb(),
        "stage_s": stages,
        "launches": launches,
        "backend": dev.type,
    }, pos, score


def config4_cigar(n_reads: int = 262_144, ref_len: int = 64_000_000,
                  chunk: int = 131072, read_len: int = 150,
                  indel_frac: float = 0.02, err: float = 0.01,
                  max_indel: int = 2, seed: int = 4,
                  device: str | torch.device = "cuda") -> dict:
    """Full-CIGAR mapping at scale: every mapped read gets a CIGAR (the
    certified-diagonal tier for exact and SNP reads, the banded traceback
    for the rest); reads/s and the tier split.  ``err`` and ``max_indel``
    sweep the error model."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    print(f"[cigar] simulating ref {ref_len/1e6:.0f} Mbp + {n_reads} reads"
          f" (err={err}, indel_frac={indel_frac}, max_indel={max_indel})",
          flush=True)
    ref, reads, true_pos = simulate(rng, ref_len, n_reads, read_len,
                                    err=err)
    # the first n_ind reads are overwritten by exact reads with a deletion
    # of 1..max_indel bp after base 70, clamped so that the deleted read's
    # reference footprint (read_len + d) stays inside the reference
    n_ind = int(n_reads * indel_frac)
    dlen = rng.integers(1, max_indel + 1, n_ind)
    for i in range(n_ind):
        d = int(dlen[i])
        s = min(int(true_pos[i]), ref_len - read_len - d)
        true_pos[i] = s
        reads[i] = np.concatenate([ref[s: s + 70],
                                   ref[s + 70 + d: s + read_len + d]])
    t0 = time.perf_counter()
    index = ReferenceIndex.build(ref, k=16)
    t_index = time.perf_counter() - t0
    t_warm = time.perf_counter()
    map_reads_stream(index, reads[:chunk], chunk=chunk, with_cigar=True,
                     device=dev)
    t_warm = time.perf_counter() - t_warm
    METRICS.reset()
    _reset_launches()
    t0 = time.perf_counter()
    out = map_reads_stream(index, reads, chunk=chunk, with_cigar=True,
                           device=dev)
    t_map = time.perf_counter() - t0
    launches = _launches()
    mapped = out["pos"] >= 0
    have_cigar = np.array([bool(c) for c in out["cigar"]])
    n_tb = int(METRICS.counters.get("map.tb_reads", 0))
    tb_s = METRICS.timers.get("map.traceback", 0.0)
    _check(have_cigar[mapped].all(), "mapped read without CIGAR")
    with_d = sum("D" in out["cigar"][i] or "I" in out["cigar"][i]
                 for i in range(n_ind) if mapped[i])
    n_mapped = int(mapped.sum())
    return {
        "n_reads": int(n_reads),
        "err": err,
        "max_indel": int(max_indel),
        "map_cigar_s": round(t_map, 2),
        "reads_per_s": round(n_reads / t_map, 1),
        "mapped_frac": round(float(mapped.mean()), 4),
        "cigar_complete": True,
        "indel_reads": int(n_ind),
        "indel_cigars_with_gap": int(with_d),
        "traceback_tier_reads": n_tb,
        "traceback_tier_share": round(n_tb / max(n_mapped, 1), 4),
        "traceback_tier_s": round(tb_s, 2),
        "traceback_overflow_reads": int(
            METRICS.counters.get("map.tb_overflow", 0)),
        "index_build_s": round(t_index, 2),
        "warmup_s": round(t_warm, 2),
        "max_rss_gb": _max_rss_gb(),
        "launches": launches,
        "backend": dev.type,
    }


def config5(pos: np.ndarray, n_sort: int = 10_000_000,
            device: str | torch.device = "cuda") -> dict:
    """The end-to-end sort of ``pos``'s coordinate keys, and the
    device-resident sort of ``n_sort`` synthetic keys."""
    dev = resolve_device(device)
    n = len(pos)
    keys = coordinate_keys(np.zeros(n), pos, np.arange(n) & 0xFFFF)
    vals = np.arange(n, dtype=np.int32)

    # end to end, host arrays to host arrays: the first call pays for the
    # sort's first use at this shape, the second is the steady state
    t0 = time.perf_counter()
    skeys, order = sort_records_single(keys, vals, device=dev)
    t_e2e = time.perf_counter() - t0
    t0 = time.perf_counter()
    skeys, order = sort_records_single(keys, vals, device=dev)
    t_e2e_warm = time.perf_counter() - t0
    _check(np.all(skeys[1:] >= skeys[:-1]), "sorted keys descend")
    _check(np.array_equal(np.sort(keys), skeys), "sort != np.sort")
    _check(np.array_equal(keys[order], skeys), "payload permutation broken")

    # n_sort synthetic coordinate keys (contig, position, tiebreak), the
    # JAX script's bit layout, sorted where they live: on the device
    rng = np.random.default_rng(1)
    big = ((rng.integers(0, 24, n_sort).astype(np.uint64) << np.uint64(48))
           | (rng.integers(0, 1 << 26, n_sort).astype(np.uint64)
              << np.uint64(16))
           | (np.arange(n_sort, dtype=np.uint64) & np.uint64(0xFFFF)))
    dk = host_key(big).to(dev)
    dv = torch.arange(n_sort, dtype=torch.int32, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    out = sort_device(dk, dv)
    _sync(dev)
    t_first = time.perf_counter() - t0
    # each repeat timed on its own, so that one slow call shows as spread
    # and not in the median
    trials = [_call_s(lambda: sort_device(dk, dv), dev)
              for _ in range(SORT_REPEATS)]
    t_10m = float(np.median(trials))
    sbig, sv = key_to_host(out[0]), out[1].cpu().numpy()
    _check(np.array_equal(sbig, np.sort(big)), "device sort != np.sort")
    _check(np.array_equal(big[sv], sbig), "device payload broken")
    _check(np.array_equal(np.sort(sv), np.arange(n_sort)),
           "device payload is not a permutation")
    return {
        "e2e_reads": int(n),
        "e2e_sort_s": round(t_e2e, 3),
        "e2e_sort_warm_s": round(t_e2e_warm, 3),
        "note": "e2e_sort_s is the first sort_records_single call (host "
                "arrays to host arrays); compare e2e_sort_warm_s run to run; "
                "sort_10m_device_s is the median of sort_10m_repeats "
                "separately timed parallel/sort.sort_device calls",
        "sort_keys": int(n_sort),
        "sort_10m_device_s": round(t_10m, 6),
        "sort_10m_first_call_s": round(t_first, 3),
        "sort_10m_mkeys_per_s": round(n_sort / t_10m / 1e6, 1),
        "sort_10m_repeats": SORT_REPEATS,
        "sort_10m_min_max_s": [round(min(trials), 6), round(max(trials), 6)],
        "sort_10m_clock": "CUDA events" if dev.type == "cuda" else "host",
        "backend": dev.type,
    }


def _mesh_rank(rank: int, n_sort: int, out_path: str) -> None:
    """One gloo rank of :func:`config5_mesh`: every rank draws the same
    keys and calls ``sort_records``; rank 0 checks the result and writes
    its time from a barrier to the result."""
    import torch.distributed as dist

    from mgl_tpu_torch.parallel.mesh import make_mesh
    from mgl_tpu_torch.parallel.sort import sort_records

    world = dist.get_world_size()
    # the ranks share the host's cores
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1 << 62, n_sort).astype(np.uint64)
    vals = np.arange(n_sort, dtype=np.int32)
    mesh = make_mesh(world, 1, "cpu")
    dist.barrier()
    t0 = time.perf_counter()
    skeys, svals = sort_records(keys, vals, mesh, "dp")
    t = time.perf_counter() - t0
    if rank == 0:
        _check(np.array_equal(skeys, np.sort(keys)), "mesh sort != np.sort")
        _check(np.array_equal(keys[svals], skeys),
               "payload permutation broken")
        with open(out_path, "w") as f:
            json.dump({"s": t}, f)


def config5_mesh(n_sort: int = 10_000_000, ranks: int = MESH_RANKS,
                 timeout: float = MESH_TIMEOUT_S) -> dict:
    """``sort_records`` of ``n_sort`` keys on a mesh of ``ranks`` gloo
    ranks on the CPU."""
    from mgl_tpu_torch import scale_configs
    from mgl_tpu_torch.parallel.dryrun import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.json")
        t0 = time.perf_counter()
        # by the module's own name, also when it runs as __main__, so that
        # the spawned ranks import it
        run_ranks(scale_configs._mesh_rank, ranks, "cpu", (n_sort, path),
                  timeout=timeout)
        wall = time.perf_counter() - t0
        with open(path) as f:
            t = json.load(f)["s"]
    return {"mesh_sort_10m_devices": ranks, "mesh_sort_10m_s": round(t, 3),
            "mesh_sort_verified": True, "sort_keys": int(n_sort),
            "mesh_sort_10m_wall_s": round(wall, 3),
            "backend": "cpu",
            "note": f"{ranks}-way bitonic shard merge on gloo ranks, one "
                    "CPU process a rank; "
                    "rank 0's time from a barrier to the gathered result; "
                    "wall from the first spawn; equal to np.sort"}


def big_entry_name(mbp: float) -> str:
    """``--big``'s report entry: ``config4_3gbp`` from 3000 Mbp on, else
    ``config4_<mbp>mbp``."""
    return "config4_3gbp" if mbp >= 3000 else f"config4_{int(mbp)}mbp"


def write_report(path: pathlib.Path, rep: dict) -> None:
    """Merge ``rep`` into the JSON report at ``path``."""
    if path.exists():
        rep = {**json.loads(path.read_text()), **rep}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rep, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mgl_tpu_torch.scale_configs")
    ap.add_argument("--reads", type=int, default=1_048_576)
    ap.add_argument("--ref-mbp", type=float, default=64.0)
    ap.add_argument("--sort-keys", type=int, default=10_000_000)
    ap.add_argument("--mesh-only", action="store_true",
                    help="run only the gloo-mesh distributed sort")
    ap.add_argument("--sort-only", action="store_true",
                    help="run only config 5, on synthetic positions")
    ap.add_argument("--big", action="store_true",
                    help="run only config 4 at --big-mbp")
    ap.add_argument("--big-mbp", type=float, default=512.0,
                    help="reference size for --big in Mbp (3100 = the "
                         "human genome's; the entry is config4_<size>)")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--cigar", action="store_true",
                    help="run only the full-CIGAR mapping configs")
    ap.add_argument("--cigar-mode", default="all",
                    choices=["base", "1m", "hierr", "all"],
                    help="which CIGAR configs: base (a quarter of "
                         "--reads), 1m (all of them), hierr (5%% SNPs + "
                         "1-8 bp deletions, a quarter), all")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the kernels) or cpu (their "
                         "plain versions); --mesh-only takes only cpu")
    ap.add_argument("--out", type=pathlib.Path, default=DEFAULT_OUT,
                    help="JSON report to merge into")
    args = ap.parse_args(argv)

    ref_len = int(args.ref_mbp * 1e6)
    if args.mesh_only:
        if args.device not in (None, "cpu"):
            ap.error("--mesh-only sorts on gloo ranks on the CPU by design; "
                     "leave --device out or give cpu")
        rep = {"config5_mesh_sort": config5_mesh(args.sort_keys)}
    else:
        dev = resolve_device(args.device or "cuda")
        rep = {"backend": dev.type,
               "card": card_name() if dev.type == "cuda" else None}
        if args.cigar:
            quarter = args.reads // 4
            if args.cigar_mode in ("base", "all"):
                rep["config4_cigar"] = config4_cigar(
                    quarter, ref_len, device=dev)
            if args.cigar_mode in ("1m", "all"):
                rep["config4_cigar_1m"] = config4_cigar(
                    args.reads, ref_len, device=dev)
            if args.cigar_mode in ("hierr", "all"):
                # the regime where the certified-diagonal tier stops
                # absorbing the load
                rep["config4_cigar_hierr"] = config4_cigar(
                    quarter, ref_len, err=0.05, indel_frac=0.10,
                    max_indel=8, seed=8, device=dev)
        elif args.big:
            rep[big_entry_name(args.big_mbp)] = config4(
                args.reads, int(args.big_mbp * 1e6), seed=3,
                passes=args.passes, device=dev)[0]
        else:
            if args.sort_only:
                pos = np.random.default_rng(9).integers(0, 1 << 26,
                                                        args.reads)
            else:
                c4, pos, _ = config4(args.reads, ref_len,
                                     passes=args.passes, device=dev)
                rep["config4_seed_extend_1m"] = c4
            rep["config5_align_sort"] = config5(pos, args.sort_keys,
                                                device=dev)
    write_report(args.out, rep)
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
