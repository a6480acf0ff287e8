#!/usr/bin/env python3
"""Drive mgl_tpu_torch's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout, one card

The quickest proof that the port still starts on the card.  It builds the
three CUDA kernels from ``mgl_tpu_torch/csrc``, holds each against its
plain torch version on the card, runs the goldens through both GATK entry
points (``SmithWatermanAligner.align_batch``,
``PairHmmEngine.compute_likelihoods``), then drives the main path at a
realistic size and times it.  Phases:

0. environment (card, power limit, CUDA, nvcc, native host library);
1. build of the kernels;
2. each kernel vs its plain version on the card, bit for bit;
3. all SW golden cases, CIGAR and offset exact;
4. PairHMM known answers and golden rows through the cascade;
5. the main path at a realistic size, with launch counts and times.

Any failed phase raises and the script exits non-zero.  The last line is
one JSON object naming the device; the line before it lists the kernels
with their launches, errors and times.  Imports no jax, and reaches the
JAX package's jax-free host modules (bucketing, contexts, the native
CIGAR decoder) only through ``mgl_tpu_torch``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SW_PARAMS = (25, -50, 110, 6)          # STANDARD_NGS


def log(msg: str) -> None:
    print(msg, flush=True)


def compare_sw(args, indel_init: bool, with_traceback: bool) -> int:
    """Kernel vs plain on the card: the largest |ez| difference plus the
    number of real traceback cells that differ (0 when bit-equal)."""
    import torch

    from mgl_tpu_torch.kernels.sw_cuda import sw_banded, sw_banded_plain
    from mgl_tpu_torch.ops.sw import banded_layout
    from mgl_tpu_torch.testing import traceback_mismatches

    kw = dict(indel_init=indel_init, with_traceback=with_traceback)
    ez_k, w_k = sw_banded(*args, *SW_PARAMS, **kw)
    ez_p, w_p = sw_banded_plain(*args, *SW_PARAMS, **kw)
    torch.cuda.synchronize()
    err = int((ez_k.long() - ez_p.long()).abs().max())
    if with_traceback:
        wpb = banded_layout(args[0].shape[1], args[1].shape[1])[1]
        err += traceback_mismatches(w_k, w_p, args[2], args[3], wpb)
    return err


def compare_pairhmm(args, f64: bool) -> float:
    import torch

    from mgl_tpu_torch.kernels import pairhmm_cuda as ph

    kernel = ph.pairhmm_banded_f64 if f64 else ph.pairhmm_banded_f32
    got = kernel(*args)
    want = ph.forward_plain(*args)
    torch.cuda.synchronize()
    return float((got.double() - want.double()).abs().max())


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
    from mgl_tpu_torch.kernels import pairhmm_cuda as ph
    from mgl_tpu_torch.kernels import sw_cuda
    from mgl_tpu_torch.ops.pairhmm import normalize, pair_likelihoods
    from mgl_tpu_torch.tables import CTX_F32, CTX_F64, MIN_ACCEPTED
    from mgl_tpu_torch.testing import (ACGT, cuda_ms, engine_region,
                                       golden_groups, golden_read,
                                       load_golden, sw_pairs, sw_tensors, u8)

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # ---- phase 0: environment ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    if not sw_cuda.host_decoder_ready():
        raise RuntimeError("native host library unavailable: the aligner "
                           "would have no CIGAR decoder")
    card = f"{smi} (nvidia-smi name, power.limit)"
    log(f"[0 env] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {nvcc[-1]}; native host library loaded")
    log(smi)

    # ---- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[1 build] {_build.library_path().name} ready in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")

    # ---- phase 2: each kernel vs its plain version, bit for bit ----------
    err = {"sw_banded": 0.0, "pairhmm_banded_f32": 0.0,
           "pairhmm_banded_f64": 0.0}
    targets, queries = sw_pairs(11, 1024, (40, 250), (40, 250))
    args = sw_tensors(targets, queries, dev)
    for strategy in OverhangStrategy:
        indel = bool(strategy & (OverhangStrategy.INDEL
                                 | OverhangStrategy.LEADING_INDEL))
        for tb in (True, False):
            e = compare_sw(args, indel, tb)
            if e:
                raise AssertionError(f"SW kernel != plain ({strategy.name}, "
                                     f"traceback={tb}): {e}")
            err["sw_banded"] = max(err["sw_banded"], e)
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
    for reads, haps, pairs in (
            (kat_reads, kat_haps, [(k, k) for k in range(len(kat))]),
            (rnd_reads, rnd_haps, rnd_pairs)):
        e = compare_pairhmm(ph.stage_pairs(*normalize(reads, haps), pairs,
                                           CTX_F32, dev), f64=False)
        if e:
            raise AssertionError(f"PairHMM f32 kernel != plain: {e}")
        err["pairhmm_banded_f32"] = max(err["pairhmm_banded_f32"], e)
    golden = load_golden("pairhmm_golden.jsonl")
    g_reads = [golden_read(r) for r in golden]
    g_haps = [u8(r["hap"]) for r in golden]
    gn_reads, gn_haps = normalize(g_reads, g_haps)
    diag = [(k, k) for k in range(len(golden))]
    e = compare_pairhmm(ph.stage_pairs(gn_reads, gn_haps, diag, CTX_F64, dev),
                        f64=True)
    if e:
        raise AssertionError(f"PairHMM f64 kernel != plain: {e}")
    err["pairhmm_banded_f64"] = e
    log(f"[2 kernel==plain, tolerance 0 (bit for bit)] SW {len(targets)} "
        f"pairs 40-250 bp x 4 strategies x 2 modes: ez and real-cell nibbles "
        f"equal; PairHMM f32 on {len(kat)} KAT + {len(rnd_pairs)} random "
        f"ragged pairs: equal; PairHMM f64 on {len(golden)} golden rows: "
        f"equal")

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
    log(f"[4 pairhmm golden] KAT {int((kat_err < 1e-5).sum())}/{len(kat)} "
        f"within 1e-5 log10 (max {kat_err.max():.2e}); golden rescue "
        f"decisions {decisions}/{len(golden)} ({int(rescued.sum())} rescued); "
        f"log10 vs scalard max {g_err.max():.2e}")

    # ---- phase 5: the main path at a realistic size -----------------------
    p_std = SWParameters(*SW_PARAMS)
    soft = OverhangStrategy.SOFTCLIP
    sw_t, sw_q = sw_pairs(21, 10_000, (150, 150), (150, 150))
    long_t, long_q = sw_pairs(22, 64, (8000, 8000), (2000, 2000))
    regions = [engine_region(100 + k) for k in range(8)]

    sw_cuda.sw_banded.launches = 0
    ph.pairhmm_banded_f32.launches = 0
    ph.pairhmm_banded_f64.launches = 0
    t0 = time.perf_counter()
    sw_out = aligner.align_batch(sw_t, sw_q, p_std, soft)
    t_sw = time.perf_counter() - t0
    t0 = time.perf_counter()
    long_out = aligner.align_batch(long_t, long_q, p_std, soft)
    t_long = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng_out = [eng.compute_likelihoods(r, h) for r, h in regions]
    t_eng = time.perf_counter() - t0
    launches = {"sw_banded": sw_cuda.sw_banded.launches,
                "pairhmm_banded_f32": ph.pairhmm_banded_f32.launches,
                "pairhmm_banded_f64": ph.pairhmm_banded_f64.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # what came out is right: shapes, values, and a sample held to the
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
    same = (got == want) | (np.abs(got - want) < 1e-5)
    if not same.all():
        raise AssertionError(f"engine sample {picks}: {got} vs {want}")
    n_resc = sum(r % 16 == 0 for r, _ in picks)     # the random reads
    n_eng = sum(o.size for o in eng_out)
    log(f"[5 main path] launches {launches}; first run: SW {len(sw_t)} x "
        f"150 bp {t_sw:.3f} s, SW {len(long_t)} x 8000x2000 {t_long:.3f} s, "
        f"engine {len(regions)} regions 512x12 {t_eng:.3f} s; {len(sample)} SW "
        f"and {len(picks)} engine pairs ({n_resc} from the random tail) equal "
        f"the plain path on the CPU")
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

    # kernel and plain times at the main path's shapes
    ms, plain_ms = {}, {}
    for label, ts, qs, iters, p_warm in (("150x150", sw_t, sw_q, 5, 1),
                                         ("8000x2000", long_t, long_q, 2, 0)):
        args = sw_tensors(ts, qs, dev)
        cells = sum(len(t) * len(q) for t, q in zip(ts, qs))
        for tb in (True, False):
            kw = dict(indel_init=False, with_traceback=tb)
            k_ms = cuda_ms(lambda: sw_cuda.sw_banded(*args, *SW_PARAMS, **kw),
                           iters)
            p_ms = cuda_ms(lambda: sw_cuda.sw_banded_plain(
                *args, *SW_PARAMS, **kw), 1, warmup=p_warm)
            e = compare_sw(args, False, tb)
            if e:
                raise AssertionError(f"SW kernel != plain at {label} "
                                     f"(traceback={tb}): {e}")
            mode = "traceback" if tb else "score-only"
            log(f"    SW {mode} {len(ts)} x {label}: kernel {k_ms:.3f} ms = "
                f"{cells / k_ms / 1e6:.2f} GCUPS; plain torch {p_ms:.3f} ms = "
                f"{cells / p_ms / 1e6:.2f} GCUPS; equal; card {card}")
            if tb and label == "150x150":
                ms["sw_banded"], plain_ms["sw_banded"] = k_ms, p_ms

    reads0, haps0 = normalize(reads0, haps0)
    prod = [(r, h) for r in range(512) for h in range(12)]
    a32 = ph.stage_pairs(reads0, haps0, prod, CTX_F32, dev)
    tail = [(r, h) for r in range(0, 512, 16) for h in range(12)]
    a64 = ph.stage_pairs(reads0, haps0, tail, CTX_F64, dev)
    for name, a, pairs, kern in (
            ("pairhmm_banded_f32", a32, prod, ph.pairhmm_banded_f32),
            ("pairhmm_banded_f64", a64, tail, ph.pairhmm_banded_f64)):
        cells = len(pairs) * 151 * 420
        k_ms = cuda_ms(lambda: kern(*a), 5)
        p_ms = cuda_ms(lambda: ph.forward_plain(*a), 1)
        e = compare_pairhmm(a, f64=name.endswith("f64"))
        if e:
            raise AssertionError(f"{name} != plain at the region shape: {e}")
        err[name] = max(err[name], e)
        ms[name], plain_ms[name] = k_ms, p_ms
        log(f"    {name} {len(pairs)} pairs 151x420: kernel {k_ms:.3f} ms = "
            f"{cells / k_ms / 1e6:.2f} GCUPS; plain torch {p_ms:.3f} ms = "
            f"{cells / p_ms / 1e6:.2f} GCUPS; equal; card {card}")

    if "jax" in sys.modules:
        raise AssertionError("the port's main path imported jax")
    replaces = {
        "sw_banded": ("mgl_tpu_torch/csrc/sw_banded.cu",
                      "mgl_tpu/kernels/sw_pallas.py:252"),
        "pairhmm_banded_f32": ("mgl_tpu_torch/csrc/pairhmm_banded.cu",
                               "mgl_tpu/kernels/pairhmm_pallas.py:175"),
        "pairhmm_banded_f64": ("mgl_tpu_torch/csrc/pairhmm_banded.cu",
                               "mgl_tpu/kernels/pairhmm_xf_pallas.py:61"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": ms[name], "plain_ms": plain_ms[name]}
        for name, (src, rep) in replaces.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
