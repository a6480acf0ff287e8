"""GATK HaplotypeCaller's two native calls, made a region at a time in
GATK's order, through the program's public entry points:

1. ``SmithWatermanAligner.align_batch`` of each haplotype against the
   padded region's reference (the configuration's hap-to-reference
   parameters and strategy);
2. ``PairHmmEngine.compute_likelihoods_stream`` over the regions in order
   (the reads x haplotypes log10 matrix, the f32 -> f64 cascade), each
   region's matrix handed back a few regions after its dispatch;
3. ``align_batch`` of each read against its best haplotype (the row's
   largest likelihood).

A region counts as done when its step 3 returns; its latency runs from
the start of its step 1.  The window feeds regions from the pool, in the
seed's order and round again, until ``seconds`` have passed, then drains
the stream: the rate is every region fed over the time to the last one's
end."""

from __future__ import annotations

import collections
import importlib
import sys
import time

import numpy as np
import torch

from mgl_tpu_torch.api import (OverhangStrategy, PairHmmEngine,
                               SmithWatermanAligner, SWParameters)
from gpubench.counts import work as counts
from gpubench.reference import pairhmm as ref_pairhmm, sw as ref_sw


class State:
    pass


def _params(p: dict) -> SWParameters:
    return SWParameters(p["match"], p["mismatch"], p["gap_open"],
                        p["gap_extend"])


def _ref_params(p: dict) -> tuple[int, int, int, int]:
    return (p["match"], p["mismatch"], p["gap_open"], p["gap_extend"])


def setup(config: dict, mix: dict, seed: int, device, spans) -> State:
    st = State()
    st.config, st.mix, st.seed, st.device = config, mix, seed, device
    st.pool = importlib.import_module(
        f"gpubench.traffic.{mix['generator']}").make(mix, config, seed)
    st.aligner = SmithWatermanAligner(device=device)
    st.engine = PairHmmEngine(use_double=config["engine"]["use_double"],
                              fast_path=config["engine"]["fast_path"],
                              device=device)
    st.hap_sw = (_params(config["hap_to_ref_sw"]),
                 OverhangStrategy[config["hap_to_ref_sw"]["strategy"]])
    st.read_sw = (_params(config["read_to_hap_sw"]),
                  OverhangStrategy[config["read_to_hap_sw"]["strategy"]])
    # warm-up: regions spread over the pool's range of shapes (haps,
    # reads, length), so that every kernel instance and buffer size the
    # window meets is loaded once
    order = sorted(range(len(st.pool)), key=lambda k: (
        len(st.pool[k]["haps"]), len(st.pool[k]["reads"]),
        len(st.pool[k]["ref"])))
    step = max(1, len(order) // mix["warm_regions"])
    _drive(st, None, spans, [st.pool[k] for k in order[::step]])
    return st


def _drive(st: State, deadline: float | None, spans, pool: list | None = None,
           keep: int = 0, rng=None) -> tuple[list, list]:
    """Regions of ``pool`` (the whole pool by default) through the three
    calls, round again until the clock passes ``deadline`` (once through
    without one).  Returns (pool index, best haps, end) of every region,
    and the whole outputs - (pool index, hap CIGARs, matrix, best haps,
    read CIGARs) - of ``keep`` of them drawn uniformly by ``rng`` (a
    reservoir, so that what is kept does not grow with the window)."""
    pool = st.pool if pool is None else pool
    P = len(pool)
    n_regions = P if deadline is None else None
    inflight: collections.deque = collections.deque()
    done, kept = [], []

    def feed():
        k = 0
        while (k < n_regions if n_regions is not None
               else time.perf_counter() < deadline):
            r = pool[k % P]
            t0 = time.perf_counter()
            with spans.span("sw.hap_ref"):
                sw1 = st.aligner.align_batch([r["ref"]] * len(r["haps"]),
                                             r["haps"], *st.hap_sw)
            inflight.append((k % P, sw1, t0))
            k += 1
            yield r["reads"], r["haps"]

    stream = st.engine.compute_likelihoods_stream(
        feed(), depth=st.config["engine"]["stream_depth"])
    while True:
        with spans.span("engine.next"):
            mat = next(stream, None)
        if mat is None:
            break
        idx, sw1, t0 = inflight.popleft()
        r = pool[idx]
        best = np.argmax(mat, axis=1)
        with spans.span("sw.read_hap"):
            sw2 = st.aligner.align_batch([r["haps"][b] for b in best],
                                         [rd["bases"] for rd in r["reads"]],
                                         *st.read_sw)
        t1 = time.perf_counter()
        spans.add("region", t0, t1)
        done.append((idx, best, t1))
        if keep:
            n, entry = len(done) - 1, (idx, sw1, mat, best, sw2)
            if n < keep:
                kept.append(entry)
            else:
                j = int(rng.integers(0, n + 1))
                if j < keep:
                    kept[j] = entry
    return done, kept


def run_window(st: State, seconds: float, spans) -> dict:
    rng = np.random.default_rng([st.seed, 1])
    t0 = time.perf_counter()
    st.done, st.kept = _drive(st, t0 + seconds, spans,
                              keep=st.mix["check_regions"], rng=rng)
    t1 = time.perf_counter()
    n = len(st.done)
    ends = np.array([d[2] for d in st.done]) - t0
    print("gpubench: regions a second:",
          np.histogram(ends, bins=int(np.ceil(t1 - t0)),
                       range=(0, np.ceil(t1 - t0)))[0].tolist(),
          file=sys.stderr)
    return {"hc_regions_per_s": n / (t1 - t0), "attempted": n, "failed": 0,
            "window_s": t1 - t0}


def trace_hooks(st: State, spans):
    """A span around the program's host CIGAR decode
    (``kernels.sw_cuda.decode_cigars``), wrapped from outside."""
    from mgl_tpu_torch.kernels import sw_cuda

    return spans.wrapped(sw_cuda, ("decode_cigars",))


def work(st: State) -> dict:
    """What the window's regions needed: the f32 pass's flops and bytes
    and the SW int32 ops of both calls.  The f64 rescue is left out:
    which pairs need it is known only from the f32 pass's results, so the
    sum is a lower bound."""
    per = {}
    for idx in {d[0] for d in st.done}:
        r = st.pool[idx]
        lens = np.array([len(rd["bases"]) for rd in r["reads"]])
        sw1 = counts.sw([len(r["ref"])] * len(r["haps"]),
                        [len(h) for h in r["haps"]], True)
        per[idx] = (counts.pairhmm_f32(lens, r["haps"]), sw1)
    out = {"regions": len(st.done), "f32_flops": 0.0, "f32_bytes": 0.0,
           "sw_ops": 0.0, "sw_bytes": 0.0}
    for idx, best, _ in st.done:
        (fl, by), (o1, b1) = per[idx]
        r = st.pool[idx]
        o2, b2 = counts.sw([len(r["haps"][b]) for b in best],
                           [len(rd["bases"]) for rd in r["reads"]], True)
        out["f32_flops"] += fl
        out["f32_bytes"] += by
        out["sw_ops"] += o1 + o2
        out["sw_bytes"] += b1 + b2
    return out


def release(st: State) -> None:
    """Drop the program's objects; what the check needs stays: the pool
    and the window's outputs."""
    st.aligner = st.engine = None


def _reference(st: State, picked: list, device, control: bool):
    """Per picked region: (log10 matrix, rescued mask, hap (cigar, offset)s,
    read (cigar, offset)s against ``best``), by the plain reference, or by
    its control in the next lower precision; ``best`` is the picked
    outputs' own choice for the reference, the control's own for it."""
    tier, rescue_tier, sw_dtype = (
        (torch.bfloat16, torch.float32, torch.int16) if control
        else (torch.float32, torch.float64, torch.int32))
    reads, haps, pairs, spans_ = [], [], [], []
    for idx, *_ in picked:
        r = st.pool[idx]
        r0, h0 = len(reads), len(haps)
        reads += r["reads"]
        haps += r["haps"]
        pairs += [(r0 + a, h0 + b) for a in range(len(r["reads"]))
                  for b in range(len(r["haps"]))]
        spans_.append((len(r["reads"]), len(r["haps"])))
    lk, rescued = ref_pairhmm.cascade(reads, haps, np.array(pairs), device,
                                      tier, rescue_tier)
    mats, masks, at = [], [], 0
    for n_r, n_h in spans_:
        mats.append(lk[at:at + n_r * n_h].reshape(n_r, n_h))
        masks.append(rescued[at:at + n_r * n_h].reshape(n_r, n_h))
        at += n_r * n_h
    hp = _ref_params(st.config["hap_to_ref_sw"])
    rp = _ref_params(st.config["read_to_hap_sw"])
    t1, q1, t2, q2 = [], [], [], []
    bests = []
    for (idx, _, _, best, *_), mat in zip(picked, mats):
        r = st.pool[idx]
        if control:
            best = np.argmax(mat, axis=1)
        bests.append(best)
        t1 += [r["ref"]] * len(r["haps"])
        q1 += r["haps"]
        t2 += [r["haps"][b] for b in best]
        q2 += [rd["bases"] for rd in r["reads"]]
    sw1, _ = ref_sw.align(t1, q1, hp, st.config["hap_to_ref_sw"]["strategy"],
                          device, sw_dtype, block=256)
    sw2, _ = ref_sw.align(t2, q2, rp,
                          st.config["read_to_hap_sw"]["strategy"], device,
                          sw_dtype, block=2048)
    out, a1, a2 = [], 0, 0
    for (idx, *_), mat, mask, best in zip(picked, mats, masks, bests):
        r = st.pool[idx]
        n_h, n_r = len(r["haps"]), len(r["reads"])
        out.append((mat, mask, sw1[a1:a1 + n_h], sw2[a2:a2 + n_r], best))
        a1 += n_h
        a2 += n_r
    return out


def check(st: State, device, control: bool = False) -> list:
    """[(name, value, limit)]: the widest log10 gap of the window's
    matrices to the reference's (its f32 tier, and its f64 rescue where
    a pair falls under the f32 floor), and the SW results that differ
    from the reference's, over a sample of the window's regions drawn
    from the seed.  ``control`` judges the reference's control in the
    program's place."""
    picked = st.kept
    if control:
        low = _reference(st, picked, device, control=True)
        got = [(m, s1, s2, best) for m, _, s1, s2, best in low]
        judged = [(p[0], None, None, g[3]) for p, g in zip(picked, got)]
    else:
        got = [(mat, [(s.cigar, s.offset) for s in sw1],
                [(s.cigar, s.offset) for s in sw2], best)
               for _, sw1, mat, best, sw2 in picked]
        judged = picked
    ref = _reference(st, judged, device, control=False)
    widest = 0.0
    bad1 = bad2 = n_pairs = n_rescued = 0
    for (mat, s1, s2, _), (rmat, mask, r1, r2, _) in zip(got, ref):
        with np.errstate(invalid="ignore"):
            mat = np.asarray(mat, np.float64)
            gap = np.where(mat == rmat, 0.0, np.abs(mat - rmat))
        gap = np.where(np.isfinite(gap), gap, np.inf)
        widest = max(widest, float(gap.max()))
        n_pairs += gap.size
        n_rescued += int(mask.sum())
        bad1 += sum(a != b for a, b in zip(s1, r1))
        bad2 += sum(a != b for a, b in zip(s2, r2))
    print(f"gpubench: checked {len(got)} regions, {n_pairs} pairs, "
          f"{n_rescued} of them rescued in f64 by the reference",
          file=sys.stderr)
    lim = st.config["limits"]
    return [("lk_gap", widest, lim["lk_gap"]),
            ("sw_hap_mismatches", bad1, lim["sw_hap_mismatches"]),
            ("sw_read_mismatches", bad2, lim["sw_read_mismatches"])]
