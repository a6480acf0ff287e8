"""``mgl-map --cigar`` users: ``map_reads_stream(..., with_cigar=True)``
over a simulated chromosome, through the program's public entry point.

Set-up builds the program's index of the reference (``ReferenceIndex``)
and maps one call's reads, which builds and warms every kernel and the
host library.  The window maps calls of ``call`` reads (``chunk`` reads a
chunk), taking the pool's halves in turn, until ``seconds`` have passed;
the rate is every read of every call over the time to the last call's
end.  Each call keeps a sample of its reads' results, drawn from the seed
(a share of them among the reads the traceback tier took), for the
check."""

from __future__ import annotations

import importlib
import sys
import time

import numpy as np
import torch

from mgl_tpu_torch.api import OverhangStrategy, SWParameters
from mgl_tpu_torch.pipelines.mapper import ReferenceIndex, map_reads_stream
from mgl_tpu_torch.utils.metrics import METRICS
from gpubench.counts import work as counts
from gpubench.reference import mapper as ref_mapper

FIELDS = ("pos", "strand", "score", "cigar", "offset")


class State:
    pass


def _sw(config: dict) -> tuple[int, int, int, int]:
    p = config["sw"]
    return (p["match"], p["mismatch"], p["gap_open"], p["gap_extend"])


def setup(config: dict, mix: dict, seed: int, device, spans) -> State:
    st = State()
    st.config, st.mix, st.seed, st.device = config, mix, seed, device
    t = [time.perf_counter()]
    data = importlib.import_module(
        f"gpubench.traffic.{mix['generator']}").make(mix, config, seed)
    st.ref, st.reads = data["ref"], data["reads"]
    st.n_sub, st.deletion = data["n_sub"], data["deletion"]
    t.append(time.perf_counter())
    st.index = ReferenceIndex.build(st.ref, k=config["k"],
                                    max_hits=config["max_hits"])
    t.append(time.perf_counter())
    st.params = SWParameters(*_sw(config))
    st.strategy = OverhangStrategy[config["sw"]["strategy"]]
    _call(st, 0)
    t.append(time.perf_counter())
    print("gpubench: set-up s: inputs %.3f, index %.3f, warm call %.3f"
          % tuple(b - a for a, b in zip(t, t[1:])), file=sys.stderr)
    return st


def _call(st: State, n: int) -> tuple[dict, int]:
    call = st.mix["call"]
    lo = (n % (len(st.reads) // call)) * call
    return map_reads_stream(st.index, st.reads[lo:lo + call],
                            chunk=st.config["chunk"],
                            window_pad=st.config["window_pad"],
                            params=st.params, with_cigar=True,
                            strategy=st.strategy, device=st.device), lo


def run_window(st: State, seconds: float, spans) -> dict:
    rng = np.random.default_rng([st.seed, 1])
    st.samples, st.calls, n = [], [], 0
    took = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        c0 = time.perf_counter()
        with spans.span("map.call"):
            out, lo = _call(st, n + 1)      # set-up mapped the first half
        took.append(round(time.perf_counter() - c0, 3))
        n += 1
        st.calls.append(lo)
        _keep(st, rng, out, lo)
    t1 = time.perf_counter()
    print("gpubench: calls took s:", took, file=sys.stderr)
    reads = n * st.mix["call"]
    return {"map_reads_per_s": reads / (t1 - t0), "attempted": reads,
            "failed": 0, "window_s": t1 - t0, "calls": n}


def _keep(st: State, rng, out: dict, lo: int) -> None:
    """A sample of the call's results: uniform, and among the reads whose
    CIGAR is not the whole read's match (the traceback tier)."""
    k = st.config["check_reads"]
    L = st.config["read_len"]
    n = len(out["pos"])
    pick = rng.choice(n, k["uniform"], replace=False)
    tier = np.nonzero((out["pos"] >= 0) & (out["cigar"] != f"{L}M"))[0]
    if len(tier):
        pick = np.union1d(pick, rng.choice(tier, min(k["tier"], len(tier)),
                                           replace=False))
    st.samples.append((lo + pick, {f: out[f][pick] for f in FIELDS}))


# the mapper's host stages, put under spans of their name in a traced run
STAGES = ("seed_candidates", "_nm_at", "_exact_tier", "revcomp",
          "_sw_score_windows_async", "sw_cigar_windows", "decode_overflow")


def trace_hooks(st: State, spans):
    """Spans around the mapper's host stages (``STAGES``), wrapped from
    outside for the traced run, so that the trace says which one the host
    was in while the card idled."""
    from mgl_tpu_torch.pipelines import mapper

    return spans.wrapped(mapper, STAGES)


def work(st: State) -> dict:
    """The SW work the window's reads needed, from how they were drawn:
    a score window (``wlen`` x ``read_len`` cells) for each read that is
    not an exact copy of the reference (a substitution or a deletion),
    and a traceback window for each read with a deletion.  A lower bound:
    competing loci and the reads whose substitutions alone earn a clipped
    or gapped CIGAR are not counted.  The program's own count of
    traceback windows is printed beside it, as a cross-check."""
    L = st.config["read_len"]
    wlen = L + 2 * st.config["window_pad"]
    call = st.mix["call"]
    n_score = n_tb = 0
    for lo in st.calls:
        sub, dele = st.n_sub[lo:lo + call], st.deletion[lo:lo + call]
        n_score += int(((sub > 0) | dele).sum())
        n_tb += int(dele.sum())
    print(f"gpubench: SW windows the inputs need: score {n_score}, "
          f"traceback {n_tb}; the program's map.tb_reads "
          f"{int(METRICS.counters.get('map.tb_reads', 0))}", file=sys.stderr)
    so, sb = counts.sw([wlen] * n_score, [L] * n_score, False)
    to, tb = counts.sw([wlen] * n_tb, [L] * n_tb, True)
    return {"score_windows": n_score, "tb_windows": n_tb,
            "sw_ops": so + to, "sw_bytes": sb + tb,
            "chunks": len(st.calls) * -(-call // st.config["chunk"])}


def release(st: State) -> None:
    st.index = None


def check(st: State, device, control: bool = False) -> list:
    """[(name, value, limit)]: over the window's sampled reads, those whose
    mapping (mapped or not, start, strand), best SW score, or CIGAR and
    offset differ from the reference's.  ``control`` judges the
    reference's control (its SW in the configuration's ``control_dtype``)
    in the program's place."""
    rows = np.concatenate([r for r, _ in st.samples])
    got = {f: np.concatenate([s[f] for _, s in st.samples]) for f in FIELDS}
    cfg = st.config
    index = ref_mapper.KmerIndex(st.ref, cfg["k"], device)
    args = (cfg["window_pad"], cfg["max_hits"], _sw(cfg))
    reads = st.reads[rows]
    exp = ref_mapper.map_reads(index, reads, *args)
    if control:
        got = ref_mapper.map_reads(index, reads, *args,
                                   dtype=getattr(torch, cfg["control_dtype"]))
    mapped = exp["pos"] >= 0
    pos_bad = (got["pos"] != exp["pos"]) | (mapped & (got["strand"]
                                                      != exp["strand"]))
    both = mapped & ~pos_bad
    score_bad = both & (got["score"] != exp["score"])
    cig_bad = both & ((got["cigar"] != exp["cigar"])
                      | (got["offset"] != exp["offset"]))
    lim = cfg["limits"]
    return [("map_pos_mismatches", int(pos_bad.sum()),
             lim["map_pos_mismatches"]),
            ("map_score_mismatches", int(score_bad.sum()),
             lim["map_score_mismatches"]),
            ("map_cigar_mismatches", int(cig_bad.sum()),
             lim["map_cigar_mismatches"])]
