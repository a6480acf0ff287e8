"""``mgl-map --cigar`` users against the whole human genome:
``map_reads_stream(..., with_cigar=True)`` over GRCh38's 24 chromosomes,
indexed by ``ReferenceIndex.build_multi(..., device=card)``, the program's
public entry points.

Set-up draws the genome (its bases on the card) and the reads
(``traffic/gen_genome_reads``), builds the program's index of the joined
chromosomes on the card, which leaves the word-packed reference there
too, and maps one call's reads, which builds and warms every kernel and
the host library.  It prints the inputs', the index's and the warm
call's seconds, the program's set-up timers and the process's peak
resident memory.  The window, the sample each call keeps and the SW work
counted are ``chr20_map``'s.  After the window, ``release`` records the
program's ``locate`` of the sampled starts and drops the index; ``check``
holds the samples to the plain reference over the whole genome
(``reference/genome_index``), and each mapped read's contig and local
start to the harness's own contig offsets."""

from __future__ import annotations

import resource
import sys
import time

import numpy as np
import torch

from mgl_tpu_torch.api import OverhangStrategy, SWParameters
from mgl_tpu_torch.pipelines.mapper import ReferenceIndex
from mgl_tpu_torch.utils.metrics import METRICS
# run_window, trace_hooks and work are this driver's as they are chr20_map's
from gpubench.drivers.chr20_map import (FIELDS, State, _call, _sw,  # noqa: F401
                                        run_window, trace_hooks, work)
from gpubench.reference import mapper as ref_mapper
from gpubench.reference.genome_index import GenomeIndex
from gpubench.traffic import gen_genome_reads

SETUP_TIMERS = ("map.index_build", "map.index_scan", "map.index_sort",
                "map.index_copy", "map.pack_ref")


def peak_rss_gib() -> float:
    """The process's peak resident memory, GiB (Linux counts it in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def setup(config: dict, mix: dict, seed: int, device, spans) -> State:
    st = State()
    st.config, st.mix, st.seed, st.device = config, mix, seed, device
    t = [time.perf_counter()]
    data = gen_genome_reads.make(mix, config, seed, device)
    st.genome, st.offsets = data["genome"], data["offsets"]
    st.reads = data["reads"]
    st.n_sub, st.deletion = data["n_sub"], data["deletion"]
    t.append(time.perf_counter())
    METRICS.reset()
    st.index = ReferenceIndex.build_multi(data["contigs"], k=config["k"],
                                          max_hits=config["max_hits"],
                                          device=device)
    del data
    built = METRICS.snapshot()
    t.append(time.perf_counter())
    st.params = SWParameters(*_sw(config))
    st.strategy = OverhangStrategy[config["sw"]["strategy"]]
    _call(st, 0)
    t.append(time.perf_counter())
    print("gpubench: set-up s: inputs %.3f, index %.3f, warm call %.3f"
          % tuple(b - a for a, b in zip(t, t[1:])), file=sys.stderr)
    print("gpubench: the program's set-up s: "
          + ", ".join(f"{n} {built['timers_s'].get(n, 0.0):.3f}"
                      for n in SETUP_TIMERS)
          + f"; map.index_rows {int(built['counters'].get('map.index_rows', 0))}"
          + f"; peak RSS {peak_rss_gib():.2f} GiB", file=sys.stderr)
    return st


def release(st: State) -> None:
    """The program's (contig, local start) of each sampled read, then the
    index dropped."""
    pos = np.concatenate([s["pos"] for _, s in st.samples])
    st.located = st.index.locate(pos)
    st.index = None


def _locus(offsets: np.ndarray, pos: np.ndarray):
    """(contig, local start) of global starts by the harness's offsets."""
    cid = np.searchsorted(offsets, pos, "right") - 1
    return cid, pos - offsets[np.clip(cid, 0, None)]


def check(st: State, device, control: bool = False) -> list:
    """[(name, value, limit)]: over the window's sampled reads, those whose
    mapping (mapped or not, start, strand), best SW score, CIGAR and
    offset, or contig and local start differ from the reference's.
    ``control`` judges the reference's control (its SW in the
    configuration's ``control_dtype``) in the program's place."""
    rows = np.concatenate([r for r, _ in st.samples])
    got = {f: np.concatenate([s[f] for _, s in st.samples]) for f in FIELDS}
    located = st.located
    cfg = st.config
    reads = st.reads[rows]
    index = GenomeIndex(st.genome, cfg["k"], reads, device)
    args = (cfg["window_pad"], cfg["max_hits"], _sw(cfg))
    exp = ref_mapper.map_reads(index, reads, *args)
    if control:
        got = ref_mapper.map_reads(index, reads, *args,
                                   dtype=getattr(torch, cfg["control_dtype"]))
        located = _locus(st.offsets, got["pos"])
    mapped = exp["pos"] >= 0
    pos_bad = (got["pos"] != exp["pos"]) | (mapped & (got["strand"]
                                                      != exp["strand"]))
    both = mapped & ~pos_bad
    score_bad = both & (got["score"] != exp["score"])
    cig_bad = both & ((got["cigar"] != exp["cigar"])
                      | (got["offset"] != exp["offset"]))
    cid, local = _locus(st.offsets, exp["pos"])
    locus_bad = mapped & ((located[0] != cid) | (located[1] != local))
    lim = cfg["limits"]
    return [(name, int(bad.sum()), lim[name]) for name, bad in (
        ("map_pos_mismatches", pos_bad), ("map_score_mismatches", score_bad),
        ("map_cigar_mismatches", cig_bad),
        ("map_locus_mismatches", locus_bad))]
