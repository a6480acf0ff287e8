"""GATK HaplotypeCaller assembly regions: the padded reference, the
haplotypes the assembler emits, and the reads, drawn from a seed.

A region's shape - its active length, the number of haplotypes, the
variant sites, their kind and length, which haplotype carries which, and
the reads' count, source haplotype and start - comes from the mix's own
``shape_seed``, so every run seed replays the same set of shapes.  The
run's seed draws the bases, the errors and the qualities, and the order in
which the pool is replayed.

* The padded reference is ``active`` bases (drawn from ``active_bp``) plus
  ``padding_bp`` on each side, uniform ACGT.
* Haplotypes: ``n_haps`` (drawn from the ``haps`` classes: [low, high,
  share]) distinct combinations of ``ceil(log2(n_haps)) + 1`` variant
  sites in the active part, at least 12 bases apart, the reference
  haplotype among them; a site is a SNP (share ``snp_share``) or an
  insertion or deletion of ``indel_bp`` bases.  Sorted by their bases, as
  GATK's assembler emits them.
* Reads: ``round(depth * (len(ref) + read_len - 1) / read_len)`` of
  ``read_len`` bases, each from a haplotype at a uniform start.  Each
  base's quality is one of NovaSeq's binned qualities (``base_q_bins``:
  [quality, share]), and the base is an error - one of the three other
  bases - with the probability that its quality states
  (10^(-Q/10): calibrated qualities).  What the PairHMM receives is what
  GATK hands it (the configuration's ``pairhmm_read``): qualities under
  ``base_quality_score_threshold`` raised to ``min_usable_q``, the
  insertion and deletion qualities ``indel_q``, gap continuation ``gcp``.
  Which read likelihoods fall into the f64 rescue is left to these reads.
"""

from __future__ import annotations

import math

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _shape(rng: np.random.Generator, mix: dict, read_len: int) -> dict:
    lo, hi = mix["active_bp"]
    active = int(rng.integers(lo, hi + 1))
    pad = mix["padding_bp"]
    ref_len = active + 2 * pad
    shares = np.array([c[2] for c in mix["haps"]], float)
    cls = mix["haps"][int(rng.choice(len(shares), p=shares / shares.sum()))]
    n_haps = int(rng.integers(cls[0], cls[1] + 1))
    n_sites = max(1, math.ceil(math.log2(n_haps))) + 1
    slots = np.arange(0, active - 20, 12)
    sites = pad + 5 + np.sort(rng.choice(slots, n_sites, replace=False))
    kinds = []
    for _ in range(n_sites):
        if rng.random() < mix["snp_share"]:
            kinds.append(("snp", 1))
        else:
            kinds.append(("ins" if rng.random() < 0.5 else "del",
                          int(rng.integers(mix["indel_bp"][0],
                                           mix["indel_bp"][1] + 1))))
    combos = rng.choice(np.arange(1, 2 ** n_sites), n_haps - 1,
                        replace=False)
    combos = [0] + [int(c) for c in combos]
    n_reads = int(round(mix["depth"] * (ref_len + read_len - 1) / read_len))
    return {"ref_len": ref_len, "sites": sites.tolist(), "kinds": kinds,
            "combos": combos, "n_reads": n_reads,
            "read_hap": rng.integers(0, n_haps, n_reads).tolist(),
            "read_at": rng.random(n_reads).tolist()}


def _region(rng: np.random.Generator, shape: dict, mix: dict,
            config: dict, read_len: int) -> dict:
    ref = ACGT[rng.integers(0, 4, shape["ref_len"])]
    alts = []
    for (kind, n) in shape["kinds"]:
        if kind == "snp":
            alts.append(int(rng.integers(1, 4)))
        elif kind == "ins":
            alts.append(ACGT[rng.integers(0, 4, n)])
        else:
            alts.append(None)
    haps = []
    for combo in shape["combos"]:
        h = ref
        # apply from the last site back, so earlier coordinates hold
        for s in reversed(range(len(shape["sites"]))):
            if not combo >> s & 1:
                continue
            p, (kind, n) = shape["sites"][s], shape["kinds"][s]
            if kind == "snp":
                h = h.copy()
                h[p] = ACGT[(int(np.searchsorted(ACGT, h[p])) + alts[s]) % 4]
            elif kind == "ins":
                h = np.concatenate([h[:p + 1], alts[s], h[p + 1:]])
            else:
                h = np.concatenate([h[:p + 1], h[p + 1 + n:]])
        haps.append(h)
    sources = haps
    haps = sorted(haps, key=lambda a: a.tobytes())
    n, L = shape["n_reads"], read_len
    bins = np.array([b[0] for b in mix["base_q_bins"]], np.uint8)
    share = np.array([b[1] for b in mix["base_q_bins"]], float)
    q = bins[rng.choice(len(bins), (n, L), p=share / share.sum())]
    err = rng.random((n, L)) < 10.0 ** (-q.astype(float) / 10.0)
    shift = rng.integers(1, 4, (n, L))
    hr = config["pairhmm_read"]
    q_hmm = np.where(q < hr["base_quality_score_threshold"],
                     hr["min_usable_q"], q).astype(np.uint8)
    indel = np.full(L, hr["indel_q"], np.uint8)
    gcp = np.full(L, hr["gcp"], np.uint8)
    reads = []
    for k in range(n):
        h = sources[shape["read_hap"][k]]
        st = int(shape["read_at"][k] * (len(h) - L + 1))
        b = h[st:st + L].copy()
        e = err[k]
        b[e] = ACGT[(np.searchsorted(ACGT, b[e]) + shift[k, e]) % 4]
        reads.append({"bases": b, "q": q_hmm[k], "i": indel, "d": indel,
                      "c": gcp})
    return {"ref": ref, "haps": haps, "reads": reads}


def make(mix: dict, config: dict, seed: int) -> list[dict]:
    """The pool of ``mix["pool"]`` regions, in the order the seed replays
    them."""
    read_len = config["read_len"]
    shape_rng = np.random.default_rng(mix["shape_seed"])
    shapes = [_shape(shape_rng, mix, read_len) for _ in range(mix["pool"])]
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(shapes))
    return [_region(rng, shapes[k], mix, config, read_len)
            for k in order]
