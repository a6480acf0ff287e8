"""Simulated short reads against a genome of several chromosomes, drawn
from a seed: ``gen_reads``' draws over the configuration's ``contigs``,
on both strands.

* The genome: each contig of the configuration's ``contigs`` (name,
  length) as uniform random ACGT of its length, drawn in turn by torch's
  generator on ``device`` (the card in a run: 3.1 Gbp in about a second)
  and copied into one host array, the contigs joined as the program's
  ``ReferenceIndex.build_multi`` joins them: max(k, 48) N after each.
  The same seed gives the same genome on the same kind of device.
* ``pool`` reads of ``read_len`` bases.  Each picks a contig in proportion
  to its length, then a start uniform over the contig's bases at which
  ``read_len`` plus the longest deletion fit, so that no read crosses a
  contig's end; each base is substituted at rate ``sub_rate`` by one of
  the three others.
* The first ``del_share`` of them are replaced by reads without
  substitutions that carry a deletion of ``del_bp`` bases after base
  ``del_after``.
* ``reverse_share`` of the reads, drawn apart from the rest, are reverse
  complemented, as a sequencer reads either strand.
* The pool is then permuted, so that every call of the window carries its
  share of deletion and reverse reads.

It returns the contigs (views of the joined genome), the joined genome and
each contig's offset in it, the reads, each read's true start in the
joined genome (its forward strand's first base), and what each needs of
the mapper's SW, known from how it was drawn: ``n_sub`` (its
substitutions), ``deletion`` and ``reverse``.
"""

from __future__ import annotations

import numpy as np
import torch

ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGT", b"TGCA"):
    _COMP[_a] = _b


def genome(config: dict, seed: int, device="cpu"
           ) -> tuple[np.ndarray, np.ndarray]:
    """(joined genome, ASCII uint8; each contig's offset in it, int64)."""
    dev = torch.device(device)
    sep = max(config["k"], 48)
    lens = np.array([n for _, n in config["contigs"]], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens + sep)[:-1]])
    out = np.full(int((lens + sep).sum()), ord("N"), np.uint8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2**63)
    lut = torch.from_numpy(ACGT.copy()).to(dev)
    for off, n in zip(offsets.tolist(), lens.tolist()):
        code = torch.randint(0, 4, (n,), dtype=torch.uint8, generator=gen,
                             device=dev)
        torch.from_numpy(out[off:off + n]).copy_(lut[code.to(torch.int32)])
    return out, offsets


def make(mix: dict, config: dict, seed: int, device="cpu") -> dict:
    joined, offsets = genome(config, seed, device)
    names = [c for c, _ in config["contigs"]]
    lens = np.array([n for _, n in config["contigs"]], np.int64)
    rng = np.random.default_rng(seed)
    n, L = mix["pool"], config["read_len"]
    d_max = mix["del_bp"][1]
    cid = rng.choice(len(lens), size=n, p=lens / lens.sum())
    local = (rng.random(n) * (lens[cid] - L - d_max + 1)).astype(np.int64)
    true_pos = offsets[cid] + local
    col = np.arange(L)[None, :]
    reads = joined[true_pos[:, None] + col]
    mut = rng.random(reads.shape) < mix["sub_rate"]
    reads[mut] = ACGT[(np.searchsorted(ACGT, reads[mut])
                       + rng.integers(1, 4, int(mut.sum()))) % 4]
    n_del = int(n * mix["del_share"])
    d = rng.integers(mix["del_bp"][0], d_max + 1, n_del)
    cut = mix["del_after"]
    reads[:n_del] = joined[true_pos[:n_del, None]
                           + np.where(col < cut, col, col + d[:, None])]
    n_sub = mut.sum(axis=1, dtype=np.int32)
    n_sub[:n_del] = 0
    reverse = rng.random(n) < mix["reverse_share"]
    reads[reverse] = _COMP[reads[reverse][:, ::-1]]
    perm = rng.permutation(n)
    return {"contigs": [(name, joined[o:o + m]) for name, o, m in
                        zip(names, offsets.tolist(), lens.tolist())],
            "genome": joined, "offsets": offsets,
            "reads": np.ascontiguousarray(reads[perm]),
            "true_pos": true_pos[perm], "deletion": perm < n_del,
            "n_sub": n_sub[perm], "reverse": reverse[perm]}
