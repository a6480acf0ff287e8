"""Simulated short reads against a uniform random reference, drawn from a
seed: the draws of the port's ``testing.simulate`` (BASELINE config 4)
and of ``scale_configs.config4_cigar``'s deletion reads, copied.

* The reference: ``ref_bp`` bases (the configuration's), uniform ACGT.
* ``pool`` reads of ``read_len`` bases at uniform starts, each base
  substituted at rate ``sub_rate`` by one of the three others.
* The first ``del_share`` of them are replaced by reads without
  substitutions that carry a deletion of ``del_bp`` bases after base
  ``del_after``, kept inside the reference.
* The pool is then permuted, so that every call of the window carries its
  share of deletion reads.

Beside the reads it returns what each needs of the mapper's SW, known
from how it was drawn: ``n_sub`` (its substitutions) and ``deletion``.
"""

from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def make(mix: dict, config: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    ref_len, n, L = config["ref_bp"], mix["pool"], config["read_len"]
    ref = ACGT[rng.integers(0, 4, size=ref_len, dtype=np.uint8)]
    true_pos = rng.integers(0, ref_len - L, size=n)
    reads = ref[true_pos[:, None] + np.arange(L)[None, :]]
    mut = rng.random(reads.shape) < mix["sub_rate"]
    reads[mut] = ACGT[(np.searchsorted(ACGT, reads[mut])
                       + rng.integers(1, 4, int(mut.sum()))) % 4]
    n_del = int(n * mix["del_share"])
    d = rng.integers(mix["del_bp"][0], mix["del_bp"][1] + 1, n_del)
    start = np.minimum(true_pos[:n_del], ref_len - L - d)
    col = np.arange(L)[None, :]
    cut = mix["del_after"]
    reads[:n_del] = ref[start[:, None] + np.where(col < cut, col,
                                                   col + d[:, None])]
    true_pos[:n_del] = start
    n_sub = mut.sum(axis=1, dtype=np.int32)
    n_sub[:n_del] = 0
    perm = rng.permutation(n)
    return {"ref": ref, "reads": np.ascontiguousarray(reads[perm]),
            "true_pos": true_pos[perm], "deletion": perm < n_del,
            "n_sub": n_sub[perm]}
