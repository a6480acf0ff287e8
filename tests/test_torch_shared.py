"""mgl_tpu_torch's shared-hap-set path on the CPU, held to the JAX package.

The plain version of the shared kernel (``shared_forward_plain``) against
itself with sharing off, against the per-pair plain forward, and against
``mgl_tpu.kernels.pairhmm_pallas.forward_scores_shared`` under the Pallas
interpreter (one call, module-scoped: it is the slow part); the hap
similarity pass and the engine's shared-or-product decision against the
JAX package's; the engine in shared mode against the JAX engine; and the
pipelined stream against sequential calls.  Small shapes and one thread.
"""

import numpy as np
import pytest
import torch

from test_torch_pairhmm import _product_fixture

from mgl_tpu.api import PairHmmEngine as JaxEngine
from mgl_tpu.ops import pairhmm as jax_pairhmm
from mgl_tpu_torch.api import PairHmmEngine
from mgl_tpu_torch.kernels import pairhmm_cuda as ph
from mgl_tpu_torch.ops.pairhmm import (compute_haplotype_similarities,
                                       normalize, use_shared_kernel)
from mgl_tpu_torch.tables import CTX_F32, MIN_ACCEPTED
from mgl_tpu_torch.testing import ACGT, engine_region

torch.set_num_threads(1)


def _snp(h: np.ndarray, p: int) -> np.ndarray:
    h = h.copy()
    h[p] = ACGT[(int(np.searchsorted(ACGT, h[p])) + 1) % 4]
    return h


def _shared_fixture():
    """9 reads of 20-110 bp against 6 haps of 120 bp: shared prefixes of
    90, 70 and 60 bases, two position resets (a hap sharing less than its
    predecessor did) and, last, an exact duplicate of hap 2."""
    rng = np.random.default_rng(11)
    base = rng.choice(ACGT, 120)
    haps = [base] + [_snp(base, p) for p in (90, 70, 100, 60)]
    haps.append(haps[2].copy())
    reads = []
    for k in range(9):
        n = int(rng.integers(20, 110))
        q = rng.integers(10, 50, n).astype(np.uint8)
        b = base[5:5 + n].copy() if k % 3 == 0 else rng.choice(ACGT, n)
        reads.append(dict(bases=b, q=q, i=q, d=q, c=np.full(n, 10, np.uint8)))
    return normalize(reads, haps)


@pytest.fixture(scope="module")
def jax_shared():
    """The fixture's scores from the JAX shared kernel, run under the
    Pallas interpreter as tests/test_pairhmm_shared.py runs it."""
    from mgl_tpu.kernels.pairhmm_pallas import forward_scores_shared

    reads, haps = _shared_fixture()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGL_TPU_PALLAS_INTERPRET", "1")
        return forward_scores_shared(reads, haps)


def test_haplotype_similarities_equal_jax():
    """Positions and (cols_min, cols_max) equal the JAX package's on 40
    seeded hap sets with shared prefixes, resets, haps under 8 bases and
    empty or single-hap sets."""
    rng = np.random.default_rng(23)
    resets = short = 0
    for case in range(40):
        base = rng.choice(ACGT, int(rng.integers(10, 40)))
        haps = []
        for _ in range(case % 9):
            h = base[:int(rng.integers(3, len(base) + 1))]
            if len(h) > 2 and rng.random() < 0.8:
                h = _snp(h, int(rng.integers(0, len(h))))
            haps.append(h)
        got = compute_haplotype_similarities(haps)
        want = jax_pairhmm.compute_haplotype_similarities(haps)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:], case
        raw = jax_pairhmm._raw_even_prefixes(haps)
        resets += int(((raw > 0) & (got[0] == 0)).sum())
        short += sum(len(h) < 8 for h in haps)
    assert resets and short


def test_shared_plain_sharing_on_equals_off_and_full_forward():
    """The checkpointed sweep reproduces the skipped columns exactly:
    sharing on == sharing off == the per-pair forward with yInit =
    y_shared for every hap, bit for bit."""
    reads, haps = _shared_fixture()
    args = ph.stage_shared(reads, haps, "cpu")
    assert args[4][1].numpy().tolist() == [0, 90, 0, 70, 0, 60]
    on = ph.pairhmm_shared_f32(*args)
    hstream, segtab = ph.segment_table(haps, np.zeros(len(haps), np.int64))
    off = ph.pairhmm_shared_f32(*args[:3], torch.from_numpy(hstream),
                                torch.from_numpy(segtab), args[5])
    pairs = [(r, h) for r in range(len(reads)) for h in range(len(haps))]
    pa = ph.stage_pairs(reads, haps, pairs, CTX_F32, "cpu")
    y = torch.full((len(haps),), args[5], dtype=torch.float32)
    full = ph.forward_plain(*pa[:5], y, *pa[6:]).reshape(on.shape)
    assert torch.equal(on, off)
    assert torch.equal(on, full)


def test_shared_scores_vs_jax_shared_kernel(jax_shared):
    """The rescaled plain scores against the JAX shared kernel: relative
    error <= 2e-6 on every pair the cascade keeps (f32 score >= 1e-28),
    the same rescue decisions, and the duplicate hap's column equal to its
    twin bit for bit.  Not bit-equal: XLA:CPU contracts into FMA (as in
    tests/test_torch_pairhmm.py) and flushes denormals, which is why pairs
    under the gate may differ; the f64 rescue recomputes those."""
    reads, haps = _shared_fixture()
    got = ph.shared_scores(reads, haps, "cpu")()
    keep = jax_shared >= float(MIN_ACCEPTED)
    assert keep.sum() >= 30
    rel = np.abs(got - jax_shared)[keep] / jax_shared[keep]
    assert rel.max() <= 2e-6, rel.max()
    assert np.array_equal(got < float(MIN_ACCEPTED), ~keep)
    assert np.array_equal(got[:, -1], got[:, 2])


@pytest.mark.parametrize("shape, shared", [
    ((512, 12, 151, 420), True),       # the smoke's engine region
    ((32, 12, 151, 420), False),       # 2,458 vs 1,220 by the estimate
    ((128, 4, 60, 100), True),
    ((300, 6, 100, 300), True),
    ("product_fixture", False),
], ids=["region_512x12", "region_32x12", "short_128x4", "mixed_300x6",
        "product_fixture"])
def test_engine_decision_equals_jax(shape, shared, monkeypatch):
    """The shared-or-product choice equals the JAX engine's
    (_shared_product_scores returns None for product mode); the JAX
    kernel is stubbed, so no interpreter runs."""
    import mgl_tpu.kernels.pairhmm_pallas as pallas

    monkeypatch.setattr(
        pallas, "forward_scores_shared",
        lambda reads, haps, **kw: lambda: np.zeros((len(reads), len(haps))))
    if shape == "product_fixture":
        reads, haps = _product_fixture()
    else:
        reads, haps = engine_region(7, *shape)
        if shape[0] == 300:          # reads in three length buckets
            for k, rd in enumerate(reads):
                n = (60, 100, 150)[k % 3] - k % 7
                reads[k] = {key: v[:n] for key, v in rd.items()}
    want = jax_pairhmm._shared_product_scores(reads, haps) is not None
    got = use_shared_kernel([len(r["bases"]) for r in reads], haps)
    assert got == want == shared


def _short_region(seed: int):
    """128 reads of 60 bp against 4 haps of 100 bp with late SNPs: shared
    mode, and every 16th read random at Q45-60 with dear gaps too (gap
    continuation Q40), so its f32 scores fall into the rescue tier."""
    reads, haps = engine_region(seed, 128, 4, 60, 100)
    for rd in reads[::16]:
        rd["c"] = np.full(60, 40, np.uint8)
    return reads, haps


def test_engine_shared_mode_vs_jax_engine():
    """compute_likelihoods through the shared path on the CPU agrees with
    mgl_tpu.api.PairHmmEngine(impl='xla') within 1e-5 log10 (the contract
    tests/test_pairhmm_shared.py:105 holds the JAX shared path to), with
    the same rescue decisions."""
    reads, haps = _short_region(3)
    assert use_shared_kernel([len(r["bases"]) for r in reads], haps)
    got = PairHmmEngine(device="cpu").compute_likelihoods(reads, haps)
    want = JaxEngine(impl="xla").compute_likelihoods(reads, haps)
    assert got.shape == want.shape == (128, 4)
    assert np.isfinite(got).all() and np.abs(got - want).max() < 1e-5
    ours = ph.shared_scores(*normalize(reads, haps), "cpu")().reshape(-1)
    pairs = [(r, h) for r in range(128) for h in range(4)]
    theirs = jax_pairhmm.forward_scores_xla(
        jax_pairhmm.pack_pairs(reads, haps, pairs, pad_to=(64, 128)))
    rescued = ours < float(MIN_ACCEPTED)
    assert rescued.sum() >= 8
    assert np.array_equal(rescued, theirs < float(MIN_ACCEPTED))


@pytest.mark.parametrize("depth", [1, 2])
def test_stream_equals_sequential(depth):
    """compute_likelihoods_stream over batches in shared mode, product
    mode and shared mode again yields, in input order, exactly what
    sequential compute_likelihoods calls return."""
    batches = [_short_region(4), engine_region(5, 8, 4, 60, 100),
               _short_region(6)]
    modes = [use_shared_kernel([len(r["bases"]) for r in rs], hs)
             for rs, hs in batches]
    assert modes == [True, False, True]
    eng = PairHmmEngine(device="cpu")
    want = [eng.compute_likelihoods(r, h) for r, h in batches]
    got = list(eng.compute_likelihoods_stream(iter(batches), depth=depth))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
