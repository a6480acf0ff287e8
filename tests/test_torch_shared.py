"""mgl_tpu_torch's shared-hap-set path, held to the JAX package on the CPU
and to its plain version on the card.

On the CPU: the plain version of the shared kernel
(``shared_forward_plain``) against itself with sharing off, against the
per-pair plain forward (also on reads of 1 to 320 bases and a
zero-length segment), and against
``mgl_tpu.kernels.pairhmm_pallas.forward_scores_shared`` under the Pallas
interpreter (one call, module-scoped: it is the slow part); the hap
similarity pass and the engine's shared-or-product decision against the
JAX package's; the engine in shared mode against the JAX engine; the
pipelined stream against sequential calls; the rule that picks the
kernel's warps a read (``shared_warps``) and the refusal of a bad forced
W.  Small shapes and one thread.

On the card (``cuda``): ``pairhmm_shared_f32`` at every W from 1 to
SHARED_WARPS_MAX bit-equal to the plain version, sharing on and off, on
reads of 1 to ~1,100 bases (35 bands, more than a block's warps, so
bands wrap), at the region shape with the carry row in shared memory,
and on a long hap set with it in global memory.  The JAX package is imported only inside the
CPU tests that use it, so the card tests also run on a GPU host without
it: ``python -m pytest tests/test_torch_shared.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from mgl_tpu_torch.api import PairHmmEngine
from mgl_tpu_torch.kernels import pairhmm_cuda as ph
from mgl_tpu_torch.ops.pairhmm import (compute_haplotype_similarities,
                                       normalize, shared_forward_plain,
                                       use_shared_kernel)
from mgl_tpu_torch.tables import CTX_F32, MIN_ACCEPTED
from mgl_tpu_torch.testing import (ACGT, engine_region, long_hap_set,
                                   shared_edge_set, shared_on_and_off, snp)

torch.set_num_threads(1)
H100_SMS = 132
# reads of 1 to ~1,100 bases: one band, a band's edges (31, 32, 33), two
# bands, the region's 151 bp, 300+ and 35 bands (more than
# SHARED_WARPS_MAX, so a read wraps at every W)
EDGE_READS = (1, 31, 32, 33, 64, 65, 151, 300, 1100)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _shared_fixture():
    """9 reads of 20-110 bp against 6 haps of 120 bp: shared prefixes of
    90, 70 and 60 bases, two position resets (a hap sharing less than its
    predecessor did) and, last, an exact duplicate of hap 2."""
    rng = np.random.default_rng(11)
    base = rng.choice(ACGT, 120)
    haps = [base] + [snp(base, p) for p in (90, 70, 100, 60)]
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
    from mgl_tpu.ops import pairhmm as jax_pairhmm

    rng = np.random.default_rng(23)
    resets = short = 0
    for case in range(40):
        base = rng.choice(ACGT, int(rng.integers(10, 40)))
        haps = []
        for _ in range(case % 9):
            h = base[:int(rng.integers(3, len(base) + 1))]
            if len(h) > 2 and rng.random() < 0.8:
                h = snp(h, int(rng.integers(0, len(h))))
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
    from mgl_tpu.ops import pairhmm as jax_pairhmm
    from test_torch_pairhmm import _product_fixture

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
    from mgl_tpu.api import PairHmmEngine as JaxEngine
    from mgl_tpu.ops import pairhmm as jax_pairhmm

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


@pytest.mark.parametrize("n_reads, n_bands, sm_count, want", [
    (512, 5, H100_SMS, 5),             # GATK's region: 151 bp reads
    (32, 5, H100_SMS, 5),
    (10_000, 5, H100_SMS, 1),          # the reads alone fill the card
    (H100_SMS * ph.WARPS_PER_SM, 8, H100_SMS, 1),
    (1000, 5, H100_SMS, 3),            # W = 2 wanted: two rounds, of 3
    (300, 8, H100_SMS, 8),             # 250 bp reads, W = 6 -> 8
    (600, 8, H100_SMS, 4),             # W = 3 -> two rounds of 4
    (128, 2, H100_SMS, 2),
    (1, 1, H100_SMS, 1),
    (4, 35, H100_SMS, 18),             # over 24 bands: two rounds
    (1, 100, 4, 13),                   # W = 12 wanted: 8 rounds of 13
])
def test_warps_per_read_rule(n_reads, n_bands, sm_count, want):
    """W is at most the bands and SHARED_WARPS_MAX, at least the W that
    puts WARPS_PER_SM warps on each SM holding a read (where the
    bands and the cap allow), and shares the bands evenly: no round of a
    warp's bands is shorter than needed."""
    w = ph.shared_warps(n_reads, n_bands, sm_count)
    assert w == want
    assert 1 <= w <= min(n_bands, ph.SHARED_WARPS_MAX)
    rounds = -(-n_bands // w)
    assert -(-n_bands // rounds) == w          # fewest warps for its rounds
    target = min(n_reads, sm_count) * ph.WARPS_PER_SM
    if n_bands <= ph.SHARED_WARPS_MAX:
        assert n_reads * w >= target or w == n_bands


@pytest.mark.parametrize("warps", [0, ph.SHARED_WARPS_MAX + 1, 2.0])
def test_forced_w_out_of_range_is_refused(warps):
    """Forcing a W the kernel does not take raises before anything runs,
    on CPU tensors too."""
    reads, haps = normalize(*shared_edge_set(1, (10, 40)))
    args = ph.stage_shared(reads, haps, "cpu")
    with pytest.raises(ValueError, match="warps_per_read"):
        ph.pairhmm_shared_f32(*args, warps_per_read=warps)


@pytest.mark.parametrize("read_lens", [(1, 32, 33, 320), (31, 64, 65, 95)],
                         ids=["1_32_33_320", "31_64_65_95"])
def test_shared_plain_on_edge_reads(read_lens):
    """The plain version the kernel is held to, on reads of one base, of
    one band's edges and of 10 bands, against haps with a reset, a
    zero-length segment, a hap under 8 bases and a prefix hap: sharing on
    == sharing off == the per-pair forward with yInit = y_shared, bit for
    bit, and the duplicate hap's column equal to its twin's."""
    reads, haps = normalize(*shared_edge_set(2, read_lens))
    on, off = shared_on_and_off(reads, haps, "cpu")
    segtab = on[4].numpy()
    assert (segtab[2] == segtab[1]).any()        # a zero-length segment
    assert ((segtab[1] == 0) & (np.arange(len(haps)) > 0)).sum() >= 2
    got_on, got_off = shared_forward_plain(*on), shared_forward_plain(*off)
    pairs = [(r, h) for r in range(len(reads)) for h in range(len(haps))]
    pa = ph.stage_pairs(reads, haps, pairs, CTX_F32, "cpu")
    y = torch.full((len(haps),), on[5], dtype=torch.float32)
    full = ph.forward_plain(*pa[:5], y, *pa[6:]).reshape(got_on.shape)
    assert torch.equal(got_on, got_off)
    assert torch.equal(got_on, full)
    assert torch.equal(got_on[:, 3], got_on[:, 2])
    assert int((got_on > 0).sum()) >= got_on.numel() // 2   # not vacuous


@pytest.mark.cuda
@pytest.mark.parametrize("sharing", [True, False], ids=["on", "off"])
def test_every_w_matches_plain(cuda, sharing):
    """Every W from 1 to SHARED_WARPS_MAX (and the wrapper's) gives the
    plain version's bits on reads of 1 to 1,100 bases, with sharing on
    and off."""
    reads, haps = normalize(*shared_edge_set(3, EDGE_READS))
    args = shared_on_and_off(reads, haps, cuda)[0 if sharing else 1]
    want = shared_forward_plain(*args)
    for w in (None, *range(1, ph.SHARED_WARPS_MAX + 1)):
        got = ph.pairhmm_shared_f32(*args, warps_per_read=w)
        torch.cuda.synchronize()
        assert torch.equal(got, want), w


@pytest.mark.cuda
def test_region_shape_every_w_shared_carry(cuda):
    """At GATK's region shape (512 reads x 12 haps, 151 x 420) the carry
    row lies in shared memory, and W = 1 to 5 all equal the plain version
    bit for bit."""
    reads, haps = normalize(*engine_region(100))
    args = ph.stage_shared(reads, haps, cuda)
    want = shared_forward_plain(*args)
    for w in range(1, 6):
        assert ph.shared_carry_in_shared(512, args[3].shape[0], w, cuda)
        got = ph.pairhmm_shared_f32(*args, warps_per_read=w)
        torch.cuda.synchronize()
        assert torch.equal(got, want), w


@pytest.mark.cuda
def test_long_hap_set_global_carry(cuda):
    """24 haps of 1 kb with resets (a row of ~129 KB a read) for 300
    reads: the launcher keeps the row in global memory, and the kernel
    equals the plain version at W = 1, 2, 4 and the wrapper's W."""
    reads, haps = normalize(*long_hap_set(5))
    args = ph.stage_shared(reads, haps, cuda)
    want = shared_forward_plain(*args)
    for w in (None, 1, 2, 4):
        if w is not None:
            assert not ph.shared_carry_in_shared(300, args[3].shape[0], w,
                                                 cuda)
        got = ph.pairhmm_shared_f32(*args, warps_per_read=w)
        torch.cuda.synchronize()
        assert torch.equal(got, want), w
