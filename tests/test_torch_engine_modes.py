"""PairHmmEngine's two modes in the port, against the JAX package:
``use_double`` (every pair through the f64 tier) and ``fast_path`` (the
seed-extend estimator first), with the port's copies of ``set_mm_prob``
and ``result_match``, the plain seed-extend scorer (on the goldens, the
edge pairs and the kernel design's edges), the cascade's
routing, the stream and duplicate haps; on a card, the seed-extend kernel
against its plain version, both modes against ``device="cpu"`` and
``fast_path`` without hits through the shared kernel.

The CPU tests run the plain torch versions at small shapes (a few seconds
on one thread); the JAX functions run on the CPU as the JAX package's own
tests run them, imported inside the tests, so that ``python -m pytest
tests/test_torch_engine_modes.py -m cuda`` runs the card's tests on a
host without jax.
"""

import math

import numpy as np
import pytest
import torch

from conftest import as_u8, kat_read
from mgl_tpu.core import context as jax_context
from mgl_tpu_torch.api import PairHmmEngine
from mgl_tpu_torch.core import context
from mgl_tpu_torch.kernels import pairhmm_cuda
from mgl_tpu_torch.kernels.seed_extend_cuda import seed_extend_f32
from mgl_tpu_torch.ops import seed_extend
from mgl_tpu_torch.ops.pairhmm import normalize
from mgl_tpu_torch.tables import CTX_F32, MIN_ACCEPTED
from mgl_tpu_torch.testing import (engine_region, golden_read, no_hit_region,
                                   same_scores, seed_extend_edge_set,
                                   seed_extend_order_set)

torch.set_num_threads(1)

MODES = [{"use_double": True}, {"fast_path": True}]


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _golden(rows):
    return [golden_read(r) for r in rows], [as_u8(r["hap"]) for r in rows]


def _plain_fast(reads, haps, pairs):
    return seed_extend.fast_scores_plain(
        *seed_extend.stage_fast(reads, haps, pairs, "cpu")).numpy()


@pytest.mark.parametrize("name", ["CTX_F32", "CTX_F64"])
def test_context_methods_equal_jax_package(name):
    """set_mm_prob over every (ins, del) in 0..127 and the transition rows
    of random reads, bit for bit against mgl_tpu.core.context."""
    ours, theirs = getattr(context, name), getattr(jax_context, name)
    ins, dels = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    got = ours.set_mm_prob(ins, dels)
    assert got.dtype == ours.dtype
    assert np.array_equal(got.view(np.uint8),
                          theirs.set_mm_prob(ins, dels).view(np.uint8))
    rng = np.random.default_rng(4)
    tracks = rng.integers(0, 256, (4, 3, 40)).astype(np.uint8)
    for a, b in zip(context.read_transition_rows(*tracks, ours),
                    jax_context.read_transition_rows(*tracks, theirs)):
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_result_match_equals_jax_package(pairhmm_golden):
    """result_match bit for bit on every golden read and a one-base read
    (no cumprod)."""
    from mgl_tpu.ops import seed_extend as jax_seed_extend

    reads, _ = _golden(pairhmm_golden)
    reads.append(dict(bases=as_u8("A"), q=np.array([30], np.uint8),
                      i=np.array([45], np.uint8), d=np.array([45], np.uint8),
                      c=np.array([10], np.uint8)))
    for rd in reads:
        got = seed_extend.result_match(rd)
        want = jax_seed_extend.result_match(rd)
        assert got.dtype == np.float32
        assert got.view(np.uint32) == np.float32(want).view(np.uint32)


def test_staged_factors_equal_jax_package(pairhmm_golden):
    """stage_fast computes resultMatch and corr over all its reads at once
    (reads of mixed lengths, a one-base read among them): bit for bit the
    JAX package's result_match and its corr (``seed_extend.py:94-102``) a
    read, and corr 0 past each read's end."""
    from mgl_tpu.ops import seed_extend as jax_seed_extend

    reads, haps = _golden(pairhmm_golden[::3])
    reads.insert(3, dict(bases=as_u8("C"), q=np.array([0], np.uint8),
                         i=np.array([45], np.uint8),
                         d=np.array([45], np.uint8),
                         c=np.array([10], np.uint8)))
    _, rslen, corr, rm = (t.numpy() for t in seed_extend.stage_fast(
        reads, haps, [(k, 0) for k in range(len(reads))], "cpu")[:4])
    assert len({len(r["bases"]) for r in reads}) > 5
    want_rm = np.array([jax_seed_extend.result_match(r) for r in reads],
                       np.float32)
    assert np.array_equal(rm.view(np.uint32), want_rm.view(np.uint32))
    ph, one = jax_context.CTX_F32.ph2pr, np.float32(1.0)
    third = one / np.float32(3.0)
    for k, rd in enumerate(reads):
        dist = ph[np.asarray(rd["q"], np.uint8) & 127].astype(np.float32)
        with np.errstate(divide="ignore"):
            want = ((dist * third) / (one - dist)).astype(np.float32)
        assert rslen[k] == len(want)
        assert np.array_equal(corr[k, :rslen[k]].view(np.uint32),
                              want.view(np.uint32))
        assert not corr[k, rslen[k]:].any()


def test_fast_scores_plain_equals_jax_on_goldens(pairhmm_golden):
    """fast_scores_plain against mgl_tpu.ops.seed_extend.fast_scores on
    pairhmm_golden[::2]: within 1e-6 relative (the JAX test's tolerance),
    and bit-equal - the torch loop adds in the scan's order."""
    from mgl_tpu.ops import seed_extend as jax_seed_extend

    rows = pairhmm_golden[::2]
    reads, haps = _golden(rows)
    pairs = [(k, k) for k in range(len(rows))]
    got = _plain_fast(reads, haps, pairs)
    want = jax_seed_extend.fast_scores(reads, haps, pairs)
    assert got.dtype == np.float32 and len(got) == len(rows) >= 100
    nz = want != 0
    assert np.all(got[~nz] == 0)
    assert np.all(np.abs(got[nz] - want[nz]) / np.abs(want[nz]) < 1e-6)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fast_scores_plain_matches_reference_fast(pairhmm_golden):
    """fast_scores_plain within 1e-6 relative of the reference's
    compute_fast_prob (the golden ``fast`` field, hex-exact) on every
    golden row."""
    reads, haps = _golden(pairhmm_golden)
    got = _plain_fast(reads, haps, [(k, k) for k in range(len(reads))])
    want = np.array([float.fromhex(r["fast"]) for r in pairhmm_golden])
    nz = want != 0
    assert nz.sum() >= 50
    assert np.all(np.abs(got[~nz]) < 1e-30)
    assert np.all(np.abs(got[nz] - want[nz]) / np.abs(want[nz]) < 1e-6)


def test_fast_scores_plain_edge_pairs():
    """The edge pairs - haplen < rslen, haplen == rslen, a one-base read,
    N in reads and haps, a 2 kb hap, a Q0 base - bit-equal to the JAX
    scorer (NaN where it has NaN), with 0 for an empty offset range."""
    from mgl_tpu.ops import seed_extend as jax_seed_extend

    reads, haps, pairs = seed_extend_edge_set(3, long_hap=2000)
    got = _plain_fast(reads, haps, pairs)
    want = jax_seed_extend.fast_scores(reads, haps, pairs)
    assert same_scores(torch.from_numpy(got), torch.from_numpy(want.copy()))
    out = got.reshape(len(reads), len(haps))
    assert out[0, 0] == 0 and out[0, 1] == 0      # a 50-base read, shorter haps
    assert out[1, 1] > 0                          # one offset, exact
    assert np.isinf(out[2, 4]) and np.isnan(out[4, 4])
    assert np.isfinite(out[:4, :4]).all()


# the parts of seed_extend_order_set's pair list
ORDER_PARTS = {"lengths": slice(0, 30), "tandem": slice(30, 38),
               "ambiguous": slice(38, 42)}


@pytest.mark.parametrize("part", list(ORDER_PARTS))
def test_fast_scores_plain_order_set_equals_jax(part):
    """The pairs at the edges of the kernel's offsets-on-lanes design
    (seed_extend_order_set: reads of 1-257 bases at 1, 31, 32, 33 and 270
    offsets, tandem repeats where many offsets of a step add, N in read
    and hap) bit-equal to the JAX scorer; every pair has an offset with
    at most one mismatch (a 9-base read over a period-3 repeat adds up to
    inf)."""
    from mgl_tpu.ops import seed_extend as jax_seed_extend

    reads, haps, pairs = seed_extend_order_set(4)
    pairs = pairs[ORDER_PARTS[part]]
    got = _plain_fast(reads, haps, pairs)
    want = jax_seed_extend.fast_scores(reads, haps, pairs)
    assert same_scores(torch.from_numpy(got), torch.from_numpy(want.copy()))
    assert not np.isnan(got).any() and (got > 0).all()


def test_use_double_kat(pairhmm_kat):
    """use_double: the known answers within 1e-5 log10, each pair alone
    and as the diagonal of one product."""
    cases = pairhmm_kat[:12]
    reads = [kat_read(c) for c in cases]
    haps = [as_u8(c["hap"]) for c in cases]
    want = np.array([c["expected_log10"] for c in cases])
    eng = PairHmmEngine(use_double=True, device="cpu")
    single = np.array([eng.compute_likelihoods([r], [h])[0, 0]
                       for r, h in zip(reads, haps)])
    assert np.abs(single - want).max() < 1e-5
    prod = eng.compute_likelihoods(reads[:4], haps[:4])
    assert np.array_equal(np.diag(prod), single[:4])


def test_use_double_equals_jax_engine(pairhmm_golden):
    """use_double on a 4 x 3 product of golden reads and haps, against the
    JAX engine's use_double: within 1e-9 log10 (its xfloat tier against
    native f64, the tolerance of tests/test_xfloat.py)."""
    from mgl_tpu.api import PairHmmEngine as JaxEngine

    reads, _ = _golden(pairhmm_golden[:4])
    _, haps = _golden(pairhmm_golden[4:7])
    got = PairHmmEngine(use_double=True, device="cpu").compute_likelihoods(
        reads, haps)
    want = JaxEngine(use_double=True, impl="xla").compute_likelihoods(
        reads, haps)
    assert got.shape == (4, 3) and np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-9


def test_fast_path_gates_correctly(pairhmm_kat):
    """fast_path on KAT[:24], each pair alone (as tests/test_pairhmm_jax.py
    does for the JAX engine): pairs whose fast score clears MIN_ACCEPTED
    take log10(fs) - log10(2^120), within 1e-9; the rest equal the exact
    engine bit for bit."""
    cases = pairhmm_kat[:24]
    reads = [kat_read(c) for c in cases]
    haps = [as_u8(c["hap"]) for c in cases]
    fs = _plain_fast(*normalize(reads, haps),
                     [(k, k) for k in range(len(cases))])
    fast = PairHmmEngine(fast_path=True, device="cpu")
    exact = PairHmmEngine(device="cpu")
    hits = 0
    for k in range(len(cases)):
        lik = fast.compute_likelihoods([reads[k]], [haps[k]])[0, 0]
        if fs[k] >= MIN_ACCEPTED:
            hits += 1
            want = (math.log10(float(fs[k]))
                    - float(CTX_F32.log10_initial_constant))
            assert abs(lik - want) < 1e-9, k
        else:
            assert lik == exact.compute_likelihoods([reads[k]],
                                                    [haps[k]])[0, 0], k
    assert 0 < hits < len(cases)


def test_fast_path_equals_jax_engine():
    """fast_path on a 12 x 3 product where half the pairs hit, against the
    JAX engine's fast_path: within 1e-5 log10 (the hits agree to the
    bit; the rest are the f32 DP, the port's plain forward against the
    JAX scan)."""
    from mgl_tpu.api import PairHmmEngine as JaxEngine

    reads, haps = engine_region(4, 12, 3, 50, 80)
    got = PairHmmEngine(fast_path=True, device="cpu").compute_likelihoods(
        reads, haps)
    want = JaxEngine(fast_path=True, impl="xla").compute_likelihoods(
        reads, haps)
    fs = _plain_fast(*normalize(reads, haps),
                     [(r, h) for r in range(12) for h in range(3)])
    assert 0 < int((fs >= MIN_ACCEPTED).sum()) < len(fs)
    assert np.abs(got - want).max() < 1e-5


def test_fast_path_takes_shared_mode_only_without_hits(monkeypatch):
    """The fast path decides shared mode after its scores
    (ops/pairhmm.py:592): a region the estimate sends to the shared kernel
    takes it when no pair hits (every read random), and not when some do;
    use_double never takes it.  On the CPU no kernel launch is counted."""
    calls = []
    real = pairhmm_cuda.shared_scores
    monkeypatch.setattr(pairhmm_cuda, "shared_scores",
                        lambda *a: calls.append(1) or real(*a))
    reads, haps = engine_region(2, 96, 3, 40, 60)
    random_reads = no_hit_region(2, 96, 3, 40, 60)[0]
    fast = PairHmmEngine(fast_path=True, device="cpu")
    launches = seed_extend_f32.launches
    for rs, want in ((reads, 0), (random_reads, 1)):
        calls.clear()
        out = fast.compute_likelihoods(rs, haps)
        assert np.isfinite(out).all() and len(calls) == want
    assert seed_extend_f32.launches == launches    # the CPU counts none
    calls.clear()
    PairHmmEngine(use_double=True, device="cpu").compute_likelihoods(reads,
                                                                     haps)
    assert not calls
    # without the fast path the same region does take it
    PairHmmEngine(device="cpu").compute_likelihoods(reads, haps)
    assert len(calls) == 1


@pytest.mark.parametrize("mode", MODES, ids=["use_double", "fast_path"])
def test_mode_stream_equals_sequential(mode):
    """compute_likelihoods_stream in each mode, at depths 1 and 2, equals
    sequential compute_likelihoods calls bit for bit."""
    batches = [engine_region(s, n, h, 40, 60)
               for s, n, h in ((1, 24, 3), (2, 6, 1), (3, 40, 4))]
    eng = PairHmmEngine(device="cpu", **mode)
    want = [eng.compute_likelihoods(r, h) for r, h in batches]
    for depth in (1, 2):
        got = list(eng.compute_likelihoods_stream(iter(batches),
                                                  depth=depth))
        assert len(got) == len(want)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("mode", MODES, ids=["use_double", "fast_path"])
def test_mode_duplicate_haps_are_copies(mode):
    """Hap dedup in each mode: a duplicate hap's column equals its twin's
    and the distinct columns equal the call without it."""
    reads, haps = engine_region(5, 10, 3, 40, 60)
    eng = PairHmmEngine(device="cpu", **mode)
    out = eng.compute_likelihoods(reads, haps + [haps[1].copy()])
    assert np.array_equal(out[:, 3], out[:, 1])
    assert np.array_equal(out[:, :3], eng.compute_likelihoods(reads, haps))


# ---------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_seed_extend_kernel_matches_plain(cuda):
    """The seed-extend kernel against its plain version on the card, bit
    for bit (NaN where it has NaN): the edge pairs with a 30 kb hap, the
    pairs at the edges of its offsets-on-lanes design and a 512 x 12
    region's 6,144 pairs."""
    reads, haps, pairs = seed_extend_edge_set(3)
    region = normalize(*engine_region(100))
    for rs, hs, ps in ((reads, haps, pairs), seed_extend_order_set(4),
                       (*region, [(r, h) for r in range(512)
                                  for h in range(12)])):
        args = seed_extend.stage_fast(rs, hs, ps, cuda)
        before = seed_extend_f32.launches
        got = seed_extend_f32(*args)
        want = seed_extend.fast_scores_plain(*args)
        torch.cuda.synchronize()
        assert seed_extend_f32.launches == before + 1
        assert same_scores(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES, ids=["use_double", "fast_path"])
def test_modes_on_the_card_equal_cpu(cuda, mode):
    """Each mode on the card equals the same engine on device='cpu' bit for
    bit, on a 32 x 12 region, and the stream equals sequential calls."""
    batches = [engine_region(s, 32, 12) for s in (7, 8)]
    eng = PairHmmEngine(device=cuda, **mode)
    got = [eng.compute_likelihoods(r, h) for r, h in batches]
    want = PairHmmEngine(device="cpu", **mode).compute_likelihoods(
        *batches[0])
    assert np.array_equal(got[0], want)
    streamed = list(eng.compute_likelihoods_stream(iter(batches)))
    assert all(np.array_equal(a, b) for a, b in zip(streamed, got))


@pytest.mark.cuda
def test_fast_path_without_hits_on_the_card(cuda):
    """fast_path on a region with no hit takes the shared kernel on the
    card (one seed-extend launch, one shared launch, no per-pair f32
    launch) and equals the same engine on device='cpu' bit for bit."""
    reads, haps = no_hit_region(2, 96, 3, 40, 60)
    kernels = (seed_extend_f32, pairhmm_cuda.pairhmm_shared_f32,
               pairhmm_cuda.pairhmm_banded_f32)
    before = [k.launches for k in kernels]
    got = PairHmmEngine(fast_path=True, device=cuda).compute_likelihoods(
        reads, haps)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 0]
    want = PairHmmEngine(fast_path=True, device="cpu").compute_likelihoods(
        reads, haps)
    assert np.array_equal(got, want)
