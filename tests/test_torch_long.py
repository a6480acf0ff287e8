"""Long pairs and long reads through the port's two GATK entry points, past
the JAX package's VMEM range (``mgl_tpu/api/__init__.py:59-77``,
``mgl_tpu/ops/pairhmm.py:291-310``, ``docs/LIMITS.md:7-19``).

On the CPU, against ``mgl_tpu``:
- ``SmithWatermanAligner(device="cpu").align_batch`` against
  ``SmithWatermanAligner(impl="xla")`` on a pair of 800 x 6,500 bases,
  which the JAX package's aligner sends to its ``stream_carry`` tier on a
  TPU (the 12 kbp x 6.5 kbp test's query length): CIGAR and offset equal, under SOFTCLIP and INDEL (one value of
  ``indel_init`` each);
- ``PairHmmEngine(device="cpu")`` against
  ``compute_likelihoods(impl="xla")`` on three 250 bp reads against a
  4,200 bp hap (past ``_pairhmm_fits_vmem``) and on one 3,000 bp read
  against a 3,500 bp hap (the JAX streaming tier's read length): the same
  rescue decisions at 1e-28, and log10 within 1e-9 where both rescue in
  float64 and within 1e-6 elsewhere (the f32 pass: the JAX package's
  ``lax.scan`` and the port's plain forward round differently in the last
  bits, as ``test_torch_pairhmm.py``'s engine test holds); on the first
  set also within 1e-5 of ``mgl_tpu.ref_impl.pairhmm_scalar``.  The scalar
  oracle's Python loop over a 3 kb read would take most of the time, so
  the second set skips it.

The SW pair is past the JAX package's VMEM range by its query, not its
target: the port's plain version steps over every target row on every
diagonal, so a target of ~20 kb, the shortest past that range with an
800-base query, costs it ~30 s on the CPU; the card runs both shapes.

On the card (``cuda``), against the scalar oracles and the plain path:
the JAX package's TPU tests' shapes (SW 20 kbp x 5 kbp and 12 kbp x 6.5
kbp, best score equal to ``sw_scalar.calculate_matrix``'s; the engine on
three 250 bp reads against a 5.6 kbp hap within 1e-5 of
``pairhmm_scalar``, by default and under ``use_double``), the 12 kbp
pair's CIGARs against the plain path in all four strategies, and the
``longer_hap`` (16 kbp) and ``long_read`` (4 x 4 kb reads against 3 x 6
kb haps) sets in all three modes bit-equal to ``device="cpu"``.  The two
SW oracle tests run the oracle's Python loop over 78-100M cells and are
marked ``slow``.  These import no jax:
``python -m pytest tests/test_torch_long.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from mgl_tpu_torch.api import (OverhangStrategy, PairHmmEngine,
                               SmithWatermanAligner, SWParameters)
from mgl_tpu_torch.kernels import sw_cuda
from mgl_tpu_torch.tables import MIN_ACCEPTED
from mgl_tpu_torch.testing import (ACGT, ENGINE_MODES, LONG_SW_PAIRS,
                                   engine_on_cpu, long_pairhmm,
                                   long_pairhmm_set,
                                   long_read_set, long_sw_pair,
                                   sw_plain_cigars)

PARAMS = SWParameters(25, -50, 110, 6)  # STANDARD_NGS

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


# ---------------------------------------------------------------- the CPU

@pytest.mark.parametrize("strategy", [OverhangStrategy.SOFTCLIP,
                                      OverhangStrategy.INDEL])
def test_sw_long_query_equals_jax(strategy):
    """800 x 6,500 bases, past the JAX aligner's VMEM and streaming
    ranges: CIGAR and offset equal to ``mgl_tpu``'s XLA aligner's."""
    from mgl_tpu.api import SmithWatermanAligner as JaxAligner
    from mgl_tpu.api import _sw_fits_stream, _sw_fits_vmem

    rng = np.random.default_rng(5)
    q = rng.choice(ACGT, 6_500)
    tgt = q[3_000:3_800].copy()
    mut = rng.random(len(tgt)) < 0.01
    tgt[mut] = rng.choice(ACGT, int(mut.sum()))
    assert not _sw_fits_vmem(len(tgt), len(q))
    assert not _sw_fits_stream(len(tgt), len(q))
    got = SmithWatermanAligner(device="cpu").align_batch([tgt], [q], PARAMS,
                                                         strategy)
    want = JaxAligner(impl="xla").align_batch([tgt], [q], PARAMS, strategy)
    assert [(r.cigar, r.offset) for r in got] == [(r.cigar, r.offset)
                                                   for r in want]
    assert "S" in got[0].cigar or strategy != OverhangStrategy.SOFTCLIP


@pytest.mark.parametrize("name, args, scalar", [
    ("3 x 250 bp against 4,200 bp", (47, 4_200), True),
    ("3,000 bp against 3,500 bp", (9, 1, 3_000, 1, 3_500), False),
])
def test_pairhmm_long_equals_jax(name, args, scalar):
    """The engine on ``device="cpu"`` against the JAX engine's XLA path
    (module docstring's tolerances) with the same rescue decisions, and on
    the first set against the scalar oracle within 1e-5 log10."""
    import mgl_tpu.ops.pairhmm as P
    from mgl_tpu.ref_impl import pairhmm_scalar

    from mgl_tpu_torch.kernels.pairhmm_cuda import scores
    from mgl_tpu_torch.ops.pairhmm import normalize
    from mgl_tpu_torch.tables import CTX_F32

    if len(args) == 2:
        reads, haps = long_pairhmm_set(*args)
    else:
        reads, haps = long_read_set(*args)
    r_len, h_len = len(reads[0]["bases"]), len(haps[0])
    assert not P._pairhmm_fits_vmem(r_len, h_len), name
    got = PairHmmEngine(device="cpu").compute_likelihoods(reads, haps)
    want = P.compute_likelihoods(reads, haps, impl="xla")
    assert got.shape == want.shape == (len(reads), len(haps))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    # the rescue decisions: each f32 pass's scores against the 1e-28 gate
    n_r, n_h = normalize(reads, haps)
    pairs = [(r, h) for r in range(len(reads)) for h in range(len(haps))]
    f32 = scores(n_r, n_h, pairs, CTX_F32, "cpu").numpy()
    f32_jax = P.forward_scores_xla(P.pack_pairs(n_r, n_h, pairs))
    rescued = (f32 < float(MIN_ACCEPTED)).reshape(got.shape)
    assert np.array_equal(rescued,
                          (f32_jax < float(MIN_ACCEPTED)).reshape(got.shape))
    err = np.abs(got - want)
    assert err[rescued].max(initial=0.0) < 1e-9
    assert err[~rescued].max(initial=0.0) < 1e-6
    if scalar:
        oracle = pairhmm_scalar.compute_likelihoods(reads, haps)
        assert np.abs(got - oracle).max() < 1e-5


# ---------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("key", sorted(LONG_SW_PAIRS))
def test_sw_long_pair_best_score_cuda(cuda, key):
    """The JAX package's TPU long-pair tests' shapes through the aligner's
    bucket path on the card: the banded kernel's best score (ScoreMax
    ``max``, which ``align_batch`` decodes from) equals the scalar
    oracle's, and ``align_batch`` returns a CIGAR that spans the query."""
    from mgl_tpu.core.params import OverhangStrategy as JS
    from mgl_tpu.core.params import SWParameters as JP
    from mgl_tpu.ref_impl.sw_scalar import calculate_matrix

    tgt, q = long_sw_pair(*LONG_SW_PAIRS[key])
    _, _, ez, _ = sw_cuda._traceback(
        sw_cuda.sw_banded, [tgt.tobytes()], [q.tobytes()], PARAMS,
        OverhangStrategy.SOFTCLIP, cuda)
    _, want = calculate_matrix(tgt, q, JP(25, -50, 110, 6), JS.SOFTCLIP)
    assert int(ez[2, 0]) == int(want["max"])
    res = SmithWatermanAligner(device=cuda).align_batch(
        [tgt], [q], PARAMS, OverhangStrategy.SOFTCLIP)[0]
    assert res.cigar and res.offset >= 0


@pytest.mark.cuda
def test_sw_12k_pair_cigars_equal_plain_cuda(cuda):
    """The 12 kbp x 6.5 kbp pair, whose traceback the TPU could not
    compile: ``align_batch`` on the card gives the plain path's CIGAR and
    offset in all four strategies."""
    tgt, q = long_sw_pair(*LONG_SW_PAIRS["12k_x_6.5k"])
    want, _ = sw_plain_cigars("12k_x_6.5k", cuda)
    for s in OverhangStrategy:
        got = SmithWatermanAligner(device=cuda).align_batch([tgt], [q],
                                                            PARAMS, s)
        assert [(r.cigar, r.offset) for r in got] == want[int(s)], s.name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "use_double"])
def test_pairhmm_long_hap_scalar_cuda(cuda, mode):
    """Three 250 bp reads against a 5.6 kbp hap (the JAX package's TPU
    test) through the engine on the card: within 1e-5 log10 of the scalar
    oracle."""
    from mgl_tpu.ref_impl import pairhmm_scalar

    reads, haps = long_pairhmm("long_hap")
    got = PairHmmEngine(device=cuda, **ENGINE_MODES[mode]
                        ).compute_likelihoods(reads, haps)
    want = pairhmm_scalar.compute_likelihoods(reads, haps)
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
@pytest.mark.parametrize("name", ["longer_hap", "long_read"])
def test_pairhmm_long_sets_equal_cpu_cuda(cuda, name, mode):
    """``longer_hap`` (three 250 bp reads against a 16 kbp hap) and
    ``long_read`` (4 reads of 4 kb against 3 haps of 6 kb, every pair
    rescued) in each mode: the card's matrix bit-equal to
    ``device="cpu"``'s."""
    reads, haps = long_pairhmm(name)
    got = PairHmmEngine(device=cuda, **ENGINE_MODES[mode]
                        ).compute_likelihoods(reads, haps)
    want = engine_on_cpu(name, mode)
    assert np.isfinite(got).all()
    assert np.array_equal(got, want)
