"""mgl_tpu_torch's per-pair banded PairHMM kernels (``csrc/pairhmm_banded.cu``
in float, the product-mode pass, and in double, the f64 rescue tier).

On the CPU: the rule that picks the kernels' warps a pair
(``pair_warps``), the refusal of a bad forced W by both wrappers, and the
plain version the kernels are held to (``ops.pairhmm.forward_plain``) at
edge shapes - reads of 1, 31, 32, 33, 64, 65 and 320 bases against haps
of 1, 7, 420 and 2,000 - against the JAX package: f32 against
``mgl_tpu.ops.pairhmm.forward_scores_xla`` and f64 against the scalar
CTX_F64 oracle ``mgl_tpu.ref_impl.pairhmm_scalar.compute_score``.  Small
shapes and one thread.

On the card (``cuda``): both kernels at every W from 1 to BANDED_WARPS_MAX
and the wrapper's, bit-equal to the plain version on reads of 1 to 1,100
bases (35 bands, so a read wraps) against haps of 7 to 2,000, with the
carry row in shared memory; on haps of 16 kb (f64) and 30 kb (f32), whose
row the launcher puts in global memory; and the engine's 384-pair rescue
bucket of a GATK region.  The JAX package is imported only inside the CPU
tests that use it, so the card tests also run on a GPU host without it:
``python -m pytest tests/test_torch_banded_pairhmm.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from mgl_tpu_torch.batch.bucketing import bucket_pairs
from mgl_tpu_torch.kernels import pairhmm_cuda as ph
from mgl_tpu_torch.ops.pairhmm import forward_plain, normalize
from mgl_tpu_torch.tables import CTX_F32, CTX_F64, MIN_ACCEPTED
from mgl_tpu_torch.testing import engine_region, pair_edge_set

torch.set_num_threads(1)
H100_SMS = 132
KERNELS = {"f32": (CTX_F32, ph.pairhmm_banded_f32),
           "f64": (CTX_F64, ph.pairhmm_banded_f64)}


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("n_pairs, n_bands, sm_count, want", [
    (384, 5, H100_SMS, 5),             # the rescue tier: 32 reads x 12 haps
    (6144, 5, H100_SMS, 1),            # a 512 x 12 product fills the card
    (1000, 5, H100_SMS, 3),            # W = 2 wanted: two rounds, of 3
    (512, 2, H100_SMS, 2),             # 128 x 4 at 60 bp
    (24, 8, H100_SMS, 8),              # 250 bp reads against a long hap
    (4, 35, H100_SMS, 12),             # 1,100 bp: over the cap, 3 rounds
    (1, 40, H100_SMS, 14),             # W = 12 wanted: 3 rounds of 14
    (1, 1, H100_SMS, 1),
])
def test_warps_per_pair_rule(n_pairs, n_bands, sm_count, want):
    """W is at most the bands and BANDED_WARPS_MAX, at least the W that
    puts WARPS_PER_SM warps on each SM holding a pair (where the bands
    and the cap allow), and shares the bands evenly: a read of more bands
    than the cap wraps over rounds that differ by at most one band."""
    w = ph.pair_warps(n_pairs, n_bands, sm_count)
    assert w == want
    assert 1 <= w <= min(n_bands, ph.BANDED_WARPS_MAX)
    rounds = -(-n_bands // w)
    assert -(-n_bands // rounds) == w          # fewest warps for its rounds
    target = min(n_pairs, sm_count) * ph.WARPS_PER_SM
    if n_bands <= ph.BANDED_WARPS_MAX:
        assert n_pairs * w >= target or w == n_bands


@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("warps", [0, ph.BANDED_WARPS_MAX + 1, 2.0])
def test_forced_w_out_of_range_is_refused(precision, warps):
    """Forcing a W the kernel does not take raises before anything runs,
    on CPU tensors too, in both wrappers."""
    ctx, kernel = KERNELS[precision]
    reads, haps, pairs = pair_edge_set(1, (10, 40), (30,))
    args = ph.stage_pairs(*normalize(reads, haps), pairs, ctx, "cpu")
    with pytest.raises(ValueError, match="warps_per_pair"):
        kernel(*args, warps_per_pair=warps)


def _edge_pairs():
    """Reads of 1 to 320 bases (one band, its edges, two and ten bands)
    against haps of 1 base (the shortest the engine takes), 7, 420 and
    2,000 bases: 28 pairs, normalized."""
    reads, haps, pairs = pair_edge_set(9, (1, 31, 32, 33, 64, 65, 320),
                                       (1, 7, 420, 2000))
    return (*normalize(reads, haps), pairs)


def test_plain_f32_on_edge_shapes_vs_xla_spec():
    """The f32 plain version against forward_scores_xla on the edge pairs:
    relative error <= 2e-6 on every pair the cascade keeps (score >=
    1e-28), and the same rescue decisions.  Not bit-equal: XLA:CPU
    contracts into FMA and flushes denormals (test_torch_pairhmm.py's
    test_plain_f32_vs_xla_spec), which is also why pairs under the gate,
    which the f64 tier recomputes, may differ."""
    from mgl_tpu.ops.pairhmm import forward_scores_xla, pack_pairs

    reads, haps, pairs = _edge_pairs()
    got = ph.scores(reads, haps, pairs, CTX_F32, "cpu").numpy()
    want = forward_scores_xla(pack_pairs(reads, haps, pairs))
    keep = want >= float(MIN_ACCEPTED)
    assert 8 <= keep.sum() < len(pairs)
    rel = np.abs(got.astype(np.float64) - want)[keep] / want[keep]
    assert rel.max() <= 2e-6, rel.max()
    assert np.array_equal(got < float(MIN_ACCEPTED), ~keep)


def test_plain_f64_on_edge_shapes_vs_scalar_oracle():
    """The f64 plain version (the rescue tier's) against the scalar CTX_F64
    oracle on the edge pairs: relative error <= 1e-12, as
    test_torch_pairhmm.py's test_plain_f64_vs_rescue_references."""
    from mgl_tpu.core import context as jax_ctx
    from mgl_tpu.ref_impl.pairhmm_scalar import compute_score

    reads, haps, pairs = _edge_pairs()
    got = ph.scores(reads, haps, pairs, CTX_F64, "cpu").numpy()
    assert (got > 0).all()
    for k, (ri, hi) in enumerate(pairs):
        rd = reads[ri]
        s = compute_score(haps[hi], rd["bases"], rd["q"], rd["i"], rd["d"],
                          rd["c"], ctx=jax_ctx.CTX_F64)
        assert abs(got[k] - s) <= 1e-12 * abs(s), (k, got[k], s)


def _every_w(args, kernel):
    want = forward_plain(*args)
    for w in (None, *range(1, ph.BANDED_WARPS_MAX + 1)):
        got = kernel(*args, warps_per_pair=w)
        torch.cuda.synchronize()
        assert torch.equal(got, want), w


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_every_w_matches_plain(cuda, precision):
    """Every W from 1 to BANDED_WARPS_MAX (and the wrapper's) gives the
    plain version's bits on reads of 1 to 1,100 bases against haps of 7 to
    2,000, with the carry row in shared memory."""
    ctx, kernel = KERNELS[precision]
    reads, haps, pairs = pair_edge_set(
        3, (1, 31, 32, 33, 64, 65, 151, 320, 1100), (7, 100, 420, 2000))
    args = ph.stage_pairs(*normalize(reads, haps), pairs, ctx, cuda)
    for w in range(1, ph.BANDED_WARPS_MAX + 1):
        assert ph.banded_carry_in_shared(len(pairs), args[3].shape[1], w,
                                         args[0].dtype, cuda)
    _every_w(args, kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("precision, hap_len",
                         [("f32", 30_000), ("f64", 16_000)])
def test_global_carry_row_matches_plain(cuda, precision, hap_len):
    """A hap of 30 kb in f32 or 16 kb in f64 has a carry row too large for
    a block's shared memory: the launcher puts it in global memory, unlike
    at the rescue tier's shape, and every W still gives the plain
    version's bits."""
    ctx, kernel = KERNELS[precision]
    reads, haps, pairs = pair_edge_set(4, (1, 33, 151, 700), (hap_len,))
    args = ph.stage_pairs(*normalize(reads, haps), pairs, ctx, cuda)
    dtype = args[0].dtype
    assert ph.banded_carry_in_shared(384, 420, 5, dtype, cuda)
    for w in range(1, ph.BANDED_WARPS_MAX + 1):
        assert not ph.banded_carry_in_shared(len(pairs), args[3].shape[1], w,
                                             dtype, cuda)
    _every_w(args, kernel)


@pytest.mark.cuda
def test_engine_rescue_bucket_matches_plain(cuda):
    """The engine's rescue of a GATK region (512 reads x 12 haps of 151 x
    420, every 16th read random at high qualities): the f32 pass of the
    shared kernel leaves the 384 pairs of the random reads under 1e-28, in
    one length bucket, and the f64 kernel scores them bit-equal to the
    plain version at the wrapper's W and at W = 1 to 5."""
    reads, haps = normalize(*engine_region(100))
    f32 = ph.shared_scores(reads, haps, cuda)().reshape(-1)
    rescue = np.nonzero(f32 < float(MIN_ACCEPTED))[0]
    pairs = [(int(b) // 12, int(b) % 12) for b in rescue]
    assert pairs == [(r, h) for r in range(0, 512, 16) for h in range(12)]
    buckets = bucket_pairs([151] * len(pairs), [420] * len(pairs))
    assert len(buckets) == 1
    args = ph.stage_pairs(reads, haps, pairs, CTX_F64, cuda)
    want = forward_plain(*args)
    for w in (None, 1, 2, 3, 4, 5):
        got = ph.pairhmm_banded_f64(*args, warps_per_pair=w)
        torch.cuda.synchronize()
        assert torch.equal(got, want), w
