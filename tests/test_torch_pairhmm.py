"""mgl_tpu_torch's PairHMM path on the CPU, held to the JAX package.

The port's plain torch forward (the CUDA kernels' plain version) against
the JAX package's XLA spec and its f64 rescue references, its device
tables against the JAX package's, and the engine against known answers
and ``mgl_tpu.api.PairHmmEngine(impl="xla")``.  Small shapes: a few
seconds on one thread.
"""

import math

import numpy as np
import pytest
import torch

from conftest import as_u8, kat_read
from mgl_tpu.core import context as jax_ctx
from mgl_tpu.ops.pairhmm import forward_scores_xla, pack_pairs
from mgl_tpu_torch.api import PairHmmEngine
from mgl_tpu_torch.kernels.pairhmm_cuda import scores
from mgl_tpu_torch.ops.pairhmm import normalize, pair_likelihoods
from mgl_tpu_torch.tables import (CTX_F32, CTX_F64, MIN_ACCEPTED,
                                  context_tables)
from mgl_tpu_torch.testing import golden_read

torch.set_num_threads(1)


def test_plain_f32_vs_xla_spec(pairhmm_kat):
    """The plain f32 forward against forward_scores_xla on the 105 KAT
    pairs: relative error <= 2e-6, and identical rescue decisions.

    Not bit-equal, on purpose: XLA:CPU contracts a*b+c into FMA (so
    jax.jit(lambda a, b, c, d: c*(a*b+(c+d)*a)) differs bitwise from numpy
    on the CPU), while torch rounds every op as numpy does, and so does
    the CUDA kernel, built with --fmad=false.  The largest relative error
    measured on these pairs is 1.12e-6; on the card the kernel is held to
    this plain version bit for bit instead (tests/test_torch_slice.py)."""
    reads, haps = normalize([kat_read(c) for c in pairhmm_kat],
                            [as_u8(c["hap"]) for c in pairhmm_kat])
    pairs = [(k, k) for k in range(len(reads))]
    got = scores(reads, haps, pairs, CTX_F32, "cpu").numpy()
    want = forward_scores_xla(pack_pairs(reads, haps, pairs))
    rel = np.abs(got.astype(np.float64) - want) / np.abs(want)
    assert rel.max() <= 2e-6, rel.max()
    assert np.array_equal(got < MIN_ACCEPTED, want < MIN_ACCEPTED)


def test_plain_f64_vs_rescue_references(pairhmm_golden):
    """The plain f64 forward on the golden rows whose f32 score underflows
    (the rescue tier) against the native f64 kernel and the scalar
    CTX_F64 oracle: relative error <= 1e-12."""
    from mgl_tpu.native import pairhmm_f64_rescue
    from mgl_tpu.ref_impl.pairhmm_scalar import compute_score

    rows = [r for r in pairhmm_golden
            if float.fromhex(r["scalarf"]) < float(MIN_ACCEPTED)]
    assert len(rows) >= 40
    reads, haps = normalize([golden_read(r) for r in rows],
                            [as_u8(r["hap"]) for r in rows])
    pairs = [(k, k) for k in range(len(rows))]
    got = scores(reads, haps, pairs, CTX_F64, "cpu").numpy()
    native = pairhmm_f64_rescue(reads, haps, pairs)
    assert native is not None
    assert (np.abs(got - native) / np.abs(native)).max() <= 1e-12
    for k in range(0, len(rows), 5):
        rd = reads[k]
        s = compute_score(haps[k], rd["bases"], rd["q"], rd["i"], rd["d"],
                          rd["c"], ctx=jax_ctx.CTX_F64)
        assert abs(got[k] - s) <= 1e-12 * abs(s), k


def test_tables_equal_jax_tables():
    """context_tables holds the JAX package's device tables bit for bit:
    _ctx_tables_f32() for the main pass, and the f64 arrays that
    _xf_tables() splits for the rescue (ph2pr, match_to_match, 1 - ph2pr,
    ph2pr / 3, as this port derives them on the device)."""
    from mgl_tpu.kernels.pairhmm_pallas import _ctx_tables_f32
    from mgl_tpu.kernels.pairhmm_xf_pallas import _xf_tables
    from mgl_tpu.ops.xfloat import xf_split

    t32 = context_tables(CTX_F32, "cpu")
    for ours, theirs in zip((t32["ph2pr"], t32["match_to_match"],
                             t32["base_enc"]), _ctx_tables_f32()):
        assert ours.numpy().dtype == np.asarray(theirs).dtype
        assert np.array_equal(ours.numpy(), np.asarray(theirs))
    t64 = context_tables(CTX_F64, "cpu")
    ph, m2m = t64["ph2pr"], t64["match_to_match"]
    xf = _xf_tables()
    for name, ours in (("ph", ph), ("m2m", m2m), ("omph", 1.0 - ph),
                       ("ph3", ph * t64["one_third"])):
        assert ours.dtype == torch.float64
        for a, b in zip(xf_split(ours.numpy()), xf[name]):
            assert np.array_equal(a, np.asarray(b)), name
    assert (t32["dtype"], t64["dtype"]) == (torch.float32, torch.float64)


def test_context_copy_equals_jax_package():
    """The port's own copy of the quality contexts (mgl_tpu_torch.core.
    context and its npz) holds the JAX package's arrays and constants bit
    for bit."""
    import mgl_tpu_torch.core.context as port_ctx

    for name in ("CTX_F32", "CTX_F64"):
        ours, theirs = getattr(port_ctx, name), getattr(jax_ctx, name)
        assert ours.dtype is theirs.dtype
        for field in ("ph2pr", "match_to_match", "jacobian_log"):
            a, b = getattr(ours, field), getattr(theirs, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, field)
        for field in ("initial_constant", "log10_initial_constant"):
            a, b = getattr(ours, field), getattr(theirs, field)
            assert type(a) is type(b) and a == b, (name, field)
    assert port_ctx.MIN_ACCEPTED == jax_ctx.MIN_ACCEPTED
    assert port_ctx.MIN_ACCEPTED.dtype == jax_ctx.MIN_ACCEPTED.dtype


def test_engine_kat(pairhmm_kat):
    """The port's cascade on the 105 known-answer pairs: all within 1e-5
    log10."""
    reads = [kat_read(c) for c in pairhmm_kat]
    haps = [as_u8(c["hap"]) for c in pairhmm_kat]
    got = pair_likelihoods(reads, haps, [(k, k) for k in range(len(reads))],
                           "cpu")
    want = np.array([c["expected_log10"] for c in pairhmm_kat])
    assert (np.abs(got - want) < 1e-5).sum() == len(pairhmm_kat)


def _product_fixture(seed: int = 3):
    """8 reads x 4 haps in one (64, 64) length bucket: six reads drawn from
    the first hap with one error, two random reads with high qualities
    whose f32 scores underflow into the rescue tier."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, 64)
    haps = [base[:60].copy() for _ in range(4)]
    for k, h in enumerate(haps[1:], 1):
        h[10 * k] = acgt[(int(np.searchsorted(acgt, h[10 * k])) + 1) % 4]
    reads = []
    for k in range(8):
        n = int(rng.integers(40, 56))
        if k < 6:
            st = int(rng.integers(0, 60 - n))
            b = base[st:st + n].copy()
            b[rng.integers(0, n)] = acgt[rng.integers(0, 4)]
            q = rng.integers(15, 40, n).astype(np.uint8)
            c = np.full(n, 10, np.uint8)
        else:               # gaps dear too, so no path escapes the mismatches
            b = rng.choice(acgt, n)
            q = rng.integers(50, 60, n).astype(np.uint8)
            c = np.full(n, 40, np.uint8)
        reads.append(dict(bases=b, q=q, i=q, d=q, c=c))
    return reads, haps


def test_engine_product_vs_jax_engine():
    """compute_likelihoods on a product of 8 reads x 4 haps that includes
    rescue pairs agrees with mgl_tpu.api.PairHmmEngine(impl='xla') within
    1e-6 log10."""
    from mgl_tpu.api import PairHmmEngine as JaxEngine

    reads, haps = _product_fixture()
    got = PairHmmEngine(device="cpu").compute_likelihoods(reads, haps)
    want = JaxEngine(impl="xla").compute_likelihoods(reads, haps)
    assert got.shape == want.shape == (8, 4)
    f32 = scores(*normalize(reads, haps),
                 [(r, h) for r in range(8) for h in range(4)], CTX_F32,
                 "cpu").numpy()
    assert (f32 < MIN_ACCEPTED).sum() >= 2          # the rescue tier ran
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() < 1e-6


def test_log10_scaling_of_a_single_pair(pairhmm_kat):
    """One pair through the public engine: the f32 score's log10 minus the
    context's log10(2^120) (a float32 constant, as in the reference)."""
    c = pairhmm_kat[0]
    read, hap = kat_read(c), as_u8(c["hap"])
    out = PairHmmEngine(device="cpu").compute_likelihoods([read], [hap])
    s = float(scores(*normalize([read], [hap]), [(0, 0)], CTX_F32,
                     "cpu")[0])
    assert s >= float(MIN_ACCEPTED)
    lic = float(CTX_F32.log10_initial_constant)
    assert lic == pytest.approx(120 * math.log10(2.0), abs=1e-5)
    assert out[0, 0] == pytest.approx(math.log10(s) - lic, abs=1e-12)
