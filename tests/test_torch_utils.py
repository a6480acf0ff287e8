"""The port's metrics, logging and opt-in self-check (``mgl_tpu_torch.
utils``) and its copies of the NumPy oracles (``mgl_tpu_torch.ref_impl``),
held against the JAX package's.  Small shapes on the CPU; nothing here
needs a card.
"""

import json
import logging

import numpy as np
import pytest
import torch

from conftest import as_u8
from mgl_tpu.core.context import CTX_F32 as JAX_CTX_F32
from mgl_tpu.core.context import CTX_F64 as JAX_CTX_F64
from mgl_tpu.core.params import OverhangStrategy as JaxStrategy
from mgl_tpu.core.params import SWParameters as JaxParams
from mgl_tpu.ref_impl import pairhmm_scalar as jax_pairhmm_scalar
from mgl_tpu.ref_impl import sw_scalar as jax_sw_scalar
from mgl_tpu_torch.api import (OverhangStrategy, PairHmmEngine,
                               SmithWatermanAligner, SWParameters, SWResult)
from mgl_tpu_torch.kernels import sw_cuda
from mgl_tpu_torch.ref_impl import pairhmm_scalar, sw_scalar
from mgl_tpu_torch.tables import CTX_F32, CTX_F64
from mgl_tpu_torch.testing import engine_region, golden_read, sw_pairs
from mgl_tpu_torch.utils import debug_check
from mgl_tpu_torch.utils import logging as mlog
from mgl_tpu_torch.utils.metrics import METRICS, Metrics, profile_trace

torch.set_num_threads(1)

P = SWParameters(25, -50, 110, 6)
SOFT = OverhangStrategy.SOFTCLIP


def test_metrics_after_align_batch():
    """align_batch records the JAX package's SW metrics: pairs, buckets
    and one align_batch timer call."""
    METRICS.reset()
    targets, queries = sw_pairs(2, 5, (20, 60), (20, 300))
    SmithWatermanAligner(device="cpu").align_batch(targets, queries, P, SOFT)
    snap = METRICS.snapshot()
    assert snap["counters"]["sw.pairs"] == 5
    assert snap["counters"]["sw.buckets"] >= 2    # 300 bp queries bucket apart
    assert snap["calls"]["sw.align_batch"] == 1
    assert snap["timers_s"]["sw.align_batch"] >= 0
    assert json.loads(METRICS.dump()) == snap


def test_metrics_after_compute_likelihoods():
    """A shared-mode region with a rescue tail records the engine's
    timers: engine.f32 (the shared pass's dispatch and fetch) and
    engine.rescue (the rescue's dispatch and fetch)."""
    METRICS.reset()
    reads, haps = engine_region(2, 96, 3, 80, 110)
    PairHmmEngine(device="cpu").compute_likelihoods(reads, haps)
    snap = METRICS.snapshot()
    assert snap["calls"]["engine.f32"] == 2
    assert snap["calls"]["engine.rescue"] == 2
    METRICS.reset()
    assert METRICS.snapshot() == {"counters": {}, "timers_s": {}, "calls": {}}


def test_metrics_counts_and_timer_calls_add_up():
    """A Metrics object sums counts and counts timer calls."""
    m = Metrics()
    for _ in range(3):
        m.count("x", 2)
        with m.timer("t"):
            pass
    assert m.counters["x"] == 6 and m.calls["t"] == 3


def test_debug_check_passes_on_a_correct_batch(monkeypatch):
    """MGL_TPU_DEBUG_CHECK=1 re-derives every CIGAR with the port's NumPy
    oracle and passes on a correct batch, all four strategies."""
    monkeypatch.setenv("MGL_TPU_DEBUG_CHECK", "1")
    assert debug_check.enabled()
    targets, queries = sw_pairs(3, 6, (10, 70), (5, 70), err=0.08)
    for strategy in OverhangStrategy:
        got = SmithWatermanAligner(device="cpu").align_batch(
            targets, queries, P, strategy)
        assert len(got) == 6
    monkeypatch.setenv("MGL_TPU_DEBUG_CHECK", "0")
    assert not debug_check.enabled()


def test_debug_check_raises_on_a_corrupted_result(monkeypatch):
    """With MGL_TPU_DEBUG_CHECK=1 a wrong CIGAR from the kernel path
    raises; without it the wrong result goes through."""
    real = sw_cuda.align_batch_banded

    def corrupted(*args):
        out = real(*args)
        cig, off = out[0]
        return [(cig, off + 1)] + out[1:]

    monkeypatch.setattr(sw_cuda, "align_batch_banded", corrupted)
    aligner = SmithWatermanAligner(device="cpu")
    pair = ([b"ACGTACGTTTGACCA"], [b"ACGTACGTTTGACCA"])
    assert aligner.align_batch(*pair, P, SOFT)[0] == SWResult("15M", 1)
    monkeypatch.setenv("MGL_TPU_DEBUG_CHECK", "1")
    with pytest.raises(AssertionError, match="pair 0"):
        aligner.align_batch(*pair, P, SOFT)


def test_check_pairhmm_scores(pairhmm_golden):
    """check_pairhmm_scores (not wired into the engine, as in the JAX
    package) passes on the oracle's own f32 scores and raises on a score
    moved by 1e-3 log10."""
    rows = [r for r in pairhmm_golden
            if float.fromhex(r["scalarf"]) >= 1e-28][:3]
    reads = [golden_read(r) for r in rows]
    haps = [as_u8(r["hap"]) for r in rows]
    pairs = [(k, k) for k in range(3)]
    scores = np.array([float.fromhex(r["scalarf"]) for r in rows])
    debug_check.check_pairhmm_scores(reads, haps, pairs, scores)
    scores[1] *= 10 ** 1e-3
    with pytest.raises(AssertionError, match="pair 1"):
        debug_check.check_pairhmm_scores(reads, haps, pairs, scores)


def test_sw_oracle_copy_equals_jax_package(sw_golden):
    """The port's sw_scalar gives the JAX package's CIGAR and offset on a
    sample of the SW goldens, each with its own parameters and strategy,
    and both give the golden's."""
    rows = [r for r in sw_golden
            if len(r["target"]) <= 60 and len(r["query"]) <= 60][::4][:24]
    assert len(rows) == 24
    for r in rows:
        t, q = r["target"].encode(), r["query"].encode()
        raw = (r["match"], r["mismatch"], r["open"], r["ext"])
        got = sw_scalar.align(t, q, SWParameters.normalized(*raw),
                              OverhangStrategy(r["strategy"]))
        want = jax_sw_scalar.align(t, q, JaxParams.normalized(*raw),
                                   JaxStrategy(r["strategy"]))
        assert got == want == (r["cigar_scalar"], r["offset_scalar"])


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_pairhmm_oracle_copy_equals_jax_package(pairhmm_golden, precision):
    """The port's pairhmm_scalar gives the JAX package's scores bit for
    bit on a sample of the PairHMM goldens, and the golden's own value
    (``scalarf`` / ``scalard``) within 1e-5 log10 where it is above 0."""
    ours, theirs = ((CTX_F32, JAX_CTX_F32) if precision == "f32"
                    else (CTX_F64, JAX_CTX_F64))
    for r in [r for r in pairhmm_golden if len(r["read"]) <= 60][:6]:
        rd = golden_read(r)
        args = (as_u8(r["hap"]), rd["bases"], rd["q"], rd["i"], rd["d"],
                rd["c"])
        got = pairhmm_scalar.compute_score(*args, ctx=ours)
        assert got == jax_pairhmm_scalar.compute_score(*args, ctx=theirs)
        want = float.fromhex(r["scalarf" if precision == "f32"
                                else "scalard"])
        if want > 0:
            assert abs(np.log10(got) - np.log10(want)) < 1e-5


def test_logger_namespace_levels_and_bucket_log(monkeypatch):
    """get_logger('engine') is mgl_tpu_torch.engine; MGL_TPU_LOG sets the
    global and per-component levels; align_batch logs each bucket's
    shape and device there at debug level."""
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    log = mlog.get_logger("engine")
    assert log.name == "mgl_tpu_torch.engine"
    keep = Keep()
    log.addHandler(keep)
    try:
        monkeypatch.setenv("MGL_TPU_LOG", "info,engine=debug")
        mlog.configure(force=True)
        assert logging.getLogger("mgl_tpu_torch").level == logging.INFO
        assert log.level == logging.DEBUG
        SmithWatermanAligner(device="cpu").align_batch(
            [b"ACGTACGT"], [b"ACGAACGT"], P, SOFT)
        msgs = [r.getMessage() for r in records]
        assert "sw bucket (64, 64) x1 on cpu" in msgs, msgs
    finally:
        log.removeHandler(keep)
        log.setLevel(logging.NOTSET)
        monkeypatch.delenv("MGL_TPU_LOG")
        mlog.configure(force=True)
    assert logging.getLogger("mgl_tpu_torch").level == logging.WARNING


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """profile_trace writes a Chrome trace of what ran inside it."""
    with profile_trace(str(tmp_path)) as where:
        assert where == str(tmp_path)
        torch.ones(8) + 1
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
