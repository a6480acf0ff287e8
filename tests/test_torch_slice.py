"""The mgl_tpu_torch slice end to end: both GATK entry points, the device
rule, the import rule, and (on a card) each CUDA kernel against its plain
torch version.

This file imports no jax, so its ``cuda`` tests also run on a GPU host
without jax: ``python -m pytest tests/test_torch_slice.py -m cuda``.
Small shapes throughout: the CPU tests take a few seconds on one thread.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import as_u8, kat_read
from mgl_tpu.core.params import OverhangStrategy, SWParameters
from mgl_tpu.ref_impl import sw_scalar
from mgl_tpu_torch.api import PairHmmEngine, SmithWatermanAligner
from mgl_tpu_torch.kernels import pairhmm_cuda, sw_cuda
from mgl_tpu_torch.ops.pairhmm import normalize, pair_likelihoods
from mgl_tpu_torch.ops.sw import banded_layout
from mgl_tpu_torch.tables import CTX_F32, CTX_F64
from mgl_tpu_torch.testing import (golden_groups, golden_read, sw_pairs,
                                   sw_tensors, traceback_mismatches)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _sw_cases(sw_golden, max_len):
    rows = [r for r in sw_golden
            if len(r["target"]) <= max_len and len(r["query"]) <= max_len]
    return rows, golden_groups(rows)


def _check_sw_golden(aligner, groups):
    for (m, x, o, e, s), rs in groups.items():
        got = aligner.align_batch([r["target"].encode() for r in rs],
                                  [r["query"].encode() for r in rs],
                                  SWParameters.normalized(m, x, o, e),
                                  OverhangStrategy(s))
        for r, g in zip(rs, got):
            assert (g.cigar, g.offset) == (r["cigar_scalar"],
                                           r["offset_scalar"]), r


def test_sw_entry_point_cpu(sw_golden):
    """align_batch on device='cpu' (plain torch) reproduces the golden
    CIGARs and offsets, all four strategies, pairs up to 40 bp."""
    rows, groups = _sw_cases(sw_golden, 40)
    assert len(rows) >= 40
    _check_sw_golden(SmithWatermanAligner(device="cpu"), groups)
    # a fresh pair, held to the scalar reference of sw.cpp
    targets, queries = sw_pairs(5, 6, (20, 90), (11, 90), err=0.08)
    p = SWParameters(25, -50, 110, 6)
    got = SmithWatermanAligner(device="cpu").align_batch(
        targets, queries, p, OverhangStrategy.SOFTCLIP)
    for t, q, g in zip(targets, queries, got):
        assert (g.cigar, g.offset) == sw_scalar.align(
            t, q, p, OverhangStrategy.SOFTCLIP)


def test_pairhmm_entry_point_cpu(pairhmm_kat):
    """compute_likelihoods on device='cpu': the full product layout, and
    the diagonal within 1e-5 log10 of the known answers."""
    cases = pairhmm_kat[:3]
    out = PairHmmEngine(device="cpu").compute_likelihoods(
        [kat_read(c) for c in cases], [as_u8(c["hap"]) for c in cases])
    assert out.shape == (3, 3) and np.isfinite(out).all()
    for k, c in enumerate(cases):
        assert abs(out[k, k] - c["expected_log10"]) < 1e-5


def test_duplicate_haps_are_copies_cpu(pairhmm_kat):
    cases = pairhmm_kat[:2]
    reads = [kat_read(c) for c in cases]
    h0, h1 = as_u8(cases[0]["hap"]), as_u8(cases[1]["hap"])
    eng = PairHmmEngine(device="cpu")
    out = eng.compute_likelihoods(reads, [h0, h1, h0])
    assert np.array_equal(out[:, 2], out[:, 0])
    assert np.array_equal(out[:, :2], eng.compute_likelihoods(reads, [h0, h1]))


def test_api_validation_and_unported_options():
    with pytest.raises(ValueError):
        SmithWatermanAligner(device="cpu").align(
            b"", b"ACGT", SWParameters(25, -50, 110, 6),
            OverhangStrategy.SOFTCLIP)
    with pytest.raises(ValueError):
        PairHmmEngine(device="cpu").compute_likelihoods(
            [dict(bases=b"ACGT", q=[30, 30], i=[30] * 4, d=[30] * 4,
                  c=[10] * 4)], [b"ACGT"])
    for kw in ({"use_double": True}, {"fast_path": True}):
        with pytest.raises(NotImplementedError):
            PairHmmEngine(device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        PairHmmEngine(device="cpu").compute_likelihoods_stream(iter(()))


@pytest.mark.parametrize("cls", [SmithWatermanAligner, PairHmmEngine])
def test_cuda_without_a_card_raises(cls, monkeypatch):
    """Asking for the card where there is none raises; nothing falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cls(device="cuda")
    with pytest.raises(RuntimeError):
        cls()                      # the default device is the card


def test_launch_counters_stay_zero_on_cpu(pairhmm_golden):
    """On CPU tensors the wrappers run their plain versions and count no
    kernel launch."""
    before = (sw_cuda.sw_banded.launches,
              pairhmm_cuda.pairhmm_banded_f32.launches,
              pairhmm_cuda.pairhmm_banded_f64.launches)
    SmithWatermanAligner(device="cpu").align(
        b"ACGTACGT", b"ACGAACGT", SWParameters(25, -50, 110, 6),
        OverhangStrategy.SOFTCLIP)
    # a golden row whose f32 score underflows: the f64 rescue runs too
    row = next(r for r in pairhmm_golden if float.fromhex(r["scalarf"]) < 1e-28)
    out = PairHmmEngine(device="cpu").compute_likelihoods(
        [golden_read(row)], [as_u8(row["hap"])])
    assert np.isfinite(out).all()
    after = (sw_cuda.sw_banded.launches,
             pairhmm_cuda.pairhmm_banded_f32.launches,
             pairhmm_cuda.pairhmm_banded_f64.launches)
    assert before == after


def test_slice_never_imports_jax(tmp_path):
    """Running both entry points of the port leaves jax out of
    sys.modules (a fresh interpreter, so no other test's import counts)."""
    code = (
        "import sys, numpy as np\n"
        "from mgl_tpu_torch.api import (SmithWatermanAligner, PairHmmEngine,"
        " SWParameters, OverhangStrategy)\n"
        "r = SmithWatermanAligner(device='cpu').align(b'ACGTACGT', b'ACGAACGT',"
        " SWParameters(25, -50, 110, 6), OverhangStrategy.SOFTCLIP)\n"
        "q = np.full(6, 30, np.uint8)\n"
        "o = PairHmmEngine(device='cpu').compute_likelihoods("
        "[dict(bases=b'ACGTAC', q=q, i=q, d=q, c=q)], [b'TTACGTACTT'])\n"
        "assert np.isfinite(o).all()\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules"
        " if m.startswith('jax'))\n"
        "print('ok', r.cigar)\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": str(root),
                               "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


# ---------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("with_traceback", [True, False])
@pytest.mark.parametrize("indel_init", [False, True])
def test_sw_kernel_matches_plain(cuda, with_traceback, indel_init):
    """SW kernel vs its plain version on the card: ez exact, nibbles equal
    on every real cell."""
    targets, queries = sw_pairs(3, 96, (5, 140), (3, 140), err=0.08)
    args = sw_tensors(targets, queries, cuda)
    kw = dict(indel_init=indel_init, with_traceback=with_traceback)
    ez_k, w_k = sw_cuda.sw_banded(*args, 25, -50, 110, 6, **kw)
    ez_p, w_p = sw_cuda.sw_banded_plain(*args, 25, -50, 110, 6, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ez_k, ez_p)
    if with_traceback:
        wpb = banded_layout(args[0].shape[1], args[1].shape[1])[1]
        assert traceback_mismatches(w_k, w_p, args[2], args[3], wpb) == 0
    else:
        assert w_k is None and w_p is None


@pytest.mark.cuda
@pytest.mark.parametrize("rescue", [False, True])
def test_pairhmm_kernel_matches_plain(cuda, pairhmm_golden, rescue):
    """f32 and f64 PairHMM kernels vs the plain forward on the card, bit
    for bit, on the golden rows."""
    reads, haps = normalize([golden_read(r) for r in pairhmm_golden[:64]],
                            [as_u8(r["hap"]) for r in pairhmm_golden[:64]])
    ctx = CTX_F64 if rescue else CTX_F32
    args = pairhmm_cuda.stage_pairs(reads, haps,
                                    [(k, k) for k in range(len(reads))],
                                    ctx, cuda)
    kernel = (pairhmm_cuda.pairhmm_banded_f64 if rescue
              else pairhmm_cuda.pairhmm_banded_f32)
    got = kernel(*args)
    want = pairhmm_cuda.forward_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernels_reject_empty_inputs(cuda):
    """An empty query or hap raises before any launch, since the kernels
    read the first base of each."""
    before = (sw_cuda.sw_banded.launches,
              pairhmm_cuda.pairhmm_banded_f32.launches)
    i32 = dict(dtype=torch.int32, device=cuda)
    ones = torch.ones((2,), **i32)
    with pytest.raises(ValueError, match="5 x 0"):
        sw_cuda.sw_banded(torch.zeros((2, 5), dtype=torch.uint8, device=cuda),
                          torch.zeros((2, 0), dtype=torch.uint8, device=cuda),
                          ones, ones, 25, -50, 110, 6, indel_init=False)
    idx = torch.zeros((1,), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="0 hap columns"):
        pairhmm_cuda.pairhmm_banded_f32(
            torch.zeros((1, 7, 34), dtype=torch.float32, device=cuda),
            torch.zeros((1, 34), **i32), ones[:1],
            torch.zeros((1, 0), **i32), ones[:1],
            torch.ones((1,), dtype=torch.float32, device=cuda), idx, idx)
    assert (sw_cuda.sw_banded.launches,
            pairhmm_cuda.pairhmm_banded_f32.launches) == before


@pytest.mark.cuda
def test_entry_points_on_the_card(cuda, sw_golden, pairhmm_kat):
    _, groups = _sw_cases(sw_golden, 60)
    _check_sw_golden(SmithWatermanAligner(device=cuda), groups)
    reads = [kat_read(c) for c in pairhmm_kat]
    haps = [as_u8(c["hap"]) for c in pairhmm_kat]
    lik = pair_likelihoods(reads, haps, [(k, k) for k in range(len(reads))],
                           cuda)
    want = np.array([c["expected_log10"] for c in pairhmm_kat])
    assert np.abs(lik - want).max() < 1e-5
