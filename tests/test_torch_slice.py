"""The mgl_tpu_torch slice end to end: both GATK entry points and the
stream, the device rule, the import rule, the port's host CIGAR decoder,
and (on a card) each CUDA kernel against its plain torch version.

This file imports no jax, so its ``cuda`` tests also run on a GPU host
without jax: ``python -m pytest tests/test_torch_slice.py -m cuda``.
Small shapes throughout: the CPU tests take a few seconds on one thread.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import as_u8, kat_read
from mgl_tpu.ref_impl import sw_scalar
from mgl_tpu_torch.api import (OverhangStrategy, PairHmmEngine,
                               SmithWatermanAligner, SWParameters)
from mgl_tpu_torch.kernels import pairhmm_cuda, sw_cuda
from mgl_tpu_torch.ops.pairhmm import (normalize, pair_likelihoods,
                                       shared_forward_plain, use_shared_kernel)
from mgl_tpu_torch.ops.sw import EZ_KEYS, BAND, banded_layout
from mgl_tpu_torch.tables import CTX_F32, CTX_F64
from mgl_tpu_torch.testing import (engine_region, golden_groups, golden_read,
                                   sw_pairs, sw_tensors, traceback_mismatches)

ROOT = pathlib.Path(__file__).resolve().parents[1]

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
    counters = (sw_cuda.sw_banded, pairhmm_cuda.pairhmm_banded_f32,
                pairhmm_cuda.pairhmm_banded_f64,
                pairhmm_cuda.pairhmm_shared_f32)
    before = [k.launches for k in counters]
    SmithWatermanAligner(device="cpu").align(
        b"ACGTACGT", b"ACGAACGT", SWParameters(25, -50, 110, 6),
        OverhangStrategy.SOFTCLIP)
    # a golden row whose f32 score underflows: the f64 rescue runs too
    row = next(r for r in pairhmm_golden if float.fromhex(r["scalarf"]) < 1e-28)
    out = PairHmmEngine(device="cpu").compute_likelihoods(
        [golden_read(row)], [as_u8(row["hap"])])
    assert np.isfinite(out).all()
    # and a region in shared mode
    reads, haps = engine_region(2, 96, 3, 40, 60)
    assert use_shared_kernel([len(r["bases"]) for r in reads], haps)
    assert np.isfinite(PairHmmEngine(device="cpu").compute_likelihoods(
        reads, haps)).all()
    assert [k.launches for k in counters] == before


def test_host_decoder_equals_jax_package_decoder(sw_golden):
    """The port's CIGAR decoder (its own copy of the C++) gives what
    mgl_tpu.native.cigar_decode_bulk_banded gives on the same kernel
    words, for the golden pairs up to 40 bp, all four strategies."""
    from mgl_tpu.native import cigar_decode_bulk_banded as jax_decode
    from mgl_tpu_torch.native import cigar_decode_bulk_banded

    _, groups = _sw_cases(sw_golden, 40)
    n = 0
    for (m, x, o, e, s), rs in groups.items():
        p = SWParameters.normalized(m, x, o, e)
        targets = [r["target"].encode() for r in rs]
        queries = [r["query"].encode() for r in rs]
        tg, qr, tl, ql = sw_tensors(targets, queries, "cpu")
        ez, words = sw_cuda.sw_banded(
            tg, qr, tl, ql, p.match, p.mismatch, p.gap_open, p.gap_extend,
            indel_init=bool(s & (OverhangStrategy.INDEL
                                 | OverhangStrategy.LEADING_INDEL)))
        args = (words.numpy().view(np.uint32),
                dict(zip(EZ_KEYS, ez.numpy().astype(np.int64))), tl.numpy(),
                ql.numpy(), s, BAND, banded_layout(tg.shape[1], qr.shape[1])[1])
        got = cigar_decode_bulk_banded(*args)
        assert got == jax_decode(*args)
        assert got == [(r["cigar_scalar"], r["offset_scalar"]) for r in rs]
        n += len(rs)
    assert n >= 40


def test_port_imports_nothing_of_the_jax_package():
    """No module of mgl_tpu_torch, and not chip_smoke.py, imports jax or
    mgl_tpu (the port keeps its own copies)."""
    pattern = re.compile(r"^\s*(from|import)\s+(mgl_tpu|jax)(\.|\s|$)",
                         re.MULTILINE)
    files = sorted((ROOT / "mgl_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}" for f in files
           for m in pattern.finditer(f.read_text())]
    assert not bad, bad


def test_slice_never_imports_jax(tmp_path):
    """Running both entry points of the port and the stream, in shared and
    product mode, and the engine's use_double and fast_path modes, and
    importing every module of the parallel layer and the checkpoint ledger
    and running the sharded step on a one-rank mesh, leaves jax and every
    mgl_tpu module out of sys.modules (a fresh interpreter, so no other
    test's import counts)."""
    code = (
        "import sys, numpy as np\n"
        "from mgl_tpu_torch.api import (SmithWatermanAligner, PairHmmEngine,"
        " SWParameters, OverhangStrategy)\n"
        "from mgl_tpu_torch.testing import engine_region\n"
        "r = SmithWatermanAligner(device='cpu').align(b'ACGTACGT', b'ACGAACGT',"
        " SWParameters(25, -50, 110, 6), OverhangStrategy.SOFTCLIP)\n"
        "q = np.full(6, 30, np.uint8)\n"
        "eng = PairHmmEngine(device='cpu')\n"
        "o = eng.compute_likelihoods("
        "[dict(bases=b'ACGTAC', q=q, i=q, d=q, c=q)], [b'TTACGTACTT'])\n"
        "assert np.isfinite(o).all()\n"
        "batches = [engine_region(2, 96, 3, 40, 60),"
        " engine_region(3, 4, 3, 40, 60)]\n"
        "for out in eng.compute_likelihoods_stream(iter(batches)):\n"
        "    assert np.isfinite(out).all()\n"
        "for kw in ({'use_double': True}, {'fast_path': True}):\n"
        "    assert np.isfinite(PairHmmEngine(device='cpu', **kw)"
        ".compute_likelihoods(*batches[1])).all()\n"
        "import mgl_tpu_torch.pipelines.checkpoint\n"
        "from mgl_tpu_torch.parallel import (dryrun, elastic, launcher, mesh,"
        " pipeline, sort, transport)\n"
        "m1 = mesh.make_mesh(1, 1, device='cpu')\n"
        "out = pipeline.pipeline_step(m1)("
        "*pipeline.make_example_inputs(m1, r_per_dev=2, h_per_dev=2)[1])\n"
        "assert out['likelihoods'].isfinite().all()\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'mgl_tpu')"
        " or m.startswith(('jax.', 'mgl_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok', r.cigar)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": str(ROOT),
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


@pytest.mark.cuda
def test_shared_kernel_matches_plain(cuda):
    """The shared-hap-set kernel vs its plain version on the card, bit for
    bit, with sharing on and off, on reads of 50-160 bp against haps with
    shared prefixes, a duplicate and a reset."""
    reads, haps = engine_region(9, 96, 8, 160, 240)
    reads = [{k: v[:50 + 3 * n % 111] for k, v in rd.items()}
             for n, rd in enumerate(reads)]
    haps = haps + [haps[2].copy()]
    reads, haps = normalize(reads, haps)
    args = pairhmm_cuda.stage_shared(reads, haps, cuda)
    hstream, segtab = pairhmm_cuda.segment_table(
        haps, np.zeros(len(haps), np.int64))
    noshare = (*args[:3], torch.from_numpy(hstream).to(cuda),
               torch.from_numpy(segtab).to(cuda), args[5])
    for a in (args, noshare):
        got = pairhmm_cuda.pairhmm_shared_f32(*a)
        want = shared_forward_plain(*a)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_stream_equals_sequential_on_the_card(cuda):
    """compute_likelihoods_stream on the card, shared and product batches
    mixed, equals sequential compute_likelihoods calls bit for bit."""
    batches = [engine_region(s, n, 12) for s, n in ((1, 512), (2, 32),
                                                     (3, 512))]
    eng = PairHmmEngine(device=cuda)
    want = [eng.compute_likelihoods(r, h) for r, h in batches]
    for depth in (1, 2):
        got = list(eng.compute_likelihoods_stream(iter(batches), depth=depth))
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
