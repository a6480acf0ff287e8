"""The port's packed GATK wire format (``mgl_tpu_torch.batch.packed``)
against the JAX package's (``mgl_tpu/batch/packed.py``): the same bytes on
the known-answer reads, the round trip, the flat likelihoods equal to the
port's engine in all three modes, and an empty request.  CPU only, small
shapes (a few seconds on one thread).
"""

import numpy as np
import pytest
import torch

from conftest import as_u8, kat_read
from mgl_tpu.batch import packed as jax_packed
from mgl_tpu_torch.api import PairHmmEngine
from mgl_tpu_torch.batch.packed import (compute_likelihoods_packed,
                                        pack_request, unpack_request)

torch.set_num_threads(1)

MODES = [{}, {"use_double": True}, {"fast_path": True}]


def test_pack_bytes_equal_jax_package(pairhmm_kat):
    """pack_request gives the JAX package's lengths and buffers, byte for
    byte, on all known-answer reads and haps, and on an empty request."""
    reads = [kat_read(c) for c in pairhmm_kat]
    haps = [as_u8(c["hap"]) for c in pairhmm_kat]
    for rs, hs in ((reads, haps), (reads[:3], []), ([], haps[:2]), ([], [])):
        got = pack_request(rs, hs)
        want = jax_packed.pack_request(rs, hs)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_pack_unpack_roundtrip(pairhmm_kat):
    """unpack_request inverts pack_request, track by track."""
    reads = [kat_read(c) for c in pairhmm_kat[:6]]
    haps = [as_u8(c["hap"]) for c in pairhmm_kat[:5]]
    lengths, rbuf, hbuf = pack_request(reads, haps)
    assert lengths[0] == 6 and lengths[7] == 5
    reads2, haps2 = unpack_request(lengths, rbuf, hbuf)
    assert len(reads2) == 6 and len(haps2) == 5
    for a, b in zip(reads, reads2):
        for k in ("bases", "q", "i", "d", "c"):
            assert np.array_equal(a[k], b[k])
    for a, b in zip(haps, haps2):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="length mismatch"):
        pack_request([{**reads[0], "q": reads[0]["q"][:-1]}], haps)


@pytest.mark.parametrize("mode", MODES, ids=["default", "use_double",
                                             "fast_path"])
def test_packed_likelihoods_equal_engine(pairhmm_kat, mode):
    """The flat (R*H,) output equals PairHmmEngine(device="cpu") in the
    same mode, row-major; the diagonal is within 1e-5 of the known answers
    except where fast_path takes its estimate."""
    cases = pairhmm_kat[:3]
    reads = [kat_read(c) for c in cases]
    haps = [as_u8(c["hap"]) for c in cases]
    flat = compute_likelihoods_packed(*pack_request(reads, haps),
                                      device="cpu", **mode)
    want = PairHmmEngine(device="cpu", **mode).compute_likelihoods(reads,
                                                                   haps)
    assert flat.shape == (9,) and flat.dtype == np.float64
    assert np.array_equal(flat, want.reshape(-1))
    if not mode:
        for k, c in enumerate(cases):
            assert abs(flat[k * 3 + k] - c["expected_log10"]) < 1e-5


@pytest.mark.parametrize("mode", MODES, ids=["default", "use_double",
                                             "fast_path"])
def test_packed_request_without_reads_is_empty(pairhmm_kat, mode):
    """numReads = 0 gives an empty float64 array in every mode (the input
    that hit the empty-product fault), as does numHaps = 0."""
    haps = [as_u8(c["hap"]) for c in pairhmm_kat[:3]]
    for rs, hs in (([], haps), ([kat_read(pairhmm_kat[0])], [])):
        flat = compute_likelihoods_packed(*pack_request(rs, hs),
                                          device="cpu", **mode)
        assert flat.shape == (0,) and flat.dtype == np.float64


@pytest.mark.parametrize("mode", MODES, ids=["default", "use_double",
                                             "fast_path"])
def test_packed_request_with_empty_sequence_raises(pairhmm_kat, mode):
    """A 0-length read or a 0-length hap inside a request raises
    ValueError("empty sequence") in every mode, as PairHmmEngine does (the
    JAX package's packed entry skips that check: -inf, IndexError or
    ZeroDivisionError by mode)."""
    read = kat_read(pairhmm_kat[0])
    hap = as_u8(pairhmm_kat[0]["hap"])
    empty_read = {k: v[:0] for k, v in read.items()}
    for rs, hs in (([read, empty_read], [hap]), ([read], [hap, hap[:0]])):
        with pytest.raises(ValueError, match="empty sequence"):
            compute_likelihoods_packed(*pack_request(rs, hs), device="cpu",
                                       **mode)
