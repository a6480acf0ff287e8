"""The port's read mapper in score mode, align + sort and the one-device
record sort, against the JAX package on the CPU at small sizes; on a card,
the window gather kernel against its plain version and the mapper against
``device="cpu"``.

What is held, each against ``mgl_tpu``:
- the index build (native and NumPy) and the seeding (native
  ``map_seed_vote`` and the NumPy pipeline), bit for bit;
- the word-packed window gather at every nibble shift and both reference
  edges, flat and blocked, and the scores it feeds;
- ``map_reads`` (JAX ``impl="xla"``), ``map_reads_stream`` (the JAX device
  path under the Pallas interpreter) and ``align_and_sort``, every output.

The JAX package pads every window-score launch to at least 1,024 lanes, so
that XLA compiles few shapes (``mapper.py:828``); under the interpreter on
the CPU that costs ~20 s a launch.  The tests that run it patch its
``bucket_dims`` to the identity, so a launch pads to one 128-lane tile: no
result changes, only the interpreter's time.

The JAX package's modules imported here import no jax at module level, so
``python -m pytest tests/test_torch_mapper.py -m cuda`` runs the card's
tests on a host without jax.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from mgl_tpu.pipelines import align_sort as J_align_sort
from mgl_tpu.pipelines import mapper as J
from mgl_tpu_torch.core.params import SWParameters
from mgl_tpu_torch.kernels.window_cuda import (window_gather,
                                               window_gather_plain)
from mgl_tpu_torch.parallel.sort import (join_u64, sort_records_single,
                                         split_u64)
from mgl_tpu_torch.pipelines import mapper as M
from mgl_tpu_torch.pipelines.align_sort import align_and_sort

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASES = np.frombuffer(b"ACGT", np.uint8)
PARAMS = SWParameters(25, -50, 110, 6)
OUT_KEYS = ("pos", "score", "votes", "votes2", "strand", "mapq", "offset")

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's device path on the CPU: Pallas under the
    interpreter, launches padded to one lane tile (module docstring)."""
    import mgl_tpu.batch.bucketing as bucketing

    monkeypatch.setenv("MGL_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(bucketing, "bucket_dims", lambda n, grid=None: n)


@pytest.fixture(scope="module")
def sim():
    """tests/test_pipelines.py's fixture: 300 reads of 100 bp at 1% error
    from a 60 kbp reference, half of them reverse-complemented: (the
    port's index, the JAX package's index (built at first use, so the
    card's tests never load that package's native library), reads, true
    starts)."""
    rng = np.random.default_rng(7)
    ref = rng.choice(BASES, size=60_000)
    N, L = 300, 100
    starts = rng.integers(0, len(ref) - L, size=N)
    reads = ref[starts[:, None] + np.arange(L)[None, :]].copy()
    mut = rng.random((N, L)) < 0.01
    reads[mut] = rng.choice(BASES, size=int(mut.sum()))
    reads[N // 2:] = M.revcomp(reads[N // 2:])
    jax_index = []

    def jidx():
        if not jax_index:
            jax_index.append(J.ReferenceIndex.build(ref, k=16))
        return jax_index[0]

    return M.ReferenceIndex.build(ref, k=16), jidx, reads, starts


def _equal_outputs(a: dict, b: dict, keys) -> None:
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------ host seeding

@pytest.mark.parametrize("k", [16, 15, 12])
def test_index_build_equals_jax(k):
    """The index (sorted_kmers, positions, canon_fwd, prefix_table) equals
    the JAX package's bit for bit, and the native rows equal the NumPy
    path's, on a 300 kbp reference with N runs."""
    rng = np.random.default_rng(7)
    ref = rng.choice(BASES, size=300_000)
    ref[rng.integers(0, len(ref), 200)] = ord("N")
    ref[5000:5040] = ord("N")
    got = M.ReferenceIndex.build(ref, k=k)
    want = J.ReferenceIndex.build(ref, k=k)
    for name in ("sorted_kmers", "positions", "canon_fwd"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.prefix_table is None and want.prefix_table is None
    code = M.encode(ref)
    native = M.kmer_index_rows(code, k)
    numpy_rows = M._index_rows_numpy(code, k)
    for a, b in zip(native, numpy_rows):
        assert np.array_equal(a, b.astype(a.dtype))


def test_prefix_table_native_equals_numpy():
    """The native jump table equals the NumPy one and the JAX package's
    count, over the sorted keys of a 300 kbp index at 4^8 buckets."""
    rng = np.random.default_rng(8)
    idx = M.ReferenceIndex.build(rng.choice(BASES, size=300_000), k=16)
    shift, buckets = 2 * (16 - 8), 4 ** 8
    native = M.kmer_prefix_table(idx.sorted_kmers, shift, buckets)
    numpy_table = M._prefix_table_numpy(idx.sorted_kmers, shift, buckets)
    from mgl_tpu.native import kmer_prefix_table as jax_pkg_table

    assert native.dtype == numpy_table.dtype == np.uint32
    assert np.array_equal(native, numpy_table)
    assert np.array_equal(native, jax_pkg_table(idx.sorted_kmers, shift,
                                                buckets))


@pytest.fixture(scope="module")
def seed_set():
    """1.1 Mbp with a duplicate locus, a partial repeat and an N run (over
    a million k-mers: the index has its jump table), and 2,048 reads of
    150 bp at 2% error, half reverse-complemented, 64 junk reads and 32
    with an N (test_mapper_scale.py:72)."""
    rng = np.random.default_rng(21)
    ref = rng.choice(BASES, size=1_100_000)
    ref[3000:3300] = ref[90_000:90_300]
    ref[70_000:70_050] = ref[90_000:90_050]
    ref[123_456:123_470] = ord("N")
    L, N = 150, 2048
    tp = rng.integers(0, len(ref) - L, N)
    reads = ref[tp[:, None] + np.arange(L)[None, :]].copy()
    mut = rng.random(reads.shape) < 0.02
    reads[mut] = rng.choice(BASES, size=int(mut.sum()))
    reads[N // 2:] = M.revcomp(reads[N // 2:])
    reads[:64] = rng.choice(BASES, size=(64, L))
    reads[64:96, 10] = ord("N")
    return ref, reads, tp


def test_seed_candidates_equal_jax(seed_set, monkeypatch):
    """seed_candidates(both_strands=True, full=True) equals the JAX
    package's on both paths (native map_seed_vote, and the NumPy pipeline
    under MGL_TPU_NATIVE_SEED=0), and the port's NumPy path equals its
    native one, with the jump table and without."""
    ref, reads, _ = seed_set
    L = reads.shape[1]
    for sub in (ref, ref[:200_000]):
        idx, jidx = M.ReferenceIndex.build(sub, k=16), J.ReferenceIndex.build(
            sub, k=16)
        assert (idx.prefix_table is not None) == (len(sub) > 1_000_000)
        if idx.prefix_table is not None:
            assert np.array_equal(idx.prefix_table, jidx.prefix_table)
        got = M.seed_candidates(idx, reads, L, both_strands=True, full=True)
        got_np = M._seed_candidates_numpy(idx, reads, L, both_strands=True,
                                          full=True)
        for env in ("1", "0"):
            monkeypatch.setenv("MGL_TPU_NATIVE_SEED", env)
            want = J.seed_candidates(jidx, reads, L, both_strands=True,
                                     full=True)
            for a, b, c in zip(got, got_np, want):
                assert np.array_equal(a, c) and np.array_equal(b, c)
    # one strand, and both strands without the runner-up
    for kw in ({}, {"both_strands": True}):
        for a, b in zip(M.seed_candidates(idx, reads, L, **kw),
                        J.seed_candidates(jidx, reads, L, **kw)):
            assert np.array_equal(a, b)


def test_nm_at_native_equals_numpy_and_jax(seed_set):
    """The exact tier's mismatch count: native, NumPy and the JAX
    package's agree, edge clamping included."""
    ref, reads, tp = seed_set
    rng = np.random.default_rng(4)
    pos = np.clip(tp + rng.integers(-3, 4, len(tp)), 0, len(ref) - 1)
    pos[:8] = len(ref) - reads.shape[1] + 100
    pos = pos.astype(np.int64)
    got = M._nm_at(ref, pos, reads)
    assert np.array_equal(got, M._nm_at_numpy(ref, pos, reads))
    assert np.array_equal(got, J._nm_at(ref, pos, reads))


def test_positions_past_int32_boundary():
    """Seeds placed past 2.6 Gbp (uint32 positions over 2^31) give the
    JAX package's candidates on both paths: every consumer widens to
    int64.  The reference is an untouched zero array, so nothing reads its
    2.6 GB."""
    rng = np.random.default_rng(11)
    seg = rng.choice(BASES, size=20_000)
    big_off = 2_600_000_123
    small = M.ReferenceIndex.build(seg, k=16)
    ref = np.zeros(big_off + len(seg) + 4096, np.uint8)
    shifted = (small.positions.astype(np.int64) + big_off).astype(np.uint32)
    idx = M.ReferenceIndex(k=16, ref=ref, sorted_kmers=small.sorted_kmers,
                           positions=shifted, canon_fwd=small.canon_fwd)
    jidx = J.ReferenceIndex(k=16, ref=ref, sorted_kmers=small.sorted_kmers,
                            positions=shifted, canon_fwd=small.canon_fwd)
    N, L = 48, 100
    starts = rng.integers(64, len(seg) - L - 64, size=N)
    reads = seg[starts[:, None] + np.arange(L)[None, :]].copy()
    reads[N // 2:] = M.revcomp(reads[N // 2:])
    got = M.seed_candidates(idx, reads, L, both_strands=True, full=True)
    got_np = M._seed_candidates_numpy(idx, reads, L, both_strands=True,
                                      full=True)
    want = J.seed_candidates(jidx, reads, L, both_strands=True, full=True)
    for a, b, c in zip(got, got_np, want):
        assert np.array_equal(a, c) and np.array_equal(b, c)
    assert (np.abs(got[0] - (big_off + starts)) <= 8).all()
    cid, local = idx.locate(got[0])
    assert (cid == 0).all() and (local == got[0]).all()


def test_mapq_equal_jax():
    """mapq_from_votes and mapq_rescore equal the JAX package's, on the
    formula's corners (test_mapper_scale.py:440) and random inputs."""
    from mgl_tpu.core.params import SWParameters as JaxParams

    s1 = np.array([3200, 3200, 3200, 3200])
    s2 = np.array([3200, 3125, 2450, -(2**30)])
    votes = np.array([8, 8, 8, 8])
    assert M.mapq_rescore(s1, s2, votes, PARAMS).tolist() == [0, 6, 60, 60]
    rng = np.random.default_rng(3)
    v1, v2 = rng.integers(0, 12, 500), rng.integers(0, 12, 500)
    a, b = rng.integers(0, 4000, 500), rng.integers(-4000, 4000, 500)
    assert np.array_equal(M.mapq_from_votes(v1, v2),
                          J.mapq_from_votes(v1, v2))
    assert np.array_equal(M.mapq_rescore(a, b, v1, PARAMS),
                          J.mapq_rescore(a, b, v1, JaxParams(25, -50, 110, 6)))


# ------------------------------------------------------ the window gather

def _gather_set(ref_len: int = 50_011, L: int = 100, pad: int = 24):
    """An odd-length reference (a ragged last word), windows at all eight
    shifts at the start, at the last valid start and past it (into the pad
    words), and in the middle; reads from the window centres with every
    17th base changed."""
    rng = np.random.default_rng(23)
    ref = rng.choice(BASES, size=ref_len)
    wlen = L + 2 * pad
    last = ref_len - wlen
    starts = np.array(list(range(8)) + list(range(last - 7, last + 1))
                      + [last + 3, last + wlen // 2]
                      + [4096 + s for s in range(8)], np.int64)
    reads = np.zeros((len(starts), L), np.uint8)
    for i, s in enumerate(starts):
        r = ref[min(s + pad, ref_len - L):][:L].copy()
        r[::17] = BASES[(np.searchsorted(BASES, r[::17]) + 1) % 4]
        reads[i] = r
    return ref, starts, reads, wlen


@pytest.mark.parametrize("L", [100, 101])
def test_window_gather_plain_equals_slice(L):
    """window_gather_plain gives each window's codes, encode(ref) sliced
    with code 5 past the end, at every shift and both edges, and each
    read's codes cut to L (odd L drops the pad nibble)."""
    ref, starts, _, _ = _gather_set(L=L)
    wlen = L + 48
    rng = np.random.default_rng(L)
    reads = rng.choice(np.frombuffer(b"ACGTNacgtn", np.uint8),
                       size=(len(starts), L))
    idx = M.ReferenceIndex.build(ref, k=16)
    words, blocked = M._ref_device(idx, torch.device("cpu"))
    assert not blocked and words.dtype == torch.int32
    st = tuple(torch.from_numpy(s) for s in M._split_starts(starts, False))
    tgt, qry = window_gather_plain(words, st, torch.from_numpy(
        M._pack_codes(reads)), wlen, L)
    code = np.concatenate([M.encode(ref), np.full(wlen, 5, np.uint8)])
    want = code[starts[:, None] + np.arange(wlen)[None, :]]
    assert np.array_equal(tgt.numpy(), want)
    assert (tgt.numpy()[starts > len(ref) - wlen] == 5).any()
    assert np.array_equal(qry.numpy(), M.encode(reads))
    got_k = window_gather(words, st, torch.from_numpy(M._pack_codes(reads)),
                          wlen, L)
    assert all(torch.equal(a, b) for a, b in zip(got_k, (tgt, qry)))


def test_window_gather_plain_words_with_top_bit():
    """Words whose top nibble is 8 or more (negative as int32) unpack
    without sign extension, in both layouts."""
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    raw[::3] |= np.uint32(0x80000000)
    words = torch.from_numpy(raw.view(np.int32))
    nib = (raw[:, None] >> (4 * np.arange(8, dtype=np.uint32))) & 0xF
    flat_codes = nib.reshape(-1).astype(np.uint8)
    starts = np.arange(0, 64 * 8 - 80, 13, dtype=np.int64)
    wlen, L = 72, 3
    packed = torch.zeros((len(starts), 2), dtype=torch.uint8)
    tgt, _ = window_gather_plain(words, tuple(
        torch.from_numpy(s) for s in M._split_starts(starts, False)),
        packed, wlen, L)
    assert np.array_equal(tgt.numpy(),
                          flat_codes[starts[:, None] + np.arange(wlen)])
    rows = torch.stack([words[:32], words[32:]])
    row = (starts // 256).astype(np.int32)
    keep = (starts % 256) + wlen <= 256
    st = (torch.from_numpy(row[keep]),
          torch.from_numpy(((starts[keep] % 256) >> 3).astype(np.int32)),
          torch.from_numpy((starts[keep] & 7).astype(np.int32)))
    tgt_b, _ = window_gather_plain(rows, st, packed[:int(keep.sum())], wlen,
                                   L)
    assert torch.equal(tgt_b, tgt[torch.from_numpy(keep)])


def test_window_gather_refuses_bad_inputs():
    words = torch.zeros(16, dtype=torch.int32)
    st = (torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    packed = torch.zeros((2, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="starts"):
        window_gather(words, st[:1], packed, 20, 10)
    with pytest.raises(ValueError, match="packed"):
        window_gather(words, st, packed, 20, 12)
    with pytest.raises(ValueError, match="ref_words"):
        window_gather(words.long(), st, packed, 20, 10)


def test_sw_score_windows_equal_jax(jax_interpret):
    """The port's sw_score_windows(device="cpu") equals the JAX package's
    (device gather + Pallas banded SW under the interpreter) and the SW of
    host-sliced windows, on the all-shift and edge set inside the
    reference (test_mapper_scale.py:291)."""
    from mgl_tpu.core.params import SWParameters as JaxParams

    ref, starts, reads, wlen = _gather_set()
    inside = starts <= len(ref) - wlen
    starts, reads = starts[inside], reads[inside]
    got = M.sw_score_windows(M.ReferenceIndex.build(ref, k=16), starts,
                             reads, wlen, PARAMS, device="cpu")
    want = J.sw_score_windows(J.ReferenceIndex.build(ref, k=16), starts,
                              reads, wlen, JaxParams(25, -50, 110, 6))
    assert got.dtype == np.int64 and np.array_equal(got, want)
    win = ref[starts[:, None] + np.arange(wlen)[None, :]]
    assert np.array_equal(got, M.sw_score_batch(win, reads, PARAMS,
                                                device="cpu"))


def test_blocked_layout_equals_flat(monkeypatch):
    """With _BLOCK_GATE and _BLOCK_BITS patched small (4,096-bp rows), the
    blocked reference gives the flat one's windows and map_reads_stream
    outputs (test_mapper_scale.py:321)."""
    rng = np.random.default_rng(12)
    ref = rng.choice(BASES, size=60_000)
    N, L = 64, 100
    starts = rng.integers(0, len(ref) - L, size=N)
    reads = ref[starts[:, None] + np.arange(L)[None, :]].copy()
    mut = rng.random((N, L)) < 0.02
    reads[mut] = rng.choice(BASES, size=int(mut.sum()))
    flat_idx = M.ReferenceIndex.build(ref, k=16)
    flat = M.map_reads_stream(flat_idx, reads, device="cpu")
    wstarts = np.array(list(range(8)) + [4096 - 150 + s for s in range(8)]
                       + [len(ref) - 148], np.int64)
    packed = torch.from_numpy(M._pack_codes(reads[:len(wstarts)]))
    w_flat, _ = M._ref_device(flat_idx, torch.device("cpu"))
    want = window_gather_plain(w_flat, tuple(
        torch.from_numpy(s) for s in M._split_starts(wstarts, False)),
        packed, 148, L)
    monkeypatch.setattr(M, "_BLOCK_GATE", 1)
    monkeypatch.setattr(M, "_BLOCK_BITS", 12)
    idx = M.ReferenceIndex.build(ref, k=16)
    blocked = M.map_reads_stream(idx, reads, device="cpu")
    assert idx._ref_blocked
    _equal_outputs(flat, blocked, OUT_KEYS + ("pos2", "score2"))
    w_rows, is_blocked = M._ref_device(idx, torch.device("cpu"))
    assert is_blocked and w_rows.dim() == 2
    got = window_gather_plain(w_rows, tuple(
        torch.from_numpy(s) for s in M._split_starts(wstarts, True)),
        packed, 148, L)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# --------------------------------------------------------- the pipelines

def test_map_reads_equals_jax(sim):
    """map_reads(device="cpu") equals the JAX package's map_reads
    (impl="xla") in every output, on tests/test_pipelines.py's fixture
    (half the reads reverse-complemented)."""
    idx, jidx, reads, starts = sim
    got = M.map_reads(idx, reads, device="cpu")
    want = J.map_reads(jidx(), reads, impl="xla")
    _equal_outputs(got, want, OUT_KEYS)
    mapped = got["pos"] >= 0
    assert mapped.mean() > 0.98 and (got["offset"] >= 0).any()
    d = starts[mapped] - got["pos"][mapped]
    assert ((d >= 0) & (d <= 48)).mean() > 0.98


def _near_duplicate():
    """test_mapper_scale.py:360's locus A and its near-duplicate B (A less
    one base), with 63 more reads of 128 bp at 2% error, 8 of them copies
    of A and 16 reverse-complemented."""
    rng = np.random.default_rng(13)
    L = 128
    seg_a = rng.choice(BASES, size=L)
    seg_b = np.delete(seg_a, 60)
    pos_a, pos_b = 3_000, 16_000
    ref = rng.choice(BASES, size=40_000)
    ref[pos_a: pos_a + L] = seg_a
    ref[pos_b: pos_b + len(seg_b)] = seg_b
    r2 = np.random.default_rng(3)
    st = r2.integers(0, len(ref) - L, 64)
    reads = ref[st[:, None] + np.arange(L)].copy()
    reads[:8] = seg_a
    mut = r2.random(reads.shape) < 0.02
    mut[0] = False
    reads[mut] = r2.choice(BASES, int(mut.sum()))
    reads[32:48] = M.revcomp(reads[32:48])
    return ref, reads, pos_a


def test_map_reads_stream_equals_jax(jax_interpret):
    """map_reads_stream(chunk=32) over 64 reads equals the JAX package's
    in every output, pos2, score2 and the rescored MAPQ included; on the
    near-duplicate read the rescored MAPQ stays low."""
    ref, reads, pos_a = _near_duplicate()
    got = M.map_reads_stream(M.ReferenceIndex.build(ref, k=16), reads,
                             chunk=32, device="cpu")
    want = J.map_reads_stream(J.ReferenceIndex.build(ref, k=16), reads,
                              chunk=32)
    _equal_outputs(got, want, OUT_KEYS + ("pos2", "score2"))
    assert got["window_pad"] == want["window_pad"]
    assert abs(got["pos"][0] + got["window_pad"] - pos_a) <= 8
    assert got["pos2"][0] >= 0 and got["score2"][0] > -(2**29)
    vote_q = M.mapq_from_votes(got["votes"][:1], got["votes2"][:1])[0]
    assert vote_q >= 25 and got["mapq"][0] <= 15
    assert (got["score2"] > -(2**29)).sum() >= 8


def test_lowercase_reads_score_as_the_tpu_route(jax_interpret):
    """Reads with lowercase bases score as on the JAX package's TPU route:
    map_reads_stream(device="cpu") equals map_reads(impl="pallas") under
    the interpreter in every output, where a lowercase base matches its
    uppercase one; the XLA route (ASCII compare) scores the forward-strand
    ones lower."""
    rng = np.random.default_rng(17)
    ref = rng.choice(BASES, size=20_000)
    N, L = 32, 100
    st = rng.integers(0, len(ref) - L, N)
    reads = ref[st[:, None] + np.arange(L)].copy()
    mut = rng.random(reads.shape) < 0.01
    reads[mut] = rng.choice(BASES, int(mut.sum()))
    reads[N // 4: N // 2] = M.revcomp(reads[N // 4: N // 2])
    low = rng.random(reads.shape) < 0.03
    low[N // 2:] = False
    reads[low] |= 0x20
    got = M.map_reads_stream(M.ReferenceIndex.build(ref, k=16), reads,
                             device="cpu")
    jidx = J.ReferenceIndex.build(ref, k=16)
    want = J.map_reads(jidx, reads, impl="pallas")
    _equal_outputs(got, want, OUT_KEYS)
    assert (got["pos"] >= 0).all()
    xla = J.map_reads(jidx, reads, impl="xla")
    # a reverse-strand read is verified as its reverse complement, which
    # is upper case in both packages
    fwd_low = low.any(axis=1) & (got["strand"] == 0)
    assert fwd_low.sum() >= N // 8
    assert (xla["score"][fwd_low] < got["score"][fwd_low]).all()
    assert np.array_equal(xla["score"][~fwd_low], got["score"][~fwd_low])


def test_stream_equals_map_reads_and_chunks(sim):
    """map_reads_stream's outputs shared with map_reads are map_reads',
    whatever the chunk size; its METRICS timers are recorded."""
    from mgl_tpu_torch.utils.metrics import METRICS

    idx, _, reads, _ = sim
    one = M.map_reads(idx, reads, device="cpu")
    METRICS.reset()
    for chunk in (300, 77):
        got = M.map_reads_stream(idx, reads, chunk=chunk, device="cpu")
        amb = got["pos2"] >= 0
        keys = [k for k in OUT_KEYS if k != "mapq"]
        _equal_outputs({k: got[k] for k in keys}, one, keys)
        assert np.array_equal(got["mapq"][~amb], one["mapq"][~amb])
    assert {"map.seed", "map.host_tier", "map.dispatch",
            "map.sync"} <= set(METRICS.snapshot()["timers_s"])


def test_unported_options_raise(sim):
    """No option is left unported: CIGAR mode runs
    (tests/test_torch_mapper_cigar.py) and a mesh sorts
    (tests/test_torch_parallel.py).  What still raises is a mesh the
    process does not have: without a process group only 1 x 1 exists, and
    a larger shape raises the JAX package's ValueError; the one-rank mesh
    sorts as mesh=None does."""
    from mgl_tpu_torch.parallel.mesh import make_mesh

    idx, _, reads, _ = sim
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        align_and_sort(idx, reads[:4], mesh=make_mesh(2, 1, device="cpu"),
                       device="cpu")
    got = align_and_sort(idx, reads[:4], mesh=make_mesh(1, 1, device="cpu"),
                         device="cpu")
    want = align_and_sort(idx, reads[:4], device="cpu")
    for k in ("keys", "order"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_align_and_sort_equals_jax(sim):
    """align_and_sort gives the JAX package's keys, order, contig and
    local_pos on one contig, and the keys ascend."""
    idx, jidx, reads, _ = sim
    got = align_and_sort(idx, reads, device="cpu")
    want = J_align_sort.align_and_sort(jidx(), reads, impl="xla")
    for k in ("keys", "order", "contig", "local_pos", "pos", "score"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["keys"].dtype == np.uint64
    assert (np.diff(got["keys"].astype(np.float64)) >= 0).all()


def test_align_and_sort_multi_contig_equals_jax():
    """On a two-contig index (build_multi), reads at each contig's start
    (clipped windows) included: keys, order, contig and local_pos equal
    the JAX package's."""
    rng = np.random.default_rng(5)
    contigs = [("chr1", rng.choice(BASES, 30_000)),
               ("chr2", rng.choice(BASES, 30_000))]
    L = 100
    reads = np.stack([seq[st: st + L] for _, seq in contigs
                      for st in [0, 1, 5] + list(rng.integers(
                          0, len(seq) - L, 20))])
    reads[::7, 50] = BASES[(np.searchsorted(BASES, reads[::7, 50]) + 1) % 4]
    idx = M.ReferenceIndex.build_multi(contigs, k=16)
    jidx = J.ReferenceIndex.build_multi(contigs, k=16)
    assert idx.contig_names == jidx.contig_names
    assert np.array_equal(idx.contig_offsets, jidx.contig_offsets)
    got = align_and_sort(idx, reads, device="cpu")
    want = J_align_sort.align_and_sort(jidx, reads, impl="xla")
    for k in ("keys", "order", "contig", "local_pos", "offset"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert set(got["contig"].tolist()) == {0, 1}


def test_sort_records_single_stable_and_equal_to_numpy():
    """The one-device sort orders uint64 keys as NumPy does, keeps ties in
    record order, and its split / join equal the JAX package's."""
    from mgl_tpu.parallel.sort import join_u64 as j_join
    from mgl_tpu.parallel.sort import split_u64 as j_split

    rng = np.random.default_rng(2)
    keys = rng.integers(0, 2**64 - 1, 2000, dtype=np.uint64)
    keys[::5] = keys[1]                          # ties
    keys[:4] = [0, 2**64 - 1, 2**63, 2**63 - 1]
    vals = np.arange(2000, dtype=np.int32)
    sk, sv = sort_records_single(keys, vals, device="cpu")
    order = np.argsort(keys, kind="stable")
    assert sk.dtype == np.uint64 and sv.dtype == np.int32
    assert np.array_equal(sk, keys[order]) and np.array_equal(sv, order)
    hi, lo = split_u64(keys)
    for a, b in zip((hi, lo), j_split(keys)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(join_u64(hi, lo), j_join(hi, lo))
    assert np.array_equal(join_u64(hi, lo), keys)


def test_mapper_never_imports_jax(tmp_path):
    """Building an index, map_reads, map_reads_stream, align_and_sort and
    the packed engine entry on device="cpu" leave jax and every mgl_tpu
    module out of sys.modules (a fresh interpreter)."""
    code = (
        "import sys, numpy as np\n"
        "from mgl_tpu_torch.pipelines.mapper import (ReferenceIndex,"
        " map_reads, map_reads_stream)\n"
        "from mgl_tpu_torch.pipelines.align_sort import align_and_sort\n"
        "from mgl_tpu_torch.batch.packed import (pack_request,"
        " compute_likelihoods_packed)\n"
        "rng = np.random.default_rng(1)\n"
        "ref = rng.choice(np.frombuffer(b'ACGT', np.uint8), 20000)\n"
        "idx = ReferenceIndex.build(ref, k=16)\n"
        "st = rng.integers(0, 19000, 40)\n"
        "reads = ref[st[:, None] + np.arange(80)].copy()\n"
        "reads[:, 40] = ord('A')\n"
        "a = map_reads(idx, reads, device='cpu')\n"
        "b = map_reads_stream(idx, reads, chunk=16, device='cpu')\n"
        "c = align_and_sort(idx, reads, device='cpu')\n"
        "assert (a['pos'] >= 0).all() and (b['score'] == a['score']).all()\n"
        "hap = np.frombuffer(b'ACGT', np.uint8)\n"
        "assert len(compute_likelihoods_packed(*pack_request([], [hap]),"
        " device='cpu')) == 0\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'mgl_tpu')"
        " or m.startswith(('jax.', 'mgl_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": str(ROOT),
                               "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("L", [150, 151])
def test_window_gather_kernel_matches_plain(cuda, L, monkeypatch):
    """The gather kernel equals its plain version on the card bit for bit:
    every shift, both edges, flat and blocked (gate patched small), odd
    and even L, reads with N and lowercase bases; the launch counter
    moves once a call."""
    ref, starts, _, wlen = _gather_set(ref_len=200_003, L=L)
    rng = np.random.default_rng(L)
    reads = rng.choice(np.frombuffer(b"ACGTNacgtn", np.uint8),
                       size=(len(starts), L))
    packed = torch.from_numpy(M._pack_codes(reads)).to(cuda)
    for gate in (M._BLOCK_GATE, 1):
        monkeypatch.setattr(M, "_BLOCK_GATE", gate)
        monkeypatch.setattr(M, "_BLOCK_BITS", 27 if gate > 1 else 14)
        idx = M.ReferenceIndex.build(ref, k=16)
        words, blocked = M._ref_device(idx, cuda)
        assert blocked == (gate == 1)
        st = tuple(torch.from_numpy(s).to(cuda)
                   for s in M._split_starts(starts, blocked))
        n0 = window_gather.launches
        got = window_gather(words, st, packed, wlen, L)
        torch.cuda.synchronize()
        assert window_gather.launches == n0 + 1
        want = window_gather_plain(words, st, packed, wlen, L)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_mapper_on_card_equals_cpu(cuda, sim):
    """map_reads_stream and align_and_sort on the card equal device="cpu"
    in every output, through the gather and SW kernels."""
    from mgl_tpu_torch.kernels.sw_cuda import sw_banded

    idx, _, reads, _ = sim
    n_gather, n_sw = window_gather.launches, sw_banded.launches
    got = M.map_reads_stream(idx, reads, chunk=128, device=cuda)
    assert window_gather.launches == n_gather + 3
    assert sw_banded.launches == n_sw + 3
    want = M.map_reads_stream(idx, reads, chunk=128, device="cpu")
    _equal_outputs(got, want, OUT_KEYS + ("pos2", "score2"))
    a = align_and_sort(idx, reads, device=cuda)
    b = align_and_sort(idx, reads, device="cpu")
    for k in ("keys", "order", "contig", "local_pos"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
