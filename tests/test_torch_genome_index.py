"""The k-mer index built on a device (``ReferenceIndex.build(...,
device=...)`` and ``build_multi``) against the host build, and the
seeding's hit counters.

On the CPU the device build runs its torch operations there: its
``sorted_kmers``, ``positions``, ``canon_fwd`` and ``prefix_table`` equal
the native ``kmer_index_rows`` / ``kmer_prefix_table`` build and
``_index_rows_numpy`` bit for bit, over several contigs with N runs, over
sort passes cut small enough that a run of equal keys outgrows one, and
with and without the prefix table; the word-packed reference it leaves on
the device equals ``_pack_ref_words``.  ``map.seed_hits`` and
``map.seeds_capped`` agree between the native and the NumPy seeding.
``python -m pytest tests/test_torch_genome_index.py -m cuda`` runs the
card's test: a ~100 Mbp reference built on the card against the host."""

import numpy as np
import pytest
import torch

from mgl_tpu_torch.pipelines import mapper as M
from mgl_tpu_torch.utils.metrics import METRICS

BASES = np.frombuffer(b"ACGT", np.uint8)
CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _contigs(seed: int, lengths, n_runs: int = 3, poly_a: int = 0):
    """[(name, ASCII bases)]: random ACGT with ``n_runs`` N runs of 1-40
    bases in each contig over 100 bases, lowercase here and there, and a run of
    ``poly_a`` A's in the first."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lengths):
        seq = BASES[rng.integers(0, 4, n)]
        for _ in range(n_runs if n > 100 else 0):
            at = int(rng.integers(0, n - 40))
            seq[at:at + int(rng.integers(1, 41))] = ord("N")
        low = rng.random(n) < 0.01
        seq[low] = seq[low] + 32
        if i == 0 and poly_a:
            seq[1000:1000 + poly_a] = ord("A")
        out.append((f"c{i}", seq))
    return out


def _equal(got: M.ReferenceIndex, want: M.ReferenceIndex) -> None:
    for name in ("sorted_kmers", "positions", "canon_fwd", "prefix_table"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(got.ref, want.ref)
    assert np.array_equal(got.contig_offsets, want.contig_offsets)


def _numpy_rows_equal(got: M.ReferenceIndex) -> None:
    vals, pos, fwd = M._index_rows_numpy(M.encode(got.ref), got.k)
    assert np.array_equal(got.sorted_kmers, vals)
    assert np.array_equal(got.positions, pos)
    assert np.array_equal(got.canon_fwd, fwd)


@pytest.mark.parametrize("k", [16, 12, 5])
def test_device_build_multi_equals_host(k):
    """Several contigs with internal N runs, over scan blocks and sort
    passes cut small: the torch build on the CPU gives the host build's
    arrays and _index_rows_numpy's rows."""
    contigs = _contigs(1, [70_000, 3_000, 45_000, 17])
    host = M.ReferenceIndex.build_multi(contigs, k=k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "_SCAN_BLOCK", 20_000)
        mp.setattr(M, "_SORT_PASS", 30_000)
        got = M.ReferenceIndex.build_multi(contigs, k=k, device="cpu")
    _equal(got, host)
    _numpy_rows_equal(got)
    assert got.prefix_table is None and len(got.sorted_kmers) > 0


def test_equal_keys_outgrow_a_sort_pass(monkeypatch):
    """A run of 30,000 A's gives one key more rows than a pass holds: the
    plan cuts its bucket down to that key, which takes a pass of its own
    in position order, and the arrays still equal the host build's."""
    contigs = _contigs(2, [60_000, 50_000], poly_a=30_000)
    monkeypatch.setattr(M, "_SCAN_BLOCK", 25_000)
    monkeypatch.setattr(M, "_SORT_PASS", 8_000)
    code = M.encode(np.concatenate([c for _, c in contigs]))
    blocks = [(lo, *M._canonical_block(
        torch.from_numpy(code[lo: min(lo + 25_000, len(code) - 15) + 15]),
        16)) for lo in range(0, len(code) - 15, 25_000)]
    passes = M._sort_passes(blocks, 16)
    whole = [p for p in passes if not p[3]]
    assert len(whole) == 1 and whole[0][:2] == (0, 1)
    assert whole[0][2] >= 30_000 - 15
    assert all(p[2] <= 8_000 for p in passes if p[3]) and len(passes) >= 10
    assert all(a[1] <= b[0] for a, b in zip(passes, passes[1:]))
    assert sum(p[2] for p in passes) == int(
        (M._kmers(code, 16)[1]).sum())
    host = M.ReferenceIndex.build_multi(contigs, k=16)
    got = M.ReferenceIndex.build_multi(contigs, k=16, device="cpu")
    _equal(got, host)
    assert np.count_nonzero(got.sorted_kmers == 0) >= 30_000 - 15


def test_device_build_makes_the_prefix_table():
    """Over a million k-mers at k = 16 the host build makes the 4^13 + 1
    jump table; the device build's is the same, uint32, bit for bit."""
    contigs = _contigs(3, [700_000, 450_000])
    host = M.ReferenceIndex.build_multi(contigs, k=16)
    got = M.ReferenceIndex.build_multi(contigs, k=16, device="cpu")
    assert host.prefix_table is not None
    assert len(got.prefix_table) == 4**13 + 1
    _equal(got, host)
    _numpy_rows_equal(got)
    assert np.array_equal(got.prefix_table, M._prefix_table_numpy(
        got.sorted_kmers, 6, 4**13))


def test_device_build_refuses_what_it_cannot_hold():
    ref = BASES[np.random.default_rng(4).integers(0, 4, 1000)]
    with pytest.raises(ValueError, match="k <= 16"):
        M.ReferenceIndex.build(ref, k=17, device="cpu")


@pytest.mark.parametrize("blocked", [False, True])
def test_device_packed_words_equal_host(blocked, monkeypatch):
    """The words the device build leaves on the index, and those
    _ref_device packs on the device for a host-built index, equal
    _pack_ref_words (and its blocked rows) bit for bit, odd tail
    included."""
    if blocked:
        monkeypatch.setattr(M, "_BLOCK_GATE", 1)
        monkeypatch.setattr(M, "_BLOCK_BITS", 12)
    contigs = _contigs(5, [30_001, 7_000])
    got = M.ReferenceIndex.build_multi(contigs, k=16, device="cpu")
    host = M.ReferenceIndex.build_multi(contigs, k=16)
    assert got._ref_dev is not None and CPU in got._ref_dev
    words = M._pack_ref_words(M.encode(host.ref))
    for idx in (got, host):
        w, is_blocked = M._ref_device(idx, CPU)
        assert is_blocked == blocked and w.dtype == torch.int32
        w = w.numpy().view(np.uint32)
        if not blocked:
            assert np.array_equal(w[:len(words)], words)
            assert (w[len(words):] == M._PAD_WORD).all()
            continue
        S_w = 1 << (M._BLOCK_BITS - 3)
        for r in range(len(w)):
            row = words[r * S_w: r * S_w + w.shape[1]]
            assert np.array_equal(w[r, :len(row)], row)
            assert (w[r, len(row):] == M._PAD_WORD).all()


def test_seed_counters_native_equal_numpy():
    """map.seed_hits and map.seeds_capped count alike on the native seeding
    and the NumPy path, where max_hits drops some seeds."""
    contigs = _contigs(6, [200_000])
    ref = contigs[0][1]
    ref[50_000:50_400] = np.tile(ref[10_000:10_016], 25)   # repeated seeds
    idx = M.ReferenceIndex.build_multi(contigs, k=16, max_hits=8,
                                       device="cpu")
    rng = np.random.default_rng(7)
    L, N = 150, 512
    tp = rng.integers(0, len(ref) - L, N)
    tp[:64] = rng.integers(49_900, 50_300, 64)
    reads = idx.ref[tp[:, None] + np.arange(L)[None, :]].copy()
    reads[N // 2:] = M.revcomp(reads[N // 2:])
    seen = []
    for fn in (M.seed_candidates, M._seed_candidates_numpy):
        METRICS.reset()
        out = fn(idx, reads, L, both_strands=True, full=True)
        seen.append((out, dict(METRICS.counters)))
    (a, ca), (b, cb) = seen
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert ca["map.seed_hits"] == cb["map.seed_hits"] > N * 6
    assert ca["map.seeds_capped"] == cb["map.seeds_capped"] > 0
    # the counts add up: every valid seed is capped, kept, or has no hit
    vals, valid, _ = M._seed_kmers(reads, 16, 16)
    lo, hi = idx.lookup(np.minimum(vals.astype(np.uint32),
                                   M._rc_kmers(vals, 16)).reshape(-1))
    cnt = (hi - lo)[valid.reshape(-1)]
    assert cb["map.seed_hits"] == cnt[cnt <= 8].sum()
    assert cb["map.seeds_capped"] == np.count_nonzero(cnt > 8)


@pytest.mark.parametrize("n", [1 << 10, (1 << 24) + 3])
def test_host_arrays_advised_into_huge_pages_keep_their_bytes(n):
    """``_host_empty`` gives an array of the size and type asked for, above
    and below ``_HUGE_MIN``, and ``_advise_huge`` on an array already
    written (its range not page aligned) changes no byte."""
    a = M._host_empty(n, np.uint32)
    assert a.shape == (n,) and a.dtype == np.uint32 and a.flags.writeable
    a[:] = np.arange(n, dtype=np.uint32)
    b = np.arange(n + 1, dtype=np.uint32)[1:]
    assert M._advise_huge(b) is b
    assert np.array_equal(b, np.arange(1, n + 1, dtype=np.uint32))
    assert np.array_equal(a, np.arange(n, dtype=np.uint32))


@pytest.mark.cuda
def test_card_build_equals_host_at_100_mbp(cuda):
    """A ~100 Mbp reference of five contigs built on the card: every array
    of the host build and the packed words, bit for bit, in at least two
    sort passes."""
    contigs = _contigs(8, [40_000_000, 25_000_000, 20_000_000, 10_000_000,
                           5_000_000], n_runs=20)
    host = M.ReferenceIndex.build_multi(contigs, k=16)
    METRICS.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "_SORT_PASS", 1 << 26)
        got = M.ReferenceIndex.build_multi(contigs, k=16, device=cuda)
    assert METRICS.calls["map.index_sort"] >= 2
    assert METRICS.counters["map.index_rows"] == len(host.sorted_kmers)
    _equal(got, host)
    words, blocked = M._ref_device(got, M.resolve_device(cuda))
    want = M._pack_ref_words(M.encode(host.ref))
    assert not blocked
    assert np.array_equal(words.cpu().numpy().view(np.uint32)[:len(want)],
                          want)
