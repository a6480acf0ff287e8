"""Coordinates past 2^31 in the port's mapper, sort and SAM output, against
the JAX package on the CPU, without building a genome.

GRCh38's 24 primary contigs (``testing.GRCH38_CONTIGS``), joined as
``ReferenceIndex.build_multi`` joins them (48 'N' between contigs), span
3,088,271,000 positions: chr13 starts at 2,077,043,558 and crosses 2^31,
chr14-chrY lie wholly past it.  uint32 reference offsets reach 2^32
(``docs/LIMITS.md:75-80``), and the word-packed reference goes blocked past
2^33 bases.  Held here, each equal to ``mgl_tpu``'s on int64 positions at
2^31 - 1, 2^31, 2^32 - 1 and over GRCh38's contig offsets:
- ``_split_starts`` in the flat and the blocked layout (and each index
  triple names its start);
- ``ReferenceIndex.locate`` on an index whose contigs are GRCh38's;
- ``coordinate_keys`` and ``sort_records_single``;
- ``io/sam.sam_record`` and ``write_sam``, whose POS is the contig-local
  start plus one.

On the card (``cuda``, ``slow``): the mapper on GRCh38's coordinate space
(one 4 Mbp segment of simulated sequence a contig, the rest 'N'), 4,096
reads, the port's records on the card against ``mgl_tpu``'s mapper on the
CPU (``impl="xla"``), and the SAM's RNAME and POS against the truth.
"""

import numpy as np
import pytest
import torch

from mgl_tpu_torch.io import sam as S
from mgl_tpu_torch.parallel.sort import sort_records_single
from mgl_tpu_torch.pipelines import mapper as M
from mgl_tpu_torch.pipelines.align_sort import coordinate_keys
from mgl_tpu_torch.testing import GRCH38_CONTIGS

SEP = 48                               # build_multi's separator at k = 16
NAMES = [n for n, _ in GRCH38_CONTIGS]
LENGTHS = np.array([n for _, n in GRCH38_CONTIGS], np.int64)
OFFSETS = np.concatenate([[0], np.cumsum(LENGTHS + SEP)[:-1]])
EDGES = np.array([2**31 - 1, 2**31, 2**31 + 1, 2**32 - 8, 2**32 - 1],
                 np.int64)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _grch38_index(module):
    """An index of ``module`` (the port's or the JAX package's mapper) with
    no k-mers and GRCh38's contigs as its coordinate space."""
    empty = np.zeros(0, np.uint32)
    idx = module.ReferenceIndex(k=16, ref=np.zeros(0, np.uint8),
                                sorted_kmers=empty, positions=empty)
    idx.contig_names = list(NAMES)
    idx.contig_offsets = OFFSETS.copy()
    idx.contig_lengths = LENGTHS.copy()
    return idx


def _positions(seed: int) -> np.ndarray:
    """Every contig's first and last base, a random base of each, and the
    2^31 and 2^32 edges."""
    rng = np.random.default_rng(seed)
    inner = OFFSETS + (rng.random(len(LENGTHS)) * LENGTHS).astype(np.int64)
    return np.concatenate([OFFSETS, OFFSETS + LENGTHS - 1, inner, EDGES])


def test_grch38_crosses_2_31():
    """The coordinate space the mapper's checks assume: 3,088,269,832
    bases, chr13 across 2^31, chr14-chrY past it, all under 2^32."""
    assert int(LENGTHS.sum()) == 3_088_269_832
    assert OFFSETS[12] == 2_077_043_558
    assert OFFSETS[12] < 2**31 < OFFSETS[12] + LENGTHS[12]
    assert (OFFSETS[13:] > 2**31).all() and OFFSETS[-1] + LENGTHS[-1] < 2**32


@pytest.mark.parametrize("blocked", [False, True])
def test_split_starts_equals_jax(blocked):
    """int64 window starts to the device's int32 index arrays, flat (word,
    nibble) and blocked (row, word, nibble), equal to the JAX package's;
    each names its start again, and no index is negative."""
    from mgl_tpu.pipelines import mapper as J

    starts = _positions(1)
    if blocked:
        starts = np.concatenate([starts, starts + 2**33,
                                 np.array([2**34 + 3, 2**35 - 1])])
    got = M._split_starts(starts, blocked)
    want = J._split_starts(starts, blocked)
    assert len(got) == len(want) == (3 if blocked else 2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
        assert (a >= 0).all()
    if blocked:
        row, word, nib = (x.astype(np.int64) for x in got)
        back = (row << M._BLOCK_BITS) + 8 * word + nib
    else:
        word, nib = (x.astype(np.int64) for x in got)
        back = 8 * word + nib
    assert np.array_equal(back, starts)


def test_locate_grch38_equals_jax():
    """Global positions to (contig, local) on GRCh38's contigs: equal to
    the JAX package's, and to the truth inside every contig; -1 stays
    unmapped."""
    from mgl_tpu.pipelines import mapper as J

    pos = np.concatenate([_positions(2), [-1]])
    cid, local = _grch38_index(M).locate(pos)
    j_cid, j_local = _grch38_index(J).locate(pos)
    assert np.array_equal(cid, j_cid) and np.array_equal(local, j_local)
    n = len(LENGTHS)
    truth = np.tile(np.arange(n), 3)
    assert np.array_equal(cid[:3 * n], truth)
    assert np.array_equal(local[:3 * n], pos[:3 * n] - OFFSETS[truth])
    assert (local[:3 * n] < LENGTHS[truth]).all()
    assert cid[-1] == -1 and local[-1] == -1
    # 2^31 - 1 to 2^31 + 1 in chr13; 2^32 - 8 and up past chrY's end
    assert (cid[3 * n: 3 * n + 3] == 12).all()
    assert (cid[3 * n + 3: -1] == 23).all()


def test_coordinate_keys_and_sort_equal_jax():
    """(contig, local) keys of GRCh38 positions and single-contig keys of
    positions up to 2^32 - 1: equal to the JAX package's, and the
    one-device sort equal to its sort and to a stable NumPy argsort."""
    from mgl_tpu.parallel import sort as JS
    from mgl_tpu.pipelines import align_sort as JA

    pos = _positions(3)
    cid, local = _grch38_index(M).locate(pos)
    rng = np.random.default_rng(3)
    contig = np.concatenate([cid, np.zeros(len(pos), np.int64), [5, 0]])
    where = np.concatenate([local, pos, [-1, -1]])
    tie = rng.permutation(len(where))
    keys = coordinate_keys(contig, where, tie)
    assert np.array_equal(keys, JA.coordinate_keys(contig, where, tie))
    assert np.array_equal(keys[:len(pos)] >> np.uint64(48),
                          cid.astype(np.uint64))
    assert np.array_equal((keys[len(pos):2 * len(pos)] >> np.uint64(16))
                          & np.uint64(2**32 - 1), pos.astype(np.uint64))
    vals = np.arange(len(keys), dtype=np.int32)
    sk, sv = sort_records_single(keys, vals, device="cpu")
    jk, jv = JS.sort_records_single(keys, vals)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(sk, jk) and np.array_equal(sv, jv)
    assert np.array_equal(sk, keys[order]) and np.array_equal(sv, order)


def test_sam_record_equals_jax():
    """SAM lines at 0-based positions up to 2^32 - 1, mapped, reverse and
    unmapped: the JAX package's bytes, POS the position plus one."""
    from mgl_tpu.io import sam as JS

    seq = b"ACGTN" * 3
    qual = np.arange(15, dtype=np.uint8)
    for p in [0, *EDGES.tolist(), int(LENGTHS[0]) - 1, -1]:
        for flag in (0, S.FLAG_REVERSE, S.FLAG_UNMAPPED):
            got = S.sam_record("r", flag, "chr14", p, 60, "15M", seq, qual)
            assert got == JS.sam_record("r", flag, "chr14", p, 60, "15M",
                                        seq, qual)
            f = got.split("\t")
            mapped = p >= 0 and not flag & S.FLAG_UNMAPPED
            assert f[3] == (str(p + 1) if mapped else "0")


def test_write_sam_grch38_equals_jax(tmp_path):
    """A mapped result whose windows lie over GRCh38's whole coordinate
    space, chr13 to chrY among them: ``write_sam`` writes the JAX
    package's bytes, each record's RNAME its contig and POS its contig-local
    start plus one, in coordinate order."""
    from mgl_tpu.io import sam as JS
    from mgl_tpu.pipelines import mapper as J

    rng = np.random.default_rng(4)
    n, L, pad = 96, 20, 24
    contig = np.arange(n) % len(LENGTHS)
    local = (rng.random(n) * (LENGTHS[contig] - 200)).astype(np.int64) + pad
    offset = rng.integers(0, 2 * pad, n)
    offset[::7] = -1                           # no pinned offset
    pos = OFFSETS[contig] + local - offset.clip(0)
    pos[5] = -1                                # unmapped
    result = {"pos": pos, "offset": offset, "window_pad": pad,
              "strand": (np.arange(n) % 3 == 0).astype(np.int8),
              "mapq": rng.integers(0, 61, n).astype(np.int32),
              "cigar": np.array([f"{L}M"] * n, dtype=object)}
    result["cigar"][::7] = ""
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), (n, L))
    got, want = tmp_path / "port.sam", tmp_path / "jax.sam"
    assert S.write_sam(got, _grch38_index(M), reads, result) == n
    assert JS.write_sam(want, _grch38_index(J), reads, result) == n
    assert got.read_bytes() == want.read_bytes()
    records = [line.split("\t") for line in got.read_text().splitlines()
               if not line.startswith("@")]
    by_name = {int(f[0][4:]): f for f in records}
    eff = np.where(offset >= 0, local, local - offset.clip(0) + pad)
    for i in range(n):
        f = by_name[i]
        if i == 5:
            assert f[2] == "*" and f[3] == "0"
        else:
            assert f[2] == NAMES[contig[i]] and int(f[3]) == eff[i] + 1
    placed = [(NAMES.index(f[2]), int(f[3])) for f in records if f[2] != "*"]
    assert placed == sorted(placed)


@pytest.mark.cuda
@pytest.mark.slow
def test_grch38_mapper_equals_jax_cuda(cuda, tmp_path):
    """The mapper on GRCh38's coordinate space (3.09 Gbp, one 4 Mbp segment
    a contig), 4,096 reads half past 2^31: the port's ``map_reads`` on the
    card equal in every output to ``mgl_tpu``'s on the CPU (``impl="xla"``,
    JAX on the CPU), both indexes built by ``build_multi`` from the same
    contigs; ``write_sam``'s bytes equal to the JAX package's, and RNAME
    and POS equal to the truth for reads with no deletion whose window
    holds it and whose first 12 bases match it."""
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from mgl_tpu.io import sam as JS
    from mgl_tpu.pipelines import mapper as J

    from mgl_tpu_torch.testing import genome_coords_reference, genome_reads

    contigs, seg = genome_coords_reference(0)
    g = genome_reads(1, contigs, seg, 4096)
    index = M.ReferenceIndex.build_multi(contigs, k=16)
    j_index = J.ReferenceIndex.build_multi(contigs, k=16)
    del contigs
    reads = g["reads"]
    got = M.map_reads(index, reads, device=cuda)
    want = J.map_reads(j_index, reads, impl="xla")
    for k in ("pos", "score", "votes", "votes2", "strand", "mapq", "offset"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    past = g["start"] >= 2**31
    inside = ((got["pos"] >= 0) & (g["start"] >= got["pos"])
              & (g["start"] <= got["pos"] + 2 * got["window_pad"]))
    assert inside.mean() >= 0.99 and inside[past].mean() >= 0.99
    a, b = tmp_path / "port.sam", tmp_path / "jax.sam"
    S.write_sam(a, index, reads, got)
    JS.write_sam(b, j_index, reads, want)
    assert a.read_bytes() == b.read_bytes()
    names = [n for n, _ in GRCH38_CONTIGS]
    # POS is the seeded diagonal unless the exact tier pinned it: the true
    # start where no deletion moved the vote
    plain = np.ones(len(reads), bool)
    plain[g["del_idx"]] = False
    n_checked = 0
    for line in a.read_text().splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t", 4)
        i = int(f[0][4:])
        if inside[i] and plain[i] and g["clean_head"][i]:
            assert (f[2], int(f[3])) == (names[g["contig"][i]],
                                         int(g["local"][i]) + 1)
            n_checked += 1
    assert n_checked >= 1024
