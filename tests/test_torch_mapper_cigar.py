"""The port's mapper in CIGAR mode against the JAX package and the host
decoder on the CPU; on a card, against ``device="cpu"``.

What is held:
- ``sw_cigar_windows(device="cpu")`` (the gather, ``sw_banded_plain`` in
  traceback mode, the walk's plain version, the host decoder for
  overflowed walks) equals ``native.cigar_decode_bulk_banded`` called
  directly on the same words, on the two walk fixtures
  (``testing.indel_read_set``, ``deletion_sweep_set``) in all four
  strategies, and the JAX
  package's ``sw_cigar_windows`` under the Pallas interpreter;
- ``map_reads_stream(with_cigar=True)`` equals ``mgl_tpu``'s in every
  output key on the fixtures of ``tests/test_mapper_scale.py:394``
  (certified, SNP and deletion reads) and ``:461`` (reference-edge
  reads), and ``map_reads(with_cigar=True)`` on
  ``tests/test_pipelines.py``'s fixture, each under the interpreter
  (``test_torch_mapper.py``'s ``jax_interpret`` pattern: launches padded
  to one 128-lane tile).
"""

import numpy as np
import pytest
import torch

from mgl_tpu.pipelines import mapper as J
from mgl_tpu_torch.core.params import OverhangStrategy, SWParameters
from mgl_tpu_torch.kernels.cigar_walk_cuda import cigar_walk
from mgl_tpu_torch.native import cigar_decode_bulk_banded
from mgl_tpu_torch.ops.sw import BAND, EZ_KEYS
from mgl_tpu_torch.pipelines import mapper as M
from mgl_tpu_torch.testing import deletion_sweep_set, indel_read_set

BASES = np.frombuffer(b"ACGT", np.uint8)
PARAMS = SWParameters(25, -50, 110, 6)
OUT_KEYS = ("pos", "score", "votes", "votes2", "strand", "mapq", "offset",
            "pos2", "score2", "cigar")

SETS = {"indel": indel_read_set, "sweep": deletion_sweep_set}

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
    interpreter, launches padded to one lane tile."""
    import mgl_tpu.batch.bucketing as bucketing

    monkeypatch.setenv("MGL_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(bucketing, "bucket_dims", lambda n, grid=None: n)


def walk_set(name: str):
    """(the port's index, starts, reads, wlen) of a walk fixture."""
    ref, starts, reads, wlen = SETS[name]()
    return M.ReferenceIndex.build(ref, k=16), starts, reads, wlen


_words: dict = {}


def plain_traceback(name: str, strategy):
    """(ez, words, words a band) of the plain gather + sw_banded_plain over
    a walk fixture's windows, cached by the strategy's indel_init."""
    key = (name, bool(strategy & (OverhangStrategy.INDEL
                                  | OverhangStrategy.LEADING_INDEL)))
    if key not in _words:
        index, starts, reads, wlen = walk_set(name)
        _words[key] = M._sw_traceback_windows(index, starts, reads, wlen,
                                              PARAMS, strategy,
                                              torch.device("cpu"))
    return _words[key]


def _equal_outputs(a: dict, b: dict, keys) -> None:
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["window_pad"] == b["window_pad"]


def cigar_stream_set():
    """test_mapper_scale.py:394's reads: 48 of 100 bp against 50 kbp,
    16 exact, 16 with two interior SNPs, 16 with a 2 bp deletion at 50."""
    rng = np.random.default_rng(15)
    ref = rng.choice(BASES, size=50_000)
    N, L = 48, 100
    starts = rng.integers(100, len(ref) - L - 100, size=N)
    reads = ref[starts[:, None] + np.arange(L)[None, :]].copy()
    for i in range(16, 32):
        for p in (30, 61):
            reads[i, p] = BASES[(np.searchsorted(BASES, reads[i, p]) + 2) % 4]
    for i in range(32, 48):
        s = starts[i]
        reads[i] = np.concatenate([ref[s: s + 50],
                                   ref[s + 52: s + L + 2]])
    return ref, reads


def edge_set():
    """test_mapper_scale.py:461's reads: the first and last 100 bp of a
    30 kbp reference (edge-clipped windows) and one at offset 5."""
    rng = np.random.default_rng(16)
    ref = rng.choice(BASES, size=30_000)
    L = 100
    return ref, np.stack([ref[:L], ref[len(ref) - L:], ref[5: 5 + L]])


def pipelines_set():
    """tests/test_pipelines.py's fixture: 300 reads of 100 bp at 1% error
    from a 60 kbp reference."""
    rng = np.random.default_rng(7)
    ref = rng.choice(BASES, size=60_000)
    N, L = 300, 100
    starts = rng.integers(0, len(ref) - L, size=N)
    reads = ref[starts[:, None] + np.arange(L)[None, :]].copy()
    mut = rng.random((N, L)) < 0.01
    reads[mut] = rng.choice(BASES, size=int(mut.sum()))
    return ref, reads


@pytest.mark.parametrize("name", sorted(SETS))
@pytest.mark.parametrize("strategy", list(OverhangStrategy))
def test_sw_cigar_windows_equals_host_decoder(name, strategy):
    """sw_cigar_windows on the CPU gives the host decoder's (cigar, offset)
    on the same words for every pair, overflowed walks included (the
    deletion sweep overflows SEG_CAP on part of its pairs)."""
    index, starts, reads, wlen = walk_set(name)
    got = M.sw_cigar_windows(index, starts, reads, wlen, PARAMS, strategy,
                             device="cpu")
    ez, words, wpb = plain_traceback(name, strategy)
    B, L = reads.shape
    want = cigar_decode_bulk_banded(
        words.numpy().view(np.uint32),
        dict(zip(EZ_KEYS, ez.numpy().astype(np.int64))),
        np.full(B, wlen, np.int32), np.full(B, L, np.int32), int(strategy),
        BAND, wpb)
    assert got == want
    assert all(c for c, _ in got)


def test_sw_cigar_windows_chunks_and_overflow_counted():
    """Chunking does not change the result, and on the sweep the walk
    (kernel or plain) flags the pairs that the host decoder finishes."""
    index, starts, reads, wlen = walk_set("sweep")
    s = OverhangStrategy.SOFTCLIP
    one = M.sw_cigar_windows(index, starts, reads, wlen, PARAMS, s,
                             device="cpu")
    n0 = cigar_walk.launches
    assert M.sw_cigar_windows(index, starts, reads, wlen, PARAMS, s,
                              chunk=7, device="cpu") == one
    assert cigar_walk.launches == n0         # the plain version ran
    ez, words, wpb = plain_traceback("sweep", s)
    from mgl_tpu_torch.ops.cigar_device import decode_cigars_device

    res = decode_cigars_device(words, ez, wlen, reads.shape[1], s, wpb)
    need = [b for b, r in enumerate(res) if r is None]
    assert 0 < len(need) < len(res)
    assert all(res[b] == one[b] for b in range(len(res)) if b not in need)
    with pytest.raises(ValueError, match="bands of 32"):
        M.sw_cigar_windows(index, starts, reads, wlen, PARAMS, s, band=16,
                           device="cpu")


def test_sw_cigar_windows_equals_jax(jax_interpret):
    """On the deletion sweep (SOFTCLIP, overflow included) the port's
    sw_cigar_windows equals the JAX package's device path (its Pallas
    kernel under the interpreter, its device walk, its host fallback)."""
    index, starts, reads, wlen = walk_set("sweep")
    s = OverhangStrategy.SOFTCLIP
    got = M.sw_cigar_windows(index, starts, reads, wlen, PARAMS, s,
                             device="cpu")
    jidx = J.ReferenceIndex.build(index.ref, k=16)
    want = J.sw_cigar_windows(jidx, starts, reads, wlen, PARAMS, s)
    assert got == want


@pytest.mark.parametrize("make", [cigar_stream_set, edge_set],
                         ids=["tiers", "edges"])
def test_map_reads_stream_cigar_equals_jax(make, jax_interpret):
    """map_reads_stream(with_cigar=True) equals the JAX package's in every
    output key, cigar included: exact and SNP reads certified "<L>M",
    deletion reads and edge-clipped windows through the traceback tier."""
    ref, reads = make()
    got = M.map_reads_stream(M.ReferenceIndex.build(ref, k=16), reads,
                             with_cigar=True, device="cpu")
    want = J.map_reads_stream(J.ReferenceIndex.build(ref, k=16), reads,
                              with_cigar=True)
    _equal_outputs(got, want, OUT_KEYS)
    L = reads.shape[1]
    assert (got["pos"] >= 0).all() and all(got["cigar"])
    if make is cigar_stream_set:
        assert list(got["cigar"][:32]) == [f"{L}M"] * 32
        assert all("D" in c for c in got["cigar"][32:])


def test_map_reads_cigar_equals_jax(jax_interpret):
    """map_reads(with_cigar=True) equals the JAX package's device path
    (impl="pallas": every mapped read through sw_cigar_windows, score 0)
    in every output key, on the fixture's first 32 reads (as
    test_pipelines.py's CIGAR-mode test takes them: one lane tile)."""
    ref, reads = pipelines_set()
    reads = reads[:32]
    got = M.map_reads(M.ReferenceIndex.build(ref, k=16), reads,
                      with_cigar=True, device="cpu")
    want = J.map_reads(J.ReferenceIndex.build(ref, k=16), reads,
                       with_cigar=True, impl="pallas")
    _equal_outputs(got, want, [k for k in OUT_KEYS
                               if k not in ("pos2", "score2")])
    mapped = got["pos"] >= 0
    assert mapped.mean() > 0.9 and (got["score"][mapped] == 0).all()
    assert all(got["cigar"][mapped])


@pytest.mark.parametrize("strategy", [OverhangStrategy.SOFTCLIP,
                                      OverhangStrategy.INDEL])
def test_stream_cigar_tiers_and_metrics(strategy):
    """The stream in CIGAR mode keeps score mode's other outputs; under
    SOFTCLIP the certified tier takes the exact and SNP reads and only the
    deletion reads reach the traceback (METRICS map.tb_reads), under
    INDEL every non-exact read does; map.traceback is timed."""
    from mgl_tpu_torch.utils.metrics import METRICS

    ref, reads = cigar_stream_set()
    idx = M.ReferenceIndex.build(ref, k=16)
    score = M.map_reads_stream(idx, reads, chunk=20, device="cpu")
    METRICS.reset()
    got = M.map_reads_stream(idx, reads, chunk=20, with_cigar=True,
                             strategy=strategy, device="cpu")
    snap = METRICS.snapshot()
    for k in OUT_KEYS[:-1]:
        if k != "offset":
            np.testing.assert_array_equal(got[k], score[k], err_msg=k)
    non_exact = int(((score["offset"] < 0) & (score["pos"] >= 0)).sum())
    want_tb = 16 if strategy == OverhangStrategy.SOFTCLIP else non_exact
    assert snap["counters"]["map.tb_reads"] == want_tb
    assert "map.traceback" in snap["timers_s"]
    assert all(got["cigar"])


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_sw_cigar_windows_on_card_equals_cpu(cuda):
    """sw_cigar_windows on the card equals device="cpu" on both walk
    fixtures in every strategy, through the gather, SW and walk kernels
    (one launch each a chunk)."""
    from mgl_tpu_torch.kernels.sw_cuda import sw_banded
    from mgl_tpu_torch.kernels.window_cuda import window_gather

    for name in sorted(SETS):
        index, starts, reads, wlen = walk_set(name)
        for s in OverhangStrategy:
            n = (window_gather.launches, sw_banded.launches,
                 cigar_walk.launches)
            got = M.sw_cigar_windows(index, starts, reads, wlen, PARAMS, s,
                                     device=cuda)
            assert (window_gather.launches, sw_banded.launches,
                    cigar_walk.launches) == tuple(x + 1 for x in n)
            assert got == M.sw_cigar_windows(index, starts, reads, wlen,
                                             PARAMS, s, device="cpu"), (name,
                                                                        s)


@pytest.mark.cuda
def test_mapper_cigar_on_card_equals_cpu(cuda):
    """map_reads_stream and map_reads in CIGAR mode on the card equal
    device="cpu" in every output key."""
    for make in (cigar_stream_set, edge_set, pipelines_set):
        ref, reads = make()
        idx = M.ReferenceIndex.build(ref, k=16)
        n_walk = cigar_walk.launches
        got = M.map_reads_stream(idx, reads, chunk=32, with_cigar=True,
                                 device=cuda)
        if make is cigar_stream_set:          # 16 deletion reads: a chunk
            assert cigar_walk.launches == n_walk + 1
        want = M.map_reads_stream(idx, reads, chunk=32, with_cigar=True,
                                  device="cpu")
        _equal_outputs(got, want, OUT_KEYS)
        a = M.map_reads(idx, reads, with_cigar=True, device=cuda)
        b = M.map_reads(idx, reads, with_cigar=True, device="cpu")
        _equal_outputs(a, b, [k for k in OUT_KEYS
                              if k not in ("pos2", "score2")])
