"""mgl_tpu_torch's plane path on the CPU, held to the JAX package.

The plain versions of the plane kernels (``ops.sw.sw_plane_plain`` in its
traceback and samples modes, ``sw_plane_scores_plain``,
``ops.pairhmm.forward_plain`` through ``forward_scores_plane``) against
the TPU kernels they replace (``sw_pallas_forward``, ``sw_pallas_scores``,
``pairhmm_pallas_forward``) run under the Pallas interpreter, as the JAX
package's own tests run them on the CPU; the port's plane CIGAR decoder
and ScoreMax scan against ``mgl_tpu.native``'s; and the plane entry point
``sw_cuda.align_batch`` against the goldens and the banded aligner.  SW
exact; PairHMM within 2e-6 relative above the 1e-28 gate.  On a card,
each plane kernel against its plain version and against the banded
kernel, bit for bit.  Small shapes and one thread.

The plane SW kernel is the banded kernel's wavefront with another store
(``csrc/sw_wavefront.cuh``), so the CPU also holds the layout identity it
rests on (a plane word of row r is a banded word of lane (r-1) % 32 at
the same phase), the plain versions at edge shapes against the scalar
oracle ``mgl_tpu.ref_impl.sw_scalar.calculate_matrix``, and the warps-a-
pair rule and refusals of the plane wrappers; on the card, every W in
all three modes, with the carry row in shared and in global memory.

The JAX package is imported inside the tests that call it, so the ``cuda``
tests also run on a GPU host without jax:
``python -m pytest tests/test_torch_plane.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from conftest import as_u8, kat_read
from mgl_tpu.core.params import (NEW_SW_PARAMETERS, STANDARD_NGS,
                                 OverhangStrategy, SWParameters)
from mgl_tpu_torch.api import SmithWatermanAligner
from mgl_tpu_torch.kernels import pairhmm_cuda as ph
from mgl_tpu_torch.kernels import sw_cuda
from mgl_tpu_torch.native import cigar_decode_bulk
from mgl_tpu_torch.ops.pairhmm import forward_plain, normalize
from mgl_tpu_torch.ops.sw import (EZ_KEYS, banded_layout, compute_score_max,
                                  sw_banded_plain, sw_plane_plain,
                                  sw_plane_scores_plain)
from mgl_tpu_torch.tables import CTX_F32, MIN_ACCEPTED
from mgl_tpu_torch.testing import (ACGT, golden_groups,
                                   plane_traceback_mismatches, sw_edge_pairs,
                                   sw_pairs, sw_tensors)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _pairs(device="cpu"):
    """16 ragged pairs of up to 32 x 28 (queries mutated slices of their
    targets, 10% errors), as (tgt, qry, tlen, qlen) tensors."""
    return sw_tensors(*sw_pairs(31, 16, (4, 32), (3, 28), err=0.1), device)


def _jax_args(tg, qr, tl, ql, p):
    """The TPU kernels' lane-major inputs (sw_pallas.prepare_inputs) and
    scores."""
    import jax.numpy as jnp
    from mgl_tpu.kernels import sw_pallas

    ins = sw_pallas.prepare_inputs(tg.numpy().astype(np.int32), tl.numpy(),
                                   qr.numpy().astype(np.int32), ql.numpy())
    return (*(jnp.asarray(a) for a in ins), p.match, p.mismatch, p.gap_open,
            p.gap_extend)


def _sw(p):
    return (p.match, p.mismatch, p.gap_open, p.gap_extend)


@pytest.mark.parametrize("indel_init", [False, True])
def test_traceback_mode_equals_pallas_plane_kernel(indel_init):
    """sw_plane_plain's ez equal sw_pallas_forward's, and its nibbles equal
    the TPU kernel's on every real cell, in the same plane layout."""
    from mgl_tpu.kernels import sw_pallas

    tg, qr, tl, ql = _pairs()
    B, T = tg.shape
    p = STANDARD_NGS
    ez, words = sw_plane_plain(tg, qr, tl, ql, *_sw(p), indel_init=indel_init)
    ez_j, btr = sw_pallas.sw_pallas_forward(
        *_jax_args(tg, qr, tl, ql, p), indel_init=indel_init,
        with_traceback=True, interpret=True)
    assert np.array_equal(ez.numpy(), np.asarray(ez_j)[:, :B])
    n_words = words.shape[1]
    tpu = torch.from_numpy(np.asarray(btr)[:n_words, :T + 1, :B]
                           .transpose(2, 0, 1).astype(np.int64))
    assert plane_traceback_mismatches(words, tpu, tl, ql) == 0
    # the comparison sees a flipped bit on a real cell, and only there
    bad = words.clone()
    bad[0, 0, 1] ^= 4                           # cell (1, 1): E-extend
    bad[0, n_words - 1, 0] ^= 1                 # row 0: not a real cell
    assert plane_traceback_mismatches(bad, tpu, tl, ql) == 1


def test_samples_mode_and_score_max_equal_jax():
    """Samples mode: the last-column and last-row samples equal the TPU
    kernel's on every real cell, and the port's compute_score_max over
    them equals mgl_tpu.ops.sw.compute_score_max and the traceback mode's
    ez."""
    from mgl_tpu.kernels import sw_pallas
    from mgl_tpu.ops import sw as jax_sw

    tg, qr, tl, ql = _pairs()
    B = tg.shape[0]
    p = NEW_SW_PARAMETERS
    lc, lr = sw_plane_plain(tg, qr, tl, ql, *_sw(p), indel_init=True,
                            with_traceback=False)
    lc_j, lr_j, _ = sw_pallas.sw_pallas_forward(
        *_jax_args(tg, qr, tl, ql, p), indel_init=True, with_traceback=False,
        interpret=True)
    lc_j, lr_j = np.asarray(lc_j)[:, :B], np.asarray(lr_j)[:, :B]
    for b in range(B):
        t, q = int(tl[b]), int(ql[b])
        col = np.arange(1, t + 1) + q - 2            # cells (i, qlen)
        row = t + np.arange(1, q + 1) - 2            # cells (tlen, j)
        assert np.array_equal(lc[b, col].numpy(), lc_j[col, b]), b
        assert np.array_equal(lr[b, row].numpy(), lr_j[row, b]), b
    got = compute_score_max(lc.numpy(), lr.numpy(), tl.numpy(), ql.numpy())
    want = jax_sw.compute_score_max(lc_j, lr_j, tl.numpy(), ql.numpy())
    ez, _ = sw_plane_plain(tg, qr, tl, ql, *_sw(p), indel_init=True)
    for k, key in enumerate(EZ_KEYS):
        assert np.array_equal(got[key], np.asarray(want[key])), key
        assert np.array_equal(got[key], ez[k].numpy()), key


def test_best_score_mode_equals_pallas_score_kernel():
    """sw_plane_scores_plain equals sw_pallas_scores and the ez max."""
    from mgl_tpu.kernels import sw_pallas

    tg, qr, tl, ql = _pairs()
    p = STANDARD_NGS
    got = sw_plane_scores_plain(tg, qr, tl, ql, *_sw(p), indel_init=False)
    want = sw_pallas.sw_pallas_scores(*_jax_args(tg, qr, tl, ql, p),
                                      indel_init=False, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want)[0, :tg.shape[0]])
    ez, _ = sw_plane_plain(tg, qr, tl, ql, *_sw(p), indel_init=False,
                           with_traceback=True)
    assert torch.equal(got, ez[2])


def test_plane_decoder_equals_jax_package_decoder(sw_golden):
    """The port's plane CIGAR decoder (its own copy of the C++) gives what
    mgl_tpu.native.cigar_decode_bulk gives on the same words and ez, and
    the goldens, for the golden pairs up to 40 bp, all four strategies."""
    from mgl_tpu.native import cigar_decode_bulk as jax_decode

    rows = [r for r in sw_golden
            if len(r["target"]) <= 40 and len(r["query"]) <= 40]
    n = 0
    for (m, x, o, e, s), rs in golden_groups(rows).items():
        p = SWParameters.normalized(m, x, o, e)
        tg, qr, tl, ql = sw_tensors([r["target"].encode() for r in rs],
                                    [r["query"].encode() for r in rs], "cpu")
        ez, words = sw_plane_plain(
            tg, qr, tl, ql, *_sw(p),
            indel_init=bool(s & (OverhangStrategy.INDEL
                                 | OverhangStrategy.LEADING_INDEL)))
        args = (words.numpy().view(np.uint32),
                dict(zip(EZ_KEYS, ez.numpy().astype(np.int64))), tl.numpy(),
                ql.numpy(), s)
        got = cigar_decode_bulk(*args)
        assert got == jax_decode(*args)
        assert got == [(r["cigar_scalar"], r["offset_scalar"]) for r in rs]
        n += len(rs)
    assert n >= 40


def _check_golden(rows):
    for (m, x, o, e, s), rs in golden_groups(rows).items():
        got = sw_cuda.align_batch([r["target"].encode() for r in rs],
                                  [r["query"].encode() for r in rs],
                                  SWParameters.normalized(m, x, o, e),
                                  OverhangStrategy(s), "cpu")
        assert got == [(r["cigar_scalar"], r["offset_scalar"]) for r in rs]


@pytest.mark.parametrize("subset", ["small", "medium"])
def test_align_batch_golden(sw_golden, subset):
    """sw_cuda.align_batch on device='cpu' (the plane path's plain
    version) on the golden subsets tests/test_sw_jax.py uses: pairs up to
    60 bp in all four strategies, and the first 48 of 60-120 bp."""
    if subset == "small":
        rows = [r for r in sw_golden
                if len(r["target"]) <= 60 and len(r["query"]) <= 60]
        assert len(rows) >= 40
    else:
        rows = [r for r in sw_golden
                if 60 < max(len(r["target"]), len(r["query"])) <= 120][:48]
        assert rows
    _check_golden(rows)


def test_align_batch_equals_banded_aligner():
    """The plane path equals the banded aligner (device='cpu') on 200
    random pairs of 10-40 bp, all four strategies."""
    targets, queries = sw_pairs(37, 200, (10, 40), (5, 40), err=0.06)
    aligner = SmithWatermanAligner(device="cpu")
    for s in OverhangStrategy:
        got = sw_cuda.align_batch(targets, queries, STANDARD_NGS, s, "cpu")
        want = aligner.align_batch(targets, queries, STANDARD_NGS, s)
        assert got == [(w.cigar, w.offset) for w in want], s.name


def _plane_pairhmm_fixture():
    """4 reads of 18-40 bp x 3 haps of 48-60 bp: reads from the first hap
    with one error at Q15-45, and one random read at Q50 with dear gaps
    whose pairs fall under the rescue gate."""
    rng = np.random.default_rng(41)
    base = rng.choice(ACGT, 60)
    h1 = base[:48].copy()
    h1[20] = ACGT[(int(np.searchsorted(ACGT, h1[20])) + 1) % 4]
    haps = [base, h1, base[5:57].copy()]
    reads = []
    for k, n in enumerate((18, 27, 33, 40)):
        st = int(rng.integers(0, 60 - n))
        b = base[st:st + n].copy()
        b[rng.integers(0, n)] = ACGT[rng.integers(0, 4)]
        q = rng.integers(15, 45, n).astype(np.uint8)
        c = np.full(n, 10, np.uint8)
        if k == 1:
            b, q, c = rng.choice(ACGT, n), np.full(n, 50, np.uint8), q + 40
        reads.append(dict(bases=b, q=q, i=q, d=q, c=c))
    return normalize(reads, haps)


def test_pairhmm_plane_equals_pallas_plane_kernel(monkeypatch):
    """forward_scores_plane on device='cpu' against the JAX package's
    forward_scores_plane (pairhmm_pallas_forward under the interpreter) on
    12 ragged pairs: relative error <= 2e-6 on every pair above the 1e-28
    gate (XLA:CPU contracts a*b+c into FMA, torch does not), and the same
    rescue decisions (the interpreter flushes denormals under the gate)."""
    from mgl_tpu.kernels.pairhmm_pallas import forward_scores_plane
    from mgl_tpu.ops.pairhmm import pack_pairs

    reads, haps = _plane_pairhmm_fixture()
    pairs = [(r, h) for r in range(4) for h in range(3)]
    got = ph.forward_scores_plane(reads, haps, pairs, "cpu").numpy()
    monkeypatch.setenv("MGL_TPU_PALLAS_INTERPRET", "1")
    want = forward_scores_plane(pack_pairs(reads, haps, pairs))
    above = want >= MIN_ACCEPTED
    assert 6 <= above.sum() < len(pairs)
    rel = np.abs(got[above].astype(np.float64) - want[above]) / want[above]
    assert rel.max() <= 2e-6, rel.max()
    assert np.array_equal(got < MIN_ACCEPTED, want < MIN_ACCEPTED)
    # the plane entry point and the per-pair product path are one plain
    # forward on the CPU
    assert np.array_equal(got, ph.scores(reads, haps, pairs, CTX_F32,
                                         "cpu").numpy())


def test_plane_wrappers_count_no_launch_on_cpu():
    """On CPU tensors the plane wrappers run their plain versions, count no
    launch, and reject inputs of the wrong type."""
    tg, qr, tl, ql = _pairs()
    before = (sw_cuda.sw_plane.launches, sw_cuda.sw_plane_scores.launches,
              ph.pairhmm_plane_f32.launches)
    ez, _ = sw_cuda.sw_plane(tg, qr, tl, ql, *_sw(STANDARD_NGS),
                             indel_init=False)
    sc = sw_cuda.sw_plane_scores(tg, qr, tl, ql, *_sw(STANDARD_NGS),
                                 indel_init=False)
    assert torch.equal(sc, ez[2])
    reads, haps = _plane_pairhmm_fixture()
    args = ph.stage_pairs(reads, haps, [(0, 0), (3, 2)], CTX_F32, "cpu")
    assert torch.equal(ph.pairhmm_plane_f32(*args), forward_plain(*args))
    assert (sw_cuda.sw_plane.launches, sw_cuda.sw_plane_scores.launches,
            ph.pairhmm_plane_f32.launches) == before
    with pytest.raises(ValueError, match="tlen"):
        sw_cuda.sw_plane(tg, qr, tl.long(), ql, *_sw(STANDARD_NGS),
                         indel_init=False)
    with pytest.raises(ValueError, match="empty"):
        sw_cuda.align_batch([b"ACGT"], [b""], STANDARD_NGS,
                            OverhangStrategy.SOFTCLIP, "cpu")


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32).astype(np.uint64)


@pytest.mark.parametrize("seed, tlen, qlen", [
    (51, (1, 70), (1, 50)),            # tl < 32 and 1-3 bands, ragged
    (52, (33, 100), (20, 40)),         # tl past a band edge, tl >> ql
    (53, (5, 40), (60, 100)),          # ql >> tl
])
def test_plane_words_are_banded_words_by_row(seed, tlen, qlen):
    """The layout identity the plane kernel rests on, on the plain
    versions: plane word 4b + t//8 of row r = 32b + s + 1 holds, on every
    real cell, the nibbles of banded word b * WPB + t//8 at lane s (the
    same phase t % 8), and every other nibble of the plane words is 0."""
    tg, qr, tl, ql = sw_tensors(*sw_pairs(seed, 12, tlen, qlen, err=0.1),
                                "cpu")
    T, Q = tg.shape[1], qr.shape[1]
    kw = dict(indel_init=True)
    plane = _u32(sw_plane_plain(tg, qr, tl, ql, *_sw(STANDARD_NGS), **kw)[1])
    banded = _u32(sw_banded_plain(tg, qr, tl, ql, *_sw(STANDARD_NGS),
                                  **kw)[1])
    wpb = banded_layout(T, Q)[1]
    n_words = plane.shape[1]
    shift = 4 * np.arange(8, dtype=np.uint64)
    for i in range(tg.shape[0]):
        t_len, q_len = int(tl[i]), int(ql[i])
        # banded words of rows 1 .. tl: (rows, WPB), with their real nibbles
        r = np.arange(1, t_len + 1)[:, None, None]
        s, band = (r - 1) % 32, (r - 1) // 32
        k = np.arange(wpb)[None, :, None]
        c = 8 * k + np.arange(8)[None, None, :] - s + 1
        mask = (((c >= 1) & (c <= q_len)) * (np.uint64(15) << shift)).sum(
            -1, dtype=np.uint64)
        word = 4 * band[..., 0] + k[..., 0]
        assert (word[mask > 0] < n_words).all()
        got = plane[i, np.minimum(word, n_words - 1), r[..., 0]]
        want = banded[i, band[..., 0] * wpb + k[..., 0], s[..., 0]]
        assert mask.sum() and not ((got ^ want) & mask).any(), i
        # the plane words outside the pair's cells
        w = np.arange(n_words)[:, None, None]
        rr = np.arange(T + 1)[None, :, None]
        cc = 8 * w + np.arange(8)[None, None, :] + 2 - rr
        real = (rr >= 1) & (rr <= t_len) & (cc >= 1) & (cc <= q_len)
        real_mask = (real * (np.uint64(15) << shift)).sum(-1,
                                                           dtype=np.uint64)
        assert not (plane[i] & ~real_mask).any(), i


EDGE_SETS = {
    "one_base": ((1, 1), (1, 6), (6, 1), (40, 1), (1, 40)),
    "below_32": ((7, 20), (31, 31), (3, 9), (20, 5)),
    "tall": ((100, 3), (77, 9), (64, 1)),
    "wide": ((4, 90), (12, 100), (1, 64)),
    "padded": ((100, 100), (5, 7), (20, 3), (2, 2)),
}


@pytest.mark.parametrize("strategy", [OverhangStrategy.SOFTCLIP,
                                      OverhangStrategy.INDEL])
@pytest.mark.parametrize("name", EDGE_SETS)
def test_plane_plain_at_edge_shapes_equals_scalar(name, strategy):
    """sw_plane_plain and sw_plane_scores_plain at edge shapes (one-base
    queries and targets, tl < 32, tl >> ql, ql >> tl, lengths far below
    the batch's padded T and Q) against the scalar oracle
    calculate_matrix: ez exact, the move of every real cell's nibble the
    sign of its backtrack entry, the best score its max."""
    from mgl_tpu.ref_impl.sw_scalar import calculate_matrix

    targets, queries = [], []
    for k, (t, q) in enumerate(EDGE_SETS[name]):
        tt, qq = sw_pairs(60 + k, 1, (t, t), (q, q), err=0.1)
        targets += tt
        queries += qq
    tg, qr, tl, ql = sw_tensors(targets, queries, "cpu")
    p = STANDARD_NGS
    indel = strategy == OverhangStrategy.INDEL
    ez, words = sw_plane_plain(tg, qr, tl, ql, *_sw(p), indel_init=indel)
    best = sw_plane_scores_plain(tg, qr, tl, ql, *_sw(p), indel_init=indel)
    words = _u32(words)
    for i, (t, q) in enumerate(zip(targets, queries)):
        btrack, want = calculate_matrix(np.frombuffer(t, np.uint8),
                                        np.frombuffer(q, np.uint8), p,
                                        strategy)
        assert [int(ez[k, i]) for k in range(6)] == [want[k] for k in
                                                     EZ_KEYS], (name, i)
        assert int(best[i]) == want["max"], (name, i)
        r = np.arange(1, len(t) + 1)[:, None]
        c = np.arange(1, len(q) + 1)[None, :]
        d2 = r + c - 2
        move = (words[i, d2 // 8, r] >> (4 * (d2 % 8)).astype(np.uint64)) & 3
        sign = np.sign(btrack[1:, 1:])
        assert np.array_equal(move, np.where(sign < 0, 1, 2 * (sign > 0))), (
            name, i)


@pytest.mark.parametrize("fn, n_pairs, t, q, forced, want", [
    ("sw_plane", 2048, 150, 150, None, 1),        # an aligner bucket
    ("sw_plane_scores", 10_000, 150, 150, None, 1),
    ("sw_plane", 64, 8000, 2000, None, 16),        # few long pairs
    ("sw_plane", 164, 398, 414, None, 8),          # capped by 13 bands
    ("sw_plane_scores", 3, 40, 40, 4, 4),          # forced
])
def test_plane_warps_rule(fn, n_pairs, t, q, forced, want):
    """The plane wrappers take W as sw_banded does: the forced one, else
    banded_warps over the launch's pairs and bands."""
    w = sw_cuda.pipeline_warps(fn, n_pairs, t, q, forced, 132)
    assert w == want
    if forced is None:
        assert w == sw_cuda.banded_warps(n_pairs, -(-t // 32), 132)


@pytest.mark.parametrize("mode", sw_cuda.PLANE_MODES)
def test_plane_wrappers_refuse_a_bad_warps_per_pair(mode):
    """A forced W outside BANDED_WARPS is refused before anything runs,
    in every mode; a W inside gives the plain result on the CPU."""
    args = _pairs()
    if mode == "scores":
        call = lambda **kw: (sw_cuda.sw_plane_scores(
            *args, *_sw(STANDARD_NGS), indel_init=False, **kw),)
    else:
        call = lambda **kw: sw_cuda.sw_plane(
            *args, *_sw(STANDARD_NGS), indel_init=False,
            with_traceback=mode == "traceback", **kw)
    for w in (0, 3, 64):
        with pytest.raises(ValueError, match="warps_per_pair"):
            call(warps_per_pair=w)
    assert all(torch.equal(a, b) for a, b in zip(call(warps_per_pair=2),
                                                 call()))


def test_plane_refuses_only_int32_overflows():
    """The plane kernel's old min(T, Q) limit is gone: 9,000 x 9,000 takes
    W = 16, and only a shape whose progress counters or whose traceback
    offsets within a pair would overflow int32 is refused, before any
    launch."""
    assert sw_cuda.pipeline_warps("sw_plane", 4, 9000, 9000, None, 132) == 16
    with pytest.raises(ValueError, match="progress in int32"):
        sw_cuda.pipeline_warps("sw_plane", 1, 2 ** 20, 2 ** 16, None, 132)
    n = 92_683                         # 23,170 words x 92,684 rows a pair
    tg, qr = torch.zeros((1, n), dtype=torch.uint8), torch.zeros(
        (1, n), dtype=torch.uint8)
    tl = ql = torch.full((1,), n, dtype=torch.int32)
    with pytest.raises(ValueError, match="traceback words in int32"):
        sw_cuda._sw_plane(0, tg, qr, tl, ql, *_sw(STANDARD_NGS), False, ())


# ---------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["traceback", "samples", "scores"])
@pytest.mark.parametrize("indel_init", [False, True])
def test_sw_plane_kernel_matches_plain(cuda, mode, indel_init):
    """The plane SW kernel vs its plain version on the card, in each mode:
    every output tensor equal, bit for bit (words outside the real cells
    are zero in both)."""
    args = sw_tensors(*sw_pairs(43, 96, (5, 140), (3, 140), err=0.08), cuda)
    kw = dict(indel_init=indel_init)
    if mode == "scores":
        got = (sw_cuda.sw_plane_scores(*args, 25, -50, 110, 6, **kw),)
        want = (sw_plane_scores_plain(*args, 25, -50, 110, 6, **kw),)
    else:
        kw["with_traceback"] = mode == "traceback"
        got = sw_cuda.sw_plane(*args, 25, -50, 110, 6, **kw)
        want = sw_plane_plain(*args, 25, -50, 110, 6, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_plane_equals_banded_on_the_card(cuda, pairhmm_kat):
    """Two hand-written designs of each recurrence agree on the card: SW
    plane and banded ez and CIGARs, and PairHMM plane and banded f32
    scores on the known-answer pairs, bit for bit."""
    targets, queries = sw_pairs(47, 300, (20, 200), (10, 200), err=0.05)
    args = sw_tensors(targets, queries, cuda)
    ez_p, _ = sw_cuda.sw_plane(*args, 25, -50, 110, 6, indel_init=False)
    ez_b, _ = sw_cuda.sw_banded(*args, 25, -50, 110, 6, indel_init=False)
    torch.cuda.synchronize()
    assert torch.equal(ez_p, ez_b)
    for s in OverhangStrategy:
        got = sw_cuda.align_batch(targets, queries, STANDARD_NGS, s, cuda)
        want = sw_cuda.align_batch_banded(targets, queries, STANDARD_NGS, s,
                                          cuda)
        assert got == want, s.name
    reads, haps = normalize([kat_read(c) for c in pairhmm_kat],
                            [as_u8(c["hap"]) for c in pairhmm_kat])
    staged = ph.stage_pairs(reads, haps, [(k, k) for k in range(len(reads))],
                            CTX_F32, cuda)
    plane = ph.pairhmm_plane_f32(*staged)
    banded = ph.pairhmm_banded_f32(*staged)
    torch.cuda.synchronize()
    assert torch.equal(plane, banded)
    assert torch.equal(plane, forward_plain(*staged))


def _plane_call(args, mode, indel_init, warps=None):
    """(kernel outputs, plain outputs) of the plane SW in ``mode``."""
    kw = dict(indel_init=indel_init)
    if mode == "scores":
        return ((sw_cuda.sw_plane_scores(*args, 25, -50, 110, 6, **kw,
                                         warps_per_pair=warps),),
                (sw_plane_scores_plain(*args, 25, -50, 110, 6, **kw),))
    kw["with_traceback"] = mode == "traceback"
    return (sw_cuda.sw_plane(*args, 25, -50, 110, 6, **kw,
                             warps_per_pair=warps),
            sw_plane_plain(*args, 25, -50, 110, 6, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sw_cuda.PLANE_MODES)
@pytest.mark.parametrize("warps", sw_cuda.BANDED_WARPS)
def test_plane_every_w_matches_plain(cuda, warps, mode):
    """Every W, 1 to 32, in each mode, with the carry row in shared memory:
    every output equal to the plain version's, bit for bit, on pairs of
    1 to 22 bands with one-base queries and a pair at tl = T."""
    args = sw_tensors(*sw_edge_pairs(4), cuda)
    assert sw_cuda.plane_carry_in_shared(
        args[0].shape[0], args[1].shape[1], warps,
        sw_cuda.PLANE_MODES.index(mode), cuda)
    for indel_init in (False, True):
        got, want = _plane_call(args, mode, indel_init, warps)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), indel_init


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sw_cuda.PLANE_MODES)
def test_plane_global_carry_matches_plain(cuda, mode):
    """2,048 queries of 1,000-2,000 bases against targets of 1-64: the
    launcher keeps the carry row in global memory (in shared memory it
    would cost resident blocks), and W = 1, 2 and the wrapper's give the
    plain version's outputs, bit for bit."""
    long_q, short_t = sw_pairs(12, 2048, (1000, 2000), (1, 64))
    args = sw_tensors(short_t, long_q, cuda)
    assert not any(sw_cuda.plane_carry_in_shared(
        2048, args[1].shape[1], w, sw_cuda.PLANE_MODES.index(mode), cuda)
        for w in (1, 2))
    want = _plane_call(args, mode, False)[1]
    for w in (None, 1, 2):
        got = _plane_call(args, mode, False, w)[0]
        torch.cuda.synchronize()
        assert all(torch.equal(g, x) for g, x in zip(got, want)), w
