"""The port's device CIGAR walk against the JAX package on the CPU; on a
card, the walk kernel against its plain version.

What is held:
- ``cigar_walk_plain`` on the port's banded traceback words equals
  ``mgl_tpu.ops.cigar_device._walk_segments`` (jit on the CPU, a plain
  ``lax.scan``) on the same words permuted to the JAX layout (G, 32, B),
  in segs, tail and over, on the fixtures of
  ``tests/test_mapper_scale.py:116`` (96 reads: deletions, insertions,
  clipped and multi-event reads, all four strategies) and ``:160`` (the
  10-17-deletion sweep across SEG_CAP, SOFTCLIP and INDEL), copied into
  ``mgl_tpu_torch.testing`` (``indel_read_set``, ``deletion_sweep_set``),
  and on ``walk_window_set`` (insertions of 9-40 and deletions of 9-47
  bases at band edges, all four strategies, and cut short by n_steps);
- the overflow boundary: a CIGAR of S non-clip runs overflows iff
  S >= SEG_CAP + 2;
- ``finish_cigars`` equals the JAX one;
- pairs that start outside the matrix do not walk.
"""

import re

import numpy as np
import pytest
import torch

from mgl_tpu_torch.core.params import OverhangStrategy, SWParameters
from mgl_tpu_torch.kernels.cigar_walk_cuda import cigar_walk
from mgl_tpu_torch.native import cigar_decode_bulk_banded
from mgl_tpu_torch.ops import cigar_device as C
from mgl_tpu_torch.ops.sw import BAND, EZ_KEYS
from mgl_tpu_torch.pipelines import mapper as M
from mgl_tpu_torch.testing import (deletion_sweep_set, indel_read_set,
                                   walk_window_set)

PARAMS = SWParameters(25, -50, 110, 6)
STRATEGIES = tuple(OverhangStrategy)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


SETS = {"indel": indel_read_set, "sweep": deletion_sweep_set,
        "window": walk_window_set}
_cache: dict = {}


def traceback(name: str, strategy):
    """(ez, words, words a band, tlen, qlen, n_steps) of the port's plain
    gather + sw_banded_plain over a set's windows; cached by the
    strategy's indel_init."""
    indel = bool(strategy & (OverhangStrategy.INDEL
                             | OverhangStrategy.LEADING_INDEL))
    key = (name, indel)
    if key not in _cache:
        ref, starts, reads, wlen = SETS[name]()
        index = M.ReferenceIndex.build(ref, k=16)
        ez, words, wpb = M._sw_traceback_windows(
            index, starts, reads, wlen, PARAMS, strategy,
            torch.device("cpu"))
        B, L = reads.shape
        full = lambda v: torch.full((B,), v, dtype=torch.int32)
        _cache[key] = (ez, words, wpb, full(wlen), full(L), wlen + L)
    return _cache[key]


def jax_walk(words, ez, tl, ql, wpb, strategy, n_steps):
    """mgl_tpu's _walk_segments on the same words, in the port's
    pair-major layout: (segs (B, cap), tail (B, 5), over (B,))."""
    import jax.numpy as jnp

    from mgl_tpu.ops.cigar_device import _walk_fn

    btr = words.numpy().view(np.uint32).transpose(1, 2, 0)
    segs, tail, over = _walk_fn()(
        jnp.asarray(btr), jnp.asarray(ez.numpy()), jnp.asarray(tl.numpy()),
        jnp.asarray(ql.numpy()), BH=BAND, WPB=wpb, strategy=int(strategy),
        n_steps=n_steps, seg_cap=C.SEG_CAP)
    return np.asarray(segs).T, np.asarray(tail).T, np.asarray(over)


def walk(name, strategy):
    ez, words, wpb, tl, ql, n_steps = traceback(name, strategy)
    return cigar_walk(words, ez, tl, ql, strategy, n_steps,
                      words_per_band=wpb)


@pytest.mark.parametrize("name,strategy", [("indel", s) for s in STRATEGIES]
                         + [("sweep", OverhangStrategy.SOFTCLIP),
                            ("sweep", OverhangStrategy.INDEL)]
                         + [("window", s) for s in STRATEGIES])
def test_walk_plain_equals_jax(name, strategy):
    """cigar_walk on CPU tensors (its plain version) equals the JAX
    package's _walk_segments in segs, tail and over."""
    ez, words, wpb, tl, ql, n_steps = traceback(name, strategy)
    segs, tail, over = walk(name, strategy)
    j_segs, j_tail, j_over = jax_walk(words, ez, tl, ql, wpb, strategy,
                                      n_steps)
    assert segs.dtype == tail.dtype == torch.int32
    assert over.dtype == torch.bool
    np.testing.assert_array_equal(segs.numpy(), j_segs)
    np.testing.assert_array_equal(tail.numpy(), j_tail)
    np.testing.assert_array_equal(over.numpy(), j_over)
    # the fixtures walk: every pair took steps, most pushed segments
    assert (tail[:, 2] > 0).all() and (tail[:, 0] > 0).mean(
        dtype=torch.float32) > 0.5
    if name == "sweep":
        assert over.any() and not over.all()
    if name == "window":           # every pair walks an indel of 9+ bases
        runs = torch.where(segs & 3 != 0, segs >> 2, 0).amax(dim=1)
        assert (runs >= 9).all()


@pytest.mark.parametrize("n_steps", [37, 100])
def test_walk_cut_short_equals_jax(n_steps):
    """Walks that n_steps cuts off (inside the first band, and inside a
    long indel or after it) equal the JAX package's, flagged over."""
    s = OverhangStrategy.SOFTCLIP
    ez, words, wpb, tl, ql, _ = traceback("window", s)
    got = cigar_walk(words, ez, tl, ql, s, n_steps, words_per_band=wpb)
    want = jax_walk(words, ez, tl, ql, wpb, s, n_steps)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert got[2].all() and (got[1][:, 2] > 0).all()


def test_overflow_boundary():
    """On the deletion sweep (SOFTCLIP) a pair overflows exactly when its
    host-decoded CIGAR has S >= SEG_CAP + 2 non-clip runs (the walk holds
    SEG_CAP segments and the run in flight), and the sweep holds pairs on
    both sides; where it does not overflow, finish_cigars gives the host
    decoder's CIGAR and offset."""
    s = OverhangStrategy.SOFTCLIP
    ez, words, wpb, tl, ql, _ = traceback("sweep", s)
    segs, tail, over = walk("sweep", s)
    host = cigar_decode_bulk_banded(
        words.numpy().view(np.uint32), dict(zip(EZ_KEYS, ez.numpy().astype(
            np.int64))), tl.numpy(), ql.numpy(), int(s), BAND, wpb)
    res = C.finish_cigars(segs.numpy(), tail.numpy(),
                          {"seg_length": ez[5].numpy()}, tl.numpy(),
                          ql.numpy(), s, len(host))
    n_over = 0
    for i, (cigar, off) in enumerate(host):
        runs = sum(op != "S" for _, op in re.findall(r"(\d+)([MIDS])", cigar))
        assert bool(over[i]) == (runs >= C.SEG_CAP + 2), (i, runs, cigar)
        n_over += bool(over[i])
        if not over[i]:
            assert res[i] == (cigar, off)
    assert len(host) // 4 <= n_over < len(host)


def test_finish_cigars_equals_jax():
    """finish_cigars on the port's pair-major segments equals the JAX
    package's on the same segments transposed, in all four strategies,
    overflowed pairs included."""
    from mgl_tpu.ops.cigar_device import finish_cigars as j_finish

    for name, strategies in (("indel", STRATEGIES),
                             ("sweep", (OverhangStrategy.SOFTCLIP,))):
        for s in strategies:
            ez, _, _, tl, ql, _ = traceback(name, s)
            segs, tail, _ = (x.numpy() for x in walk(name, s))
            ez_d = dict(zip(EZ_KEYS, ez.numpy().astype(np.int64)))
            got = C.finish_cigars(segs, tail, ez_d, tl.numpy(), ql.numpy(),
                                  s, len(tl))
            assert got == j_finish(segs.T, tail.T, ez_d, tl.numpy(),
                                   ql.numpy(), s, len(tl)), (name, s)


def zero_start_inputs(dev):
    """Eight pairs of the indel set whose walk starts (max_t, max_q under
    SOFTCLIP) are set to 0 in I, J or both on pairs 0-2, and whose tlen /
    qlen (INDEL's start) are 0 on pairs 3-4."""
    ez, words, wpb, tl, ql, n_steps = traceback("indel",
                                                OverhangStrategy.SOFTCLIP)
    ez, words = ez[:, :8].clone(), words[:8].clone()
    tl, ql = tl[:8].clone(), ql[:8].clone()
    ez[3, 0] = 0
    ez[4, 1] = 0
    ez[3:5, 2] = 0
    tl[3] = 0
    ql[4] = 0
    return [x.to(dev) for x in (words, ez, tl, ql)], wpb, n_steps


def test_zero_start_never_walks():
    """A pair whose start has I or J at 0 takes no step: no segment, tail
    (0, 0, 0, I0, J0), not overflowed - as in the JAX package."""
    (words, ez, tl, ql), wpb, n_steps = zero_start_inputs("cpu")
    for s, idle in ((OverhangStrategy.SOFTCLIP, (0, 1, 2)),
                    (OverhangStrategy.INDEL, (3, 4))):
        segs, tail, over = cigar_walk(words, ez, tl, ql, s, n_steps,
                                      words_per_band=wpb)
        j_segs, j_tail, j_over = jax_walk(words, ez, tl, ql, wpb, s, n_steps)
        np.testing.assert_array_equal(segs.numpy(), j_segs)
        np.testing.assert_array_equal(tail.numpy(), j_tail)
        np.testing.assert_array_equal(over.numpy(), j_over)
        for b in idle:
            assert not segs[b].any() and not over[b]
            assert tail[b, :3].tolist() == [0, 0, 0]
        assert (tail[[b for b in range(8) if b not in idle], 2] > 0).all()


def test_walk_refuses_bad_inputs():
    """The wrapper names what is wrong: words not (B, G, 32) int32, ez of
    another batch, a words_per_band that does not divide G, a strategy
    that is no OverhangStrategy code."""
    ez, words, wpb, tl, ql, n = traceback("indel", OverhangStrategy.SOFTCLIP)
    s = OverhangStrategy.SOFTCLIP
    with pytest.raises(ValueError, match="words"):
        cigar_walk(words.long(), ez, tl, ql, s, n, words_per_band=wpb)
    with pytest.raises(ValueError, match="ez"):
        cigar_walk(words, ez[:, 1:], tl, ql, s, n, words_per_band=wpb)
    with pytest.raises(ValueError, match="words_per_band"):
        cigar_walk(words, ez, tl, ql, s, n, words_per_band=wpb + 1)
    with pytest.raises(ValueError, match="strategy"):
        cigar_walk(words, ez, tl, ql, 3, n, words_per_band=wpb)


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_walk_kernel_matches_plain(cuda):
    """The walk kernel equals its plain version bit for bit on the card:
    the three fixtures in every strategy (overflowed pairs included), the
    window set's walks cut short, and the zero-start pairs; the launch
    counter moves once a call."""
    cases = [(n, s) for n in SETS for s in STRATEGIES]
    for name, s in cases:
        ez, words, wpb, tl, ql, n_steps = traceback(name, s)
        args = [x.to(cuda) for x in (words, ez, tl, ql)]
        n0 = cigar_walk.launches
        got = cigar_walk(*args, s, n_steps, words_per_band=wpb)
        torch.cuda.synchronize()
        assert cigar_walk.launches == n0 + 1
        want = C.cigar_walk_plain(*args, strategy=int(s), n_steps=n_steps,
                                  words_per_band=wpb)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (name, s)
    ez, words, wpb, tl, ql, _ = traceback("window", OverhangStrategy.SOFTCLIP)
    args = [x.to(cuda) for x in (words, ez, tl, ql)]
    for n_steps in (37, 100):
        got = cigar_walk(*args, OverhangStrategy.SOFTCLIP, n_steps,
                         words_per_band=wpb)
        want = C.cigar_walk_plain(*args, strategy=int(OverhangStrategy.SOFTCLIP),
                                  n_steps=n_steps, words_per_band=wpb)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), n_steps
    args, wpb, n_steps = zero_start_inputs(cuda)
    for s in (OverhangStrategy.SOFTCLIP, OverhangStrategy.INDEL):
        got = cigar_walk(*args, s, n_steps, words_per_band=wpb)
        want = C.cigar_walk_plain(*args, strategy=int(s), n_steps=n_steps,
                                  words_per_band=wpb)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), s
