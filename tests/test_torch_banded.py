"""The banded SW kernel's warps a pair (``csrc/sw_banded.cu``).

On the CPU: the rule that picks W (``sw_cuda.banded_warps``) and the
check of a forced W.  On the card (``cuda``): every W, 1 to 32, bit-equal
to the plain version in both modes on a ragged batch and on queries of
29,000-30,000 bases, and the chosen W at 8000x2000 against the plane
kernel.  Imports no jax, so the card tests
also run on a GPU host without it:
``python -m pytest tests/test_torch_banded.py -m cuda``.
"""

import pytest
import torch

from mgl_tpu_torch.kernels import sw_cuda
from mgl_tpu_torch.ops.sw import banded_layout
from mgl_tpu_torch.testing import (sw_edge_pairs, sw_pairs, sw_tensors,
                                   traceback_mismatches)

SW = (25, -50, 110, 6)                 # STANDARD_NGS
H100_SMS = 132


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("n_pairs, n_bands, sm_count, want", [
    (10_000, 5, H100_SMS, 1),          # the 150 bp batch fills the card
    (2048, 5, H100_SMS, 1),            # so does one aligner bucket of it
    (H100_SMS * sw_cuda.WARPS_PER_SM, 250, H100_SMS, 1),
    (1024, 5, H100_SMS, 2),
    (64, 250, H100_SMS, 16),           # 64 pairs of 8000 x 2000
    (64, 20, H100_SMS, 16),
    (500, 250, H100_SMS, 4),
    (3, 6, H100_SMS, 4),               # capped by the bands
    (1, 1, H100_SMS, 1),
    (1, 1000, H100_SMS, 16),
    (7, 40, 4, 8),
])
def test_warps_per_pair_rule(n_pairs, n_bands, sm_count, want):
    """W is a power of two, at most n_bands and 32, the least that puts
    WARPS_PER_SM warps on each SM holding a pair, and 1 when the pairs
    alone do."""
    w = sw_cuda.banded_warps(n_pairs, n_bands, sm_count)
    target = min(n_pairs, sm_count) * sw_cuda.WARPS_PER_SM
    assert w == want
    assert w in sw_cuda.BANDED_WARPS and w <= n_bands
    assert w == 1 or n_pairs * (w // 2) < target          # no larger than needed
    assert n_pairs * w >= target or 2 * w > min(n_bands, 32)  # fills, or capped
    if n_pairs >= target:
        assert w == 1


def test_forced_w_must_be_a_power_of_two_up_to_32():
    """Forcing a W outside BANDED_WARPS is refused before anything runs."""
    args = sw_tensors(*sw_pairs(1, 2, (10, 20), (10, 20)), "cpu")
    with pytest.raises(ValueError, match="warps_per_pair"):
        sw_cuda.sw_banded(*args, *SW, indel_init=False, warps_per_pair=3)


@pytest.mark.cuda
@pytest.mark.parametrize("with_traceback", [True, False])
@pytest.mark.parametrize("indel_init", [False, True])
@pytest.mark.parametrize("warps", sw_cuda.BANDED_WARPS)
def test_every_w_matches_plain(cuda, warps, indel_init, with_traceback):
    """sw_banded with W forced equals sw_banded_plain: ez exact, nibbles
    equal on every real cell."""
    args = sw_tensors(*sw_edge_pairs(4), cuda)
    kw = dict(indel_init=indel_init, with_traceback=with_traceback)
    ez_k, w_k = sw_cuda.sw_banded(*args, *SW, **kw, warps_per_pair=warps)
    ez_p, w_p = sw_cuda.sw_banded_plain(*args, *SW, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ez_k, ez_p)
    if with_traceback:
        wpb = banded_layout(args[0].shape[1], args[1].shape[1])[1]
        assert traceback_mismatches(w_k, w_p, args[2], args[3], wpb) == 0
    else:
        assert w_k is None and w_p is None


@pytest.mark.cuda
def test_long_queries_match_plain(cuda):
    """Queries of 29,000-30,000 bases (a carry row of 240 KB a pair, more
    than a block's shared memory, so it lies in global memory): W = 2's
    ez and real-cell nibbles equal the plain version's (run on the CPU,
    ~11 s a mode) in both modes, and W = 1 and 8 give W = 2's."""
    pairs = sw_pairs(6, 6, (40, 200), (29_000, 30_000))
    args, cpu_args = sw_tensors(*pairs, cuda), sw_tensors(*pairs, "cpu")
    wpb = banded_layout(args[0].shape[1], args[1].shape[1])[1]
    for tb in (True, False):
        assert not any(sw_cuda.banded_carry_in_shared(6, args[1].shape[1], w,
                                                      tb, cuda)
                       for w in (1, 2, 8))
        kw = dict(indel_init=False, with_traceback=tb)
        ez_p, w_p = sw_cuda.sw_banded_plain(*cpu_args, *SW, **kw)
        ez_2, w_2 = sw_cuda.sw_banded(*args, *SW, **kw, warps_per_pair=2)
        assert torch.equal(ez_2.cpu(), ez_p), tb
        if tb:
            assert traceback_mismatches(w_2.cpu(), w_p, cpu_args[2],
                                        cpu_args[3], wpb) == 0
        for warps in (1, 8):
            ez, w = sw_cuda.sw_banded(*args, *SW, **kw, warps_per_pair=warps)
            assert torch.equal(ez, ez_2), (warps, tb)
            if tb:
                assert traceback_mismatches(w, w_2, args[2], args[3],
                                            wpb) == 0, warps


@pytest.mark.cuda
@pytest.mark.parametrize("n_pairs, q, warps, shared", [
    (10_000, 150, 1, True),            # short reads: the row fits, 32 a SM
    (64, 2000, 16, True),              # few long pairs: 1 block a SM
    (2048, 2000, 1, False),            # 12 blocks a SM fit, 16 wanted
    (2048, 10_000, 1, False),          # 2 fit
    (6, 30_000, 2, False),             # over the opt-in limit
])
def test_carry_row_placement(cuda, n_pairs, q, warps, shared):
    """The launcher keeps the carry row in shared memory only where that
    costs no resident blocks the batch would use, in both modes."""
    for tb in (True, False):
        assert sw_cuda.banded_carry_in_shared(n_pairs, q, warps, tb,
                                              cuda) == shared


@pytest.mark.cuda
def test_long_pairs_chosen_w_matches_plane(cuda):
    """At 64 x 8000x2000 the wrapper's W gives the plane kernel's ez and
    best scores, in both modes."""
    args = sw_tensors(*sw_pairs(22, 64, (8000, 8000), (2000, 2000)), cuda)
    want = sw_cuda.sw_plane(*args, *SW, indel_init=False)[0]
    best = sw_cuda.sw_plane_scores(*args, *SW, indel_init=False)
    for tb in (True, False):
        ez, _ = sw_cuda.sw_banded(*args, *SW, indel_init=False,
                                  with_traceback=tb)
        assert torch.equal(ez, want) and torch.equal(ez[2], best)
