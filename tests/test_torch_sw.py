"""mgl_tpu_torch's SW path on the CPU, held to the JAX package.

The port's plain torch SW (the CUDA kernel's plain version) against
``mgl_tpu.ops.sw`` (the JAX executable spec), against
``mgl_tpu.api.SmithWatermanAligner(impl="xla")`` and the golden CIGARs,
and against the banded Pallas kernel's traceback nibbles run in interpret
mode.  All comparisons are exact (int32).  Small shapes: a few seconds
on one thread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgl_tpu.api import SmithWatermanAligner as JaxAligner
from mgl_tpu.core.params import (NEW_SW_PARAMETERS, ORIGINAL_DEFAULT,
                                 STANDARD_NGS, OverhangStrategy, SWParameters)
from mgl_tpu.ops import sw as jax_sw
from mgl_tpu_torch.api import SmithWatermanAligner
from mgl_tpu_torch.kernels.sw_cuda import sw_banded
from mgl_tpu_torch.ops.sw import EZ_KEYS, BAND, banded_layout
from mgl_tpu_torch.testing import golden_groups, sw_pairs, sw_tensors

torch.set_num_threads(1)

@pytest.mark.parametrize("indel_init", [False, True])
@pytest.mark.parametrize("params", [STANDARD_NGS, NEW_SW_PARAMETERS,
                                    ORIGINAL_DEFAULT],
                         ids=["standard_ngs", "new_sw", "original_default"])
def test_ez_equals_jax_spec(params, indel_init):
    """The port's ScoreMax rows equal mgl_tpu.ops.sw.compute_score_max over
    sw_forward's last-row / last-column samples, exactly."""
    targets, queries = sw_pairs(7, 24, (3, 70), (2, 70), err=0.1)
    tg, qr, tl, ql = sw_tensors(targets, queries, "cpu")
    ez, _ = sw_banded(tg, qr, tl, ql, params.match, params.mismatch,
                      params.gap_open, params.gap_extend,
                      indel_init=indel_init, with_traceback=False)
    res = jax_sw.sw_forward(
        jnp.asarray(tg.numpy().astype(np.int32)), jnp.asarray(tl.numpy()),
        jnp.asarray(qr.numpy().astype(np.int32)), jnp.asarray(ql.numpy()),
        jnp.int32(params.match), jnp.int32(params.mismatch),
        jnp.int32(params.gap_open), jnp.int32(params.gap_extend),
        indel_init=indel_init, with_traceback=False)
    want = jax_sw.compute_score_max(np.asarray(res.last_col),
                                    np.asarray(res.last_row),
                                    tl.numpy(), ql.numpy())
    for k, key in enumerate(EZ_KEYS):
        assert np.array_equal(ez[k].numpy(), np.asarray(want[key])), key


def _check_against_golden_and_jax(rows):
    port = SmithWatermanAligner(device="cpu")
    ref = JaxAligner(impl="xla")
    for (m, x, o, e, s), rs in golden_groups(rows).items():
        args = ([r["target"].encode() for r in rs],
                [r["query"].encode() for r in rs],
                SWParameters.normalized(m, x, o, e), OverhangStrategy(s))
        got = port.align_batch(*args)
        want = ref.align_batch(*args)
        for r, g, w in zip(rs, got, want):
            assert (g.cigar, g.offset) == (r["cigar_scalar"],
                                           r["offset_scalar"]), r
            assert (g.cigar, g.offset) == (w.cigar, w.offset), r


def test_golden_small_all_strategies(sw_golden):
    """Pairs up to 60 bp, all four strategies and parameter sets: CIGAR and
    offset equal the golden and the JAX package's XLA path."""
    rows = [r for r in sw_golden
            if len(r["target"]) <= 60 and len(r["query"]) <= 60]
    assert len(rows) >= 40
    _check_against_golden_and_jax(rows)


def test_golden_medium(sw_golden):
    """The first 48 pairs of 60-120 bp, as tests/test_sw_jax.py takes them."""
    rows = [r for r in sw_golden
            if 60 < max(len(r["target"]), len(r["query"])) <= 120][:48]
    assert rows
    _check_against_golden_and_jax(rows)


def test_nibbles_equal_pallas_banded_kernel(monkeypatch):
    """The port's traceback words hold, on every real cell, the nibble the
    TPU kernel (sw_pallas_banded, Mosaic interpreter) emits for it: same
    move, E-extend and F-extend bits in the other layout."""
    monkeypatch.setenv("MGL_TPU_PALLAS_INTERPRET", "1")
    from mgl_tpu.kernels.sw_pallas import (prepare_inputs_banded,
                                           sw_pallas_banded)

    targets, queries = sw_pairs(4, 6, (8, 32), (8, 32), err=0.1)
    tg, qr, tl, ql = sw_tensors(targets, queries, "cpu")
    p = STANDARD_NGS
    ez, words = sw_banded(tg, qr, tl, ql, p.match, p.mismatch, p.gap_open,
                          p.gap_extend, indel_init=True)
    B, T = tg.shape
    Q = qr.shape[1]
    ins = prepare_inputs_banded(tg.numpy().astype(np.int32), tl.numpy(),
                                qr.numpy().astype(np.int32), ql.numpy())
    ez_j, btr = sw_pallas_banded(*(jnp.asarray(a) for a in ins), p.match,
                                 p.mismatch, p.gap_open, p.gap_extend,
                                 indel_init=True, interpret=True)
    assert np.array_equal(ez.numpy(), np.asarray(ez_j)[:, :B])
    btr = np.asarray(btr).transpose(2, 0, 1)[:B]       # (B, G_tpu, 32)
    wpb_tpu = (ins[1].shape[0] - 1 + 7) // 8           # sw_pallas.py:958
    wpb = banded_layout(T, Q)[1]
    w = words.numpy().view(np.uint32)
    for b in range(B):
        for i in range(1, int(tl[b]) + 1):
            s = (i - 1) % BAND
            for j in range(1, int(ql[b]) + 1):
                t = j - 1 + s
                band = (i - 1) // BAND
                got = (int(w[b, band * wpb + t // 8, s]) >> (4 * (t % 8))) & 15
                want = (int(btr[b, band * wpb_tpu + t // 8, s])
                        >> (4 * (t % 8))) & 15
                assert got == want, (b, i, j)
