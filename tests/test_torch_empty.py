"""Empty products through the port's PairHmmEngine: no reads, no haps, or
neither, in every mode and through the stream, against the JAX package
wherever it gives an answer.

The port returns an empty (R, H) float64 matrix for each, and launches
nothing.  One deliberate departure from ``mgl_tpu``: under ``fast_path``
the JAX package raises on an empty product (``mgl_tpu/ops/
seed_extend.py:89``, ``max()`` of an empty sequence), where the port
returns the empty matrix as its other two modes do.
"""

import numpy as np
import pytest
import torch

from mgl_tpu_torch.api import PairHmmEngine
from mgl_tpu_torch.ops.pairhmm import use_shared_kernel
from mgl_tpu_torch.testing import engine_region

torch.set_num_threads(1)

MODES = [{}, {"use_double": True}, {"fast_path": True}]
# (reads, haps) of each empty product: (0, 3), (2, 0), (0, 0)
SHAPES = [(0, 3), (2, 0), (0, 0)]


def _inputs(n_reads: int, n_haps: int):
    reads, haps = engine_region(31, n_reads=4, n_haps=3, rdlen=40,
                                haplen=60)
    return reads[:n_reads], haps[:n_haps]


@pytest.mark.parametrize("mode", MODES, ids=["default", "use_double",
                                             "fast_path"])
@pytest.mark.parametrize("shape", SHAPES, ids=["no_reads", "no_haps",
                                               "neither"])
def test_empty_product_gives_empty_matrix(mode, shape):
    """compute_likelihoods and the stream give an (R, H) float64 matrix
    with no entries; the JAX package gives the same where it answers (its
    fast_path raises: see the module docstring)."""
    from mgl_tpu.api import PairHmmEngine as JaxEngine

    reads, haps = _inputs(*shape)
    eng = PairHmmEngine(device="cpu", **mode)
    got = eng.compute_likelihoods(reads, haps)
    assert got.shape == shape and got.dtype == np.float64
    streamed = list(eng.compute_likelihoods_stream(iter([(reads, haps)] * 3)))
    assert len(streamed) == 3
    for s in streamed:
        assert s.shape == shape and s.dtype == np.float64
    jax_eng = JaxEngine(impl="xla", **mode)
    if mode.get("fast_path"):
        with pytest.raises(ValueError):
            jax_eng.compute_likelihoods(reads, haps)
        return
    want = jax_eng.compute_likelihoods(reads, haps)
    assert want.shape == got.shape


def test_stream_mixes_empty_and_full_regions():
    """An empty region between two full ones: the stream's outputs equal
    sequential calls, the empty one (0, 3) in place, in the default mode
    (shared mode for the full regions)."""
    full = engine_region(32, n_reads=96, n_haps=3, rdlen=40, haplen=60)
    assert use_shared_kernel([len(r["bases"]) for r in full[0]], full[1])
    batches = [full, ([], full[1]), full]
    eng = PairHmmEngine(device="cpu")
    out = list(eng.compute_likelihoods_stream(iter(batches)))
    assert [o.shape for o in out] == [(96, 3), (0, 3), (96, 3)]
    want = eng.compute_likelihoods(*full)
    assert np.array_equal(out[0], want) and np.array_equal(out[2], want)


def test_shared_estimate_refuses_no_reads():
    """The shared-or-product estimate says no to zero reads (both work
    estimates are 0 there), and yes to the same haps with reads."""
    reads, haps = engine_region(33, n_reads=96, n_haps=3, rdlen=40,
                                haplen=60)
    assert not use_shared_kernel([], haps)
    assert use_shared_kernel([len(r["bases"]) for r in reads], haps)
