"""mgl-tpu on PyTorch and CUDA: GATK's SW and PairHMM on an NVIDIA H100.

A port of ``mgl_tpu`` (JAX on a TPU), which stays beside it as the
reference.  Each Pallas kernel of the main path has a hand-written CUDA
counterpart in ``csrc/`` and a plain torch version beside its wrapper:

    from mgl_tpu_torch.api import SmithWatermanAligner, PairHmmEngine

    SmithWatermanAligner(device="cuda").align_batch(refs, alts, params,
                                                    strategy)
    PairHmmEngine(device="cuda").compute_likelihoods(reads, haps)

``device="cuda"`` runs the kernels and raises when no card is present;
``device="cpu"`` runs the plain versions.  This package imports torch and
never jax or anything of ``mgl_tpu``: it keeps its own copies of the host
modules it needs (``core``, ``batch.bucketing``, ``native``).
"""

__version__ = "0.1.0"
