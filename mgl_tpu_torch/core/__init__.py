"""The port's copies of ``mgl_tpu.core``: SW parameters and the PairHMM
quality contexts."""
