"""The port's copy of ``mgl_tpu.batch.bucketing``."""
