"""The plain reference that decides ``correct``: NumPy and plain torch.

It imports nothing of the program under test, of ``mgl_tpu`` or of JAX,
and works out from the benchmark's raw inputs again whatever the program
derives from them (quality tables, the k-mer index, the seeds, the DP
matrices).  Each recurrence is written once and takes its precision as an
argument, so the same code gives the reference and its lower-precision
control.
"""
