"""The host CIGAR decode in ms a region: the benchmark's range around
``kernels.sw_cuda.decode_cigars`` (wrapped from outside in the traced
run), both SW calls."""


def read(ctx):
    n = ctx["work"].get("regions", 0)
    d = ctx["spans"].named("sw_cuda.decode_cigars")
    return sum(s.seconds for s in d) * 1e3 / n if n and d else None
