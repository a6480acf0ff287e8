"""95th percentile of a region's latency in ms: from the start of its
hap-to-reference SW call to the end of its read-to-hap SW call, on the
benchmark's clock, over every region of the window."""

import numpy as np


def read(ctx):
    d = [s.seconds for s in ctx["spans"].named("region")]
    return float(np.percentile(d, 95) * 1e3) if d else None
