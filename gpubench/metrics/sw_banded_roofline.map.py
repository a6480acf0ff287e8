"""Share (%) of the mapper's SW work's least time in the banded SW
kernel's device time: the larger of the needed int32 operations (score
windows at 12 a cell, traceback windows at 30) over the INT32 rate worked
out in ``counts.peaks`` and the bytes over HBM bandwidth, over the device
time of every ``sw_wavefront_kernel`` launch."""

from gpubench.counts import peaks
from gpubench.trace import kernel_seconds


def read(ctx):
    red, w = ctx["trace"], ctx["work"]
    t = kernel_seconds(red, "sw_wavefront_kernel")
    if not t or not w.get("sw_ops"):
        return None
    need = max(w["sw_ops"] / peaks.INT32_OPS, w["sw_bytes"] / peaks.HBM_BYTES)
    return 100.0 * need / t
