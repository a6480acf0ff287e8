"""The window's share (%) of the card's peak: the least time of the work
its regions needed - the f32 pass's flops at the f32 peak and both SW
calls' int32 operations at the INT32 rate (``counts.work``; the f64
rescue is not counted, so this is a lower bound) - over the traced
window's length."""

from gpubench.counts import peaks


def read(ctx):
    red, w = ctx["trace"], ctx["work"]
    if red["busy_s"] <= 0 or not w.get("f32_flops"):
        return None
    need = w["f32_flops"] / peaks.F32_FLOPS + w["sw_ops"] / peaks.INT32_OPS
    return 100.0 * need / red["window_s"]
