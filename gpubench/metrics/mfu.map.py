"""The window's share (%) of the card's peak: the SW work its calls needed
(``sw_banded_roofline.map``'s operations) at the INT32 rate, over the
traced window's length."""

from gpubench.counts import peaks


def read(ctx):
    red, w = ctx["trace"], ctx["work"]
    if red["busy_s"] <= 0 or not w.get("sw_ops"):
        return None
    return 100.0 * w["sw_ops"] / peaks.INT32_OPS / red["window_s"]
