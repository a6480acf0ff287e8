"""Share (%) of the traced window in which no kernel, copy or set ran on
the card (the union of their intervals in the profiler's trace)."""


def read(ctx):
    red = ctx["trace"]
    if red["busy_s"] <= 0 or red["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])
