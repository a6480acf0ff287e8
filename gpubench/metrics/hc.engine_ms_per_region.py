"""The likelihood stream's host time in ms a region: the benchmark's
``engine.next`` spans around each ``next()`` of
``compute_likelihoods_stream`` (its dispatches, fetches, rescues and
log10), less the hap-to-reference SW calls that the stream's pull of the
next region runs inside them."""


def read(ctx):
    n = ctx["work"].get("regions", 0)
    if not n or not ctx["spans"].named("engine.next"):
        return None
    return ctx["spans"].self_seconds("engine.next") * 1e3 / n
