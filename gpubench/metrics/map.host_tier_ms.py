"""The program's ``map.host_tier`` timer (window starts, orientation, the
exact and gap-free tiers) in ms a chunk."""


def read(ctx):
    n = ctx["work"].get("chunks", 0)
    t = ctx["metrics"]["timers_s"].get("map.host_tier")
    return t * 1e3 / n if n and t is not None else None
