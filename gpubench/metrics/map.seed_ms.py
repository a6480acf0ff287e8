"""The program's ``map.seed`` timer (the native seed, lookup and vote of
each chunk's reads) in ms a chunk."""


def read(ctx):
    n = ctx["work"].get("chunks", 0)
    t = ctx["metrics"]["timers_s"].get("map.seed")
    return t * 1e3 / n if n and t is not None else None
