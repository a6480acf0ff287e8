"""The program's ``map.traceback`` timer (CIGAR mode's post-pass: gather,
SW traceback, the CIGAR walk and the strings) in ms a chunk."""


def read(ctx):
    n = ctx["work"].get("chunks", 0)
    t = ctx["metrics"]["timers_s"].get("map.traceback")
    return t * 1e3 / n if n and t is not None else None
