"""The program's ``sw.align_batch`` timer (both SW calls of a region) in
ms a region."""


def read(ctx):
    n = ctx["work"].get("regions", 0)
    t = ctx["metrics"]["timers_s"].get("sw.align_batch")
    return t * 1e3 / n if n and t is not None else None
