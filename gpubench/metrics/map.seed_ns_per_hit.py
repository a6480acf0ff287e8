"""The program's ``map.seed`` timer over its ``map.seed_hits`` counter (the
index entries the kept seeds returned into the vote), in ns a hit: the
cost of a lookup, which an index that stays in the host's caches hides."""


def read(ctx):
    t = ctx["metrics"]["timers_s"].get("map.seed")
    hits = ctx["metrics"]["counters"].get("map.seed_hits")
    return t * 1e9 / hits if t is not None and hits else None
