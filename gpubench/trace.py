"""Reduction of a ``torch.profiler`` trace of the measured window to what
the per-layer readers and the result line need: device busy time (the
union of the intervals of kernels, copies and sets on the card), the
window's length, the device time of every op by name, and the idle gaps of
the card by the benchmark range (``gb:<span>``) that was open on the host.
The method of ``mgl_tpu_torch/profile_e2e.py`` (a copy, so that no change
to the program moves it), read from the profiler's flat event list."""

from __future__ import annotations

import collections

import torch

# device-side rows that are not work on the card: ranges mirrored from host
# annotations and runtime bookkeeping
_NOT_WORK = ("aten::", "gb:", "cuda", "Activity Buffer")
WINDOW = "gb:window"


def reduce(prof) -> dict:
    evs = prof.profiler.kineto_results.events()
    dev, host = [], []
    for e in evs:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith(_NOT_WORK):
                continue
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif name.startswith("gb:"):
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                         name[3:]))
    window = [h for h in host if h[2] == WINDOW[3:]]
    if not window:
        raise RuntimeError("the trace holds no gb:window range")
    w0, w1 = window[0][0], window[0][1]
    ops: dict = collections.defaultdict(lambda: [0.0, 0])
    spans = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        ops[name][0] += (e - s) * 1e-9
        ops[name][1] += 1
        spans.append((s, e))
    spans.sort()
    busy, merged = 0, []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps = []
    prev = w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    return {"busy_s": busy * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "ops": {k: (v[0], v[1]) for k, v in ops.items()},
            "idle_by_range": _attribute(gaps, host)}


def _innermost(host) -> list:
    """The host's timeline as (start, end, name) pieces, each named by
    the innermost ``gb:`` range open over it (the ranges of one thread
    nest)."""
    marks = sorted([(s, 1, -i) for i, (s, e, _) in enumerate(host)]
                   + [(e, 0, -i) for i, (s, e, _) in enumerate(host)])
    pieces, stack, prev = [], [], None
    for t, opening, neg in marks:
        if prev is not None and t > prev:
            pieces.append((prev, t, host[stack[-1]][2] if stack else "none"))
        if opening:
            stack.append(-neg)
        elif -neg in stack:
            stack.remove(-neg)
        prev = t
    return pieces


def _attribute(gaps, host) -> dict:
    """Idle seconds of the card by the innermost ``gb:`` range open on the
    host at each moment of each gap ("none" outside every range but the
    window itself)."""
    pieces = _innermost(host)
    out: dict = collections.defaultdict(float)
    j = 0
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k, covered = j, 0
        while k < len(pieces) and pieces[k][0] < g1:
            s, e, name = pieces[k]
            part = min(e, g1) - max(s, g0)
            if part > 0:
                out["none" if name == WINDOW[3:] else name] += part * 1e-9
                covered += part
            k += 1
        if g1 - g0 > covered:
            out["none"] += (g1 - g0 - covered) * 1e-9
    return dict(out)


def breakdown(red: dict, top: int = 10) -> dict:
    ops = sorted(((k, v[0]) for k, v in red["ops"].items()),
                 key=lambda kv: -kv[1])[:top]
    gaps = sorted(red["idle_by_range"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def kernel_seconds(red: dict, *fragments: str) -> float | None:
    """Device seconds of the ops whose name holds every fragment; None if
    the trace has none."""
    hit = [v[0] for k, v in red["ops"].items()
           if all(f in k for f in fragments)]
    return sum(hit) if hit else None
