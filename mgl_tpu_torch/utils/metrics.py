"""Lightweight counters/timers + profiler hooks.

The port's copy of ``mgl_tpu/utils/metrics.py``, with the same metric
names (``sw.pairs``, ``sw.buckets``, ``sw.align_batch``, ``engine.f32``,
``engine.rescue``).  The reference ships no tracing or metrics; this
module provides cheap host-side counters, wall-clock scopes, and a
``torch.profiler`` trace context that writes a Chrome trace.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import threading
import time


class Metrics:
    """Process-wide counters and timing accumulators (thread-safe: callers
    may align and score from several threads at once)."""

    def __init__(self):
        self.counters: dict[str, float] = collections.defaultdict(float)
        self.timers: dict[str, float] = collections.defaultdict(float)
        self.calls: dict[str, int] = collections.defaultdict(int)
        self._lock = threading.Lock()

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.timers[name] += dt
                self.calls[name] += 1

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "timers_s": {k: round(v, 6) for k, v in self.timers.items()},
            "calls": dict(self.calls),
        }

    def dump(self) -> str:
        return json.dumps(self.snapshot())

    def reset(self) -> None:
        self.counters.clear()
        self.timers.clear()
        self.calls.clear()


METRICS = Metrics()


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """Capture a ``torch.profiler`` trace of the host and, where a card is
    present, the card, and write it as a Chrome trace (open with
    chrome://tracing or Perfetto) into ``log_dir``, by default
    ``mgl_tpu_trace`` under the temporary directory (``TMPDIR``)."""
    import torch

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "mgl_tpu_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
