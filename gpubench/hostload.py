"""The process's CPU seconds (user and system) over the window, second by
second, printed to standard error beside the driver's own work a second:
a slow stretch in which the CPU seconds a second hold while the work a
second falls is one in which the same CPU time bought less work, that is
the host's CPUs ran slower, and not one in which the process waited."""

from __future__ import annotations

import resource
import sys
import threading
import time


def _sample() -> tuple[float, float]:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return time.perf_counter(), ru.ru_utime + ru.ru_stime


class HostLoad:
    """A thread that samples once every ``every`` seconds while entered."""

    def __init__(self, every: float = 1.0):
        self.every = every
        self.samples: list[tuple[float, float]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(self.every):
            self.samples.append(_sample())

    def __enter__(self) -> "HostLoad":
        self.samples.append(_sample())
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.samples.append(_sample())

    def per_second(self) -> dict:
        s = self.samples
        wall = s[-1][0] - s[0][0]
        return {"cpu_s": [round(b[1] - a[1], 3) for a, b in zip(s, s[1:])],
                "cpu_over_wall": round((s[-1][1] - s[0][1]) / wall, 3)
                if wall > 0 else None}

    def report(self, file=sys.stderr) -> None:
        for k, v in self.per_second().items():
            print(f"gpubench: host {k}: {v}", file=file)
