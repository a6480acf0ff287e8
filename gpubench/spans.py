"""The benchmark's own spans: name, start, end and the span open around
it, kept in memory on the host clock.  In a traced run each span is also a
``torch.profiler.record_function`` range named ``gb:<name>``, so the
profiler's trace can say what the host was doing while the card idled."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    parent: int          # index of the enclosing span, -1 at the top

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Spans:
    def __init__(self, traced: bool = False):
        self.traced = traced
        self.spans: list[Span] = []
        self._open: list[int] = []

    @contextlib.contextmanager
    def span(self, name: str):
        idx = len(self.spans)
        parent = self._open[-1] if self._open else -1
        self.spans.append(Span(name, time.perf_counter(), 0.0, parent))
        self._open.append(idx)
        rf = (torch.profiler.record_function(f"gb:{name}") if self.traced
              else contextlib.nullcontext())
        try:
            with rf:
                yield
        finally:
            self._open.pop()
            self.spans[idx].end = time.perf_counter()

    @contextlib.contextmanager
    def wrapped(self, module, names: tuple[str, ...]):
        """Put the functions ``names`` of ``module`` under spans named
        ``<module's last name>.<function>`` while the context lasts,
        wrapped from outside (callers that look them up in the module
        at call time see the wrappers)."""
        prefix = module.__name__.rsplit(".", 1)[-1]
        inner = {name: getattr(module, name) for name in names}

        def wrap(name, fn):
            def staged(*args, **kwargs):
                with self.span(f"{prefix}.{name}"):
                    return fn(*args, **kwargs)
            return staged

        for name, fn in inner.items():
            setattr(module, name, wrap(name, fn))
        try:
            yield
        finally:
            for name, fn in inner.items():
                setattr(module, name, fn)

    def add(self, name: str, start: float, end: float) -> None:
        """A span timed by the caller (one that outlives a ``with``)."""
        self.spans.append(Span(name, start, end, -1))

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def self_seconds(self, name: str) -> float:
        """Total time of the spans called ``name``, less the part of it
        that their child spans cover."""
        total = sum(s.seconds for s in self.named(name))
        ids = {i for i, s in enumerate(self.spans) if s.name == name}
        inner = sum(s.seconds for s in self.spans if s.parent in ids)
        return total - inner
