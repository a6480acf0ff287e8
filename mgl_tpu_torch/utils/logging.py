"""Logging configuration for mgl_tpu_torch.

The port's copy of ``mgl_tpu/utils/logging.py``, under the
``mgl_tpu_torch`` namespace and read from the same ``MGL_TPU_LOG``
variable, so one setting serves both packages.

The reference ships a log4j2 config with per-component levels
(src/main/resources/log4j2.xml) and logs load/dispatch decisions from the
JNI loader (NativeLibraryLoader.java:51-87).  The equivalent here uses
the stdlib ``logging`` package under one ``mgl_tpu_torch`` namespace:

* ``get_logger("engine")`` -> logger ``mgl_tpu_torch.engine`` (lazy
  handler setup, never touches the root logger — embedding applications
  keep full control);
* default level WARNING; ``MGL_TPU_LOG=debug|info|warning|error`` (or a
  number) overrides it globally and ``MGL_TPU_LOG=engine=debug,io=info``
  sets per-component levels, the log4j2-style granularity knob;
* format includes the component and wall time, matching what the
  reference's PatternLayout records.
"""

from __future__ import annotations

import logging
import os
import sys

NAMESPACE = "mgl_tpu_torch"
_CONFIGURED = False


class _LazyStderrHandler(logging.StreamHandler):
    """Resolves sys.stderr at emit time, so redirections after configure
    (pytest capture, daemonization) are honored."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        return sys.stderr

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "warn": logging.WARNING,
    "error": logging.ERROR,
}


def _parse_level(spec: str) -> int | None:
    spec = spec.strip().lower()
    if spec in _LEVELS:
        return _LEVELS[spec]
    if spec.isdigit():
        return int(spec)
    return None


def configure(force: bool = False) -> None:
    """Idempotent handler/level setup for the ``mgl_tpu_torch`` namespace
    from ``MGL_TPU_LOG`` (global level and/or comma-separated
    ``component=level`` pairs)."""
    global _CONFIGURED
    if _CONFIGURED and not force:
        return
    _CONFIGURED = True
    base = logging.getLogger(NAMESPACE)
    if not base.handlers:
        h = _LazyStderrHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        base.addHandler(h)
        base.propagate = False
    base.setLevel(logging.WARNING)
    spec = os.environ.get("MGL_TPU_LOG", "")
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" in part:
            comp, _, lv = part.partition("=")
            level = _parse_level(lv)
            if level is not None:
                logging.getLogger(f"{NAMESPACE}.{comp.strip()}").setLevel(level)
        else:
            level = _parse_level(part)
            if level is not None:
                base.setLevel(level)


def get_logger(component: str) -> logging.Logger:
    """Component logger (``mgl_tpu_torch.<component>``), configuring on
    first use."""
    configure()
    return logging.getLogger(f"{NAMESPACE}.{component}")
