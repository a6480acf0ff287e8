"""One reader a per-layer metric: ``<metric name>.py`` with ``read(ctx)``,
returning the value or None where the run has nothing to read.  ``ctx``
holds ``cell``, ``spans`` (the benchmark's ``Spans``), ``metrics`` (the
program's ``METRICS`` snapshot over the window), ``trace`` (the reduced
profiler trace: ``busy_s``, ``window_s``, ``ops``, ``idle_by_range``),
``work`` (the driver's counts of what the window needed) and ``window``
(the driver's window result)."""
