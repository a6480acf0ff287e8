"""Drivers: the loop that drives one family of the program's entry points
through the measured window.  A configuration names its driver; a driver
module provides ``setup``, ``run_window``, ``trace_hooks``, ``work``,
``release`` and ``check`` (see ``gpubench/run.py``)."""
