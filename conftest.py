"""Settings for every test of this repository: a time limit per test.

A test that runs longer than ``TEST_TIME_LIMIT_S``, counting the set-up
and teardown of its fixtures of every scope, ends its process: every
thread's Python stack goes to stderr and the process exits with code 1.
The timer is faulthandler's watchdog thread, so it fires even when the
main thread is blocked in C, where a SIGALRM handler would never run.
Under xdist the worker's end fails the test and a new worker starts; a
test that starts child processes keeps its own ``timeout=`` as well.
"""

import faulthandler
import hashlib
import os
import pathlib

import pytest

# Seconds one test may take: about twice the slowest test, and well under
# the suite's own limit.  Edit it here if it ever has to change.
TEST_TIME_LIMIT_S = 600

_RERUN = pytest.StashKey[bool]()


class TimeLimit:
    """Plugin that ends the process when a test runs past ``seconds``."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        # This process's stderr as it is now, between tests, while pytest
        # does not capture it: fd 2 itself may point into the capture's
        # file when the limit fires, and that file dies with the process.
        self._stderr_fd = os.dup(2)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_protocol(self, item: pytest.Item):
        # With --dist loadfile, xdist hands a new worker the rest of the
        # file from the test that was running when its worker ended, that
        # test included.  So a test leaves a mark in the run's temporary
        # directory while it runs, and a test that finds its own mark
        # fails at once instead of running into the limit again.
        mark = None
        basetemp = getattr(item.config.option, "basetemp", None)
        if hasattr(item.config, "workerinput") and basetemp:
            mark = (pathlib.Path(basetemp).parent / "time-limit"
                    / hashlib.sha1(item.nodeid.encode()).hexdigest())
            item.stash[_RERUN] = mark.exists()
            mark.parent.mkdir(parents=True, exist_ok=True)
            mark.touch()
        faulthandler.dump_traceback_later(
            self.seconds, exit=True, file=self._stderr_fd)
        try:
            return (yield)
        finally:
            faulthandler.cancel_dump_traceback_later()
            if mark is not None:
                mark.unlink()

    @pytest.hookimpl(tryfirst=True)
    def pytest_runtest_setup(self, item: pytest.Item):
        if item.stash.get(_RERUN, False):
            pytest.fail(f"a worker ended in this test at its {self.seconds} s"
                        f" time limit; it is not run again", pytrace=False)


def pytest_configure(config: pytest.Config):
    config.pluginmanager.register(TimeLimit(TEST_TIME_LIMIT_S), "time-limit")
