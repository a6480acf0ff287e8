"""The per-test time limit of the repository's root conftest.py: a child
pytest runs a throwaway file under its ``TimeLimit`` plugin with a short
limit.  A test that sleeps past it must end its process a little after
the limit, with a non-zero code and every thread's stack on stderr; short
tests must pass.  The limit covers a module-scoped fixture's set-up too.
Under xdist the hung test must fail once, and the rest of its file must
run on the new worker.
"""

import pathlib
import subprocess
import sys
import textwrap
import time

import pytest

REPO_CONFTEST = pathlib.Path(__file__).resolve().parents[1] / "conftest.py"
LIMIT_S = 3


@pytest.mark.parametrize(
    "sleeper,sleep_s,xdist",
    [("test_sleeper", 60, False), ("test_sleeper", 0.1, False),
     ("test_sleeper", 60, True), ("module_set_up", 60, False)],
    ids=["hangs", "passes", "hangs-xdist", "hangs-in-module-set-up"])
def test_time_limit_ends_a_hung_test(tmp_path, sleeper, sleep_s, xdist):
    (tmp_path / "conftest.py").write_text(textwrap.dedent(f"""\
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "repo_conftest", {str(REPO_CONFTEST)!r})
        repo_conftest = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(repo_conftest)


        def pytest_configure(config):
            config.pluginmanager.register(
                repo_conftest.TimeLimit({LIMIT_S}), "time-limit")
        """))
    (tmp_path / "test_sleeper.py").write_text(textwrap.dedent(f"""\
        import time

        import pytest


        @pytest.fixture(scope="module")
        def module_set_up():
            if {sleeper!r} == "module_set_up":
                time.sleep({sleep_s})


        def test_sleeper(module_set_up):
            if {sleeper!r} == "test_sleeper":
                time.sleep({sleep_s})


        def test_after():
            pass
        """))
    dist = ["-p", "xdist", "-n", "1", "--dist", "loadfile"] if xdist else \
        ["-p", "no:xdist"]
    t0 = time.monotonic()
    p = subprocess.Popen(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", *dist, "test_sleeper.py"],
        cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    elapsed = time.monotonic() - t0
    if sleep_s < LIMIT_S:
        assert p.returncode == 0, out + err
        assert "2 passed" in out, out
        assert "Timeout" not in err, err
        return
    assert p.returncode != 0, out
    assert err.count("Timeout (") == 1, err
    assert f"Timeout (0:00:{LIMIT_S:02d})!" in err, err
    assert f"in {sleeper}" in err, err
    if xdist:
        assert "crashed while running 'test_sleeper.py::test_sleeper'" in out
        assert "it is not run again" in out, out
        assert "1 passed" in out, out
    else:
        assert LIMIT_S <= elapsed < LIMIT_S + 15, elapsed
        assert "passed" not in out, out
