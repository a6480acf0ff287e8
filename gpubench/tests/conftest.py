"""CPU tests of the benchmark (``python -m pytest gpubench/tests``).  Tests
that need a card carry the ``cuda`` marker and skip without one."""

import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card")


def full_bench() -> dict:
    """``BENCHMARK.json`` with the entries of ``gpubench/later/*.json``
    added: cells whose harness is kept and tested here, out of the
    benchmark until their rate holds a bound (PERF.md)."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    for path in sorted((ROOT / "gpubench" / "later").glob("*.json")):
        with open(path) as f:
            for key, entries in json.load(f).items():
                bench[key] += entries
    return bench


@pytest.fixture
def bench():
    return full_bench()


@pytest.fixture
def committed():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture
def small(monkeypatch):
    """Run cells at a size a CPU test holds: ``gpubench.run.cell`` with the
    pool, depth, reference and calls cut down; ``small.extra`` adds keys."""
    import gpubench.run as run

    orig = run.cell

    class Small:
        extra: dict = {}

    def cell(bench, workload):
        w, config, mix = orig(bench, workload)
        if config["driver"] == "gatk_hc":
            mix.update(pool=3, depth=2, check_regions=2, warm_regions=2)
        else:
            config.update(ref_bp=200_000, chunk=512,
                          check_reads={"uniform": 64, "tier": 32})
            mix.update(pool=2048, call=1024)
        mix.update(Small.extra)
        return w, config, mix

    monkeypatch.setattr(run, "cell", cell)
    return Small
