"""``BENCHMARK.json`` keeps to its contract's names, units and shapes, every
cell's files are found by name, and a new mix and a new per-layer reader
are added as files and entries alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from gpubench.tests.conftest import ROOT, full_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("which", ["committed", "bench"])
def test_names_and_units(which, request):
    bench = request.getfixturevalue(which)
    names = []
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert NAME.match(w["config"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        names.append(w["name"])
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("which", ["committed", "bench"])
def test_shape_of_the_file(which, request):
    bench = request.getfixturevalue(which)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    cells = len(bench["workloads"])
    assert 2 + 14 * cells <= 2 + 14 * 24
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("which", ["committed", "bench"])
def test_cells_find_their_files(which, request):
    bench = request.getfixturevalue(which)
    for w in bench["workloads"]:
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        assert conf["file"].startswith("gpubench/")
        config = json.loads((ROOT / conf["file"]).read_text())
        assert (ROOT / "gpubench" / "drivers" / f"{config['driver']}.py").exists()
        mix = json.loads((ROOT / "gpubench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "gpubench" / "traffic" / f"{mix['generator']}.py").exists()
    for m in bench["per_layer"]:
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").exists()
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


NEW_READER = '''"""Regions of the window (a test reader)."""


def read(ctx):
    return float(ctx["work"]["regions"])
'''


def test_a_new_mix_and_reader_are_files_and_entries(tmp_path):
    """A copy of the benchmark gains a mix and a reader by new files and
    new entries in BENCHMARK.json only, and runs the new cell (traced, on
    the CPU) with the new metric in its line."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = full_bench()
    mix = json.loads((ROOT / "gpubench/traffic/wgs30x.json").read_text())
    mix.update(pool=2, depth=2, check_regions=1, warm_regions=1,
               haps=[[2, 3, 1.0]])
    (tmp_path / "gpubench/traffic/tiny10x.json").write_text(json.dumps(mix))
    (tmp_path / "gpubench/metrics/hc.regions_seen.py").write_text(NEW_READER)
    bench["workloads"].append({"name": "hc.tiny10x", "config": "gatk_hc",
                               "traffic": "tiny10x", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "hc_regions_per_s":
            m["workloads"].append("hc.tiny10x")
    bench["per_layer"].append({"name": "hc.regions_seen", "unit": "regions",
                               "better": "higher", "source": "host_clock",
                               "layer": "api", "moves": "hc_regions_per_s",
                               "workloads": ["hc.tiny10x"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; import gpubench.run as r; "
            "res = r.measure(r.load_json(r.ROOT / 'BENCHMARK.json'), "
            "'hc.tiny10x', 5, 0.5, True, device='cpu'); "
            "print(json.dumps(res))")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["hc.regions_seen"]["value"] >= 1
