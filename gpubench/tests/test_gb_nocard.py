"""The measurement path fails, and does not fall back to the CPU, where no
card is present; it also fails in a checkout that holds the benchmark
alone."""

import os
import shutil
import subprocess
import sys

import pytest

from gpubench.tests.conftest import ROOT

ARGS = ["-m", "gpubench.run", "--workload", "map.illumina", "--seed",
        "2147483999", "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, *ARGS], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, *ARGS], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, *ARGS], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"correct": true' in out.stdout.strip().splitlines()[-1]
