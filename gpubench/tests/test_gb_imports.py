"""Nothing of JAX or the JAX package reaches a run: the check compares whole
top-level module names, and the reference imports nothing of the
program."""

import ast
import os
import subprocess
import sys

from gpubench.run import forbidden_modules
from gpubench.tests.conftest import ROOT


def test_whole_top_level_names():
    assert forbidden_modules(["mgl_tpu_torch", "mgl_tpu_torch.api",
                              "jax_utils", "flaxen", "numpy"]) == []
    assert forbidden_modules(["mgl_tpu", "mgl_tpu.api", "jax.numpy", "jaxlib",
                              "flax.linen", "mgl_tpu_torch"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "mgl_tpu", "mgl_tpu.api"]


def test_a_run_loads_none_of_them():
    code = ("import sys, gpubench.run as r, gpubench.drivers.gatk_hc, "
            "gpubench.drivers.chr20_map, gpubench.trace; "
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "gpubench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in ("numpy", "torch", "__future__",
                                           "gpubench", "math"), (path, n)
                if n.startswith("gpubench"):
                    assert n.startswith("gpubench.reference"), (path, n)
