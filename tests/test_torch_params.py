"""GATK's three SW parameter sets in the port's ``core/params.py``, field
for field against the JAX package's, and no restated copy of
``STANDARD_NGS`` left in the port's modules."""

import dataclasses
import pathlib
import re

import pytest

import mgl_tpu.core.params as J
import mgl_tpu_torch.core.params as P

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["STANDARD_NGS", "NEW_SW_PARAMETERS",
                                  "ORIGINAL_DEFAULT"])
def test_parameter_set_equals_jax(name):
    got, want = getattr(P, name), getattr(J, name)
    assert isinstance(got, P.SWParameters)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_port_restates_no_parameter_set():
    """The port names STANDARD_NGS where it means it: no module writes
    SWParameters(25, -50, 110, 6) out by hand."""
    literal = re.compile(r"SWParameters\(\s*25,\s*-50,\s*110,\s*6\s*\)")
    files = sorted((ROOT / "mgl_tpu_torch").rglob("*.py"))
    bad = [str(f.relative_to(ROOT)) for f in files
           if literal.search(f.read_text())
           and f != ROOT / "mgl_tpu_torch/core/params.py"]
    assert not bad, bad
