"""The port's scale runs (``python -m mgl_tpu_torch.scale_configs``) at
toy sizes on the CPU, against the JAX package's scale script
``tools/run_scale_configs.py`` (loaded by path; it imports only numpy at
its top):

- ``testing.simulate``, the scale runs' reads, bit-equal to the JAX
  script's;
- ``config4`` and ``config4_cigar`` (hierr's error model) equal to the JAX
  script's under the Pallas interpreter, with the JAX mapper's launches
  padded to one lane tile as in ``tests/test_torch_mapper.py``;
- ``config5``'s two sorts and ``config5_mesh`` on two gloo ranks;
- each entry's keys a superset of the JAX record's
  (``tests/golden/scale_report.json``, left unchanged);
- ``main`` merging into an existing report, naming ``--big``'s entry, and
  refusing a device it would not use.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from mgl_tpu_torch import scale_configs as S
from mgl_tpu_torch.testing import simulate

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECORD = ROOT / "tests" / "golden" / "scale_report.json"
BIG_ENTRIES = ("config4_512mbp", "config4_3gbp")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_scale():
    spec = importlib.util.spec_from_file_location(
        "run_scale_configs", ROOT / "tools" / "run_scale_configs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def record():
    return json.loads(RECORD.read_text())


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX package's device path on the CPU: Pallas under the
    interpreter, launches padded to one lane tile."""
    import mgl_tpu.batch.bucketing as bucketing

    monkeypatch.setenv("MGL_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(bucketing, "bucket_dims", lambda n, grid=None: n)


@pytest.mark.parametrize("seed", [0, 8])
@pytest.mark.parametrize("err", [0.01, 0.05])
def test_simulate_equals_jax_scale(jax_scale, seed, err):
    got = simulate(np.random.default_rng(seed), 20_000, 64, 150, err)
    want = jax_scale.simulate(np.random.default_rng(seed), 20_000, 64, 150,
                              err)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_config4_equals_jax_scale(jax_scale, jax_interpret, record):
    """64 reads of a 20 kbp reference in chunks of 32, one pass: the
    positions, scores, mapped fraction and window accuracy equal the JAX
    script's; the entry has the record's keys of config 4 and of
    ``--big``'s entries."""
    got, pos, score = S.config4(64, 20_000, chunk=32, passes=1,
                                device="cpu")
    want, jpos, jscore = jax_scale.config4(64, 20_000, chunk=32, passes=1)
    assert np.array_equal(pos, jpos) and np.array_equal(score, jscore)
    for k in ("mapped_frac", "window_accuracy", "n_reads", "ref_mbp"):
        assert got[k] == want[k], k
    assert got["window_accuracy"] == 1.0
    assert set(want) <= set(got)
    for name in ("config4_seed_extend_1m", *BIG_ENTRIES):
        assert set(record[name]) <= set(got), name
    assert got["backend"] == "cpu"


def test_config4_cigar_equals_jax_scale(jax_scale, jax_interpret, record):
    """hierr's error model (5% substitutions, deletions of 1-8 bp) on 64
    reads, 8 of them deletion reads: the tier counts equal the JAX
    script's."""
    kw = dict(n_reads=64, ref_len=20_000, chunk=32, err=0.05,
              indel_frac=0.125, max_indel=8, seed=8)
    got = S.config4_cigar(**kw, device="cpu")
    want = jax_scale.config4_cigar(**kw)
    for k in ("indel_reads", "indel_cigars_with_gap", "traceback_tier_reads",
              "traceback_tier_share", "mapped_frac", "cigar_complete"):
        assert got[k] == want[k], k
    assert got["indel_reads"] == 8 and got["traceback_tier_reads"] >= 8
    assert set(want) <= set(got)
    assert set(record["config4_cigar_hierr"]) <= set(got)


def test_config5_sorts_equal_numpy(record):
    """Both sorts at 10,000 keys pass their checks against np.sort and the
    payload permutation (config5 raises otherwise); the device sort is
    timed call by call, its median inside its spread."""
    pos = np.random.default_rng(9).integers(-1, 1 << 26, 4_096)
    got = S.config5(pos, n_sort=10_000, device="cpu")
    assert got["e2e_reads"] == 4_096 and got["sort_keys"] == 10_000
    assert got["sort_10m_mkeys_per_s"] > 0
    lo, hi = got["sort_10m_min_max_s"]
    assert got["sort_10m_repeats"] == S.SORT_REPEATS
    assert lo <= got["sort_10m_device_s"] <= hi
    assert got["sort_10m_clock"] == "host" and got["backend"] == "cpu"
    assert set(record["config5_align_sort"]) <= set(got)


def test_config5_mesh_on_two_gloo_ranks(record):
    """sort_records of 4,096 keys on two gloo ranks equals np.sort, and the
    entry carries the JAX record's keys."""
    got = S.config5_mesh(4_096, ranks=2, timeout=120.0)
    assert got["mesh_sort_verified"] and got["mesh_sort_10m_devices"] == 2
    assert got["backend"] == "cpu"
    assert set(record["config5_mesh_sort"]) <= set(got)


def test_main_merges_report(tmp_path, record):
    """main on the CPU at toy sizes (config 5 on synthetic positions, then
    the base CIGAR config) merges into an existing report, each entry's
    keys a superset of the same entry's in the JAX record, which stays
    byte for byte as it was."""
    before = RECORD.read_bytes()
    out = tmp_path / "scale_report.json"
    out.write_text(json.dumps({"earlier": {"kept": True}}))
    toy = ["--device", "cpu", "--out", str(out)]
    assert S.main(toy + ["--sort-only", "--reads", "256",
                         "--sort-keys", "1000"]) == 0
    assert S.main(toy + ["--cigar", "--cigar-mode", "base", "--reads", "64",
                         "--ref-mbp", "0.02"]) == 0
    rep = json.loads(out.read_text())
    assert rep["earlier"] == {"kept": True}
    assert rep["backend"] == "cpu" and rep["card"] is None
    for name in ("config5_align_sort", "config4_cigar"):
        assert set(record[name]) <= set(rep[name]), name
        assert rep[name]["backend"] == "cpu"
    assert rep["config4_cigar"]["n_reads"] == 16
    assert rep["config5_align_sort"]["e2e_reads"] == 256
    assert RECORD.read_bytes() == before


@pytest.mark.parametrize("mbp, name", [(512, "config4_512mbp"),
                                       (2999.9, "config4_2999mbp"),
                                       (3000, "config4_3gbp"),
                                       (3100, "config4_3gbp")])
def test_big_entry_name(mbp, name):
    """``--big``'s entry is the JAX script's name for its size."""
    assert S.big_entry_name(mbp) == name


def test_main_refuses_cuda_for_mesh_and_a_missing_card(tmp_path,
                                                      monkeypatch):
    """``--mesh-only`` runs on gloo CPU ranks and refuses ``--device
    cuda``; the default device without a card raises; neither writes a
    report."""
    out = tmp_path / "scale_report.json"
    with pytest.raises(SystemExit) as exc:
        S.main(["--mesh-only", "--device", "cuda", "--out", str(out)])
    assert exc.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        S.main(["--sort-only", "--reads", "16", "--out", str(out)])
    assert not out.exists()
