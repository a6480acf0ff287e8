"""The plain reference agrees with the port's ``device="cpu"`` path (and
with the port's scalar oracles) on a toy region and a toy chunk."""

import numpy as np
import pytest
import torch

from gpubench.reference import mapper as ref_mapper
from gpubench.reference import pairhmm as ref_pairhmm
from gpubench.reference import sw as ref_sw
from gpubench.run import cell
from gpubench.traffic import gen_reads, gen_regions


def test_quality_tables_match_the_program():
    from mgl_tpu_torch.core.context import CTX_F32, CTX_F64

    assert np.allclose(ref_pairhmm._PH2PR, CTX_F64.ph2pr, rtol=1e-12)
    assert np.allclose(ref_pairhmm._M2M, CTX_F64.match_to_match, atol=1e-7)
    assert ref_pairhmm.scale(torch.float32)[1] == float(
        CTX_F32.log10_initial_constant)
    assert ref_pairhmm.scale(torch.float64)[1] == float(
        CTX_F64.log10_initial_constant)


@pytest.fixture(scope="module")
def region():
    from gpubench.tests.conftest import full_bench

    _, config, mix = cell(full_bench(), "hc.wgs30x")
    mix.update(pool=2, depth=3)
    r = gen_regions.make(mix, config, 99)[1]
    # a read of random bases at Q37, whose f32 likelihood falls under the
    # floor, so that the reference's f64 rescue is held to the port too
    L = config["read_len"]
    rng = np.random.default_rng(7)
    q = np.full(L, 37, np.uint8)
    r["reads"].append({"bases": gen_regions.ACGT[rng.integers(0, 4, L)],
                       "q": q, "i": r["reads"][0]["i"],
                       "d": r["reads"][0]["d"], "c": r["reads"][0]["c"]})
    return config, r


def test_likelihoods_match_the_port(region):
    from mgl_tpu_torch.api import PairHmmEngine

    _, r = region
    got = PairHmmEngine(device="cpu").compute_likelihoods(r["reads"],
                                                          r["haps"])
    pairs = np.array([(a, b) for a in range(len(r["reads"]))
                      for b in range(len(r["haps"]))])
    exp, rescued = ref_pairhmm.cascade(r["reads"], r["haps"], pairs, "cpu")
    assert rescued.any() and (~rescued).any()
    assert np.max(np.abs(got.reshape(-1) - exp)) < 1e-5


@pytest.mark.parametrize("which", ["hap_to_ref_sw", "read_to_hap_sw"])
def test_sw_matches_the_port(region, which):
    from mgl_tpu_torch.api import (OverhangStrategy, SmithWatermanAligner,
                                   SWParameters)

    config, r = region
    p = config[which]
    if which == "hap_to_ref_sw":
        t, q = [r["ref"]] * len(r["haps"]), r["haps"]
    else:
        t = [r["haps"][k % len(r["haps"])] for k in range(len(r["reads"]))]
        q = [rd["bases"] for rd in r["reads"]]
    got = SmithWatermanAligner(device="cpu").align_batch(
        t, q, SWParameters(p["match"], p["mismatch"], p["gap_open"],
                           p["gap_extend"]), OverhangStrategy[p["strategy"]])
    exp, _ = ref_sw.align(t, q, (p["match"], p["mismatch"], p["gap_open"],
                                 p["gap_extend"]), p["strategy"], "cpu")
    assert [(g.cigar, g.offset) for g in got] == exp


def test_sw_matches_the_scalar_oracle():
    from mgl_tpu_torch.core.params import NEW_SW_PARAMETERS, OverhangStrategy
    from mgl_tpu_torch.ref_impl import sw_scalar

    rng = np.random.default_rng(4)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    t = [acgt[rng.integers(0, 4, rng.integers(5, 60))] for _ in range(40)]
    q = [np.concatenate([s[3:20], acgt[rng.integers(0, 4, 3)], s[22:40]])
         if len(s) > 40 else acgt[rng.integers(0, 4, 17)] for s in t]
    p = NEW_SW_PARAMETERS
    for strat in (OverhangStrategy.SOFTCLIP, OverhangStrategy.INDEL):
        exp = [sw_scalar.align(a, b, p, strat) for a, b in zip(t, q)]
        got, _ = ref_sw.align(t, q, (p.match, p.mismatch, p.gap_open,
                                     p.gap_extend), strat.name, "cpu",
                              block=7)
        assert got == [tuple(e) for e in exp]


def test_mapper_matches_the_port():
    from mgl_tpu_torch.api import OverhangStrategy, SWParameters
    from mgl_tpu_torch.pipelines.mapper import (ReferenceIndex,
                                                map_reads_stream)

    from gpubench.run import ROOT, load_json

    bench = load_json(ROOT / "BENCHMARK.json")
    _, config, _ = cell(bench, "map.illumina")
    mix = load_json(ROOT / "gpubench" / "traffic" / "hierr.json")
    config["ref_bp"] = 120_000
    mix["pool"] = 1500
    data = gen_reads.make(mix, config, 17)
    p = config["sw"]
    params = (p["match"], p["mismatch"], p["gap_open"], p["gap_extend"])
    got = map_reads_stream(ReferenceIndex.build(data["ref"], k=16),
                           data["reads"], chunk=512, with_cigar=True,
                           params=SWParameters(*params),
                           strategy=OverhangStrategy.SOFTCLIP, device="cpu")
    exp = ref_mapper.map_reads(ref_mapper.KmerIndex(data["ref"], 16, "cpu"),
                               data["reads"], 24, 64, params)
    m = exp["pos"] >= 0
    assert m.mean() > 0.9
    assert np.array_equal(got["pos"], exp["pos"])
    assert np.array_equal(got["strand"][m], exp["strand"][m])
    assert np.array_equal(got["score"][m], exp["score"][m])
    assert np.array_equal(got["offset"][m], exp["offset"][m])
    assert list(got["cigar"][m]) == list(exp["cigar"][m])
    assert (exp["cigar"][m] != "150M").sum() > 50
