"""Each traffic generator repeats exactly from its seed, and another seed
replays the same shapes with other bases."""

import numpy as np

from gpubench.run import ROOT, cell, load_json
from gpubench.traffic import gen_reads, gen_regions


def _hc(bench):
    _, config, mix = cell(bench, "hc.wgs30x")
    mix.update(pool=6)
    return config, mix


def test_regions_repeat_from_seed(bench):
    config, mix = _hc(bench)
    a = gen_regions.make(mix, config, 2**31 + 7)
    b = gen_regions.make(mix, config, 2**31 + 7)
    for ra, rb in zip(a, b):
        assert np.array_equal(ra["ref"], rb["ref"])
        assert all(np.array_equal(x, y) for x, y in zip(ra["haps"], rb["haps"]))
        for x, y in zip(ra["reads"], rb["reads"]):
            assert all(np.array_equal(x[k], y[k]) for k in x)


def test_regions_other_seed_same_shapes(bench):
    config, mix = _hc(bench)
    a = gen_regions.make(mix, config, 1)
    b = gen_regions.make(mix, config, 2)
    shape = lambda r: (len(r["ref"]), len(r["haps"]), len(r["reads"]))
    assert sorted(map(shape, a)) == sorted(map(shape, b))
    assert not all(np.array_equal(x["ref"], y["ref"]) for x, y in zip(
        sorted(a, key=shape), sorted(b, key=shape)))


def test_regions_follow_the_mix(bench):
    config, mix = _hc(bench)
    for r in gen_regions.make(mix, config, 5):
        pad = mix["padding_bp"]
        assert mix["active_bp"][0] <= len(r["ref"]) - 2 * pad <= mix["active_bp"][1]
        assert 2 <= len(r["haps"]) <= 16
        keys = [h.tobytes() for h in r["haps"]]
        assert keys == sorted(keys) and len(set(keys)) == len(keys)
        assert r["ref"].tobytes() in keys
        assert all(len(rd["bases"]) == config["read_len"] for rd in r["reads"])


def test_reads_repeat_from_seed(bench):
    _, config, _ = cell(bench, "map.illumina")
    mix = load_json(ROOT / "gpubench" / "traffic" / "hierr.json")
    config["ref_bp"] = 50_000
    mix["pool"] = 1000
    a = gen_reads.make(mix, config, 3_000_000_000)
    b = gen_reads.make(mix, config, 3_000_000_000)
    c = gen_reads.make(mix, config, 3_000_000_001)
    assert np.array_equal(a["ref"], b["ref"])
    assert np.array_equal(a["reads"], b["reads"])
    assert not np.array_equal(a["reads"], c["reads"])
    assert a["deletion"].sum() == c["deletion"].sum() == 100
