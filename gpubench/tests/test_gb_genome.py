"""The whole-genome cell ``map.grch38`` on the CPU, at a size a test holds:
its generator, its reference index against ``KmerIndex``, a sound run, the
control and planted faults, and its two per-layer readers."""

import numpy as np
import pytest
import torch

import gpubench.run as run
from gpubench.reference import mapper as ref_mapper
from gpubench.reference.genome_index import GenomeIndex
from gpubench.traffic import gen_genome_reads

CELL = "map.grch38"
SEED = 2_147_483_777


@pytest.fixture
def small(monkeypatch):
    """``gpubench.run.cell`` with the chromosomes cut to a ten-thousandth
    of their lengths (308 kbp in all) and the pool, calls and samples cut
    down."""
    orig = run.cell

    def cell(bench, workload):
        w, config, mix = orig(bench, workload)
        config["contigs"] = [[n, m // 10_000] for n, m in config["contigs"]]
        config.update(chunk=512, check_reads={"uniform": 64, "tier": 32})
        mix.update(pool=2048, call=1024)
        return w, config, mix

    monkeypatch.setattr(run, "cell", cell)


def _drawn(bench, pool=4000, seed=SEED):
    _, config, mix = run.cell(bench, CELL)
    config["contigs"] = [[n, m // 10_000] for n, m in config["contigs"]]
    mix["pool"] = pool
    return config, mix, gen_genome_reads.make(mix, config, seed)


def test_genome_reads_as_drawn(bench):
    """The genome is joined as build_multi joins it; no read crosses its
    contig's end; a reverse read is the reverse complement of its forward
    draw; substitutions and deletions are as counted."""
    config, mix, d = _drawn(bench)
    L, g, off = config["read_len"], d["genome"], d["offsets"]
    lens = np.array([m for _, m in config["contigs"]])
    assert len(g) == (lens + 48).sum() and np.array_equal(
        off, np.concatenate([[0], np.cumsum(lens + 48)[:-1]]))
    assert all((g[o + m:o + m + 48] == ord("N")).all() and
               np.array_equal(c, g[o:o + m]) and name == config["contigs"][i][0]
               for i, ((name, c), o, m) in enumerate(zip(d["contigs"], off,
                                                          lens)))
    cid = np.searchsorted(off, d["true_pos"], "right") - 1
    assert (d["true_pos"] + L + mix["del_bp"][1] <= off[cid] + lens[cid]).all()
    assert 0.45 < d["reverse"].mean() < 0.55
    assert d["deletion"].sum() == int(mix["pool"] * mix["del_share"])
    assert 0.6 < np.bincount(cid, minlength=24)[:2].sum() / (
        mix["pool"] * lens[:2].sum() / lens.sum()) < 1.4
    fwd = np.where(d["reverse"][:, None], ref_mapper.revcomp(d["reads"]),
                   d["reads"])
    at = g[d["true_pos"][:, None] + np.arange(L)[None, :]]
    dele = d["deletion"]
    assert np.array_equal((fwd != at).sum(1)[~dele], d["n_sub"][~dele])
    assert (d["n_sub"][dele] == 0).all()
    cut = mix["del_after"]
    for r in np.nonzero(dele)[0][:50]:
        p = d["true_pos"][r]
        assert np.array_equal(fwd[r, :cut], g[p:p + cut])
        assert any(np.array_equal(fwd[r, cut:], g[p + cut + k:p + L + k])
                   for k in mix["del_bp"])
    e = gen_genome_reads.make(mix, config, SEED)
    assert np.array_equal(e["genome"], g) and np.array_equal(e["reads"],
                                                             d["reads"])
    f = gen_genome_reads.make(mix, config, SEED + 1)
    assert not np.array_equal(f["genome"], g)


def test_genome_index_maps_as_kmer_index(bench):
    """On a small multi-contig genome, the index of the sampled reads' seeds
    alone gives the plain mapper the answers the whole KmerIndex gives,
    with a seed over max_hits among them."""
    config, _, d = _drawn(bench, pool=300)
    g = d["genome"].copy()
    g[5000:5400] = np.tile(g[1000:1016], 25)
    reads = d["reads"].copy()
    reads[:4] = g[5100:5250]
    dev = torch.device("cpu")
    whole = ref_mapper.KmerIndex(g, config["k"], dev)
    part = GenomeIndex(g, config["k"], reads, dev, block=50_000)
    assert len(part.values) < len(whole.values) // 20
    q = torch.from_numpy(np.unique(part.values.numpy()))
    assert torch.equal(torch.searchsorted(part.values, q, right=True)
                       - torch.searchsorted(part.values, q),
                       torch.searchsorted(whole.values, q, right=True)
                       - torch.searchsorted(whole.values, q))
    args = (config["window_pad"], 8, (25, -50, 110, 6))
    a = ref_mapper.map_reads(whole, reads, *args)
    b = ref_mapper.map_reads(part, reads, *args)
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    assert (a["pos"] >= 0).mean() > 0.9 and (a["strand"] == 1).any()


def _measure(bench, control=False, trace=False):
    return run.measure(bench, CELL, SEED, 0.5, trace, device="cpu",
                       control=control)


def test_sound_run_is_correct(bench, small):
    res = _measure(bench)
    assert res["correct"] is True, res["checked"]
    assert set(res["checked"]) == {"map_pos_mismatches",
                                   "map_score_mismatches",
                                   "map_cigar_mismatches",
                                   "map_locus_mismatches"}
    assert set(res["metrics"]) == {"map_reads_per_s", "setup_s"}


def test_traced_run_reads_the_seed_metrics(bench, small):
    res = _measure(bench, trace=True)
    assert res["correct"] is True, res["checked"]
    m = res["metrics"]
    assert m["map.seed_ms"]["value"] > 0
    assert m["map.seed_ns_per_hit"]["value"] > 0


def test_control_is_not_correct(bench, small):
    res = _measure(bench, control=True)
    assert res["correct"] is False
    assert res["checked"]["map_score_mismatches"]["value"] > 0


def _mapper(monkeypatch, change):
    from gpubench.drivers import chr20_map

    inner = chr20_map.map_reads_stream

    def stream(index, *args, **kwargs):
        out = inner(index, *args, **kwargs)
        return change(index, out, out["pos"] >= 0)

    monkeypatch.setattr(chr20_map, "map_reads_stream", stream)


def _wrong_contig(index, out, m):
    cid, local = index.locate(out["pos"])
    other = (cid + 1) % len(index.contig_offsets)
    fits = m & (local < index.contig_lengths[other] - 200)
    out["pos"] = np.where(fits, index.contig_offsets[other] + local,
                          out["pos"])
    return out


def _start_plus_one(index, out, m):
    out["pos"] = np.where(m, out["pos"] + 1, out["pos"])
    return out


def _strand_flipped(index, out, m):
    out["strand"] = np.where(m, 1 - out["strand"], out["strand"]).astype(
        out["strand"].dtype)
    return out


@pytest.mark.parametrize("change,moved", [
    (_wrong_contig, ("map_pos_mismatches", "map_locus_mismatches")),
    (_start_plus_one, ("map_pos_mismatches", "map_locus_mismatches")),
    (_strand_flipped, ("map_pos_mismatches",))])
def test_planted_fault_is_not_correct(bench, small, monkeypatch, change,
                                      moved):
    _mapper(monkeypatch, change)
    res = _measure(bench)
    assert res["correct"] is False
    for name in moved:
        assert res["checked"][name]["value"] > 0, name


def test_wrong_locate_is_not_correct(bench, small, monkeypatch):
    """Starts right but ``locate`` a contig off: only the locus check
    sees it."""
    from mgl_tpu_torch.pipelines.mapper import ReferenceIndex

    inner = ReferenceIndex.locate

    def locate(self, pos):
        cid, local = inner(self, pos)
        return np.where(cid >= 0, cid + 1, cid), local

    monkeypatch.setattr(ReferenceIndex, "locate", locate)
    res = _measure(bench)
    assert res["correct"] is False
    c = res["checked"]
    assert c["map_locus_mismatches"]["value"] > 0
    assert c["map_pos_mismatches"]["value"] == 0


def _ctx(timers, counters, chunks):
    return {"metrics": {"timers_s": timers, "counters": counters,
                        "calls": {}}, "work": {"chunks": chunks}}


@pytest.mark.parametrize("name,value", [("map.seed_ms", 250.0),
                                        ("map.seed_ns_per_hit", 50.0)])
def test_seed_readers(name, value):
    read = run.reader(name)
    assert read(_ctx({"map.seed": 1.0}, {"map.seed_hits": 2e7}, 4)) == \
        pytest.approx(value, rel=1e-12)
    assert read(_ctx({}, {}, 4)) is None
    assert read(_ctx({"map.seed": 1.0}, {}, 0)) is None
