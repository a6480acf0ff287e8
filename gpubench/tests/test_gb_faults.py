"""``correct`` comes out false for the reference's lower-precision control
in the program's place, and for a run whose timed path is broken
underneath, once a fault the cells can have: an answer altered where it
is produced, half of a batch left out (its answers taken from the other
half), and a call that hands back its previous state.  The exchange
between chips has no place here: every cell runs on one card.  Each test
skips the harness's look for a card and drives the rest of a run on the
CPU, at a small size."""

import numpy as np
import pytest

import gpubench.run as run

HC, MAP = "hc.wgs30x", "map.illumina"


def _measure(bench, cell, control=False):
    return run.measure(bench, cell, 2_147_483_777, 0.5, False, device="cpu",
                       control=control)


@pytest.mark.parametrize("cell", [HC, MAP])
def test_sound_run_is_correct(bench, small, cell):
    res = _measure(bench, cell)
    assert res["correct"] is True, res["checked"]


@pytest.mark.parametrize("cell", [HC, MAP])
def test_control_is_not_correct(bench, small, cell):
    res = _measure(bench, cell, control=True)
    assert res["correct"] is False, res["checked"]


def _stream(monkeypatch, change):
    from mgl_tpu_torch.api import PairHmmEngine

    inner = PairHmmEngine.compute_likelihoods_stream

    def stream(self, batches, depth=2):
        for mat in inner(self, batches, depth):
            yield change(np.array(mat))

    monkeypatch.setattr(PairHmmEngine, "compute_likelihoods_stream", stream)


def test_hc_likelihood_altered(bench, small, monkeypatch):
    def change(m):
        m[1, 0] += 1e-2
        return m
    _stream(monkeypatch, change)
    res = _measure(bench, HC)
    assert res["correct"] is False
    assert res["checked"]["lk_gap"]["value"] > 5e-3


def test_hc_half_the_reads_left_out(bench, small, monkeypatch):
    def change(m):
        half = len(m) // 2
        m[half:] = m[:half].mean(axis=0)
        return m
    _stream(monkeypatch, change)
    assert _measure(bench, HC)["correct"] is False


def test_hc_cigar_altered(bench, small, monkeypatch):
    from mgl_tpu_torch.api import SmithWatermanAligner, SWResult

    inner = SmithWatermanAligner.align_batch

    def align_batch(self, refs, alts, params, strategy):
        out = inner(self, refs, alts, params, strategy)
        return [SWResult(out[0].cigar, out[0].offset + 1)] + out[1:]

    monkeypatch.setattr(SmithWatermanAligner, "align_batch", align_batch)
    res = _measure(bench, HC)
    assert res["correct"] is False
    assert res["checked"]["sw_hap_mismatches"]["value"] > 0


def _mapper(monkeypatch, change):
    from gpubench.drivers import chr20_map

    inner = chr20_map.map_reads_stream
    seen = []

    def stream(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(out)
        return change(out, seen)

    monkeypatch.setattr(chr20_map, "map_reads_stream", stream)


def test_map_score_altered(bench, small, monkeypatch):
    def change(out, seen):
        out["score"] = np.where(out["pos"] >= 0, out["score"] + 1,
                                out["score"])
        return out
    _mapper(monkeypatch, change)
    res = _measure(bench, MAP)
    assert res["correct"] is False
    assert res["checked"]["map_score_mismatches"]["value"] > 0


def test_map_half_the_reads_left_out(bench, small, monkeypatch):
    def change(out, seen):
        n = len(out["pos"]) // 2
        for k in ("pos", "strand", "score", "cigar", "offset"):
            out[k][n:2 * n] = out[k][:n]
        return out
    _mapper(monkeypatch, change)
    assert _measure(bench, MAP)["correct"] is False


def test_map_state_unchanged(bench, small, monkeypatch):
    _mapper(monkeypatch, lambda out, seen: seen[-2] if len(seen) > 1
            else out)
    assert _measure(bench, MAP)["correct"] is False
