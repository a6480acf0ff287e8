"""Each per-layer reader gives the right value on a canned trace, spans and
``METRICS`` snapshot, and nothing where there is nothing to read."""

import pytest

from gpubench.counts import peaks
from gpubench.run import reader
from gpubench.spans import Span, Spans


def _spans():
    s = Spans()
    s.spans = [Span("engine.next", 0.0, 0.010, -1),
               Span("sw.hap_ref", 0.002, 0.005, 0),
               Span("engine.next", 0.020, 0.024, -1),
               Span("sw_cuda.decode_cigars", 0.030, 0.031, -1),
               Span("sw_cuda.decode_cigars", 0.040, 0.043, -1)]
    for k in range(100):
        s.spans.append(Span("region", 1.0, 1.0 + (k + 1) * 1e-3, -1))
    return s


def _ctx():
    ops = {"void pairhmm_shared_kernel<true>(float const*)": (0.004, 2),
           "void pairhmm_banded_kernel<float, false>(float const*)": (0.001, 1),
           "void pairhmm_banded_kernel<double, true>(double const*)": (0.5, 1),
           "void sw_wavefront_kernel<1, true>(unsigned char const*)": (0.002, 3),
           "Memcpy HtoD (Pageable -> Device)": (0.25, 9)}
    return {"cell": "x", "spans": _spans(),
            "metrics": {"timers_s": {"sw.align_batch": 0.5,
                                     "map.host_tier": 0.3,
                                     "map.traceback": 0.06},
                        "counters": {}, "calls": {}},
            "trace": {"busy_s": 1.0, "window_s": 4.0, "ops": ops,
                      "idle_by_range": {}},
            "work": {"regions": 2, "chunks": 4, "f32_flops": 67e9,
                     "f32_bytes": 1e6, "sw_ops": 1e9,
                     "sw_bytes": 1e3},
            "window": {}}


CASES = {
    "hc.region_p95_ms": 95.05,
    "hc.sw_ms_per_region": 250.0,
    "hc.engine_ms_per_region": (0.010 + 0.004 - 0.003) * 1e3 / 2,
    "hc.decode_ms_per_region": 2.0,
    "map.host_tier_ms": 75.0,
    "map.traceback_ms": 15.0,
    "pairhmm_f32_roofline.hc": 100.0 * 1e-3 / 0.005,
    "sw_banded_roofline.map": 100.0 * 1e9 / peaks.INT32_OPS / 0.002,
    "device.idle_share.hc": 75.0,
    "device.idle_share.map": 75.0,
    "mfu.hc": 100.0 * (1e-3 + 1e9 / peaks.INT32_OPS) / 4.0,
    "mfu.map": 100.0 * 1e9 / peaks.INT32_OPS / 4.0,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_value(name):
    assert reader(name)(_ctx()) == pytest.approx(CASES[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_finds_nothing(name):
    empty = {"cell": "x", "spans": Spans(),
             "metrics": {"timers_s": {}, "counters": {}, "calls": {}},
             "trace": {"busy_s": 0.0, "window_s": 4.0, "ops": {},
                       "idle_by_range": {}},
             "work": {}, "window": {}}
    assert reader(name)(empty) is None


def test_every_per_layer_metric_has_a_reader(bench):
    assert sorted(m["name"] for m in bench["per_layer"]) == sorted(CASES)


def test_trace_reduction_on_canned_events():
    from gpubench import trace

    class Ev:
        def __init__(self, name, dev, s, d, ann=False):
            self._n, self._dev, self._s, self._d, self._a = name, dev, s, d, ann

        def name(self): return self._n
        def device_type(self): return self._dev
        def start_ns(self): return self._s
        def duration_ns(self): return self._d
        def is_user_annotation(self): return self._a

    import torch
    C, G = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    evs = [Ev("gb:window", C, 0, 1000), Ev("gb:map.call", C, 150, 800),
           Ev("gb:decode", C, 700, 150), Ev("kernA", G, 200, 100),
           Ev("kernA", G, 250, 100), Ev("Memcpy", G, 500, 50),
           Ev("gb:map.call", G, 100, 800, ann=True)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return evs

    red = trace.reduce(Prof)
    assert red["window_s"] == pytest.approx(1e-6)
    assert red["busy_s"] == pytest.approx(200e-9)
    assert red["ops"]["kernA"] == (pytest.approx(200e-9), 2)
    assert red["idle_by_range"] == pytest.approx(
        {"none": 200e-9, "map.call": 450e-9, "decode": 150e-9})
    bd = trace.breakdown(red)
    assert bd["device_ops"][0][0] == "kernA"
    assert len(bd["idle_gaps"]) == 3


def test_hostload_counts_cpu_seconds_a_second():
    """The sampler's CPU seconds a second follow a busy loop and stop with
    the window."""
    import time

    from gpubench.hostload import HostLoad

    with HostLoad(every=0.1) as load:
        t = time.perf_counter()
        while time.perf_counter() - t < 0.35:
            pass
    out = load.per_second()
    assert len(out["cpu_s"]) == len(load.samples) - 1 >= 3
    assert 0.5 < out["cpu_over_wall"] <= 1.5
    assert not load._thread.is_alive()
