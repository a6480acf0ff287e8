"""One run of one cell of the benchmark.

    python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` at the root of the checkout, finds the cell's
configuration, driver, traffic mix and per-layer readers by name, and:

1. refuses to run (exit 2, no result) without as many CUDA cards as the
   cell asks for: nothing falls back to the CPU;
2. sets up (inputs from the seed, the program's objects, a warm-up of
   every shape the window uses) and times it as ``setup_s``;
3. measures for ``--seconds`` (under ``torch.profiler`` with ``--trace
   1``), reads the device's peak memory, frees the program's objects;
4. exits 3, with no result, if ``jax``, ``jaxlib``, ``flax`` or
   ``mgl_tpu`` was loaded (whole top-level module names);
5. checks the window's outputs against the plain reference, prints each
   number compared beside its limit on standard error, and prints the
   result as one JSON line on standard output, last.

Every cache the program builds lies in the checkout: the port's nvcc and
g++ outputs in ``build/mgl_tpu_torch/``, Triton's and torch's extension
caches under ``build/gpubench/``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mgl_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``mgl_tpu_torch`` is not ``mgl_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration file, traffic mix) of a cell."""
    wl = {w["name"]: w for w in bench["workloads"]}
    if workload not in wl:
        raise SystemExit(f"unknown workload {workload!r}")
    w = wl[workload]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(ROOT / conf_entry["file"])
    mix = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    mix.setdefault("name", w["traffic"])
    return w, config, mix


def reader(name: str):
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"gpubench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _env() -> None:
    """Cache directories at fixed paths inside the checkout."""
    build = ROOT / "build" / "gpubench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: the cell needs {n} CUDA card(s), this machine has "
              f"{count}; nothing is measured on the CPU", file=sys.stderr)
        raise SystemExit(2)


def _device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def _power_limit() -> str | None:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def _refuse_forbidden(when: str) -> None:
    found = forbidden_modules()
    if found:
        print(f"gpubench: {when}, the process holds {', '.join(found)}",
              file=sys.stderr)
        raise SystemExit(3)


def measure(bench: dict, workload: str, seed: int, seconds: float,
            trace: bool, device=None, control: bool = False) -> dict:
    """One run; returns the result line's object.  ``device`` None asks
    for the cell's cards; a test passes ``"cpu"`` to drive the rest of a
    run without them.  ``control`` judges the reference's control in the
    program's place instead of the program's outputs."""
    import torch

    from mgl_tpu_torch.utils.metrics import METRICS
    from gpubench import hostload
    from gpubench import spans as spans_mod
    from gpubench import trace as trace_mod

    w, config, mix = cell(bench, workload)
    if device is None:
        require_cards(w["chips"])
        device = torch.device("cuda", 0)
    on_card = torch.device(device).type == "cuda"
    driver = importlib.import_module(f"gpubench.drivers.{config['driver']}")
    spans = spans_mod.Spans(traced=trace)

    t0 = time.perf_counter()
    state = driver.setup(config, mix, seed, device, spans)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _refuse_forbidden("at the end of set-up")

    METRICS.reset()
    spans.spans.clear()
    prof = None
    with (driver.trace_hooks(state, spans) if trace
          else contextlib.nullcontext()):
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        try:
            with spans.span("window"), hostload.HostLoad() as load:
                got = driver.run_window(state, seconds, spans)
                if on_card:
                    torch.cuda.synchronize()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
    load.report()
    device_info = (_device_info(w["chips"]) if on_card else
                   {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0})
    snapshot = METRICS.snapshot()
    work = driver.work(state)
    driver.release(state)
    if on_card:
        torch.cuda.empty_cache()
    _refuse_forbidden("after the window")

    result: dict = {"attempted": got["attempted"], "failed": got["failed"]}
    metrics: dict = {}
    if trace:
        red = (trace_mod.reduce(prof) if on_card else
               {"busy_s": 0.0, "window_s": got["window_s"], "ops": {},
                "idle_by_range": {}})
        ctx = {"cell": workload, "spans": spans, "metrics": snapshot,
               "trace": red, "work": work, "window": got}
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = red["busy_s"]
        device_info["window_s"] = red["window_s"]
        result["breakdown"] = trace_mod.breakdown(red)
    else:
        values = {**got, "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    t_check = time.perf_counter()
    compared = driver.check(state, device, control=control)
    print(f"gpubench: set-up {setup_s:.3f} s, window {got['window_s']:.3f} "
          f"s, check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = all(v <= lim for _, v, lim in compared) and got["failed"] == 0
    result.update({"correct": correct, "metrics": metrics,
                   "device": device_info,
                   "card": _power_limit() if on_card else None,
                   "checked": {n: {"value": _number(v), "limit": lim}
                               for n, v, lim in compared}})
    return result


def _number(v):
    """A JSON number, or "inf" / "nan" for a reading that is none."""
    v = float(v) if not isinstance(v, int) else v
    return v if isinstance(v, int) or v == v and abs(v) != float("inf") \
        else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the reference's lower-precision control in "
                         "the program's place (not a benchmark run)")
    args = ap.parse_args(argv)
    _env()
    bench = load_json(ROOT / "BENCHMARK.json")
    seed = args.seed % 2**63
    result = measure(bench, args.workload, seed, args.seconds,
                     bool(args.trace), control=args.control)
    for name, c in result["checked"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
