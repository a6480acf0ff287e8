"""The benchmark of ``mgl_tpu_torch`` on one NVIDIA GPU.

    python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration (``configs/<config>.json``), the driver it names
(``drivers/<driver>.py``), the traffic mix (``traffic/<mix>.json``) and
its generator, and one reader a per-layer metric (``metrics/<name>.py``).
See ``README.md``.
"""
