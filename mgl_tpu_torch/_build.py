"""Build and load the port's CUDA kernels and its host library.

Every ``csrc/*.cu`` is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ``ctypes``; every ``csrc/host/*.cpp`` (the host
CIGAR decoder and ScoreMax scan, and the read mapper's seeding) is
compiled by ``g++`` into a second one.
Each goes to ``build/mgl_tpu_torch/`` at the root of the checkout
(git-ignored) under a name that carries the hash of its sources and
flags, so an edit to any source rebuilds it at its next use and an
unchanged tree reuses it.

Nothing is compiled when this module is imported: :func:`load_library`
builds at the first kernel launch, :func:`load_host_library` at the first
CIGAR decode or index build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mgl_tpu_torch"

# The shared PairHMM kernel's most warps a block, its __launch_bounds__:
# at 24 (768 threads) ptxas keeps a lane's state in registers without
# spills, where 32 warps held it to 64 registers and spilled.
SHARED_MAX_WARPS = 24
# The per-pair and plane PairHMM kernels' most warps a block, their
# __launch_bounds__: 16 (512 threads) leaves a lane 128 registers, room for
# the double instance's planes and state, and the plane kernel's four rows
# a lane, without spills, and runs a read of up to 512 bases (16 bands of
# a row a lane) in one round.
BANDED_MAX_WARPS = 16
# --fmad=false: no contraction of a*b+c, so the PairHMM kernels round like
# torch's elementwise ops; no -ftz, so f32 denormals are kept.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    f"-DMGL_SHARED_MAX_WARPS={SHARED_MAX_WARPS}",
    f"-DMGL_BANDED_MAX_WARPS={BANDED_MAX_WARPS}",
)
# no -march=native: the library must load on any x86-64 host it is built on
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# C entry points: name -> argument types (every pointer and the stream as
# c_void_p, so none is cut to 32 bits)
_ENTRIES = {
    "mgl_sw_banded": [_P] * 4 + [_I] * 13 + [_P] * 4,
    "mgl_sw_banded_carry_in_shared": [_I] * 4,
    "mgl_pairhmm_banded_f32": [_P] * 8 + [_I] * 5 + [_P] * 3,
    "mgl_pairhmm_banded_f64": [_P] * 8 + [_I] * 5 + [_P] * 3,
    "mgl_pairhmm_banded_carry_in_shared": [_I] * 4,
    "mgl_pairhmm_shared_f32": [_P] * 5 + [_I] * 4
                              + [ctypes.c_float, _I, _I] + [_P] * 3,
    "mgl_pairhmm_shared_carry_in_shared": [_I] * 3,
    "mgl_sw_plane": [_P] * 4 + [_I] * 12 + [_P] * 4,
    "mgl_sw_plane_carry_in_shared": [_I] * 4,
    "mgl_pairhmm_plane_f32": [_P] * 8 + [_I] * 6 + [_P] * 3,
    "mgl_pairhmm_plane_carry_in_shared": [_I] * 4,
    "mgl_seed_extend": [_P] * 8 + [_I] * 3 + [_P] * 2,
    "mgl_seed_extend_layout": [_I] * 3 + [_P],
    "mgl_window_gather": [_P] * 5 + [_I64] + [_I] * 4 + [_P] * 3,
    "mgl_cigar_walk": [_P] * 4 + [_I, _I64] + [_I] * 4 + [_P] * 4,
    "mgl_cigar_walk_layout": [_I, _P],
}
_HOST_ENTRIES = {
    "cigar_decode_batch": [_I, _P, _I64, _I64, _P, _P, _I, _P, _P, _P, _P,
                           _P, _I, _P, _I],
    "cigar_decode_batch_banded": [_I, _P, _I64, _I64, _P, _P, _I, _P, _P, _P,
                                  _P, _P, _I, _P, _I, _I, _I, _I64],
    "score_max_batch": [_I, _P, _P, _I64, _I64, _P, _P] + [_P] * 6,
    "kmer_scan_canonical": [_I64, _P, _I, _P, _P, _P],
    "kmer_prefix_table": [_I64, _P, _I, _I64, _P],
    "radix_sort_kmer_index": [_I64, _I, _P, _P, _P],
    "map_seed_vote": [_I, _I, _P, _I, _I, _P, _P, _P, _I64, _P, _I, _I, _I64,
                      _I] + [_P] * 4,
    "exact_nm_batch": [_I, _I, _P, _P, _I64, _P, _P, _I],
}
# the host entries that return a value (the rest return void)
_HOST_RESTYPES = {"kmer_scan_canonical": _I64}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def host_sources() -> list[pathlib.Path]:
    return sorted((CSRC / "host").glob("*.cpp"))


def _hash(paths: list[pathlib.Path], flags: tuple[str, ...]) -> str:
    h = hashlib.sha256()
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def source_hash() -> str:
    return _hash(sources(), NVCC_FLAGS)


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libmgl_tpu_torch-{source_hash()}.so"


def host_library_path() -> pathlib.Path:
    return BUILD_DIR / (f"libmgl_tpu_torch_host-"
                        f"{_hash(host_sources(), HOST_FLAGS)}.so")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _run(cmds: list[list[str]], log: list[str]) -> None:
    """Run ``cmds`` side by side, append each one's report (for nvcc:
    registers, spills) to ``log``, and raise if any failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{pathlib.Path(cmd[0]).name} failed "
                          f"({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _compile(compiler: str, flags: tuple[str, ...],
             srcs: list[pathlib.Path], so: pathlib.Path) -> None:
    """Compile ``srcs`` into ``so``, each source by its own compiler
    process, all started together, then link the objects; the reports go
    to ``so`` with the suffix ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    objs = [so.with_name(f"{so.stem}.{os.getpid()}.{src.stem}.o")
            for src in srcs]
    log: list[str] = []
    compile_flags = tuple(f for f in flags if f != "-shared")
    try:
        _run([[compiler, *compile_flags, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(srcs, objs)], log)
        _run([[compiler, *flags, "-o", str(tmp), *map(str, objs)]], log)
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        so.with_suffix(".log").write_text("".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing


def build(so: pathlib.Path) -> None:
    """Compile every csrc/*.cu into ``so`` with nvcc."""
    _compile(_nvcc(), NVCC_FLAGS, [p for p in sources() if p.suffix == ".cu"],
             so)


def kernel_resources(fragment: str) -> list[dict]:
    """Registers and spills of each compiled kernel whose mangled name
    holds ``fragment``, read from the kernel library's build log (nvcc's
    ``-Xptxas -v`` report): dicts of entry, registers, spill_stores and
    spill_loads (bytes).  Empty if the library was built elsewhere."""
    log = library_path().with_suffix(".log")
    if not log.exists():
        return []
    found: dict[str, dict] = {}
    current = None
    for line in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            current = found.setdefault(m.group(1), {"entry": m.group(1)})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return [v for k, v in found.items() if fragment in k and "registers" in v]


def _bind(so: pathlib.Path, entries: dict, restype) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernel library, built first if its sources changed."""
    so = library_path()
    if not so.exists():
        build(so)
    lib = _bind(so, _ENTRIES, ctypes.c_int)
    lib.mgl_error_string.argtypes = [ctypes.c_int]
    lib.mgl_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def load_host_library() -> ctypes.CDLL:
    """The host library (CIGAR decoder, ScoreMax, the mapper's seeding),
    built with g++ first if its sources changed.  Raises if it cannot be built or loaded: there is no
    Python fallback."""
    so = host_library_path()
    if not so.exists():
        compiler = shutil.which("g++") or shutil.which("c++")
        if compiler is None:
            raise RuntimeError("no C++ compiler (g++) to build the host "
                               "CIGAR decoder")
        _compile(compiler, HOST_FLAGS, host_sources(), so)
    lib = _bind(so, _HOST_ENTRIES, None)
    for name, restype in _HOST_RESTYPES.items():
        getattr(lib, name).restype = restype
    return lib


def check_launch(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a C entry reported a launch error (cudaGetLastError)."""
    if code != 0:
        msg = lib.mgl_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}: {msg})")
