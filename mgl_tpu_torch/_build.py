"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` into one shared library with a
plain C interface, loaded with ``ctypes``.  The library goes to
``build/mgl_tpu_torch/`` at the root of the checkout (git-ignored) under a
name that carries the hash of the sources and flags, so an edit to any
source rebuilds it at its next use and an unchanged tree reuses it.

Nothing is compiled when this module is imported: :func:`load_library`
builds at the first kernel launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mgl_tpu_torch"

# --fmad=false: no contraction of a*b+c, so the PairHMM kernels round like
# torch's elementwise ops; no -ftz, so f32 denormals are kept.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (every pointer and the stream as
# c_void_p, so none is cut to 32 bits)
_ENTRIES = {
    "mgl_sw_banded": [_P] * 4 + [_I] * 12 + [_P] * 4,
    "mgl_pairhmm_banded_f32": [_P] * 8 + [_I] * 4 + [_P] * 3,
    "mgl_pairhmm_banded_f64": [_P] * 8 + [_I] * 4 + [_P] * 3,
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libmgl_tpu_torch-{source_hash()}.so"


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


def build(so: pathlib.Path) -> None:
    """Compile every csrc/*.cu into ``so``; nvcc's report (registers,
    spills) goes to ``so`` with the suffix ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cu = [str(p) for p in sources() if p.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)   # atomic: a concurrent loader sees all or nothing


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The kernel library, built first if its sources changed."""
    so = library_path()
    if not so.exists():
        build(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mgl_error_string.argtypes = [ctypes.c_int]
    lib.mgl_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, code: int, name: str) -> None:
    """Raise if a C entry reported a launch error (cudaGetLastError)."""
    if code != 0:
        msg = lib.mgl_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}: {msg})")
