"""Build the CUDA kernels from the package's sources and load them.

Every `csrc/*.cu` file is compiled by one nvcc call into one shared library
with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

The library goes to `build/rustfft_tpu_torch/` at the repository root, named
by a hash of the sources' contents, so an edit rebuilds and an unchanged
checkout reuses the last build.  The build runs on first use, never at
import: the CPU-only test runs import every module and have no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "rustfft_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

#: bytes of shared memory one block may use on sm_90 (csrc/fft_tile.cuh)
SMEM_MAX = 232448

_vp = ctypes.c_void_p
_int = ctypes.c_int
_ll = ctypes.c_longlong

#: argtypes of every C entry point; pointers and the stream as c_void_p so
#: that ctypes does not cut them to 32 bits
_SIGNATURES = {
    "rf_lanepack_fft": [_vp, _vp, _ll, _int, _int, _int, _int, _int,
                        _vp, _vp, _vp, _vp, _vp, _vp],
    "rf_large_col_stage": [_vp, _vp, _ll, _int, _int, _int, _int, _int, _int,
                           _int, _vp, _vp, _vp, _vp, _vp, _vp, _vp],
    "rf_large_row_stage": [_vp, _vp, _ll, _int, _int, _int, _int, _int, _int,
                           _int, _vp, _vp, _vp, _vp, _vp, _vp],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when an existing library was reused)
last_build_seconds = 0.0


def sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    return BUILD_DIR / f"librustfft_tpu_torch-{source_hash()}.so"


def build() -> Path:
    """Compile the sources unless a library for their hash exists; return it."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        last_build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(SRC_DIR.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    start = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    last_build_seconds = time.perf_counter() - start
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rf_error_string.argtypes = [ctypes.c_int]
            lib.rf_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.rf_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
