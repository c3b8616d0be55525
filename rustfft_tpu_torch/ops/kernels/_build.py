"""Build the CUDA kernels from the package's sources and load them.

Every `csrc/*.cu` file is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c
    nvcc -shared

The library goes to `build/rustfft_tpu_torch/` at the repository root, named
by a hash of the sources' contents, so an edit rebuilds and an unchanged
checkout reuses the last build.  The build runs on first use, never at
import: the CPU-only test runs import every module and have no nvcc.

`load(phase_stamps=True)` builds and loads a second library from the same
sources with `-DRF_PHASE_STAMPS`, which adds the stamped forms of K1's
two kernels (`rf_lanepack_chain_phase_stamps`,
`rf_lanepack_pipe_phase_stamps`), K9's radix kernel (`rf_radix_phase_stamps`),
K7's cluster kernel
(`rf_two_stage_cluster_phase_stamps`) and K12's two kernels
(`rf_largepad_col_phase_stamps`, `rf_largepad_row_phase_stamps`), K2's and
K3's (`rf_large_col_phase_stamps`, `rf_large_row_phase_stamps`), K10's
cluster kernel (`rf_large2f_col_phase_stamps`), the one-pass convolution
core's kernels (`rf_conv_fft_stamps`, `rf_conv_chain_fft_stamps`) and the
access-pattern probe of K3's tile (`rf_large_copy_probe`;
tools/torch_phase_times.py, tools/torch_ab.py); no route loads it, so no other build pays for
those forms.
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
from typing import Dict

_PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "rustfft_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

#: bytes of shared memory one block may use on sm_90 (csrc/fft_tile.cuh)
SMEM_MAX = 232448

_vp = ctypes.c_void_p
_int = ctypes.c_int
_ll = ctypes.c_longlong

#: argtypes of every C entry point; pointers and the stream as c_void_p so
#: that ctypes does not cut them to 32 bits
_SIGNATURES = {
    "rf_lanepack_chain": [_vp, _vp, _ll, _int, _int, _int] + [_int] * 5 + [_vp] * 7
                         + [_int] * 4 + [_vp],
    "rf_lanepack_pipe": [_vp, _vp, _ll] + [_vp] * 6,
    "rf_large_col_stage": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 6 + [_ll, _ll, _vp],
    "rf_large_row_stage": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 5 + [_ll, _vp],
    "rf_large_resident_blocks": [_int, ctypes.POINTER(_int)],
    "rf_conv_fft": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 8 + [_int, _vp],
    "rf_conv_chain_fft": [_vp, _vp, _ll] + [_int] * 8 + [_vp] * 5 + [_int] * 3 + [_ll, _vp],
    "rf_conv_chain_resident": [_int, _ll, ctypes.POINTER(_int)],
    "rf_large_col_stage_gauss": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 6 + [_ll, _ll, _vp],
    "rf_large_row_stage_gauss": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 5 + [_ll, _vp],
    "rf_large_gauss_resident_blocks": [_int, ctypes.POINTER(_int)],
    "rf_conv_col_stage": [_vp, _vp, _vp, _ll, _int, _ll] + [_int] * 8 + [_vp] * 9,
    "rf_conv_row_stage_gauss": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 8 + [_ll, _vp, _vp]
                               + [_int, _int, _int, _ll, _vp],
    "rf_permute": [_vp, _vp, _vp, _ll, _int, _int, _vp],
    "rf_large2f_col_stage": [_vp, _vp, _ll] + [_int] * 8 + [_vp] * 7 + [_int, _ll, _vp],
    "rf_large2f_max_active_clusters": [_int, ctypes.POINTER(_int)],
    "rf_large3_col_stage": [_vp, _vp, _ll] + [_int] * 8 + [_vp] * 6 + [_ll, _ll, _vp],
    "rf_large3_p2": [_vp, _vp, _ll, _int, _int, _int, _vp, _vp, _vp, _ll, _ll, _vp],
    "rf_large3_resident_blocks": [_int, ctypes.POINTER(_int)],
    "rf_radix_fft": [_vp, _vp, _ll, _ll, _int] + [_int] * 4 + [_vp] * 5 + [_vp] * 5,
    "rf_radix_max_active_clusters": [_int, ctypes.POINTER(_int)],
    "rf_two_stage_fft": [_vp, _vp, _ll, _int, _int] + ([_int] * 4 + [_vp] * 5 + [_int] * 3) * 2
                        + [_vp, _int, _ll, _vp],
    "rf_two_stage_cluster_fft": [_vp, _vp, _ll, _int, _int, _int]
                                + ([_int] * 4 + [_vp] * 5 + [_int] * 3) * 2 + [_vp, _int, _vp],
    "rf_two_stage_cluster_max_active_clusters": [_int, ctypes.POINTER(_int)],
    "rf_two_stage_attrs": [_int, ctypes.POINTER(_int), ctypes.POINTER(_int)],
    "rf_dense_fft": [_vp, _vp, _ll, _int, _int, _vp, _vp, _ll, _vp],
    "rf_dense_pair_resident": [_int, ctypes.POINTER(_int)],
    "rf_largepad_col_stage": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 5 + [_int] * 3 + [_vp, _vp],
    "rf_largepad_row_stage": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 5 + [_int] * 3 + [_vp],
    "rf_bconv_row_stage": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 8,
    "rf_bconv_out_stage": [_vp, _vp, _ll] + [_int] * 8 + [_vp] * 7,
    "rf_bconv_col_tile": [_vp, _vp, _ll, _int, _ll] + [_int] * 5 + [_vp] * 5 + [_ll, _ll, _vp],
    "rf_bconv_row_tile": [_vp, _vp, _ll, _int] + [_vp] * 5 + [_ll, _vp],
    "rf_bconv_out_tile": [_vp, _vp, _ll, _int, _int, _ll] + [_int] * 3 + [_vp] * 4
                         + [_ll, _ll, _vp],
    "rf_bconv_resident_blocks": [_int, ctypes.POINTER(_int)],
    "rf_bconv_cols": [_vp, _vp, _ll] + [_int] * 8 + [_vp] * 4 + [_ll, _vp],
    "rf_bconv_cols_resident": [_int, ctypes.POINTER(_int)],
    "rf_bconv_pair": [_vp, _vp, _ll, _int] + [_vp] * 4 + [_ll, _vp],
    "rf_bconv_pair_clusters": [ctypes.POINTER(_int)],
    "rf_conv_pad_col_stage": [_vp, _vp, _vp, _ll, _int, _ll] + [_int] * 7 + [_vp] * 5
                             + [_int] * 3 + [_vp] * 4,
    "rf_conv_pad_row_stage": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 5 + [_int] * 3 + [_vp] * 3
                             + [_ll, _vp, _vp, _int, _int, _int, _ll, _vp],
    "rf_conv_radix_pass1": [_vp, _vp, _vp, _ll, _int, _ll] + [_int] * 5 + [_vp] * 14 + [_ll, _vp],
    "rf_conv_radix_pass2": [_vp, _vp, _ll] + [_int] * 5 + [_vp] * 13 + [_ll, _vp, _vp]
                           + [_int] * 3 + [_ll, _ll, _vp],
}

#: the entry points only the RF_PHASE_STAMPS library has
_STAMP_SIGNATURES = {
    "rf_radix_phase_stamps": [_vp, _vp, _ll, _ll, _int] + [_int] * 4 + [_vp] * 5 + [_vp] * 4
                             + [_vp, _vp],
    "rf_two_stage_phase_stamps": [_vp, _vp, _ll, _int, _int]
                                 + ([_int] * 4 + [_vp] * 5 + [_int] * 3) * 2
                                 + [_vp, _int, _vp, _vp],
    "rf_two_stage_cluster_phase_stamps": [_vp, _vp, _ll, _int, _int, _int]
                                         + ([_int] * 4 + [_vp] * 5 + [_int] * 3) * 2
                                         + [_vp, _int, _vp, _vp],
    "rf_largepad_col_phase_stamps": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 5 + [_int] * 3
                                    + [_vp, _vp, _vp],
    "rf_largepad_row_phase_stamps": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 5 + [_int] * 3
                                    + [_vp, _vp],
    "rf_lanepack_chain_phase_stamps": [_vp, _vp, _ll, _int, _int, _int] + [_int] * 5
                                      + [_vp] * 7 + [_int] * 4 + [_vp, _vp],
    "rf_lanepack_pipe_phase_stamps": [_vp, _vp, _ll] + [_vp] * 7,
    "rf_large_col_phase_stamps": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 6 + [_ll, _ll, _vp, _vp],
    "rf_large_row_phase_stamps": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 5 + [_ll, _vp, _vp],
    "rf_large_copy_probe": [_vp, _vp, _ll, _int, _int, _vp],
    "rf_large2f_col_phase_stamps": [_vp, _vp, _ll] + [_int] * 8 + [_vp] * 7
                                   + [_int, _ll, _vp, _vp],
    "rf_bconv_col_tile_stamps": [_vp, _vp, _ll, _int, _ll] + [_int] * 5 + [_vp] * 5
                                + [_ll, _ll, _vp, _vp],
    "rf_bconv_row_tile_stamps": [_vp, _vp, _ll, _int] + [_vp] * 5 + [_ll, _vp, _vp],
    "rf_bconv_cols_stamps": [_vp, _vp, _ll] + [_int] * 8 + [_vp] * 4 + [_ll, _vp, _vp],
    "rf_bconv_pair_stamps": [_vp, _vp, _ll, _int] + [_vp] * 4 + [_ll, _vp, _vp],
    "rf_bconv_out_tile_stamps": [_vp, _vp, _ll, _int, _int, _ll] + [_int] * 3 + [_vp] * 4
                                + [_ll, _ll, _vp, _vp],
    "rf_gather_probe": [_vp, _vp, _vp, _ll, _int, _int, _vp],
    "rf_conv_fft_stamps": [_vp, _vp, _ll] + [_int] * 7 + [_vp] * 8 + [_int, _vp, _vp],
    "rf_conv_chain_fft_stamps": [_vp, _vp, _ll] + [_int] * 8 + [_vp] * 5 + [_int] * 3
                                + [_ll, _vp, _vp],
}
STAMP_FLAGS = ("-DRF_PHASE_STAMPS",)

_lock = threading.Lock()
#: the loaded libraries: False the kernels', True the phase-stamps build
_libs: Dict[bool, ctypes.CDLL] = {}
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


def library_path(phase_stamps: bool = False) -> Path:
    tag = "-stamps" if phase_stamps else ""
    return BUILD_DIR / f"librustfft_tpu_torch-{source_hash()}{tag}.so"


def _run(procs, what: str) -> None:
    """Wait for every nvcc process; raise with the output of the first that failed."""
    failed = None
    for proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc {what} failed (exit {proc.returncode}):\n{out}{err}"
    if failed:
        raise RuntimeError(failed)


def build(phase_stamps: bool = False) -> Path:
    """Compile the sources unless a library for their hash exists; return it.
    With phase_stamps, the library with -DRF_PHASE_STAMPS."""
    global last_build_seconds
    out = library_path(phase_stamps)
    flags = NVCC_FLAGS + (STAMP_FLAGS if phase_stamps else ())
    if out.exists():
        last_build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in sorted(SRC_DIR.glob("*.cu"))]
        procs = [
            subprocess.Popen([nvcc, *flags, "-c", "-o", obj, str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(sorted(SRC_DIR.glob("*.cu")), objs)
        ]
        _run(procs, "compile")
        lib = os.path.join(tmp, out.name)
        link = subprocess.Popen([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                                 "-o", lib, *objs],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        _run([link], "link")
        os.replace(lib, out)
    last_build_seconds = time.perf_counter() - start
    return out


def load(phase_stamps: bool = False) -> ctypes.CDLL:
    """The kernels' library, built on first use; with phase_stamps, the
    library that also has the stamped cluster kernel."""
    with _lock:
        if phase_stamps not in _libs:
            lib = ctypes.CDLL(str(build(phase_stamps)))
            signatures = {**_SIGNATURES, **(_STAMP_SIGNATURES if phase_stamps else {})}
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rf_error_string.argtypes = [ctypes.c_int]
            lib.rf_error_string.restype = ctypes.c_char_p
            _libs[phase_stamps] = lib
        return _libs[phase_stamps]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.rf_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
