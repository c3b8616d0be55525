#!/usr/bin/env python3
"""Time K12's column kernel at other register caps than its own, on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/torch_largepad_caps.py [N:BATCH ...]

csrc/largepad.cu compiles the column kernel's form without a Bluestein
stage for kPadColPlainBlocks (csrc/largepad.cuh) 256-thread blocks an SM.
This script copies the sources into a temporary directory, compiles
largepad.cu alone into a library for each of B = 2, 3, 4 blocks (at most
128, 80 and 64 registers a thread), prints the column kernel's registers
and spills in each (ptxas -v), and times each build's column kernel
(CUDA events, median of 9 after 2 warm-ups) at the large_pad shapes
(default: 15625:4096, 78125:512, 177147:256, 531441:64, 50666:1024, whose
P chains have no Bluestein stage, and 775575:64, whose has), at each width
of largepad.WIDTHS at which two or more blocks fit shared memory (the
largest three), with every output checked bit for bit against the
wrapper's.  The first line is the card's name and power limit
(nvidia-smi).
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((15625, 4096), (78125, 512), (177147, 256), (531441, 64), (50666, 1024), (775575, 64))
CAPS = (2, 3, 4)
KNOB = "constexpr int kPadColPlainBlocks = "


def median_ms(fn, reps: int = 9, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def build_caps(tmp: str):
    """{name: library}, one build of largepad.cu per cap."""
    from rustfft_tpu_torch.ops.kernels import _build

    procs = {}
    for blocks in CAPS:
        d = os.path.join(tmp, f"cap{blocks}")
        shutil.copytree(_build.SRC_DIR, d)
        path = os.path.join(d, "largepad.cuh")
        src = open(path).read()
        if src.count(KNOB) != 1:
            raise SystemExit(f"torch_largepad_caps: expected one '{KNOB}' in largepad.cuh")
        with open(path, "w") as f:
            f.write(re.sub(re.escape(KNOB) + r"\d+;", f"{KNOB}{blocks};", src))
        procs[f"{blocks} blocks"] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "largepad.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{report}")
        entry = ""
        for line in report.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                                       text=True).stdout.strip().split("(")[0]
            elif "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                print(f"  {name} {entry}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        lib.rf_largepad_col_stage.argtypes = _build._SIGNATURES["rf_largepad_col_stage"]
        lib.rf_largepad_col_stage.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    import torch

    from rustfft_tpu_torch.common import FftDirection
    from rustfft_tpu_torch.ops.kernels import _build, fused, large, largepad

    if not torch.cuda.is_available():
        raise SystemExit("torch_largepad_caps: needs an NVIDIA GPU")
    shapes = [tuple(int(v) for v in a.split(":")) for a in sys.argv[1:]] or SHAPES
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd = FftDirection.FORWARD

    def card(tables):
        return tuple([torch.from_numpy(a).to(dev) for a in t] if isinstance(t, list)
                     else torch.from_numpy(t).to(dev) for t in tables)

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_caps(tmp)
        for n, batch in shapes:
            p, q1, q2 = large.choose_pqq(n)
            q = q1 * q2
            col = card(largepad.col_tables(p, q, fwd))
            x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
            want = largepad.largepad_col_stage(x, p, q, col)
            radices = large.stage_radices(p)
            widths = [w for w in largepad.WIDTHS
                      if largepad.smem_bytes(p, w, radices) <= _build.SMEM_MAX
                      and largepad.blocks_per_sm(p, w) >= 2][:3]
            cells = []
            for width in widths:
                for name, lib in libs.items():
                    out = torch.empty_like(want)
                    args = (x.data_ptr(), out.data_ptr(), batch, p, q, width,
                            *fused.chain_args(radices, col[0], col[1]), col[2].data_ptr())

                    def launch():
                        code = lib.rf_largepad_col_stage(*args,
                                                         torch.cuda.current_stream().cuda_stream)
                        if code:
                            raise RuntimeError(f"{name} width {width}: CUDA error {code}")

                    launch()
                    torch.cuda.synchronize()
                    if not torch.equal(out, want):
                        raise SystemExit(f"n={n} {name} width {width}: differs from the "
                                         "wrapper's output")
                    cells.append(f"{name} w{width} {median_ms(launch):.3f}")
            print(f"n={n} batch={batch} col {radices} Bluestein {fused.bluestein_ms(radices)}: "
                  + "; ".join(cells), flush=True)
            del x, want
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
