#!/usr/bin/env python3
"""Report the registers and spills of the PyTorch/CUDA port's kernels.

Run from the repository root on a machine with nvcc:

    python3 tools/torch_ptxas.py [CHECKOUT]

Compiles every rustfft_tpu_torch/csrc/*.cu of this checkout (or of the
checkout named, for example a parent unpacked with `git archive` into
tmp_chip/parent) with `-Xptxas -v`, one nvcc each, in parallel, with the
build's own flags; writes the whole report to build/ptxas.txt and prints
each kernel's registers and any spill.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rustfft_tpu_torch.ops.kernels import _build  # noqa: E402


def main() -> None:
    checkout = Path(sys.argv[1]) if len(sys.argv) > 1 else Path(ROOT)
    srcs = sorted((checkout / "rustfft_tpu_torch" / "csrc").glob("*.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                                   "-o", os.path.join(tmp, s.stem + ".o"), str(s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s in srcs]
        reports = [p.communicate()[0] for p in procs]
    text = "".join(f"==== {s.name}\n{r}" for s, r in zip(srcs, reports))
    out_dir = os.path.join(ROOT, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        f.write(text)
    entry = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                                   text=True).stdout.strip()[:110]
        elif "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
            print(f"  {entry}: {line.strip()}")
    if any(p.returncode for p in procs):
        raise SystemExit("nvcc failed; see build/ptxas.txt")


if __name__ == "__main__":
    main()
