#!/usr/bin/env python3
"""Compare the machine code (SASS) of CUDA sources between two checkouts.

Run from the repository root on a machine with nvcc:

    python3 tools/torch_sass_cmp.py [--per-kernel] OLD_CHECKOUT NEW_CHECKOUT [SOURCE ...]

Default sources: fused.cu, largepad.cu and largepad_row.cu (K7's and K12's
kernels, which include csrc/inplace_chain.cuh).  Each source of each
checkout is compiled with the build's own flags (one nvcc each, in
parallel), disassembled with cuobjdump -sass, and the two listings are
compared line by line with the instruction addresses stripped and runs
of white space made one (cuobjdump pads its columns to the longest line
of the file, so a kernel added to a source shifts every line's padding); it
prints, per source, the SASS lines of each side and how many differ (at
the same position, plus the difference in length).  0 means the kernels are
the same instructions, so a difference in their times is not the code's.

With --per-kernel the listings are split by function (cuobjdump's
"Function :" headers) and compared function by function, so that the
kernels of a source that did not change show 0 while another kernel of
the same source changed (for example fused.cu's two_stage_kernel and
two_stage_cluster_kernel while its radix_kernel changes): one line per
kernel, demangled, with its SASS lines on each side and how many differ,
or "only in old" / "only in new".
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rustfft_tpu_torch.ops.kernels import _build  # noqa: E402

SOURCES = ("fused.cu", "largepad.cu", "largepad_row.cu")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")


def differing(old_lines, new_lines) -> int:
    return (sum(a != b for a, b in zip(old_lines, new_lines))
            + abs(len(old_lines) - len(new_lines)))


def by_function(lines):
    """{mangled name: its SASS lines} of one listing."""
    out, name = {}, None
    for line in lines:
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def demangle(name: str) -> str:
    return subprocess.run(["c++filt", name], capture_output=True, text=True).stdout.strip()


def main() -> None:
    args = sys.argv[1:]
    per_kernel = "--per-kernel" in args
    args = [a for a in args if a != "--per-kernel"]
    if len(args) < 2:
        raise SystemExit(__doc__)
    old, new = Path(args[0]), Path(args[1])
    sources = args[2:] or SOURCES
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for src in sources:
            for tag, root in (("old", old), ("new", new)):
                obj = os.path.join(tmp, f"{tag}-{src}.o")
                jobs[(src, tag)] = (obj, subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", obj,
                     str(root / "rustfft_tpu_torch" / "csrc" / src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for (src, tag), (_, proc) in jobs.items():
            if proc.wait() != 0:
                raise SystemExit(f"nvcc failed on {tag} {src}:\n{proc.stdout.read()}")
        for src in sources:
            listings = []
            for tag in ("old", "new"):
                out = subprocess.run([cuobjdump(), "-sass", jobs[(src, tag)][0]],
                                     capture_output=True, text=True, check=True).stdout
                listings.append([" ".join(re.sub(r"/\*[0-9a-f]+\*/", "", line).split())
                                 for line in out.splitlines() if line.strip()])
            old_lines, new_lines = listings
            print(f"{src}: {len(listings[0])} / {len(listings[1])} SASS lines; "
                  f"differing lines: {differing(old_lines, new_lines)}", flush=True)
            if per_kernel:
                funcs = [by_function(lines) for lines in listings]
                for name in sorted(set(funcs[0]) | set(funcs[1])):
                    label = demangle(name)[:120]
                    if name not in funcs[0] or name not in funcs[1]:
                        side = "old" if name in funcs[0] else "new"
                        print(f"  {label}: only in {side}", flush=True)
                        continue
                    a, b = funcs[0][name], funcs[1][name]
                    print(f"  {label}: {len(a)} / {len(b)} SASS lines; differing lines: "
                          f"{differing(a, b)}", flush=True)


if __name__ == "__main__":
    main()
