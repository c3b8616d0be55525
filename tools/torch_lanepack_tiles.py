#!/usr/bin/env python3
"""Time K1's chain kernel at every block width and thread count, on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/torch_lanepack_tiles.py [N:BATCH ...]

Default shapes (about 512 MiB each): 64:1048576 and 1024:65536 (register
chains of many small transforms), 1000:65536 (four register stages),
2008:32768 (a 512-point Bluestein stage), 8192:8192 (one transform a
block), 251:131072 and 29:2097152 (K5's chain form, one Bluestein stage
of 512 and 64 points).  For each shape it launches csrc/lanepack.cu's
chain kernel on the size's own chain (lanepack.choose_radices, or (n,) for
a dense-route prime) at every power-of-2 width T (transforms a block) whose
buffer fits shared memory, up to 8192 points, with 128 and 256 threads,
checks that the output equals the wrapper's bit for bit (the chain
computes each column alike at any width), and prints the kernel's time
(CUDA events, median of 7 after 2 warm-ups).  The width and thread count
the wrapper takes (lanepack.chain_width, lanepack.chain_threads) are
marked with '*'.  The first line is the card's name and power limit
(nvidia-smi).
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((64, 1 << 20), (1024, 65536), (1000, 65536), (2008, 32768), (8192, 8192),
          (251, 131072), (29, 1 << 21))


def median_ms(fn, reps: int = 7, warmup: int = 2) -> float:
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


def main() -> None:
    import numpy as np
    import torch

    from rustfft_tpu_torch import route
    from rustfft_tpu_torch.common import FftDirection
    from rustfft_tpu_torch.ops.kernels import _build, dense, lanepack

    if not torch.cuda.is_available():
        raise SystemExit("torch_lanepack_tiles: needs an NVIDIA GPU")
    shapes = [tuple(int(v) for v in a.split(":")) for a in sys.argv[1:]] or SHAPES
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, batch in shapes:
        if route(n, np.complex64) == "dense":
            radices, host = (n,), ([dense.chain_table(n, FftDirection.FORWARD)], [])
        else:
            radices = lanepack.choose_radices(n)
            host = lanepack.chain_tables(n, radices, FftDirection.FORWARD)
        tables = tuple([torch.from_numpy(a).to(dev) for a in t] for t in host)
        x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
        want = lanepack.launch_chain(x, radices, tables, "torch_lanepack_tiles")
        print(f"n={n} {radices} batch={batch} Bluestein "
              f"{lanepack.bluestein_ms(radices, lanepack.MAX_STAGES)}:", flush=True)
        width = 1
        while n * width <= 8192 and \
                lanepack.chain_smem_bytes(n, width, radices) <= _build.SMEM_MAX:
            row = []
            for threads in (128, 256):
                def run():
                    return lanepack.launch_chain(x, radices, tables, "torch_lanepack_tiles",
                                                 width=width, threads=threads)
                if not torch.equal(run(), want):
                    raise SystemExit(f"n={n} width {width} threads {threads}: output differs")
                mark = ("*" if (width, threads) == (lanepack.chain_width(n),
                                                    lanepack.chain_threads(n)) else " ")
                row.append(f"{threads} threads {median_ms(run):7.3f} ms{mark}")
            print(f"  width {width:4d} ({lanepack.chain_smem_bytes(n, width, radices)} bytes): "
                  + "  ".join(row), flush=True)
            width *= 2
        del x, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
