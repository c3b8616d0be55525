#!/usr/bin/env python3
"""Time K16 (`permute`) in each of its forms on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/torch_permute_rows.py [M:BATCH ...]

Default shapes: 256:32768 and 262:32768 (the Rader 257 and 263 paths'
gathers), 1008:8192 (the Rader 1009 path's), 4096:2048, 4097:2047,
8192:1024, 8193:1023, 16384:512, 28672:292, and 29056:288 and 29057:288 on
both sides of the wrapper's cut-over (about 64 MiB each).  For each shape
and a random permutation it times `permute.permute_rows` with 0 rows a
block (the direct gather from device memory) and with 1, 2, 4, 8 and 16
whole rows a block in shared memory where they fit, and with
`permute.smem_rows(m)`, the form the wrapper takes; it checks each output
bit for bit against torch.index_select, and prints those times beside
torch.index_select's and a clone of the input's (a copy of the same
bytes).  The forms are timed in turns, ROUNDS rounds of a median of 21
after 3 warm-ups each (CUDA events), so that a drift of the card's clock
reaches every form alike; each time is the median over the rounds, with
the least and the most in brackets (ms).  The first line is the card's
name and power limit (nvidia-smi).
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((256, 32768), (262, 32768), (1008, 8192), (4096, 2048), (4097, 2047), (8192, 1024), (8193, 1023), (16384, 512),
          (28672, 292), (29056, 288), (29057, 288))

#: bytes of shared memory one block may use on sm_90
SMEM_MAX = 232448

#: rounds of every form in turn
ROUNDS = 9


def median_ms(fn, reps: int = 21, warmup: int = 3) -> float:
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

    from rustfft_tpu_torch.ops.kernels import permute

    if not torch.cuda.is_available():
        raise SystemExit("torch_permute_rows: needs an NVIDIA GPU")
    shapes = [tuple(int(v) for v in a.split(":")) for a in sys.argv[1:]] or SHAPES
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, batch in shapes:
        idx = torch.from_numpy(permute.permutation_index(
            np.random.default_rng(m).permutation(m))).to(dev)
        x = torch.randn((batch, m), dtype=torch.complex64, generator=gen, device=dev)
        want = torch.index_select(x, 1, idx)
        forms = {"index_select": lambda: torch.index_select(x, 1, idx), "clone": x.clone}
        for rows in sorted({0, 1, 2, 4, 8, 16, permute.smem_rows(m)}):
            if rows * m * 8 > SMEM_MAX:
                continue
            if not torch.equal(permute.permute_rows(x, idx, rows), want):
                raise SystemExit(f"m={m} rows={rows}: differs from torch.index_select")
            forms[f"rows={rows}"] = lambda rows=rows: permute.permute_rows(x, idx, rows)
        times = {name: [] for name in forms}
        for _ in range(ROUNDS):
            for name, fn in forms.items():
                times[name].append(median_ms(fn))
        line = f"m={m} batch={batch} smem_rows={permute.smem_rows(m)}:"
        for name, ts in times.items():
            line += f" {name} {statistics.median(ts):.4f} ({min(ts):.4f}..{max(ts):.4f});"
        print(line.rstrip(";"), flush=True)
        del x, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
