#!/usr/bin/env python3
"""Time K12's two kernels at every tile width that fits, on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/torch_largepad_tiles.py [N:BATCH ...]

Default shapes: 177147:256 (243 x 729, register radices) and 531441:64
(243 x 2187, a radix-27 Bluestein stage on the row stage), then the
route's bulk: 234617:256, 775575:64, 412519:128, 50666:1024.  For each
shape and each stage of large_pad (largepad_col_stage over P,
largepad_row_stage over Q) it launches csrc/largepad.cu's kernel through
its C entry at every width of largepad.WIDTHS whose tile fits shared
memory, checks that the output equals the wrapper's bit for bit (the
chain computes each column alike at any width), and prints the kernel's
time (CUDA events, median of 7 after 2 warm-ups) with the blocks an SM
holds by shared memory (a block has 256 threads where two fit, else 512).
The width the wrappers take (largepad.tile) is marked with '*'.  The first
line is the card's name and power limit (nvidia-smi).
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((177147, 256), (531441, 64), (234617, 256), (775575, 64), (412519, 128),
          (50666, 1024))


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
    import torch

    from rustfft_tpu_torch.common import FftDirection
    from rustfft_tpu_torch.ops.kernels import _build, fused, large, largepad

    if not torch.cuda.is_available():
        raise SystemExit("torch_largepad_tiles: needs an NVIDIA GPU")
    shapes = [tuple(int(v) for v in a.split(":")) for a in sys.argv[1:]] or SHAPES
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = _build.load()
    fwd = FftDirection.FORWARD

    def card(tables):
        return tuple([torch.from_numpy(a).to(dev) for a in t] if isinstance(t, list)
                     else torch.from_numpy(t).to(dev) for t in tables)

    for n, batch in shapes:
        p, q1, q2 = large.choose_pqq(n)
        q = q1 * q2
        col = card(largepad.col_tables(p, q, fwd))
        row = card(largepad.row_tables(q, fwd))
        x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
        a = largepad.largepad_col_stage(x, p, q, col)
        y = largepad.largepad_row_stage(a, q, p, row)
        print(f"n={n} batch={batch}: P={p} {large.stage_radices(p)} "
              f"{fused.bluestein_ms(large.stage_radices(p))}, Q={q} {large.stage_radices(q)} "
              f"{fused.bluestein_ms(large.stage_radices(q))}", flush=True)
        for stage, m, other, want in (("col", p, q, a), ("row", q, p, y)):
            radices = large.stage_radices(m)
            for width in largepad.WIDTHS:
                smem = largepad.smem_bytes(m, width, radices)
                if smem > _build.SMEM_MAX:
                    continue
                out = torch.empty_like(want)
                if stage == "col":
                    roots, tws, outer = col
                    args = (x.data_ptr(), out.data_ptr(), batch, p, q, width,
                            *fused.chain_args(radices, roots, tws), outer.data_ptr())
                    fn = lib.rf_largepad_col_stage
                else:
                    roots, tws = row
                    args = (a.data_ptr(), out.data_ptr(), batch, q, p, width,
                            *fused.chain_args(radices, roots, tws))
                    fn = lib.rf_largepad_row_stage

                def launch():
                    _build.check(lib, fn(*args, torch.cuda.current_stream().cuda_stream),
                                 f"{stage} width {width}")

                launch()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise SystemExit(f"n={n} {stage} width {width}: differs from the wrapper's "
                                     "output")
                ms = median_ms(launch)
                mark = "*" if width == largepad.tile(m) else " "
                print(f"  {stage} width {width:2d}{mark} {ms:8.3f} ms  ({smem / 1024:.1f} KiB: "
                      f"{largepad.blocks_per_sm(m, width)} blocks an SM by shared memory; "
                      f"{-(-other // width) * batch} blocks)", flush=True)
        del x, a, y
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
