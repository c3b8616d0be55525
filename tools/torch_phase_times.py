#!/usr/bin/env python3
"""Split the time of K7's cluster kernel into its phases on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/torch_phase_times.py [N:BATCH ...]

Default shapes: 49152:2048 (192 x 256, register radices only, 4 blocks a
transform) and 260608:256 (509 x 512, the prime p = 509 as a Bluestein
stage, 16 blocks).  For each shape it runs the stamped form of
two_stage_cluster_kernel (fused.two_stage_cluster_phase_stamps, which no
route launches: thread 0 of every block reads %globaltimer after a block
barrier at the kernel's start and at the end of the load, DFT_p, the
exchange, DFT_q and the store), checks its output bit for bit against the
kernel's, and prints:

  - per phase, the mean and median over blocks of its time in a block, in
    microseconds, and its share of a block's span (start to store);
  - the blocks' mean span, the blocks resident at once (the sum of the
    spans over the first-to-last stamp), and the wall time of the stamped
    launch and of the kernel's own (CUDA events, median of 7 after 2
    warm-ups), whose difference is what the stamps cost.

The first line is the card's name and power limit (nvidia-smi).
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((49152, 2048), (260608, 256))


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
    from rustfft_tpu_torch.ops.kernels import fused, large

    if not torch.cuda.is_available():
        raise SystemExit("torch_phase_times: needs an NVIDIA GPU")
    shapes = [tuple(int(v) for v in a.split(":")) for a in sys.argv[1:]] or SHAPES
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, batch in shapes:
        p, q = fused.choose_pq(n)
        c = fused.choose_cluster(n)
        host = fused.two_stage_tables(p, large.stage_radices(q), FftDirection.FORWARD)
        tabs = tuple([torch.from_numpy(a).to(dev) for a in t] if isinstance(t, list)
                     else torch.from_numpy(t).to(dev) for t in host)
        x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
        fused.two_stage_cluster_phase_stamps(x, p, q, c, tabs)  # warm-up
        y, stamps = fused.two_stage_cluster_phase_stamps(x, p, q, c, tabs)
        torch.cuda.synchronize()
        if not torch.equal(y, fused.two_stage_cluster_fft(x, p, q, c, tabs)):
            raise SystemExit(f"n={n}: the stamped kernel differs from the kernel")
        s = stamps.double().cpu()
        phases = (s[:, 1:] - s[:, :-1]) / 1e3  # (blocks, 5) microseconds
        span = (s[:, -1] - s[:, 0]) / 1e3
        wall = (s[:, -1].max() - s[:, 0].min()).item() / 1e3
        print(f"n={n} ({p} x {q}, {large.stage_radices(p)} x {large.stage_radices(q)}, "
              f"Bluestein lengths {fused.bluestein_ms(large.stage_radices(p))}) batch={batch} "
              f"on clusters of {c}: {s.shape[0]} blocks", flush=True)
        for i, name in enumerate(fused.PHASES):
            col = phases[:, i]
            print(f"  {name:9s} mean {col.mean().item():9.2f} us  median "
                  f"{col.median().item():9.2f} us  {100 * col.mean().item() / span.mean().item():5.1f}% "
                  "of a block's span", flush=True)
        stamped = median_ms(lambda: fused.two_stage_cluster_phase_stamps(x, p, q, c, tabs))
        plain = median_ms(lambda: fused.two_stage_cluster_fft(x, p, q, c, tabs))
        print(f"  span: mean {span.mean().item():.2f} us; blocks resident at once "
              f"{span.sum().item() / wall:.1f}; first to last stamp {wall / 1e3:.3f} ms; "
              f"stamped launch {stamped:.3f} ms, kernel {plain:.3f} ms", flush=True)
        del x, y, stamps
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
