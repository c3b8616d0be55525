#!/usr/bin/env python3
"""Time K7's cluster kernel at every cluster size its shares allow.

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 tools/torch_cluster_sizes.py

For each of chip_smoke.py's cluster-band paths, and 32896 x 4096 (a prime
p = 257) and 36864 x 2048 (m of the Bluestein prime 18427), times
`fused.two_stage_cluster_fft` with CUDA events (median of 7 after 2
warm-ups) at every c in `fused.CLUSTER_SIZES` that divides q and whose
shares hold at most `fused.CLUSTER_SHARE_MAX` values, in turns (each c,
then each c again in reverse order), checks every c's output against the
first's, and prints one line per path beside the c that
`fused.choose_cluster` picks.  It tests choose_cluster's rule (the fewest
blocks that fit).
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PATHS = ((28928, 4096), (49152, 2048), (98304, 1024), (196608, 512), (245760, 256),
         (260608, 256), (32896, 4096), (36864, 2048))


def main() -> None:
    import torch

    from rustfft_tpu_torch.common import FftDirection
    from rustfft_tpu_torch.ops.kernels import fused, large

    if not torch.cuda.is_available():
        raise SystemExit("torch_cluster_sizes: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def ms(fn, reps=7, warmup=2):
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

    for n, batch in PATHS:
        p, q = fused.choose_pq(n)
        x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device="cuda")
        host = fused.two_stage_tables(p, large.stage_radices(q), FftDirection.FORWARD)
        tabs = tuple([torch.from_numpy(a).cuda() for a in t] if isinstance(t, list)
                     else torch.from_numpy(t).cuda() for t in host)
        sizes = [c for c in fused.CLUSTER_SIZES
                 if q % c == 0 and fused.cluster_share(p, q, c) <= fused.CLUSTER_SHARE_MAX]
        first = fused.two_stage_cluster_fft(x, p, q, sizes[0], tabs)
        times = {c: [] for c in sizes}
        for c in sizes + sizes[::-1]:
            y = fused.two_stage_cluster_fft(x, p, q, c, tabs)
            err = ((y - first).abs().double().sum() / first.abs().double().sum()).item()
            if not err <= 1e-6:
                raise AssertionError(f"n={n} c={c}: {err:.3e} from c={sizes[0]}")
            times[c].append(ms(lambda: fused.two_stage_cluster_fft(x, p, q, c, tabs)))
        print(f"n={n} x {batch} ({p} x {q}), choose_cluster {fused.choose_cluster(n)}: "
              + "; ".join(f"c={c} {t[0]:.3f} / {t[1]:.3f} ms" for c, t in times.items()),
              flush=True)
        del x, y, first
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
