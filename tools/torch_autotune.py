#!/usr/bin/env python3
"""Time each size's kernel route against the torch recipe tree on the card:
the PyTorch/CUDA counterpart of tools/autotune.py.

    python3 tools/torch_autotune.py [n ...] [--device cuda] [--batch B] [--reps 7]

At each n (default 1024 .. 2^20, tools/autotune.py's list; batch 2^26 / n,
tools/autotune.py's rule) it times `plan.process(x)` on a (batch, n)
complex64 tensor on the device:

  auto         the planner's path (config.kernels = "auto");
  <switch>     the same with each kernel-variant switch that n's path reads
               set to its other value (large_gauss and large_blocks2d on the
               large route; conv_radix_gauss, and for a Rader rader_in_shift
               and rader_full_out, on the two-pass convolution core);
  tree         the torch recipe tree (config.kernels = "off");
  torch.fft    torch.fft.fft on the same tensor, the baseline;

each the median of --reps runs after two warm-up calls, from CUDA events on
the card (host clock on the cpu, whose numbers say nothing of the card).
The JAX tool recommends config.pallas_min_n; the port routes structurally
and has no such constant, so in its place this prints, for each route, the
smallest n where its kernel beats the tree, and flags every n where the tree
or a non-default switch is faster than the planner's path.  It changes no
config: every field is set back after its run.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from rustfft_tpu_torch import FftPlanner, config, recipes, route  # noqa: E402

SIZES = (1024, 2048, 4096, 8192, 16384, 65536, 262144, 1 << 20)
#: points a timed call transforms (tools/autotune.py: batch = 2^26 / n)
POINTS = 1 << 26


def switches_read(n: int):
    """[(switch, its non-default value)] for each kernel-variant switch that
    the planner's path at n reads."""
    from rustfft_tpu_torch.ops.kernels import conv, conv_radix, convlarge

    c64 = np.complex64
    name = route(n, c64)
    if name == "large":
        return [("large_gauss", True), ("large_blocks2d", True)]
    if name is not None:
        return []
    recipe = FftPlanner(c64, device="cpu").design_fft_for_len(n)
    if not isinstance(recipe, (recipes.Raders, recipes.Bluesteins)):
        return []
    m = recipe.inner.length
    two_pass = (not conv.conv_supported(m, c64) and conv_radix.radix_conv_supported(m, c64)
                and not (isinstance(recipe, recipes.Bluesteins)
                         and convlarge.bconv_supported(m, c64)))
    if not two_pass:
        return []
    if isinstance(recipe, recipes.Raders):
        return [("conv_radix_gauss", True), ("rader_in_shift", True), ("rader_full_out", False)]
    return [("conv_radix_gauss", True)]


def median_ms(fn, device, reps: int) -> float:
    """Median ms of fn() over reps runs after two warm-up calls: CUDA events
    on the card, the host clock on the cpu."""
    import torch

    on_card = device.type == "cuda"
    for _ in range(2):
        fn()
    if on_card:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_path(n, x, device, reps, **fields) -> float:
    """ms of the planner's path at n with the config fields set (set back
    after)."""
    old = {k: getattr(config, k) for k in fields}
    for k, v in fields.items():
        setattr(config, k, v)
    try:
        plan = FftPlanner(np.complex64, device=device).plan_fft_forward(n)
        return median_ms(lambda: plan.process(x), device, reps)
    finally:
        for k, v in old.items():
            setattr(config, k, v)


def device_line(device) -> str:
    import torch

    if device.type != "cuda":
        return "device: cpu (host clock; not a measurement of the card)"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    return (f"card: {card} ({torch.cuda.get_device_name(device)}); torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}; CUDA events, median")


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None, help="default 2^26 / n")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_autotune: no CUDA GPU; pass --device cpu")
    print(f"# {device_line(device)} of {args.reps} after 2 warm-ups; ms a call", flush=True)

    rows = []
    gen = torch.Generator(device=device).manual_seed(0)
    for n in args.sizes or SIZES:
        batch = args.batch or max(1, POINTS // n)
        x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=device)
        name = route(n, np.complex64)
        row = {"auto": time_path(n, x, device, args.reps)}
        for switch, value in switches_read(n):
            row[f"{switch}={value}"] = time_path(n, x, device, args.reps, **{switch: value})
        row["tree"] = time_path(n, x, device, args.reps, kernels="off")
        row["torch.fft"] = median_ms(lambda: torch.fft.fft(x), device, args.reps)
        rows.append((n, batch, name, row))
        print(f"n={n:>8} batch={batch:>6} route={name or 'none'}: "
              + "  ".join(f"{k}={v:.3f}" for k, v in row.items()), flush=True)
        del x
        if device.type == "cuda":
            torch.cuda.empty_cache()

    print("\n# the smallest n where each route's kernel beats the tree:")
    for name in dict.fromkeys(r[2] for r in rows if r[2] is not None):
        wins = [n for n, _, rn, row in rows if rn == name and row["auto"] < row["tree"]]
        print(f"  {name}: {min(wins) if wins else 'none of the sizes timed'}")
    flags = []
    for n, _, name, row in rows:
        faster = [k for k, v in row.items() if k not in ("auto", "torch.fft") and v < row["auto"]]
        if faster:
            flags.append(f"  n={n} ({name or 'none'}): faster than the planner's path: "
                         + ", ".join(f"{k} {row[k]:.3f} < {row['auto']:.3f}" for k in faster))
    print("# flags (the tree or a non-default switch faster than the planner's path):")
    print("\n".join(flags) if flags else "  none")


if __name__ == "__main__":
    main()
