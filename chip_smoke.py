#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rustfft_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no result line) on failure:

1. the card's name and power limit (nvidia-smi); build every CUDA kernel of
   the main path from rustfft_tpu_torch/csrc with nvcc and time the build;
2. each kernel against its plain torch version on the card, forward and
   inverse, relative mean error <= 1e-5;
3. the main path through the public entry,
   FftPlanner(np.complex64, device="cuda").plan_fft_forward/inverse(n)
   .process(x): n = 4096 at batch 8 and 16384, n = 2^20 at batch 1024
   (the flagship n; batch cut from 4096 so that input, intermediate and
   output fit the card), with the kernels' launch counters set to 0 before
   and read after, errors against a float64 numpy oracle on 4 rows and
   against torch.fft (an oracle only) on the whole batch, and the round trip
   divided by n against the input;
4. times from CUDA events (median of 7 after 2 warm-ups): each kernel
   against its plain version, the main path against torch.fft, GF/s as
   5*n*log2(n) per transform.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 1e-5
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().double().sum() / want.abs().double().sum()).item()


def rel_err_chunked(got: torch.Tensor, want_rows, rows: int = 64) -> float:
    """Relative mean error of got (B, n) against want_rows(i, j) -> rows i:j."""
    num = den = 0.0
    for i in range(0, got.shape[0], rows):
        want = want_rows(i, i + rows)
        num += (got[i : i + rows] - want).abs().double().sum().item()
        den += want.abs().double().sum().item()
    return num / den


def check(what: str, value: float, bound: float = TOL) -> None:
    print(f"  {what}: {value:.3e} (bound {bound:.0e})", flush=True)
    if not value <= bound:
        raise AssertionError(f"{what}: {value:.3e} > {bound:.0e}")


def median_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gflops(n: int, batch: int, ms: float) -> float:
    return 5 * n * math.log2(n) * batch / (ms * 1e6)


def free() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: needs an NVIDIA GPU")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rustfft_tpu_torch import FftDirection, FftPlanner, route
    from rustfft_tpu_torch.ops.kernels import _build, lanepack, large
    from rustfft_tpu_torch.twiddles import host_dft

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def signal(batch: int, n: int) -> torch.Tensor:
        return torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)

    def on_card(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    directions = (FftDirection.FORWARD, FftDirection.INVERSE)

    # ---- phase 1: build ----
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    start = time.perf_counter()
    _build.load()
    print(f"phase 1: kernels built from {_build.SRC_DIR.name}/ in "
          f"{time.perf_counter() - start:.1f} s (nvcc {_build.last_build_seconds:.1f} s) "
          f"-> {_build.library_path()}", flush=True)

    # ---- phase 2: each kernel against its plain version on the card ----
    print("phase 2: kernels against their plain torch versions", flush=True)
    max_abs = {"lanepack_fft": 0.0, "large_col_stage": 0.0, "large_row_stage": 0.0}
    for n, batch, radices in ((4096, 257, lanepack.choose_radices(4096)),
                              (4096, 257, (256, 16)),
                              (3888, 130, lanepack.choose_radices(3888))):
        x = signal(batch, n)
        for d in directions:
            roots, tws = lanepack.stage_tables(n, radices, d)
            tables = (on_card(roots), on_card(tws))
            got = lanepack.lanepack_fft(x, radices, tables)
            torch.cuda.synchronize()
            want = lanepack.lanepack_fft_plain(x, radices, tables)
            check(f"lanepack_fft n={n} {radices} batch={batch} {d.name}", rel_err(got, want))
            max_abs["lanepack_fft"] = max(max_abs["lanepack_fft"], (got - want).abs().max().item())
    for n, batch in ((1 << 20, 4), (32768, 3)):
        p, q1, q2 = large.choose_pqq(n)
        q = q1 * q2
        x = signal(batch, n)
        for d in directions:
            r, t, outer = large.col_tables(p, q, d)
            col = (on_card(r), on_card(t), torch.from_numpy(outer).to(dev))
            r, t = large.row_tables(q, d)
            row = (on_card(r), on_card(t))
            a = large.large_col_stage(x, p, q, col)
            torch.cuda.synchronize()
            a_plain = large.large_col_stage_plain(x, p, q, col)
            check(f"large_col_stage n={n} P={p} {large.stage_radices(p)} batch={batch} {d.name}",
                  rel_err(a, a_plain))
            y = large.large_row_stage(a, q, p, row)
            torch.cuda.synchronize()
            y_plain = large.large_row_stage_plain(a, q, p, row)
            check(f"large_row_stage n={n} Q={q} {large.stage_radices(q)} batch={batch} {d.name}",
                  rel_err(y, y_plain))
            max_abs["large_col_stage"] = max(max_abs["large_col_stage"], (a - a_plain).abs().max().item())
            max_abs["large_row_stage"] = max(max_abs["large_row_stage"], (y - y_plain).abs().max().item())
    del x, a, a_plain, y, y_plain
    free()

    # ---- phase 3: the main path through the public entry ----
    print("phase 3: main path, FftPlanner(np.complex64, device='cuda')", flush=True)
    counters = {"lanepack_fft": lanepack.lanepack_fft,
                "large_col_stage": large.large_col_stage,
                "large_row_stage": large.large_row_stage}
    for fn in counters.values():
        fn.launches = 0
    planner = FftPlanner(np.complex64, device="cuda")
    assert route(4096, np.complex64) == "lanepack" and route(1 << 20, np.complex64) == "large"

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    def expect_rise(before, names):
        after = launches()
        for name in counters:
            rise = after[name] - before[name]
            want = 1 if name in names else 0
            if rise != want:
                raise AssertionError(f"{name} launched {rise} times, expected {want}")

    def oracle_rows(x, got, direction, what):
        ref = host_dft(x[:4].cpu().numpy(), direction)
        out = got[:4].cpu().numpy().astype(np.complex128)
        check(f"{what} vs float64 oracle (4 rows)",
              float(np.mean(np.abs(out - ref)) / np.mean(np.abs(ref))))

    for n, batch, names in ((4096, 8, ("lanepack_fft",)),
                            (4096, 16384, ("lanepack_fft",)),
                            (1 << 20, 1024, ("large_col_stage", "large_row_stage"))):
        fwd = planner.plan_fft_forward(n)
        inv = planner.plan_fft_inverse(n)
        x = signal(batch, n)
        before = launches()
        y = fwd.process(x)
        torch.cuda.synchronize()
        expect_rise(before, names)
        what = f"n={n} batch={batch}"
        if y.shape != x.shape or y.dtype != torch.complex64 or y.device != x.device:
            raise AssertionError(f"{what}: output {tuple(y.shape)} {y.dtype} on {y.device}")
        if not bool(torch.isfinite(torch.view_as_real(y)).all()):
            raise AssertionError(f"{what}: non-finite output")
        oracle_rows(x, y, FftDirection.FORWARD, f"forward {what}")
        check(f"forward {what} vs torch.fft",
              rel_err_chunked(y, lambda i, j: torch.fft.fft(x[i:j])))
        before = launches()
        z = inv.process(y)
        torch.cuda.synchronize()
        expect_rise(before, names)
        oracle_rows(y, z, FftDirection.INVERSE, f"inverse {what}")
        check(f"round trip / n {what} vs input", rel_err_chunked(z, lambda i, j: x[i:j] * n))
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
        del x, y, z
        free()
        torch.cuda.reset_peak_memory_stats()
    main_launches = launches()
    print(f"  launches on the main path: {main_launches}", flush=True)
    for name, count in main_launches.items():
        if count == 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # ---- phase 4: times ----
    print(f"phase 4: times on {card} (CUDA events, median of 7)", flush=True)
    ms = {}
    n, batch = 4096, 16384
    x = signal(batch, n)
    default = lanepack.choose_radices(n)
    for radices in (default, (256, 16)):
        roots, tws = lanepack.stage_tables(n, radices, FftDirection.FORWARD)
        tables = (on_card(roots), on_card(tws))
        k = median_ms(lambda: lanepack.lanepack_fft(x, radices, tables))
        plain = median_ms(lambda: lanepack.lanepack_fft_plain(x, radices, tables))
        print(f"  lanepack_fft n={n} {radices} batch={batch}: kernel {k:.3f} ms "
              f"({gflops(n, batch, k):.0f} GF/s), plain {plain:.3f} ms", flush=True)
        if radices == default:
            ms["lanepack_fft"] = (k, plain)
    plan = planner.plan_fft_forward(n)
    path = median_ms(lambda: plan.process(x))
    ref = median_ms(lambda: torch.fft.fft(x))
    print(f"  main path n={n} batch={batch}: {path:.3f} ms ({gflops(n, batch, path):.0f} GF/s); "
          f"torch.fft {ref:.3f} ms ({gflops(n, batch, ref):.0f} GF/s)", flush=True)
    del x
    free()

    n = 1 << 20
    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    r, t, outer = large.col_tables(p, q, FftDirection.FORWARD)
    col = (on_card(r), on_card(t), torch.from_numpy(outer).to(dev))
    r, t = large.row_tables(q, FftDirection.FORWARD)
    row = (on_card(r), on_card(t))
    batch = 64  # the bench row: the plain versions' intermediates fit here
    x = signal(batch, n)
    a = large.large_col_stage(x, p, q, col)
    k = median_ms(lambda: large.large_col_stage(x, p, q, col))
    plain = median_ms(lambda: large.large_col_stage_plain(x, p, q, col))
    ms["large_col_stage"] = (k, plain)
    print(f"  large_col_stage n={n} P={p} batch={batch}: kernel {k:.3f} ms, plain {plain:.3f} ms",
          flush=True)
    k = median_ms(lambda: large.large_row_stage(a, q, p, row))
    plain = median_ms(lambda: large.large_row_stage_plain(a, q, p, row))
    ms["large_row_stage"] = (k, plain)
    print(f"  large_row_stage n={n} Q={q} {large.stage_radices(q)} batch={batch}: kernel {k:.3f} ms, "
          f"plain {plain:.3f} ms", flush=True)
    del x, a
    free()
    for batch in (64, 1024):
        x = signal(batch, n)
        plan = planner.plan_fft_forward(n)
        path = median_ms(lambda: plan.process(x), reps=5)
        ref = median_ms(lambda: torch.fft.fft(x), reps=5)
        print(f"  main path n={n} batch={batch}: {path:.3f} ms ({gflops(n, batch, path):.0f} GF/s); "
              f"torch.fft {ref:.3f} ms ({gflops(n, batch, ref):.0f} GF/s)", flush=True)
        del x
        free()

    sources = {"lanepack_fft": ("rustfft_tpu_torch/csrc/lanepack.cu",
                                "rustfft_tpu/ops/pallas/lanepack.py:250"),
               "large_col_stage": ("rustfft_tpu_torch/csrc/large.cu",
                                   "rustfft_tpu/ops/pallas/large.py:60"),
               "large_row_stage": ("rustfft_tpu_torch/csrc/large.cu",
                                   "rustfft_tpu/ops/pallas/large.py:241")}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": main_launches[name], "max_abs_err": max_abs[name],
         "ms": ms[name][0], "plain_ms": ms[name][1]}
        for name, (src, replaces) in sources.items()
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
