#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rustfft_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no result line) on failure:

1. the card's name and power limit (nvidia-smi); build every CUDA kernel
   from rustfft_tpu_torch/csrc (one nvcc per source, in parallel) and time
   the build;
2. each kernel against its plain torch version on the card, forward and
   inverse, relative mean error <= 1e-5: the whole-transform kernels
   (lanepack, large), the one-pass convolution core at m = 1008 (the Rader
   1009 shape) and m = 3072 (the Bluestein 1234 shape) with its tables and
   conj off and on, the two-pass core stage by stage at m = 65536 (Rader
   65537: gathers, x0, sums, full output) and m = 16384 (Bluestein 7919),
   and the permutation at m = 1008 and 114688;
3. the main paths through the public entry,
   FftPlanner(np.complex64, device="cuda").plan_fft_forward/inverse(n)
   .process(x): n = 4096 at batch 8 and 16384, n = 2^20 at batch 1024
   (the flagship n; batch cut from 4096 so that input, intermediate and
   output fit the card), and the prime path at 1009 x 8192, 1234 x 8192,
   7919 x 4096 and 65537 x 512 (the JAX bench's rows and the 7919 cell).
   Every launch counter is set to 0 just before each run and read just
   after: each path must launch exactly its kernels.  Errors against a
   float64 numpy oracle on 4 rows and against torch.fft (an oracle only)
   on the whole batch, and the round trip divided by n against the input;
4. each kernel against its plain version again at the shape its main path
   launches it with (the same relative bound; max_abs_err covers phases 2
   and 4), then times from CUDA events (median of 7 after 2 warm-ups):
   each kernel against its plain version, every path against torch.fft, GF/s as
   5*n*log2(n) per transform, and 1234 three ways (whole-n Bluestein at
   m = 3072 and 2592, and MixedRadix(2, Raders(617))).

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

#: every ported kernel: (its source, the TPU kernel it replaces); conv_fft
#: serves K13 and K6, reported at the shape of each
KERNELS = {
    "lanepack_fft": ("rustfft_tpu_torch/csrc/lanepack.cu", "rustfft_tpu/ops/pallas/lanepack.py:250"),
    "large_col_stage": ("rustfft_tpu_torch/csrc/large.cu", "rustfft_tpu/ops/pallas/large.py:60"),
    "large_row_stage": ("rustfft_tpu_torch/csrc/large.cu", "rustfft_tpu/ops/pallas/large.py:241"),
    "conv_fft/K13": ("rustfft_tpu_torch/csrc/conv.cu", "rustfft_tpu/ops/pallas/conv.py:119"),
    "conv_fft/K6": ("rustfft_tpu_torch/csrc/conv.cu", "rustfft_tpu/ops/pallas/lanepack.py:501"),
    "conv_col_stage": ("rustfft_tpu_torch/csrc/conv_radix.cu",
                       "rustfft_tpu/ops/pallas/conv_radix.py:70"),
    "conv_row_stage": ("rustfft_tpu_torch/csrc/conv_radix.cu",
                       "rustfft_tpu/ops/pallas/conv_radix.py:70"),
    "permute": ("rustfft_tpu_torch/csrc/permute.cu", "rustfft_tpu/ops/pallas/permute.py:229"),
}


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
    from rustfft_tpu_torch import FftDirection, FftPlanner, executor, recipes, route
    from rustfft_tpu_torch.ops.bluestein import bluestein_tables
    from rustfft_tpu_torch.ops.kernels import _build, conv, conv_radix, lanepack, large, permute
    from rustfft_tpu_torch.ops.raders import raders_tables
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
    max_abs = {name: 0.0 for name in KERNELS}
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

    def note(name, got, want, what):
        check(what, rel_err(got, want))
        max_abs[name] = max(max_abs[name], (got - want).abs().max().item())

    def conv_tables(m, d, h, pre=None, post=None):
        radices = lanepack.choose_radices(m)
        roots, tws = lanepack.stage_tables(m, radices, d)
        extra = [None if t is None else torch.from_numpy(conv_radix.zero_extended(t, m)).to(dev)
                 for t in (h, pre, post)]
        return radices, (on_card(roots), on_card(tws), *extra)

    # the one-pass core: Rader 1009 (m = 1008, K6's shape) and Bluestein
    # 1234 (m = 3072, K13's shape), tables and conj off and on
    for m, n_blue, batch in ((1008, 504, 257), (3072, 1234, 257)):
        key = "conv_fft/K6" if m == 1008 else "conv_fft/K13"
        for d in directions:
            chirp, h_blue = bluestein_tables(n_blue, m, d)
            h_plain = raders_tables(1009, d)[2] if m == 1008 else h_blue
            for tables_on in (False, True):
                if tables_on:  # Bluestein n_blue: pre, post, conj, ragged n_in / n_out
                    radices, tables = conv_tables(m, d, h_blue, chirp, chirp)
                    n = n_blue
                else:
                    radices, tables = conv_tables(m, d, h_plain)
                    n = m
                x = signal(batch, n)
                got = conv.conv_fft(x, radices, tables, n, conj_out=tables_on)
                torch.cuda.synchronize()
                want = conv.conv_fft_plain(x, m, radices, tables, n, tables_on)
                note(key, got, want, f"conv_fft m={m} {radices} n={n} pre/post/conj={tables_on} "
                                     f"batch={batch} {d.name}")

    def two_pass_stages(x, m, d, tabs, batch_what, n_out, conj_out=False, x0=None,
                        full_out=False):
        """The two-pass core stage by stage, each kernel against its plain
        version on the kernel's own input."""
        p, q = conv_radix.choose_split(m)
        col = (on_card(tabs["col"][0]), on_card(tabs["col"][1]),
               torch.from_numpy(tabs["col"][2]).to(dev))
        row = (on_card(tabs["row"][0]), on_card(tabs["row"][1]))
        t = {k: None if tabs[k] is None else torch.from_numpy(tabs[k]).to(dev)
             for k in ("h", "pre", "post", "perm", "scatter")}
        a, part = conv_radix.conv_col_stage(x, p, q, col, pre=t["pre"], perm=t["perm"],
                                            emit_sum=full_out)
        torch.cuda.synchronize()
        a_p, part_p = conv_radix.conv_col_stage_plain(x, p, q, col, t["pre"], t["perm"], full_out)
        note("conv_col_stage", a, a_p, f"conv_col_stage pass 1 {batch_what} {d.name}")
        if full_out:
            check(f"conv_col_stage partial sums {batch_what} {d.name}", rel_err(part, part_p))
        z = conv_radix.conv_row_stage(a, q, p, row, m, h=t["h"])
        torch.cuda.synchronize()
        note("conv_row_stage", z, conv_radix.conv_row_stage_plain(a, q, p, row, m, h=t["h"]),
             f"conv_row_stage pass 1 {batch_what} {d.name}")
        b, _ = conv_radix.conv_col_stage(z, p, q, col)
        torch.cuda.synchronize()
        note("conv_col_stage", b, conv_radix.conv_col_stage_plain(z, p, q, col)[0],
             f"conv_col_stage pass 2 {batch_what} {d.name}")
        kw = dict(conj_out=conj_out, post=t["post"], x0=x0, scatter=t["scatter"],
                  partials=part if full_out else None)
        out = conv_radix.conv_row_stage(b, q, p, row, n_out, **kw)
        torch.cuda.synchronize()
        note("conv_row_stage", out, conv_radix.conv_row_stage_plain(b, q, p, row, n_out, **kw),
             f"conv_row_stage pass 2 {batch_what} {d.name}")
        return out

    # the two-pass core: Rader 65537 (m = 65536, gathers, x0, sums and the
    # DC-first output fused) and Bluestein 7919 (m = 16384)
    for d in directions:
        p_prime = 65537
        perm_in, inv_gather, b_fft = raders_tables(p_prime, d)
        tabs = conv_radix.radix_conv_tables(p_prime - 1, d, h=b_fft, in_perm=perm_in - 1,
                                            out_perm=inv_gather)
        x = signal(3, p_prime)
        out = two_pass_stages(x[:, 1:].contiguous(), p_prime - 1, d, tabs,
                              "m=65536 Rader batch=3", p_prime - 1, conj_out=True,
                              x0=x[:, 0].contiguous(), full_out=True)
        check(f"Rader 65537 two-pass core vs float64 oracle {d.name}",
              rel_err(out.cpu().to(torch.complex128),
                      torch.from_numpy(host_dft(x.cpu().numpy(), d))))
        n, m = 7919, 16384
        chirp, h_fft = bluestein_tables(n, m, d)
        tabs = conv_radix.radix_conv_tables(m, d, h=h_fft, pre=chirp, post=chirp)
        x = signal(3, n)
        out = two_pass_stages(x, m, d, tabs, "m=16384 Bluestein 7919 batch=3", n, conj_out=True)
        check(f"Bluestein 7919 two-pass core vs float64 oracle {d.name}",
              rel_err(out.cpu().to(torch.complex128),
                      torch.from_numpy(host_dft(x.cpu().numpy(), d))))
    for m, batch in ((1008, 257), (114688, 5)):
        idx = torch.from_numpy(permute.permutation_index(
            np.random.default_rng(m).permutation(m))).to(dev)
        x = signal(batch, m)
        got = permute.permute(x, idx)
        torch.cuda.synchronize()
        note("permute", got, permute.permute_plain(x, idx), f"permute m={m} batch={batch}")
    del x, got, out
    free()

    # ---- phase 3: the main path through the public entry ----
    print("phase 3: main path, FftPlanner(np.complex64, device='cuda')", flush=True)
    counters = {"lanepack_fft": lanepack.lanepack_fft,
                "large_col_stage": large.large_col_stage,
                "large_row_stage": large.large_row_stage,
                "conv_fft": conv.conv_fft,
                "conv_col_stage": conv_radix.conv_col_stage,
                "conv_row_stage": conv_radix.conv_row_stage,
                "permute": permute.permute}
    planner = FftPlanner(np.complex64, device="cuda")
    assert route(4096, np.complex64) == "lanepack" and route(1 << 20, np.complex64) == "large"
    main_launches = {name: 0 for name in counters}
    path_launches = {}

    def run_counted(fn, x, expected, what, n):
        """fn(x) with every counter set to 0 just before and read just after:
        exactly the expected launches."""
        for counter in counters.values():
            counter.launches = 0
        y = fn(x)
        torch.cuda.synchronize()
        got = {name: counter.launches for name, counter in counters.items()}
        want = {name: expected.get(name, 0) for name in counters}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, expected {want}")
        for name, count in got.items():
            main_launches[name] += count
            path_launches.setdefault(n, {}).setdefault(name, 0)
            path_launches[n][name] += count
        return y

    def oracle_rows(x, got, direction, what):
        ref = host_dft(x[:4].cpu().numpy(), direction)
        out = got[:4].cpu().numpy().astype(np.complex128)
        check(f"{what} vs float64 oracle (4 rows)",
              float(np.mean(np.abs(out - ref)) / np.mean(np.abs(ref))))

    paths = (
        (4096, 8, {"lanepack_fft": 1}),
        (4096, 16384, {"lanepack_fft": 1}),
        (1 << 20, 1024, {"large_col_stage": 1, "large_row_stage": 1}),
        (1009, 8192, {"conv_fft": 1, "permute": 2}),
        (1234, 8192, {"conv_fft": 1}),
        (7919, 4096, {"conv_col_stage": 2, "conv_row_stage": 2}),
        (65537, 512, {"conv_col_stage": 2, "conv_row_stage": 2}),
    )
    for n, batch, expected in paths:
        fwd = planner.plan_fft_forward(n)
        inv = planner.plan_fft_inverse(n)
        x = signal(batch, n)
        what = f"n={n} batch={batch} ({type(fwd.recipe).__name__})"
        y = run_counted(fwd.process, x, expected, f"forward {what}", n)
        if y.shape != x.shape or y.dtype != torch.complex64 or y.device != x.device:
            raise AssertionError(f"{what}: output {tuple(y.shape)} {y.dtype} on {y.device}")
        if not bool(torch.isfinite(torch.view_as_real(y)).all()):
            raise AssertionError(f"{what}: non-finite output")
        oracle_rows(x, y, FftDirection.FORWARD, f"forward {what}")
        check(f"forward {what} vs torch.fft",
              rel_err_chunked(y, lambda i, j: torch.fft.fft(x[i:j])))
        z = run_counted(inv.process, y, expected, f"inverse {what}", n)
        oracle_rows(y, z, FftDirection.INVERSE, f"inverse {what}")
        check(f"round trip / n {what} vs input", rel_err_chunked(z, lambda i, j: x[i:j] * n))
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
        del x, y, z
        free()
        torch.cuda.reset_peak_memory_stats()
    print(f"  launches on the main paths: {main_launches}", flush=True)
    for name, count in main_launches.items():
        if count == 0:
            raise AssertionError(f"{name} was not launched on the main paths")

    # ---- phase 4: times ----
    print(f"phase 4: times on {card} (CUDA events, median of 7)", flush=True)
    ms = {}
    n, batch = 4096, 16384
    x = signal(batch, n)
    default = lanepack.choose_radices(n)
    for radices in (default, (256, 16)):
        roots, tws = lanepack.stage_tables(n, radices, FftDirection.FORWARD)
        tables = (on_card(roots), on_card(tws))
        if radices == default:
            note("lanepack_fft", lanepack.lanepack_fft(x, radices, tables),
                 lanepack.lanepack_fft_plain(x, radices, tables),
                 f"lanepack_fft n={n} {radices} batch={batch} (the main path's shape)")
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
    note("large_col_stage", a, large.large_col_stage_plain(x, p, q, col),
         f"large_col_stage n={n} P={p} batch={batch}")
    note("large_row_stage", large.large_row_stage(a, q, p, row),
         large.large_row_stage_plain(a, q, p, row), f"large_row_stage n={n} Q={q} batch={batch}")
    free()
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

    # the one-pass core and the permutation at the prime path's shapes
    for key, m, n in (("conv_fft/K6", 1008, 1008), ("conv_fft/K13", 3072, 1234)):
        tables_on = m != n  # K6: the Rader 1009 core; K13: the Bluestein 1234 core
        if tables_on:
            chirp, h_fft = bluestein_tables(n, m, FftDirection.FORWARD)
            radices, tables = conv_tables(m, FftDirection.FORWARD, h_fft, chirp, chirp)
        else:
            radices, tables = conv_tables(m, FftDirection.FORWARD,
                                          raders_tables(m + 1, FftDirection.FORWARD)[2])
        x = signal(8192, n)
        note(key, conv.conv_fft(x, radices, tables, n, tables_on),
             conv.conv_fft_plain(x, m, radices, tables, n, tables_on),
             f"conv_fft m={m} {radices} n={n} batch=8192 (the main path's shape)")
        k = median_ms(lambda: conv.conv_fft(x, radices, tables, n, tables_on))
        plain = median_ms(lambda: conv.conv_fft_plain(x, m, radices, tables, n, tables_on))
        ms[key] = (k, plain)
        print(f"  conv_fft m={m} {radices} n={n} batch=8192: kernel {k:.3f} ms, plain {plain:.3f} ms",
              flush=True)
    idx = torch.from_numpy(permute.permutation_index(
        raders_tables(1009, FftDirection.FORWARD)[0] - 1)).to(dev)
    x = signal(8192, 1008)
    note("permute", permute.permute(x, idx), permute.permute_plain(x, idx),
         "permute m=1008 batch=8192 (the main path's shape)")
    k = median_ms(lambda: permute.permute(x, idx))
    plain = median_ms(lambda: permute.permute_plain(x, idx))
    ms["permute"] = (k, plain)
    print(f"  permute m=1008 batch=8192 (Rader 1009 input gather): kernel {k:.3f} ms, "
          f"plain {plain:.3f} ms", flush=True)
    del x
    free()

    # the two-pass core's stages at the Bluestein 7919 x 4096 shape, against
    # their plain versions
    n, m = 7919, 16384
    chirp, h_fft = bluestein_tables(n, m, FftDirection.FORWARD)
    tabs = conv_radix.radix_conv_tables(m, FftDirection.FORWARD, h=h_fft, pre=chirp, post=chirp)
    two_pass_stages(signal(4096, n), m, FftDirection.FORWARD, tabs,
                    "m=16384 Bluestein 7919 batch=4096 (the main path's shape)", n, conj_out=True)
    free()

    # the two-pass core's stages at the Rader 65537 x 512 shape
    m, batch = 65536, 512
    p, q = conv_radix.choose_split(m)
    perm_in, inv_gather, b_fft = raders_tables(m + 1, FftDirection.FORWARD)
    tabs = conv_radix.radix_conv_tables(m, FftDirection.FORWARD, h=b_fft, in_perm=perm_in - 1,
                                        out_perm=inv_gather)
    col = (on_card(tabs["col"][0]), on_card(tabs["col"][1]), torch.from_numpy(tabs["col"][2]).to(dev))
    row = (on_card(tabs["row"][0]), on_card(tabs["row"][1]))
    perm = torch.from_numpy(tabs["perm"]).to(dev)
    scatter = torch.from_numpy(tabs["scatter"]).to(dev)
    h = torch.from_numpy(tabs["h"]).to(dev)
    x = signal(batch, m)
    x0 = signal(batch, 1).reshape(-1)
    a, part = conv_radix.conv_col_stage(x, p, q, col, perm=perm, emit_sum=True)
    a_p, part_p = conv_radix.conv_col_stage_plain(x, p, q, col, None, perm, True)
    what = f"m={m} Rader batch={batch} (the main path's shape)"
    note("conv_col_stage", a, a_p, f"conv_col_stage pass 1 {what}")
    check(f"conv_col_stage partial sums {what}", rel_err(part, part_p))
    del a_p, part_p
    z = conv_radix.conv_row_stage(a, q, p, row, m, h=h)
    note("conv_row_stage", z, conv_radix.conv_row_stage_plain(a, q, p, row, m, h=h),
         f"conv_row_stage pass 1 {what}")
    b, _ = conv_radix.conv_col_stage(z, p, q, col)
    note("conv_col_stage", b, conv_radix.conv_col_stage_plain(z, p, q, col)[0],
         f"conv_col_stage pass 2 {what}")
    kw = dict(conj_out=True, x0=x0, scatter=scatter, partials=part)
    note("conv_row_stage", conv_radix.conv_row_stage(b, q, p, row, m, **kw),
         conv_radix.conv_row_stage_plain(b, q, p, row, m, **kw), f"conv_row_stage pass 2 {what}")
    del z, b
    free()
    k = median_ms(lambda: conv_radix.conv_col_stage(x, p, q, col, perm=perm, emit_sum=True))
    plain = median_ms(lambda: conv_radix.conv_col_stage_plain(x, p, q, col, None, perm, True))
    ms["conv_col_stage"] = (k, plain)
    no_gather = median_ms(lambda: conv_radix.conv_col_stage(x, p, q, col))
    print(f"  conv_col_stage m={m} P={p} batch={batch}: kernel {k:.3f} ms with the Rader gather "
          f"and sums, {no_gather:.3f} ms plain load; plain version {plain:.3f} ms", flush=True)
    k1 = median_ms(lambda: conv_radix.conv_row_stage(a, q, p, row, m, h=h))
    k = median_ms(lambda: conv_radix.conv_row_stage(a, q, p, row, m, **kw))
    plain = median_ms(lambda: conv_radix.conv_row_stage_plain(a, q, p, row, m, **kw))
    ms["conv_row_stage"] = (k, plain)
    print(f"  conv_row_stage m={m} Q={q} batch={batch}: kernel {k:.3f} ms with the scatter and "
          f"full output, {k1:.3f} ms with the H epilogue; plain version {plain:.3f} ms", flush=True)
    del x, a, part
    free()

    # every prime-path size against torch.fft
    for n, batch in ((1009, 8192), (1234, 8192), (7919, 4096), (65537, 512)):
        x = signal(batch, n)
        plan = planner.plan_fft_forward(n)
        path = median_ms(lambda: plan.process(x))
        ref = median_ms(lambda: torch.fft.fft(x))
        print(f"  prime path n={n} batch={batch} ({type(plan.recipe).__name__}): {path:.3f} ms "
              f"({gflops(n, batch, path):.0f} GF/s); torch.fft {ref:.3f} ms "
              f"({gflops(n, batch, ref):.0f} GF/s)", flush=True)
        del x
        free()
    # 1234 three ways, each built through executor.build
    x = signal(8192, 1234)
    for what, recipe in (
        ("whole-n Bluestein m=3072", recipes.Bluesteins(1234, recipes.Dft(3072))),
        ("whole-n Bluestein m=2592", recipes.Bluesteins(1234, recipes.Dft(2592))),
        ("MixedRadix(2, Raders(617))",
         recipes.MixedRadix(recipes.Dft(2), recipes.Raders(recipes.Dft(616)))),
    ):
        fn = executor.build(recipe, FftDirection.FORWARD, np.complex64)
        check(f"1234 as {what} vs torch.fft", rel_err(fn(x), torch.fft.fft(x)))
        t = median_ms(lambda: fn(x))
        print(f"  1234 x 8192 as {what}: {t:.3f} ms ({gflops(1234, 8192, t):.0f} GF/s)", flush=True)
    del x
    free()

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": (main_launches[name.split("/")[0]] if "/" not in name
                      else path_launches[1009 if name.endswith("K6") else 1234]["conv_fft"]),
         "max_abs_err": max_abs[name], "ms": ms[name][0], "plain_ms": ms[name][1]}
        for name, (src, replaces) in KERNELS.items()
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
