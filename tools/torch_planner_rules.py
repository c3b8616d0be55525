#!/usr/bin/env python3
"""Time the planner's three kernel decisions of the JAX package on the card:
the prime rule (R1), the hole band (R2) and the dense band (R3), each at its
sampled and held-out sizes, the current path against the candidate.

    python3 tools/torch_planner_rules.py [--rules R1,R2,R3] [--out FILE]
        [--device cuda] [--batch B] [--limit K] [--rounds 2]
    python3 tools/torch_planner_rules.py --check FILE

For each size n, at a batch that makes the (batch, n) complex64 tensor 256 -
512 MiB (--batch sets it), it times two paths, each in its rule's turns
(current, candidate, candidate, current; --rounds times), by CUDA events
around one call (median of 5 after 2 warm-up calls) and as queued device
time (10 calls queued behind a sleep kernel, median of 5), and torch.fft
once:

  R1  the primes whose recipe from the convolution-core rules
      (FftPlannerGpu._conv_prime_recipe) runs K14's four stages: that recipe
      against Bluesteins(n, m') on the fast form's inner m'
      (planner.routed_bluestein_inner: K15's tile form or K14's cluster
      passes).  Sampled: 40 of the Rader primes spread over [8192, 2^20],
      the median prime of each of the 24 most common Bluestein inner
      lengths, 746497, 196613, 88589; held out: 10 more Raders between
      those and the median primes of the next 10 inner lengths.
  R2  the odd composites of the hole band (executor.hole_band_inner under
      the JAX settings: n >= 8192, m = r*16384 <= 3.5 n) that large_pad
      serves: large_pad against Bluesteins(n, m) on the cluster passes.
      Sampled: 15625, 19683, 59049 and, for each r, the sizes of the lowest
      and the highest pad ratio; held out: 10 more spread over the band.
  R3  the 442 sizes of [257, 2048] that no route serves with the dense
      fallback off: the planner's path (the convolution cores) against
      dense_fft.  Sampled: 257, 514, 1031, 2042 and every 8th size; held
      out: 10 sizes between those.

Each path's first rows are held against torch.fft in complex128 (relative
mean error <= 1e-5).  It prints one table a rule (n, batch, the current
recipe and form with its ms, the candidate's with its ms, torch.fft's ms,
the ratio current / candidate by events and queued, the spread of the
turns, and the way the planner of this tree takes) and writes every row to
FILE (default build/planner_rules.json).  --check FILE reprints a
recorded run's tables on the CPU with the decisions of this tree's planner,
so that a rule put in code after the run is checked against it, held-out
sizes apart (PLANNER_RULES_GPU.md is that reprint of the H100 run).
--device cpu --limit 1 --batch 1 rehearses it on the plain versions (host
times, which say nothing of the card).  About 17 minutes on an H100, a
minute of it the census of R1's primes.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

C64 = np.complex64
RULES = ("R1", "R2", "R3")
#: the JAX package's hole-band settings (rustfft_tpu/config.py:183-185)
JAX_BAND = dict(bconv_misaligned=True, bconv_misaligned_min_n=8192,
                bconv_misaligned_max_pad=3.5)
#: a tensor of 2^25 complex64 points is 256 MiB
POINTS = 1 << 25
TOL = 1e-5


def batch_for(n: int) -> int:
    """The power of two that puts (batch, n) complex64 at 256 - 512 MiB."""
    return 1 << max(0, (-(-POINTS // n) - 1).bit_length())


def switched(fields: dict, fn):
    """fn() with the config fields set, each set back after."""
    from rustfft_tpu_torch import config

    old = {k: getattr(config, k) for k in fields}
    for k, v in fields.items():
        setattr(config, k, v)
    try:
        return fn()
    finally:
        for k, v in old.items():
            setattr(config, k, v)


def spread_pick(items, count, offset=0.0):
    """count items spread evenly over the list, at positions (i + offset)
    of count - 1 + ... (offset 0: both ends; 0.5: between them)."""
    if not items or count <= 0:
        return []
    if count == 1:
        return [items[len(items) // 2]]
    last = len(items) - 1
    return [items[min(last, round((i + offset) * last / (count - 1)))] for i in range(count)]


# ---- the samples ----


def primes_in(lo: int, hi: int) -> list:
    from torch_prime_cores import primes_in as sieve

    return sieve(lo, hi).tolist()


def r1_census(lo: int = 8192, hi: int = 1 << 20):
    """(Rader primes, {inner m: [Bluestein primes]}) of [lo, hi] whose recipe
    from the convolution-core rules runs K14's four stages."""
    from rustfft_tpu_torch import executor, recipes
    from rustfft_tpu_torch.planner import FftPlannerGpu

    planner = FftPlannerGpu(C64, device="cpu")
    raders, blues = [], {}
    for n in primes_in(lo, hi):
        recipe = planner._conv_prime_recipe(n)
        if not isinstance(recipe, (recipes.Raders, recipes.Bluesteins)):
            continue
        kind = "rader" if isinstance(recipe, recipes.Raders) else "bluestein"
        if executor.core_form(kind, recipe.inner.length, C64) != "K14 four stages":
            continue
        if kind == "rader":
            raders.append(n)
        else:
            blues.setdefault(recipe.inner.length, []).append(n)
    return raders, blues


def r1_samples():
    """(sampled, held out) primes of the prime rule."""
    raders, blues = r1_census()
    by_count = sorted(blues, key=lambda m: (-len(blues[m]), m))
    median = [blues[m][len(blues[m]) // 2] for m in by_count]
    fit = spread_pick(raders, 40) + median[:24] + [746497, 196613, 88589]
    held = spread_pick(raders, 10, 0.5) + median[24:34]
    fit = list(dict.fromkeys(fit))
    held = [n for n in dict.fromkeys(held) if n not in fit]
    print(f"R1 census: {len(raders)} Rader and {sum(map(len, blues.values()))} Bluestein primes "
          f"on K14's four stages, {len(blues)} Bluestein inner lengths; the 24 most common: "
          + ", ".join(f"{m}:{len(blues[m])}" for m in by_count[:24]), flush=True)
    return fit, held


def r2_band():
    """[(n, m)] of the hole band under the JAX settings."""
    from rustfft_tpu_torch import executor

    def band():
        return [(n, m) for n in range(8193, 131073, 2)
                if (m := executor.hole_band_inner(n, C64)) is not None]

    return switched(JAX_BAND, band)


def r2_samples():
    band = r2_band()
    inner = dict(band)
    fit = [15625, 19683, 59049]
    for r in (2, 4, 8, 16):
        sizes = [n for n, m in band if m == r * 16384]
        if sizes:
            fit += [sizes[-1], sizes[0]]  # lowest and highest pad ratio
    fit = list(dict.fromkeys(n for n in fit if n in inner))
    rest = [n for n, _ in band if n not in fit]
    held = spread_pick(rest, 10, 0.5)
    print(f"R2 band: {len(band)} odd composites, " + ", ".join(
        f"r={r}: {sum(1 for _, m in band if m == r * 16384)}" for r in (2, 4, 8, 16)), flush=True)
    return fit, held


def r3_band():
    """The sizes of [257, 2048] no route serves with the dense fallback off."""
    from rustfft_tpu_torch import route
    from rustfft_tpu_torch.ops.kernels import dense

    return switched(dict(dense_fallback_max_n=0), lambda: [
        n for n in range(257, 2049) if route(n, C64) is None and dense.dense_supported(n, C64)])


def r3_samples():
    band = r3_band()
    fit = list(dict.fromkeys([257, 514, 1031, 2042] + band[::8]))
    rest = [n for n in band if n not in fit]
    held = spread_pick(rest, 10, 0.5)
    primes = set(primes_in(257, 2048))
    print(f"R3 band: {len(band)} sizes, {sum(n in primes for n in band)} primes", flush=True)
    return fit, held


SAMPLES = {"R1": r1_samples, "R2": r2_samples, "R3": r3_samples}


# ---- the two paths of each rule ----


def describe(recipe) -> str:
    from rustfft_tpu_torch import executor, recipes

    if isinstance(recipe, (recipes.Raders, recipes.Bluesteins)):
        kind = "rader" if isinstance(recipe, recipes.Raders) else "bluestein"
        name = "Raders" if kind == "rader" else "Bluesteins"
        return f"{name}(m={recipe.inner.length}) {executor.core_form(kind, recipe.inner.length, C64)}"
    return type(recipe).__name__


def paths(rule: str, n: int, direction):
    """((current label, current fn), (candidate label, candidate fn))."""
    from rustfft_tpu_torch import FftPlanner, executor, recipes
    from rustfft_tpu_torch.ops.kernels import conv, dense, largepad
    from rustfft_tpu_torch.planner import FftPlannerGpu, routed_bluestein_inner

    if rule == "R1":
        old = FftPlannerGpu(C64, device="cpu")._conv_prime_recipe(n)
        m = routed_bluestein_inner(n, C64)
        new = recipes.Bluesteins(n, recipes.Dft(m))
        return ((describe(old), executor.build(old, direction, C64)),
                (describe(new), executor.build(new, direction, C64)))
    if rule == "R2":
        m = switched(JAX_BAND, lambda: executor.hole_band_inner(n, C64))
        return (("large_pad", largepad.make_largepad_fft_fn(n, direction, C64)),
                (f"Bluesteins(m={m}) K14 cluster passes",
                 conv.make_bluestein_fn(n, m, direction, C64)))
    plan = switched(dict(dense_fallback_max_n=0),
                    lambda: FftPlanner(C64, device="cpu").plan_fft(n, direction))
    return ((describe(plan.recipe), plan.process),
            ("dense_fft", dense.make_dense_fft_fn(n, direction, C64)))


def taken(rule: str, n: int) -> str:
    """The way this tree's planner takes at n: "candidate" or "current"."""
    from rustfft_tpu_torch import executor, recipes, route
    from rustfft_tpu_torch.planner import FftPlannerGpu, routed_bluestein_inner

    if rule == "R1":
        recipe = FftPlannerGpu(C64, device="cpu").design_fft_for_len(n)
        new = (isinstance(recipe, recipes.Bluesteins)
               and recipe.inner.length == routed_bluestein_inner(n, C64)
               and recipe != FftPlannerGpu(C64, device="cpu")._conv_prime_recipe(n))
    elif rule == "R2":
        new = route(n, C64) is None and executor.hole_band_inner(n, C64) is not None
    else:
        new = route(n, C64) == "dense"
    return "candidate" if new else "current"


# ---- timing ----


def make_timers(device):
    import torch

    if device.type != "cuda":
        def host_ms(fn, reps=3):
            times = []
            for _ in range(reps):
                start = time.perf_counter()
                fn()
                times.append((time.perf_counter() - start) * 1e3)
            return statistics.median(times)

        return host_ms, host_ms

    def event_ms(fn, reps=5, warmup=2):
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

    def queued_ms(fn, calls=10, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)  # cycles: longer than the host takes to queue the calls
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / calls)
        return statistics.median(times)

    return event_ms, queued_ms


def rel_err(got, want) -> float:
    return ((got.to(want.dtype) - want).abs().sum() / want.abs().sum()).item()


def measure(rule, n, batch, device, rounds, timers):
    """One row: both paths' labels and times, torch.fft's, and the error of
    each path's first rows against torch.fft in complex128."""
    import torch

    from rustfft_tpu_torch import FftDirection, executor

    event_ms, queued_ms = timers
    start = time.perf_counter()
    (old_label, old_fn), (new_label, new_fn) = paths(rule, n, FftDirection.FORWARD)
    gen = torch.Generator(device=device).manual_seed(n)
    x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=device)
    want = torch.fft.fft(x[:4].to(torch.complex128))
    errs = [rel_err(fn(x)[:4], want) for fn in (old_fn, new_fn)]
    for label, err in zip((old_label, new_label), errs):
        if not err <= TOL:
            raise AssertionError(f"{rule} n={n}: {label} relative mean error {err:.3e} > {TOL}")
    ev = {"current": [], "candidate": []}
    qu = {"current": [], "candidate": []}
    fns = {"current": lambda: old_fn(x), "candidate": lambda: new_fn(x)}
    for _ in range(rounds):
        for way in ("current", "candidate", "candidate", "current"):
            ev[way].append(event_ms(fns[way]))
            qu[way].append(queued_ms(fns[way]))
    fft_ms = event_ms(lambda: torch.fft.fft(x))
    row = dict(rule=rule, n=n, batch=batch, current=old_label, candidate=new_label,
               err_current=errs[0], err_candidate=errs[1], torch_fft_ms=fft_ms)
    for way in ("current", "candidate"):
        row[f"{way}_ms"] = statistics.median(ev[way])
        row[f"{way}_queued_ms"] = statistics.median(qu[way])
        row[f"{way}_turns_ms"] = ev[way]
        row[f"{way}_turns_queued_ms"] = qu[way]
    del x, want
    executor._CACHE.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - start
    return row


def spread(row) -> float:
    """The larger relative spread of the two ways' turns (queued device
    time; events on the CPU): (max - min) / median."""
    key = "turns_queued_ms" if row.get("device", "cuda") == "cuda" else "turns_ms"
    return max((max(t) - min(t)) / statistics.median(t)
               for t in (row[f"current_{key}"], row[f"candidate_{key}"]))


def faster(row) -> str:
    """The way measured faster by more than the spread in both timings, or
    "tie"."""
    s = spread(row)
    ev = row["current_ms"] / row["candidate_ms"]
    qu = row["current_queued_ms"] / row["candidate_queued_ms"]
    if min(ev, qu) > 1 + s:
        return "candidate"
    if max(ev, qu) < 1 / (1 + s):
        return "current"
    return "tie"


def print_table(rule, rows, header) -> None:
    from rustfft_tpu_torch import config

    print(f"\n{rule} ({header}); ms a call (events / queued); ratio = current / candidate")
    print("| set | n | batch | current | ms | candidate | ms | torch.fft | ratio | spread | faster "
          "| planner takes |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|")
    agree = Counter()
    for row in rows:
        took = taken(rule, row["n"])
        won = faster(row)
        agree[(row["set"], won == took or won == "tie")] += 1
        print(f"| {row['set']} | {row['n']} | {row['batch']} | {row['current']} | "
              f"{row['current_ms']:.3f} / {row['current_queued_ms']:.3f} | {row['candidate']} | "
              f"{row['candidate_ms']:.3f} / {row['candidate_queued_ms']:.3f} | "
              f"{row['torch_fft_ms']:.3f} | {row['current_ms'] / row['candidate_ms']:.2f} / "
              f"{row['current_queued_ms'] / row['candidate_queued_ms']:.2f} | "
              f"{spread(row):.3f} | {won} | {took} |")
    for s in ("fit", "held"):
        total = agree[(s, True)] + agree[(s, False)]
        if total:
            print(f"{rule} {s}: the planner of this tree takes the faster way (or a tie) at "
                  f"{agree[(s, True)]} of {total} sizes")
    print(f"config: dense_fallback_max_n={config.dense_fallback_max_n}, "
          f"bconv_misaligned={config.bconv_misaligned}, "
          f"bconv_misaligned_min_n={config.bconv_misaligned_min_n}, "
          f"bconv_misaligned_max_pad={config.bconv_misaligned_max_pad}", flush=True)


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip() or "no nvidia-smi output"
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rules", default=",".join(RULES))
    ap.add_argument("--out", default=os.path.join(REPO, "build", "planner_rules.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=0, help="batch (default: 256-512 MiB a tensor)")
    ap.add_argument("--limit", type=int, default=0, help="sizes a set (default: all)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--check", metavar="FILE", help="reprint a recorded run with this tree's "
                                                    "decisions, on the CPU")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    if args.check:
        with open(args.check) as f:
            record = json.load(f)
        print("# The planner rules on the card\n\n`python3 tools/torch_planner_rules.py --check "
              f"{os.path.basename(args.check)}`: a run recorded on {record['card']} (torch "
              f"{record['torch']}), with the decisions of this tree's planner.")
        for rule in RULES:
            rows = [r for r in record["rows"] if r["rule"] == rule]
            if rows:
                print_table(rule, rows, f"recorded on {record['card']}")
        return

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_planner_rules: no CUDA device (pass --device cpu to rehearse)")
    card = card_line() if device.type == "cuda" else "cpu (host times)"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    timers = make_timers(device)
    record = dict(card=card, torch=torch.__version__, rows=[])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t0 = time.perf_counter()
    for rule in args.rules.split(","):
        fit, held = SAMPLES[rule]()
        if args.limit:
            fit, held = fit[:args.limit], held[:args.limit]
        print(f"{rule}: sampled {fit}; held out {held} (t = {time.perf_counter() - t0:.1f} s)",
              flush=True)
        rows = []
        for set_, sizes in (("fit", fit), ("held", held)):
            for n in sizes:
                row = measure(rule, n, args.batch or batch_for(n), device, args.rounds, timers)
                row["set"], row["device"] = set_, device.type
                rows.append(row)
                record["rows"].append(row)
                print(f"  {rule} {set_} n={n}: {row['current']} {row['current_ms']:.3f} / "
                      f"{row['current_queued_ms']:.3f} ms, {row['candidate']} "
                      f"{row['candidate_ms']:.3f} / {row['candidate_queued_ms']:.3f} ms, "
                      f"torch.fft {row['torch_fft_ms']:.3f} ({row['seconds']:.1f} s)", flush=True)
                with open(args.out, "w") as f:
                    json.dump(record, f, indent=1)
        print_table(rule, rows, card)
    print(f"\nall rules {time.perf_counter() - t0:.1f} s -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
