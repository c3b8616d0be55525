#!/usr/bin/env python3
"""Time the planner's kernel decisions of the JAX package on the card: the
prime rule (R1), the hole band (R2), the dense band (R3), the composite
rule (R4) and the executor's core rule above 2^20 (R5), each at its
sampled and held-out sizes, the current path against the candidate (and
R4's split).

    python3 tools/torch_planner_rules.py [--rules R1,R2,R3,R4,R5] [--out FILE]
        [--device cuda] [--batch B] [--limit K] [--rounds 2]
        [--sets fit,held] [--held-seed S] [--held-per-way K]
        [--fit-sizes N,N,...] [--held-sizes N,N,...]
    python3 tools/torch_planner_rules.py --costs | --glue [--out FILE]
    python3 tools/torch_planner_rules.py --fit COSTS [COSTS ...] GLUE > rustfft_tpu_torch/split_costs.py
    python3 tools/torch_planner_rules.py --check FILE [FILE ...]

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
  R4  the 64210 composites of [8192, 2^20) that no route serves and whose
      whole-n Bluestein (FftPlannerGpu._conv_composite_recipe) runs K14's
      four stages (torch_prime_cores.four_stage_composites, 35 inner
      lengths): that recipe against Bluesteins(n, m') on the fast form's
      inner (as R1) and against the near-balanced split
      (FftPlannerGpu._split, its halves as this tree designs them), in the
      turns current, candidate, split, split, candidate, current.
      Sampled: the median size of each inner length and R4_NAMED; held
      out (--held-seed, drawn once the rule is stated, apart from the cost
      sweep's sizes): --held-per-way (5) sizes the rule sends to the split
      and as many it sends to the Bluestein.

  R5  the primes of (2^20, 2^22] by the planner's recipe (r5_census), in
      the classes R5_CLASSES: B22, the Bluesteins on 2^22, and R4S, the
      Raders on n - 1, whose core without the rule is K14's four stages;
      B3a and B3b, the Bluesteins on 3*2^20 and 3*2^21, on K15's tile form
      (K15's general form before the tile form took Q = 12288 and 24576);
      B23, the Bluesteins on 2^23, glued either way.  The current
      path is the node on its core without the rule
      (executor.build(core_rule=False)), the candidate the glued form
      (ops/bluestein.py or ops/raders.py around the inner FFT that
      executor.build makes of the recipe's inner, on route(m)'s kernel);
      B23 only the current, against torch.fft.  Sampled: 6 primes spread
      over each class; held out: 4 more a class, drawn with R5_HELD_SEED.
      Each row also gives each way's relative mean error against the host
      float64 oracle at batch 1, forward and inverse, its launches of the
      ported kernels (their counters) and the host's time to queue a call.
      About 2 minutes of census and 15 of timing.

R4's rule compares two costs from split_costs.py's tables, which two
sweeps measure: --costs times, at R4's sampled sizes, its first held-out
draw and the median size of each class of the split's prime half (kind,
inner length) and of 16 DFT_p sizes, the Bluestein on m', the split, its
CT glue alone and its half alone (bluestein, split, glue, half, half,
glue, split, bluestein; about 9 minutes); --glue times the glue alone at
the median size of every p from 2 to config.dense_dft_max (about 3
minutes).  --fit COSTS [COSTS ...] GLUE prints split_costs.py from the
records, a later costs record's (kind, inner length) replacing an
earlier's.  --fit-sizes and --held-sizes time the sizes listed in place of
a rule's samples and draw (or of the cost sweep's sizes), so that a draw
made on the CPU is timed as it was drawn.

Each path's first rows are held against torch.fft in complex128 (relative
mean error <= 1e-5).  It prints one table a rule (n, batch, the current
recipe and form with its ms, the candidate's with its ms, torch.fft's ms,
the ratio current / candidate by events and queued, the spread of the
turns, and the way the planner of this tree takes) and writes every row to
FILE (default build/planner_rules.json).  --sets times only the sets
named.  --check FILE ... reprints recorded runs' tables on the CPU with
the decisions of this tree's planner, so that a rule put in code after a
run is checked against it, held-out sizes apart (PLANNER_RULES_GPU.md is
that reprint of the H100 runs); R4's table also says of each size whether
the way the planner takes is among the fastest ("win") or not ("loss").
--device cpu --limit 1 --batch 1 rehearses it on the plain versions (host
times, which say nothing of the card).  About 17 minutes on an H100 for
R1-R4, a minute of it the census of R1's primes.
"""
from __future__ import annotations

import argparse
import json
import math
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
RULES = ("R1", "R2", "R3", "R4", "R5")
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


#: the sizes R4 samples beside the median of each inner length: 8199 = 9 x
#: 911, 41484 and 98324 on the cluster passes' inner lengths, and 131084 =
#: 4 x 32771 and 196611 = 3 x 65537 above 131072, where the JAX planner
#: finds no radix-core inner and splits
R4_NAMED = (8199, 41484, 98324, 131084, 196611)


def r4_samples(held_seed=None, per_way=5):
    """(sampled, held out) composites of the composite rule: the median n of
    each inner length of four_stage_composites, and R4_NAMED; held out, the
    first `per_way` sizes the rule of this tree sends to the split and the
    first `per_way` it sends to the Bluestein, of the others in the order of
    numpy's default_rng(held_seed).permutation (none without a seed: the
    seed is chosen once the rule is stated), leaving out the cost sweep's
    sizes too (r4_cost_samples: the sizes split_costs.py was measured at)."""
    from torch_prime_cores import four_stage_composites

    by_inner = four_stage_composites()
    fit = [by_inner[m][len(by_inner[m]) // 2] for m in sorted(by_inner)] + list(R4_NAMED)
    fit = list(dict.fromkeys(fit))
    seen = set(fit) | (set(r4_cost_samples(by_inner)) if held_seed is not None else set())
    rest = sorted(n for sizes in by_inner.values() for n in sizes if n not in seen)
    held = []
    if held_seed is not None:
        drawn = {"split": [], "candidate": []}
        for n in np.random.default_rng(held_seed).permutation(rest).tolist():
            way = drawn.get(taken("R4", n))
            if way is not None and len(way) < per_way:
                way.append(n)
            if sum(map(len, drawn.values())) == 2 * per_way:
                break
        held = drawn["split"] + drawn["candidate"]
    print(f"R4 census: {sum(map(len, by_inner.values()))} composites of [8192, 2^20) with no "
          f"route on K14's four stages, {len(by_inner)} inner lengths: " + ", ".join(
              f"{m}:{len(by_inner[m])}" for m in sorted(by_inner)), flush=True)
    return fit, held


#: R5, the core rule above 2^20 (executor.core_form): its classes of primes of
#: (2^20, 2^22], (kind, inner length); R4S's is every n - 1 in (2^20, 2^22]
#: whose core before the rule is K14's four stages
R5_CLASSES = {"B22": ("bluestein", 1 << 22), "R4S": ("rader", None),
              "B3a": ("bluestein", 3 << 20), "B3b": ("bluestein", 3 << 21),
              "B23": ("bluestein", 1 << 23)}
#: the class whose Bluestein is glued before the rule, timed against torch.fft only
R5_TIMED_ONLY = ("B23",)
R5_RANGE = ((1 << 20) + 1, 1 << 22)
#: the seed R5's held-out primes are drawn with, 4 a class
R5_HELD_SEED = 20261026
R5_SAMPLED, R5_HELD = 6, 4


def pre_rule_form(kind: str, m: int) -> str:
    """The core the executor runs a Raders or Bluesteins of inner length m
    on without R5."""
    from rustfft_tpu_torch import executor

    return executor.core_form(kind, m, C64, core_rule=False)


def r5_class(recipe):
    """R5's class of a prime's recipe, or None."""
    from rustfft_tpu_torch import recipes

    if isinstance(recipe, recipes.Raders):
        m = recipe.inner.length
        in_range = 1 << 20 < m <= 1 << 22
        return "R4S" if in_range and pre_rule_form("rader", m) == "K14 four stages" else None
    if isinstance(recipe, recipes.Bluesteins):
        return next((c for c, (kind, m) in R5_CLASSES.items()
                     if kind == "bluestein" and m == recipe.inner.length), None)
    return None


def r5_census() -> dict:
    """{class: [primes of R5_RANGE]} by the planner's recipe."""
    from rustfft_tpu_torch.planner import FftPlannerGpu

    planner = FftPlannerGpu(C64, device="cpu")
    classes = {c: [] for c in R5_CLASSES}
    for n in primes_in(*R5_RANGE):
        c = r5_class(planner._design_prime(n))
        if c is not None:
            classes[c].append(n)
    return classes


def r5_samples(held_seed=R5_HELD_SEED):
    """(sampled, held out) primes of R5: R5_SAMPLED spread over each class,
    R5_HELD drawn from the rest of it with numpy's default_rng(held_seed)."""
    classes = r5_census()
    rng = np.random.default_rng(held_seed)
    fit, held = [], []
    for primes in classes.values():
        picked = spread_pick(primes, R5_SAMPLED)
        rest = [n for n in primes if n not in set(picked)]
        fit += picked
        held += sorted(rng.choice(rest, R5_HELD, replace=False).tolist())
    print("R5 census of (2^20, 2^22]: " + ", ".join(
        f"{c} {len(primes)}" for c, primes in classes.items())
        + f" ({len({p - 1 for p in classes['R4S']})} Rader inner lengths)", flush=True)
    return fit, held


SAMPLES = {"R1": r1_samples, "R2": r2_samples, "R3": r3_samples, "R4": r4_samples,
           "R5": r5_samples}

#: R4's first held-out draw (--held-seed 20261018, under the rule's first
#: statement, by inner points), which the cost sweep times beside its sampled
#: sizes
R4_HELD_FIRST = (148543, 33828, 58931, 49365, 86883, 103287, 150408, 117715, 205853, 121177)
#: the DFT_p sizes whose median size the cost sweep adds
COST_P = (2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


#: the core forms of the split's prime half that the cost sweep times (the
#: others, K14's four stages and K15's general form, are slower than the
#: Bluestein on m_a, so the rule, finding no cost for them, takes that):
#: the tile form's halves are the Bluesteins on 36864 and 49152 (Q = 144,
#: 192), which K15's general form served before the tile form took them
HALF_FORMS = ("one-pass core", "K14 cluster passes", "K15 tile form")


def split_classes(by_inner=None):
    """{n: (p, "rader" or "bluestein", m_q)} of the composites the composite
    rule decides (four_stage_composites) whose split's prime half
    (FftPlannerGpu._split) is a Raders or Bluesteins on HALF_FORMS with no
    route."""
    from rustfft_tpu_torch import executor, recipes, route
    from rustfft_tpu_torch.math_utils import PrimeFactors
    from rustfft_tpu_torch.planner import FftPlannerGpu
    from torch_prime_cores import four_stage_composites

    planner = FftPlannerGpu(C64, device="cpu")
    by_inner = by_inner if by_inner is not None else four_stage_composites()
    classes = {}
    for n in sorted(n for sizes in by_inner.values() for n in sizes):
        split = planner._split(n, PrimeFactors.compute(n))
        half = split.right
        if not isinstance(half, (recipes.Raders, recipes.Bluesteins)):
            continue
        kind = "rader" if isinstance(half, recipes.Raders) else "bluestein"
        m = half.inner.length
        if executor.core_form(kind, m, C64) in HALF_FORMS and route(half.length, C64) is None:
            classes[n] = (split.left.length, kind, m)
    return classes


def r4_cost_samples(by_inner=None):
    """The cost sweep's sizes: R4's sampled sizes and R4_HELD_FIRST, the
    median size of each class (kind, m_q) of the split's prime half with p
    <= config.dense_dft_max (split_classes), and the median size of each p
    of COST_P."""
    from rustfft_tpu_torch import config
    from torch_prime_cores import four_stage_composites

    by_inner = by_inner if by_inner is not None else four_stage_composites()
    fit = [by_inner[m][len(by_inner[m]) // 2] for m in sorted(by_inner)] + list(R4_NAMED)
    classes = {n: c for n, c in split_classes(by_inner).items() if c[0] <= config.dense_dft_max}
    by_half, by_p = {}, {}
    for n, (p, kind, m) in classes.items():
        by_half.setdefault((kind, m), []).append(n)
        by_p.setdefault(p, []).append(n)
    sizes = fit + list(R4_HELD_FIRST)
    sizes += [by_half[k][len(by_half[k]) // 2] for k in sorted(by_half)]
    sizes += [by_p[p][len(by_p[p]) // 2] for p in COST_P if p in by_p]
    sizes = list(dict.fromkeys(sizes))
    print(f"R4 costs: {len(classes)} sizes split onto {len(by_half)} half classes; "
          f"{len(sizes)} sizes timed", flush=True)
    return sizes


# ---- the two paths of each rule ----


def describe(recipe) -> str:
    from rustfft_tpu_torch import executor, recipes

    if isinstance(recipe, (recipes.Raders, recipes.Bluesteins)):
        kind = "rader" if isinstance(recipe, recipes.Raders) else "bluestein"
        name = "Raders" if kind == "rader" else "Bluesteins"
        return f"{name}(m={recipe.inner.length}) {executor.core_form(kind, recipe.inner.length, C64)}"
    return type(recipe).__name__


def describe_split(recipe) -> str:
    from rustfft_tpu_torch import route

    right = recipe.right
    return (f"MixedRadix({recipe.left.length} x {right.length}: "
            f"{route(right.length, C64) or describe(right)})")


def paths(rule: str, n: int, direction) -> dict:
    """{way: (label, fn)}: "current" and "candidate", and R4's "split"."""
    from rustfft_tpu_torch import FftPlanner, executor, recipes
    from rustfft_tpu_torch.math_utils import PrimeFactors
    from rustfft_tpu_torch.ops.kernels import conv, dense, largepad
    from rustfft_tpu_torch.planner import FftPlannerGpu, routed_bluestein_inner

    if rule == "R5":
        return r5_paths(n, direction)
    if rule in ("R1", "R4"):
        planner = FftPlannerGpu(C64, device="cpu")
        old = planner._conv_prime_recipe(n) if rule == "R1" else planner._conv_composite_recipe(n)
        new = recipes.Bluesteins(n, recipes.Dft(routed_bluestein_inner(n, C64)))
        ways = {"current": (describe(old), executor.build(old, direction, C64)),
                "candidate": (describe(new), executor.build(new, direction, C64))}
        if rule == "R4":
            # the near-balanced split, its halves as this tree designs them
            split = planner._split(n, PrimeFactors.compute(n))
            ways["split"] = (describe_split(split), executor.build(split, direction, C64))
        return ways
    if rule == "R2":
        m = switched(JAX_BAND, lambda: executor.hole_band_inner(n, C64))
        return {"current": ("large_pad", largepad.make_largepad_fft_fn(n, direction, C64)),
                "candidate": (f"Bluesteins(m={m}) K14 cluster passes",
                              conv.make_bluestein_fn(n, m, direction, C64))}
    plan = switched(dict(dense_fallback_max_n=0),
                    lambda: FftPlanner(C64, device="cpu").plan_fft(n, direction))
    return {"current": (describe(plan.recipe), plan.process),
            "candidate": ("dense_fft", dense.make_dense_fft_fn(n, direction, C64))}


def r5_paths(n: int, direction) -> dict:
    """{way: (label, fn)} of R5 at the prime n: "current", its node on the
    core without the rule (executor.build(core_rule=False): K14's four
    stages on K12's kernels, or K15's general form), and "candidate", the
    glued form the JAX executor runs at these inner lengths
    (rustfft_tpu/executor.py:346-390), built here from ops/bluestein.py or
    ops/raders.py around two calls of the inner FFT that executor.build
    makes of the recipe's inner, on route(m)'s kernel.  B23's node is
    glued without the rule: its one way is "current"."""
    from rustfft_tpu_torch import executor, recipes, route
    from rustfft_tpu_torch.ops import bluestein as op_bluestein
    from rustfft_tpu_torch.ops import raders as op_raders
    from rustfft_tpu_torch.planner import FftPlannerGpu

    recipe = FftPlannerGpu(C64, device="cpu")._design_prime(n)
    rader = isinstance(recipe, recipes.Raders)
    m = recipe.inner.length
    name = f"{type(recipe).__name__}(m={m})"
    glued = f"{name} glued on {route(m, C64) or 'the recipe tree'}"
    current = executor.build(recipe, direction, C64, core_rule=False)
    if r5_class(recipe) in R5_TIMED_ONLY:
        return {"current": (glued, current)}
    form = pre_rule_form("rader" if rader else "bluestein", m)
    if form not in ("K14 four stages", "K15 tile form", "K15 general form"):
        raise AssertionError(f"R5 n={n}: {name} runs on the {form} without the rule")
    inner = executor.build(recipe.inner, direction, C64)
    fn = (op_raders.make_raders_fn(n, inner, direction, C64) if rader
          else op_bluestein.make_bluestein_fn(n, m, inner, direction, C64))
    return {"current": (f"{name} {form}", current), "candidate": (glued, fn)}


def taken(rule: str, n: int) -> str:
    """The way this tree's planner takes at n: "candidate" or "current" (or
    R4's "split")."""
    from rustfft_tpu_torch import executor, recipes, route
    from rustfft_tpu_torch.planner import FftPlannerGpu, routed_bluestein_inner

    if rule == "R5":
        recipe = FftPlannerGpu(C64, device="cpu")._design_prime(n)
        kind = "rader" if isinstance(recipe, recipes.Raders) else "bluestein"
        m = recipe.inner.length
        moved = executor.core_form(kind, m, C64) != pre_rule_form(kind, m)
        return "candidate" if moved else "current"
    if rule == "R4":
        way = FftPlannerGpu(C64, device="cpu").composite_way(n)
        return {"split": "split", "bluestein": "candidate"}.get(way, "current")
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

    if rule == "R5":
        return measure_r5(n, batch, device, rounds, timers)
    event_ms, queued_ms = timers
    start = time.perf_counter()
    ways = paths(rule, n, FftDirection.FORWARD)
    gen = torch.Generator(device=device).manual_seed(n)
    x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=device)
    want = torch.fft.fft(x[:4].to(torch.complex128))
    row = dict(rule=rule, n=n, batch=batch)
    for way, (label, fn) in ways.items():
        err = rel_err(fn(x)[:4], want)
        if not err <= TOL:
            raise AssertionError(f"{rule} n={n}: {label} relative mean error {err:.3e} > {TOL}")
        row[way], row[f"err_{way}"] = label, err
    ev = {way: [] for way in ways}
    qu = {way: [] for way in ways}
    for _ in range(rounds):
        # current, candidate(s), then back: current, candidate, candidate, current
        for way in list(ways) + list(ways)[::-1]:
            fn = ways[way][1]
            ev[way].append(event_ms(lambda: fn(x)))
            qu[way].append(queued_ms(lambda: fn(x)))
    row["torch_fft_ms"] = event_ms(lambda: torch.fft.fft(x))
    for way in ways:
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


def count_launches(fn, x, device) -> dict:
    """One call of fn(x): {"kernels": the ported kernels' launches by
    wrapper (ops.kernels.launch_counters), "host_ms": the host's time to
    queue the call (median of 5, the device idle before each)}."""
    import torch

    from rustfft_tpu_torch.ops.kernels import launch_counters

    counters = launch_counters()
    for counter in counters.values():
        counter.launches = 0
    fn(x)
    kernels = {name: c.launches for name, c in counters.items() if c.launches}
    if device.type != "cuda":
        return dict(kernels=kernels, host_ms=None)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn(x)
        host.append((time.perf_counter() - start) * 1e3)
    torch.cuda.synchronize()
    return dict(kernels=kernels, host_ms=statistics.median(host))


def measure_r5(n, batch, device, rounds, timers):
    """One row of R5: each way's relative mean error against the host
    float64 oracle at batch 1, forward and inverse, its launches and host
    time at (batch, n), and its times in turns (as measure), torch.fft's."""
    import torch

    from rustfft_tpu_torch import FftDirection, executor, route
    from rustfft_tpu_torch.planner import FftPlannerGpu
    from rustfft_tpu_torch.utils.testing import oracle_dft, random_signal

    event_ms, queued_ms = timers
    start = time.perf_counter()
    recipe = FftPlannerGpu(C64, device="cpu")._design_prime(n)
    m = recipe.inner.length
    row = dict(rule="R5", n=n, batch=batch, cls=r5_class(recipe), m=m,
               inner_route=route(m, C64))
    x1 = random_signal(n, dtype=C64, seed=1000 + n).reshape(1, n)
    ways = r5_paths(n, FftDirection.FORWARD)
    for direction, tag in ((FftDirection.FORWARD, "F"), (FftDirection.INVERSE, "I")):
        want = oracle_dft(x1, direction)
        fns = ways if direction is FftDirection.FORWARD else r5_paths(n, direction)
        for way, (label, fn) in fns.items():
            got = fn(torch.from_numpy(x1).to(device)).cpu().numpy().astype(np.complex128)
            err = float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))
            if not err <= TOL:
                raise AssertionError(f"R5 n={n} {tag}: {label} relative mean error "
                                     f"{err:.3e} > {TOL}")
            row[way], row[f"err_{way}_{tag}"] = label, err
    gen = torch.Generator(device=device).manual_seed(n)
    x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=device)
    for way, (_, fn) in ways.items():
        row[f"{way}_launches"] = count_launches(fn, x, device)
    ev = {way: [] for way in ways}
    qu = {way: [] for way in ways}
    for _ in range(rounds):
        for way in list(ways) + list(ways)[::-1]:
            fn = ways[way][1]
            ev[way].append(event_ms(lambda: fn(x)))
            qu[way].append(queued_ms(lambda: fn(x)))
    row["torch_fft_ms"] = event_ms(lambda: torch.fft.fft(x))
    for way in ways:
        row[f"{way}_ms"] = statistics.median(ev[way])
        row[f"{way}_queued_ms"] = statistics.median(qu[way])
        row[f"{way}_turns_ms"] = ev[way]
        row[f"{way}_turns_queued_ms"] = qu[way]
    if device.type == "cuda":
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
    del x, ways
    executor._CACHE.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - start
    return row


#: the parts the cost sweep times: the Bluestein on routed_bluestein_inner,
#: the split, its CT glue alone (the DFT_p matmul, the twiddle and the
#: transpose around an identity) and its prime half alone on the p x batch
#: rows of q points the split hands it
COST_WAYS = ("bluestein", "split", "glue", "half")


def measure_costs(n, batch, device, timers):
    """One row of the cost sweep: the COST_WAYS at n, in the turns
    bluestein, split, glue, half, half, glue, split, bluestein."""
    import torch

    from rustfft_tpu_torch import FftDirection, executor, recipes
    from rustfft_tpu_torch.math_utils import PrimeFactors
    from rustfft_tpu_torch.ops import ct
    from rustfft_tpu_torch.planner import FftPlannerGpu, routed_bluestein_inner

    event_ms, queued_ms = timers
    start = time.perf_counter()
    fwd = FftDirection.FORWARD
    split = FftPlannerGpu(C64, device="cpu")._split(n, PrimeFactors.compute(n))
    p, half = split.left.length, split.right
    q, m_a = half.length, routed_bluestein_inner(n, C64)
    kind = "rader" if isinstance(half, recipes.Raders) else "bluestein"
    blue = recipes.Bluesteins(n, recipes.Dft(m_a))
    half_fn = executor.build(half, fwd, C64)
    fns = {"bluestein": executor.build(blue, fwd, C64), "split": executor.build(split, fwd, C64),
           "glue": ct.make_ct_stage_fn(p, q, lambda a: a, fwd, C64),
           "half": lambda x: half_fn(x.view(batch, p, q))}
    gen = torch.Generator(device=device).manual_seed(n)
    x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=device)
    want = torch.fft.fft(x[:4].to(torch.complex128))
    row = dict(rule="R4 costs", n=n, batch=batch, p=p, q=q, kind=kind,
               m_q=half.inner.length, form_q=describe(half), m_a=m_a, form_a=describe(blue))
    for way in ("bluestein", "split"):
        err = rel_err(fns[way](x)[:4], want)
        if not err <= TOL:
            raise AssertionError(f"R4 costs n={n}: {way} relative mean error {err:.3e} > {TOL}")
        row[f"err_{way}"] = err
    ev = {way: [] for way in fns}
    qu = {way: [] for way in fns}
    for way in COST_WAYS + COST_WAYS[::-1]:
        fn = fns[way]
        ev[way].append(event_ms(lambda: fn(x)))
        qu[way].append(queued_ms(lambda: fn(x)))
    for way in fns:
        row[f"{way}_ms"] = statistics.median(ev[way])
        row[f"{way}_queued_ms"] = statistics.median(qu[way])
        row[f"{way}_turns_queued_ms"] = qu[way]
    del x, want
    executor._CACHE.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - start
    return row


def glue_samples():
    """{p: n}: the median size of each DFT_p size p <= config.dense_dft_max
    of split_classes, at which --glue times the CT glue alone."""
    from rustfft_tpu_torch import config

    by_p = {}
    for n, (p, _, _) in split_classes().items():
        if p <= config.dense_dft_max:
            by_p.setdefault(p, []).append(n)
    return {p: by_p[p][len(by_p[p]) // 2] for p in sorted(by_p)}


def measure_glue(p, n, batch, device, timers):
    """The CT glue alone (COST_WAYS' "glue") at n = p x q: ms a call and
    queued, twice each."""
    import torch

    from rustfft_tpu_torch import FftDirection
    from rustfft_tpu_torch.ops import ct

    event_ms, queued_ms = timers
    fn = ct.make_ct_stage_fn(p, n // p, lambda a: a, FftDirection.FORWARD, C64)
    gen = torch.Generator(device=device).manual_seed(n)
    x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=device)
    ev = [event_ms(lambda: fn(x)) for _ in range(2)]
    qu = [queued_ms(lambda: fn(x)) for _ in range(2)]
    del x
    return dict(rule="R4 glue", n=n, batch=batch, p=p, q=n // p, glue_ms=statistics.median(ev),
                glue_queued_ms=statistics.median(qu), glue_turns_queued_ms=qu)


def fit_costs(costs_paths, glue_path):
    """split_costs.py's text from --costs records and a --glue record:
    CORE_NS, the median ns a transform of each (kind, inner length) over the
    first costs record's halves (queued half ms over p x batch transforms)
    and Bluesteins (queued bluestein ms over batch); a later record (a sweep
    of the halves whose core changed) prices the halves it times, its
    samples of a (kind, inner length) replacing the earlier ones, and
    leaves the Bluesteins, whose cores it did not change, to the first;
    GLUE_PS, the ps an element of the glue (queued ms over batch x n) at
    each p of the glue record.  Prints on stderr how far the split is from
    its glue plus its half, and the glue of the records at the p they
    share."""
    records = []
    for path in costs_paths:
        with open(path) as f:
            records.append(json.load(f))
    with open(glue_path) as f:
        glue = json.load(f)
    samples: dict = {}
    for i, record in enumerate(records):
        halves: dict = {}
        for r in record["rows"]:
            halves.setdefault((r["kind"], r["m_q"]), []).append(
                r["half_queued_ms"] * 1e6 / (r["batch"] * r["p"]))
            if i == 0:
                samples.setdefault(("bluestein", r["m_a"]), []).append(
                    r["bluestein_queued_ms"] * 1e6 / r["batch"])
        for key, values in halves.items():
            samples[key] = values if i else samples.get(key, []) + values
    costs = dict(records[-1], rows=[r for record in records for r in record["rows"]])
    core = {k: statistics.median(v) for k, v in sorted(samples.items())}
    glue_ps = {r["p"]: r["glue_queued_ms"] * 1e9 / (r["batch"] * r["n"]) for r in glue["rows"]}
    ratios = [r["split_queued_ms"] / (r["glue_queued_ms"] + r["half_queued_ms"])
              for r in costs["rows"]]
    drift = [glue_ps[r["p"]] / (r["glue_queued_ms"] * 1e9 / (r["batch"] * r["n"]))
             for r in costs["rows"] if r["p"] in glue_ps]
    print(f"split / (glue + half): {min(ratios):.3f} .. {max(ratios):.3f} over "
          f"{len(ratios)} sizes; glue of {glue_path} / of {', '.join(costs_paths)}: "
          f"{min(drift):.3f} .. {max(drift):.3f} at {len(drift)} sizes", file=sys.stderr)
    lines = [f'"""The composite rule\'s cost tables (FftPlannerGpu._composite_way),',
             f"measured on {costs['card']} (torch {costs['torch']}) by",
             "tools/torch_planner_rules.py --costs and --glue, queued device time; this",
             "file is `tools/torch_planner_rules.py --fit COSTS [COSTS ...] GLUE`'s output.",
             '"""', "from typing import Optional", "",
             "#: ns a transform of the convolution core of a Raders (\"rader\") or",
             "#: Bluesteins (\"bluestein\") of inner length m, at 256 - 512 MiB a call",
             "CORE_NS = {"]
    lines += [f"    ({kind!r}, {m}): {ns:.1f}," for (kind, m), ns in core.items()]
    lines += ["}", "", "#: ps an element of the CT glue around a split's prime half",
              "#: (ops.ct.make_ct_stage_fn: the DFT_p matmul, the twiddle, the transpose)",
              "#: at each p"]
    items = [f"{p}: {ps:.2f}," for p, ps in sorted(glue_ps.items())]
    lines.append("GLUE_PS = {")
    for i in range(0, len(items), 8):
        lines.append("    " + " ".join(items[i:i + 8]))
    lines += ["}", "", "", "def core_ns(kind: str, m: int) -> Optional[float]:",
              '    """CORE_NS at (kind, m), or None where it was not measured."""',
              "    return CORE_NS.get((kind, m))", "", "",
              "def split_ns(p: int, n: int, kind: str, m: int) -> Optional[float]:",
              '    """ns a transform of the split n = p x q whose prime half is a `kind`',
              "    of inner length m: p of the half's transforms and n elements of the",
              '    glue; None where either was not measured."""',
              "    half, glue = CORE_NS.get((kind, m)), GLUE_PS.get(p)",
              "    return None if half is None or glue is None else p * half + n * glue / 1e3",
              ""]
    return "\n".join(lines)


#: the ways a row may time, in the order they are printed
WAYS = ("current", "candidate", "split")


def ways_of(row) -> list:
    return [way for way in WAYS if f"{way}_ms" in row]


def spread(row) -> float:
    """The largest relative spread of the ways' turns (queued device time;
    events on the CPU): (max - min) / median."""
    key = "turns_queued_ms" if row.get("device", "cuda") == "cuda" else "turns_ms"
    return max((max(t) - min(t)) / statistics.median(t)
               for t in (row[f"{way}_{key}"] for way in ways_of(row)))


def fastest(row) -> list:
    """The ways no other way beats by more than the spread in both timings
    (events and queued)."""
    s = spread(row)

    def beats(a, b):
        return min(row[f"{b}_ms"] / row[f"{a}_ms"],
                   row[f"{b}_queued_ms"] / row[f"{a}_queued_ms"]) > 1 + s

    ways = ways_of(row)
    return [w for w in ways if not any(beats(o, w) for o in ways if o != w)]


def faster(row) -> str:
    """The way measured faster than every other by more than the spread in
    both timings; "tie" where none is, or "a=b" for two ways level ahead of
    a third."""
    best = fastest(row)
    return best[0] if len(best) == 1 else "tie" if len(best) == len(ways_of(row)) else \
        "=".join(best)


def tables_ms(n, batch):
    """(candidate, split): the queued ms a call of R4's Bluestein on m_a and
    of its split at (batch, n) by split_costs.py's tables
    (FftPlannerGpu.composite_costs), None where they have no cost."""
    from rustfft_tpu_torch.math_utils import PrimeFactors
    from rustfft_tpu_torch.planner import FftPlannerGpu

    costs = FftPlannerGpu(C64, device="cpu").composite_costs(n, PrimeFactors.compute(n))
    return tuple(None if c is None else c * batch / 1e6 for c in costs)


def print_table(rule, rows, header) -> None:
    """One rule's rows; with a split way (R4) its columns too, whether the
    way the planner takes is among the fastest ("win") or not ("loss"), and
    the ms split_costs.py's tables give the candidate and the split, with
    the range of the queued ms over them.  R5's rows: print_r5_table."""
    from rustfft_tpu_torch import config

    if rule == "R5":
        return print_r5_table(rows, header)

    split = any("split_ms" in row for row in rows)
    print(f"\n{rule} ({header}); ms a call (events / queued); ratio = current / candidate"
          + ("; ratio split = current / split; tables = split_costs.py's ms of the "
             "candidate / the split" if split else ""))
    print("| set | n | batch | current | ms | candidate | ms | " + ("split | ms | " if split else "")
          + "torch.fft | ratio | " + ("ratio split | " if split else "")
          + "spread | faster | planner takes |" + (" the rule | tables |" if split else ""))
    print("|---" * (12 + 5 * split) + "|")
    agree = Counter()
    against = {"candidate": [], "split": []}
    for row in rows:
        took = taken(rule, row["n"])
        won = took in fastest(row)
        agree[(row["set"], won)] += 1
        cells = [row["set"], row["n"], row["batch"]]
        for way in ways_of(row):
            cells += [row[way], f"{row[f'{way}_ms']:.3f} / {row[f'{way}_queued_ms']:.3f}"]
        cells.append(f"{row['torch_fft_ms']:.3f}")
        for way in ways_of(row)[1:]:
            cells.append(f"{row['current_ms'] / row[f'{way}_ms']:.2f} / "
                         f"{row['current_queued_ms'] / row[f'{way}_queued_ms']:.2f}")
        cells += [f"{spread(row):.3f}", faster(row), took]
        if split:
            table = tables_ms(row["n"], row["batch"])
            for way, ms in zip(against, table):
                if ms is not None:
                    against[way].append(row[f"{way}_queued_ms"] / ms)
            cells += ["win" if won else "loss",
                      " / ".join("-" if ms is None else f"{ms:.3f}" for ms in table)]
        print("| " + " | ".join(str(c) for c in cells) + " |")
    for s in ("fit", "held"):
        total = agree[(s, True)] + agree[(s, False)]
        if total:
            print(f"{rule} {s}: the planner of this tree takes the faster way (or a tie) at "
                  f"{agree[(s, True)]} of {total} sizes")
    if split:
        print("queued / tables: " + ", ".join(
            f"{way} {min(r):.3f} .. {max(r):.3f} ({len(r)} sizes)"
            for way, r in against.items() if r))
    print(f"config: dense_fallback_max_n={config.dense_fallback_max_n}, "
          f"bconv_misaligned={config.bconv_misaligned}, "
          f"bconv_misaligned_min_n={config.bconv_misaligned_min_n}, "
          f"bconv_misaligned_max_pad={config.bconv_misaligned_max_pad}", flush=True)


def launches_text(launches) -> str:
    """A way's launches of the ported kernels, by wrapper."""
    return " ".join(f"{name} {c}" for name, c in sorted(launches["kernels"].items())) or "none"


#: the card's rates the bound is taken at (PERF.md §6): HBM bytes/s and
#: FP32 operations/s (H100 SXM data sheet, 700 W)
HBM_BPS, FP32_OPS = 3.35e12, 67e12


def r5_bound_ms(row) -> float:
    """The least time of an R5 row's core at (batch, n): its input and
    output once over HBM_BPS, or two m-point FFTs of 5 m log2 m operations
    over FP32_OPS, the larger."""
    nbytes = 2 * row["batch"] * row["n"] * 8
    ops = 2 * 5 * row["m"] * math.log2(row["m"]) * row["batch"]
    return max(nbytes / HBM_BPS, ops / FP32_OPS) * 1e3


def print_r5_table(rows, header) -> None:
    """R5's rows: both ways' times, torch.fft's, the faster way, the way
    this tree takes, each way's relative mean error against the float64
    oracle at batch 1 (forward / inverse), its launches and its host time
    to queue a call."""
    print(f"\nR5 ({header}); ms a call (events / queued); bound = r5_bound_ms, the least "
          "time of the core; ratio = current / candidate; err = relative mean error at batch 1 "
          "against the host float64 oracle, forward / inverse; host = ms the host takes to "
          "queue a call (current / candidate)")
    print("| set | class | n | batch | inner route | current | ms | candidate | ms | torch.fft "
          "| bound | ratio | spread | faster | executor takes | err current | err candidate "
          "| launches current | launches candidate | host ms |")
    print("|---" * 20 + "|")
    agree = Counter()
    for row in rows:
        took = taken("R5", row["n"])
        agree[(row["set"], took in fastest(row))] += 1
        cells = [row["set"], row["cls"], row["n"], row["batch"], row["inner_route"] or "none"]
        for way in ("current", "candidate"):
            cells += ([row[way], f"{row[f'{way}_ms']:.3f} / {row[f'{way}_queued_ms']:.3f}"]
                      if way in row else ["-", "-"])
        cells += [f"{row['torch_fft_ms']:.3f}", f"{r5_bound_ms(row):.3f}"]
        cells.append(f"{row['current_ms'] / row['candidate_ms']:.2f} / "
                     f"{row['current_queued_ms'] / row['candidate_queued_ms']:.2f}"
                     if "candidate" in row else "-")
        cells += [f"{spread(row):.3f}", faster(row), took]
        for way in ("current", "candidate"):
            cells.append(f"{row[f'err_{way}_F']:.2e} / {row[f'err_{way}_I']:.2e}"
                         if way in row else "-")
        for way in ("current", "candidate"):
            cells.append(launches_text(row[f"{way}_launches"]) if way in row else "-")
        cells.append(" / ".join("-" if row.get(f"{way}_launches", {}).get("host_ms") is None
                                else f"{row[f'{way}_launches']['host_ms']:.3f}"
                                for way in ("current", "candidate") if way in row))
        print("| " + " | ".join(str(c) for c in cells) + " |")
    for s in ("fit", "held"):
        total = agree[(s, True)] + agree[(s, False)]
        if total:
            print(f"R5 {s}: the executor of this tree takes the faster way (or a tie) at "
                  f"{agree[(s, True)]} of {total} sizes")
    print(flush=True)


def sizes_of(text) -> list:
    """The sizes of a comma-separated list (none for None)."""
    return [int(v) for v in text.split(",")] if text else []


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
    ap.add_argument("--sets", default="fit,held", help="the sets to time (fit, held)")
    ap.add_argument("--held-seed", type=int, default=None,
                    help="R4: the seed its held-out sizes are drawn with (none without)")
    ap.add_argument("--held-per-way", type=int, default=5,
                    help="R4: the held-out sizes drawn for each way")
    ap.add_argument("--costs", action="store_true",
                    help="R4's cost sweep (COST_WAYS at r4_cost_samples) in place of the rules")
    ap.add_argument("--glue", action="store_true",
                    help="R4's CT glue alone at every DFT_p size (glue_samples)")
    ap.add_argument("--fit", metavar="RECORD", nargs="+",
                    help="print split_costs.py from --costs records and a --glue record (the "
                         "last), on the CPU")
    ap.add_argument("--fit-sizes", default=None,
                    help="sizes to time as the sampled set, comma-separated, in place of the "
                         "rule's (or the cost sweep's) samples")
    ap.add_argument("--held-sizes", default=None,
                    help="sizes to time as the held-out set, comma-separated, in place of the "
                         "rule's draw")
    ap.add_argument("--check", metavar="FILE", nargs="+",
                    help="reprint recorded runs with this tree's decisions, on the CPU")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    if args.fit:
        if len(args.fit) < 2:
            raise SystemExit("--fit needs one or more --costs records and a --glue record")
        print(fit_costs(args.fit[:-1], args.fit[-1]), end="")
        return
    if args.check:
        records = []
        for path in args.check:
            with open(path) as f:
                records.append(json.load(f))
        cards = list(dict.fromkeys(f"{r['card']} (torch {r['torch']})" for r in records))
        print("# The planner rules on the card\n\n`python3 tools/torch_planner_rules.py --check "
              f"{' '.join(os.path.basename(p) for p in args.check)}`: "
              f"{'a run' if len(records) == 1 else 'runs'} recorded on {', '.join(cards)}, "
              "with the decisions of this tree's planner.")
        for rule in RULES:
            for record in records:
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
    if args.glue:
        samples = list(glue_samples().items())
        for p, n in samples[:args.limit] if args.limit else samples:
            row = measure_glue(p, n, args.batch or batch_for(n), device, timers)
            row["device"] = device.type
            record["rows"].append(row)
            print(f"  R4 glue p={p} n={n} batch={row['batch']}: {row['glue_ms']:.3f} / "
                  f"{row['glue_queued_ms']:.3f} ms, "
                  f"{row['glue_queued_ms'] * 1e9 / (row['batch'] * n):.2f} ps an element",
                  flush=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"\nR4 glue {time.perf_counter() - t0:.1f} s -> {args.out}", flush=True)
        return
    if args.costs:
        sizes = sizes_of(args.fit_sizes) if args.fit_sizes else r4_cost_samples()
        sizes = sizes[:args.limit] if args.limit else sizes
        for n in sizes:
            row = measure_costs(n, args.batch or batch_for(n), device, timers)
            row["device"] = device.type
            record["rows"].append(row)
            print(f"  R4 costs n={n} = {row['p']} x {row['q']} batch={row['batch']}: "
                  + ", ".join(f"{w} {row[f'{w}_ms']:.3f} / {row[f'{w}_queued_ms']:.3f}"
                              for w in COST_WAYS)
                  + f" ms ({row['form_q']}; {row['form_a']}; {row['seconds']:.1f} s)", flush=True)
            with open(args.out, "w") as f:
                json.dump(record, f, indent=1)
        print(f"\nR4 costs {time.perf_counter() - t0:.1f} s -> {args.out}", flush=True)
        return
    for rule in args.rules.split(","):
        if args.fit_sizes or args.held_sizes:
            fit, held = sizes_of(args.fit_sizes), sizes_of(args.held_sizes)
        elif rule == "R4":
            fit, held = SAMPLES[rule](args.held_seed, args.held_per_way)
        else:
            fit, held = SAMPLES[rule]()
        if args.limit:
            fit, held = fit[:args.limit], held[:args.limit]
        print(f"{rule}: sampled {fit}; held out {held} (t = {time.perf_counter() - t0:.1f} s)",
              flush=True)
        rows = []
        for set_, sizes in (("fit", fit), ("held", held)):
            if set_ not in args.sets.split(","):
                continue
            for n in sizes:
                row = measure(rule, n, args.batch or batch_for(n), device, args.rounds, timers)
                row["set"], row["device"] = set_, device.type
                rows.append(row)
                record["rows"].append(row)
                print(f"  {rule} {set_} n={n}: " + ", ".join(
                    f"{row[w]} {row[f'{w}_ms']:.3f} / {row[f'{w}_queued_ms']:.3f} ms"
                    for w in ways_of(row)) + f", torch.fft {row['torch_fft_ms']:.3f} "
                    f"({row['seconds']:.1f} s)", flush=True)
                with open(args.out, "w") as f:
                    json.dump(record, f, indent=1)
        print_table(rule, rows, card)
    print(f"\nall rules {time.perf_counter() - t0:.1f} s -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
