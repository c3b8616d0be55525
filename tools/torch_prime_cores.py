#!/usr/bin/env python3
"""Count the primes of a range by the recipe and the convolution core the
PyTorch/CUDA port runs them on.

Run from the repository root; it needs no GPU:

    python3 tools/torch_prime_cores.py [TREE] [LO HI]

TREE (default the checkout this script lies in) is the root of the
checkout whose `rustfft_tpu_torch` is counted, so that a parent unpacked
with `git archive` can be counted beside the change; [LO, HI] (default
[8192, 2^20]) is the range of primes, both ends included.  For every prime
n there, `FftPlannerGpu(np.complex64)._design_prime(n)` gives the recipe
(Raders on n - 1, Bluesteins on an inner m, or another) and the executor's
dispatch (executor.py: the Raders and Bluesteins branches) the core its
inner length runs on:

  one-pass core      conv.conv_supported(m) (K6 / K13);
  K15 tile form      a Bluestein on the fused large Bluestein at a split
                     convlarge.tile_form takes;
  K15 general form   the fused large Bluestein at any other split;
  K14 cluster passes conv_radix.cluster_form(m) (m = r*16384);
  K14 four stages    the two-pass core's column and row stages;
  torch recipe tree  no kernel core.

It prints the primes by recipe and inner length (the most common inner
lengths first), then by core form (with the number of distinct inner
lengths), then each core form's most common inner lengths.
About 45 s for [8192, 2^20] on one CPU core.
"""
from __future__ import annotations

import os
import sys
from collections import Counter

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the (recipe, inner length) pairs printed for each core form, most primes
#: first
SHOWN = 24

#: the core forms, in the order they are printed
FORMS = ("one-pass core", "K15 tile form", "K15 general form", "K14 cluster passes",
         "K14 four stages", "torch recipe tree")


def primes_in(lo: int, hi: int) -> np.ndarray:
    """The primes p with lo <= p <= hi."""
    sieve = np.ones(hi + 1, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(hi ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p :: p] = False
    return np.flatnonzero(sieve[lo:]) + lo


def core_form(kind: str, m: int) -> str:
    """The core the executor runs a Raders ("rader") or Bluesteins
    ("bluestein") recipe of inner length m on, with the kernels on."""
    from rustfft_tpu_torch.ops.kernels import conv, conv_radix, convlarge, large

    c64 = np.complex64
    if conv.conv_supported(m, c64):
        return FORMS[0]
    if kind == "bluestein" and convlarge.bconv_supported(m, c64):
        p, q1, q2 = large.choose_pqq(m)
        return FORMS[1] if convlarge.tile_form(p, q1 * q2) else FORMS[2]
    if conv_radix.radix_conv_supported(m, c64):
        return FORMS[3] if conv_radix.cluster_form(m) is not None else FORMS[4]
    return FORMS[5]


def census(lo: int, hi: int):
    """(primes by (recipe, inner length), primes by core form, inner
    lengths by core form) over the primes of [lo, hi]."""
    from rustfft_tpu_torch import recipes
    from rustfft_tpu_torch.planner import FftPlannerGpu

    planner = FftPlannerGpu(np.complex64)
    by_inner: Counter = Counter()
    by_form: Counter = Counter()
    inners: dict = {}
    for n in primes_in(lo, hi).tolist():
        recipe = planner._design_prime(n)
        if isinstance(recipe, recipes.Raders):
            kind, m = "rader", recipe.inner.length
        elif isinstance(recipe, recipes.Bluesteins):
            kind, m = "bluestein", recipe.inner.length
        else:
            kind, m = type(recipe).__name__, 0
        form = core_form(kind, m) if m else FORMS[5]
        by_inner[(kind, m)] += 1
        by_form[form] += 1
        inners.setdefault(form, Counter())[(kind, m)] += 1
    return by_inner, by_form, inners


def main() -> None:
    args = sys.argv[1:]
    root = HERE
    if args and os.path.isdir(args[0]):
        root, args = os.path.abspath(args[0]), args[1:]
    sys.path.insert(0, root)
    lo, hi = (int(a) for a in args[:2]) if len(args) > 1 else (8192, 1 << 20)
    by_inner, by_form, inners = census(lo, hi)
    total = sum(by_form.values())
    kinds = Counter()
    for (kind, _), c in by_inner.items():
        kinds[kind] += c
    print(f"primes in [{lo}, {hi}]: {total} (tree {root})")
    print("by recipe: " + ", ".join(f"{k} {c}" for k, c in kinds.most_common()))
    print(f"by recipe and inner length ({len(by_inner)} pairs, most primes first):")
    for (kind, m), c in sorted(by_inner.items(), key=lambda kv: (-kv[1], kv[0])):
        print(f"  {kind} m={m}: {c}")
    print("by core form:")
    for form in FORMS:
        if by_form[form]:
            kc = Counter()
            for (kind, _), c in inners[form].items():
                kc[kind] += c
            lengths = len({m for _, m in inners[form]})
            print(f"  {form}: {by_form[form]} primes, {lengths} inner lengths ("
                  + ", ".join(f"{k} {c}" for k, c in kc.most_common()) + ")")
    for form in FORMS:
        if by_form[form]:
            top = sorted(inners[form].items(), key=lambda kv: (-kv[1], kv[0]))
            more = f", and {len(top) - SHOWN} more" if len(top) > SHOWN else ""
            print(f"{form}, inner lengths by primes (b Bluestein, r Rader): " + ", ".join(
                f"{kind[0]}{m}:{c}" for (kind, m), c in top[:SHOWN]) + more)


if __name__ == "__main__":
    main()
