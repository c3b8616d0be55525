#!/usr/bin/env python3
"""Count the primes of a range by the recipe and the convolution core the
PyTorch/CUDA port runs them on.

Run from the repository root; it needs no GPU:

    python3 tools/torch_prime_cores.py [TREE] [LO HI]
    python3 tools/torch_prime_cores.py --composites [LO HI]

TREE (default the checkout this script lies in) is the root of the
checkout whose `rustfft_tpu_torch` is counted, so that a parent unpacked
with `git archive` can be counted beside the change (a tree with
`executor.core_form` and the prime rule); [LO, HI] (default [8192, 2^20]) is the range of
primes, both ends included.  For every prime n there,
`FftPlannerGpu(np.complex64)._design_prime(n)` gives the recipe (Raders on
n - 1, Bluesteins on an inner m, or another) and `executor.core_form` (the
executor's Raders and Bluesteins branches) the core its inner length runs
on (`executor.CORE_FORMS`):

  one-pass core      conv.conv_supported(m) (K6 / K13);
  K15 tile form      a Bluestein on the fused large Bluestein at a split
                     (convlarge.split) convlarge.tile_form takes;
  K15 general form   the fused large Bluestein at any other split;
  K14 cluster passes conv_radix.cluster_form(m) (m = r*16384);
  K14 four stages    the two-pass core's column and row stages;
  glued form         no kernel core: ops/bluestein.py or ops/raders.py
                     around two calls of the inner FFT, which
                     executor.build runs on route(m)'s kernel (above 2^20
                     also where R5, the core rule, takes it);
  torch recipe tree  the kernels off (recipe_core_form).

It prints the primes by recipe and inner length (the most common inner
lengths first), then by core form (with the number of distinct inner
lengths), then each core form's most common inner lengths, K15's split P x
Q of each inner length on K15 (convlarge.split), then the primes
the prime rule (planner.prime_rule_inner) moved: their recipe's core form
before the rule (FftPlannerGpu._conv_prime_recipe) and after it.
About 60 s for [8192, 2^20] on one CPU core.

With --composites it counts the awkward composites of [LO, HI) (default
[8192, 2^20), HI left out): the composites with a prime factor above
config.dense_dft_max that no route serves, by recipe and core form before
the composite rule (FftPlannerGpu._conv_composite_recipe: a whole-n
Bluesteins, else the split) and after it (the planner's recipe), then the
sizes the rule moved, by form before and way after.  About four minutes
for the default range on one CPU core, most of it executor.route.
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

#: the form of a Raders or Bluesteins recipe with the kernels off, and of a
#: prime's recipe that is neither
TREE = "torch recipe tree"


def forms() -> tuple:
    """The core forms, in the order they are printed: executor.CORE_FORMS of
    the tree counted."""
    from rustfft_tpu_torch import executor

    return executor.CORE_FORMS


def primes_in(lo: int, hi: int) -> np.ndarray:
    """The primes p with lo <= p <= hi."""
    sieve = np.ones(hi + 1, dtype=bool)
    sieve[:2] = False
    for p in range(2, int(hi ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p :: p] = False
    return np.flatnonzero(sieve[lo:]) + lo


def awkward_composites(lo: int, hi: int, above: int) -> np.ndarray:
    """The composites n with lo <= n < hi and a prime factor above `above`
    (config.dense_dft_max): the sizes the awkward-composite rule designs as
    one whole-n Bluestein's."""
    largest = np.zeros(hi, dtype=np.int64)
    for p in primes_in(2, hi - 1).tolist():
        largest[p::p] = p  # ascending primes: the largest factor is written last
    n = np.arange(lo, hi)
    big = largest[lo:hi]
    return n[(big > above) & (big != n)]


def four_stage_composites(lo: int = 8192, hi: int = 1 << 20) -> dict:
    """{inner length m: [n, ...]} of the composites of [lo, hi) that no
    route serves and whose whole-n Bluestein before the composite rule
    (FftPlannerGpu._conv_composite_recipe) runs K14's four stages: the
    sizes the composite rule (FftPlannerGpu._composite_way) decides."""
    from rustfft_tpu_torch import config, executor, recipes, route
    from rustfft_tpu_torch.planner import FftPlannerGpu

    planner = FftPlannerGpu(np.complex64, device="cpu")
    forms: dict = {}
    by_inner: dict = {}
    for n in awkward_composites(lo, hi, config.dense_dft_max).tolist():
        recipe = planner._conv_composite_recipe(n)
        if not isinstance(recipe, recipes.Bluesteins):
            continue
        m = recipe.inner.length
        if m not in forms:
            forms[m] = core_form("bluestein", m)
        # route last: it costs more than the rest together
        if forms[m] == "K14 four stages" and route(n, np.complex64) is None:
            by_inner.setdefault(m, []).append(n)
    return by_inner


def core_form(kind: str, m: int) -> str:
    """The core the executor runs a Raders ("rader") or Bluesteins
    ("bluestein") recipe of inner length m on, with the kernels on."""
    from rustfft_tpu_torch import executor

    return executor.core_form(kind, m, np.complex64)


def k15_split(m: int) -> tuple:
    """K15's split (P, q1, q2) of an inner length in the tree counted:
    convlarge.split, or large.choose_pqq in a tree without it."""
    from rustfft_tpu_torch.ops.kernels import convlarge, large

    return getattr(convlarge, "split", large.choose_pqq)(m)


def kind_and_inner(recipe):
    """("rader" or "bluestein", inner length) of a prime's recipe, or (its
    class name, 0)."""
    from rustfft_tpu_torch import recipes

    if isinstance(recipe, recipes.Raders):
        return "rader", recipe.inner.length
    if isinstance(recipe, recipes.Bluesteins):
        return "bluestein", recipe.inner.length
    return type(recipe).__name__, 0


def recipe_core_form(recipe, routed, dtype, core_rule: bool = True) -> str:
    """The core a plan's top recipe runs on: executor.core_form for a Raders
    or Bluesteins recipe that no route serves (`routed`, executor.route's
    name, is None) with the kernels on for `dtype` (core_rule=False: the
    core without R5), the torch recipe tree with them off; "" for any other
    recipe."""
    from rustfft_tpu_torch import executor, recipes

    if routed is not None or not isinstance(recipe, (recipes.Raders, recipes.Bluesteins)):
        return ""
    if not executor.kernels_on(dtype):
        return TREE
    kind = "rader" if isinstance(recipe, recipes.Raders) else "bluestein"
    return executor.core_form(kind, recipe.inner.length, np.complex64, core_rule=core_rule)


def census(lo: int, hi: int):
    """(primes by (recipe, inner length), primes by core form, inner
    lengths by core form, primes the prime rule moved by (kind and form
    before, form after), the moved primes' new inner length over the old,
    ascending) over the primes of [lo, hi]."""
    from rustfft_tpu_torch.planner import FftPlannerGpu

    planner = FftPlannerGpu(np.complex64)
    by_inner: Counter = Counter()
    by_form: Counter = Counter()
    moved: Counter = Counter()
    pads: list = []
    inners: dict = {}
    for n in primes_in(lo, hi).tolist():
        recipe = planner._design_prime(n)
        kind, m = kind_and_inner(recipe)
        form = core_form(kind, m) if m else TREE
        by_inner[(kind, m)] += 1
        by_form[form] += 1
        inners.setdefault(form, Counter())[(kind, m)] += 1
        before = planner._conv_prime_recipe(n)
        if before != recipe:
            old_kind, old_m = kind_and_inner(before)
            moved[(old_kind, core_form(old_kind, old_m) if old_m else TREE, form)] += 1
            pads.append(m / old_m)
    return by_inner, by_form, inners, moved, sorted(pads)


def recipe_label(recipe) -> str:
    """A composite's recipe as the census counts it: "Bluesteins on" its
    core form, or the recipe's class name."""
    from rustfft_tpu_torch import recipes

    if isinstance(recipe, recipes.Bluesteins):
        return f"Bluesteins on {core_form('bluestein', recipe.inner.length)}"
    return type(recipe).__name__


def composite_census(lo: int, hi: int):
    """(awkward composites, of them served by a route, those with no route
    by recipe label before the composite rule, and after, the moved ones
    by (label before, label after)) over the awkward composites of [lo,
    hi)."""
    from rustfft_tpu_torch import config, route
    from rustfft_tpu_torch.planner import FftPlannerGpu

    planner = FftPlannerGpu(np.complex64, device="cpu")
    sizes = awkward_composites(lo, hi, config.dense_dft_max).tolist()
    routed = 0
    before: Counter = Counter()
    after: Counter = Counter()
    moved: Counter = Counter()
    for n in sizes:
        if route(n, np.complex64) is not None:
            routed += 1
            continue
        recipe = planner.design_fft_for_len(n)
        new = recipe_label(recipe)
        old = recipe_label(planner._conv_composite_recipe(n)) if planner.composite_way(n) else new
        before[old] += 1
        after[new] += 1
        if new != old:
            moved[(old, new)] += 1
    return len(sizes), routed, before, after, moved


def print_composites(lo: int, hi: int) -> None:
    total, routed, before, after, moved = composite_census(lo, hi)
    print(f"awkward composites in [{lo}, {hi}): {total}, {routed} served by a route, "
          f"{total - routed} with no route")
    for name, counts in (("before the composite rule", before), ("after it", after)):
        print(f"{name}, by recipe and core form:")
        for label, c in sorted(counts.items(), key=lambda kv: -kv[1]):
            print(f"  {label}: {c}")
    print(f"moved by the composite rule: {sum(moved.values())}" + "".join(
        f"\n  {old} -> {new}: {c}" for (old, new), c in sorted(moved.items(),
                                                               key=lambda kv: -kv[1])))


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--composites"]:
        sys.path.insert(0, HERE)
        lo, hi = (int(a) for a in args[1:3]) if len(args) > 2 else (8192, 1 << 20)
        print_composites(lo, hi)
        return
    root = HERE
    if args and os.path.isdir(args[0]):
        root, args = os.path.abspath(args[0]), args[1:]
    sys.path.insert(0, root)
    lo, hi = (int(a) for a in args[:2]) if len(args) > 1 else (8192, 1 << 20)
    by_inner, by_form, inners, moved, pads = census(lo, hi)
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
    shown = tuple(dict.fromkeys(forms() + tuple(by_form)))
    for form in shown:
        if by_form[form]:
            kc = Counter()
            for (kind, _), c in inners[form].items():
                kc[kind] += c
            lengths = len({m for _, m in inners[form]})
            print(f"  {form}: {by_form[form]} primes, {lengths} inner lengths ("
                  + ", ".join(f"{k} {c}" for k, c in kc.most_common()) + ")")
    for form in shown:
        if by_form[form]:
            top = sorted(inners[form].items(), key=lambda kv: (-kv[1], kv[0]))
            more = f", and {len(top) - SHOWN} more" if len(top) > SHOWN else ""
            print(f"{form}, inner lengths by primes (b Bluestein, r Rader): " + ", ".join(
                f"{kind[0]}{m}:{c}" for (kind, m), c in top[:SHOWN]) + more)
    k15 = sorted({m for form in shown if form.startswith("K15") for _, m in inners.get(form, {})})
    if k15:
        print("K15's split of its inner lengths, P x Q: " + ", ".join(
            f"{m} = {k15_split(m)[0]} x {m // k15_split(m)[0]}" for m in k15))
    print(f"moved by the prime rule: {sum(moved.values())} primes" + (
        f", the new inner {pads[0]:.2f}x .. {pads[-1]:.2f}x the old (median "
        f"{pads[len(pads) // 2]:.2f}x)" if pads else "") + "".join(
        f"\n  {kind} on {old} -> Bluestein on {new}: {c}"
        for (kind, old, new), c in sorted(moved.items(), key=lambda kv: -kv[1])))


if __name__ == "__main__":
    main()
