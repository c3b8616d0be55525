#!/usr/bin/env python3
"""Count the sizes each route of the PyTorch/CUDA port serves.

Run from the repository root; it needs no GPU:

    python3 tools/torch_routes.py [--chains] [LO HI]
    python3 tools/torch_routes.py --lanepack
    python3 tools/torch_routes.py --rules

For complex64 and every n in [LO, HI) (default [14464, 2^20), about four
minutes on one CPU core) prints how many sizes `rustfft_tpu_torch.route`
sends to each route, with the first few of each.  It shows how far a route
rule reaches beyond the sizes its tests pin: for example how many of the
sizes with a `large` split go to `large_pad` (largepad.narrowed_by_division).
Then the route of each power of two from 2^20 to 2^28 (the top band: 2^26
and 2^27 on large3f).

With --chains it also splits the sizes of each two-chain route (large_pad
and large: the column stage's P and the row stage's Q of large.choose_pqq;
two_stage: p and q of fused.choose_pq) by the class of each chain's
costliest stage, as K7's and K12's kernels run them
(fused.bluestein_stage_m): "register" (every radix 2-9, 12 or 16), "direct
sum" (a roots-table stage, no Bluestein stage), "Bluestein r<=256" (a
Bluestein stage of M <= 512) and "Bluestein 257-509" (the prime P as one
stage of M = 1024).  `large`'s own kernels run every radix without a
register stage as a direct sum; the class says what K7's chain would run.

With --lanepack it counts the lanepack sizes of [2, 16384] (a few seconds)
by the class of their chain's costliest stage, before and after K1 moved to
the in-place chain: before, `lanepack.tile_radices` (2-3 stages) on the
two-buffer kernel, which ran every radix without a register stage as a
direct sum from a roots table; after, `lanepack.choose_radices` (1-4
stages) as the chain kernel runs it: "register", "direct sum" (no
Bluestein stage) or "Bluestein" (lanepack.bluestein_stage_m).

With --rules it counts the sizes of the two route rules that
tools/torch_planner_rules.py settles, under the config as it is and under
the other setting (a few seconds): the hole band (executor.hole_band_inner:
odd n of [8192, 131072] that leave large_pad for a Bluestein on the
cluster passes, by r) and the dense band (n of [257, 2048] that no route
but dense serves: routed dense up to config.dense_fallback_max_n).
"""
from __future__ import annotations

import os
import sys
from collections import Counter
from typing import Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rustfft_tpu_torch import route  # noqa: E402
from rustfft_tpu_torch.ops.kernels import fused, large, lanepack  # noqa: E402

#: the chain classes, cheapest first
CLASSES = ("register", "direct sum", "Bluestein r<=256", "Bluestein 257-509")


#: the lanepack classes, cheapest first
LANE_CLASSES = ("register", "direct sum", "Bluestein")


def lanepack_classes(lo: int = 2, hi: int = 16385):
    """(sizes per class before, sizes per class after, stages after) over
    the lanepack sizes of [lo, hi)."""
    before: Counter = Counter()
    after: Counter = Counter()
    stages: Counter = Counter()
    for n in range(lo, hi):
        if route(n, np.complex64) != "lanepack":
            continue
        old = lanepack.tile_radices(n)
        before[LANE_CLASSES[0 if all(r in lanepack.REGISTER_RADICES for r in old) else 1]] += 1
        new = lanepack.choose_radices(n)
        worst = max(2 if fused.bluestein_stage_m(r) else 0 if r in lanepack.REGISTER_RADICES
                    else 1 for r in new)
        after[LANE_CLASSES[worst]] += 1
        stages[len(new)] += 1
    return before, after, stages


def chain_class(m: int) -> str:
    """The class of the costliest stage of large.stage_radices(m)."""
    worst = 0
    for r in large.stage_radices(m):
        bm = fused.bluestein_stage_m(r)
        worst = max(worst, 3 if bm == 1024 else 2 if bm else 0 if r in lanepack.REGISTER_RADICES
                    else 1)
    return CLASSES[worst]


def chains(n: int, name: Optional[str]) -> Optional[Tuple[str, str]]:
    """(first chain's class, second chain's class) of n on a two-chain
    route, else None."""
    if name in ("large_pad", "large"):
        p, q1, q2 = large.choose_pqq(n)
        return chain_class(p), chain_class(q1 * q2)
    if name == "two_stage":
        p, q = fused.choose_pq(n)
        return chain_class(p), chain_class(q)
    return None


def count_routes(lo: int, hi: int, with_chains: bool = False):
    """(sizes per route, first few n per route, sizes per (route, chain
    classes) with with_chains) over n in [lo, hi)."""
    counts: Counter = Counter()
    by_chain: Counter = Counter()
    first: dict = {}
    for n in range(lo, hi):
        name = route(n, np.complex64)
        counts[name] += 1
        if len(first.setdefault(name, [])) < 5:
            first[name].append(n)
        if with_chains:
            pair = chains(n, name)
            if pair is not None:
                by_chain[(name, *pair)] += 1
    return counts, first, by_chain


def rule_bands(fields: dict):
    """(hole band {r: sizes}, dense band sizes routed dense, sizes no route
    serves in [257, 2048]) with the config fields set."""
    from rustfft_tpu_torch import config, executor

    old = {k: getattr(config, k) for k in fields}
    for k, v in fields.items():
        setattr(config, k, v)
    try:
        hole: Counter = Counter()
        for n in range(8193, 131073, 2):
            m = executor.hole_band_inner(n, np.complex64)
            if m is not None:
                hole[m // 16384] += 1
        dense = sum(1 for n in range(257, 2049) if route(n, np.complex64) == "dense")
        none = sum(1 for n in range(257, 2049) if route(n, np.complex64) is None)
    finally:
        for k, v in old.items():
            setattr(config, k, v)
    return hole, dense, none


def print_rule_bands() -> None:
    from rustfft_tpu_torch import config

    for what, fields in (("as configured", {}),
                         ("with the JAX settings", dict(bconv_misaligned=True,
                                                       bconv_misaligned_min_n=8192,
                                                       bconv_misaligned_max_pad=3.5,
                                                       dense_fallback_max_n=2048))):
        hole, dense, none = rule_bands(fields)
        shown = {k: getattr(config, k) for k in ("bconv_misaligned", "bconv_misaligned_min_n",
                                                 "bconv_misaligned_max_pad",
                                                 "dense_fallback_max_n")}
        shown.update(fields)
        print(f"{what} ({', '.join(f'{k}={v}' for k, v in shown.items())}):")
        print(f"  hole band: {sum(hole.values())} odd composites leave large_pad for a "
              "Bluestein on the cluster passes (" + ", ".join(
                  f"r={r}: {hole[r]}" for r in (2, 4, 8, 16)) + ")")
        print(f"  dense band: {dense} sizes of [257, 2048] route dense, {none} have no route")


def main() -> None:
    args = sys.argv[1:]
    if "--rules" in args:
        print_rule_bands()
        return
    if "--lanepack" in args:
        before, after, stages = lanepack_classes()
        total = sum(before.values())
        print(f"lanepack sizes of [2, 16384]: {total}, by their chain's costliest stage")
        for what, cls in (("before (tile_radices, two-buffer kernel)", before),
                          ("after (choose_radices, in-place chain)", after)):
            print(f"  {what}: " + ", ".join(f"{k} {cls[k]} ({100 * cls[k] / total:.1f}%)"
                                            for k in LANE_CLASSES if cls[k]))
        print("  stages after: " + ", ".join(f"{k}: {stages[k]}" for k in sorted(stages)))
        return
    with_chains = "--chains" in args
    args = [a for a in args if a != "--chains"]
    lo, hi = (int(a) for a in args[:2]) if len(args) > 1 else (14464, 1 << 20)
    counts, first, by_chain = count_routes(lo, hi, with_chains)
    print(f"routes of complex64 n in [{lo}, {hi}):")
    for name, count in counts.most_common():
        print(f"  {name}: {count} sizes (first {', '.join(map(str, first[name]))})")
    print("the top band's powers of two: " + ", ".join(
        f"2^{k} {route(1 << k, np.complex64)}" for k in range(20, 29)))
    if with_chains:
        print("two-chain routes by the class of each chain (first stage x second stage):")
        for name in ("large_pad", "large", "two_stage"):
            total = sum(c for key, c in by_chain.items() if key[0] == name)
            for a in CLASSES:
                for b in CLASSES:
                    c = by_chain.get((name, a, b), 0)
                    if c:
                        print(f"  {name}: {a} x {b}: {c} sizes ({100 * c / total:.1f}%)")
            for i, stage in enumerate(("first", "second")):
                cls = Counter()
                for key, c in by_chain.items():
                    if key[0] == name:
                        cls[key[1 + i]] += c
                print(f"  {name} {stage} chain: " + ", ".join(
                    f"{k} {cls[k]} ({100 * cls[k] / total:.1f}%)" for k in CLASSES if cls[k]))


if __name__ == "__main__":
    main()
