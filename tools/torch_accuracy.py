#!/usr/bin/env python3
"""The port's production path against the float64 oracle, route by route:
the PyTorch/CUDA counterpart of tools/tpu_accuracy.py, writing
ACCURACY_GPU.md.

    python3 tools/torch_accuracy.py [n ...] [--sizes LO..HI] [--out ACCURACY_GPU.md]
        [--tol 0.1] [--device cuda] [--sweep LO..HI] [--commit SHA]

Each check runs `FftPlanner(dtype, device).plan_fft(n, direction).process(x)`
on a (batch, n) numpy signal (`utils.testing.random_signal`, seed 1000 + n;
batch 4, 1 above 2^20) and holds it against `utils.testing.oracle_dft` (host
float64): the mean element error below --tol (0.1, the reference's bar,
tests/accuracy.rs:30-37) and the relative mean error at most 1e-5 for
complex64 and 1e-12 for complex128 (tests/test_torch_accuracy.py).  Each row
names `route(n, dtype)`, the recipe, and for a Raders or Bluesteins recipe
that no whole-transform route serves, the convolution core it runs on
(`tools/torch_prime_cores.core_form`).  A check that raises is a failure.

With no n and no --sizes, the checks are `default_checks()`: the sizes of
ACCURACY_TPU.md (SAMPLED_SIZES, SCENARIO_SIZES), a size for every route and
every core form beyond those, complex128 on the card's recipe tree, the
hand-built Rader and Bluestein of tools/tpu_accuracy.py's "lanepack-conv"
rows (pinned plans, algorithm.py) and the kernel-variant switches, each set
around its check and set back after.  chip_smoke.py runs the same list.
--sweep LO..HI adds every size of LO..HI (complex64, both directions) as a
section of its own.  Where ACCURACY_TPU.md has the same (n, direction), its
relative mean error stands beside the port's.

The script exits 1 when any check fails.  --device cpu runs the kernels'
plain torch versions (the tests run it so); the artifact is made on the card.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from rustfft_tpu_torch import (  # noqa: E402
    FftDirection, FftPlanner, algorithm, config, recipes, route)

# the sizes of tools/tpu_accuracy.py:29-39, copied so that the two artifacts
# compare row by row: a stratified sample of 1..1000 and the bench's sizes
SAMPLED_SIZES = [
    1, 2, 3, 4, 5, 7, 8, 11, 13, 16, 17, 23, 29, 31, 32,
    36, 48, 64, 81, 97, 100, 101, 128, 120, 144, 179, 233,
    240, 243, 251, 256, 283, 360, 367, 409, 431, 512, 540, 577, 625,
    720, 729, 768, 809, 863, 929, 960, 997, 1000,
]

SCENARIO_SIZES = [1024, 1234, 2048, 2592, 3888, 4096, 7776, 8192, 16384,
                  1009, 7919, 65537, 65536, 1 << 20, 1 << 23, 746497,
                  78125]

#: sizes for each value of executor.route beyond the lists above
ROUTE_SIZES = {
    "lanepack": (4096,),
    "radix": (32768, 262144),
    "two_stage": (14464, 28928, 260608),
    "large_pad": (15625, 531441),
    "large": (1 << 20,),
    "large2f": (1 << 22, 1 << 25),
    "large3f": (1 << 26, 1 << 27),
    "dense": (5, 23, 127, 251),
}

#: sizes for each convolution core form (executor.CORE_FORMS): primes no
#: route serves, by the core their recipe's inner length runs on, among them
#: one prime of each class of R5, the core rule above 2^20.  K14's four
#: stages: below 2^20 no planner path reaches them with the switches at
#: their defaults since the prime rule and the composite rule (65537 under
#: rader_in_shift, a SWITCHED check, runs them), above it the Raders on n - 1
#: in (2^20, 2^22] keep them (1051009, m = 1051008), and R5_REPLACED runs
#: them where R5 took the glued form.  K15's tile form also at 24571 (Q =
#: 192) and at 1048583 and 2097169 (the Bluesteins on 3*2^20 and 3*2^21, Q
#: = 12288 and 24576), which K15's general form served before the tile form
#: took every Q the planner gives a prime: no prime reaches the general
#: form since (convlarge.make_bluestein_large_fn(general=True) does, in
#: chip_smoke.py).  The glued form at 4194301 (a Bluestein on 2^23, glued
#: around large2f either way) and 1572869 (on 2^22, glued around large2f
#: since R5)
FORM_SIZES = {
    "one-pass core": (257, 2531, 3083),
    "K14 cluster passes": (65521, 131071),
    "K14 four stages": (1051009,),
    "K15 tile form": (1000003, 524309, 24571, 1048583, 2097169),
    "K15 general form": (),
    "glued form": (4194301, 1572869),
}

#: R5's prime on the core the rule replaced (executor.build(core_rule=False)):
#: K14's four stages at 1572869 (Bluesteins on 2^22)
R5_REPLACED = (1572869,)

#: the composite rule's ways (FftPlannerGpu._composite_way) at composites
#: whose whole-n Bluestein ran K14's four stages before it: the split at
#: 8199 = 9 x 911 and 88575 = 75 x 1181 (halves on the one-pass core), the
#: Bluestein on K15's tile form at 196609 (m = 442368)
COMPOSITE_SIZES = (8199, 196609, 88575)

#: complex128 on the card: the torch recipe tree (no kernel serves c128)
C128_SIZES = (64, 256, 1009, 4096, 65537)

#: the hand-built recipes of tools/tpu_accuracy.py:113-136, as pinned plans:
#: (n, kind, inner length)
PINNED = ((1009, "rader", 1008), (600, "bluestein", 1296))

#: the kernel-variant switches, each with the sizes whose path reads it
SWITCHED = (
    ((("large_gauss", True),), (1 << 20,)),
    ((("large_blocks2d", True),), (1 << 20,)),
    ((("conv_radix_gauss", True),), (65537, 7919)),
    ((("rader_in_shift", True),), (65537,)),
    ((("rader_full_out", False),), (1009,)),
)

#: the relative mean error bar by dtype (tests/test_torch_accuracy.py)
REL_BAR = {"complex64": 1e-5, "complex128": 1e-12}
MEAN_TOL = 0.1
#: sizes above this run at batch 1
BATCH1_ABOVE = 1 << 20
#: a table longer than this shows its failures and its 50 worst rows only
TABLE_MAX = 300

DIRECTIONS = (FftDirection.FORWARD, FftDirection.INVERSE)


@dataclass(frozen=True)
class Check:
    n: int
    direction: FftDirection
    dtype: str = "complex64"
    #: config fields set around the check, (name, value) pairs
    switches: Tuple[Tuple[str, object], ...] = ()
    #: a pinned plan instead of the planner's: ("rader" or "bluestein", inner length)
    pinned: Optional[Tuple[str, int]] = None
    #: False: the planner's recipe with its Raders and Bluesteins nodes on
    #: their cores without R5 (executor.build(core_rule=False))
    core_rule: bool = True

    @property
    def batch(self) -> int:
        return 1 if self.n > BATCH1_ABOVE else 4

    @property
    def tag(self) -> str:
        return "F" if self.direction is FftDirection.FORWARD else "I"

    @property
    def label(self) -> str:
        """What sets the check apart from the planner's c64 plan."""
        parts = [f"{name}={value}" for name, value in self.switches]
        if self.pinned:
            parts.append("pinned " + ("RadersAlgorithm" if self.pinned[0] == "rader"
                                      else "BluesteinsAlgorithm"))
        if not self.core_rule:
            parts.append("the core R5 replaced")
        return ", ".join(parts)


def planner_checks(sizes, dtype: str = "complex64", switches=()):
    """The planner's plan at each size, both directions."""
    return [Check(n, d, dtype, tuple(switches)) for n in sizes for d in DIRECTIONS]


def default_checks():
    """The route-wide list that this script and chip_smoke.py run."""
    sizes = list(dict.fromkeys(SAMPLED_SIZES + SCENARIO_SIZES + list(COMPOSITE_SIZES)))
    for group in (ROUTE_SIZES, FORM_SIZES):
        for more in group.values():
            sizes += [n for n in more if n not in sizes]
    checks = planner_checks(sizes)
    checks += planner_checks(C128_SIZES, "complex128")
    checks += [Check(n, d, pinned=(kind, m)) for n, kind, m in PINNED for d in DIRECTIONS]
    for switches, at in SWITCHED:
        checks += planner_checks(at, switches=switches)
    checks += [Check(n, d, core_rule=False) for n in R5_REPLACED for d in DIRECTIONS]
    return checks


class switched:
    """Set config fields for a with-block; every one is set back after."""

    def __init__(self, switches):
        self.switches = switches

    def __enter__(self):
        self.old = [(name, getattr(config, name)) for name, _ in self.switches]
        for name, value in self.switches:
            setattr(config, name, value)

    def __exit__(self, *exc):
        for name, value in self.old:
            setattr(config, name, value)


class ReplacedPlan:
    """The planner's recipe at n built with executor.build(core_rule=False):
    its Raders and Bluesteins nodes on the cores R5 replaced.  process takes
    a tensor on its own device or a numpy buffer, computed on `device`."""

    def __init__(self, recipe, direction, dtype, device):
        from rustfft_tpu_torch import executor

        self.recipe = recipe
        self._fn = executor.build(recipe, direction, dtype, core_rule=False)
        self._device = device

    def process(self, x):
        import torch

        if isinstance(x, torch.Tensor):
            return self._fn(x)
        return self._fn(torch.from_numpy(x).to(self._device)).cpu().numpy()


def make_plan(check: Check, device):
    """The check's plan: the planner's, the pinned constructor's over the
    planner's inner plan, or the planner's recipe on the cores R5 replaced.
    Call it with the check's switches set."""
    planner = FftPlanner(np.dtype(check.dtype), device=device)
    if not check.core_rule:
        recipe = planner.design_fft_for_len(check.n)
        return ReplacedPlan(recipe, check.direction, np.dtype(check.dtype), device)
    if check.pinned is None:
        return planner.plan_fft(check.n, check.direction)
    kind, m = check.pinned
    inner = planner.plan_fft(m, check.direction)
    if kind == "rader":
        return algorithm.RadersAlgorithm(inner)
    return algorithm.BluesteinsAlgorithm(check.n, inner)


def recipe_label(recipe) -> str:
    name = type(recipe).__name__
    if isinstance(recipe, (recipes.Raders, recipes.Bluesteins)):
        return f"{name}({recipe.inner.length})"
    if hasattr(recipe, "left"):
        return f"{name}({recipe.left.length} x {recipe.right.length})"
    return name


def core_form_of(check: Check, recipe, routed) -> str:
    """torch_prime_cores.recipe_core_form; a pinned plan runs no core."""
    from torch_prime_cores import TREE, recipe_core_form

    form = recipe_core_form(recipe, routed, np.dtype(check.dtype), check.core_rule)
    return TREE if form and check.pinned else form


def card_signal(check: Check, device):
    """A (batch, n) signal made on the card from seed 1000 + n, unit-normal
    real and imaginary parts as random_signal's."""
    import torch

    real = torch.float64 if check.dtype == "complex128" else torch.float32
    gen = torch.Generator(device=device).manual_seed(1000 + check.n)
    parts = torch.randn((check.batch, check.n, 2), dtype=real, generator=gen, device=device)
    return torch.view_as_complex(parts)


def run_check(check: Check, device="cuda", on_card: bool = False, tol: float = MEAN_TOL) -> Dict:
    """Run one check; return its errors, route, recipe and core form, and
    "ok".  Host mode (the artifact): random_signal and the host float64
    oracle.  on_card (chip_smoke.py): the signal made on the card and
    torch.fft in complex128 on the card as the oracle."""
    import torch

    from rustfft_tpu_torch.utils.testing import oracle_dft, random_signal

    start = time.perf_counter()
    with switched(check.switches):
        routed = route(check.n, np.dtype(check.dtype))
        plan = make_plan(check, device)
        if on_card:
            x = card_signal(check, device)
            got = plan.process(x).to(torch.complex128)
            x = x.to(torch.complex128)
            want = (torch.fft.fft(x) if check.direction is FftDirection.FORWARD
                    else torch.fft.ifft(x) * check.n)
            diff = (got - want).abs()
            mean_err, max_err = diff.mean().item(), diff.max().item()
            denom = want.abs().mean().item()
            del x, got, want, diff
        else:
            x = random_signal(check.batch * check.n, dtype=np.dtype(check.dtype),
                              seed=1000 + check.n).reshape(check.batch, check.n)
            got = np.asarray(plan.process(x)).astype(np.complex128)
            want = oracle_dft(x, check.direction)
            diff = np.abs(got - want)
            mean_err, max_err = float(diff.mean()), float(diff.max())
            denom = float(np.mean(np.abs(want)))
    rel_err = mean_err / denom if denom else mean_err
    ok = bool(mean_err < tol and rel_err <= REL_BAR[check.dtype])
    return dict(check=check, mean_err=mean_err, max_err=max_err, rel_err=rel_err, ok=ok,
                route=routed, recipe=recipe_label(plan.recipe),
                form=core_form_of(check, plan.recipe, routed),
                seconds=time.perf_counter() - start)


def tpu_errors(path: str = os.path.join(REPO, "ACCURACY_TPU.md")) -> Dict:
    """{(n, "F" or "I"): relative mean error} of ACCURACY_TPU.md's table
    (its first row of each)."""
    rows = {}
    if not os.path.exists(path):
        return rows
    row = re.compile(r"^\| (\d+) \| ([FI]) \| [^|]+ \| [^|]+ \| ([0-9.e+-]+) \|$")
    with open(path) as f:
        for line in f:
            m = row.match(line.strip())
            if m:
                rows.setdefault((int(m.group(1)), m.group(2)), float(m.group(3)))
    return rows


def run_all(checks, device, tol, what):
    """Run each check, printing a line for each on stderr; return the
    results (a check that raises is a failed result)."""
    results = []
    for check in checks:
        try:
            r = run_check(check, device, tol=tol)
        except Exception as exc:  # noqa: BLE001 - a raising check is a failure, recorded
            r = dict(check=check, mean_err=float("nan"), max_err=float("nan"),
                     rel_err=float("nan"), ok=False, route=None, recipe="raised",
                     form=f"{type(exc).__name__}: {exc}"[:120], seconds=0.0)
        results.append(r)
        print(f"# {what} n={check.n:>9}{check.tag} {check.dtype} {check.label}: "
              f"mean={r['mean_err']:.3e} max={r['max_err']:.3e} rel={r['rel_err']:.3e} "
              f"route={r['route']} {r['recipe']} {r['form']} ({r['seconds']:.1f}s)"
              f"{'' if r['ok'] else '  FAIL'}", file=sys.stderr, flush=True)
    return results


def summary(results) -> str:
    fails = [r for r in results if not r["ok"]]
    worst = max(results, key=lambda r: (r["rel_err"] if r["rel_err"] == r["rel_err"]
                                        else float("inf")))
    c = worst["check"]
    return (f"**{len(results)} checks, {len(fails)} failures.** worst relative mean error: "
            f"{worst['rel_err']:.3e} at n={c.n} {c.tag} {c.dtype}"
            + (f" ({c.label})" if c.label else "") + f", route {worst['route']}")


def tpu_of(result, tpu):
    """ACCURACY_TPU.md's relative mean error at a planner c64 check's (n,
    direction), or None."""
    c = result["check"]
    return tpu.get((c.n, c.tag)) if c.dtype == "complex64" and not c.label else None


def versus_tpu(results, tpu) -> str:
    """How the rows that ACCURACY_TPU.md also has compare."""
    pairs = [(t, r["rel_err"]) for r in results if (t := tpu_of(r, tpu)) is not None]
    ratios = sorted(t / p for t, p in pairs if p > 0)
    if not ratios:
        return ""
    return (f"Beside ACCURACY_TPU.md: {len(pairs)} (n, direction) rows in both; the port's "
            f"relative mean error is the lower in {sum(p < t for t, p in pairs)}; "
            f"ACCURACY_TPU.md's over the port's: min {ratios[0]:.3g}, median "
            f"{ratios[len(ratios) // 2]:.3g}, max {ratios[-1]:.3g} (the {len(ratios)} rows "
            f"where the port's is not 0).")


def table(results, tpu) -> str:
    shown = results
    note = ""
    if len(results) > TABLE_MAX:
        worst = sorted(results, key=lambda r: -r["rel_err"])[:50]
        shown = [r for r in results if not r["ok"] or any(r is w for w in worst)]
        note = (f"(table: every failure and the 50 worst relative mean errors of "
                f"{len(results)} checks)\n\n")
    lines = ["| n | dir | dtype | variant | recipe | route | core form | mean err | max err "
             "| rel mean err | TPU rel mean err | ok |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in shown:
        c = r["check"]
        on_tpu = tpu_of(r, tpu)
        lines.append(
            f"| {c.n} | {c.tag} | c{c.dtype[7:]} | {c.label} | {r['recipe']} | "
            f"{r['route'] or '-'} | {r['form'] or '-'} | {r['mean_err']:.3e} | "
            f"{r['max_err']:.3e} | {r['rel_err']:.3e} | "
            f"{'-' if on_tpu is None else f'{on_tpu:.3e}'} | {'yes' if r['ok'] else 'FAIL'} |")
    return note + "\n".join(lines) + "\n"


def device_header(device: str, commit: str) -> str:
    import torch

    if device.startswith("cuda"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
        where = f"card: {card} (nvidia-smi name, power limit); {torch.cuda.get_device_name(0)}"
    else:
        where = "device: cpu (the kernels' plain torch versions; no card)"
    return (f"{where}; torch {torch.__version__}, CUDA {torch.version.cuda}; commit {commit}; "
            f"generated {time.strftime('%Y-%m-%d %H:%M:%S')}")


def git_commit() -> str:
    try:
        return subprocess.run(["git", "-C", REPO, "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True, check=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown (not a git checkout)"


def parse_range(spec: str):
    lo, hi = spec.split("..")
    return list(range(int(lo), int(hi) + 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int)
    ap.add_argument("--out", default="ACCURACY_GPU.md")
    ap.add_argument("--sizes", dest="range_spec", default=None,
                    help="LO..HI: every size of the range in place of the default list")
    ap.add_argument("--tol", type=float, default=MEAN_TOL)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sweep", default=None,
                    help="LO..HI: also every size of the range, in a section of its own")
    ap.add_argument("--commit", default=None, help="the commit the run is of (default: git)")
    args = ap.parse_args(argv)

    if args.range_spec:
        checks = planner_checks(parse_range(args.range_spec))
    elif args.sizes:
        checks = planner_checks([n for n in args.sizes if n >= 1])
    else:
        checks = default_checks()
    header = device_header(args.device, args.commit or git_commit())
    print("#", header, file=sys.stderr, flush=True)
    start = time.perf_counter()
    results = run_all(checks, args.device, args.tol, "check")
    sweep = (run_all(planner_checks(parse_range(args.sweep)), args.device, args.tol, "sweep")
             if args.sweep else [])
    seconds = time.perf_counter() - start
    tpu = tpu_errors()

    with open(args.out, "w") as f:
        f.write("# GPU accuracy artifact — the port's production path vs the host f64 oracle\n\n")
        f.write(f"{header}\n\n")
        command = " ".join(argv if argv is not None else sys.argv[1:])
        f.write(f"`python3 tools/torch_accuracy.py {command}`"
                f" in {seconds:.1f} s; batch 4 a size (1 above 2^20); input "
                "`random_signal(seed=1000 + n)`; oracle `oracle_dft` (numpy float64); bars: "
                f"mean element error < {args.tol} (reference tests/accuracy.rs:30-37) and "
                "relative mean error <= 1e-5 (c64), 1e-12 (c128).  `route` is "
                "`executor.route(n, dtype)` (- none: the recipe tree's nodes); `core form` the "
                "convolution core of a Raders or Bluesteins recipe that no route serves "
                "(`tools/torch_prime_cores.core_form`); `TPU rel mean err` the same (n, "
                "direction) in ACCURACY_TPU.md.\n\n")
        f.write(summary(results) + "\n\n")
        if versus_tpu(results, tpu):
            f.write(versus_tpu(results, tpu) + "\n\n")
        if sweep:
            f.write(f"Sweep `--sweep {args.sweep}` (c64, both directions, the planner's plans): "
                    + summary(sweep) + "\n\n")
        f.write(table(results, tpu))
        if sweep:
            f.write(f"\n## Sweep {args.sweep}\n\n" + table(sweep, tpu))
    fails = sum(not r["ok"] for r in results + sweep)
    print(f"# wrote {args.out}: {len(results) + len(sweep)} checks, {fails} failures",
          file=sys.stderr, flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
