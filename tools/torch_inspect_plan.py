#!/usr/bin/env python3
"""Inspect one size's plan in the PyTorch/CUDA port: its recipe tree, route,
convolution core and config switches, and what one call launches.  The
counterpart of tools/inspect_plan.py, whose jaxpr and HLO have no meaning
here: in their place the kernel launches of one `process` call.

    python3 tools/torch_inspect_plan.py N [--direction inverse] [--scalar]
        [--dtype c128] [--device cpu] [--kernels off] [--trace]

It prints the recipe (the same text as tools/inspect_plan.py's `describe`),
`route(N, dtype)`, for a Raders or Bluesteins recipe that no route serves
the convolution core it runs on (`tools/torch_prime_cores.core_form`), the
planner rule that decided N where one did (the prime rule, the hole band or
the dense band, tools/torch_planner_rules.py), and `config.switch_key()`.  Then it runs `process` once on a (1, N) input and,
on the card (the default device), prints each kernel wrapper's launch count
(`ops.kernels.launch_counters()`, every count set to 0 just before the call
and read just after, as chip_smoke.py does); with --trace, the CUDA kernels
that torch.profiler records for that call, with their grids and blocks.
--kernels off sets config.kernels to "off": the torch recipe tree, whose
recipes are the JAX package's with its kernels off.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from rustfft_tpu_torch import recipes  # noqa: E402

DTYPES = {"c64": np.complex64, "c128": np.complex128}
TORCH_DTYPES = {"c64": "complex64", "c128": "complex128"}


def describe(recipe, indent=0) -> str:
    """The recipe tree as text: a copy of tools/inspect_plan.py's describe,
    on the port's recipe classes (the same names and fields)."""
    pad = "  " * indent
    name = type(recipe).__name__
    if isinstance(recipe, (recipes.Dft, recipes.Butterfly)):
        return f"{pad}{name}({recipe.length})"
    if isinstance(recipe, recipes.Radix4):
        return f"{pad}Radix4(k={recipe.k}, len={recipe.length})\n" + describe(
            recipe.base, indent + 1
        )
    if isinstance(recipe, recipes.RadixN):
        return (
            f"{pad}RadixN(factors={recipe.factors}, len={recipe.length})\n"
            + describe(recipe.base, indent + 1)
        )
    if hasattr(recipe, "left"):
        return (
            f"{pad}{name}(len={recipe.length})\n"
            + describe(recipe.left, indent + 1)
            + "\n"
            + describe(recipe.right, indent + 1)
        )
    if hasattr(recipe, "inner"):
        return f"{pad}{name}(len={recipe.length})\n" + describe(
            recipe.inner, indent + 1
        )
    return f"{pad}{name}(len={recipe.length})"


def kernel_trace(fn, device) -> list:
    """(name, grid, block) of every CUDA kernel torch.profiler records while
    fn() runs, in launch order."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    return [(e["name"], tuple(e.get("args", {}).get("grid", ())),
             tuple(e.get("args", {}).get("block", ()))) for e in kernels]


def rule_of(n: int, recipe, routed, np_dtype) -> str:
    """The planner rule that decided n's plan, as text, or "": the prime
    rule (a Bluestein on a fast core form in place of the recipe of the
    convolution-core rules), the composite rule (a Bluestein on a fast core
    form or the split in place of a composite's whole-n Bluestein on K14's
    four stages), the core rule above 2^20 (R5: the glued form in place of
    K14's four stages or K15's general form), the hole band (route gives no
    route where it would give large_pad) or the dense band (dense above
    config.dense_dft_max)."""
    from rustfft_tpu_torch import config, executor, recipes
    from rustfft_tpu_torch.math_utils import is_prime
    from rustfft_tpu_torch.planner import FftPlannerGpu
    from torch_prime_cores import core_form, kind_and_inner

    if not executor.kernels_on(np_dtype):
        return ""
    if isinstance(recipe, recipes.Bluesteins) and is_prime(n):
        before = FftPlannerGpu(np_dtype, device="cpu")._conv_prime_recipe(n)
        if before != recipe:
            kind, m = kind_and_inner(before)
            return (f"the prime rule: {kind} on m={m} ({core_form(kind, m)}) -> Bluestein on "
                    f"m={recipe.inner.length} ({core_form('bluestein', recipe.inner.length)})")
    if routed is None and isinstance(recipe, (recipes.Raders, recipes.Bluesteins)):
        kind, m = kind_and_inner(recipe)
        before = executor.core_form(kind, m, np_dtype, core_rule=False)
        if core_form(kind, m) != before:
            return (f"the core rule above 2^20: {kind} on m={m} ({before}) -> the glued form, "
                    f"its inner on {executor.route(m, np_dtype)}")
    planner = FftPlannerGpu(np_dtype, device="cpu")
    way = planner.composite_way(n)
    if way is not None:
        m = planner._conv_composite_recipe(n).inner.length
        after = (f"the split {recipe.left.length} x {recipe.right.length}" if way == "split" else
                 f"Bluestein on m={recipe.inner.length} "
                 f"({core_form('bluestein', recipe.inner.length)})")
        return f"the composite rule: bluestein on m={m} ({core_form('bluestein', m)}) -> {after}"
    m = executor.hole_band_inner(n, np_dtype)
    if m is not None:
        return f"the hole band: Bluestein on m={m} ({core_form('bluestein', m)}), not large_pad"
    if routed == "dense" and n > config.dense_dft_max:
        return (f"the dense band: dense_fft up to config.dense_fallback_max_n = "
                f"{config.dense_fallback_max_n}")
    return ""


def inspect(n: int, direction="forward", dtype="c64", device="cuda", scalar=False,
            kernels="auto", trace=False) -> dict:
    """What the tool prints, as a dict: recipe (describe's text), route,
    core_form, rule (rule_of; "" for the scalar planner), switch_key, launches ({wrapper: count} of one process call on
    the card, None on the CPU) and trace ([(kernel, grid, block)] with
    trace on the card, else None)."""
    import torch

    from rustfft_tpu_torch import FftDirection, FftPlanner, FftPlannerScalar, config, route
    from rustfft_tpu_torch.ops.kernels import launch_counters
    from torch_prime_cores import recipe_core_form

    np_dtype = DTYPES[dtype]
    old = config.kernels
    config.kernels = kernels
    try:
        planner = (FftPlannerScalar if scalar else FftPlanner)(np_dtype, device=device)
        plan = planner.plan_fft(n, FftDirection(direction))
        routed = route(n, np_dtype)
        out = dict(recipe=describe(plan.recipe), route=routed,
                   core_form=recipe_core_form(plan.recipe, routed, np_dtype),
                   rule="" if scalar else rule_of(n, plan.recipe, routed, np_dtype),
                   switch_key=config.switch_key(), launches=None, trace=None)
        gen = torch.Generator(device=device).manual_seed(n)
        x = torch.randn((1, n), dtype=getattr(torch, TORCH_DTYPES[dtype]), generator=gen,
                        device=device)
        on_card = torch.device(device).type == "cuda"
        if on_card:
            counters = launch_counters()
            for counter in counters.values():
                counter.launches = 0
            plan.process(x)
            torch.cuda.synchronize(device)
            out["launches"] = {name: c.launches for name, c in counters.items() if c.launches}
            if trace:
                out["trace"] = kernel_trace(lambda: plan.process(x), device)
        else:
            plan.process(x)
    finally:
        config.kernels = old
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--direction", default="forward", choices=("forward", "inverse"))
    ap.add_argument("--scalar", action="store_true", help="use FftPlannerScalar")
    ap.add_argument("--dtype", default="c64", choices=tuple(DTYPES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernels", default="auto", choices=("auto", "off"))
    ap.add_argument("--trace", action="store_true",
                    help="the CUDA kernels of one call, from torch.profiler")
    args = ap.parse_args(argv)

    info = inspect(args.n, args.direction, args.dtype, args.device, args.scalar, args.kernels,
                   args.trace)
    print("=== recipe ===")
    print(info["recipe"])
    print(f"route: {info['route'] or 'none (no whole-transform kernel)'}")
    if info["core_form"]:
        print(f"core form: {info['core_form']}")
    if info["rule"]:
        print(f"planner rule: {info['rule']}")
    print(f"config switch key (kernels, use_native, large_gauss, large_blocks2d, "
          f"conv_radix_gauss, rader_in_shift, rader_full_out, dense_fallback_max_n, "
          f"bconv_misaligned, bconv_misaligned_min_n, bconv_misaligned_max_pad): "
          f"{info['switch_key']}")
    print(f"\n=== one process call of (1, {args.n}) on {args.device} ===")
    if info["launches"] is None:
        print("launches: not counted (the kernels' plain torch versions run on the cpu)")
    else:
        print(f"launches: {info['launches'] or 'none (no counted kernel)'}")
    if info["trace"] is not None:
        print(f"CUDA kernels ({len(info['trace'])}):")
        for name, grid, block in info["trace"]:
            print(f"  {name[:110]} grid={grid} block={block}")
    elif args.trace:
        print("trace: no CUDA kernels on the cpu")


if __name__ == "__main__":
    main()
