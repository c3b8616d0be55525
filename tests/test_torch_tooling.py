"""The port's user-facing tools and examples on the CPU.

tools/torch_accuracy.py (its route-wide check list and its CLI),
tools/torch_inspect_plan.py (its recipe text against the JAX tool's
`describe` of the JAX planner's recipe, its route line),
tools/torch_autotune.py, the three examples (examples/torch_*.py, each in a
subprocess with --device cpu, its printed errors under the bar; the
distributed one on 4 gloo ranks), and the two races in state the port
shares between threads: executor.build's cache of built functions and the
native plancore's first load.  The card's side is
tests/test_torch_card_tooling.py.
"""
import ctypes
import dataclasses
import inspect
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from rustfft_tpu import FftPlanner as RefPlanner
from rustfft_tpu import config as ref_config
from rustfft_tpu_torch import FftPlanner, executor, math_utils, native, recipes, route
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import conv_radix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    # after every other entry: the tools import each other by module name
    sys.path.append(TOOLS)

import inspect_plan  # noqa: E402  (the JAX package's tool)
import torch_accuracy  # noqa: E402
import torch_inspect_plan  # noqa: E402
import torch_planner_rules  # noqa: E402
import torch_prime_cores  # noqa: E402
import torch_routes  # noqa: E402
from torch_prime_cores import recipe_core_form  # noqa: E402

C64 = np.complex64
#: the five sizes the recipe text is compared at
INSPECT_SIZES = (1009, 1234, 4096, 1 << 20, 746497)
#: seconds a subprocess may take
TIMEOUT = 240


def route_values():
    """Every value executor.route can return: the names in its return
    statements, and None."""
    names = re.findall(r'return "(\w+)"', inspect.getsource(executor.route))
    assert names, "executor.route names no route"
    return sorted(set(names)) + [None]


def form_of(n, core_rule=True):
    """(route, core form) of the planner's c64 plan at n (core_rule=False:
    the core without R5); the form is "" where a route serves n or the
    recipe is neither Raders nor Bluesteins."""
    routed = route(n, C64)
    recipe = FftPlanner(C64, device="cpu").design_fft_for_len(n)
    return routed, recipe_core_form(recipe, routed, C64, core_rule)


def run(args, timeout=TIMEOUT):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


# ---- tools/torch_accuracy.py ----

@pytest.mark.parametrize("name", list(torch_accuracy.ROUTE_SIZES))
def test_route_sizes_take_their_route(name):
    """Each size listed for a route takes it: a routing change that orphans
    the list fails here."""
    for n in torch_accuracy.ROUTE_SIZES[name]:
        assert route(n, C64) == name, n


@pytest.mark.parametrize("form", executor.CORE_FORMS)
def test_form_sizes_take_their_core_form(form):
    """Every core form of executor.CORE_FORMS is reached by some prime, and
    each size listed for it is a prime that no route serves and whose inner
    length runs on that form (the glued form by the Bluesteins on 2^23 above
    about 3.1 million, 4194301 among them, and since R5, the core rule above
    2^20, on 2^22, 1572869 among them).  K14's four stages only above 2^20,
    by the Raders on n - 1 in (2^20, 2^22] (1051009): below it no planner
    path reaches them with the switches at their defaults since the prime
    rule and the composite rule, and the switched check of 65537 under
    rader_in_shift does (its Rader core keeps them,
    conv_radix.cluster_form); the composites they served take the
    composite rule's ways, and R5_REPLACED's check at 1572869 runs them
    (executor.build(core_rule=False)).  K15's general form: no prime since
    the tile form took every Q the planner gives a prime of [8192, 2^22]
    (24571, 1048583 and 2097169 among them); its kernels stay, reached by
    convlarge.make_bluestein_large_fn(general=True)."""
    sizes = torch_accuracy.FORM_SIZES[form]
    if form == "K15 general form":
        assert sizes == ()
        for n in (24571, 1048583, 2097169):
            assert form_of(n) == (None, "K15 tile form"), n
        return
    assert sizes, form
    for n in sizes:
        assert math_utils.is_prime(n), n
        assert form_of(n) == (None, form), n
    if form == "K14 four stages":
        assert all(n > 1 << 20 for n in sizes), sizes
        assert ((("rader_in_shift", True),), (65537,)) in torch_accuracy.SWITCHED
        assert form_of(65537) == (None, "K14 cluster passes")
        assert conv_radix.cluster_form(65536, in_shift=True) is None
        for n in torch_accuracy.COMPOSITE_SIZES:
            assert not math_utils.is_prime(n) and route(n, C64) is None, n
            assert form_of(n)[1] in ("", "K15 tile form", "K14 cluster passes"), n
        assert [n for n in torch_accuracy.R5_REPLACED
                if form_of(n, core_rule=False)[1] == form] == [1572869]


def test_r5_replaced_sizes():
    """R5_REPLACED: the prime of the class R5 moved (the Bluesteins on 2^22),
    on the glued form by default and on K14's four stages without the rule,
    checked both ways in default_checks on the four stages; the primes of
    the classes it kept run the same form with and without it."""
    assert torch_accuracy.R5_REPLACED == (1572869,)
    assert form_of(1572869) == (None, "glued form")
    assert form_of(1572869, core_rule=False) == (None, "K14 four stages")
    assert 1572869 in torch_accuracy.FORM_SIZES["glued form"]
    for n in (1051009, 1048583, 2097169, 4194301):
        assert form_of(n) == form_of(n, core_rule=False), n
    checks = torch_accuracy.default_checks()
    assert {(c.n, c.direction) for c in checks if not c.core_rule} == {
        (1572869, d) for d in torch_accuracy.DIRECTIONS}
    check = next(c for c in checks if not c.core_rule)
    assert check.label == "the core R5 replaced" and check.batch == 1


def test_default_checks_cover_every_route_and_core_form():
    checks = torch_accuracy.default_checks()
    planner = [c for c in checks if c.dtype == "complex64" and not c.pinned and not c.switches
               and c.core_rule]
    sizes = {c.n for c in planner}
    routes = {route(n, C64) for n in sizes}
    assert routes == set(route_values()), routes
    forms = {form_of(n)[1] for n in sizes} - {""}
    assert forms == set(executor.CORE_FORMS) - {"K15 general form"}, forms
    # the four stages also on a switched check (65537 under rader_in_shift)
    # and on the check of the core R5 replaced
    switched = {(c.n, c.switches) for c in checks if c.switches}
    assert (65537, (("rader_in_shift", True),)) in switched
    assert {form_of(c.n, core_rule=False)[1] for c in checks if not c.core_rule} == {
        "K14 four stages"}
    assert set(torch_accuracy.COMPOSITE_SIZES) <= sizes
    # both directions of every check
    for c in checks:
        assert dataclasses.replace(c, direction=c.direction.opposite()) in checks
    # the JAX artifact's sizes, row by row
    assert set(torch_accuracy.SAMPLED_SIZES + torch_accuracy.SCENARIO_SIZES) <= sizes
    assert {c.n for c in checks if c.dtype == "complex128"} == set(torch_accuracy.C128_SIZES)
    assert {(c.n, c.pinned) for c in checks if c.pinned} == {(1009, ("rader", 1008)),
                                                             (600, ("bluestein", 1296))}
    switched = {(c.switches, c.n) for c in checks if c.switches}
    assert switched == {((("large_gauss", True),), 1 << 20),
                        ((("large_blocks2d", True),), 1 << 20),
                        ((("conv_radix_gauss", True),), 65537),
                        ((("conv_radix_gauss", True),), 7919),
                        ((("rader_in_shift", True),), 65537),
                        ((("rader_full_out", False),), 1009)}
    assert all(c.batch == (1 if c.n > 1 << 20 else 4) for c in checks)


def test_accuracy_cli(tmp_path):
    out = tmp_path / "acc.md"
    proc = run(["tools/torch_accuracy.py", "--device", "cpu", "7", "16", "1009",
                "--out", str(out)])
    assert proc.returncode == 0, proc.stderr[-2000:]
    text = out.read_text()
    rows = re.findall(r"^\| (\d+) \| ([FI]) \|", text, flags=re.M)
    assert sorted(rows) == sorted((str(n), d) for n in (7, 16, 1009) for d in "FI")
    assert "**6 checks, 0 failures.**" in text
    # each row beside ACCURACY_TPU.md's relative error at the same (n, dir)
    assert torch_accuracy.tpu_errors()[(1009, "F")] == pytest.approx(5.736e-06)
    assert "| 5.736e-06 | yes |" in text

    proc = run(["tools/torch_accuracy.py", "--device", "cpu", "7", "--tol", "0",
                "--out", str(tmp_path / "acc0.md")])
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "**2 checks, 2 failures.**" in (tmp_path / "acc0.md").read_text()


def test_accuracy_check_that_raises_is_a_failure(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("no plan")

    monkeypatch.setattr(torch_accuracy, "make_plan", broken)
    results = torch_accuracy.run_all(torch_accuracy.planner_checks([16]), "cpu", 0.1, "check")
    assert [r["ok"] for r in results] == [False, False]
    assert all("RuntimeError: no plan" in r["form"] for r in results)


@pytest.mark.parametrize("on_card", [False, True], ids=["host_oracle", "torch_oracle"])
def test_accuracy_checks_hold_the_bars(on_card):
    """The small checks of the default list (pinned, switched and c128 among
    them) pass on the CPU in both of run_check's modes; the switches are set
    back after each."""
    from rustfft_tpu_torch import config

    before = config.switch_key()
    checks = [c for c in torch_accuracy.default_checks()
              if c.n <= 1024 or c.pinned or c.dtype == "complex128"
              or (c.switches and c.n < 1 << 20)]
    for c in checks:
        r = torch_accuracy.run_check(c, "cpu", on_card=on_card)
        assert r["ok"], (c, r)
        assert config.switch_key() == before
    assert {c.dtype for c in checks} == {"complex64", "complex128"}


# ---- tools/torch_inspect_plan.py ----

@pytest.fixture
def ref_pallas_off():
    old = ref_config.use_pallas
    ref_config.use_pallas = "off"
    try:
        yield
    finally:
        ref_config.use_pallas = old


@pytest.mark.parametrize("n", INSPECT_SIZES)
def test_inspect_plan_recipe_matches_jax_tool(n, ref_pallas_off, capsys):
    """The recipe text with the kernels off equals tools/inspect_plan.py's
    describe of the JAX planner's recipe with Pallas off; the default run
    prints executor.route's route."""
    want = inspect_plan.describe(RefPlanner().plan_fft_forward(n).recipe)
    got = torch_inspect_plan.inspect(n, device="cpu", kernels="off")
    assert got["recipe"] == want
    assert got["route"] is None and got["launches"] is None

    torch_inspect_plan.main([str(n), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"route: {route(n, C64) or 'none (no whole-transform kernel)'}\n" in printed
    default = FftPlanner(C64, device="cpu").plan_fft_forward(n).recipe
    assert torch_inspect_plan.describe(default) in printed
    assert "launches: not counted" in printed


def test_inspect_plan_options(capsys):
    torch_inspect_plan.main(["65537", "--device", "cpu", "--direction", "inverse", "--scalar",
                             "--dtype", "c128", "--trace"])
    printed = capsys.readouterr().out
    assert printed.startswith("=== recipe ===\nRaders(len=65537)")
    assert "route: none" in printed and "core form: torch recipe tree" in printed
    assert "trace: no CUDA kernels on the cpu" in printed
    assert torch_inspect_plan.inspect(65537, device="cpu")["core_form"] == "K14 cluster passes"


@pytest.fixture
def rule_fields():
    """Set the planner rules' config fields for one test; set back after."""
    names = ("dense_fallback_max_n", "bconv_misaligned", "bconv_misaligned_min_n",
             "bconv_misaligned_max_pad")
    old = {k: getattr(executor.config, k) for k in names}

    def set_(**kw):
        for k, v in kw.items():
            setattr(executor.config, k, v)

    yield set_
    set_(**old)


@pytest.mark.parametrize("n,on,rule", [
    (746497, {}, "the prime rule: rader on m=746496 (K14 four stages) -> Bluestein on "
                 "m=1572864 (K15 tile form)"),
    (88589, {}, "the prime rule: bluestein on m=186624 (K14 four stages) -> Bluestein on "
                "m=262144 (K14 cluster passes)"),
    (8199, {}, "the composite rule: bluestein on m=17496 (K14 four stages) -> the split "
               "9 x 911"),
    (8482, {}, "the composite rule: bluestein on m=17496 (K14 four stages) -> Bluestein on "
               "m=32768 (K14 cluster passes)"),
    (16383, {"bconv_misaligned": True},
     "the hole band: Bluestein on m=32768 (K14 cluster passes), not large_pad"),
    (1031, {"dense_fallback_max_n": 2048},
     "the dense band: dense_fft up to config.dense_fallback_max_n = 2048"),
    (1572869, {}, "the core rule above 2^20: bluestein on m=4194304 (K14 four stages) -> the "
                  "glued form, its inner on large2f"),
    (16383, {}, ""), (1031, {}, ""), (65537, {}, ""), (1051009, {}, ""), (2097169, {}, ""),
    (4194301, {}, ""),
])
def test_inspect_plan_names_the_rule(n, on, rule, rule_fields, capsys):
    """The planner rule that decided n, as the tool prints it (none where
    no rule acts or a rule is off)."""
    rule_fields(**on)
    assert torch_inspect_plan.inspect(n, device="cpu")["rule"] == rule
    torch_inspect_plan.main([str(n), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert (f"planner rule: {rule}\n" in printed) == bool(rule)
    assert torch_inspect_plan.inspect(n, device="cpu", scalar=True)["rule"] == ""


# ---- tools/torch_prime_cores.py, tools/torch_routes.py --rules ----

def test_prime_cores_counts_the_composite_rule(capsys):
    """The composite census of [8192, 9000): the awkward composites, those a
    route serves, and the 256 with no route whose whole-n Bluestein ran
    K14's four stages, each moved by the composite rule onto a fast form or
    the split; none is left on the four stages."""
    total, routed, before, after, moved = torch_prime_cores.composite_census(8192, 9000)
    assert (total, routed) == (352, 96)
    assert before == {"Bluesteins on K14 four stages": 256}
    assert sum(after.values()) == 256 and "Bluesteins on K14 four stages" not in after
    assert set(after) <= {"MixedRadix", "Bluesteins on K14 cluster passes",
                          "Bluesteins on K15 tile form"}
    assert sum(moved.values()) == 256
    by_inner = torch_prime_cores.four_stage_composites(8192, 9000)
    assert sum(map(len, by_inner.values())) == 256 and sorted(by_inner) == [17496, 18432]
    torch_prime_cores.print_composites(8192, 9000)
    out = capsys.readouterr().out
    assert "awkward composites in [8192, 9000): 352, 96 served by a route, 256 with no route" in out
    assert "moved by the composite rule: 256" in out


def test_prime_cores_counts_the_prime_rule():
    """The census of [8192, 9000]: no prime left on K14's four stages, each
    moved by the prime rule from them onto a fast form."""
    by_inner, by_form, _, moved, pads = torch_prime_cores.census(8192, 9000)
    assert by_form["K14 four stages"] == 0 and sum(moved.values()) > 0
    assert all(old == "K14 four stages" and new in ("K14 cluster passes", "K15 tile form")
               for _, old, new in moved)
    assert len(pads) == sum(moved.values()) and all(p > 1 for p in pads)


def test_routes_count_the_rule_bands(rule_fields, capsys):
    """--rules: the hole band and the dense band as configured (both off)
    and with the JAX settings (15988 and 442 sizes)."""
    torch_routes.print_rule_bands()
    out = capsys.readouterr().out
    assert "hole band: 0 odd composites" in out and "dense band: 0 sizes" in out
    assert "hole band: 15988 odd composites" in out
    assert "(r=2: 728, r=4: 2803, r=8: 4787, r=16: 7670)" in out
    assert "dense band: 442 sizes of [257, 2048] route dense, 0 have no route" in out
    rule_fields(dense_fallback_max_n=1024)
    assert torch_routes.rule_bands({})[1] == sum(1 for n in range(257, 1025)
                                                 if route(n, C64) == "dense")


# ---- tools/torch_planner_rules.py ----

def test_planner_rules_samples_and_batches():
    """The dense band's samples (the four named sizes, every 8th of the
    band, 10 held out apart from them), and batches of 256-512 MiB."""
    fit, held = torch_planner_rules.r3_samples()
    assert {257, 514, 1031, 2042} <= set(fit) and len(held) == 10 and not set(fit) & set(held)
    assert len(fit) == 59
    for n in (257, 2042, 15625, 88589, 746497, 1 << 20):
        batch = torch_planner_rules.batch_for(n)
        assert 256 <= batch * n * 8 / 2**20 < 512 + 16 and batch & (batch - 1) == 0


def test_planner_rules_check_reprints_a_record(tmp_path, capsys):
    """--check reprints a recorded run's tables with this tree's decisions,
    on the CPU: the prime rule takes the candidate, the hole band and the
    dense band (off) the current path."""
    import json

    def row(rule, n, set_, cur, new):
        return dict(rule=rule, n=n, set=set_, batch=2, device="cuda", current="old",
                    candidate="new", torch_fft_ms=1.0, current_ms=cur, candidate_ms=new,
                    current_queued_ms=cur, candidate_queued_ms=new,
                    current_turns_queued_ms=[cur, cur], candidate_turns_queued_ms=[new, new],
                    current_turns_ms=[cur, cur], candidate_turns_ms=[new, new])

    record = dict(card="NVIDIA H100 80GB HBM3, 700.00 W", torch="2.11", rows=[
        row("R1", 746497, "fit", 7.5, 3.1), row("R1", 8501, "held", 6.0, 2.9),
        row("R2", 15625, "fit", 2.4, 3.0), row("R3", 257, "held", 1.4, 2.6)])
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(record))
    torch_planner_rules.main(["--check", str(path)])
    out = capsys.readouterr().out
    assert "| fit | 746497 | 2 | old | 7.500 / 7.500 | new | 3.100 / 3.100 |" in out
    assert "| candidate | candidate |" in out and "| current | current |" in out
    for rule, set_ in (("R1", "fit"), ("R1", "held"), ("R2", "fit"), ("R3", "held")):
        assert f"{rule} {set_}: the planner of this tree takes the faster way (or a tie) at 1 " \
               "of 1 sizes" in out


def test_planner_rules_check_reprints_the_composite_rule(tmp_path, capsys):
    """--check reprints R4's three ways, from two records: 8199 (the rule
    takes the split, measured fastest: a win) and 41484 (it takes the
    split, where the Bluestein was measured faster in this made-up row: a
    loss)."""
    import json

    def row(n, set_, cur, new, split):
        out = dict(rule="R4", n=n, set=set_, batch=2, device="cuda", torch_fft_ms=1.0)
        for way, ms in (("current", cur), ("candidate", new), ("split", split)):
            out.update({way: way, f"{way}_ms": ms, f"{way}_queued_ms": ms,
                        f"{way}_turns_ms": [ms, ms], f"{way}_turns_queued_ms": [ms, ms]})
        return out

    paths = []
    for name, rows in (("fit.json", [row(8199, "fit", 6.0, 2.9, 1.8)]),
                       ("held.json", [row(41484, "held", 6.1, 3.0, 3.3)])):
        path = tmp_path / name
        path.write_text(json.dumps(dict(card="NVIDIA H100 80GB HBM3, 700.00 W", torch="2.11",
                                        rows=rows)))
        paths.append(str(path))
    torch_planner_rules.main(["--check", *paths])
    out = capsys.readouterr().out
    assert "`python3 tools/torch_planner_rules.py --check fit.json held.json`: runs" in out
    assert "| fit | 8199 | 2 | current | 6.000 / 6.000 | candidate | 2.900 / 2.900 | split | " \
           "1.800 / 1.800 | 1.000 | 2.07 / 2.07 | 3.33 / 3.33 | 0.000 | split | split | win |" in out
    assert "| 0.000 | candidate | split | loss |" in out
    assert "R4 fit: the planner of this tree takes the faster way (or a tie) at 1 of 1" in out
    assert "R4 held: the planner of this tree takes the faster way (or a tie) at 0 of 1" in out


def test_planner_rules_check_reprints_the_core_rule(tmp_path, capsys):
    """--check reprints R5's rows: each class by the planner's recipe
    (r5_class), the glued form taken where it was measured faster (B22),
    the core kept where it was (R4S), B23's one way against torch.fft, with
    each row's bound (r5_bound_ms), errors, launches and host times."""
    import json

    from rustfft_tpu_torch.planner import FftPlannerGpu

    planner = FftPlannerGpu(C64, device="cpu")
    classes = {n: torch_planner_rules.r5_class(planner.design_fft_for_len(n))
               for n in (1572869, 1051009, 1048583, 2097169, 4194301, 1000003)}
    assert classes == {1572869: "B22", 1051009: "R4S", 1048583: "B3a", 2097169: "B3b",
                       4194301: "B23", 1000003: None}

    def row(n, set_, batch, m, cls, core, glued):
        out = dict(rule="R5", n=n, set=set_, batch=batch, m=m, cls=cls, inner_route="large2f",
                   device="cuda", torch_fft_ms=5.0)
        for way, ms in (("current", core), ("candidate", glued)):
            if ms is not None:
                out.update({way: way, f"{way}_ms": ms, f"{way}_queued_ms": ms,
                            f"{way}_turns_ms": [ms, ms], f"{way}_turns_queued_ms": [ms, ms],
                            f"err_{way}_F": 3e-7, f"err_{way}_I": 3e-7,
                            f"{way}_launches": dict(kernels={"large_row_stage": 2},
                                                    host_ms=0.5)})
        return out

    path = tmp_path / "r5.json"
    path.write_text(json.dumps(dict(card="NVIDIA H100 80GB HBM3, 700.00 W", torch="2.11", rows=[
        row(1572869, "fit", 32, 1 << 22, "B22", 18.8, 7.5),
        row(1051009, "held", 32, 1051008, "R4S", 5.9, 6.6),
        row(4194301, "fit", 16, 1 << 23, "B23", 8.1, None)])))
    torch_planner_rules.main(["--check", str(path)])
    out = capsys.readouterr().out
    assert "| fit | B22 | 1572869 | 32 | large2f | current | 18.800 / 18.800 | candidate | " \
           "7.500 / 7.500 | 5.000 | 0.441 | 2.51 / 2.51 | 0.000 | candidate | candidate |" in out
    assert "| held | R4S | 1051009 | 32 | large2f | current | 5.900 / 5.900 | candidate | " \
           "6.600 / 6.600 | 5.000 | 0.161 | 0.89 / 0.89 | 0.000 | current | current |" in out
    assert "| 0.461 | - | 0.000 | current | current | 3.00e-07 / 3.00e-07 | - | " \
           "large_row_stage 2 | - | 0.500 |" in out
    assert "R5 fit: the executor of this tree takes the faster way (or a tie) at 2 of 2" in out
    assert "R5 held: the executor of this tree takes the faster way (or a tie) at 1 of 1" in out


def test_planner_rules_composite_samples(monkeypatch):
    """R4's samples, on the census of [8192, 12000) in place of [8192,
    2^20): the median of each inner length and the five named sizes;
    without a seed no held-out size, with one 5 sizes the rule sends to the
    split and 5 it sends to the Bluestein, apart from the sampled."""
    by_inner = torch_prime_cores.four_stage_composites(8192, 12000)
    monkeypatch.setattr(torch_prime_cores, "four_stage_composites", lambda: by_inner)
    fit, held = torch_planner_rules.r4_samples()
    medians = [by_inner[m][len(by_inner[m]) // 2] for m in sorted(by_inner)]
    assert fit == medians + list(torch_planner_rules.R4_NAMED) and held == []
    _, held = torch_planner_rules.r4_samples(20261018)
    census = {n for sizes in by_inner.values() for n in sizes}
    assert len(held) == 10 and set(held) <= census and not set(held) & set(fit)
    assert [torch_planner_rules.taken("R4", n) for n in held] == ["split"] * 5 + ["candidate"] * 5


def test_planner_rules_costs_and_glue_rows():
    """The cost sweep's row at 8199 = 9 x 911 and the glue sweep's at p = 9,
    on the CPU at batch 1: the split, its glue, its half (the one-pass
    core's Bluestein at m = 2048) and the Bluestein at m = 32768, each
    timed in its turns, the split and the Bluestein within 1e-5 of
    torch.fft."""
    import torch

    timers = torch_planner_rules.make_timers(torch.device("cpu"))
    row = torch_planner_rules.measure_costs(8199, 1, torch.device("cpu"), timers)
    assert (row["p"], row["q"], row["kind"], row["m_q"], row["m_a"]) == \
        (9, 911, "bluestein", 2048, 32768)
    assert row["form_q"] == "Bluesteins(m=2048) one-pass core"
    for way in torch_planner_rules.COST_WAYS:
        assert row[f"{way}_ms"] > 0 and len(row[f"{way}_turns_queued_ms"]) == 2
    assert row["err_split"] <= 1e-5 and row["err_bluestein"] <= 1e-5
    glue = torch_planner_rules.measure_glue(9, 8199, 1, torch.device("cpu"), timers)
    assert (glue["p"], glue["q"]) == (9, 911) and glue["glue_queued_ms"] > 0


def test_planner_rules_fit_writes_the_tables(tmp_path, capsys):
    """--fit COSTS GLUE prints split_costs.py: CORE_NS the median ns a
    transform of each half (queued ms over p x batch) and Bluestein (over
    batch), GLUE_PS the ps an element of the glue by p; the text runs, and
    its split_ns is p halves plus n elements of glue."""
    import json

    def cost_row(n, p, kind, m_q, m_a, half_ms, blue_ms, glue_ms, batch=4):
        return dict(rule="R4 costs", n=n, batch=batch, p=p, q=n // p, kind=kind, m_q=m_q,
                    m_a=m_a, half_queued_ms=half_ms, bluestein_queued_ms=blue_ms,
                    glue_queued_ms=glue_ms, split_queued_ms=half_ms + glue_ms)

    costs = dict(card="NVIDIA H100 80GB HBM3, 700.00 W", torch="2.11", rows=[
        cost_row(8199, 9, "bluestein", 2048, 32768, 9 * 4 * 23e-6, 4 * 700e-6, 4 * 8199 * 27e-9),
        cost_row(41484, 12, "rader", 3456, 131072, 12 * 4 * 162e-6, 4 * 3200e-6,
                 4 * 41484 * 24e-9)])
    glue = dict(card=costs["card"], torch="2.11", rows=[
        dict(rule="R4 glue", n=8199, batch=4, p=9, glue_queued_ms=4 * 8199 * 27.5e-9),
        dict(rule="R4 glue", n=41484, batch=4, p=12, glue_queued_ms=4 * 41484 * 23.8e-9)])
    paths = []
    for name, record in (("costs.json", costs), ("glue.json", glue)):
        path = tmp_path / name
        path.write_text(json.dumps(record))
        paths.append(str(path))
    torch_planner_rules.main(["--fit", *paths])
    captured = capsys.readouterr()
    assert "split / (glue + half): 1.000 .. 1.000 over 2 sizes" in captured.err
    module = {}
    exec(captured.out, module)
    assert module["CORE_NS"] == {("bluestein", 2048): 23.0, ("bluestein", 32768): 700.0,
                                 ("bluestein", 131072): 3200.0, ("rader", 3456): 162.0}
    assert module["GLUE_PS"] == {9: 27.5, 12: 23.8}
    assert module["split_ns"](9, 8199, "bluestein", 2048) == 9 * 23.0 + 8199 * 27.5 / 1e3
    assert module["split_ns"](5, 8199, "bluestein", 2048) is None
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in captured.out


def test_planner_rules_fit_takes_a_later_record_of_an_inner_length(tmp_path, capsys):
    """--fit COSTS COSTS2 GLUE: a later costs record's half samples of a
    (kind, inner length) replace the earlier record's (a sweep of the
    halves whose core changed); its Bluesteins' samples are left out, and
    the other entries stay."""
    import json

    def cost_row(n, p, m_q, m_a, half_ns, blue_ns, batch=4):
        return dict(rule="R4 costs", n=n, batch=batch, p=p, q=n // p, kind="bluestein", m_q=m_q,
                    m_a=m_a, half_queued_ms=p * batch * half_ns * 1e-6,
                    bluestein_queued_ms=batch * blue_ns * 1e-6, glue_queued_ms=1.0,
                    split_queued_ms=p * batch * half_ns * 1e-6 + 1.0)

    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    old = dict(card=card, torch="2.11", rows=[cost_row(90955, 5, 36864, 262144, 2316.3, 4000.0),
                                              cost_row(8199, 9, 2048, 32768, 23.0, 700.0)])
    new = dict(card=card, torch="2.11", rows=[cost_row(87545, 5, 36864, 262144, 900.0, 4200.0)])
    glue = dict(card=card, torch="2.11", rows=[dict(rule="R4 glue", n=8199, batch=4, p=9,
                                                    glue_queued_ms=1.0)])
    paths = []
    for name, record in (("old.json", old), ("new.json", new), ("glue.json", glue)):
        path = tmp_path / name
        path.write_text(json.dumps(record))
        paths.append(str(path))
    torch_planner_rules.main(["--fit", *paths])
    module = {}
    exec(capsys.readouterr().out, module)
    assert module["CORE_NS"] == {("bluestein", 2048): 23.0, ("bluestein", 32768): 700.0,
                                 ("bluestein", 36864): 900.0, ("bluestein", 262144): 4000.0}


# ---- tools/torch_autotune.py ----

def test_autotune_prints_a_row_per_size():
    proc = run(["tools/torch_autotune.py", "--device", "cpu", "--batch", "2", "--reps", "2",
                "64", "256"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = re.findall(r"^n=\s*(\d+) batch=\s*2 route=(\w+): auto=[\d.]+ +tree=[\d.]+ +"
                      r"torch\.fft=[\d.]+$", proc.stdout, flags=re.M)
    assert rows == [("64", "lanepack"), ("256", "lanepack")], proc.stdout
    assert "not a measurement of the card" in proc.stdout


def test_autotune_switches_follow_the_path():
    import torch_autotune

    assert torch_autotune.switches_read(1 << 20) == [("large_gauss", True),
                                                     ("large_blocks2d", True)]
    assert [s for s, _ in torch_autotune.switches_read(65537)] == [
        "conv_radix_gauss", "rader_in_shift", "rader_full_out"]
    assert torch_autotune.switches_read(7919) == [("conv_radix_gauss", True)]
    assert torch_autotune.switches_read(4096) == torch_autotune.switches_read(1009) == []


# ---- the examples ----

def _errors(text, label):
    return [float(v) for v in re.findall(label + r" = ([0-9.e+-]+)", text)]


def test_example_basic():
    proc = run(["examples/torch_basic.py", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "batch output shape: (8, 1234)" in out
    assert float(re.search(r"impulse max err: (\S+)", out).group(1)) < 1e-5
    assert float(re.search(r"batch rel err: (\S+)", out).group(1)) < 1e-5
    assert float(re.search(r"roundtrip max err: (\S+)", out).group(1)) < 1e-4


def test_example_concurrency():
    proc = run(["examples/torch_concurrency.py", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    errs = _errors(proc.stdout, "rel err")
    assert len(errs) == 3 * 2 * 4 and max(errs) < 1e-5, proc.stdout


def test_example_distributed():
    proc = run(["examples/torch_distributed.py", "--device", "cpu", "--ranks", "4",
                "--timeout", "200"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "on mesh {'data': 2, 'fft': 2} (cpu)" in proc.stdout
    errs = _errors(proc.stdout, "rel err")
    assert len(errs) == 2 and max(errs) < 1e-5, proc.stdout


# ---- shared state under threads ----

def test_build_cache_under_threads(monkeypatch):
    """executor.build's cache from more threads than cores, with a short
    switch interval and a cache of two entries: no lookup may meet its key
    evicted between the get and the move to the end (a KeyError before the
    cache took a lock), and threads that build one key together get one
    function."""
    monkeypatch.setattr(executor, "_CACHE", type(executor._CACHE)())
    monkeypatch.setattr(executor, "_CACHE_MAX", 2)
    trees = [recipes.Dft(n) for n in range(2, 10)]
    errors, got = [], [[] for _ in range(16)]

    def work(i):
        try:
            for k in range(1500):
                fn = executor.build(trees[(i + k) % len(trees)], FftDirection.FORWARD, C64)
                got[i].append(fn)
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert all(len(g) == 1500 for g in got)

    # one key built by many threads at once: one function for all
    monkeypatch.setattr(executor, "_CACHE", type(executor._CACHE)())
    barrier = threading.Barrier(8)
    fns = []

    def first(_):
        barrier.wait()
        fns.append(executor.build(recipes.Dft(12), FftDirection.INVERSE, C64))

    threads = [threading.Thread(target=first, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(fns) == 8 and len({id(f) for f in fns}) == 1


def test_native_first_load_under_threads(monkeypatch):
    """Threads that ask for the plancore library while its first load is
    under way all get it: none may see the load marked done before the
    library is there (and fall back to the Python path)."""
    if not os.path.exists(native._LIB_PATH):
        pytest.skip("no checked-in native/libplancore.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    real = ctypes.CDLL

    def slow(*args, **kwargs):
        time.sleep(0.2)
        return real(*args, **kwargs)

    monkeypatch.setattr(native.ctypes, "CDLL", slow)
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(native._load())) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(libs) == 8 and all(lib is not None for lib in libs)
    assert len({id(lib) for lib in libs}) == 1
