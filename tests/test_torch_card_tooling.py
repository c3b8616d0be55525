"""The port's tools and the concurrency example on the card.

Marked `cuda`: each skips without a GPU (the CUDA kernels have no CPU
mode).  Run on the card with `python -m pytest -m cuda
tests/test_torch_card_tooling.py`.  This file imports no JAX:
tools/torch_accuracy.py's run_check at one size of each route and of each
convolution core form, both directions, against the host float64 oracle
(K14's four stages at 1051009, a Rader above 2^20, and, below 2^20, where
no planner path reaches them with the switches at their defaults, through
executor.build on the whole-n Bluestein that the composite rule replaced
at 196609; and at 1572869, where R5, the core rule above 2^20, replaced
them by the glued form, through executor.build(core_rule=False));
tools/torch_inspect_plan.py's launch counts at 4096 and 65537, which must
equal those chip_smoke.py's phase 3 expects of the same paths (4096 x 8:
one lanepack_pipe_fft; 65537 x 512: one launch of each of the two-pass
core's cluster passes); examples/torch_concurrency.py's check (one plan
from four threads at 4096, 1009 and 2^20).  The CPU side is
tests/test_torch_tooling.py.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.append(TOOLS)

import torch_accuracy  # noqa: E402
import torch_inspect_plan  # noqa: E402

#: the core forms no planner path below 2^20 reaches with the switches at
#: their defaults, each at a composite whose whole-n Bluestein
#: (FftPlannerGpu._conv_composite_recipe) runs it: 196609, inner 419904
REPLACED = {"K14 four stages": 196609}

#: one size of each route and each core form (the first the list gives it),
#: and of each form in REPLACED
ONE_EACH = {**{name: sizes[0] for name, sizes in torch_accuracy.ROUTE_SIZES.items()},
            **{form: sizes[0] for form, sizes in torch_accuracy.FORM_SIZES.items() if sizes},
            **{f"{form}, replaced": n for form, n in REPLACED.items()}}

#: chip_smoke.py phase 3's expected launches of the same paths
LAUNCHES = {4096: {"lanepack_pipe_fft": 1},
            65537: {"conv_radix_pass1": 1, "conv_radix_pass2": 1}}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("what", list(ONE_EACH))
def test_accuracy_one_size_each(what, cuda_device):
    n = ONE_EACH[what]
    form = what.removesuffix(", replaced")
    if form != what:
        check_replaced(form, n, cuda_device)
        return
    for check in torch_accuracy.planner_checks([n]):
        r = torch_accuracy.run_check(check, cuda_device)
        assert r["ok"], r
        assert what in (r["route"], r["form"]), r


def check_replaced(form, n, device):
    """The whole-n Bluestein that the composite rule replaced at n, through
    executor.build, both directions, batch 4: its inner on `form`, K14's
    four launches, within the complex64 bar of the host float64 oracle."""
    from rustfft_tpu_torch import FftDirection, executor
    from rustfft_tpu_torch.ops.kernels import launch_counters
    from rustfft_tpu_torch.planner import FftPlannerGpu
    from rustfft_tpu_torch.utils.testing import oracle_dft, random_signal

    planner = FftPlannerGpu(np.complex64, device=device)
    recipe = planner._conv_composite_recipe(n)
    assert recipe != planner.design_fft_for_len(n)
    assert executor.core_form("bluestein", recipe.inner.length, np.complex64) == form
    x = random_signal(4 * n, dtype=np.complex64, seed=1000 + n).reshape(4, n)
    counters = launch_counters()
    for direction in (FftDirection.FORWARD, FftDirection.INVERSE):
        fn = executor.build(recipe, direction, np.complex64)
        for counter in counters.values():
            counter.launches = 0
        got = fn(torch.from_numpy(x).to(device)).cpu().numpy()
        launched = {name: c.launches for name, c in counters.items() if c.launches}
        assert launched == {"conv_col_stage": 2, "conv_row_stage": 2}
        want = oracle_dft(x, direction)
        rel = float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))
        assert rel <= torch_accuracy.REL_BAR["complex64"], (direction, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("n", torch_accuracy.R5_REPLACED)
def test_accuracy_core_rule_replaced(n, cuda_device):
    """The planner's recipe at R5's prime on the core the rule replaced
    (executor.build(core_rule=False): K14's four stages), both directions,
    batch 1, within the bars of the host float64 oracle, as default_checks
    runs it."""
    for direction in torch_accuracy.DIRECTIONS:
        check = torch_accuracy.Check(n, direction, core_rule=False)
        r = torch_accuracy.run_check(check, cuda_device)
        assert r["ok"], r
        assert r["form"] == "K14 four stages", r


@pytest.mark.cuda
@pytest.mark.parametrize("n", sorted(LAUNCHES))
def test_inspect_plan_launches(n, cuda_device):
    info = torch_inspect_plan.inspect(n, device=cuda_device, trace=True)
    assert info["launches"] == LAUNCHES[n]
    assert len(info["trace"]) >= sum(LAUNCHES[n].values())


@pytest.mark.cuda
def test_concurrency_check(cuda_device):
    spec = importlib.util.spec_from_file_location(
        "torch_concurrency", os.path.join(REPO, "examples", "torch_concurrency.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    results = module.check(cuda_device)
    assert len(results) == 24 and max(e for *_, e in results) <= module.TOL
