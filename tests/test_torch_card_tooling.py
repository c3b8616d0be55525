"""The port's tools and the concurrency example on the card.

Marked `cuda`: each skips without a GPU (the CUDA kernels have no CPU
mode).  Run on the card with `python -m pytest -m cuda
tests/test_torch_card_tooling.py`.  This file imports no JAX:
tools/torch_accuracy.py's run_check at one size of each route and of each
convolution core form, both directions, against the host float64 oracle;
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

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.append(TOOLS)

import torch_accuracy  # noqa: E402
import torch_inspect_plan  # noqa: E402

#: one size of each route and each core form: the first the list gives it
ONE_EACH = {**{name: sizes[0] for name, sizes in torch_accuracy.ROUTE_SIZES.items()},
            **{form: sizes[0] for form, sizes in torch_accuracy.FORM_SIZES.items()}}

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
    for check in torch_accuracy.planner_checks([n]):
        r = torch_accuracy.run_check(check, cuda_device)
        assert r["ok"], r
        assert what in (r["route"], r["form"]), r


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
