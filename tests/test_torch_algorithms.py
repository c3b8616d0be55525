"""Per-algorithm conformance of the port.

Mirrors tests/test_algorithms.py (the reference's per-algorithm unit tests,
e.g. radix4.rs:207-245, bluesteins_algorithm.rs:202-226): every algorithm is
exercised through hand-built recipes, independent of planner choices, by the
port's check_fft_algorithm on device="cpu" against the f64 oracle, in both
directions, at the reference's bar (mean element error < 0.1) and at a
relative mean error of 1e-5 (complex64) or 1e-12 (complex128).  Each recipe
runs as built (pinned, its literal recipe) and as the executor lowers it by
default (whole-transform kernels and convolution cores in their plain torch
versions where they serve a node).
"""
import numpy as np
import pytest

from rustfft_tpu_torch import FftDirection, FftPlanner, recipes
from rustfft_tpu_torch.plan import FftPlan
from rustfft_tpu_torch.planner import BUTTERFLY_SIZES
from rustfft_tpu_torch.utils.testing import check_fft_algorithm, random_signal

DIRECTIONS = [FftDirection.FORWARD, FftDirection.INVERSE]
#: relative mean error against the f64 oracle
REL_TOL = {np.complex64: 1e-5, np.complex128: 1e-12}


@pytest.fixture(params=[False, True], ids=["lowered", "pinned"])
def pinned(request):
    return request.param


def run(recipe, direction, pinned, dtype=np.complex64):
    plan = FftPlan(recipe, direction, dtype, device="cpu", pinned=pinned)
    assert plan.pinned is pinned
    err = check_fft_algorithm(plan, recipe.length, direction, dtype)
    assert err <= REL_TOL[dtype], f"{recipe!r} {direction}: relative error {err:.3e}"


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("n", list(range(1, 33)) + [50, 100, 256])
def test_dft(n, direction, pinned):
    # algorithm/dft.rs:84-126 oracle tests, any size
    run(recipes.Dft(n), direction, pinned)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize(
    "n", [2, 3, 4, 5, 6, 7, 8, 9, 11, 12, 13, 16, 17, 19, 23, 24, 27, 29, 31, 32]
)
def test_butterflies(n, direction, pinned):
    # algorithm/butterflies.rs per-size tests
    run(recipes.Butterfly(n), direction, pinned)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("k", [0, 1, 2, 3])
@pytest.mark.parametrize("base", [1, 2, 4, 8, 16, 32])
def test_radix4(k, base, direction, pinned):
    # radix4.rs:207-245: test_radix4 over bases and exponents
    leaf = recipes.Butterfly(base) if base > 1 else recipes.Dft(base)
    run(recipes.Radix4(k, leaf), direction, pinned)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize(
    "factors,base",
    [((2,), 8), ((3,), 8), ((5,), 4), ((6,), 4), ((7,), 3), ((2, 3), 8),
     ((7, 6, 5, 3, 2), 4), ((4, 4), 12), ((3, 3, 3), 27)],
)
def test_radixn(factors, base, direction, pinned):
    # radixn.rs unit tests: arbitrary factor chains over bases
    run(recipes.RadixN(factors, recipes.Butterfly(base)), direction, pinned)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("width,height",
                         [(2, 3), (3, 4), (4, 5), (7, 8), (12, 16), (16, 32), (31, 32)])
def test_mixed_radix(width, height, direction, pinned):
    # mixed_radix.rs unit tests
    leaf = recipes.Butterfly if width in BUTTERFLY_SIZES else recipes.Dft
    run(recipes.MixedRadix(leaf(width), leaf(height)), direction, pinned)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("width,height", [(2, 3), (3, 4), (4, 5), (7, 8), (11, 12)])
def test_mixed_radix_small(width, height, direction, pinned):
    run(recipes.MixedRadixSmall(recipes.Butterfly(width), recipes.Butterfly(height)),
        direction, pinned)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("width,height",
                         [(2, 3), (3, 4), (4, 5), (7, 8), (9, 16), (11, 13), (16, 27), (25, 32)])
def test_good_thomas(width, height, direction, pinned):
    # good_thomas_algorithm.rs unit tests: coprime pairs
    run(recipes.GoodThomas(recipes.Dft(width), recipes.Dft(height)), direction, pinned)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("width,height", [(2, 3), (3, 4), (5, 6), (9, 16), (11, 13)])
def test_good_thomas_small(width, height, direction, pinned):
    run(recipes.GoodThomasSmall(recipes.Butterfly(width), recipes.Butterfly(height)),
        direction, pinned)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("p", [3, 5, 7, 11, 13, 17, 97, 101, 257])
def test_raders(p, direction, pinned):
    # raders_algorithm.rs unit tests: prime sizes, inner fft of size p-1
    run(recipes.Raders(recipes.Dft(p - 1)), direction, pinned)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("n,inner",
                         [(3, 8), (5, 16), (7, 13), (12, 23), (31, 64), (100, 256), (257, 1024)])
def test_bluestein(n, inner, direction, pinned):
    # bluesteins_algorithm.rs unit tests: any inner size >= 2n-1
    assert inner >= 2 * n - 1
    run(recipes.Bluesteins(n, recipes.Dft(inner)), direction, pinned)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_nested_composition(direction, pinned):
    # deep tree: Bluestein over Radix4 over MixedRadix inner pieces
    inner = recipes.Radix4(2, recipes.Butterfly(16))  # 256
    run(recipes.Bluesteins(101, inner), direction, pinned)
    recipe = recipes.Raders(recipes.MixedRadix(recipes.Butterfly(4), recipes.Butterfly(7)))  # 29
    run(recipe, direction, pinned)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_dtypes(dtype, pinned):
    # f32 and f64 parity (reference FftNum over f32/f64, common.rs:5-7)
    run(recipes.MixedRadix(recipes.Butterfly(24), recipes.Dft(50)), FftDirection.FORWARD,
        pinned, dtype)


def test_roundtrip_unnormalized():
    # forward+inverse roundtrip scales by n (lib.rs:81-86)
    n = 240
    planner = FftPlanner(device="cpu")
    fwd = planner.plan_fft_forward(n)
    inv = planner.plan_fft_inverse(n)
    x = random_signal(n)
    out = np.asarray(inv.process(fwd.process(x)))
    np.testing.assert_allclose(out, x * n, rtol=1e-4, atol=1e-3)
