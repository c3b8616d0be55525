"""The hand-built constructors of rustfft_tpu_torch.algorithm.

Mirrors tests/test_algorithm_api.py on the CPU (device="cpu"): every
constructor through the port's check_fft_algorithm (the f64 oracle at the
reference's mean-error bar of 0.1), every rejection, a hand-built tree
against the planner, and each constructor against its rustfft_tpu.algorithm
counterpart on the same input at a relative mean error of 1e-5 (c64) or
1e-12 (c128).  Every constructor builds a pinned plan on the device of its
inner plans.
"""
import functools

import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu import algorithm as ref_alg
from rustfft_tpu_torch import FftDirection, FftPlanner, algorithm, recipes
from rustfft_tpu_torch.utils.testing import check_fft_algorithm, random_signal

DIRECTIONS = [FftDirection.FORWARD, FftDirection.INVERSE]
CPU = "cpu"


def _ref_dir(direction):
    return rustfft_tpu.FftDirection(direction.value)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_dft_constructor(direction):
    check_fft_algorithm(algorithm.Dft(50, direction, device=CPU), 50, direction)


@pytest.mark.parametrize("n", [2, 7, 16, 31, 32])
def test_butterfly_constructor(n):
    d = FftDirection.FORWARD
    check_fft_algorithm(algorithm.Butterfly(n, d, device=CPU), n, d)


def test_butterfly_rejects_unknown_size():
    with pytest.raises(ValueError):
        algorithm.Butterfly(10, FftDirection.FORWARD, device=CPU)


@pytest.mark.parametrize("n", [1, 8, 16, 64, 128, 256, 2048])
def test_radix4_constructor(n):
    d = FftDirection.FORWARD
    check_fft_algorithm(algorithm.Radix4(n, d, device=CPU), n, d)


def test_radix4_rejects_non_pow2():
    with pytest.raises(ValueError):
        algorithm.Radix4(12, FftDirection.FORWARD, device=CPU)


@pytest.mark.parametrize("n", [3, 27, 81, 729])
def test_radix3_constructor(n):
    d = FftDirection.FORWARD
    check_fft_algorithm(algorithm.Radix3(n, d, device=CPU), n, d)


def test_radix3_rejects_non_pow3():
    with pytest.raises(ValueError):
        algorithm.Radix3(12, FftDirection.FORWARD, device=CPU)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_mixed_radix_composition(direction):
    w = algorithm.Dft(12, direction, device=CPU)
    h = algorithm.Radix4(16, direction, device=CPU)
    check_fft_algorithm(algorithm.MixedRadix(w, h), 192, direction)


def test_mixed_radix_small():
    d = FftDirection.FORWARD
    plan = algorithm.MixedRadixSmall(algorithm.Butterfly(4, d, device=CPU),
                                     algorithm.Butterfly(6, d, device=CPU))
    check_fft_algorithm(plan, 24, d)


def test_mixed_radix_rejects_mismatched_directions():
    w = algorithm.Dft(4, FftDirection.FORWARD, device=CPU)
    h = algorithm.Dft(5, FftDirection.INVERSE, device=CPU)
    with pytest.raises(ValueError):
        algorithm.MixedRadix(w, h)


def test_composites_reject_mismatched_dtypes():
    w = algorithm.Dft(4, FftDirection.FORWARD, np.complex64, device=CPU)
    h = algorithm.Dft(5, FftDirection.FORWARD, np.complex128, device=CPU)
    with pytest.raises(ValueError, match="dtype"):
        algorithm.MixedRadix(w, h)


def test_composites_reject_mismatched_devices():
    """The inner plans must share a device (the card's plans are built but
    never run here)."""
    w = algorithm.Dft(4, FftDirection.FORWARD, device=CPU)
    h = algorithm.Dft(5, FftDirection.FORWARD, device="cuda")
    for ctor in (algorithm.MixedRadix, algorithm.MixedRadixSmall, algorithm.GoodThomasAlgorithm,
                 algorithm.GoodThomasAlgorithmSmall):
        with pytest.raises(ValueError, match="device"):
            ctor(w, h)


def test_leaves_default_to_the_card_and_composites_follow_their_inner():
    d = FftDirection.FORWARD
    assert algorithm.Dft(8, d).device == torch.device("cuda")
    assert algorithm.Radix4(64, d).device == torch.device("cuda")
    inner = algorithm.Radix4(256, d, device=CPU)
    for plan in (algorithm.BluesteinsAlgorithm(100, inner),
                 algorithm.RadersAlgorithm(algorithm.Dft(12, d, device=CPU)),
                 algorithm.MixedRadix(inner, inner)):
        assert plan.device == torch.device(CPU) and plan.pinned


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_good_thomas_composition(direction):
    w = algorithm.Dft(9, direction, device=CPU)
    h = algorithm.Dft(16, direction, device=CPU)
    check_fft_algorithm(algorithm.GoodThomasAlgorithm(w, h), 144, direction)
    check_fft_algorithm(
        algorithm.GoodThomasAlgorithmSmall(algorithm.Butterfly(9, direction, device=CPU),
                                           algorithm.Butterfly(16, direction, device=CPU)),
        144, direction,
    )


@pytest.mark.parametrize("ctor", ["GoodThomasAlgorithm", "GoodThomasAlgorithmSmall"])
def test_good_thomas_rejects_non_coprime(ctor):
    d = FftDirection.FORWARD
    with pytest.raises(ValueError, match="coprime"):
        getattr(algorithm, ctor)(algorithm.Dft(4, d, device=CPU), algorithm.Dft(6, d, device=CPU))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_raders_composition(direction):
    inner = algorithm.Dft(12, direction, device=CPU)  # 13 prime
    check_fft_algorithm(algorithm.RadersAlgorithm(inner), 13, direction)


def test_raders_rejects_composite():
    inner = algorithm.Dft(13, FftDirection.FORWARD, device=CPU)  # 14 not prime
    with pytest.raises(ValueError):
        algorithm.RadersAlgorithm(inner)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_bluesteins_composition(direction):
    inner = algorithm.Radix4(256, direction, device=CPU)
    check_fft_algorithm(algorithm.BluesteinsAlgorithm(100, inner), 100, direction)


def test_bluesteins_rejects_short_inner():
    inner = algorithm.Radix4(128, FftDirection.FORWARD, device=CPU)
    with pytest.raises(ValueError):
        algorithm.BluesteinsAlgorithm(100, inner)


def test_hand_built_matches_planner():
    """A hand-built tree and the planner's plan agree."""
    d = FftDirection.FORWARD
    hand = algorithm.MixedRadix(algorithm.Dft(30, d, device=CPU), algorithm.Dft(40, d, device=CPU))
    auto = FftPlanner(device=CPU).plan_fft_forward(1200)
    sig = (np.random.default_rng(3).standard_normal(1200)
           + 1j * np.random.default_rng(4).standard_normal(1200)).astype(np.complex64)
    assert _rel(hand.process(sig), auto.process(sig)) <= 1e-5


@functools.lru_cache(maxsize=None)
def _pairs(d, dtype):
    """(port plan, JAX plan, length) for every constructor."""
    rd = _ref_dir(d)

    def both(name, *args):
        return (getattr(algorithm, name)(*args, d, dtype, device=CPU),
                getattr(ref_alg, name)(*args, rd, dtype))

    dft, ref_dft = both("Dft", 50)
    bf, ref_bf = both("Butterfly", 16)
    r4, ref_r4 = both("Radix4", 4096)
    r3, ref_r3 = both("Radix3", 729)
    b4, ref_b4 = both("Butterfly", 4)
    b6, ref_b6 = both("Butterfly", 6)
    b7, ref_b7 = both("Butterfly", 7)
    r128, ref_r128 = both("Radix4", 128)
    b9, ref_b9 = both("Butterfly", 9)
    inner1008 = algorithm.MixedRadix(algorithm.Dft(28, d, dtype, device=CPU),
                                     algorithm.Dft(36, d, dtype, device=CPU))
    ref1008 = ref_alg.MixedRadix(ref_alg.Dft(28, rd, dtype), ref_alg.Dft(36, rd, dtype))
    return {
        "Dft": (dft, ref_dft, 50),
        "Butterfly": (bf, ref_bf, 16),
        "Radix4": (r4, ref_r4, 4096),
        "Radix3": (r3, ref_r3, 729),
        "MixedRadix": (algorithm.MixedRadix(r128, bf), ref_alg.MixedRadix(ref_r128, ref_bf), 2048),
        "MixedRadixSmall": (algorithm.MixedRadixSmall(b4, b6),
                            ref_alg.MixedRadixSmall(ref_b4, ref_b6), 24),
        "GoodThomasAlgorithm": (algorithm.GoodThomasAlgorithm(b7, r128),
                                ref_alg.GoodThomasAlgorithm(ref_b7, ref_r128), 896),
        "GoodThomasAlgorithmSmall": (algorithm.GoodThomasAlgorithmSmall(b9, bf),
                                     ref_alg.GoodThomasAlgorithmSmall(ref_b9, ref_bf), 144),
        "RadersAlgorithm": (algorithm.RadersAlgorithm(inner1008),
                            ref_alg.RadersAlgorithm(ref1008), 1009),
        "BluesteinsAlgorithm": (algorithm.BluesteinsAlgorithm(1234, r4),
                                ref_alg.BluesteinsAlgorithm(1234, ref_r4), 1234),
    }


CONSTRUCTORS = ["Dft", "Butterfly", "Radix4", "Radix3", "MixedRadix", "MixedRadixSmall",
                "GoodThomasAlgorithm", "GoodThomasAlgorithmSmall", "RadersAlgorithm",
                "BluesteinsAlgorithm"]


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructor_matches_reference(name, direction, dtype):
    """Each of the ten constructors against its rustfft_tpu.algorithm
    counterpart: the same recipe, pinned, and the same output on the same
    input (rel. mean error 1e-5 for c64, 1e-12 for c128), both held to the
    f64 oracle."""
    tol = 1e-5 if dtype == np.complex64 else 1e-12
    pairs = _pairs(direction, dtype)
    assert sorted(pairs) == sorted(CONSTRUCTORS)
    plan, ref_plan, n = pairs[name]
    assert plan.pinned and len(plan) == n == len(ref_plan)
    assert plan.recipe == recipes.from_reference_recipe(ref_plan.recipe)
    x = random_signal(2 * n, dtype=dtype, seed=n).reshape(2, n)
    got = plan.process(x)
    assert got.dtype == dtype
    assert _rel(got, np.asarray(ref_plan.process(x))) <= tol
    want = np.fft.fft(x) if direction is FftDirection.FORWARD else np.fft.ifft(x) * n
    assert _rel(got, want) <= tol
