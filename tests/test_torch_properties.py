"""DFT mathematical-property tests of the port across planner-chosen recipes.

Mirrors tests/test_properties.py on the CPU (device="cpu"): beyond oracle
comparison (test_torch_accuracy.py), these pin algebraic identities that
catch sign, conjugation and permutation bugs independent of the oracle:
roundtrip (inverse(forward(x)) = n*x), linearity, the shift theorem, impulse
response, Parseval's theorem and conjugate symmetry, with the JAX file's
bounds.
"""
import numpy as np
import pytest

from rustfft_tpu_torch import FftPlanner
from rustfft_tpu_torch.utils.testing import random_signal

# mix of size classes: pow2, 2^a*3^b, butterfly-product, primes (Rader,
# Bluestein), awkward composite, prime power
SIZES = [8, 64, 243, 288, 1009, 617, 1234, 121, 1024]


@pytest.fixture(scope="module")
def planner():
    return FftPlanner(device="cpu")


@pytest.mark.parametrize("n", SIZES)
def test_roundtrip_scales_by_n(planner, n):
    fwd = planner.plan_fft_forward(n)
    inv = planner.plan_fft_inverse(n)
    x = random_signal(n, seed=n)
    rt = inv.process(fwd.process(x)) / n
    assert np.mean(np.abs(rt - x)) < 1e-3


@pytest.mark.parametrize("n", SIZES)
def test_linearity(planner, n):
    fft = planner.plan_fft_forward(n)
    a = random_signal(n, seed=n)
    b = random_signal(n, seed=n + 1)
    lhs = fft.process(2.0 * a + 3.0j * b)
    rhs = 2.0 * fft.process(a) + 3.0j * fft.process(b)
    assert np.mean(np.abs(lhs - rhs)) < 1e-3


@pytest.mark.parametrize("n", SIZES)
def test_impulse_is_flat(planner, n):
    fft = planner.plan_fft_forward(n)
    x = np.zeros(n, dtype=np.complex64)
    x[0] = 1.0
    assert np.mean(np.abs(fft.process(x) - 1.0)) < 1e-4


@pytest.mark.parametrize("n", SIZES)
def test_shift_theorem(planner, n):
    """FFT(roll(x, 1))[k] = FFT(x)[k] * e^(-2 pi i k / n)."""
    fft = planner.plan_fft_forward(n)
    x = random_signal(n, seed=n + 7)
    lhs = fft.process(np.roll(x, 1))
    k = np.arange(n)
    rhs = fft.process(x) * np.exp(-2j * np.pi * k / n)
    assert np.mean(np.abs(lhs - rhs)) < 1e-3


@pytest.mark.parametrize("n", SIZES)
def test_parseval(planner, n):
    fft = planner.plan_fft_forward(n)
    x = random_signal(n, seed=n + 13)
    out = fft.process(x)
    time_energy = float(np.sum(np.abs(x) ** 2))
    freq_energy = float(np.sum(np.abs(out.astype(np.complex128)) ** 2)) / n
    assert abs(time_energy - freq_energy) / time_energy < 1e-4


@pytest.mark.parametrize("n", [64, 1009])
def test_conjugate_symmetry_real_input(planner, n):
    """Real input -> X[k] = conj(X[n-k])."""
    fft = planner.plan_fft_forward(n)
    x = random_signal(n, seed=n + 29).real.astype(np.complex64)
    out = fft.process(x)
    mirrored = np.conj(out[(-np.arange(n)) % n])
    assert np.mean(np.abs(out - mirrored)) < 1e-3
