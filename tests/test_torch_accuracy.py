"""Integration accuracy sweep of the port: port of tests/test_accuracy.py
(reference tests/accuracy.rs).

The reference sweeps every length 1..1000 for f32+f64, fwd+inv, comparing
the planner's output against a control; pass = mean element error < 0.1
(accuracy.rs:30-37, 98-122).  Here the control is the host f64 DFT and the
planners run on device="cpu" (the kernels' plain torch versions); each
output is held to that bar and to a relative mean error of 1e-5
(complex64) or 1e-12 (complex128), and the scenario sizes also against the
JAX package's planner on the same input (1e-5).  As in
the JAX file, the exhaustive range is trimmed: full coverage 1..128, strided
coverage above, plus the BASELINE.md scenario sizes.  Set
RUSTFFT_TPU_FULL_SWEEP=1 for the reference's full 1..1000 range.
"""
import os

import numpy as np
import pytest

from rustfft_tpu_torch import FftDirection, FftPlanner, FftPlannerScalar
from rustfft_tpu_torch.utils.testing import mean_element_error, oracle_dft, random_signal

FULL = os.environ.get("RUSTFFT_TPU_FULL_SWEEP") == "1"

if FULL:
    SWEEP_SIZES = list(range(1, 1001))
else:
    SWEEP_SIZES = (
        list(range(1, 129))
        + list(range(129, 512, 13))
        + [255, 256, 512, 729, 1000, 1024]
    )

# BASELINE.md scenario sizes: planner path 1234; primes via Rader/Bluestein
# (65537 = F4, Rader inner 65536); mixed-radix 3^n*2^m composites; pow2.
SCENARIO_SIZES = [1234, 1009, 7919, 65537, 2592, 2916, 3**5 * 2**5, 4096, 65536]


#: relative mean error against the f64 oracle
REL_TOL = {np.complex64: 1e-5, np.complex128: 1e-12}


def _check(planner, n, direction, dtype, tol=0.1):
    plan = planner.plan_fft(n, direction)
    sig = random_signal(n, dtype=dtype, seed=1000 + n)
    out = plan.process(sig)
    assert out.dtype == dtype
    want = oracle_dft(sig, direction)
    err = mean_element_error(out, want)
    assert err < tol, f"n={n} dir={direction} dtype={dtype} err={err}"
    rel = err / float(np.mean(np.abs(want)))
    assert rel <= REL_TOL[dtype], f"n={n} dir={direction} dtype={dtype} relative err={rel}"


@pytest.fixture(scope="module")
def gpu_planner():
    return FftPlanner(device="cpu")


@pytest.fixture(scope="module")
def scalar_planner():
    return FftPlannerScalar(device="cpu")


@pytest.mark.parametrize("direction", [FftDirection.FORWARD, FftDirection.INVERSE])
@pytest.mark.parametrize("n", SWEEP_SIZES)
def test_sweep_c64_planner(gpu_planner, n, direction):
    _check(gpu_planner, n, direction, np.complex64)


@pytest.mark.parametrize("n", SWEEP_SIZES)
def test_sweep_c64_scalar_planner(scalar_planner, n):
    _check(scalar_planner, n, FftDirection.FORWARD, np.complex64)


@pytest.mark.parametrize("n", SWEEP_SIZES[:64] + [251, 509])
def test_sweep_c128(n):
    planner = FftPlannerScalar(np.complex128, device="cpu")
    _check(planner, n, FftDirection.FORWARD, np.complex128, tol=1e-6)


@pytest.fixture(scope="module")
def jax_planner():
    import rustfft_tpu
    return rustfft_tpu.FftPlanner(np.complex64)


@pytest.mark.parametrize("n", SCENARIO_SIZES)
def test_scenario_sizes(gpu_planner, jax_planner, n):
    # against the oracle, and against the JAX package's planner on the same
    # input at a relative mean error of 1e-5
    _check(gpu_planner, n, FftDirection.FORWARD, np.complex64)
    sig = random_signal(n, seed=1000 + n)
    got = gpu_planner.plan_fft_forward(n).process(sig)
    want = np.asarray(jax_planner.plan_fft_forward(n).process(sig))
    rel = mean_element_error(got, want) / float(np.mean(np.abs(want)))
    assert rel <= REL_TOL[np.complex64], f"n={n}: relative difference from JAX {rel}"


@pytest.mark.parametrize("n", [1009, 7919, 65537])
def test_prime_roundtrip(gpu_planner, n):
    # BASELINE config 3: prime fwd+inv roundtrip scales by n
    fwd = gpu_planner.plan_fft(n, FftDirection.FORWARD)
    inv = gpu_planner.plan_fft(n, FftDirection.INVERSE)
    sig = random_signal(n, seed=7)
    out = inv.process(fwd.process(sig)) / n
    err = mean_element_error(out, sig)
    assert err < 1e-3, err
