"""Every size the port once refused now plans and computes.

Both planners of the port, complex64 and complex128, every n in 0..299 and
617, 1009, 1234, 7919 and 65537: no NotImplementedError, and the output of
`plan_fft_forward(n).process(x)` agrees with the float64 oracle and with the
JAX package's FftPlanner (Pallas off) to 1e-5 relative mean error in c64
and 1e-12 in c128; the inverse agrees with the oracle to the same bars.
On the CPU the c64 kernel paths run their plain torch versions.
"""
import numpy as np
import pytest

import rustfft_tpu
from rustfft_tpu import config as ref_config
from rustfft_tpu_torch import FftPlanner, FftPlannerScalar
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.twiddles import host_dft

SIZES = list(range(300)) + [617, 1009, 1234, 7919, 65537]
TOL = {np.complex64: 1e-5, np.complex128: 1e-12}
PLANNERS = {"planner": FftPlanner, "scalar": FftPlannerScalar}


def _signal(n, dtype):
    rng = np.random.default_rng(n)
    return (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(dtype)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


@pytest.fixture(scope="module")
def reference_forward():
    """JAX FftPlanner (Pallas off) forward output for (dtype, n), computed
    once for both port planners."""
    planners = {}
    cache = {}

    def get(dtype, n):
        if (dtype, n) not in cache:
            old = ref_config.use_pallas
            ref_config.use_pallas = "off"
            try:
                planner = planners.setdefault(dtype, rustfft_tpu.FftPlanner(dtype))
                cache[dtype, n] = np.asarray(planner.plan_fft_forward(n).process(_signal(n, dtype)))
            finally:
                ref_config.use_pallas = old
        return cache[dtype, n]

    return get


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["c64", "c128"])
@pytest.mark.parametrize("planner", sorted(PLANNERS))
def test_every_size_plans_and_matches(planner, dtype, n, reference_forward):
    port = PLANNERS[planner](dtype, device="cpu")
    x = _signal(n, dtype)
    fwd = port.plan_fft_forward(n).process(x)
    inv = port.plan_fft_inverse(n).process(x)
    assert fwd.shape == x.shape and fwd.dtype == dtype and inv.shape == x.shape
    if n == 0:
        return
    assert np.all(np.isfinite(fwd)) and np.all(np.isfinite(inv))
    assert _rel(fwd, host_dft(x, FftDirection.FORWARD)) <= TOL[dtype]
    assert _rel(inv, host_dft(x, FftDirection.INVERSE)) <= TOL[dtype]
    assert _rel(fwd, reference_forward(dtype, n)) <= TOL[dtype]
