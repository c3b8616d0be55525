"""Public-API contract of the port (reference: src/lib.rs:140-278,
fft_helper.rs).

Mirrors tests/test_api.py on the CPU (device="cpu"), each output also held
against the JAX package's FftPlanner on the same input (relative mean error
1e-5 for c64, 1e-12 for c128).  The buffer contract that
tests/test_torch_slice.py checks for FftPlanner (wrong length, zero length,
length one, negative length) is a case here for each of the three planners.
"""
import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu_torch import (FftBufferError, FftPlanner, FftPlannerGpu, FftPlannerScalar,
                               Forward, Inverse)
from rustfft_tpu_torch.utils.testing import oracle_dft, random_signal

PLANNERS = {"FftPlanner": FftPlanner, "FftPlannerGpu": FftPlannerGpu,
            "FftPlannerScalar": FftPlannerScalar}


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


@pytest.fixture(scope="module")
def reference():
    return rustfft_tpu.FftPlanner()


def test_direction_opposite():
    # lib.rs:164-170
    assert Forward.opposite() is Inverse
    assert Inverse.opposite() is Forward


def test_batch_chunking_flat_buffer(reference):
    # lib.rs:195-211: buffer of k*n runs k independent FFTs
    n, k = 32, 5
    plan = FftPlanner(device="cpu").plan_fft_forward(n)
    sig = random_signal(n * k)
    out = plan.process(sig)
    assert out.shape == (n * k,)
    expected = oracle_dft(sig.reshape(k, n), Forward).reshape(-1)
    np.testing.assert_allclose(out, expected, rtol=1e-3, atol=1e-3)
    assert _rel(out, np.asarray(reference.plan_fft_forward(n).process(sig))) <= 1e-5


def test_batch_leading_dims(reference):
    n = 24
    plan = FftPlanner(device="cpu").plan_fft_forward(n)
    sig = random_signal(2 * 3 * n).reshape(2, 3, n)
    out = plan.process(sig)
    assert out.shape == (2, 3, n)
    np.testing.assert_allclose(out, oracle_dft(sig, Forward), rtol=1e-3, atol=1e-3)
    assert _rel(out, np.asarray(reference.plan_fft_forward(n).process(sig))) <= 1e-5


@pytest.mark.parametrize("name", list(PLANNERS))
def test_buffer_contract(name):
    # the analogue of the reference's buffer-misuse panics (common.rs:11-104),
    # plan.rs:872-882 (length 0) and length 1 as the identity
    planner = PLANNERS[name](device="cpu")
    with pytest.raises(FftBufferError):
        planner.plan_fft_forward(32).process(random_signal(33))
    zero = planner.plan_fft_forward(0)
    assert zero.process(np.array([], dtype=np.complex64)).size == 0
    with pytest.raises(FftBufferError):
        zero.process(random_signal(4))
    sig = random_signal(7)  # 7 chunks of length 1
    np.testing.assert_array_equal(planner.plan_fft_forward(1).process(sig), sig)
    with pytest.raises(ValueError):
        planner.plan_fft_forward(-1)


def test_scratch_api_parity():
    # lib.rs:214-277: all process variants agree; scratch queries return 0
    plan = FftPlanner(device="cpu").plan_fft_forward(30)
    sig = random_signal(30)
    base = plan.process(sig)
    np.testing.assert_array_equal(base, plan.process_with_scratch(sig, None))
    np.testing.assert_array_equal(base, plan.process_outofplace_with_scratch(sig, None, None))
    np.testing.assert_array_equal(base, plan.process_immutable_with_scratch(sig, None, None))
    assert plan.get_inplace_scratch_len() == 0
    assert plan.get_outofplace_scratch_len() == 0
    assert plan.get_immutable_scratch_len() == 0


def test_plan_is_callable():
    plan = FftPlanner(device="cpu").plan_fft_forward(16)
    sig = random_signal(16)
    np.testing.assert_array_equal(plan(sig), plan.process(sig))


def test_real_input_promoted():
    plan = FftPlanner(device="cpu").plan_fft_forward(16)
    x = np.arange(16, dtype=np.float32)
    out = plan.process(x)
    assert out.dtype == np.complex64
    np.testing.assert_allclose(out, np.fft.fft(x), rtol=1e-4, atol=1e-3)


def test_c128_dtype_plan():
    plan = FftPlanner(np.complex128, device="cpu").plan_fft_forward(100)
    sig = random_signal(100, dtype=np.complex128)
    out = plan.process(sig)
    assert out.dtype == np.complex128
    np.testing.assert_allclose(out, np.fft.fft(sig), rtol=1e-9, atol=1e-9)
    ref = rustfft_tpu.FftPlanner(np.complex128).plan_fft_forward(100)
    assert _rel(out, np.asarray(ref.process(sig))) <= 1e-12


def test_size_1234_readme_example(reference):
    # the README example config (BASELINE config 1): size-1234 forward c32
    fft = FftPlanner(device="cpu").plan_fft_forward(1234)
    out = fft.process(np.zeros(1234, dtype=np.complex64))
    assert out.shape == (1234,)
    np.testing.assert_allclose(out, 0)
    sig = random_signal(1234)
    got = fft.process(sig)
    np.testing.assert_allclose(got, np.fft.fft(sig), rtol=1e-3, atol=1e-2)
    assert _rel(got, np.asarray(reference.plan_fft_forward(1234).process(sig))) <= 1e-5


@pytest.mark.parametrize("n", [48, 210, 1009])
def test_planner_scalar_matches_gpu_planner(n, reference):
    # different planners, identical math
    sig = random_signal(n)
    a = FftPlannerScalar(device="cpu").plan_fft_forward(n).process(sig)
    b = FftPlanner(device="cpu").plan_fft_forward(n).process(sig)
    assert _rel(a, b) <= 1e-5
    assert _rel(b, np.asarray(reference.plan_fft_forward(n).process(sig))) <= 1e-5


def test_tensor_inputs_stay_tensors():
    """Torch tensors round-trip as tensors on their own device (the port's
    analogue of JAX arrays staying on device)."""
    plan = FftPlanner(device="cpu").plan_fft_forward(96)
    sig = random_signal(2 * 96).reshape(2, 96)
    x = torch.from_numpy(sig)
    out = plan.process(x)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.complex64
    assert out.device == x.device
    assert _rel(out.numpy(), oracle_dft(sig, plan.fft_direction())) <= 1e-5
    out2 = plan.process(x.reshape(-1))  # flat chunked tensor
    np.testing.assert_array_equal(out2.reshape(2, 96).numpy(), out.numpy())
