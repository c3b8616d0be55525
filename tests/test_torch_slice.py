"""The port's main path end to end, held against the JAX package.

`FftPlanner(np.complex64).plan_fft_forward/inverse(n).process(x)` at the
slice's two sizes (4096 through the lanepack route, 2^20 through the large
route) against the reference FftPlanner (its XLA path on the CPU) and the f64
oracle: relative mean error <= 1e-5 against either.  On the CPU the routed
kernels run their plain torch versions and count no launches.
"""
import numpy as np
import pytest
import torch

import rustfft_tpu
import rustfft_tpu_torch
from rustfft_tpu_torch import FftBufferError, FftDirection, FftPlanner, config, route
from rustfft_tpu_torch.models.flagship import FlagshipConfig, make_forward_fn
from rustfft_tpu_torch.ops.kernels import fused, lanepack, large, largepad
from rustfft_tpu_torch.twiddles import host_dft

TOL = 1e-5


def _signal(shape, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _counts():
    return (lanepack.lanepack_chain_fft.launches, lanepack.lanepack_pipe_fft.launches,
            large.large_col_stage.launches, large.large_row_stage.launches)


@pytest.fixture(scope="module")
def reference_planner():
    return rustfft_tpu.FftPlanner(np.complex64)


@pytest.mark.parametrize("n,batch", [(4096, 2), (1 << 20, 1)])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_slice_matches_reference_and_oracle(n, batch, inverse, reference_planner):
    planner = FftPlanner(np.complex64, device="cpu")
    plan = planner.plan_fft_inverse(n) if inverse else planner.plan_fft_forward(n)
    ref_plan = (reference_planner.plan_fft_inverse(n) if inverse
                else reference_planner.plan_fft_forward(n))
    x = _signal((batch, n), seed=n + inverse)
    before = _counts()
    got = plan.process(x)
    assert _counts() == before  # CPU tensors never launch a kernel
    assert isinstance(got, np.ndarray) and got.dtype == np.complex64 and got.shape == x.shape
    assert np.all(np.isfinite(got))
    direction = FftDirection.INVERSE if inverse else FftDirection.FORWARD
    assert _rel(got, host_dft(x, direction)) <= TOL
    assert _rel(got, np.asarray(ref_plan.process(x))) <= TOL


def test_slice_routes():
    assert route(4096, np.complex64) == "lanepack"
    assert route(1 << 20, np.complex64) == "large"
    assert route(3888, np.complex64) == "lanepack"
    assert route(32768, np.complex64) == "radix"
    assert route(4096, np.complex128) is None  # c128 takes the recipe tree
    assert route(1009, np.complex64) is None  # primes: the Raders recipe, not a route
    old = config.kernels
    try:
        config.kernels = "off"
        assert route(4096, np.complex64) is None
        config.kernels = "sometimes"
        with pytest.raises(ValueError):
            route(4096, np.complex64)
    finally:
        config.kernels = old


@pytest.mark.parametrize("n", [96, 4096, 32768])
def test_kernel_route_equals_recipe_tree(n):
    """The routed kernel's plain version and the torch recipe tree agree."""
    x = torch.from_numpy(_signal((3, n), seed=n))
    old = config.kernels
    try:
        routed = FftPlanner(device="cpu").plan_fft_forward(n).process(x)
        config.kernels = "off"
        tree = FftPlanner(device="cpu").plan_fft_forward(n).process(x)
    finally:
        config.kernels = old
    assert _rel(routed, tree) <= TOL


def test_round_trip_scales_by_n():
    n = 4096
    planner = FftPlanner(device="cpu")
    x = torch.from_numpy(_signal((4, n), seed=1))
    back = planner.plan_fft_inverse(n).process(planner.plan_fft_forward(n).process(x)) / n
    assert _rel(back, x) <= TOL


def test_tensor_stays_tensor_and_numpy_stays_numpy():
    plan = FftPlanner(device="cpu").plan_fft_forward(64)
    x = _signal((2, 64), seed=2)
    out_t = plan.process(torch.from_numpy(x))
    assert isinstance(out_t, torch.Tensor) and out_t.device.type == "cpu"
    out_n = plan.process(x)
    assert isinstance(out_n, np.ndarray)
    np.testing.assert_array_equal(out_t.numpy(), out_n)
    # real input is promoted to the plan's complex dtype
    out_r = plan.process(x.real)
    assert out_r.dtype == np.complex64
    assert _rel(out_r, np.fft.fft(x.real.astype(np.float64))) <= TOL


def test_batching_contract():
    n = 1000
    plan = FftPlanner(device="cpu").plan_fft_forward(n)
    x = _signal(3 * n, seed=3)
    flat = plan.process(x)
    assert flat.shape == (3 * n,)
    np.testing.assert_array_equal(plan.process(x.reshape(3, n)).reshape(-1), flat)
    assert _rel(flat.reshape(3, n), np.fft.fft(x.reshape(3, n).astype(np.complex128))) <= TOL
    nd = plan.process(x.reshape(1, 3, n))
    assert nd.shape == (1, 3, n)
    for method in (plan.process_with_scratch, plan.process_outofplace_with_scratch,
                   plan.process_immutable_with_scratch):
        np.testing.assert_array_equal(method(x), flat)
    assert plan.get_inplace_scratch_len() == 0
    assert plan.get_outofplace_scratch_len() == 0
    assert plan.get_immutable_scratch_len() == 0


def test_buffer_errors():
    plan = FftPlanner(device="cpu").plan_fft_forward(16)
    with pytest.raises(FftBufferError):
        plan.process(np.zeros(17, np.complex64))
    with pytest.raises(FftBufferError):
        plan.process(np.complex64(1.0))
    with pytest.raises(FftBufferError):
        plan.process(torch.zeros((2, 15), dtype=torch.complex64))
    zero = FftPlanner(device="cpu").plan_fft_forward(0)
    assert zero.process(np.zeros(0, np.complex64)).shape == (0,)
    with pytest.raises(FftBufferError):
        zero.process(np.zeros(3, np.complex64))
    one = FftPlanner(device="cpu").plan_fft_forward(1)
    x = _signal(5, seed=4)
    np.testing.assert_array_equal(one.process(x), x)
    with pytest.raises(ValueError):
        FftPlanner().plan_fft_forward(-1)


def test_primes_wait_for_a5():
    """The prime path is ported: 1009 plans as Rader's and computes."""
    plan = FftPlanner(device="cpu").plan_fft_forward(1009)
    assert isinstance(plan.recipe, rustfft_tpu_torch.recipes.Raders)
    x = _signal((2, 1009), seed=1009)
    assert _rel(plan.process(x), host_dft(x, FftDirection.FORWARD)) <= TOL


def test_plan_cache_and_api_surface():
    planner = FftPlanner(np.complex64, device="cpu")
    a = planner.plan_fft_forward(4096)
    assert a is planner.plan_fft_forward(4096)
    assert a is not planner.plan_fft_inverse(4096)
    assert len(a) == 4096 and a.fft_direction() is FftDirection.FORWARD
    assert a.device == torch.device("cpu")
    re, im = a.process_pair(*(lambda s: (s.real, s.imag))(_signal((2, 4096), seed=5)))
    assert re.dtype == torch.float32 and re.shape == (2, 4096)
    assert isinstance(rustfft_tpu_torch.FftPlannerScalar().plan_fft_forward(64),
                      rustfft_tpu_torch.FftPlan)


def test_default_device_is_the_card():
    """Every planner and plan computes numpy buffers on the card unless the
    caller passes device="cpu"."""
    for planner in (FftPlanner(), rustfft_tpu_torch.FftPlannerScalar(),
                    rustfft_tpu_torch.FftPlannerGpu()):
        assert planner.device == torch.device("cuda")
        assert planner.plan_fft_forward(64).device == torch.device("cuda")
    plan = rustfft_tpu_torch.FftPlan(rustfft_tpu_torch.recipes.Dft(64), FftDirection.FORWARD,
                                     np.complex64)
    assert plan.device == torch.device("cuda")
    assert FftPlanner(device="cpu").plan_fft_forward(64).device == torch.device("cpu")


def test_numpy_on_the_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device computes there")
    plan = FftPlanner().plan_fft_forward(64)
    x = _signal((2, 64), seed=9)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan.process(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan.process_pair(x.real, x.imag)
    # a torch tensor stays on its own device
    assert plan.process(torch.from_numpy(x)).device.type == "cpu"


def test_complex128_takes_the_recipe_tree():
    n = 4096
    planner = FftPlanner(np.complex128, device="cpu")
    x = _signal((2, n), seed=6, dtype=np.complex128)
    before = _counts()
    got = planner.plan_fft_forward(n).process(x)
    assert got.dtype == np.complex128
    assert _counts() == before
    assert _rel(got, np.fft.fft(x)) <= 1e-12


def test_flagship_forward_fn():
    assert FlagshipConfig() == FlagshipConfig(4096, 1 << 20, np.complex64)
    fn = make_forward_fn(4096)
    x = torch.from_numpy(_signal((8, 4096), seed=8))
    assert _rel(fn(x), np.fft.fft(x.numpy().astype(np.complex128))) <= TOL


@pytest.mark.cuda
def test_main_path_on_card_launches_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    planner = FftPlanner(np.complex64, device="cuda")
    for n, batch, counter in ((4096, 8, lanepack.lanepack_pipe_fft),
                              (1 << 20, 2, large.large_row_stage)):
        x = _signal((batch, n), seed=n)
        before = counter.launches
        got = planner.plan_fft_forward(n).process(torch.from_numpy(x).cuda())
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert got.device.type == "cuda"
        assert _rel(got.cpu(), host_dft(x, FftDirection.FORWARD)) <= TOL
        assert _rel(planner.plan_fft_forward(n).process(x), host_dft(x, FftDirection.FORWARD)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [
    (24, 3), (210, 3), (1000, 3), (4016, 3), (7776, 3), (14400, 3),  # lanepack, general kernel
    (59049, 2), (390625, 2), (509 * 4096, 2),  # large_pad: ragged tiles
    (14465, 3), (14577, 3),  # large_pad: a prime P = 263; 129 x 113
    (15520, 3),  # large, general kernels (P = 194)
    (16384, 3), (24576, 3),  # two_stage: the radix body at R = 1, the general kernel
    (28928, 3), (32896, 2), (49152, 2), (98304, 2), (260608, 1),  # two_stage: clusters of 2-16
    (65536, 2), (262144, 1),  # radix: clusters of 4 and 16 blocks
    (1 << 22, 1),  # large2f
])
def test_routed_sizes_on_card(n, batch):
    """Every kernel shape the routes reach off the main path: odd and prime
    radices, one-column tiles, a prime P as one dense stage."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    counter = {"lanepack": lanepack.lanepack_chain_fft, "large": large.large_row_stage,
               "large_pad": largepad.largepad_row_stage,
               "two_stage": fused.two_stage_fft, "radix": fused.radix_fft,
               "large2f": large.large_row_stage}[route(n, np.complex64)]
    if counter is fused.two_stage_fft and fused.two_stage_cluster_supported(n, np.complex64):
        counter = fused.two_stage_cluster_fft
    planner = FftPlanner(np.complex64, device="cuda")
    x = _signal((batch, n), seed=n)
    for direction in (FftDirection.FORWARD, FftDirection.INVERSE):
        plan = planner.plan_fft_forward(n) if direction is FftDirection.FORWARD else planner.plan_fft_inverse(n)
        before = counter.launches
        got = plan.process(torch.from_numpy(x).cuda())
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert _rel(got.cpu(), host_dft(x, direction)) <= TOL
