"""K7's cluster band (28928 .. 261632) held against the JAX package.

The port's cluster form of the two-stage kernel, two_stage_cluster_fft
(its plain torch version on the CPU, share by share as the cluster of c
blocks computes it), against the JAX K7 (`_fused_kernel_gauss`, the
default variant) in Pallas interpret mode and the f64 oracle, relative
mean error <= 1e-5 against either, both directions, inputs made with numpy
from a seed.  The JAX factory gets precision="bf16x3", which interpret
mode resolves to f32 HIGHEST.  Also: the routes and split rules of the
band against the JAX package's, every cluster size with ragged row shares,
the planner at 49152 on the CPU, and which Bluestein core serves the
primes whose inner length moved to the band (the fused large Bluestein,
as before the move).  The tests marked `cuda` hold
the kernel against its plain version on the card and skip without a GPU.
"""
import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.executor import pallas_route
from rustfft_tpu.ops.pallas import fused as ref_fused
from rustfft_tpu_torch import FftPlanner, executor, recipes, route
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import (
    conv, conv_radix, convlarge, fused, lanepack, large, largepad,
)
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
DIR_IDS = ["fwd", "inv"]
TOL = 1e-5
#: the kernel against its plain version: the same tables, the sums in another order
KERNEL_TOL = 1e-6


def _band():
    """The aligned n above the one-block band (q % 128 == 0, so n is a
    multiple of 128) that neither lanepack nor radix takes."""
    out = []
    for n in range(28928, fused.MAX_FUSED_N + 1, 128):
        sp = fused.choose_pq(n)
        if (sp is not None and sp[1] % 128 == 0 and not lanepack.lanepack_supported(n, np.complex64)
                and not fused.radix_supported(n, np.complex64)):
            out.append(n)
    return out


BAND = _band()
#: the band's edges and a sample of it, the slice's paths among them
SAMPLE = sorted({BAND[0], BAND[1], BAND[-2], BAND[-1], 32896, 49152, 98304, 196608, 245760,
                 260608, *BAND[::97]})


def _signal(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _jax_out(fn, x):
    o_r, o_i = fn((x.real.copy(), x.imag.copy()))
    return np.asarray(o_r) + 1j * np.asarray(o_i)


def _tables(p, q, d, device="cpu"):
    host = fused.two_stage_tables(p, large.stage_radices(q), d)
    return tuple([torch.from_numpy(a).to(device) for a in t] if isinstance(t, list)
                 else torch.from_numpy(t).to(device) for t in host)


def _counts():
    return fused.two_stage_fft.launches, fused.two_stage_cluster_fft.launches


# -- routes and split rules -------------------------------------------------------

def test_every_band_size_routes_to_two_stage():
    assert len(BAND) == 1009 and (BAND[0], BAND[-1]) == (28928, 261632)
    assert all(route(n, np.complex64) == "two_stage" for n in BAND)
    assert all(fused.two_stage_cluster_supported(n, np.complex64) for n in BAND)
    assert not any(fused.two_stage_supported(n, np.complex64) for n in BAND)
    assert route(28800, np.complex64) == "two_stage" and fused.two_stage_supported(28800, np.complex64)
    assert route(262144, np.complex64) == "radix"
    for n in (49152, 260608):
        assert route(n, np.complex128) is None


@pytest.mark.parametrize("n", SAMPLE)
def test_route_and_split_equal_jax(n):
    assert route(n, np.complex64) == pallas_route(n, np.complex64, "tpu") == "two_stage"
    assert fused.choose_pq(n) == ref_fused._choose_pq(n)


@pytest.mark.parametrize("n,c", [(28928, 2), (32896, 4), (49152, 4), (98304, 8), (196608, 16),
                                 (245760, 16), (260608, 16), (261632, 16)])
def test_choose_cluster(n, c):
    """The fewest blocks whose shares hold at most 16384 values."""
    assert fused.choose_cluster(n) == c
    p, q = fused.choose_pq(n)
    assert fused.cluster_share(p, q, c) <= fused.CLUSTER_SHARE_MAX
    if c > 2:
        assert fused.cluster_share(p, q, c // 2) > fused.CLUSTER_SHARE_MAX
    # the share, the roots of both chains and the p + 2q index ints
    share = -(-fused.cluster_share(p, q, c) // 16) * 16
    roots = sum(large.stage_radices(p)) + sum(large.stage_radices(q))
    assert (share + roots) * 8 + 4 * (p + 2 * q) <= 145408 <= 232448


def test_cluster_sizes_over_the_band():
    sizes = {c: sum(fused.choose_cluster(n) == c for n in BAND) for c in fused.CLUSTER_SIZES}
    assert sizes == {2: 30, 4: 254, 8: 337, 16: 388}


@pytest.mark.parametrize("p,c", [(226, 2), (257, 4), (509, 16), (129, 8), (511, 16)])
def test_row_shares_are_balanced(p, c):
    shares = fused.row_shares(p, c)
    assert shares[0][0] == 0 and shares[-1][1] == p
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    assert {hi - lo for lo, hi in shares} <= {p // c, -(-p // c)}


# -- the plain version against the JAX kernel and the oracle -----------------------

@pytest.mark.parametrize("n", [28928, 49152, 32896], ids=["226x128-radix113", "192x256", "257x128"])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_cluster_plain_matches_jax_gauss_and_oracle(n, d, rd):
    x = _signal(2, n, seed=n)
    fn = fused.make_fused_two_stage_fn(n, d, np.complex64)
    before = _counts()
    got = fn(torch.from_numpy(x))
    assert _counts() == before
    ref = ref_fused.make_fused_two_stage_fn(n, rd, np.complex64, interpret=True, batch_tile=1,
                                            variant="gauss", precision="bf16x3")
    assert got.shape == x.shape
    assert _rel(got, _jax_out(ref, x)) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


@pytest.mark.parametrize("n,c", [(28928, 2), (32896, 4), (98304, 8), (260608, 16), (28928, 16),
                                 (49152, 8)],
                         ids=["c2", "c4-ragged", "c8", "c16-ragged", "c16-at-28928", "c8-at-49152"])
def test_cluster_plain_at_every_cluster_size(n, c):
    """Shares of every width, ragged where c does not divide p, against
    numpy; also at cluster sizes other than choose_cluster's."""
    p, q = fused.choose_pq(n)
    x = _signal(1, n, seed=c)
    for d, _ in DIRECTIONS:
        got = fused.two_stage_cluster_fft(torch.from_numpy(x), p, q, c, _tables(p, q, d))
        assert _rel(got, host_dft(x, d)) <= TOL
        assert _rel(got, fused.two_stage_fft_plain(torch.from_numpy(x), p, q, _tables(p, q, d))) <= 1e-6


def test_cluster_plain_is_share_by_share(monkeypatch):
    """The plain version runs DFT_p once per column share and DFT_q once per
    row share, the shares of row_shares (each a K7 chain, chain_stages_plain)."""
    calls = []
    real = fused.chain_stages_plain
    monkeypatch.setattr(fused, "chain_stages_plain",
                        lambda v, *a: calls.append(tuple(v.shape)) or real(v, *a))
    p, q, c = 509, 512, 16
    fused.two_stage_cluster_fft(torch.from_numpy(_signal(1, p * q, 3)), p, q, c,
                                _tables(p, q, FftDirection.FORWARD))
    assert calls[:c] == [(1, q // c, p)] * c
    assert calls[c:] == [(1, hi - lo, q) for lo, hi in fused.row_shares(p, c)]
    assert {hi - lo for lo, hi in fused.row_shares(p, c)} == {31, 32}


# -- the whole path through the public entry ----------------------------------

def test_49152_through_the_planner():
    n = 49152
    planner = FftPlanner(np.complex64, device="cpu")
    ref_planner = rustfft_tpu.FftPlanner(np.complex64)  # Pallas off on the CPU
    x = _signal(2, n, seed=11)
    before = _counts()
    for plan, ref_plan, d in ((planner.plan_fft_forward(n), ref_planner.plan_fft_forward(n),
                               FftDirection.FORWARD),
                              (planner.plan_fft_inverse(n), ref_planner.plan_fft_inverse(n),
                               FftDirection.INVERSE)):
        got = plan.process(x)
        assert isinstance(got, np.ndarray) and got.dtype == np.complex64 and got.shape == x.shape
        assert _rel(got, np.asarray(ref_plan.process(x))) <= TOL
        assert _rel(got, host_dft(x, d)) <= TOL
    assert _counts() == before  # CPU tensors never launch a kernel


def test_planner_runs_the_cluster_plain_version(monkeypatch):
    calls = []
    real = fused.two_stage_cluster_fft_plain
    monkeypatch.setattr(fused, "two_stage_cluster_fft_plain",
                        lambda x, p, q, c, t: calls.append((p, q, c)) or real(x, p, q, c, t))
    fn = fused.make_fused_two_stage_fn(98304, FftDirection.FORWARD, np.complex64)
    x = _signal(1, 98304, seed=4)
    assert _rel(fn(torch.from_numpy(x)), host_dft(x, FftDirection.FORWARD)) <= TOL
    assert calls == [(256, 384, 8)]


# -- the Bluestein primes whose inner length moved to the band -----------------------

@pytest.mark.parametrize("n,m", [(18427, 36864), (24571, 49152)])
def test_bluestein_primes_keep_the_fused_large_bluestein(n, m):
    """The inner m of 18427 and 24571 now routes to "two_stage", as the JAX
    package's pallas_route(m) does; the JAX rule would then leave them to
    the two-pass convolution core, but the port keeps them on the fused
    large Bluestein (K15), faster on the card (convlarge.bconv_supported).
    The one-block band's m (16384) and the radix sizes keep their cores."""
    plan = FftPlanner(np.complex64, device="cpu").plan_fft_forward(n)
    assert isinstance(plan.recipe, recipes.Bluesteins) and plan.recipe.inner.length == m
    assert route(m, np.complex64) == pallas_route(m, np.complex64, "tpu") == "two_stage"
    assert convlarge.bconv_supported(m, np.complex64)
    assert executor.build(plan.recipe, FftDirection.FORWARD, np.complex64).__module__ == \
        convlarge.__name__
    for other in (16384, 65536, 262144):  # one block; radix
        assert not convlarge.bconv_supported(other, np.complex64)
    x = _signal(1, n, seed=n)
    assert _rel(plan.process(x), host_dft(x, FftDirection.FORWARD)) <= TOL
    fn = conv.make_bluestein_fn(n, m, FftDirection.FORWARD, np.complex64)  # the JAX rule's core
    assert fn.__module__ == conv_radix.__name__
    assert _rel(fn(torch.from_numpy(x)), host_dft(x, FftDirection.FORWARD)) <= TOL


def test_fused_large_bluestein_keeps_only_the_bands_former_large_sizes():
    """K15 serves the band's m that routed to "large" before the band (153
    of them: 157 less four whose tiles do not fit), never one that routed
    to "large_pad", whose tiles large narrows (28928 = 256 x 113, 41472 =
    256 x 162, 62208 = 256 x 243)."""
    served = [m for m in BAND if convlarge.bconv_supported(m, np.complex64)]
    assert len(served) == 153 and {36864, 49152} <= set(served)
    assert not any(largepad.narrowed_by_division(m) for m in served)
    for m in (28928, 41472, 62208):
        assert largepad.narrowed_by_division(m) and not convlarge.bconv_supported(m, np.complex64)


# -- the wrappers --------------------------------------------------------------

def test_wrapper_rejects_bad_operands():
    p, q = 226, 128
    t = _tables(p, q, FftDirection.FORWARD)
    x = torch.from_numpy(_signal(1, p * q, 1))
    with pytest.raises(ValueError):
        fused.two_stage_cluster_fft(x, p, q, 3, t)  # 3 does not divide q
    with pytest.raises(ValueError):
        fused.two_stage_cluster_fft(x.reshape(1, 2, -1), p, q, 2, t)
    with pytest.raises(ValueError):
        fused.two_stage_cluster_fft(x, p, q, 2, (t[0], t[1], t[2].t(), t[3], t[4]))
    with pytest.raises(TypeError):
        fused.two_stage_cluster_fft(x.to(torch.complex128), p, q, 2, t)
    with pytest.raises(ValueError):
        fused.make_fused_two_stage_fn(1 << 19, FftDirection.FORWARD, np.complex64)  # above the band


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [28928, 32896, 49152, 98304, 196608, 260608, 29184, 40832, 132480])
def test_cluster_kernel_on_card(cuda_device, n):
    """The kernel against its plain version at every cluster size, ragged
    row shares (32896, 260608) and prime p above 256 included, and p with
    a direct-sum stage: 228 = (19, 12) on 2 blocks and 345 = (23, 5, 3) on
    16 (the kernel's form without a Bluestein stage), 319 = (29, 11) on 4
    (a Bluestein stage, then a direct sum)."""
    p, q = fused.choose_pq(n)
    c = fused.choose_cluster(n)
    x = torch.from_numpy(_signal(3, n, n)).to(cuda_device)
    for d, _ in DIRECTIONS:
        tabs = _tables(p, q, d, cuda_device)
        before = fused.two_stage_cluster_fft.launches
        got = fused.two_stage_cluster_fft(x, p, q, c, tabs)
        torch.cuda.synchronize()
        assert fused.two_stage_cluster_fft.launches == before + 1
        assert _rel(got.cpu(), fused.two_stage_cluster_fft_plain(x, p, q, c, tabs).cpu()) <= KERNEL_TOL
    assert fused.two_stage_cluster_max_active_clusters(c) >= 1


@pytest.mark.cuda
def test_cluster_kernel_refuses_what_it_does_not_take(cuda_device):
    p, q = 226, 128
    x = torch.from_numpy(_signal(1, p * q, 1)).to(cuda_device)
    with pytest.raises(ValueError):
        fused.two_stage_cluster_fft(x, p, q, 1, _tables(p, q, FftDirection.FORWARD, cuda_device))
