"""K7's in-place Bluestein stage held against the f64 oracle and the JAX package.

A radix of K7's chains from 29 up (the primes 29 .. 509) runs as a
Bluestein stage in both two-stage kernels (csrc/fused.cu
stage_bluestein_inplace); its plain version (ops/kernels/fused.py
bluestein_dft_plain) runs the same steps from the same table.  Here: the
plain stage against the f64 direct DFT_r, relative mean error <= 2e-6
(float32 throughout, two FFTs of at most 1024 points); the crossover rule;
its table against the port's and the JAX package's Bluestein host tables
(bit-equal chirp); the plain two-stage paths at 14464, 16256 (one block)
and 28928, 260608 (a cluster) against the JAX K7 (`_fused_kernel_gauss` in
Pallas interpret mode, precision="bf16x3", which interpret mode resolves to
f32 HIGHEST) and the f64 oracle, 1e-5; a sweep of the whole two-stage band
for stages left on the direct sum and for shared memory.  Inputs are made
with numpy from a seed.  The tests marked `cuda` hold both kernels against
their plain versions on the card (1e-6) and skip without a GPU.
"""
import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import fused as ref_fused
from rustfft_tpu_torch import twiddles
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.bluestein import bluestein_tables
from rustfft_tpu_torch.ops.kernels import _build, fused, lanepack, large
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
DIR_IDS = ["fwd", "inv"]
TOL = 1e-5
#: the kernels against their plain versions: the same table, another order of sums
KERNEL_TOL = 1e-6
#: the smallest radix with a Bluestein stage
CROSSOVER = 29


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


def _tables(p, q_radices, d, device="cpu"):
    host = fused.two_stage_tables(p, q_radices, d)
    return tuple([torch.from_numpy(a).to(device) for a in t] if isinstance(t, list)
                 else torch.from_numpy(t).to(device) for t in host)


def _primes(lo, hi):
    return [r for r in range(lo, hi + 1) if all(r % f for f in range(2, int(r ** 0.5) + 1))]


def _two_stage_band():
    """(n, one_block) of every size the two-stage route serves."""
    out = []
    for n in range(14464, fused.MAX_FUSED_N + 1, 128):
        if fused.two_stage_supported(n, np.complex64):
            out.append((n, True))
        elif (fused.two_stage_cluster_supported(n, np.complex64)
              and not fused.radix_supported(n, np.complex64)):
            out.append((n, False))
    return out


# -- the stage and its rule ------------------------------------------------------

@pytest.mark.parametrize("r", [23, 29, 113, 127, 223, 257, 509])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_plain_stage_against_the_direct_dft(r, d, rd):
    """23 has no Bluestein stage on the chains (the direct sum is cheaper);
    the stage itself computes it at M = 64 all the same."""
    m = fused.bluestein_stage_m(r) or 64
    x = _signal(5, r, seed=r)
    table = torch.from_numpy(fused.bluestein_stage_tables(r, m, d))
    got = fused.bluestein_dft_plain(torch.from_numpy(x), r, m, table)
    assert got.shape == x.shape and got.dtype == torch.complex64
    assert _rel(got, host_dft(x, d)) <= 2e-6


def test_crossover():
    for r in (11, 13, 17, 19, 23, *lanepack.REGISTER_RADICES):
        assert fused.bluestein_stage_m(r) is None
    assert [fused.bluestein_stage_m(r) for r in (29, 31, 37, 113, 127, 223, 257, 509)] == \
        [64, 64, 128, 256, 256, 512, 1024, 1024]
    for r in _primes(CROSSOVER, 511):
        m = fused.bluestein_stage_m(r)
        assert m is not None and m & (m - 1) == 0 and m >= 2 * r - 1 and m // 2 < max(2 * r - 1, 64)
        assert m / r * (10 * np.log2(m) + 6) + 12 < 8 * r


@pytest.mark.parametrize("r", [29, 113, 509])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_table_equals_the_bluestein_host_tables(r, d, rd):
    m = fused.bluestein_stage_m(r)
    table = fused.bluestein_stage_tables(r, m, d)
    assert table.dtype == np.complex64 and len(table) == fused.bluestein_table_len(r, m)
    chirp, spectrum, tw, roots_v, roots_32 = fused.bluestein_parts(table, r, m)
    want_chirp, want_spectrum = bluestein_tables(r, m, d)
    np.testing.assert_array_equal(chirp, want_chirp.astype(np.complex64))
    np.testing.assert_array_equal(chirp, twiddles.bluesteins_twiddles(r, d).astype(np.complex64))
    np.testing.assert_array_equal(
        chirp, rustfft_tpu.twiddles.bluesteins_twiddles(r, rd).astype(np.complex64))
    np.testing.assert_array_equal(
        spectrum, want_spectrum[fused.bluestein_lane_order(m)].astype(np.complex64))
    roots, tws = lanepack.stage_tables(m, (m // 32, 32), FftDirection.FORWARD)
    np.testing.assert_array_equal(tw, tws[0])
    np.testing.assert_array_equal(roots_v, roots[0])
    np.testing.assert_array_equal(roots_32, roots[1])
    # the kernel's immediates w_32^e (csrc/fused.cu w32) stand for both
    np.testing.assert_array_equal(roots_v, roots_32[::32 // (m // 32)])
    # the spectrum of the symmetric wrapped chirp is symmetric, so the
    # forward FFT_m the stage runs in both directions gives it too
    np.testing.assert_allclose(want_spectrum, want_spectrum[(-np.arange(m)) % m], rtol=0, atol=1e-12)


@pytest.mark.parametrize("m", [64, 128, 256, 512, 1024])
def test_lane_order(m):
    order = fused.bluestein_lane_order(m)
    assert sorted(order) == list(range(m))
    v = m // 32
    # lane 1 (bit-reversed: 16) of register 1 (bit-reversed: v/2)
    assert order[32 + 1] == v // 2 + v * 16


# -- the two-stage paths against the JAX kernel and the oracle ----------------------

@pytest.mark.parametrize("n", [14464, 16256], ids=["113x128", "127x128"])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_one_block_plain_matches_jax_gauss_and_oracle(n, d, rd):
    p, q = fused.choose_pq(n)
    assert fused.two_stage_supported(n, np.complex64) and fused.bluestein_stage_m(p)
    x = _signal(2, n, seed=n)
    got = fused.two_stage_fft_plain(torch.from_numpy(x), p, q, _tables(p, large.stage_radices(q), d))
    ref = ref_fused.make_fused_two_stage_fn(n, rd, np.complex64, interpret=True, batch_tile=1,
                                            variant="gauss", precision="bf16x3")
    assert _rel(got, _jax_out(ref, x)) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


@pytest.mark.parametrize("n", [28928, 260608], ids=["226x128-radix113", "509x512"])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_cluster_plain_matches_jax_gauss_and_oracle(n, d, rd):
    p, q = fused.choose_pq(n)
    c = fused.choose_cluster(n)
    x = _signal(2, n, seed=n)
    got = fused.two_stage_cluster_fft_plain(torch.from_numpy(x), p, q, c,
                                            _tables(p, large.stage_radices(q), d))
    ref = ref_fused.make_fused_two_stage_fn(n, rd, np.complex64, interpret=True, batch_tile=1,
                                            variant="gauss", precision="bf16x3")
    assert _rel(got, _jax_out(ref, x)) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


@pytest.mark.parametrize("n,radices", [(29184, (19, 12)), (40832, (29, 11)), (132480, (23, 5, 3))],
                         ids=["19x12", "29x11", "23x5x3"])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_cluster_plain_with_a_direct_sum_stage(n, radices, d, rd):
    """p with a direct-sum stage (19, 23) and with a Bluestein stage before
    one (29, then 11): the chains the cluster kernel runs in both kinds of
    stage, against the f64 oracle."""
    p, q = fused.choose_pq(n)
    c = fused.choose_cluster(n)
    assert large.stage_radices(p) == radices and fused.two_stage_cluster_supported(n, np.complex64)
    x = _signal(1, n, seed=n)
    got = fused.two_stage_cluster_fft_plain(torch.from_numpy(x), p, q, c,
                                            _tables(p, large.stage_radices(q), d))
    assert _rel(got, host_dft(x, d)) <= TOL


def test_phase_stamps_build_apart():
    """The stamped cluster kernel is only in the library built for it: the
    kernels' library has neither its entry point nor its flag."""
    assert "rf_two_stage_cluster_phase_stamps" not in _build._SIGNATURES
    assert "rf_two_stage_cluster_phase_stamps" in _build._STAMP_SIGNATURES
    assert _build.library_path(phase_stamps=True) != _build.library_path()
    assert "-DRF_PHASE_STAMPS" in _build.STAMP_FLAGS and "-DRF_PHASE_STAMPS" not in _build.NVCC_FLAGS


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_three_stage_plain_with_a_bluestein_stage(d, rd):
    p, q1, q2 = 113, 8, 16
    n = p * q1 * q2
    x = _signal(2, n, seed=7)
    got = fused.three_stage_fft_plain(torch.from_numpy(x), p, q1, q2, _tables(p, (q1, q2), d))
    assert _rel(got, host_dft(x, d)) <= TOL


def test_chain_plain_runs_the_bluestein_stage(monkeypatch):
    calls = []
    real = lanepack.bluestein_dft_plain
    monkeypatch.setattr(lanepack, "bluestein_dft_plain",
                        lambda u, r, m, t: calls.append((tuple(u.shape), r, m)) or real(u, r, m, t))
    p, q = 226, 128
    x = torch.from_numpy(_signal(1, p * q, 5))
    fused.two_stage_fft_plain(x, p, q, _tables(p, large.stage_radices(q), FftDirection.FORWARD))
    assert large.stage_radices(p) == (113, 2)
    assert calls == [((q, 1, 2, 113), 113, 256)]  # the first of DFT_p's stages, q columns


# -- the band --------------------------------------------------------------------

def test_no_stage_at_or_above_the_crossover_runs_the_direct_sum():
    """Every radix of every two-stage size's chains from the crossover up
    runs the Bluestein stage (a Bluestein length in the launch arguments and
    the table in the roots slot); every other radix is a register radix or
    a prime from 11 to 23 (or 10, 14, 15, 20), none above 256."""
    band = _two_stage_band()
    assert sum(one for _, one in band) == 113 and sum(not one for _, one in band) == 1009
    with_stage = {True: 0, False: 0}
    for n, one in band:
        p, q = fused.choose_pq(n)
        radices = large.stage_radices(p) + large.stage_radices(q)
        ms = [fused.bluestein_stage_m(r) for r in radices]
        for r, m in zip(radices, ms):
            if r in lanepack.REGISTER_RADICES:
                assert m is None
            elif r >= CROSSOVER:
                assert m is not None and m <= (512 if one else 1024)
            else:
                assert m is None and r in (10, 11, 13, 14, 15, 17, 19, 20, 23)
        for rs in (large.stage_radices(p), large.stage_radices(q)):
            assert fused.bluestein_ms(rs) == [fused.bluestein_stage_m(r) or 0 for r in rs] + \
                [0] * (3 - len(rs))
            assert fused.chain_root_lens(rs) == [
                fused.bluestein_table_len(r, fused.bluestein_stage_m(r)) if fused.bluestein_stage_m(r)
                else r for r in rs]
        assert max(r for r, m in zip(radices, ms) if m is None) <= fused.MAX_INPLACE_RADIX
        with_stage[one] += any(ms)
    assert with_stage == {True: 58, False: 665}


def test_shared_memory_at_every_band_size():
    """Neither kernel's block takes more than 232448 bytes anywhere on the
    band; shared memory holds the roots of the direct stages only, never a
    Bluestein table (read from device memory)."""
    most = 0
    for n, one in _two_stage_band():
        p, q = fused.choose_pq(n)
        if one:
            nbytes = fused.two_stage_smem_bytes(n, large.stage_radices(p), large.stage_radices(q))
        else:
            nbytes = fused.cluster_smem_bytes(p, q, fused.choose_cluster(n))
            most = max(most, nbytes)
        assert nbytes <= _build.SMEM_MAX
    assert most == 137672  # 506 x 512 = (23, 11, 2) x (16, 16, 2) on 16 blocks
    assert fused.two_stage_smem_bytes(14464, (113,), (16, 8)) == 14464 * 8 + 4 * 241 + 8 * 24
    assert fused.two_stage_smem_bytes(28544, (223,), (16, 8)) == 28544 * 8 + 4 * 351 + 8 * 24
    assert fused.two_stage_smem_bytes(20608, (23, 7), (16, 8)) == 20608 * 8 + 4 * 289 + 8 * 54


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [14464, 16256, 28544, 20608])
def test_one_block_kernel_on_card(cuda_device, n):
    """p = 113, 127, 223 (a Bluestein stage) and 161 = 23 x 7 (a direct
    sum beside a register stage: the kernel's form without a Bluestein
    stage)."""
    p, q = fused.choose_pq(n)
    x = torch.from_numpy(_signal(3, n, n)).to(cuda_device)
    for d, _ in DIRECTIONS:
        tabs = _tables(p, large.stage_radices(q), d, cuda_device)
        before = fused.two_stage_fft.launches
        got = fused.two_stage_fft(x, p, q, tabs)
        torch.cuda.synchronize()
        assert fused.two_stage_fft.launches == before + 1
        assert _rel(got.cpu(), fused.two_stage_fft_plain(x, p, q, tabs).cpu()) <= KERNEL_TOL
        assert _rel(got.cpu(), host_dft(x.cpu().numpy(), d)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [28928, 32896, 65792, 260608, 40832, 81664])
def test_cluster_kernel_on_card(cuda_device, n):
    """A Bluestein stage on clusters of 2, 4, 8 and 16 blocks (p = 226 =
    113 x 2, 257, 257, 509), and before a direct-sum stage (p = 319 = 29 x
    11 on 4 and 8 blocks)."""
    p, q = fused.choose_pq(n)
    c = fused.choose_cluster(n)
    assert fused.bluestein_stage_m(large.stage_radices(p)[0])
    x = torch.from_numpy(_signal(3, n, n)).to(cuda_device)
    for d, _ in DIRECTIONS:
        tabs = _tables(p, large.stage_radices(q), d, cuda_device)
        got = fused.two_stage_cluster_fft(x, p, q, c, tabs)
        torch.cuda.synchronize()
        assert _rel(got.cpu(), fused.two_stage_cluster_fft_plain(x, p, q, c, tabs).cpu()) <= KERNEL_TOL
        assert _rel(got.cpu(), host_dft(x.cpu().numpy(), d)) <= TOL


@pytest.mark.cuda
def test_three_stage_kernel_with_a_bluestein_stage_on_card(cuda_device):
    p, q1, q2 = 113, 8, 16
    x = torch.from_numpy(_signal(3, p * q1 * q2, 3)).to(cuda_device)
    tabs = tuple([torch.from_numpy(a).to(cuda_device) for a in t] if isinstance(t, list)
                 else torch.from_numpy(t).to(cuda_device)
                 for t in fused.three_stage_tables(p, q1, q2, FftDirection.FORWARD))
    got = fused.three_stage_fft(x, p, q1, q2, tabs)
    torch.cuda.synchronize()
    assert _rel(got.cpu(), fused.three_stage_fft_plain(x, p, q1, q2, tabs).cpu()) <= KERNEL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [49152, 260608])
def test_phase_stamps_on_card(cuda_device, n):
    """The stamped form computes what the kernel does, bit for bit, and
    each block's stamps rise."""
    p, q = fused.choose_pq(n)
    c = fused.choose_cluster(n)
    x = torch.from_numpy(_signal(2, n, 1)).to(cuda_device)
    tabs = _tables(p, large.stage_radices(q), FftDirection.FORWARD, cuda_device)
    y, stamps = fused.two_stage_cluster_phase_stamps(x, p, q, c, tabs)
    torch.cuda.synchronize()
    assert stamps.shape == (2 * c, fused.PHASE_STAMPS)
    assert bool((stamps[:, 1:] >= stamps[:, :-1]).all()) and bool((stamps[:, 0] > 0).all())
    assert torch.equal(y, fused.two_stage_cluster_fft(x, p, q, c, tabs))


@pytest.mark.cuda
def test_kernels_refuse_a_bluestein_length_above_their_cap(cuda_device, monkeypatch):
    """The one-block kernel takes M <= 512; asked for 1024 it raises."""
    real = fused.bluestein_stage_m
    patched = lambda r: 1024 if r == 113 else real(r)  # noqa: E731
    # the chain's tables and arguments read lanepack's rule, the smem sizing fused's
    monkeypatch.setattr(lanepack, "bluestein_stage_m", patched)
    monkeypatch.setattr(fused, "bluestein_stage_m", patched)
    p, q = 113, 128
    x = torch.from_numpy(_signal(1, p * q, 1)).to(cuda_device)
    with pytest.raises(RuntimeError):
        fused.two_stage_fft(x, p, q, _tables(p, large.stage_radices(q), FftDirection.FORWARD,
                                             cuda_device))
