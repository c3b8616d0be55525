"""The prime path of the port held against the JAX package.

Host tables (Rader permutations and spectra, Bluestein chirps and spectra,
Good-Thomas index maps) must be bit-equal to the JAX package's on both the
native and the Python path.  The kernels' plain torch versions (the one-pass
core K13/K6, the two-pass core K14, the permutation K16) are held against
the JAX kernels in Pallas interpret mode, which run their bf16x3 tier there:
relative mean error <= 1e-5 (about 5e-6 is the tier's own error,
tests/test_torch_kernels.py), and against the f64 oracle to 1e-5.  The
planner's prime rules are checked by recipe.  Tests marked `cuda` hold each
kernel against its plain version on the card and skip without one.
"""
import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu import config as ref_config
from rustfft_tpu import math_utils as ref_math
from rustfft_tpu import native as ref_native
from rustfft_tpu import twiddles as ref_twiddles
from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops import bluestein as ref_bluestein
from rustfft_tpu.ops import good_thomas as ref_gt
from rustfft_tpu.ops import raders as ref_raders
from rustfft_tpu.ops.pallas import conv as ref_conv
from rustfft_tpu.ops.pallas import conv_radix as ref_conv_radix
from rustfft_tpu.ops.pallas import permute as ref_permute
import rustfft_tpu_torch
from rustfft_tpu_torch import config, executor, math_utils, native, recipes, twiddles
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops import bluestein, good_thomas, raders
from rustfft_tpu_torch.ops.kernels import _build, conv, conv_radix, lanepack, large, permute
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
DIR_IDS = ["fwd", "inv"]

VS_JAX = 1e-5
VS_ORACLE = 1e-5

PRIMES = [3, 5, 37, 59, 257, 263, 617, 1009, 7919, 65537]


def _signal(batch, n, seed, dtype=np.complex64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(dtype)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _jax_out(fn, x):
    o_r, o_i = fn((x.real.copy(), x.imag.copy()))
    return np.asarray(o_r) + 1j * np.asarray(o_i)


def _tensors(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.fixture(params=[True, False], ids=["native", "python"])
def use_native(request):
    old_port, old_ref = config.use_native, ref_config.use_native
    config.use_native = ref_config.use_native = request.param
    try:
        yield request.param
    finally:
        config.use_native, ref_config.use_native = old_port, old_ref


@pytest.fixture
def ref_pallas_off():
    old = ref_config.use_pallas
    ref_config.use_pallas = "off"
    try:
        yield
    finally:
        ref_config.use_pallas = old


@pytest.fixture
def kernels_off():
    old = config.kernels
    config.kernels = "off"
    try:
        yield
    finally:
        config.kernels = old


# -- (a) host tables ----------------------------------------------------------

def test_number_theory_matches_reference():
    for a in range(0, 60):
        for b in range(1, 60):
            assert math_utils.extended_gcd(a, b) == ref_math.extended_gcd(a, b)
            assert math_utils.modular_exponent(a, b, 97) == ref_math.modular_exponent(a, b, 97)
    for p in PRIMES[1:] + [2**31 - 1]:
        for a in (1, 2, 3, p - 1, 12345 % p or 1):
            inv = math_utils.mod_inverse(a, p)
            assert inv == ref_math.mod_inverse(a, p) and a * inv % p == 1
    with pytest.raises(ValueError):
        math_utils.mod_inverse(6, 9)


def test_compute_twiddle_and_twiddle_values_match_reference():
    for n in (1, 7, 64, 1009, 65537):
        for i in (0, 1, n // 3, n - 1, 5 * n + 2):
            for d, rd in DIRECTIONS:
                assert twiddles.compute_twiddle(i, n, d) == ref_twiddles.compute_twiddle(i, n, rd)
    if not native.available():
        pytest.skip("native plancore not built")
    idx = np.arange(200) * 7
    for conj in (False, True):
        np.testing.assert_array_equal(native.twiddle_values(idx, 1009, conj),
                                      ref_native.twiddle_values(idx, 1009, conj))
        ref = np.exp((1j if conj else -1j) * 2 * np.pi * idx / 1009)
        np.testing.assert_allclose(native.twiddle_values(idx, 1009, conj), ref, rtol=0, atol=1e-14)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 100, 617, 1234, 7919, 65537])
def test_bluesteins_twiddles_bit_equal(n, use_native):
    for d, rd in DIRECTIONS:
        np.testing.assert_array_equal(twiddles.bluesteins_twiddles(n, d),
                                      ref_twiddles.bluesteins_twiddles(n, rd))


@pytest.mark.parametrize("p", PRIMES)
def test_raders_tables_bit_equal(p, use_native):
    for d, rd in DIRECTIONS:
        perm_in, inv_gather, b_fft = raders.raders_tables(p, d)
        ref = ref_raders.raders_tables(p, rd)
        np.testing.assert_array_equal(perm_in, ref[0])
        np.testing.assert_array_equal(inv_gather, ref[1])
        np.testing.assert_array_equal(b_fft, ref[2])
    with pytest.raises(ValueError):
        raders.raders_tables(p + 1 if p > 2 else 4, FftDirection.FORWARD)


@pytest.mark.parametrize("n,m", [(5, 16), (59, 128), (100, 256), (617, 1296), (1234, 3072),
                                 (7919, 16384), (15625, 32768)])
def test_bluestein_tables_bit_equal(n, m, use_native):
    for d, rd in DIRECTIONS:
        chirp, h_fft = bluestein.bluestein_tables(n, m, d)
        ref_chirp, ref_h = ref_bluestein.bluestein_tables(n, m, rd)
        np.testing.assert_array_equal(chirp, ref_chirp)
        np.testing.assert_array_equal(h_fft, ref_h)
    with pytest.raises(ValueError):
        bluestein.bluestein_tables(n, 2 * n - 2, FftDirection.FORWARD)


@pytest.mark.parametrize("p,q", [(2, 3), (3, 4), (7, 16), (16, 9), (5, 81), (31, 37)])
def test_index_maps_match_reference(p, q):
    got = good_thomas.make_index_maps(p, q)
    want = ref_gt.make_index_maps(p, q)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


# -- Good-Thomas and the plain Rader / Bluestein recipes ----------------------

@pytest.mark.parametrize("p,q", [(3, 4), (7, 16), (16, 9), (5, 81)])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["index_select", "permute"])
def test_good_thomas_matches_reference(p, q, use_kernel, ref_pallas_off):
    from rustfft_tpu.ops import dft as ref_dft
    from rustfft_tpu_torch.ops import dft

    n = p * q
    x = _signal(3, n, seed=n)
    for d, rd in DIRECTIONS:
        fn = good_thomas.make_good_thomas_fn(
            p, q, dft.make_dft_fn(p, d, np.complex64), dft.make_dft_fn(q, d, np.complex64),
            use_kernel=use_kernel)
        got = fn(torch.from_numpy(x))
        ref_fn = ref_gt.make_good_thomas_fn(
            p, q, ref_dft.make_dft_fn(p, rd, np.complex64), ref_dft.make_dft_fn(q, rd, np.complex64),
            np.complex64)
        assert _rel(got, _jax_out(ref_fn, x)) <= VS_JAX
        assert _rel(got, host_dft(x, d)) <= VS_ORACLE


@pytest.mark.parametrize("p", [5, 37, 257, 1009])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["c64", "c128"])
def test_plain_raders_matches_reference(p, dtype, ref_pallas_off):
    from rustfft_tpu.ops import dft as ref_dft
    from rustfft_tpu_torch.ops import dft

    x = _signal(2, p, seed=p, dtype=dtype)
    tol = VS_ORACLE if dtype == np.complex64 else 1e-12
    for d, rd in DIRECTIONS:
        got = raders.make_raders_fn(p, dft.make_dft_fn(p - 1, d, dtype), d, dtype)(torch.from_numpy(x))
        ref = ref_raders.make_raders_fn(p, ref_dft.make_dft_fn(p - 1, rd, dtype), rd, dtype)
        assert _rel(got, _jax_out(ref, x)) <= tol
        assert _rel(got, host_dft(x, d)) <= tol


@pytest.mark.parametrize("n,m", [(5, 16), (59, 128), (100, 256)])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128], ids=["c64", "c128"])
def test_plain_bluestein_matches_reference(n, m, dtype, ref_pallas_off):
    from rustfft_tpu.ops import dft as ref_dft
    from rustfft_tpu_torch.ops import dft

    x = _signal(2, n, seed=n, dtype=dtype)
    tol = VS_ORACLE if dtype == np.complex64 else 1e-12
    for d, rd in DIRECTIONS:
        got = bluestein.make_bluestein_fn(n, m, dft.make_dft_fn(m, d, dtype), d, dtype)(
            torch.from_numpy(x))
        ref = ref_bluestein.make_bluestein_fn(n, m, ref_dft.make_dft_fn(m, rd, dtype), rd, dtype)
        assert _rel(got, _jax_out(ref, x)) <= tol
        assert _rel(got, host_dft(x, d)) <= tol


# -- (b) the one-pass core against K13 / K6 in interpret mode -----------------

@pytest.mark.parametrize("n,m", [(100, 256), (1234, 3072), (2063, 6144)])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_one_pass_bluestein_matches_jax_kernel(n, m, d, rd):
    assert conv.conv_supported(m, np.complex64)
    x = _signal(3, n, seed=n)
    got = conv.make_bluestein_fn(n, m, d, np.complex64)(torch.from_numpy(x))
    want = _jax_out(ref_conv.make_bluestein_fn(n, m, rd, np.complex64, interpret=True), x)
    assert got.shape == (3, n)
    assert _rel(got, want) <= VS_JAX
    assert _rel(got, host_dft(x, d)) <= VS_ORACLE


@pytest.mark.parametrize("p", [257, 1009, 2531])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_one_pass_raders_matches_jax_kernel(p, d, rd):
    """257: m = 256 reaches K13; 1009: m = 1008 is not 128-aligned and
    reaches K6 (lanepack._conv_kernel); 2531: m = 2530, which the JAX
    package serves through conv_any_supported as it serves 1008 (the port's
    chain form with direct sums of 23 and 11)."""
    assert conv.conv_supported(p - 1, np.complex64)
    x = _signal(3, p, seed=p).reshape(1, 3, p)
    got = conv.make_raders_fn(p, d, np.complex64)(torch.from_numpy(x))
    want = _jax_out(ref_conv.make_raders_fn(p, rd, np.complex64, interpret=True), x)
    assert got.shape == (1, 3, p)
    assert _rel(got, want) <= VS_JAX
    assert _rel(got, host_dft(x, d)) <= VS_ORACLE


@pytest.mark.parametrize("m,n_in,n_out", [(616, 616, 616), (1008, 1008, 1000), (3072, 1234, 1234)])
def test_conv_fft_matches_definition(m, n_in, n_out):
    """conv_fft alone, with pre, post and conj on and off: an m with no
    register stage (616 = 11 x 8 x 7), ragged n_in / n_out."""
    radices = lanepack.tile_radices(m)
    rng = np.random.default_rng(m)
    x = _signal(2, n_in, seed=m + 1)
    for d, _ in DIRECTIONS:
        roots, tws = lanepack.stage_tables(m, radices, d)
        h = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(np.complex64)
        for with_tables, conj_out in ((False, False), (True, True), (True, False)):
            pre = post = None
            if with_tables:
                pre = conv_radix.zero_extended(rng.standard_normal(n_in) + 1j, m)
                post = conv_radix.zero_extended(rng.standard_normal(n_out) - 1j, m)
            tables = (_tensors(roots), _tensors(tws), torch.from_numpy(h),
                      None if pre is None else torch.from_numpy(pre),
                      None if post is None else torch.from_numpy(post))
            got = conv.conv_fft(torch.from_numpy(x), radices, tables, n_out, conj_out)
            v = np.zeros((2, m), np.complex128)
            v[:, :n_in] = x
            if pre is not None:
                v = v * pre
            want = host_dft(np.conj(host_dft(v, d) * h), d)[:, :n_out]
            if conj_out:
                want = np.conj(want)
            if post is not None:
                want = want * post[:n_out]
            assert _rel(got, want) <= VS_ORACLE


# -- (c) the two-pass core against K14 ----------------------------------------

@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_two_pass_bluestein_matches_jax_kernel(d, rd):
    """Bluestein 15625 at m = 32768 (the JAX package's hole-band recipe)."""
    n, m = 15625, 32768
    assert not conv.conv_supported(m, np.complex64) and conv_radix.radix_conv_supported(m, np.complex64)
    chirp, h_fft = bluestein.bluestein_tables(n, m, d)
    x = _signal(2, n, seed=11)
    got = conv_radix.make_radix_conv_fn(m, d, np.complex64, h=h_fft, pre=chirp, post=chirp,
                                        conj_out=True, n_in=n, n_out=n)(torch.from_numpy(x))
    ref_chirp, ref_h = ref_bluestein.bluestein_tables(n, m, rd)
    ref = ref_conv_radix.make_radix_conv_fn(m, rd, np.complex64, h=ref_h, pre=ref_chirp,
                                            post=ref_chirp, conj_out=True, n_in=n, n_out=n,
                                            interpret=True)
    assert _rel(got, _jax_out(ref, x)) <= VS_JAX
    assert _rel(got, host_dft(x, d)) <= VS_ORACLE


@pytest.mark.parametrize("d", [FftDirection.FORWARD, FftDirection.INVERSE], ids=DIR_IDS)
def test_two_pass_rader_65537_fused_matches_oracle(d):
    """Rader 65537: both permutations, the +x0 and the DC-first layout fused
    into the two-pass core (m = 65536 does not fit one block)."""
    p = 65537
    assert not conv.conv_supported(p - 1, np.complex64)
    x = _signal(2, p, seed=3)
    got = conv.make_raders_fn(p, d, np.complex64)(torch.from_numpy(x))
    assert got.shape == (2, p)
    assert _rel(got, host_dft(x, d)) <= VS_ORACLE


def test_two_pass_emit_sum_and_x0_add():
    """emit_sum without full_out returns the raw-input sums beside the
    output; x0_add adds the constant to every bin after the out gather."""
    m = 16384
    rng = np.random.default_rng(5)
    h = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    perm = rng.permutation(m)
    out_perm = rng.permutation(m)
    x = _signal(3, m, seed=6)
    c = _signal(3, 1, seed=7)
    d = FftDirection.FORWARD
    fn = conv_radix.make_radix_conv_fn(m, d, np.complex64, h=h, conj_out=True, in_perm=perm,
                                       out_perm=out_perm, x0_add=True, emit_sum=True)
    out, sums = fn(torch.from_numpy(x), const=torch.from_numpy(c))
    want = np.conj(host_dft(np.conj(host_dft(x[:, perm], d) * h), d))[:, out_perm] + c
    assert _rel(out, want) <= VS_ORACLE
    assert sums.shape == (3, 1)
    np.testing.assert_allclose(sums.numpy(), x.astype(np.complex128).sum(axis=1, keepdims=True),
                               rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError):
        conv_radix.make_radix_conv_fn(m, d, np.complex64, h=h, full_out=True)
    with pytest.raises(ValueError):
        conv_radix.make_radix_conv_fn(m, d, np.complex64, h=h, pre=h, in_perm=perm)
    with pytest.raises(ValueError):
        conv_radix.make_radix_conv_fn(1018, d, np.complex64, h=h)  # 2 x 509: no split


def test_two_pass_splits():
    assert conv_radix.choose_split(65536) == (256, 256)
    assert conv_radix.choose_split(16384) == (256, 64)
    assert conv_radix.choose_split(32768) == (256, 128)
    assert conv_radix.col_tile(256, 256) == 16 and conv_radix.row_tile(256, 256) == 16
    assert not conv_radix.radix_conv_supported(65536, np.complex128)
    assert not conv_radix.radix_conv_supported(1018, np.complex64)  # 2 x 509
    assert large.stage_radices(64) == (8, 8)


# -- (d) the permutation against K16 ------------------------------------------

def test_permute_matches_jax_kernel():
    m = 16384
    perm = np.random.default_rng(16384).permutation(m)
    x = _signal(2, m, seed=4)
    got = permute.make_permute_fn(perm)(torch.from_numpy(x))
    want = _jax_out(ref_permute.make_permute_fn(perm, interpret=True), x)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.complex64))
    np.testing.assert_array_equal(got.numpy(), x[:, perm])


@pytest.mark.parametrize("p", [1009, 7919, 65537])
def test_permute_rader_tables_match_definition(p):
    perm_in, inv_gather, _ = raders.raders_tables(p, FftDirection.FORWARD)
    x = _signal(3, p - 1, seed=p).reshape(3, 1, p - 1)
    for perm in (perm_in - 1, inv_gather):
        got = permute.make_permute_fn(perm)(torch.from_numpy(x))
        assert got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), x[..., perm])


@pytest.mark.parametrize("m", [1, 2, 3, 1008, 1009, 4096, 4097, 16384, permute.SMEM_ROW_MAX,
                               permute.SMEM_ROW_MAX + 1, 114688])
def test_permute_smem_cut_over(m):
    """K16's one host rule: rows that fit a block's shared memory go through
    it, as many whole rows a block as SMEM_BLOCK_VALUES holds (at least
    one); longer rows take the direct gather (0)."""
    rows = permute.smem_rows(m)
    assert permute.SMEM_ROW_MAX * 8 <= _build.SMEM_MAX < (permute.SMEM_ROW_MAX + 1) * 8
    if m > permute.SMEM_ROW_MAX:
        assert rows == 0
    else:
        assert rows >= 1
        assert rows * m <= max(permute.SMEM_BLOCK_VALUES, m)
        assert rows * m * 8 <= _build.SMEM_MAX
        assert (rows + 1) * m > permute.SMEM_BLOCK_VALUES  # as many rows as fit
    assert permute.smem_rows(1008) == 1  # the Rader 1009 gathers: one row a block


def test_permute_smem_rows_rejects_empty_rows():
    with pytest.raises(ValueError):
        permute.smem_rows(0)


def test_permutation_index_checks():
    assert permute.permutation_index(np.array([2, 0, 1], np.int64)).dtype == np.int32
    for bad in ([0, 0, 1], [1, 2, 3], np.array([0.0, 1.0]), np.zeros((2, 2), np.int64)):
        with pytest.raises(ValueError):
            permute.permutation_index(bad)
    x = torch.from_numpy(_signal(2, 3, seed=1))
    idx = torch.from_numpy(permute.permutation_index([2, 0, 1]))
    with pytest.raises(TypeError):
        permute.permute(x, idx.long())
    with pytest.raises(ValueError):
        permute.permute(x[:, :2].contiguous(), idx)
    with pytest.raises(ValueError):
        permute.permute(x.reshape(-1), idx)
    with pytest.raises(TypeError):
        permute.permute(x.to(torch.complex128), idx)


def test_wrappers_reject_bad_operands():
    m = 1008
    radices = lanepack.tile_radices(m)
    roots, tws = lanepack.stage_tables(m, radices, FftDirection.FORWARD)
    h = torch.ones(m, dtype=torch.complex64)
    tables = (_tensors(roots), _tensors(tws), h, None, None)
    x = torch.from_numpy(_signal(2, m, seed=2))
    with pytest.raises(ValueError):
        conv.conv_fft(x, radices, tables, m + 1)
    with pytest.raises(TypeError):
        conv.conv_fft(x, radices, (tables[0], tables[1], None, None, None), m)
    with pytest.raises(ValueError):
        conv.conv_fft(x, radices, (tables[0], tables[1], h[:10], None, None), m)
    with pytest.raises(ValueError):
        conv.conv_fft(torch.cat([x, x], dim=1), radices, tables, m)
    p, q = conv_radix.choose_split(16384)
    col = large.col_tables(p, q, FftDirection.FORWARD)
    colt = (_tensors(col[0]), _tensors(col[1]), torch.from_numpy(col[2]))
    xl = torch.from_numpy(_signal(2, 100, seed=3))
    perm = torch.from_numpy(permute.permutation_index(np.arange(p * q)))
    with pytest.raises(ValueError):
        conv_radix.conv_col_stage(xl, p, q, colt, perm=perm)  # a gather needs n_in == m
    a, partials = conv_radix.conv_col_stage(xl, p, q, colt, emit_sum=True)
    assert a.shape == (2, q, p) and partials.shape == (2, q // conv_radix.col_tile(p, q))
    row = large.row_tables(q, FftDirection.FORWARD)
    rowt = (_tensors(row[0]), _tensors(row[1]))
    x0 = torch.zeros(2, dtype=torch.complex64)
    with pytest.raises(ValueError):
        conv_radix.conv_row_stage(a, q, p, rowt, p * q, x0=x0, partials=partials)  # no scatter
    with pytest.raises(ValueError):
        conv_radix.conv_row_stage(a, q, p, rowt, 100, scatter=perm)  # scatter needs n_out == m
    with pytest.raises(ValueError):
        conv_radix.conv_row_stage(a, q, p, rowt, p * q + 1)


def test_cpu_wrappers_count_no_launches():
    before = (conv.conv_fft.launches, conv.conv_chain_fft.launches,
              conv_radix.conv_col_stage.launches, conv_radix.conv_row_stage.launches,
              permute.permute.launches)
    x = _signal(2, 1009, seed=9)
    for n in (1009, 1234, 7919, 65537):
        rustfft_tpu_torch.FftPlanner(device="cpu").plan_fft_forward(n).process(_signal(1, n, seed=n))
    conv.make_raders_fn(1009, FftDirection.FORWARD, np.complex64)(torch.from_numpy(x))
    after = (conv.conv_fft.launches, conv.conv_chain_fft.launches,
             conv_radix.conv_col_stage.launches, conv_radix.conv_row_stage.launches,
             permute.permute.launches)
    assert after == before


# -- (f) the planner rules ----------------------------------------------------

def test_planner_prime_rules():
    planner = rustfft_tpu_torch.FftPlanner(np.complex64)
    r = planner.design_fft_for_len(1009)
    assert isinstance(r, recipes.Raders) and r.inner.length == 1008
    r = planner.design_fft_for_len(7919)
    assert isinstance(r, recipes.Bluesteins) and r.inner.length == 16384
    r = planner.design_fft_for_len(65537)
    assert isinstance(r, recipes.Raders) and r.inner.length == 65536
    r = planner.design_fft_for_len(1234)
    assert isinstance(r, recipes.Bluesteins) and r.inner.length == 3072
    r = planner.design_fft_for_len(257)
    assert isinstance(r, recipes.Raders) and r.inner.length == 256
    # 263 - 1 = 2 x 131: served, but only through a generic radix-131 stage
    assert not conv.conv_aligned(262, np.complex64) and conv.conv_supported(262, np.complex64)
    r = planner.design_fft_for_len(263)
    assert isinstance(r, recipes.Bluesteins) and conv.conv_aligned(r.inner.length, np.complex64)
    assert isinstance(planner.design_fft_for_len(4096), recipes.MixedRadix)
    assert isinstance(planner.design_fft_for_len(255), recipes.Dft)
    # c128 keeps the reference rule: 1234 = 2 x 617 splits
    assert isinstance(rustfft_tpu_torch.FftPlanner(np.complex128).design_fft_for_len(1234),
                      recipes.MixedRadix)


@pytest.mark.parametrize("n", [257, 263, 617, 1009, 1019, 1234, 2018, 7919, 65537, 746497])
def test_planner_recipes_with_kernels_off_match_reference(n, kernels_off, ref_pallas_off):
    port = rustfft_tpu_torch.FftPlanner(np.complex64).design_fft_for_len(n)
    ref = rustfft_tpu.FftPlanner(np.complex64).design_fft_for_len(n)
    assert repr(port) == repr(ref)


def test_recipe_cache_follows_config_kernels():
    planner = rustfft_tpu_torch.FftPlanner(np.complex64)
    on = planner.design_fft_for_len(1234)
    old = config.kernels
    try:
        config.kernels = "off"
        off = planner.design_fft_for_len(1234)
        assert planner.plan_fft_forward(1234).recipe == off
    finally:
        config.kernels = old
    assert on != off and planner.design_fft_for_len(1234) == on
    assert planner.plan_fft_forward(1234).recipe == on


def test_executor_takes_the_kernel_path_for_c64():
    for recipe in (recipes.Raders(recipes.Dft(1008)), recipes.Bluesteins(1234, recipes.Dft(3072)),
                   recipes.Raders(recipes.MixedRadix(recipes.Dft(256), recipes.Dft(256)))):
        fn = executor.build(recipe, FftDirection.FORWARD, np.complex64)
        assert fn.__module__ == conv.__name__
        fn = executor.build(recipe, FftDirection.FORWARD, np.complex128)
        assert fn.__module__ != conv.__name__
    old = config.kernels
    try:
        config.kernels = "off"
        fn = executor.build(recipes.Raders(recipes.Dft(1008)), FftDirection.FORWARD, np.complex64)
        assert fn.__module__ == raders.__name__
    finally:
        config.kernels = old


# -- (g) each kernel against its plain version on the card --------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_in,n_out,with_tables", [
    (1008, 1008, 1008, False), (3072, 1234, 1234, True), (616, 616, 600, True), (262, 262, 262, False),
])
def test_conv_fft_matches_plain_on_card(cuda_device, m, n_in, n_out, with_tables):
    radices = lanepack.tile_radices(m)
    rng = np.random.default_rng(m)
    x = torch.from_numpy(_signal(257, n_in, seed=m)).to(cuda_device)
    for d, _ in DIRECTIONS:
        roots, tws = lanepack.stage_tables(m, radices, d)
        h = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(np.complex64)
        extra = [None, None]
        if with_tables:
            extra = [torch.from_numpy(conv_radix.zero_extended(rng.standard_normal(k) + 1j, m)).to(cuda_device)
                     for k in (n_in, n_out)]
        tables = (_tensors(roots, cuda_device), _tensors(tws, cuda_device),
                  torch.from_numpy(h).to(cuda_device), *extra)
        before = conv.conv_fft.launches
        got = conv.conv_fft(x, radices, tables, n_out, conj_out=with_tables)
        torch.cuda.synchronize()
        assert conv.conv_fft.launches == before + 1
        want = conv.conv_fft_plain(x, m, radices, tables, n_out, with_tables)
        assert _rel(got.cpu(), want.cpu()) <= VS_ORACLE


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1008, 114688, permute.SMEM_ROW_MAX, permute.SMEM_ROW_MAX + 1, 1009])
def test_permute_matches_plain_on_card(cuda_device, m):
    idx = torch.from_numpy(permute.permutation_index(np.random.default_rng(m).permutation(m))).to(cuda_device)
    x = torch.from_numpy(_signal(5, m, seed=m)).to(cuda_device)
    before = permute.permute.launches
    got = permute.permute(x, idx)
    torch.cuda.synchronize()
    assert permute.permute.launches == before + 1
    assert torch.equal(got, permute.permute_plain(x, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1008, 29000])
def test_permute_odd_offset_on_card(cuda_device, m):
    """An input whose data starts 8 bytes past a 16-byte boundary takes the
    shared-memory gather's 8-byte cp.async form: bit-equal all the same."""
    batch = 5
    idx = torch.from_numpy(permute.permutation_index(np.random.default_rng(m).permutation(m))).to(cuda_device)
    buf = torch.from_numpy(_signal(1, batch * m + 1, seed=m)).to(cuda_device)
    x = buf[0, 1:].view(batch, m)
    assert x.data_ptr() % 16 == 8 and permute.smem_rows(m) >= 1
    before = permute.permute.launches
    got = permute.permute(x, idx)
    torch.cuda.synchronize()
    assert permute.permute.launches == before + 1
    assert torch.equal(got, permute.permute_plain(x, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(7919, 16384), (15625, 32768)])
def test_two_pass_bluestein_matches_plain_on_card(cuda_device, n, m):
    x = _signal(3, n, seed=n)
    for d, _ in DIRECTIONS:
        chirp, h_fft = bluestein.bluestein_tables(n, m, d)
        fn = conv_radix.make_radix_conv_fn(m, d, np.complex64, h=h_fft, pre=chirp, post=chirp,
                                           conj_out=True, n_in=n, n_out=n)
        # m = 16384 and 32768: the cluster form, one launch of each pass
        before = conv_radix.conv_radix_pass2.launches
        got = fn(torch.from_numpy(x).to(cuda_device))
        torch.cuda.synchronize()
        assert conv_radix.conv_radix_pass2.launches == before + 1
        assert _rel(got.cpu(), fn(torch.from_numpy(x))) <= VS_ORACLE


@pytest.mark.cuda
@pytest.mark.parametrize("p", [65537, 114689])
def test_two_pass_rader_matches_plain_on_card(cuda_device, p):
    x = _signal(2, p, seed=p)
    for d, _ in DIRECTIONS:
        fn = conv.make_raders_fn(p, d, np.complex64)
        # 65537 (m = 4 x 16384): the two cluster passes; 114689: four stages
        counter, rise = ((conv_radix.conv_radix_pass1, 1) if p == 65537 else
                         (conv_radix.conv_col_stage, 2))
        before = counter.launches
        got = fn(torch.from_numpy(x).to(cuda_device))
        torch.cuda.synchronize()
        assert counter.launches == before + rise
        assert _rel(got.cpu(), fn(torch.from_numpy(x))) <= VS_ORACLE
        assert _rel(got.cpu(), host_dft(x, d)) <= VS_ORACLE


@pytest.mark.cuda
@pytest.mark.parametrize("n,counter,rise", [
    (1009, "conv_chain_fft", 1), (1234, "conv_chain_fft", 1), (7919, "conv_radix_pass2", 1),
    (65537, "conv_radix_pass2", 1), (263, "conv_chain_fft", 1), (257, "permute", 2),
])
def test_prime_path_on_card(cuda_device, n, counter, rise):
    """Each prime path launches its core once (the one-pass core's chain
    form at 1009, 1234 and 263, whose inner lengths chain_radices takes)."""
    fn = {"conv_chain_fft": conv.conv_chain_fft, "conv_radix_pass2": conv_radix.conv_radix_pass2,
          "permute": permute.permute}[counter]
    planner = rustfft_tpu_torch.FftPlanner(np.complex64, device="cuda")
    x = _signal(4, n, seed=n)
    for d, _ in DIRECTIONS:
        plan = planner.plan_fft_forward(n) if d is FftDirection.FORWARD else planner.plan_fft_inverse(n)
        before = fn.launches
        got = plan.process(torch.from_numpy(x).to(cuda_device))
        torch.cuda.synchronize()
        assert fn.launches == before + rise
        assert _rel(got.cpu(), host_dft(x, d)) <= VS_ORACLE


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 59, 1009])
def test_scalar_planner_on_card(cuda_device, n):
    """FftPlannerScalar's Rader and Bluestein nodes on the card."""
    planner = rustfft_tpu_torch.FftPlannerScalar(np.complex64, device="cuda")
    x = _signal(3, n, seed=n)
    for d, _ in DIRECTIONS:
        plan = planner.plan_fft_forward(n) if d is FftDirection.FORWARD else planner.plan_fft_inverse(n)
        got = plan.process(torch.from_numpy(x).to(cuda_device))
        torch.cuda.synchronize()
        assert _rel(got.cpu(), host_dft(x, d)) <= VS_ORACLE


@pytest.mark.cuda
@pytest.mark.parametrize("p,q", [(7, 16), (5, 81)])
def test_good_thomas_permute_on_card(cuda_device, p, q):
    from rustfft_tpu_torch.ops import dft

    x = _signal(3, p * q, seed=p * q)
    for d, _ in DIRECTIONS:
        fn = good_thomas.make_good_thomas_fn(
            p, q, dft.make_dft_fn(p, d, np.complex64), dft.make_dft_fn(q, d, np.complex64),
            use_kernel=True)
        before = permute.permute.launches
        got = fn(torch.from_numpy(x).to(cuda_device))
        torch.cuda.synchronize()
        assert permute.permute.launches == before + 2
        assert _rel(got.cpu(), host_dft(x, d)) <= VS_ORACLE


@pytest.mark.parametrize("n", [746497, 1000003])
def test_huge_primes_match_oracle(n):
    """Primes whose n-1 no core serves with register stages take the
    reference rule, then the prime rule: 746497 -> Rader onto K14's four
    stages, then the Bluestein at m = 1572864 on the fused large Bluestein's
    tile form, 1000003 -> Bluestein at m = 2^21 on the fused large
    Bluestein (ops/kernels/convlarge.py)."""
    planner = rustfft_tpu_torch.FftPlanner(np.complex64, device="cpu")
    plan = planner.plan_fft_forward(n)
    assert not conv.conv_aligned(n - 1, np.complex64)
    assert conv.conv_any_supported(plan.recipe.inner.length, np.complex64)
    x = _signal(1, n, seed=n)
    assert _rel(plan.process(x), host_dft(x, FftDirection.FORWARD)) <= VS_ORACLE


@pytest.mark.cuda
@pytest.mark.parametrize("n", [746497, 1000003])
def test_huge_primes_on_card(cuda_device, n):
    """746497 (the prime rule's Bluestein at m = 1572864) and 1000003: the
    fused large Bluestein's tile form (kernel A, B_conv, A2)."""
    from rustfft_tpu_torch.ops.kernels import convlarge

    counters = {"col": conv_radix.conv_col_stage, "row": conv_radix.conv_row_stage,
                "a": convlarge.bconv_col_tile, "bconv": convlarge.bconv_row_tile,
                "out": convlarge.bconv_out_tile}
    rises = {"col": 0, "row": 0, "a": 1, "bconv": 1, "out": 1}
    planner = rustfft_tpu_torch.FftPlanner(np.complex64, device="cuda")
    x = _signal(2, n, seed=n)
    for d, _ in DIRECTIONS:
        plan = planner.plan_fft_forward(n) if d is FftDirection.FORWARD else planner.plan_fft_inverse(n)
        before = {k: c.launches for k, c in counters.items()}
        got = plan.process(torch.from_numpy(x).to(cuda_device))
        torch.cuda.synchronize()
        assert {k: c.launches - before[k] for k, c in counters.items()} == rises
        assert _rel(got.cpu(), host_dft(x, d)) <= VS_ORACLE
