"""The kernel-variant switches of the two-pass stages, held against the JAX package.

K4 (the large pipeline's Gauss, deep and 2-D forms) and K14's gauss_mode
and in_shift: each plain torch version against the JAX kernels in Pallas
interpret mode at precision HIGHEST and against the f64 oracle, relative
mean error <= 1e-5, both directions, inputs made with numpy from a seed;
deep_a and blocks2d bit-equal to the default; the Gauss tables equal to the
JAX package's; the switches key both caches and reach only the "large"
route and the two-pass core.  On the CPU each wrapper runs its plain
version and launches nothing; the tests marked `cuda` hold each kernel
against its plain version on the card, and each switched path's launch
counts, and skip without a GPU.
"""
import jax
import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu import config as ref_config
from rustfft_tpu import twiddles as ref_twiddles
from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import fused as ref_fused
from rustfft_tpu.ops.pallas import large as ref_large
from rustfft_tpu_torch import FftPlanner, config, executor, route
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops import bluestein, raders
from rustfft_tpu_torch.ops.kernels import (
    conv, conv_radix, convlarge, large, large2f, large3, largepad,
)
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
DIR_IDS = ["fwd", "inv"]
HIGHEST = jax.lax.Precision.HIGHEST
TOL = 1e-5

#: the switches and their defaults (those of the JAX package)
SWITCHES = {"large_gauss": False, "large_blocks2d": False, "conv_radix_gauss": False,
            "rader_in_shift": False, "rader_full_out": True}


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


def _tensors(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _counters():
    return (large.large_col_stage, large.large_row_stage, large.large_col_stage_gauss,
            large.large_row_stage_gauss, conv_radix.conv_col_stage, conv_radix.conv_row_stage,
            conv_radix.conv_col_stage_gauss, conv_radix.conv_row_stage_gauss,
            conv_radix.conv_radix_pass1, conv_radix.conv_radix_pass2,
            conv_radix.conv_radix_pass1_gauss, conv_radix.conv_radix_pass2_gauss)


def _counts():
    return tuple(c.launches for c in _counters())


@pytest.fixture
def switches():
    """Set config switches by name; every one back at its default after."""
    def set_(**kw):
        for name, value in kw.items():
            assert name in SWITCHES
            setattr(config, name, value)
    try:
        yield set_
    finally:
        for name, value in SWITCHES.items():
            setattr(config, name, value)


@pytest.fixture(params=[True, False], ids=["native", "python"])
def use_native(request):
    old_port, old_ref = config.use_native, ref_config.use_native
    config.use_native = ref_config.use_native = request.param
    try:
        yield request.param
    finally:
        config.use_native, ref_config.use_native = old_port, old_ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_switch_defaults_equal_jax():
    for name, value in SWITCHES.items():
        assert getattr(type(config)(), name) is value
        assert getattr(type(ref_config)(), name) is value


# -- K4: the large pipeline's Gauss, deep and 2-D forms -------------------------

@pytest.mark.parametrize("n,split", [(128, (8, 4, 4)), (32768, None)], ids=["8x4x4", "32768"])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_large_gauss_matches_jax_and_oracle(n, split, d, rd):
    """The Gauss pipeline (large_col_stage_gauss + large_row_stage_gauss)
    against the JAX _kernel_a_gauss + _kernel_b_gauss (test_pallas.py:84-98)."""
    split = split or large.choose_pqq(n)
    x = _signal(2, n, seed=n + 1)
    before = _counts()
    fn = large.make_large_fft_fn(n, d, np.complex64, split=split, gauss=True)
    assert fn.stages == (large.large_col_stage_gauss, large.large_row_stage_gauss)
    got = fn(torch.from_numpy(x))
    assert _counts() == before  # a CPU tensor runs the plain versions
    ref = _jax_out(ref_large.make_large_fft_fn(n, rd, np.complex64, split=split, interpret=True,
                                               precision=HIGHEST, gauss=True), x)
    assert _rel(got, host_dft(x, d)) <= TOL
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_large_deep_a_matches_jax(d, rd):
    """deep_a runs K2's column stage, already the multi-stage form of the
    JAX _kernel_a_deep (test_pallas.py:556-570)."""
    n = 32768
    x = _signal(2, n, seed=7)
    fn = large.make_large_fft_fn(n, d, np.complex64, deep_a=True)
    assert fn.stages == (large.large_col_stage, large.large_row_stage)
    got = fn(torch.from_numpy(x))
    ref = _jax_out(ref_large.make_large_fft_fn(n, rd, np.complex64, interpret=True,
                                               precision=HIGHEST, deep_a=True), x)
    assert _rel(got, host_dft(x, d)) <= TOL
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("n,split", [(128, (8, 4, 4)), (32768, None), (1 << 20, None)],
                         ids=["8x4x4", "32768", "2^20"])
def test_large_deep_and_2d_bit_equal_to_default(n, split):
    x = torch.from_numpy(_signal(2, n, seed=n))
    for d, _ in DIRECTIONS:
        want = large.make_large_fft_fn(n, d, np.complex64, split=split)(x)
        for kw in (dict(deep_a=True), dict(blocks2d=True), dict(variant="wlhs"),
                   dict(deep_a=True, variant="wlhs")):
            fn = large.make_large_fft_fn(n, d, np.complex64, split=split, **kw)
            assert fn.stages == (large.large_col_stage, large.large_row_stage), kw
            assert torch.equal(fn(x), want), kw


def test_large_blocks2d_matches_jax():
    n, d, rd = 32768, FftDirection.FORWARD, RefDirection.FORWARD
    x = _signal(2, n, seed=3)
    got = large.make_large_fft_fn(n, d, np.complex64, blocks2d=True)(torch.from_numpy(x))
    ref = _jax_out(ref_large.make_large_fft_fn(n, rd, np.complex64, interpret=True,
                                               precision=HIGHEST, blocks2d=True), x)
    assert _rel(got, ref) <= TOL


def test_make_large_fft_fn_checks(switches):
    d = FftDirection.FORWARD
    for kw in (dict(blocks2d=True, gauss=True), dict(blocks2d=True, deep_a=True)):
        with pytest.raises(ValueError):
            large.make_large_fft_fn(32768, d, np.complex64, **kw)
    switches(large_blocks2d=True)
    with pytest.raises(ValueError):  # the config's blocks2d with gauss
        large.make_large_fft_fn(32768, d, np.complex64, gauss=True)
    switches(large_blocks2d=False)
    with pytest.raises(ValueError):
        large.make_large_fft_fn(32768, d, np.complex64, variant="transpose")
    with pytest.raises(ValueError):
        large.make_large_fft_fn(128, d, np.complex64, split=(8, 4, 8))  # 256 != 128
    with pytest.raises(ValueError):
        large.make_large_fft_fn(32768, d, np.complex128)
    with pytest.raises(ValueError):
        large.make_large_fft_fn(509, d, np.complex64)  # a prime: no split


def test_large_gauss_and_2d_follow_config(switches):
    d = FftDirection.FORWARD
    assert large.make_large_fft_fn(32768, d, np.complex64).stages[0] is large.large_col_stage
    switches(large_gauss=True)
    fn = large.make_large_fft_fn(32768, d, np.complex64)
    assert fn.stages == (large.large_col_stage_gauss, large.large_row_stage_gauss)
    assert large.make_large_fft_fn(32768, d, np.complex64, gauss=False).stages[0] is \
        large.large_col_stage
    switches(large_gauss=False, large_blocks2d=True)
    assert large.make_large_fft_fn(32768, d, np.complex64).stages[1] is large.large_row_stage


@pytest.mark.parametrize("r", [2, 3, 4, 5, 7, 8, 12, 16, 17, 64, 103, 256])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_gauss_tables_equal_jax(r, d, rd, use_native):
    """Wr, Wi, Ws at (j*k) mod r equal the JAX package's
    gauss_tables(dft_matrix(r), HIGHEST) entries: f64, then cast to f32."""
    (g,) = large.gauss_tables([r], d)
    assert g.dtype == np.float32 and g.shape == (3, r)
    wr, _, wi, _, ws, _ = ref_fused.gauss_tables(ref_twiddles.dft_matrix(r, rd), HIGHEST)
    j = np.arange(r)
    e = np.outer(j, j) % r
    for mine, ref in zip(g, (wr, wi, ws)):
        assert ref.dtype == np.float32 and np.array_equal(mine[e], ref)


def test_gauss_tile_rules():
    """The Gauss form runs K2's and K3's tile kernels where they take the
    default form: at 2^20, P = 256 over (16, 16) and Q = 4096 over (16, 16,
    16) take their widths, 16 and 4.  Off those chains it keeps the general
    kernels' widths, whose shared memory holds 16 bytes per root (Q = 2048
    over (16, 16, 8), and Q = 4096 at P = 65536, past the row-tile kernel's
    32768); K14's Gauss tiles are its own rule's."""
    p, q1, q2 = large.choose_pqq(1 << 20)
    q = q1 * q2
    assert (large.stage_radices(p), large.stage_radices(q)) == ((16, 16), (16, 16, 16))
    assert (large.col_tile(p, q), large.row_tile(q, p)) == (16, 4)  # compile-time kernels
    assert (large.col_tile(p, q, gauss=True), large.row_tile(q, p, gauss=True)) == (16, 4)
    assert large.stage_radices(2048) == (16, 16, 8)
    assert large.row_tile(2048, 256, gauss=True) == large.general_row_tile(2048, 256, gauss=True)
    assert large.row_tile(2048, 256, gauss=True) == 2
    assert (large.row_tile(4096, 65536), large.row_tile(4096, 65536, gauss=True)) == (4, 2)
    assert large.col_tile(128, 2048, gauss=True) == large.general_col_tile(128, 2048, gauss=True)
    assert large.smem_bytes(4096, (16, 16), gauss=True) - large.smem_bytes(4096, (16, 16)) == 8 * 32
    assert conv_radix.col_tile(256, 256, gauss=True) == 16
    assert conv_radix.row_tile(256, 256, gauss=True) == 16


def test_gauss_wrappers_check_their_tables():
    p, q = 16, 8
    x = torch.from_numpy(_signal(2, p * q, seed=1))
    roots, tws, outer = large.col_tables(p, q, FftDirection.FORWARD)
    gtabs = large.gauss_tables(large.stage_radices(p), FftDirection.FORWARD)
    with pytest.raises(ValueError):  # the roots where the Gauss tables belong
        large.large_col_stage_gauss(x, p, q, (_tensors(roots), _tensors(tws),
                                              torch.from_numpy(outer)))
    with pytest.raises(TypeError):  # the Gauss tables where the roots belong
        large.large_col_stage(x, p, q, (_tensors(gtabs), _tensors(tws), torch.from_numpy(outer)))
    a = large.large_col_stage_gauss(x, p, q, (_tensors(gtabs), _tensors(tws),
                                              torch.from_numpy(outer)))
    rg, rt = large.row_tables(q, FftDirection.FORWARD, gauss=True)
    with pytest.raises(ValueError):
        large.large_row_stage_gauss(a, q, p, (_tensors(rg)[:0], _tensors(rt)))
    got = large.large_row_stage_gauss(a, q, p, (_tensors(rg), _tensors(rt)))
    assert _rel(got, host_dft(x.numpy(), FftDirection.FORWARD)) <= TOL


# -- K14: the two-pass core's gauss_mode and in_shift ---------------------------

@pytest.mark.parametrize("p", [257, 769, 1031])
@pytest.mark.parametrize("gauss", [False, True], ids=["block", "gauss"])
@pytest.mark.parametrize("in_shift", [False, True], ids=["copy", "in_shift"])
@pytest.mark.parametrize("d", [FftDirection.FORWARD, FftDirection.INVERSE], ids=DIR_IDS)
def test_rader_core_gauss_and_in_shift_match_oracle(p, gauss, in_shift, d):
    """The whole Rader transform of prime p on the two-pass core at small m
    (256 = 64 x 4, 768 = 192 x 4, 1030 = 206 x 5 with a radix-103 stage),
    gathers, +x0 and the DC-first output fused; with in_shift the core
    reads the raw rows, and the DC bin is x0 plus the raw input's sum."""
    m = p - 1
    perm_in, inv_gather, b_fft = raders.raders_tables(p, d)
    core = conv_radix.make_radix_conv_fn(
        m, d, np.complex64, h=b_fft, conj_out=True, in_perm=perm_in - 1, out_perm=inv_gather,
        x0_add=True, emit_sum=True, full_out=True, gauss=gauss, in_shift=in_shift)
    x = _signal(3, p, seed=p)
    t = torch.from_numpy(x)
    got = core(t) if in_shift else core(t[:, 1:].contiguous(), const=t[:, :1].contiguous())
    assert got.shape == (3, p)
    want = host_dft(x, d)
    assert _rel(got, want) <= TOL
    # the DC bin is the f32 sum of the raw row
    np.testing.assert_allclose(got[:, 0].numpy(), x.astype(np.complex128).sum(axis=1),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n,m", [(100, 256), (7919, 16384)])
@pytest.mark.parametrize("d", [FftDirection.FORWARD, FftDirection.INVERSE], ids=DIR_IDS)
def test_bluestein_core_gauss_matches_oracle(n, m, d, switches):
    """config.conv_radix_gauss reaches the Bluestein core as well
    (conv_radix.py:720)."""
    chirp, h_fft = bluestein.bluestein_tables(n, m, d)
    x = _signal(2, n, seed=n)
    switches(conv_radix_gauss=True)
    got = conv_radix.make_radix_conv_fn(m, d, np.complex64, h=h_fft, pre=chirp, post=chirp,
                                        conj_out=True, n_in=n, n_out=n)(torch.from_numpy(x))
    assert _rel(got, host_dft(x, d)) <= TOL


def test_gauss_core_matches_jax():
    """The Gauss core against the JAX kernel's gauss_mode at m = 32768 (the
    smallest m = r * 128 * 128 the JAX core takes): Bluestein 15625."""
    from rustfft_tpu.ops import bluestein as ref_bluestein
    from rustfft_tpu.ops.pallas import conv_radix as ref_conv_radix

    n, m, d, rd = 15625, 32768, FftDirection.INVERSE, RefDirection.INVERSE
    chirp, h_fft = bluestein.bluestein_tables(n, m, d)
    x = _signal(2, n, seed=11)
    got = conv_radix.make_radix_conv_fn(m, d, np.complex64, h=h_fft, pre=chirp, post=chirp,
                                        conj_out=True, n_in=n, n_out=n,
                                        gauss=True)(torch.from_numpy(x))
    ref_chirp, ref_h = ref_bluestein.bluestein_tables(n, m, rd)
    ref = ref_conv_radix.make_radix_conv_fn(m, rd, np.complex64, h=ref_h, pre=ref_chirp,
                                            post=ref_chirp, conj_out=True, n_in=n, n_out=n,
                                            interpret=True, precision=HIGHEST, gauss=True)
    assert _rel(got, _jax_out(ref, x)) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


def test_in_shift_and_gauss_checks():
    m, d = 256, FftDirection.FORWARD
    perm_in, inv_gather, b_fft = raders.raders_tables(m + 1, d)
    with pytest.raises(ValueError):  # in_shift needs full_out
        conv_radix.make_radix_conv_fn(m, d, np.complex64, h=b_fft, in_perm=perm_in - 1,
                                      out_perm=inv_gather, x0_add=True, emit_sum=True,
                                      in_shift=True)
    core = conv_radix.make_radix_conv_fn(
        m, d, np.complex64, h=b_fft, conj_out=True, in_perm=perm_in - 1, out_perm=inv_gather,
        x0_add=True, emit_sum=True, full_out=True, in_shift=True)
    x = torch.from_numpy(_signal(2, m + 1, seed=2))
    with pytest.raises(ValueError):  # x0 comes from the raw rows
        core(x, const=x[:, :1])
    p, q = conv_radix.choose_split(m)
    col = large.col_tables(p, q, d, gauss=True)
    colt = (_tensors(col[0]), _tensors(col[1]), torch.from_numpy(col[2]))
    with pytest.raises(TypeError):  # the Gauss tables need gauss=True
        conv_radix.conv_col_stage(x[:, 1:], p, q, colt)
    with pytest.raises(ValueError):  # overlapping rows
        conv_radix.conv_col_stage_gauss(x.as_strided((2, m), (1, 1), 1), p, q, colt)
    a, _ = conv_radix.conv_col_stage_gauss(x[:, 1:], p, q, colt)
    want, _ = conv_radix.conv_col_stage_gauss(x[:, 1:].contiguous(), p, q, colt)
    assert torch.equal(a, want)


@pytest.mark.parametrize("sw", [dict(rader_in_shift=True), dict(conv_radix_gauss=True),
                                dict(rader_in_shift=True, conv_radix_gauss=True),
                                dict(rader_full_out=False),
                                dict(rader_full_out=False, rader_in_shift=True)],
                         ids=["in_shift", "gauss", "both", "no_full_out", "no_full_out+in_shift"])
def test_rader_65537_switches_through_the_planner(sw, switches):
    """65537 (Rader on the two-pass core at m = 65536) through
    FftPlanner(device="cpu") under each switch, against the f64 oracle and
    the JAX FftPlanner; in_shift needs rader_full_out, as in the JAX
    package (conv.py:296)."""
    n = 65537
    x = _signal(2, n, seed=5)
    ref_planner = rustfft_tpu.FftPlanner(np.complex64)
    default = FftPlanner(np.complex64, device="cpu").plan_fft_forward(n)
    switches(**sw)
    planner = FftPlanner(np.complex64, device="cpu")
    before = _counts()
    for plan, ref_plan, d in ((planner.plan_fft_forward(n), ref_planner.plan_fft_forward(n),
                               FftDirection.FORWARD),
                              (planner.plan_fft_inverse(n), ref_planner.plan_fft_inverse(n),
                               FftDirection.INVERSE)):
        got = plan.process(x)
        assert _rel(got, host_dft(x, d)) <= TOL
        assert _rel(got, np.asarray(ref_plan.process(x))) <= TOL
    assert _counts() == before
    assert planner.plan_fft_forward(n).raw_fn is not default.raw_fn


def test_rader_full_out_off_takes_the_sums_form(switches, monkeypatch):
    """rader_full_out off: the core returns (rest, sums) and the DC bin and
    the concatenation are torch glue (the JAX package's conv.py:348-350)."""
    made = []
    real = conv_radix.make_radix_conv_fn

    def spy(*args, **kw):
        made.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(conv_radix, "make_radix_conv_fn", spy)
    switches(rader_full_out=False, rader_in_shift=True)
    x = _signal(2, 65537, seed=8)
    got = conv.make_raders_fn(65537, FftDirection.FORWARD, np.complex64)(torch.from_numpy(x))
    assert made and not made[0]["full_out"] and not made[0]["in_shift"]
    assert made[0]["emit_sum"] and made[0]["x0_add"]
    assert got.shape == (2, 65537)
    assert _rel(got, host_dft(x, FftDirection.FORWARD)) <= TOL


# -- the caches and the reach of the switches -----------------------------------

@pytest.mark.parametrize("name,n", [("large_gauss", 1 << 20), ("large_blocks2d", 1 << 20),
                                    ("conv_radix_gauss", 65537), ("rader_in_shift", 65537),
                                    ("rader_full_out", 65537)])
def test_switches_key_both_caches(name, n, switches):
    planner = FftPlanner(np.complex64, device="cpu")
    plan = planner.plan_fft_forward(n)
    fn = executor.build(plan.recipe, FftDirection.FORWARD, np.complex64)
    assert plan.raw_fn is fn and planner.plan_fft_forward(n) is plan
    switches(**{name: not SWITCHES[name]})
    other = planner.plan_fft_forward(n)
    assert other is not plan and other.raw_fn is not fn
    assert executor.build(plan.recipe, FftDirection.FORWARD, np.complex64) is other.raw_fn
    switches(**{name: SWITCHES[name]})
    assert planner.plan_fft_forward(n) is plan
    assert executor.build(plan.recipe, FftDirection.FORWARD, np.complex64) is fn


def test_large_gauss_reaches_the_large_route(switches, monkeypatch):
    calls = []
    real = large.gauss_stages_plain
    monkeypatch.setattr(large, "gauss_stages_plain",
                        lambda *a: calls.append(a[1]) or real(*a))
    switches(large_gauss=True)
    n = 1 << 20
    assert route(n, np.complex64) == "large"
    x = _signal(1, n, seed=2)
    got = FftPlanner(np.complex64, device="cpu").plan_fft_forward(n).process(x)
    assert calls == [(16, 16), (16, 16, 16)]
    assert _rel(got, host_dft(x, FftDirection.FORWARD)) <= TOL


def test_switches_do_not_reach_other_routes(switches, monkeypatch):
    """With every switch on, large_pad, large2f, large3f and the fused large
    Bluestein (K15) run no Gauss stage: the JAX package reads large_gauss
    only in large.make_large_fft_fn and its K15 kernel A has no Gauss form
    (convlarge.py:245)."""
    def no_gauss(*args):
        raise AssertionError("a Gauss stage ran")

    monkeypatch.setattr(large, "gauss_stages_plain", no_gauss)
    switches(large_gauss=True, large_blocks2d=True, conv_radix_gauss=True, rader_in_shift=True)
    d = FftDirection.FORWARD
    assert [route(n, np.complex64) for n in (15625, 1 << 23, 1 << 26)] == \
        ["large_pad", "large2f", "large3f"]
    planner = FftPlanner(np.complex64, device="cpu")
    recipe = planner.plan_fft_forward(1000003).recipe
    assert executor.build(recipe, d, np.complex64).__module__ == convlarge.__name__
    for n in (15625, 1 << 23, 1 << 26):
        assert executor.build(planner.plan_fft_forward(n).recipe, d, np.complex64).__module__ in \
            (largepad.__name__, large2f.__name__, large3.__name__)
    x = _signal(1, 15625, seed=1)
    assert _rel(planner.plan_fft_forward(15625).process(x), host_dft(x, d)) <= TOL
    n, split = 8 * 4 * 16, (8, 4, 4, 4, 16)
    x = _signal(2, n, seed=3)
    for fn in (largepad.make_largepad_fft_fn(n, d, np.complex64, split=(8, 4, 16)),
               large2f.make_large2f_fft_fn(n, d, np.complex64, split=split),
               large3.make_large3_fft_fn(n, d, np.complex64, split=split, factored=True)):
        assert _rel(fn(torch.from_numpy(x)), host_dft(x, d)) <= TOL
    n, m = 8191, 16384
    x = _signal(2, n, seed=4)
    fn = convlarge.make_bluestein_large_fn(n, m, d, np.complex64, split=large.choose_pqq(m))
    assert _rel(fn(torch.from_numpy(x)), host_dft(x, d)) <= TOL


# -- on the card ----------------------------------------------------------------

def _card_tables(host, device):
    return tuple(_tensors(t, device) if isinstance(t, list) else torch.from_numpy(t).to(device)
                 for t in host)


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(32768, 3), (1 << 20, 2), (128, 5)])
def test_large_gauss_stages_match_plain_on_card(cuda_device, n, batch):
    split = (8, 4, 4) if n == 128 else large.choose_pqq(n)
    p, q = split[0], split[1] * split[2]
    x = torch.from_numpy(_signal(batch, n, seed=n)).to(cuda_device)
    for d, _ in DIRECTIONS:
        col = _card_tables(large.col_tables(p, q, d, gauss=True), cuda_device)
        row = _card_tables(large.row_tables(q, d, gauss=True), cuda_device)
        before = _counts()
        a = large.large_col_stage_gauss(x, p, q, col)
        y = large.large_row_stage_gauss(a, q, p, row)
        torch.cuda.synchronize()
        assert _counts()[2:4] == (before[2] + 1, before[3] + 1)
        assert _rel(a.cpu(), large.large_col_stage_gauss_plain(x, p, q, col).cpu()) <= TOL
        assert _rel(y.cpu(), large.large_row_stage_gauss_plain(a, q, p, row).cpu()) <= TOL
        assert _rel(y.cpu(), host_dft(x.cpu().numpy(), d)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("gauss", [False, True], ids=["block", "gauss"])
@pytest.mark.parametrize("p", [65537, 1031])
def test_rader_core_stages_on_card(cuda_device, p, gauss):
    """The in_shift column stage (rows m + 1 apart) and the Gauss stages of
    the Rader core, stage by stage against their plain versions."""
    m = p - 1
    q_p = conv_radix.choose_split(m)
    for d, _ in DIRECTIONS:
        perm_in, inv_gather, b_fft = raders.raders_tables(p, d)
        host = conv_radix.radix_conv_tables(m, d, h=b_fft, in_perm=perm_in - 1,
                                            out_perm=inv_gather, gauss=gauss)
        col = _card_tables(host["col"], cuda_device)
        row = _card_tables(host["row"], cuda_device)
        t = {k: torch.from_numpy(host[k]).to(cuda_device) for k in ("h", "perm", "scatter")}
        x = torch.from_numpy(_signal(3, p, seed=p)).to(cuda_device)
        pp, q = q_p
        a, part = conv_radix.conv_col_stage(x[:, 1:], pp, q, col, perm=t["perm"], emit_sum=True,
                                            gauss=gauss)
        a_p, part_p = conv_radix.conv_col_stage_plain(x[:, 1:], pp, q, col, None, t["perm"],
                                                      True, gauss)
        torch.cuda.synchronize()
        assert _rel(a.cpu(), a_p.cpu()) <= TOL and _rel(part.cpu(), part_p.cpu()) <= TOL
        z = conv_radix.conv_row_stage(a, q, pp, row, m, h=t["h"], gauss=gauss)
        assert _rel(z.cpu(), conv_radix.conv_row_stage_plain(a, q, pp, row, m, h=t["h"],
                                                             gauss=gauss).cpu()) <= TOL
        b, _ = conv_radix.conv_col_stage(z, pp, q, col, gauss=gauss)
        kw = dict(conj_out=True, x0=x[:, 0], scatter=t["scatter"], partials=part, gauss=gauss)
        out = conv_radix.conv_row_stage(b, q, pp, row, m, **kw)
        torch.cuda.synchronize()
        assert _rel(out.cpu(), conv_radix.conv_row_stage_plain(b, q, pp, row, m, **kw).cpu()) <= TOL
        assert _rel(out.cpu(), host_dft(x.cpu().numpy(), d)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,sw,rise", [
    (1 << 20, dict(large_gauss=True), {2: 1, 3: 1}),
    (1 << 20, dict(large_blocks2d=True), {0: 1, 1: 1}),
    (65537, dict(rader_in_shift=True), {4: 2, 5: 2}),
    (65537, dict(conv_radix_gauss=True), {10: 1, 11: 1}),
    (65537, dict(rader_in_shift=True, conv_radix_gauss=True), {6: 2, 7: 2}),
    (7919, dict(conv_radix_gauss=True), {10: 1, 11: 1}),
    (15625, dict(large_gauss=True, conv_radix_gauss=True, rader_in_shift=True), {}),
    (1000003, dict(large_gauss=True, conv_radix_gauss=True, rader_in_shift=True), {}),
], ids=["2^20-gauss", "2^20-2d", "65537-in_shift", "65537-gauss", "65537-both", "7919-gauss",
        "15625-all", "1000003-all"])
def test_switched_paths_on_card(cuda_device, n, sw, rise, switches):
    """Each switched path launches exactly its stages: the Gauss stages
    under large_gauss, the Gauss cluster passes under conv_radix_gauss
    (the four Gauss stages with in_shift too), the default core under
    in_shift, none of the counters' kernels on large_pad or K15 (its tile
    form launches kernels of its own, convlarge.bconv_col_tile ...)."""
    switches(**sw)
    planner = FftPlanner(np.complex64, device="cuda")
    x = _signal(2, n, seed=n)
    for d, _ in DIRECTIONS:
        plan = planner.plan_fft_forward(n) if d is FftDirection.FORWARD else planner.plan_fft_inverse(n)
        before = _counts()
        got = plan.process(torch.from_numpy(x).to(cuda_device))
        torch.cuda.synchronize()
        after = _counts()
        assert {i: a - b for i, (a, b) in enumerate(zip(after, before)) if a != b} == rise
        assert _rel(got.cpu(), host_dft(x, d)) <= TOL


@pytest.mark.cuda
def test_deep_and_2d_bit_equal_on_card(cuda_device):
    n = 1 << 20
    x = torch.from_numpy(_signal(3, n, seed=1)).to(cuda_device)
    for d, _ in DIRECTIONS:
        want = large.make_large_fft_fn(n, d, np.complex64)(x)
        for kw in (dict(deep_a=True), dict(blocks2d=True)):
            assert torch.equal(large.make_large_fft_fn(n, d, np.complex64, **kw)(x), want)


def _forbid_kernels(monkeypatch):
    """Make every whole-node kernel and convolution core the executor could
    substitute raise when it is built."""
    def forbidden(*args, **kwargs):
        raise AssertionError("a pinned build reached a kernel")

    monkeypatch.setattr(executor, "_kernel_fn", forbidden)
    monkeypatch.setattr(conv, "make_raders_fn", forbidden)
    monkeypatch.setattr(conv, "make_bluestein_fn", forbidden)
    monkeypatch.setattr(convlarge, "make_bluestein_large_fn", forbidden)


@pytest.mark.parametrize("order", ["pinned_first", "unpinned_first"])
@pytest.mark.parametrize("n", [4096, 1009, 1234])
def test_pinned_keys_the_build_cache(n, order, monkeypatch):
    """pinned joins executor.build's cache key: a pinned plan and an unpinned
    plan of one recipe never share a built function, in either order of
    construction into an empty cache; a pinned build never reaches a kernel
    (route 'lanepack' at 4096, the one-pass core at 1009 and 1234); both
    agree with the oracle."""
    from collections import OrderedDict

    from rustfft_tpu_torch.plan import FftPlan

    monkeypatch.setattr(executor, "_CACHE", OrderedDict())
    d = FftDirection.FORWARD
    recipe = FftPlanner(np.complex64, device="cpu").design_fft_for_len(n)
    assert route(n, np.complex64) == "lanepack" if n == 4096 else route(n, np.complex64) is None

    def build(pinned):
        return FftPlan(recipe, d, np.complex64, device="cpu", pinned=pinned)

    if order == "pinned_first":
        with monkeypatch.context() as m:
            _forbid_kernels(m)
            pinned = build(True)
        unpinned = build(False)
    else:
        unpinned = build(False)
        with monkeypatch.context() as m:
            _forbid_kernels(m)
            pinned = build(True)
    assert pinned.pinned and not unpinned.pinned
    assert pinned.raw_fn is not unpinned.raw_fn
    assert executor.build(recipe, d, np.complex64, pinned=True) is pinned.raw_fn
    assert executor.build(recipe, d, np.complex64) is unpinned.raw_fn
    x = _signal(3, n, seed=n)
    want = host_dft(x, d)
    assert _rel(pinned.process(x), want) <= TOL
    assert _rel(unpinned.process(x), want) <= TOL


def test_pinned_good_thomas_keeps_its_gathers(monkeypatch):
    """As in the JAX package (executor.py:336-344), a pinned Good-Thomas node
    re-indexes through the permute wrapper (K16 on the card)."""
    from rustfft_tpu_torch import algorithm
    from rustfft_tpu_torch.ops.kernels import permute

    calls = []
    real = permute.make_permute_fn
    monkeypatch.setattr(permute, "make_permute_fn", lambda idx: calls.append(len(idx)) or real(idx))
    d = FftDirection.FORWARD
    plan = algorithm.GoodThomasAlgorithm(algorithm.Butterfly(7, d, device="cpu"),
                                         algorithm.Radix4(128, d, device="cpu"))
    assert calls == [896, 896]
    x = _signal(2, 896, seed=7)
    assert _rel(plan.process(x), host_dft(x, d)) <= TOL
