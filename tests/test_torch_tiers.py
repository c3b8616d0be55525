"""The JAX router's last three tiers in the port, held against the JAX package.

dense (K5), largepad (K12) and convlarge (K15): each module's plain torch
version against the JAX kernels in Pallas interpret mode and the f64 oracle,
relative mean error <= 1e-5, both directions, inputs made with numpy from a
seed; host tables bit-equal to the JAX package's; the routes and the
executor's Bluestein branch pinned.  On the CPU each wrapper runs its plain
version and launches nothing; the tests marked `cuda` hold each kernel
against its plain version on the card, and each new path's launch counts,
and skip without a GPU.
"""
import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu import config as ref_config
from rustfft_tpu import twiddles as ref_twiddles
from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops import bluestein as ref_bluestein
from rustfft_tpu.ops.pallas import convlarge as ref_convlarge
from rustfft_tpu.ops.pallas import dense as ref_dense
from rustfft_tpu.ops.pallas import large as ref_large
from rustfft_tpu.ops.pallas import largepad as ref_largepad
from rustfft_tpu_torch import FftPlanner, config, executor, recipes, route
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import (
    conv, conv_radix, convlarge, dense, large, largepad,
)
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
DIR_IDS = ["fwd", "inv"]
TOL = 1e-5

#: the primes dense_fft serves: 5..251 (2 and 3 are below dense_supported's 4)
SMALL_PRIMES = [p for p in range(5, 257) if all(p % d for d in range(2, int(p ** 0.5) + 1))]
#: the lane-misaligned composites large_pad takes from large's one-column tiles
ODD_COMPOSITES = [15625, 19683, 59049, 78125, 177147, 531441]


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


def _counts():
    return (dense.dense_fft.launches, dense.dense_chain_fft.launches,
            largepad.largepad_col_stage.launches,
            largepad.largepad_row_stage.launches, convlarge.bconv_row_stage.launches,
            convlarge.bconv_out_stage.launches, conv_radix.conv_col_stage.launches,
            conv_radix.conv_row_stage.launches, large.large_col_stage.launches,
            large.large_row_stage.launches)


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


# -- dense (K5) -----------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 17, 127, 243, 251, 500, 1009, 1234])
@pytest.mark.parametrize("variant", ["block", "gauss"])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_dense_matches_jax_and_oracle(n, variant, d, rd):
    x = _signal(3, n, seed=n)
    before = _counts()
    got = dense.make_dense_fft_fn(n, d, np.complex64, variant)(torch.from_numpy(x)).numpy()
    assert _counts() == before  # a CPU tensor runs the plain version
    ref = _jax_out(ref_dense.make_dense_fft_fn(n, rd, np.complex64, interpret=True,
                                               variant=variant), x)
    assert _rel(got, host_dft(x, d)) <= TOL
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("n", [5, 127, 251, 500])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_dense_tables_bit_equal(n, d, rd, use_native):
    w, ws = dense.dense_tables(n, d, "gauss")
    ref_w = ref_twiddles.dft_matrix(n, rd)
    assert np.array_equal(w, ref_w.astype(np.complex64))
    # the JAX package's Gauss table: f32 real plus f32 imaginary part
    ref_ws = (np.ascontiguousarray(ref_w.real).astype(np.float32)
              + np.ascontiguousarray(ref_w.imag).astype(np.float32))
    assert ws.dtype == np.float32 and np.array_equal(ws, ref_ws)
    w_block, none = dense.dense_tables(n, d, "block")
    assert none is None and np.array_equal(w_block, w)


def test_dense_choose_variant_equals_jax():
    assert all(dense.choose_variant(n) == ref_dense.choose_variant(n) for n in range(4, 2049))


def test_dense_routes():
    assert [n for n in range(2049) if route(n, np.complex64) == "dense"] == SMALL_PRIMES
    assert route(256, np.complex64) == "lanepack"  # kept: a radix split exists
    for n in (2, 3, 1009, 1234):
        assert route(n, np.complex64) is None  # the recipe tree / the convolution cores
    assert route(127, np.complex128) is None
    assert dense.dense_supported(4, np.complex64) and not dense.dense_supported(3, np.complex64)
    assert not dense.dense_supported(127, np.complex128)


@pytest.mark.parametrize("n", [5, 127, 251])
def test_small_primes_through_the_planner(n):
    planner = FftPlanner(np.complex64, device="cpu")
    ref_planner = rustfft_tpu.FftPlanner(np.complex64)
    x = _signal(4, n, seed=n + 1)
    for plan, ref_plan, d in ((planner.plan_fft_forward(n), ref_planner.plan_fft_forward(n),
                               FftDirection.FORWARD),
                              (planner.plan_fft_inverse(n), ref_planner.plan_fft_inverse(n),
                               FftDirection.INVERSE)):
        fn = executor.build(plan.recipe, d, np.complex64)
        assert fn.__module__ == dense.__name__
        got = plan.process(x)
        assert _rel(got, host_dft(x, d)) <= TOL
        assert _rel(got, np.asarray(ref_plan.process(x))) <= TOL


def test_dense_wrapper_checks():
    w, ws = (torch.from_numpy(t) for t in dense.dense_tables(7, FftDirection.FORWARD, "gauss"))
    x = torch.from_numpy(_signal(2, 7, seed=0))
    with pytest.raises(ValueError):
        dense.dense_fft(x, (w, None), "gauss")  # the Gauss form needs Wr + Wi
    with pytest.raises(ValueError):
        dense.dense_fft(x, (w, ws), "karatsuba")
    with pytest.raises(ValueError):
        dense.dense_fft(x[:, :6].contiguous(), (w, ws), "block")


# -- largepad (K12) -------------------------------------------------------------

@pytest.mark.parametrize("n,split", [(3125, (25, 25, 5)), (46656, (96, 18, 27))],
                         ids=["3125", "46656"])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_largepad_matches_jax_and_oracle(n, split, d, rd):
    assert ref_largepad.choose_pq_padded(46656) == (96, 18, 27)
    x = _signal(2, n, seed=n)
    before = _counts()
    got = largepad.make_largepad_fft_fn(n, d, np.complex64, split=split)(torch.from_numpy(x))
    assert _counts() == before
    ref = _jax_out(ref_largepad.make_largepad_fft_fn(n, rd, np.complex64, split=split,
                                                     interpret=True), x)
    assert _rel(got, host_dft(x, d)) <= TOL
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("n", [78125, 177147, 531441])
def test_largepad_split_equals_jax(n):
    assert large.choose_pqq(n) == ref_largepad.choose_pq_padded(n)


def test_largepad_routes():
    for n in ODD_COMPOSITES:
        assert route(n, np.complex64) == "large_pad", n
        assert largepad.narrowed_by_division(n)
    for n in (10 ** 6, 1 << 20, 1 << 21, 393216):
        assert route(n, np.complex64) == "large", n
        assert not largepad.narrowed_by_division(n)
    assert route(14577, np.complex64) == "large_pad"  # 129 x 113: one column on large
    assert route(78125, np.complex128) is None
    # today's other routes are unchanged
    assert [route(n, np.complex64) for n in (4096, 16384, 65536, 1 << 22, 1 << 26)] == \
        ["lanepack", "two_stage", "radix", "large2f", "large3f"]


def test_largepad_tile_widths():
    """large's tiles at the odd composites are one column wide on both
    stages; largepad's are 16 columns, 4 at Q = 2187."""
    widths = {}
    for n in ODD_COMPOSITES:
        p, q1, q2 = large.choose_pqq(n)
        q = q1 * q2
        assert (large.col_tile(p, q), large.row_tile(q, p)) == (1, 1)
        widths[n] = (largepad.tile(p), largepad.tile(q))
    assert widths == {15625: (16, 16), 19683: (16, 16), 59049: (16, 16), 78125: (16, 16),
                      177147: (16, 16), 531441: (16, 4)}


def test_78125_through_the_planner():
    planner = FftPlanner(np.complex64, device="cpu")
    x = _signal(1, 78125, seed=5)
    before = _counts()
    for plan, d in ((planner.plan_fft_forward(78125), FftDirection.FORWARD),
                    (planner.plan_fft_inverse(78125), FftDirection.INVERSE)):
        assert executor.build(plan.recipe, d, np.complex64).__module__ == largepad.__name__
        assert _rel(plan.process(x), host_dft(x, d)) <= TOL
    assert _counts() == before


# -- convlarge (K15) ------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(8191, 16384), (12289, 32768)])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_convlarge_matches_jax_and_oracle(n, m, d, rd):
    """8191: A2 keeps every row of DFT_P in the JAX kernel; 12289 its
    sliced pkeep < P case (the port's store mask either way)."""
    split = ref_large.choose_pqq(m)
    x = _signal(2, n, seed=n)
    before = _counts()
    got = convlarge.make_bluestein_large_fn(n, m, d, np.complex64, split=split)(torch.from_numpy(x))
    assert _counts() == before
    ref = _jax_out(ref_convlarge.make_bluestein_large_fn(n, m, rd, np.complex64, interpret=True), x)
    assert _rel(got, host_dft(x, d)) <= TOL
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("n,m", [(8191, 16384), (1000003, 1 << 21)])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_convlarge_tables_bit_equal(n, m, d, rd, use_native):
    p, q1, q2 = ref_large.choose_pqq(m)
    q = q1 * q2
    host = convlarge.bconv_tables(n, m, p, q, d)
    chirp, h_fft = ref_bluestein.bluestein_tables(n, m, rd)
    assert np.array_equal(host["pre"][:n], chirp.astype(np.complex64))
    assert not host["pre"][n:].any()
    assert np.array_equal(host["chirp"], chirp.astype(np.complex64))  # the output chirp
    assert np.array_equal(host["h"], h_fft.reshape(q, p).astype(np.complex64))
    outer = ref_twiddles.twiddle_table(p, q, rd).T
    assert np.array_equal(host["col"][2], outer.astype(np.complex64))


def test_convlarge_stages_compose():
    """The three plain stages equal the plain two-pass core on the same
    Bluestein (n = 8191, m = 16384 at the port's own split)."""
    n, m = 8191, 16384
    x = torch.from_numpy(_signal(2, n, seed=3))
    for d, _ in DIRECTIONS:
        fused = convlarge.make_bluestein_large_fn(n, m, d, np.complex64)(x)
        core = conv.make_bluestein_fn(n, m, d, np.complex64)(x)
        assert _rel(fused, core.numpy()) <= TOL


def test_bconv_tiles():
    """B_conv's tiles at the two K15 inner lengths: at Q = 8192 (m = 2^21)
    and Q = 6144 (m = 1572864) the tile form (ops/kernels/convlarge.py
    tile_form: a unit of COLUMN_FORMS[Q][1] columns, csrc/convlarge.cu and
    csrc/bconv_cols.cu), where the general kernel's two buffers would hold
    one and two columns; A2 stores 16 rows."""
    for m, q, general in ((1 << 21, 8192, 1), (1572864, 6144, 2)):
        p, q1, q2 = large.choose_pqq(m)
        assert (p, q1 * q2) == (256, q)
        assert convlarge.bconv_tile(q, p) == conv_radix.row_tile(q, p) == general
        assert convlarge.tile_form(p, q)
        assert convlarge.COLUMN_FORMS[q][1] == (1 if q == 8192 else 2)
        assert convlarge.out_tile(p, q) == 16
    assert convlarge.bconv_tile(8192, 3) == conv_radix.row_tile(8192, 3) == 1


def test_bluestein_branch_takes_k15():
    fn = executor.build(recipes.Bluesteins(1000003, recipes.Dft(1 << 21)),
                        FftDirection.FORWARD, np.complex64)
    assert fn.__module__ == convlarge.__name__
    assert convlarge.bconv_supported(1 << 21, np.complex64)
    assert convlarge.bconv_supported(1572864, np.complex64)
    # inners on another route keep their cores: 7919 (m = 16384, two_stage)
    # on the two-pass core, 1234 (m = 3072) on the one-pass core
    assert not convlarge.bconv_supported(16384, np.complex64)
    fn = executor.build(recipes.Bluesteins(7919, recipes.Dft(16384)), FftDirection.FORWARD,
                        np.complex64)
    assert fn.__module__ == conv_radix.__name__
    assert not convlarge.bconv_supported(1 << 21, np.complex128)  # c128: the recipe tree
    old = config.kernels
    try:
        config.kernels = "off"
        assert not convlarge.bconv_supported(1 << 21, np.complex64)
    finally:
        config.kernels = old


def test_746497_keeps_rader():
    """The JAX package's third prime rule (a Bluestein whose inner a kernel
    route serves, because n-1 = 746496 routes to large_pad) would take
    Bluesteins(746497, 1572864) on K15; on the card it ran slower than the
    reference rule's Rader on the two-pass core, which the port keeps."""
    from rustfft_tpu_torch.planner import routed_bluestein_inner

    assert routed_bluestein_inner(746497, np.complex64) == 1572864
    assert routed_bluestein_inner(1000003, np.complex64) == 1 << 21
    assert route(746496, np.complex64) == "large_pad"
    recipe = FftPlanner(np.complex64, device="cpu").design_fft_for_len(746497)
    assert isinstance(recipe, recipes.Raders) and recipe.inner.length == 746496
    fn = executor.build(recipes.Bluesteins(746497, recipes.Dft(1572864)), FftDirection.FORWARD,
                        np.complex64)
    assert fn.__module__ == convlarge.__name__


def test_planner_sends_1000003_to_k15():
    planner = FftPlanner(np.complex64, device="cpu")
    recipe = planner.design_fft_for_len(1000003)
    assert isinstance(recipe, recipes.Bluesteins) and recipe.inner.length == 1 << 21
    assert executor.build(recipe, FftDirection.INVERSE, np.complex64).__module__ == convlarge.__name__


# -- on the card -----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 17, 127, 251, 1009])
@pytest.mark.parametrize("variant", ["block", "gauss"])
def test_dense_fft_matches_plain_on_card(cuda_device, n, variant):
    x = torch.from_numpy(_signal(300, n, seed=n)).to(cuda_device)
    for d, _ in DIRECTIONS:
        tables = tuple(None if t is None else torch.from_numpy(t).to(cuda_device)
                       for t in dense.dense_tables(n, d, variant))
        before = dense.dense_fft.launches
        got = dense.dense_fft(x, tables, variant)
        torch.cuda.synchronize()
        assert dense.dense_fft.launches == before + 1
        assert _rel(got.cpu(), dense.dense_fft_plain(x, tables, variant).cpu()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [15625, 78125, 531441])
def test_largepad_stages_match_plain_on_card(cuda_device, n):
    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    x = torch.from_numpy(_signal(3, n, seed=n)).to(cuda_device)
    for d, _ in DIRECTIONS:
        r, t, outer = largepad.col_tables(p, q, d)
        col = ([torch.from_numpy(a).to(cuda_device) for a in r],
               [torch.from_numpy(a).to(cuda_device) for a in t], torch.from_numpy(outer).to(cuda_device))
        row = tuple([torch.from_numpy(a).to(cuda_device) for a in tabs]
                    for tabs in largepad.row_tables(q, d))
        a = largepad.largepad_col_stage(x, p, q, col)
        torch.cuda.synchronize()
        assert _rel(a.cpu(), largepad.largepad_col_stage_plain(x, p, q, col).cpu()) <= TOL
        y = largepad.largepad_row_stage(a, q, p, row)
        torch.cuda.synchronize()
        assert _rel(y.cpu(), largepad.largepad_row_stage_plain(a, q, p, row).cpu()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(8191, 16384), (1000003, 1 << 21), (746497, 1572864)])
def test_bconv_stages_match_plain_on_card(cuda_device, n, m):
    p, q1, q2 = large.choose_pqq(m)
    q = q1 * q2
    x = torch.from_numpy(_signal(2, n, seed=n)).to(cuda_device)
    for d, _ in DIRECTIONS:
        host = convlarge.bconv_tables(n, m, p, q, d)
        col = ([torch.from_numpy(a).to(cuda_device) for a in host["col"][0]],
               [torch.from_numpy(a).to(cuda_device) for a in host["col"][1]],
               torch.from_numpy(host["col"][2]).to(cuda_device))
        row = tuple([torch.from_numpy(a).to(cuda_device) for a in tabs] for tabs in host["row"])
        pre, h, chirp = (torch.from_numpy(host[k]).to(cuda_device) for k in ("pre", "h", "chirp"))
        a, _ = conv_radix.conv_col_stage(x, p, q, col, pre=pre)
        b = convlarge.bconv_row_stage(a, q, p, row, h, col[2])
        torch.cuda.synchronize()
        assert _rel(b.cpu(), convlarge.bconv_row_stage_plain(a, q, p, row, h, col[2]).cpu()) <= TOL
        out = convlarge.bconv_out_stage(b, p, q, col[:2], chirp, n)
        torch.cuda.synchronize()
        assert _rel(out.cpu(), convlarge.bconv_out_stage_plain(b, p, q, col[:2], chirp, n).cpu()) <= TOL
        assert _rel(out.cpu(), host_dft(x.cpu().numpy(), d)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,rises", [
    (127, {"dense_chain_fft": 1}), (251, {"dense_chain_fft": 1}),
    (15625, {"largepad_col_stage": 1, "largepad_row_stage": 1}),
    (78125, {"largepad_col_stage": 1, "largepad_row_stage": 1}),
    (1000003, {"bconv_col_tile": 1, "bconv_row_tile": 1, "bconv_out_tile": 1}),
])
def test_tiers_through_the_planner_on_card(cuda_device, n, rises):
    counters = {"dense_fft": dense.dense_fft, "dense_chain_fft": dense.dense_chain_fft,
                "bconv_col_tile": convlarge.bconv_col_tile,
                "bconv_row_tile": convlarge.bconv_row_tile,
                "bconv_out_tile": convlarge.bconv_out_tile,
                "largepad_col_stage": largepad.largepad_col_stage,
                "largepad_row_stage": largepad.largepad_row_stage,
                "bconv_row_stage": convlarge.bconv_row_stage,
                "bconv_out_stage": convlarge.bconv_out_stage,
                "conv_col_stage": conv_radix.conv_col_stage,
                "conv_row_stage": conv_radix.conv_row_stage,
                "large_col_stage": large.large_col_stage, "large_row_stage": large.large_row_stage}
    planner = FftPlanner(np.complex64, device="cuda")
    x = _signal(2, n, seed=n)
    for d, _ in DIRECTIONS:
        plan = planner.plan_fft_forward(n) if d is FftDirection.FORWARD else planner.plan_fft_inverse(n)
        before = {k: c.launches for k, c in counters.items()}
        got = plan.process(torch.from_numpy(x).to(cuda_device))
        torch.cuda.synchronize()
        assert {k: c.launches - before[k] for k, c in counters.items()} == \
            {k: rises.get(k, 0) for k in counters}
        assert _rel(got.cpu(), host_dft(x, d)) <= TOL
