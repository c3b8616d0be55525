"""Host layer of the torch port held against the JAX package.

The port (rustfft_tpu_torch) must design the same recipe as the reference
planners for the same n, build bit-equal f64/f32 host tables, keep its
native plancore path equal to its Python path, and never import jax.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rustfft_tpu
import rustfft_tpu_torch
from rustfft_tpu import config as ref_config
from rustfft_tpu import twiddles as ref_twiddles
from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import lanepack as ref_lanepack
from rustfft_tpu_torch import config, math_utils, native, recipes, twiddles
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import lanepack, large

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the size ladder of tests/test_planner.py
LADDER = sorted(
    {1 << p for p in range(6, 32)}
    | {
        2**a * 3**b * 5**c * 7**d
        for a in range(2, 5) for b in range(2, 5)
        for c in range(2, 5) for d in range(2, 5)
    }
    | {59, 83, 107, 149, 167, 173, 179, 359, 719, 1439, 2879}
    | {53, 61, 67, 71, 97, 101, 127, 131, 137, 139, 151, 181, 199}
    | {12 * 3, 6 * 27, 15, 21, 35, 143, 22, 1234, 3 * 2**9, 3 * 2**10,
       2**3 * 3**3 * 5, 3**7, 13 * 64, 3888, 7776, 44100, 65537, 746497}
)

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]


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
    """The port's recipes with its kernels off: the JAX package's with Pallas off."""
    old = config.kernels
    config.kernels = "off"
    try:
        yield
    finally:
        config.kernels = old


@pytest.fixture(params=[True, False], ids=["native", "python"])
def use_native(request):
    old_port, old_ref = config.use_native, ref_config.use_native
    config.use_native = ref_config.use_native = request.param
    try:
        yield request.param
    finally:
        config.use_native, ref_config.use_native = old_port, old_ref


def _same_recipe(port, ref):
    assert repr(port) == repr(ref)
    assert port == rustfft_tpu_torch.from_reference_recipe(ref)
    assert port.length == ref.length


@pytest.mark.parametrize("lo,hi", [(0, 500), (500, 1000), (1000, 1500), (1500, 2001)])
def test_scalar_recipes_match_reference(lo, hi, use_native):
    port = rustfft_tpu_torch.FftPlannerScalar()
    ref = rustfft_tpu.FftPlannerScalar()
    for n in range(lo, hi):
        _same_recipe(port.design_fft_for_len(n), ref.design_fft_for_len(n))


@pytest.mark.parametrize("lo,hi", [(0, 500), (500, 1000), (1000, 1500), (1500, 2001)])
def test_planner_recipes_match_reference(lo, hi, ref_pallas_off, kernels_off):
    port = rustfft_tpu_torch.FftPlanner()
    ref = rustfft_tpu.FftPlanner()
    for n in range(lo, hi):
        _same_recipe(port.design_fft_for_len(n), ref.design_fft_for_len(n))


@pytest.mark.parametrize("planner", ["scalar", "planner"])
def test_recipes_match_reference_on_ladder(planner, ref_pallas_off, kernels_off):
    if planner == "scalar":
        port, ref = rustfft_tpu_torch.FftPlannerScalar(), rustfft_tpu.FftPlannerScalar()
    else:
        port, ref = rustfft_tpu_torch.FftPlanner(), rustfft_tpu.FftPlanner()
    for n in LADDER:
        _same_recipe(port.design_fft_for_len(n), ref.design_fft_for_len(n))


@pytest.mark.parametrize("n", [1, 2, 7, 16, 31, 128, 243, 256, 257, 512])
def test_dft_matrix_bit_equal(n, use_native):
    for d, rd in DIRECTIONS:
        np.testing.assert_array_equal(twiddles.dft_matrix(n, d), ref_twiddles.dft_matrix(n, rd))


@pytest.mark.parametrize("p,q", [(2, 3), (16, 128), (31, 37), (256, 4096), (64, 64)])
def test_twiddle_table_bit_equal(p, q, use_native):
    for d, rd in DIRECTIONS:
        np.testing.assert_array_equal(
            twiddles.twiddle_table(p, q, d), ref_twiddles.twiddle_table(p, q, rd)
        )


def test_host_dft_matches_reference():
    x = np.random.default_rng(3).standard_normal((3, 40)) + 0j
    for d, rd in DIRECTIONS:
        np.testing.assert_array_equal(twiddles.host_dft(x, d), ref_twiddles.host_dft(x, rd))


@pytest.mark.parametrize(
    "n,radices",
    [(4096, (256, 16)), (4096, (16, 16, 16)), (3888, (243, 16)), (3888, (27, 24, 6)),
     (1024, (64, 16)), (1024, (16, 8, 8))],
)
def test_stage_tables_bit_equal(n, radices, use_native):
    """The kernels' DFT matrices (expanded from the roots tables) and
    inter-stage twiddles equal the JAX kernel's f32 tables bit for bit."""
    import jax

    k = len(radices)
    for d, rd in DIRECTIONS:
        roots, tws = lanepack.stage_tables(n, radices, d)
        # HIGHEST: the reference ships plain f32 K-halves [wA, 0, wB, 0] per stage
        consts = ref_lanepack._stage_consts(n, radices, rd, jax.lax.Precision.HIGHEST)
        for s, r in enumerate(radices):
            w = lanepack.dft_from_roots(torch.from_numpy(roots[s])).numpy()
            wa = consts[4 * s]  # block_mid(W)[:, :r] = [[Wr], [Wi]]
            np.testing.assert_array_equal(w.real, wa[:r])
            np.testing.assert_array_equal(w.imag, wa[r:])
        for s in range(k - 1):
            np.testing.assert_array_equal(tws[s].real, consts[4 * k + 2 * s])
            np.testing.assert_array_equal(tws[s].imag, consts[4 * k + 2 * s + 1])


@pytest.mark.parametrize("n", [32768, 1 << 20])
def test_large_tables_bit_equal(n, use_native):
    """The two-pass pipeline's outer twiddle equals the JAX pipeline's f32
    table (large.py:446-450), and the stage tables of its DFT_P and length-Q
    FFT equal the JAX lanepack tables of the same radix chain."""
    import jax

    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    for d, rd in DIRECTIONS:
        roots_p, tws_p, outer = large.col_tables(p, q, d)
        ref_outer = ref_twiddles.twiddle_table(p, q, rd).T
        np.testing.assert_array_equal(outer.real, ref_outer.real.astype(np.float32))
        np.testing.assert_array_equal(outer.imag, ref_outer.imag.astype(np.float32))
        for m, (roots, tws) in ((p, (roots_p, tws_p)), (q, large.row_tables(q, d))):
            radices = large.stage_radices(m)
            k = len(radices)
            consts = ref_lanepack._stage_consts(m, radices, rd, jax.lax.Precision.HIGHEST)
            for s, r in enumerate(radices):
                w = lanepack.dft_from_roots(torch.from_numpy(roots[s])).numpy()
                np.testing.assert_array_equal(w.real, consts[4 * s][:r])
                np.testing.assert_array_equal(w.imag, consts[4 * s][r:])
            for s in range(k - 1):
                np.testing.assert_array_equal(tws[s].real, consts[4 * k + 2 * s])
                np.testing.assert_array_equal(tws[s].imag, consts[4 * k + 2 * s + 1])


def test_split_rules_match_reference_at_slice_sizes():
    from rustfft_tpu.ops.pallas import large as ref_large

    for n in (32768, 1 << 20):
        assert large.choose_pqq(n) == ref_large.choose_pqq(n)
    assert large.choose_pqq(1 << 20) == (256, 64, 64)
    assert lanepack.choose_radices(4096) == (16, 16, 16)
    assert ref_lanepack.choose_radices(4096) == (256, 16)


# -- native plancore: parity with the port's Python paths and the reference --

pytestmark_native = pytest.mark.skipif(not native.available(), reason="native plancore not built")


@pytestmark_native
def test_native_number_theory_parity():
    for n in list(range(2000)) + [1 << 20, 65537, 746497, 2**31 - 1]:
        assert native.is_prime(n) == math_utils.is_prime(n), n
    for p in [3, 5, 7, 29, 97, 1009, 7919, 65537]:
        assert native.primitive_root(p) == math_utils.primitive_root(p), p
    for n in list(range(2, 2000)) + [1 << 20, 44100, 746496]:
        f = math_utils.PrimeFactors.compute(n)
        expected = [(2, f.power_two)] if f.power_two else []
        expected += [(3, f.power_three)] if f.power_three else []
        expected += [(x.value, x.count) for x in f.other_factors]
        assert native.factorize(n) == expected, n


@pytestmark_native
def test_native_recipe_parity():
    planner = rustfft_tpu_torch.FftPlannerScalar()
    planner._native_design = False
    for n in list(range(2, 1500)) + [4096, 65536, 1 << 20, 1009, 7919, 65537, 746497, 44100]:
        assert native.design_recipe(n) == planner.design_fft_for_len(n), n


@pytestmark_native
def test_native_tables_parity():
    old = config.use_native
    try:
        for n in (1, 2, 31, 128, 257):
            for d, _ in DIRECTIONS:
                nat = native.dft_matrix(n, d is FftDirection.INVERSE)
                config.use_native = False
                np.testing.assert_allclose(nat, twiddles.dft_matrix(n, d), rtol=0, atol=1e-14)
                config.use_native = old
        for p, q in ((2, 3), (16, 128), (31, 37)):
            for d, _ in DIRECTIONS:
                nat = native.twiddle_table(p, q, d is FftDirection.INVERSE)
                config.use_native = False
                np.testing.assert_allclose(nat, twiddles.twiddle_table(p, q, d), rtol=0, atol=1e-14)
                config.use_native = old
    finally:
        config.use_native = old


def test_native_path_is_the_checked_in_library():
    assert native._LIB_PATH == os.path.join(REPO, "native", "libplancore.so")
    assert not hasattr(native, "_try_build")


# -- the package stands alone --

def test_import_leaves_jax_out():
    code = (
        "import sys, pkgutil, importlib\n"
        "import rustfft_tpu_torch\n"
        "for m in pkgutil.walk_packages(rustfft_tpu_torch.__path__, 'rustfft_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'rustfft_tpu.')) "
        "or m == 'rustfft_tpu' or m == 'triton')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# -- carrying recipes across packages --

@pytest.mark.parametrize("n", [0, 1, 7, 64, 96, 1234, 3888, 4096, 2879, 65537, 1 << 20])
def test_from_reference_recipe_round_trip(n, ref_pallas_off):
    for ref_planner in (rustfft_tpu.FftPlannerScalar(), rustfft_tpu.FftPlanner()):
        ref = ref_planner.design_fft_for_len(n)
        port = rustfft_tpu_torch.from_reference_recipe(ref)
        assert repr(port) == repr(ref)
        # a port recipe is its own reference form too
        assert rustfft_tpu_torch.from_reference_recipe(port) == port
        assert isinstance(port, recipes.Recipe)


def test_from_reference_recipe_nested_form():
    nested = ("MixedRadix", {"left": ("Dft", {"length": 16}),
                             "right": ("RadixN", {"factors": (4, 2), "base": ("Butterfly", {"length": 8})})})
    r = rustfft_tpu_torch.from_reference_recipe(nested)
    assert r == recipes.MixedRadix(recipes.Dft(16), recipes.RadixN((4, 2), recipes.Butterfly(8)))
    assert r.length == 16 * 64
    with pytest.raises(ValueError):
        rustfft_tpu_torch.from_reference_recipe(("NoSuchRecipe", {}))
    with pytest.raises(TypeError):
        rustfft_tpu_torch.from_reference_recipe(42)


@pytest.mark.parametrize("n", [96, 1000, 4096])
def test_plans_from_one_recipe_agree(n, ref_pallas_off):
    """Both packages' plans built from one recipe give the same transform."""
    from rustfft_tpu.plan import FftPlan as RefPlan
    from rustfft_tpu_torch.plan import FftPlan

    recipe = rustfft_tpu.FftPlanner().design_fft_for_len(n)
    x = (np.random.default_rng(n).standard_normal((2, n))
         + 1j * np.random.default_rng(n + 1).standard_normal((2, n))).astype(np.complex64)
    for d, rd in DIRECTIONS:
        got = FftPlan(rustfft_tpu_torch.from_reference_recipe(recipe), d, np.complex64,
                      device="cpu").process(x)
        want = np.asarray(RefPlan(recipe, rd, np.complex64).process(x))
        err = np.mean(np.abs(got - want)) / np.mean(np.abs(want))
        assert err < 1e-5, err
