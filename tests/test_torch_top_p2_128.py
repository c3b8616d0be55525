"""2^27 on the large3f route: K11's pass 2 at P2 = 128 held against the JAX package.

The split rule and the routes against the JAX package's at every power of
two from 2^21 to 2^28, the planner's recipe at 2^27 against the JAX TPU
planner's, the walks and tables of 2^27's three passes, and the three-pass
pipeline at scaled-down splits with P2 = 128 (units of 32 k1, DFT_128
split 16 x 8) against the f64 oracle, both directions: relative mean error
<= 1e-5.  On the CPU each wrapper runs its plain torch version; the card's
kernels are held against those in tests/test_torch_card_k8_k11.py.  The
numpy mirror of pass 2's kernel at P2 = 128, held against the JAX pipeline
in Pallas interpret mode pass by pass, is in
tests/test_torch_large3_tiles.py, beside the mirror of the other P2.
"""
import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.executor import pallas_route
from rustfft_tpu.ops.pallas import large3 as ref_large3
from rustfft_tpu_torch import FftPlanner, recipes, route
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import large, large3
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
TOL = 1e-5
N27 = 1 << 27
SPLIT27 = (256, 128, 64, 64, 4096)

#: resident blocks of an H100 (132 SMs, two of either kernel's blocks an SM)
RESIDENT = 264


def _signal(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


@pytest.mark.parametrize("log2n", range(21, 29))
def test_factored_split_and_support_equal_jax(log2n):
    n = 1 << log2n
    assert large3.choose_split3f(n) == ref_large3.choose_split3f(n)
    for dtype in (np.complex64, np.complex128):
        assert large3.large3f_supported(n, dtype) == ref_large3.large3f_supported(n, dtype)


def test_routes_at_2_27():
    assert large3.choose_split3f(N27) == SPLIT27
    assert route(N27, np.complex64) == "large3f"
    assert pallas_route(N27, np.complex64, mode="tpu") == "large3f"
    assert route(N27, np.complex128) is None
    assert route(1 << 28, np.complex64) is None  # P2 = 256 is above the rule's 128
    assert large3.MAX_P2 == 128


def test_recipe_at_2_27_equals_the_jax_tpu_planner():
    """The route changes, not the recipe: both planners design the same
    tree, which the port ran before large3f took 2^27."""
    ref = rustfft_tpu.FftPlannerTpu(np.complex64).design_fft_for_len(N27)
    port = FftPlanner(np.complex64, device="cpu").design_fft_for_len(N27)
    assert repr(port) == repr(ref)
    assert port == recipes.from_reference_recipe(ref)
    assert repr(port) == ("MixedRadix(left=MixedRadix(left=Dft(length=64), right=Dft(length=128)), "
                          "right=MixedRadix(left=Dft(length=128), right=Dft(length=128)))")


def test_walks_at_2_27():
    """2^27 x 1: pass 1 walks 128 groups of 256 tiles (32768 units of 32
    KiB, 125 a block on the H100's 264 blocks); pass 2 eight chunks of 32
    k1 a (b, j3) (32768 units of 32 KiB, a block's range within two chunks
    of wos); pass 3 K3's tile kernel at Q = 4096 over P = 32768 columns.
    Every count is far under the kernels' 0x7fffffff."""
    p1, p2, q1, q2, q = SPLIT27
    m = p2 * q
    assert large3._fits(SPLIT27)
    assert large.col_tile(p1, m) == 16 and large.row_tile(q, p1 * p2) == 4
    assert large.stage_radices(p1) == (16, 16) and large.stage_radices(q) == (16, 16, 16)
    assert large3.col_walk(1, p2, q // 16, RESIDENT) == (263, 125)
    assert large3.p2_split(p2) == (16, 8) and large3.p2_cols(p2) == 32
    assert large3.p2_chunks(p1, p2) == 8
    grid, per = large3.p2_walk(1, q, p1, p2, RESIDENT)
    assert (grid, per) == (263, 125) and per <= q  # at most two chunks a block
    assert large.row_grid(p1 * p2 // 4, RESIDENT // 2) == 132
    for batch in (1, 2, 3):
        pass1, pass2 = batch * p2 * (q // 16), batch * q * large3.p2_chunks(p1, p2)
        assert pass1 == pass2 == batch * 32768 < 0x7fffffff


def test_tables_at_2_27():
    """No table of n entries: wob (Q, P1), wos (P2, P1), wm (Q, P2)."""
    p1, p2, _, _, q = SPLIT27
    for d, _ in DIRECTIONS:
        roots, wos, wm = large3.p2_tables(p1, p2, q, d, True)
        assert roots.shape == (p2,) and wos.shape == (p2, p1) and wm.shape == (q, p2)
        fn = large3.make_large3_fft_fn(N27, d, np.complex64, factored=True)
        assert max(a.size for a in fn.tables.host) == q * p1


@pytest.mark.parametrize("split", [(8, 128, 4, 4, 16), (96, 128, 4, 4, 16)],
                         ids=["p1-8", "p1-96"])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_p2_128_pipeline_against_the_oracle(split, d, rd):
    """The three passes at P2 = 128 (P1 = 8: one chunk of 8 k1, the
    columns past it idle on the card; P1 = 96: three chunks of 32), batch
    3.  The same pipeline against the JAX one in interpret mode, pass by
    pass, is tests/test_torch_large3_tiles.py's P2 = 128 mirror test."""
    n = split[0] * split[1] * split[4]
    x = _signal(3, n, seed=split[0])
    got = large3.make_large3_fft_fn(n, d, np.complex64, split=split, factored=True)(
        torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    assert _rel(got, host_dft(x, d)) <= TOL


@pytest.mark.parametrize("p1", [64, 96, 256])
def test_p2_128_pass2_plain_against_the_oracle(p1):
    """large3_p2_plain at P2 = 128 over several chunks (P1 = 64, 96 with a
    narrower last chunk, 256 as at 2^27), the j2 factor on and off."""
    p2, q = 128, 8
    a = _signal(2, p1 * p2 * q, seed=p1).reshape(2, p2 * q, p1)
    for d, _ in DIRECTIONS:
        sign = -1.0 if d is FftDirection.FORWARD else 1.0
        for factored in (True, False):
            roots, wos, wm = large3.p2_tables(p1, p2, q, d, factored)
            got = large3.large3_p2(torch.from_numpy(a), p1, p2, q,
                                   (torch.from_numpy(roots),
                                    None if wos is None else torch.from_numpy(wos),
                                    torch.from_numpy(wm))).numpy()
            v = a.reshape(2, p2, q, p1).astype(np.complex128)
            if factored:
                e = np.arange(p2)[:, None] * np.arange(p1)[None, :]
                v = v * np.exp(sign * 2j * np.pi * e / (p1 * p2))[:, None, :]
            f = host_dft(v.transpose(0, 2, 3, 1), d)  # (B, Q, P1, P2) [j3, k1, k2]
            e = np.arange(q)[:, None, None] * np.arange(p2)[None, None, :]
            f = f * np.exp(sign * 2j * np.pi * (e % (p2 * q)) / (p2 * q))
            want = f.transpose(0, 1, 3, 2).reshape(2, q, p2 * p1)
            assert _rel(got, want) <= TOL
