"""The top power-of-two band (2^23 .. 2^26) held against the JAX package.

The port's large2f (K10) and large3 / large3f (K11) pipelines at the
scaled-down splits tests/test_pallas.py runs in Pallas interpret mode, both
directions, against the JAX pipelines there and the f64 oracle: relative
mean error <= 1e-5 against either (the JAX kernels' bf16x3 tier in
interpret mode is ~4.3e-6 from the oracle here).  On the CPU each wrapper
runs its plain torch version; the tests marked `cuda` hold each kernel
against its plain version on the card and skip without a GPU.
"""
import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import large2f as ref_large2f
from rustfft_tpu.ops.pallas import large3 as ref_large3
from rustfft_tpu_torch import FftPlanner, executor, route
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import large, large2f, large3
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
SPLITS = [(8, 2, 4, 4, 16), (8, 4, 4, 4, 16), (8, 8, 4, 4, 16)]
TOL = 1e-5


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


def _on(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _counts():
    return (large2f.large2f_col_stage.launches, large3.large3_col_stage.launches,
            large3.large3_p2.launches, large.large_col_stage.launches,
            large.large_row_stage.launches)


# -- the pipelines against the JAX package and the oracle ---------------------

@pytest.mark.parametrize("split", SPLITS, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_large2f_matches_jax_and_oracle(split, d, rd):
    n = split[0] * split[1] * split[4]
    x = _signal(3, n, seed=n + split[1])
    got = large2f.make_large2f_fft_fn(n, d, np.complex64, split=split)(torch.from_numpy(x))
    ref = ref_large2f.make_large2f_fft_fn(n, rd, np.complex64, split=split, interpret=True,
                                          pt=8, qt3=16)
    assert _rel(got, _jax_out(ref, x)) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


@pytest.mark.parametrize("factored", [True, False], ids=["large3f", "large3"])
@pytest.mark.parametrize("split", SPLITS, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_large3_matches_jax_and_oracle(factored, split, d, rd):
    n = split[0] * split[1] * split[4]
    x = _signal(2, n, seed=n + 3 * split[1])
    got = large3.make_large3_fft_fn(n, d, np.complex64, split=split,
                                    factored=factored)(torch.from_numpy(x))
    ref = ref_large3.make_large3_fft_fn(n, rd, np.complex64, split=split, interpret=True,
                                        pt=8, qt=16, factored=factored)
    assert _rel(got, _jax_out(ref, x)) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


@pytest.mark.parametrize("p2", [2, 4, 8, 16, 32, 64])
def test_p2_chain_plain_is_the_dft(p2):
    """The plain P2 chain (fused._vpu_fft_list's recursion, twiddles from the
    roots table) is the DFT over the list, natural order in and out."""
    x = _signal(p2, 24, seed=p2)
    for d, _ in DIRECTIONS:
        roots = torch.from_numpy(large3.p2_tables(8, p2, 16, d, False)[0])
        got = torch.stack(large3.p2_chain_plain(list(torch.from_numpy(x).unbind(0)), roots))
        assert _rel(got, host_dft(x.T, d).T) <= TOL


def test_stages_match_definitions():
    """Each plain stage against its formula in f64 (split (8, 4, 4, 4, 16))."""
    p1, p2, q = 8, 4, 16
    p, n = p1 * p2, p1 * p2 * q
    x = _signal(2, n, seed=11)
    for d, _ in DIRECTIONS:
        sign = -1.0 if d is FftDirection.FORWARD else 1.0
        w = lambda e, m: np.exp(sign * 2j * np.pi * (e % m) / m)  # noqa: E731
        # large2f's column stage: a[j3, K] = w_n^(K*j3) * DFT_P over J
        r, t, wob, wm = large2f.col_tables(p1, p2, q, d)
        a = large2f.large2f_col_stage(torch.from_numpy(x), p1, p2, q, (_on(r), _on(t), *_on([wob, wm])))
        dft = host_dft(x.reshape(2, p, q).transpose(0, 2, 1), d)  # (2, Q, P) [j3, K]
        want = dft * w(np.arange(q)[:, None] * np.arange(p)[None, :], n)
        assert a.shape == (2, q, p) and _rel(a, want) <= TOL
        # large3f's pass 1: a[jr, k1] = w_n^(k1*(jr mod Q)) * DFT_P1 over j1
        m = p2 * q
        r, t, wob = large3.col_tables(p1, m, q, d)
        a1 = large3.large3_col_stage(torch.from_numpy(x), p1, m, q, (_on(r), _on(t), _on([wob])[0]))
        dft = host_dft(x.reshape(2, p1, m).transpose(0, 2, 1), d)  # (2, M, P1)
        want = dft * w((np.arange(m)[:, None] % q) * np.arange(p1)[None, :], n)
        assert a1.shape == (2, m, p1) and _rel(a1, want) <= TOL
        # pass 2: b[j3, k2, k1] = w_M^(k2*j3) * DFT_P2 over j2 of wos[j2, k1] * a1
        for factored in (True, False):
            roots, wos, wmid = large3.p2_tables(p1, p2, q, d, factored)
            tabs = (torch.from_numpy(roots), None if wos is None else torch.from_numpy(wos),
                    torch.from_numpy(wmid))
            b = large3.large3_p2(a1, p1, p2, q, tabs)
            v = a1.numpy().astype(np.complex128).reshape(2, p2, q, p1)
            if factored:
                v = v * w(np.arange(p2)[:, None] * np.arange(p1)[None, :], p1 * p2)[:, None, :]
            want = host_dft(v.transpose(0, 2, 3, 1), d)  # (2, Q, P1, P2) [j3, k1, k2]
            want = want * w(np.arange(q)[:, None] * np.arange(p2)[None, :], m)[:, None, :]
            assert b.shape == (2, q, p) and _rel(b, want.transpose(0, 1, 3, 2).reshape(2, q, p)) <= TOL


# -- host tables and split rules ----------------------------------------------

def test_host_tables_bit_equal_to_jax():
    for q, p1, p2 in ((16, 8, 4), (4096, 128, 32), (4096, 256, 64)):
        n = p1 * p2 * q
        for d, rd in DIRECTIONS:
            np.testing.assert_array_equal(large2f.outer_table(q, p1, n, d),
                                          ref_large2f.outer_table(q, p1, n, rd))
            _, _, wob, wm = large2f.col_tables(p1, p2, q, d)
            np.testing.assert_array_equal(
                wob, ref_large2f.outer_table(q, p1, n, rd).astype(np.complex64))
            ref_wm = rustfft_tpu.twiddles.twiddle_table(q, p2, rd)  # large2f's (Q, P2)
            np.testing.assert_array_equal(wm, ref_wm.astype(np.complex64))
            roots, wos, wm3 = large3.p2_tables(p1, p2, q, d, True)
            np.testing.assert_array_equal(
                wos, rustfft_tpu.twiddles.twiddle_table(p2, p1, rd).astype(np.complex64))
            # large3's mid table is (P2, Q); the port keeps its transpose
            np.testing.assert_array_equal(
                wm3, rustfft_tpu.twiddles.twiddle_table(p2, q, rd).T.astype(np.complex64))
            np.testing.assert_array_equal(
                roots, rustfft_tpu.twiddles.dft_matrix(p2, rd)[1].astype(np.complex64))
            _, _, wob3 = large3.col_tables(p1, p2 * q, q, d)
            np.testing.assert_array_equal(wob3, wob)


@pytest.mark.parametrize("log2n", range(21, 29))
def test_split_choosers_equal_jax(log2n):
    n = 1 << log2n
    assert large2f.choose_split2f(n) == ref_large2f.choose_split2f(n)
    assert large3.choose_split3(n) == ref_large3.choose_split3(n)
    assert large3.choose_split3f(n) == ref_large3.choose_split3f(n)
    assert (large2f.large2f_supported(n, np.complex64)
            == ref_large2f.large2f_supported(n, np.complex64))
    assert large3.large3f_supported(n, np.complex64) == ref_large3.large3f_supported(n, np.complex64)


def test_split_differences_from_jax():
    # the port's pass 2 takes P2 = 128 (units of 32 k1, DFT_128 as 16 x 8),
    # so 2^27 has the JAX split
    assert ref_large3.choose_split3f(1 << 27) == (256, 128, 64, 64, 4096)
    assert large3.choose_split3f(1 << 27) == (256, 128, 64, 64, 4096)
    assert large2f.choose_split2f(1 << 22) == (128, 8, 64, 64, 4096)
    assert large3.choose_split3f(1 << 26) == (256, 64, 64, 64, 4096)
    assert not large3.large3f_supported(1 << 26, np.complex128)
    assert not large2f.large2f_supported(1 << 24, np.complex128)
    assert large.col_tile(16384, 4096) is None  # 2^26's large2f split does not fit


def test_top_band_routes():
    for log2n in (23, 24, 25):
        assert route(1 << log2n, np.complex64) == "large2f"
    assert route(1 << 26, np.complex64) == "large3f"
    assert route(1 << 20, np.complex64) == "large"
    assert route(1 << 21, np.complex64) == "large"
    # both two-pass routes serve 2^22; only large2f's row stage is the
    # compile-time Q = 4096 kernel (measured 3.2x faster on the H100)
    assert large.large_supported(1 << 22, np.complex64)
    assert route(1 << 22, np.complex64) == "large2f"
    assert route(1 << 27, np.complex64) == "large3f"
    assert route(1 << 24, np.complex128) is None


@pytest.mark.parametrize("log2n", [23, 24, 25, 26, 27])
def test_no_top_band_plan_holds_an_n_entry_table(log2n):
    n = 1 << log2n
    for d, _ in DIRECTIONS:
        fn = executor._kernel_fn(n, d, np.complex64)
        assert max(a.size for a in fn.tables.host) <= n // 16


# -- the wrappers --------------------------------------------------------------

def test_wrappers_reject_bad_operands():
    p1, p2, q = 8, 4, 16
    n = p1 * p2 * q
    r, t, wob, wm = large2f.col_tables(p1, p2, q, FftDirection.FORWARD)
    col = (_on(r), _on(t), *_on([wob, wm]))
    x = torch.from_numpy(_signal(2, n, 1))
    with pytest.raises(ValueError):
        large2f.large2f_col_stage(x.reshape(2, 2, -1), p1, p2, q, col)
    with pytest.raises(ValueError):
        large2f.large2f_col_stage(x, p1, p2, q, (col[0], col[1], col[3], col[2]))
    with pytest.raises(TypeError):
        large2f.large2f_col_stage(x.to(torch.complex128), p1, p2, q, col)
    m = p2 * q
    r, t, wob = large3.col_tables(p1, m, q, FftDirection.FORWARD)
    with pytest.raises(ValueError):
        large3.large3_col_stage(x, p1, m, 24, (_on(r), _on(t), _on([wob])[0]))
    a = large3.large3_col_stage(x, p1, m, q, (_on(r), _on(t), _on([wob])[0]))
    roots, wos, wmid = (torch.from_numpy(v) for v in large3.p2_tables(p1, p2, q, FftDirection.FORWARD, True))
    with pytest.raises(ValueError):
        large3.large3_p2(a.transpose(1, 2), p1, p2, q, (roots, wos, wmid))
    with pytest.raises(ValueError):
        large3.large3_p2(a, p1, p2, q, (roots, wos.t(), wmid))
    with pytest.raises(ValueError):
        large3.large3_p2(a.reshape(2, 2, p2 * q // 2, p1), p1, p2, q, (roots, wos, wmid))
    with pytest.raises(ValueError):
        large2f.make_large2f_fft_fn(n, FftDirection.FORWARD, np.complex64, split=(8, 4, 4, 4, 8))
    with pytest.raises(ValueError):  # P2 = 256 is above the JAX rule's 128
        large3.make_large3_fft_fn(1 << 28, FftDirection.FORWARD, np.complex64, factored=True)
    fn = large3.make_large3_fft_fn(1 << 27, FftDirection.FORWARD, np.complex64, factored=True)
    assert max(a.size for a in fn.tables.host) == 4096 * 256  # wob, (Q, P1)


def test_cpu_wrappers_count_no_launches():
    before = _counts()
    for sp in SPLITS[:1]:
        n = sp[0] * sp[1] * sp[4]
        x = torch.from_numpy(_signal(2, n, 2))
        large2f.make_large2f_fft_fn(n, FftDirection.FORWARD, np.complex64, split=sp)(x)
        large3.make_large3_fft_fn(n, FftDirection.FORWARD, np.complex64, split=sp, factored=True)(x)
    assert _counts() == before


def test_full_size_2_23_through_the_planner():
    """2^23 x 1 through FftPlanner(np.complex64, device="cpu"): the large2f
    route's plain versions against np.fft, forward and inverse."""
    n = 1 << 23
    planner = FftPlanner(np.complex64, device="cpu")
    x = _signal(1, n, seed=23)
    before = _counts()
    y = planner.plan_fft_forward(n).process(x)
    assert y.dtype == np.complex64 and y.shape == x.shape
    assert _rel(y, np.fft.fft(x.astype(np.complex128))) <= TOL
    z = planner.plan_fft_inverse(n).process(y)
    assert _rel(z / n, x) <= TOL
    assert _counts() == before


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("log2n", [21, 22, 23, 24, 25])
def test_large2f_col_stage_on_card(cuda_device, log2n):
    """Every compile-time column tile (P = 1024 .. 8192) and the general
    kernel (2^21: P = 1024 over Q = 2048 takes the compile-time tile too)."""
    n = 1 << log2n
    p1, p2, _, _, q = large2f.choose_split2f(n)
    x = torch.from_numpy(_signal(1, n, log2n)).to(cuda_device)
    for d, _ in DIRECTIONS:
        r, t, wob, wm = large2f.col_tables(p1, p2, q, d)
        col = (_on(r, cuda_device), _on(t, cuda_device), *_on([wob, wm], cuda_device))
        before = large2f.large2f_col_stage.launches
        got = large2f.large2f_col_stage(x, p1, p2, q, col)
        torch.cuda.synchronize()
        assert large2f.large2f_col_stage.launches == before + 1
        assert _rel(got.cpu(), large2f.large2f_col_stage_plain(x, p1, p2, q, col).cpu()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("split", [(256, 64, 64, 64, 4096), (8, 8, 4, 4, 16), (128, 2, 4, 8, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_large3_kernels_on_card(cuda_device, split):
    p1, p2, _, _, q = split
    m = p2 * q
    n = p1 * m
    x = torch.from_numpy(_signal(1, n, p2)).to(cuda_device)
    for d, _ in DIRECTIONS:
        r, t, wob = large3.col_tables(p1, m, q, d)
        col = (_on(r, cuda_device), _on(t, cuda_device), _on([wob], cuda_device)[0])
        a = large3.large3_col_stage(x, p1, m, q, col)
        torch.cuda.synchronize()
        assert _rel(a.cpu(), large3.large3_col_stage_plain(x, p1, m, q, col).cpu()) <= TOL
        for factored in (True, False):
            roots, wos, wmid = large3.p2_tables(p1, p2, q, d, factored)
            tabs = (torch.from_numpy(roots).to(cuda_device),
                    None if wos is None else torch.from_numpy(wos).to(cuda_device),
                    torch.from_numpy(wmid).to(cuda_device))
            b = large3.large3_p2(a, p1, p2, q, tabs)
            torch.cuda.synchronize()
            assert _rel(b.cpu(), large3.large3_p2_plain(a, p1, p2, q, tabs).cpu()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("log2n,batch", [(23, 1), (26, 1)])
def test_top_band_path_on_card(cuda_device, log2n, batch):
    n = 1 << log2n
    planner = FftPlanner(np.complex64, device="cuda")
    x = _signal(batch, n, seed=log2n)
    for d, _ in DIRECTIONS:
        plan = planner.plan_fft_forward(n) if d is FftDirection.FORWARD else planner.plan_fft_inverse(n)
        before = _counts()
        got = plan.process(torch.from_numpy(x).to(cuda_device))
        torch.cuda.synchronize()
        rise = tuple(a - b for a, b in zip(_counts(), before))
        assert rise == ((1, 0, 0, 0, 1) if log2n < 26 else (0, 1, 1, 0, 1))
        assert _rel(got.cpu(), host_dft(x, d)) <= TOL
