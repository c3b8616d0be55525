"""The port's kernels held against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain torch version, which is checked here
against the JAX kernel in Pallas interpret mode at identical radices / split
and against the f64 oracle.  Bars: relative mean error <= 5e-5 against the
JAX kernel (in interpret mode it runs its bf16x3s cat tier, ~5e-6 relative,
fused.py:212-227) and <= 1e-5 against the f64 oracle.  The kernels
themselves run only on the card: the tests marked `cuda` compare each one
with its plain version there and skip without a GPU.
"""
import numpy as np
import pytest
import torch

from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import lanepack as ref_lanepack
from rustfft_tpu.ops.pallas import large as ref_large
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops import calg
from rustfft_tpu_torch.ops.kernels import lanepack, large
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]

VS_JAX = 5e-5
VS_ORACLE = 1e-5


def _signal(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _tensors(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _jax_out(fn, x):
    o_r, o_i = fn((x.real.copy(), x.imag.copy()))
    return np.asarray(o_r) + 1j * np.asarray(o_i)


def _k1_cases():
    """Every n at the port's default radices and at the JAX kernel's."""
    cases = []
    for n in (1024, 3888, 4096):
        for rad in sorted({lanepack.choose_radices(n), ref_lanepack.choose_radices(n)}):
            cases.append(pytest.param(n, rad, id=f"{n}-{'x'.join(map(str, rad))}"))
    return cases


@pytest.mark.parametrize("n,radices", _k1_cases())
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_lanepack_plain_matches_jax_kernel(n, radices, d, rd):
    x = _signal(130, n, seed=n + len(radices))
    roots, tws = lanepack.chain_tables(n, radices, d)
    got = lanepack.lanepack_fft(torch.from_numpy(x), radices, (_tensors(roots), _tensors(tws)))
    ref_fn = ref_lanepack.make_lanepack_fn(n, rd, np.complex64, radices=radices, interpret=True)
    want = _jax_out(ref_fn, x)
    assert _rel(got, want) <= VS_JAX
    assert _rel(got, host_dft(x, d)) <= VS_ORACLE


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_large_plain_pipeline_matches_jax_kernels(d, rd):
    n = 32768
    split = large.choose_pqq(n)
    assert split == ref_large.choose_pqq(n)
    p, q1, q2 = split
    x = _signal(2, n, seed=7)
    q = q1 * q2
    col = large.col_tables(p, q, d)
    row = large.row_tables(q, d)
    a = large.large_col_stage(torch.from_numpy(x), p, q,
                              (_tensors(col[0]), _tensors(col[1]), torch.from_numpy(col[2])))
    got = large.large_row_stage(a, q, p, (_tensors(row[0]), _tensors(row[1])))
    ref_fn = ref_large.make_large_fft_fn(n, rd, np.complex64, split=split, interpret=True)
    want = _jax_out(ref_fn, x)
    assert _rel(got, want) <= VS_JAX
    assert _rel(got, host_dft(x, d)) <= VS_ORACLE


@pytest.mark.parametrize("n", [32768, 1 << 20])
def test_large_col_stage_matches_definition(n):
    """K2 alone: a[b, j2, k1] = w_n^(k1*j2) * sum_j1 x[b, j1, j2] w_P^(j1*k1)."""
    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    x = _signal(1, n, seed=3)
    for d, _ in DIRECTIONS:
        col = large.col_tables(p, q, d)
        got = large.large_col_stage(torch.from_numpy(x), p, q,
                                    (_tensors(col[0]), _tensors(col[1]), torch.from_numpy(col[2])))
        assert got.shape == (1, q, p)
        x3 = x.astype(np.complex128).reshape(1, p, q)
        dft_p = host_dft(x3.transpose(0, 2, 1), d)  # (1, Q, P) [j2, k1]
        sign = -1.0 if d is FftDirection.FORWARD else 1.0
        k1 = np.arange(p)[None, :]
        j2 = np.arange(q)[:, None]
        want = dft_p * np.exp(sign * 2j * np.pi * ((k1 * j2) % n) / n)
        assert _rel(got, want) <= VS_ORACLE


def test_large_row_stage_natural_order():
    """K3 alone: a length-Q FFT down each column of (B, Q, P), written as
    X[k2*P + k1]."""
    q, p = 128, 12
    a = _signal(2, q * p, seed=5).reshape(2, q, p)
    for d, _ in DIRECTIONS:
        row = large.row_tables(q, d)
        got = large.large_row_stage(torch.from_numpy(a), q, p,
                                    (_tensors(row[0]), _tensors(row[1])))
        want = host_dft(a.transpose(0, 2, 1), d).transpose(0, 2, 1).reshape(2, -1)
        assert _rel(got, want) <= VS_ORACLE


@pytest.mark.parametrize("n", [12, 96, 1000, 3888, 4096, 7776])
def test_lanepack_fn_matches_oracle(n):
    """make_lanepack_fn on the default radices, odd batches, any batch shape."""
    x = _signal(6, n, seed=n).reshape(2, 3, n)
    for d, _ in DIRECTIONS:
        got = lanepack.make_lanepack_fn(n, d, np.complex64)(torch.from_numpy(x))
        assert got.shape == (2, 3, n)
        assert _rel(got, host_dft(x, d)) <= VS_ORACLE


@pytest.mark.parametrize("n", [512, 1024, 4096])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_lanepack_flat_matches_jax_flat_and_oracle(n, d, rd):
    """variant="flat" at the JAX package's flat test sizes and batch
    (tests/test_pallas.py test_lanepack_flat_matches_oracle), where the JAX
    kernel packs 65536 / n transforms a row: the port's alias gives the
    block function's output bit for bit, within the bar of the JAX flat
    kernel in interpret mode."""
    assert ref_lanepack.flat_pack(n) == 65536 // n
    x = _signal((2 * 65536) // n + 3, n, seed=5 + n)
    got = lanepack.make_lanepack_fn(n, d, np.complex64, variant="flat")(torch.from_numpy(x))
    assert torch.equal(got, lanepack.make_lanepack_fn(n, d, np.complex64, variant="block")(
        torch.from_numpy(x)))
    ref_fn = ref_lanepack.make_lanepack_fn(n, rd, np.complex64, interpret=True, variant="flat")
    assert _rel(got, _jax_out(ref_fn, x)) <= VS_JAX
    assert _rel(got, host_dft(x, d)) <= VS_ORACLE


def test_lanepack_flat_pack_rules():
    """Where the JAX flat_pack is None its flat variant falls back to block
    (test_lanepack_flat_pack_rules); the port's "flat" at such an n is the
    same function, within the bar of the JAX kernel."""
    assert [ref_lanepack.flat_pack(n) for n in (3888, 720, 65536)] == [None] * 3
    fn = lanepack.make_lanepack_fn(3888, FftDirection.FORWARD, np.complex64, variant="flat")
    x = _signal(130, 3888, seed=7)
    ref_fn = ref_lanepack.make_lanepack_fn(3888, RefDirection.FORWARD, np.complex64,
                                           interpret=True, variant="flat")
    got = fn(torch.from_numpy(x))
    assert _rel(got, _jax_out(ref_fn, x)) <= VS_JAX
    assert _rel(got, host_dft(x, FftDirection.FORWARD)) <= VS_ORACLE


@pytest.mark.parametrize("n,radices", [(3888, (16, 243)), (4096, (16, 16, 16)), (1024, None),
                                       (720, None), (243, None)])
def test_lanepack_fn_radices_match_jax_and_oracle(n, radices):
    """make_lanepack_fn(radices=) at the JAX package's cases
    (tests/test_pallas.py test_lanepack_matches_oracle), both directions."""
    x = _signal(130, n, seed=5 + n)
    for d, rd in DIRECTIONS:
        fn = lanepack.make_lanepack_fn(n, d, np.complex64, radices=radices)
        assert fn.radices == tuple(radices or lanepack.choose_radices(n))
        got = fn(torch.from_numpy(x))
        ref_fn = ref_lanepack.make_lanepack_fn(n, rd, np.complex64, radices=radices, interpret=True)
        assert _rel(got, _jax_out(ref_fn, x)) <= VS_JAX
        assert _rel(got, host_dft(x, d)) <= VS_ORACLE


def test_lanepack_fn_rejects_what_the_kernel_cannot_run():
    for radices in ((16, 16), (512, 8), (4096,), (1, 4096), (2, 2, 2, 2, 256), (2, 2, 1024)):
        with pytest.raises(ValueError):
            lanepack.make_lanepack_fn(4096, FftDirection.FORWARD, np.complex64, radices=radices)
    with pytest.raises(ValueError):
        lanepack.make_lanepack_fn(4096, FftDirection.FORWARD, np.complex64, variant="wide")
    with pytest.raises(ValueError):
        lanepack.make_lanepack_fn(4096, FftDirection.FORWARD, np.complex128, radices=(16, 256))


def test_choose_radices_rules():
    assert lanepack.choose_radices(4096) == (16, 16, 16)
    assert lanepack.tile_radices(4096) == (16, 16, 16)
    assert lanepack.tile_radices(3) is None  # no 2-stage split
    assert lanepack.choose_radices(3) == (3,)  # the chain kernel runs one stage
    assert lanepack.choose_radices(1009) is None  # prime > 256
    for n in (4, 12, 96, 1000, 3888, 4096, 7776, 65536):
        rad = lanepack.choose_radices(n)
        assert int(np.prod(rad)) == n and 1 <= len(rad) <= lanepack.MAX_STAGES
        assert max(rad) <= lanepack.MAX_STAGE
        tile = lanepack.tile_radices(n)
        assert int(np.prod(tile)) == n and 2 <= len(tile) <= 3
    assert large.stage_radices(256) == (16, 16)
    assert large.stage_radices(4096) == (16, 16, 16)
    assert large.stage_radices(509) == (509,)  # prime P: one dense stage
    assert large.stage_radices(16) == (16,)


def test_route_bounds_follow_shared_memory():
    # two (n,) complex64 buffers of one transform fit 227 KB up to ~14.5k
    assert lanepack.lanepack_supported(8192, np.complex64)
    assert not lanepack.lanepack_supported(16384, np.complex64)
    assert not lanepack.lanepack_supported(4096, np.complex128)
    assert large.large_supported(16384, np.complex64)
    assert large.choose_pqq(1 << 22) == (512, 64, 128)
    assert large.choose_pqq(1 << 24) is None


def _k1_args(n=64, radices=(8, 8)):
    roots, tws = lanepack.stage_tables(n, radices, FftDirection.FORWARD)
    return torch.from_numpy(_signal(3, n, 1)), radices, (_tensors(roots), _tensors(tws))


def test_wrappers_reject_bad_operands():
    x, rad, tb = _k1_args()
    with pytest.raises(TypeError):
        lanepack.lanepack_fft(x.to(torch.complex128), rad, tb)
    with pytest.raises(ValueError):
        lanepack.lanepack_fft(x[:, :32], rad, tb)
    with pytest.raises(ValueError):
        lanepack.lanepack_fft(x.t().contiguous().t(), rad, tb)  # non-contiguous
    with pytest.raises(ValueError):
        lanepack.lanepack_fft(x, (4, 8), tb)  # radices do not split n
    with pytest.raises(ValueError):
        lanepack.lanepack_fft(x.reshape(3, 8, 8), rad, tb)
    with pytest.raises(ValueError):
        lanepack.lanepack_fft(x.to("meta"), rad, ([t.to("meta") for t in tb[0]],
                                                  [t.to("meta") for t in tb[1]]))
    p, q1, q2 = 8, 4, 4
    col = large.col_tables(p, q1 * q2, FftDirection.FORWARD)
    colt = (_tensors(col[0]), _tensors(col[1]), torch.from_numpy(col[2]))
    xl = torch.from_numpy(_signal(2, p * q1 * q2, 2))
    with pytest.raises(ValueError):
        large.large_col_stage(xl, p, q1 * q2, (colt[0], colt[1], colt[2].t()))
    a = large.large_col_stage(xl, p, q1 * q2, colt)
    row = large.row_tables(q1 * q2, FftDirection.FORWARD)
    with pytest.raises(ValueError):
        large.large_row_stage(a.reshape(2, -1), q1 * q2, p, (_tensors(row[0]), _tensors(row[1])))
    with pytest.raises(ValueError):
        large.large_row_stage(a, q1 * q2, p, (_tensors(row[0]), [torch.zeros(3, dtype=torch.complex64)]))


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    def counts():
        return (lanepack.lanepack_chain_fft.launches, lanepack.lanepack_pipe_fft.launches,
                large.large_col_stage.launches, large.large_row_stage.launches)

    before = counts()
    x, rad, tb = _k1_args()
    got = lanepack.lanepack_fft(x, rad, tb)
    torch.testing.assert_close(got, lanepack.lanepack_fft_plain(x, rad, tb), rtol=0, atol=0)
    assert lanepack.lanepack_fft(x[:0], rad, tb).shape == (0, 64)
    after = counts()
    assert after == before


def test_pair_adapter_round_trip():
    x = _signal(2, 8, 4)
    re, im = calg.to_pair(torch.from_numpy(x))
    back = calg.from_pair(re.numpy(), im.numpy())
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,radices", [(4096, (16, 16, 16)), (4096, (256, 16)), (3888, None)])
def test_lanepack_kernel_matches_plain_on_card(cuda_device, n, radices):
    radices = radices or lanepack.choose_radices(n)
    x = torch.from_numpy(_signal(257, n, 9)).to(cuda_device)
    counter = (lanepack.lanepack_pipe_fft if radices == lanepack.PIPE_RADICES
               else lanepack.lanepack_chain_fft)
    for d, _ in DIRECTIONS:
        roots, tws = lanepack.chain_tables(n, radices, d)
        tb = (_tensors(roots, cuda_device), _tensors(tws, cuda_device))
        before = counter.launches
        got = lanepack.lanepack_fft(x, radices, tb)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        want = lanepack.lanepack_fft_plain(x, radices, tb)
        assert _rel(got.cpu(), want.cpu()) <= VS_ORACLE


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(32768, 3), (1 << 20, 2)])
def test_large_kernels_match_plain_on_card(cuda_device, n, batch):
    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    x = torch.from_numpy(_signal(batch, n, 10)).to(cuda_device)
    for d, _ in DIRECTIONS:
        c = large.col_tables(p, q, d)
        col = (_tensors(c[0], cuda_device), _tensors(c[1], cuda_device),
               torch.from_numpy(c[2]).to(cuda_device))
        r = large.row_tables(q, d)
        row = (_tensors(r[0], cuda_device), _tensors(r[1], cuda_device))
        a = large.large_col_stage(x, p, q, col)
        y = large.large_row_stage(a, q, p, row)
        torch.cuda.synchronize()
        assert _rel(a.cpu(), large.large_col_stage_plain(x, p, q, col).cpu()) <= VS_ORACLE
        assert _rel(y.cpu(), large.large_row_stage_plain(a, q, p, row).cpu()) <= VS_ORACLE
