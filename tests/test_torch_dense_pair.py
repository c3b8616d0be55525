"""K5's product at the route's primes 5..23 in the pair form
(csrc/dense.cu dense_pair_kernel).

On the CPU: the pair form step by step (dense.pair_dft_plain) against the
wrapper's plain version (dense_fft_plain, x @ W), the JAX
dense.make_dense_fft_fn in Pallas interpret mode and the float64 oracle at
every n the kernel serves (both directions); its constants against
twiddles.dft_matrix's entries cast to float32, and csrc/dense_pair.cuh
against dense.pair_header(), the text they are written from; the host rules
of the persistent grid: tile rows, grid, and every tile walked once,
ragged walks included.  The tests marked `cuda` hold the kernel against its
plain version (relative mean error <= 1e-6) at batches 1, 3, a ragged walk
and a view 8 bytes into its storage, and skip without a GPU.
"""
import numpy as np
import pytest
import torch

from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import dense as ref_dense
from rustfft_tpu_torch import config, route, twiddles
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import dense
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
DIR_IDS = ["fwd", "inv"]
TOL = 1e-5
#: the pair form against the f64 oracle and the product (same f32 inputs,
#: sums of at most 23 terms)
PAIR_TOL = 1e-6
#: the route's product primes, and every n the pair kernel serves
PRIMES = [5, 7, 11, 13, 17, 19, 23]
PAIR_NS = list(range(2, dense.PAIR_MAX + 1))


def _signal(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


@pytest.fixture(params=[True, False], ids=["native", "python"])
def use_native(request):
    old = config.use_native
    config.use_native = request.param
    try:
        yield request.param
    finally:
        config.use_native = old


def _jax_out(fn, x):
    o_r, o_i = fn((x.real.copy(), x.imag.copy()))
    return np.asarray(o_r) + 1j * np.asarray(o_i)


@pytest.mark.parametrize("n", PRIMES)
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_pair_form_matches_product_jax_and_oracle(n, d, rd):
    x = _signal(64, n, seed=n)
    got = dense.pair_dft_plain(torch.from_numpy(x), d).numpy()
    w, _ = dense.dense_tables(n, d, "block")
    product = dense.dense_fft_plain(torch.from_numpy(x), (torch.from_numpy(w), None), "block")
    ref = _jax_out(ref_dense.make_dense_fft_fn(n, rd, np.complex64, interpret=True,
                                               variant="block"), x)
    assert _rel(got, product.numpy()) <= PAIR_TOL
    assert _rel(got, ref) <= TOL
    assert _rel(got, host_dft(x, d)) <= PAIR_TOL


@pytest.mark.parametrize("n", [m for m in PAIR_NS if m not in PRIMES])
@pytest.mark.parametrize("d", [FftDirection.FORWARD, FftDirection.INVERSE], ids=DIR_IDS)
def test_pair_form_at_every_other_n(n, d):
    """The kernel serves the block form at every n up to 23 (even n with the
    middle term x_{n/2})."""
    x = _signal(16, n, seed=100 + n)
    assert _rel(dense.pair_dft_plain(torch.from_numpy(x), d).numpy(), host_dft(x, d)) <= PAIR_TOL


@pytest.mark.parametrize("n", PAIR_NS)
def test_pair_constants_are_dft_matrix_entries(n, use_native):
    cos, sin = dense.pair_roots(n)
    assert cos.dtype == np.float32 and sin.dtype == np.float32
    j = np.arange(n)
    m = np.outer(j, j) % n
    for d in FftDirection:
        w = twiddles.dft_matrix(n, d)
        sign = 1.0 if d is FftDirection.FORWARD else -1.0
        assert np.array_equal(cos[m], w.real.astype(np.float32))
        assert np.array_equal(sign * sin[m], (-w.imag).astype(np.float32))


def test_pair_header_is_written_from_the_constants(use_native):
    assert dense.PAIR_HEADER.read_text() == dense.pair_header()
    text = dense.pair_header()
    # every literal reads back as its float32 constant
    for n in PRIMES:
        block = text.split(f"struct PairRoots<{n}> {{")[1].split("};")[0]
        funcs = block.split("static __device__")[1:]
        for func, vals in zip(funcs, dense.pair_roots(n)):
            lits = [line.split("return ")[1].rstrip(";").rstrip("f")
                    for line in func.splitlines() if line.strip().startswith("case ")]
            assert np.array_equal(np.array(lits, dtype=np.float32), vals)


def test_pair_form_rule():
    assert all(dense.pair_form(n, "block") for n in PAIR_NS)
    assert not any(dense.pair_form(n, "gauss") for n in PAIR_NS)
    assert not dense.pair_form(29, "block") and not dense.pair_form(1, "block")
    # the route's product primes all take the pair form; the chain form
    # keeps the primes from 29
    assert [n for n in range(2, 30) if route(n, np.complex64) == "dense"] == PRIMES + [29]
    assert all(dense.pair_form(n, dense.choose_variant(n)) and not dense.chain_form(n)
               for n in PRIMES)


@pytest.mark.parametrize("n", PAIR_NS)
def test_pair_rows(n):
    rows = dense.pair_rows(n)
    assert rows % 2 == 0 and rows % dense.PAIR_THREADS == 0
    assert rows * n * 8 <= 48 * 1024 and (rows * n * 8) % 16 == 0


@pytest.mark.parametrize("n,batch,resident", [
    (23, 1, 264), (23, 3, 264), (23, 1 << 21, 264), (5, 1 << 23, 528), (23, 256 * 264 + 7, 264),
    (7, 768 * 10 + 1, 4), (13, 256, 1), (11, 5000, 3),
])
def test_pair_walk_visits_every_tile_once(n, batch, resident):
    grid = dense.pair_grid(batch, n, resident)
    rows = dense.pair_rows(n)
    tiles = -(-batch // rows)
    assert grid == min(tiles, resident)
    walks = dense.pair_walk(grid, batch, n)
    assert len(walks) == grid and all(walks)
    covered = sorted(r for walk in walks for first, count in walk
                     for r in range(first, first + count))
    assert covered == list(range(batch))
    assert all(0 < count <= rows for walk in walks for _, count in walk)
    lengths = {len(w) for w in walks}
    assert max(lengths) - min(lengths) <= 1


def test_pair_grid_rejects_empty():
    with pytest.raises(ValueError):
        dense.pair_grid(0, 23, 264)
    with pytest.raises(ValueError):
        dense.pair_grid(5, 23, 0)


def test_cpu_wrapper_runs_the_product_plain():
    x = torch.from_numpy(_signal(5, 23, seed=1))
    w, _ = dense.dense_tables(23, FftDirection.FORWARD, "block")
    before = dense.dense_fft.launches
    got = dense.dense_fft(x, (torch.from_numpy(w), None), "block")
    assert dense.dense_fft.launches == before
    assert torch.equal(got, x @ torch.from_numpy(w))


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", PAIR_NS)
def test_pair_kernel_matches_plain_on_card(cuda_device, n):
    resident = dense.resident_blocks(n)
    ragged = resident * dense.pair_rows(n) + 3
    for d, _ in DIRECTIONS:
        w, _ = dense.dense_tables(n, d, "block")
        tables = (torch.from_numpy(w).to(cuda_device), None)
        for batch in (1, 3, ragged):
            x = torch.from_numpy(_signal(batch, n, seed=n + batch)).to(cuda_device)
            before = dense.dense_fft.launches
            got = dense.dense_fft(x, tables, "block")
            torch.cuda.synchronize()
            assert dense.dense_fft.launches == before + 1
            assert _rel(got.cpu(), dense.dense_fft_plain(x, tables, "block").cpu()) <= PAIR_TOL
            assert _rel(got.cpu(), host_dft(x.cpu().numpy(), d)) <= PAIR_TOL
        store = torch.from_numpy(_signal(1, 3 * n + 1, seed=n)).to(cuda_device)
        view = store.reshape(-1)[1:].reshape(3, n)
        assert torch.equal(dense.dense_fft(view, tables, "block"),
                           dense.dense_fft(view.clone(), tables, "block"))
