"""K1 on K7's in-place chain and K5's chain form, held against the JAX package.

On the CPU: the chain rule (every lanepack size that is a product of at most
four register radices runs register stages only; every prime factor from
29 runs the Bluestein stage), the route counts over [2, 16384] (the
redesign moves no size), which kernel each size launches, and the plain
versions (`lanepack.chain_stages_plain`, `lanepack.bluestein_dft_plain`,
every Bluestein stage step by step) against the JAX `make_lanepack_fn` and
`make_dense_fft_fn` in Pallas interpret mode and the f64 oracle, relative
mean error <= 1e-5 (the JAX kernels run their bf16 tiers there, about
5e-6 from the oracle, so the comparison is a tolerance, never bit for
bit), and the planner against the JAX planner.  The tests marked `cuda`
hold each kernel form against its plain version on the card within 1e-6
and skip without a GPU.
"""
from collections import Counter

import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import dense as ref_dense
from rustfft_tpu.ops.pallas import lanepack as ref_lanepack
from rustfft_tpu_torch import FftPlanner, executor, route
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import dense, lanepack
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
DIR_IDS = ["fwd", "inv"]
TOL = 1e-5
#: a kernel against its plain version on the card (the same tables and
#: stages, the sums in another order; the 4096 kernel composes stage 0's
#: twiddle from two tables)
CARD_TOL = 1e-6

#: the issue's sizes: a packed small n, a register chain of four stages
#: (1000 = 8 x 5 x 5 x 5, 8192 = 16 x 16 x 16 x 2), a Bluestein stage
#: (2008 = 251 x 8), and the dense route's primes as one Bluestein stage
LANEPACK_NS = [64, 1000, 2008, 8192]
DENSE_NS = [29, 127, 251]


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


def _register_split(n, stages=4):
    """A factorization of n into at most `stages` register radices, or None."""
    if n == 1:
        return ()
    if stages == 0:
        return None
    for r in sorted(lanepack.REGISTER_RADICES, reverse=True):
        if n % r == 0:
            rest = _register_split(n // r, stages - 1)
            if rest is not None:
                return (r,) + rest
    return None


def _lanepack_sizes():
    return [n for n in range(2, 16385) if route(n, np.complex64) == "lanepack"]


def _kind(r):
    if r in lanepack.REGISTER_RADICES:
        return "register"
    return "Bluestein" if lanepack.bluestein_stage_m(r) else "direct sum"


# -- the chain rule -------------------------------------------------------------

def test_route_counts_do_not_move():
    counts = Counter(route(n, np.complex64) for n in range(2, 16385))
    assert counts == {"lanepack": 7324, "large_pad": 2515, "dense": 52, "two_stage": 16,
                      "large": 2, None: 6474}


def test_register_sizes_run_register_stages_only():
    """No lanepack size with a register chain of at most four stages has a
    direct-sum or Bluestein stage; 275 of the 379 7-smooth sizes are such."""
    sizes = _lanepack_sizes()
    smooth = [n for n in sizes if _register_split(n, 99) is not None]
    four = [n for n in smooth if _register_split(n) is not None]
    assert (len(sizes), len(smooth), len(four)) == (7324, 379, 275)
    for n in four:
        assert all(r in lanepack.REGISTER_RADICES for r in lanepack.choose_radices(n)), n
    assert lanepack.choose_radices(8192) == (16, 16, 16, 2)
    assert lanepack.choose_radices(6144) == (16, 16, 8, 3)
    assert lanepack.choose_radices(12288) == (16, 16, 16, 3)
    assert lanepack.choose_radices(1000) == (8, 5, 5, 5)
    # the other 7-smooth sizes take their cheapest chain, a stage of more
    # than a register radix among it
    for n in set(smooth) - set(four):
        assert any(r not in lanepack.REGISTER_RADICES for r in lanepack.choose_radices(n)), n


@pytest.mark.parametrize("chunk", range(4))
def test_prime_factors_from_29_run_the_bluestein_stage(chunk):
    """The stage that carries a prime factor p >= 29 is a Bluestein stage,
    and the launch arguments carry its length."""
    sizes = _lanepack_sizes()[chunk::4]
    for n in sizes:
        radices = lanepack.choose_radices(n)
        assert lanepack.chain_runs(n, radices) and max(radices) <= lanepack.MAX_STAGE
        ms = lanepack.bluestein_ms(radices, lanepack.MAX_STAGES)
        for r, m in zip(radices, ms):
            if any(r % p == 0 for p in range(29, r + 1)
                   if all(p % d for d in range(2, int(p ** 0.5) + 1))):
                assert _kind(r) == "Bluestein" and m == lanepack.bluestein_stage_m(r) <= 512
            assert (m != 0) == (_kind(r) == "Bluestein")


def test_chain_costs_price_each_stage_as_it_runs():
    """stage_cost prices a register stage below a direct sum or Bluestein
    stage that could replace it, and a pass per stage."""
    assert lanepack.radix_cost(16) == 20 and lanepack.radix_cost(5) == 40
    assert lanepack.radix_cost(11) == 132  # a direct sum, 12r
    m = lanepack.bluestein_stage_m(251)
    assert m == 512 and lanepack.radix_cost(251) == pytest.approx(
        lanepack.bluestein_ops(251, m) + 160 * m / 251)
    assert lanepack.stage_cost((16, 16, 16)) == 3 * (20 + lanepack.PASS_COST) + 12
    assert lanepack.stage_cost((2, 5)) < lanepack.stage_cost((10,))  # 10 is a direct sum
    assert lanepack.stage_cost((5, 5, 5)) < lanepack.stage_cost((125,))  # 125 is Bluestein
    # the tile rule of the convolution core and the large stages is the
    # two-buffer kernel's, unchanged
    assert lanepack.tile_radices(8192) == (32, 16, 16)
    assert lanepack.tile_radices(1000) == (25, 8, 5)


def test_chain_width_packs_small_transforms():
    assert [lanepack.chain_width(n) for n in (64, 251, 1000, 2008, 4096, 8192, 14400)] == \
        [64, 16, 4, 2, 1, 1, 1]
    for n in (64, 1000, 8192, 14400):
        radices = lanepack.choose_radices(n)
        assert lanepack.chain_smem_bytes(n, lanepack.chain_width(n), radices) <= 232448


def test_every_lanepack_size_but_4096_takes_the_chain_kernel(monkeypatch):
    """lanepack_fft sends (16, 16, 16) to the pipelined kernel and every
    other chain to the chain kernel; 4096 is the only size whose chain is
    (16, 16, 16)."""
    assert [n for n in _lanepack_sizes() if lanepack.choose_radices(n) == lanepack.PIPE_RADICES] \
        == [4096]
    calls = []
    monkeypatch.setattr(lanepack, "lanepack_pipe_fft", lambda x, t: calls.append("pipe") or x)
    monkeypatch.setattr(lanepack, "lanepack_chain_fft",
                        lambda x, r, t: calls.append(("chain", r)) or x)
    for n in (4096, 8192, 64):
        lanepack.make_lanepack_fn(n, FftDirection.FORWARD, np.complex64)(
            torch.zeros((1, n), dtype=torch.complex64))
    assert calls == ["pipe", ("chain", (16, 16, 16, 2)), ("chain", (8, 8))]


def test_dense_route_primes_from_29_take_the_chain_form(monkeypatch):
    """The dense route's primes 29..251 run dense_chain_fft, 5..23 the
    product; an explicit variant runs the product."""
    primes = [n for n in range(2, 257) if route(n, np.complex64) == "dense"]
    assert [n for n in primes if dense.chain_form(n)] == [p for p in primes if p >= 29]
    calls = []
    monkeypatch.setattr(dense, "dense_chain_fft", lambda x, t: calls.append("chain") or x)
    monkeypatch.setattr(dense, "dense_fft", lambda x, t, v: calls.append(v) or x)
    for n, variant in ((29, None), (251, None), (23, None), (5, None), (127, "block"),
                       (127, "gauss")):
        dense.make_dense_fft_fn(n, FftDirection.FORWARD, np.complex64, variant)(
            torch.zeros((1, n), dtype=torch.complex64))
    assert calls == ["chain", "chain", "block", "block", "block", "gauss"]


def test_make_lanepack_fn_takes_any_chain_it_runs():
    for radices in ((16, 16, 16), (8, 8, 8, 8), (16, 256), (2, 8, 16, 16)):
        fn = lanepack.make_lanepack_fn(4096, FftDirection.FORWARD, np.complex64, radices=radices)
        assert fn.radices == radices
    for radices in ((2, 2, 2, 512), (4, 4, 4, 4, 16), (4096,), (16, 16)):
        assert not lanepack.chain_runs(4096, radices)
        with pytest.raises(ValueError):
            lanepack.make_lanepack_fn(4096, FftDirection.FORWARD, np.complex64, radices=radices)


# -- the plain versions against the JAX kernels ----------------------------------

@pytest.mark.parametrize("n", LANEPACK_NS)
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_lanepack_plain_matches_jax_and_oracle(n, d, rd):
    x = _signal(3, n, seed=n)
    fn = lanepack.make_lanepack_fn(n, d, np.complex64)
    assert fn.radices == lanepack.choose_radices(n)
    got = fn(torch.from_numpy(x)).numpy()
    ref_fn = ref_lanepack.make_lanepack_fn(n, rd, np.complex64, interpret=True)
    assert _rel(got, host_dft(x, d)) <= TOL
    assert _rel(got, _jax_out(ref_fn, x)) <= TOL


@pytest.mark.parametrize("n", DENSE_NS)
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_dense_chain_plain_matches_jax_and_oracle(n, d, rd):
    x = _signal(5, n, seed=n)
    got = dense.make_dense_fft_fn(n, d, np.complex64)(torch.from_numpy(x)).numpy()
    ref_fn = ref_dense.make_dense_fft_fn(n, rd, np.complex64, interpret=True)
    assert _rel(got, host_dft(x, d)) <= TOL
    assert _rel(got, _jax_out(ref_fn, x)) <= TOL


@pytest.mark.parametrize("n", LANEPACK_NS + DENSE_NS)
def test_planner_matches_jax_planner(n):
    planner = FftPlanner(np.complex64, device="cpu")
    ref_planner = rustfft_tpu.FftPlanner(np.complex64)
    x = _signal(2, n, seed=n + 3)
    for plan, ref_plan, d in ((planner.plan_fft_forward(n), ref_planner.plan_fft_forward(n),
                               FftDirection.FORWARD),
                              (planner.plan_fft_inverse(n), ref_planner.plan_fft_inverse(n),
                               FftDirection.INVERSE)):
        module = executor.build(plan.recipe, d, np.complex64).__module__
        assert module == (dense.__name__ if n in DENSE_NS else lanepack.__name__)
        got = np.asarray(plan.process(x))
        assert _rel(got, host_dft(x, d)) <= TOL
        assert _rel(got, np.asarray(ref_plan.process(x))) <= TOL


# -- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(64, 300), (1000, 17), (2008, 9), (8192, 3), (4096, 301),
                                     (14400, 2)])
def test_lanepack_kernels_match_plain_on_card(cuda_device, n, batch):
    x = torch.from_numpy(_signal(batch, n, n)).to(cuda_device)
    radices = lanepack.choose_radices(n)
    counter = (lanepack.lanepack_pipe_fft if radices == lanepack.PIPE_RADICES
               else lanepack.lanepack_chain_fft)
    for d, _ in DIRECTIONS:
        roots, tws = lanepack.chain_tables(n, radices, d)
        tables = ([torch.from_numpy(a).to(cuda_device) for a in roots],
                  [torch.from_numpy(a).to(cuda_device) for a in tws])
        before = counter.launches
        got = lanepack.lanepack_fft(x, radices, tables)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert _rel(got.cpu(), lanepack.lanepack_fft_plain(x, radices, tables).cpu()) <= CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", DENSE_NS)
def test_dense_chain_matches_plain_on_card(cuda_device, n):
    x = torch.from_numpy(_signal(97, n, n)).to(cuda_device)
    for d, _ in DIRECTIONS:
        table = torch.from_numpy(dense.chain_table(n, d)).to(cuda_device)
        before = dense.dense_chain_fft.launches
        got = dense.dense_chain_fft(x, table)
        torch.cuda.synchronize()
        assert dense.dense_chain_fft.launches == before + 1
        assert _rel(got.cpu(), dense.dense_chain_fft_plain(x, table).cpu()) <= CARD_TOL
