"""K4's Gauss stages on K2's and K3's tile kernels, on the card.

Marked `cuda`: each skips without a GPU (the CUDA kernels have no CPU
mode).  Run on the card with `python -m pytest -m cuda
tests/test_torch_card_gauss_tiles.py`.  This file imports no JAX: at 2^20's
split each Gauss stage is held against its plain torch version (relative
mean error <= 1e-6: the same function, summed in another order) and bit
for bit against the general Gauss body (`general=True`, which computes the
same floats in the same order), one launch a call; a misaligned view; the
2^20 path under config.large_gauss against torch.fft.  The same functions
against the JAX package run on the CPU in tests/test_torch_gauss_tiles.py.
"""
import numpy as np
import pytest
import torch

from rustfft_tpu_torch import FftPlanner, config
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import large

DIRECTIONS = (FftDirection.FORWARD, FftDirection.INVERSE)
VS_PLAIN = 1e-6
TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _signal(batch, n, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=device)


def _rel(got, want):
    got, want = got.to(torch.complex128), want.to(torch.complex128)
    return float((got - want).abs().mean() / want.abs().mean())


def _on(host, device):
    return tuple([torch.from_numpy(a).to(device) for a in t] if isinstance(t, list)
                 else torch.from_numpy(t).to(device) for t in host)


def _split():
    p, q1, q2 = large.choose_pqq(1 << 20)
    return p, q1 * q2


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("d", DIRECTIONS, ids=["fwd", "inv"])
def test_gauss_col_tile_on_card(cuda_device, batch, d):
    """large_col_stage_gauss on K2's tile kernel: within 1e-6 of its plain
    version, bit-equal to the general body, one launch a call."""
    p, q = _split()
    assert large.col_tile(p, q, gauss=True) == large.TILE_COL[1]
    col = _on(large.col_tables(p, q, d, gauss=True), cuda_device)
    x = _signal(batch, p * q, batch, cuda_device)
    before = large.large_col_stage_gauss.launches
    a = large.large_col_stage_gauss(x, p, q, col)
    assert large.large_col_stage_gauss.launches == before + 1
    general = large.large_col_stage_gauss(x, p, q, col, general=True)
    torch.cuda.synchronize()
    assert large.large_col_stage_gauss.launches == before + 2
    assert _rel(a, large.large_col_stage_gauss_plain(x, p, q, col)) <= VS_PLAIN
    assert torch.equal(a, general)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("d", DIRECTIONS, ids=["fwd", "inv"])
def test_gauss_row_tile_on_card(cuda_device, batch, d):
    """large_row_stage_gauss on K3's tile kernel: within 1e-6 of its plain
    version, bit-equal to the general body, one launch a call."""
    p, q = _split()
    assert large.row_tile(q, p, gauss=True) == large.TILE_ROW[1]
    row = _on(large.row_tables(q, d, gauss=True), cuda_device)
    a = _signal(batch, p * q, batch + 100, cuda_device).view(batch, q, p)
    before = large.large_row_stage_gauss.launches
    y = large.large_row_stage_gauss(a, q, p, row)
    assert large.large_row_stage_gauss.launches == before + 1
    general = large.large_row_stage_gauss(a, q, p, row, general=True)
    torch.cuda.synchronize()
    assert large.large_row_stage_gauss.launches == before + 2
    assert _rel(y, large.large_row_stage_gauss_plain(a, q, p, row)) <= VS_PLAIN
    assert torch.equal(y, general)


@pytest.mark.cuda
def test_gauss_tiles_on_a_misaligned_view(cuda_device):
    """A view 8 bytes into its storage is copied before the tile kernels'
    16-byte reads: the same bits as the aligned input."""
    p, q = _split()
    d = FftDirection.FORWARD
    col = _on(large.col_tables(p, q, d, gauss=True), cuda_device)
    row = _on(large.row_tables(q, d, gauss=True), cuda_device)
    x = _signal(2, p * q, 11, cuda_device)
    base = torch.zeros(2 * p * q + 1, dtype=torch.complex64, device=cuda_device)
    base[1:] = x.reshape(-1)
    a = large.large_col_stage_gauss(base[1:].view(2, p * q), p, q, col)
    assert torch.equal(a, large.large_col_stage_gauss(x, p, q, col))
    base[1:] = a.reshape(-1)
    assert torch.equal(large.large_row_stage_gauss(base[1:].view(2, q, p), q, p, row),
                       large.large_row_stage_gauss(a, q, p, row))


@pytest.mark.cuda
@pytest.mark.parametrize("d", DIRECTIONS, ids=["fwd", "inv"])
def test_large_gauss_path_on_card(cuda_device, d):
    """2^20 x 4 under config.large_gauss: one launch of each Gauss tile
    stage, none of K2 or K3, within 1e-5 of torch.fft."""
    n = 1 << 20
    old = config.large_gauss
    try:
        config.large_gauss = True
        planner = FftPlanner(np.complex64, device="cuda")
        plan = (planner.plan_fft_forward(n) if d is FftDirection.FORWARD
                else planner.plan_fft_inverse(n))
    finally:
        config.large_gauss = old
    x = _signal(4, n, 5, cuda_device)
    counters = (large.large_col_stage_gauss, large.large_row_stage_gauss,
                large.large_col_stage, large.large_row_stage)
    before = [c.launches for c in counters]
    y = plan.process(x)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0, 0]
    want = torch.fft.fft(x) if d is FftDirection.FORWARD else torch.fft.ifft(x) * n
    assert _rel(y, want) <= TOL
