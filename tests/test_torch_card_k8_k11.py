"""K8 at every size of its domain and K11 at P2 = 128 (2^27) on the card.

Marked `cuda`: each skips without a GPU (the CUDA kernels have no CPU
mode).  Run on the card with `python -m pytest -m cuda
tests/test_torch_card_k8_k11.py`.  This file imports no JAX: the kernels
are held against their plain torch versions (relative mean error <= 1e-6:
the same function, summed in another order) and the 2^27 path against
torch.fft and the round trip (<= 1e-5).  The same functions against the
JAX package run on the CPU in tests/test_torch_three_stage.py,
tests/test_torch_top_p2_128.py and tests/test_torch_large3_tiles.py.
"""
import numpy as np
import pytest
import torch

from rustfft_tpu_torch import FftPlanner
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import fused, large, large3

DIRECTIONS = (FftDirection.FORWARD, FftDirection.INVERSE)
VS_PLAIN = 1e-6
TOL = 1e-5

#: K8's domain (tests/test_torch_three_stage.py holds it against the JAX rule)
DOMAIN = [16384 * k for k in range(1, 51)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("n", DOMAIN)
def test_three_stage_on_card(cuda_device, n):
    """three_stage_fft on its card form at n, batch 1 and 3, both
    directions, against its plain version; one launch a call."""
    p, q1, q2 = fused.choose_pqq_fused(n)
    assert fused.three_stage_form(n) is not None
    for batch in (1, 3):
        x = _signal(batch, n, n // 16384 + batch, cuda_device)
        for d in DIRECTIONS:
            tabs = _on(fused.three_stage_tables(p, q1, q2, d), cuda_device)
            before = fused.three_stage_fft.launches
            got = fused.three_stage_fft(x, p, q1, q2, tabs)
            torch.cuda.synchronize()
            assert fused.three_stage_fft.launches == before + 1
            want = fused.three_stage_fft_plain(x, p, q1, q2, tabs)
            assert _rel(got, want) <= VS_PLAIN


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16384, 32768, 393216])
def test_three_stage_plan_on_card(cuda_device, n):
    """make_fused_three_stage_fn hands three_stage_fft its tables on the
    card in three_stage_tables' groups: one launch a call, the plain
    version's output."""
    p, q1, q2 = fused.choose_pqq_fused(n)
    x = _signal(2, n, n // 16384, cuda_device)
    for d in DIRECTIONS:
        fn = fused.make_fused_three_stage_fn(n, d, np.complex64)
        before = fused.three_stage_fft.launches
        got = fn(x)
        torch.cuda.synchronize()
        assert fused.three_stage_fft.launches == before + 1
        want = fused.three_stage_fft_plain(x, p, q1, q2,
                                           _on(fused.three_stage_tables(p, q1, q2, d), cuda_device))
        assert _rel(got, want) <= VS_PLAIN


@pytest.mark.cuda
def test_three_stage_two_pass_counts_its_stages(cuda_device):
    """Above 262144 the form is K2's and K3's stages: one launch of each."""
    n = 393216
    p, q1, q2 = fused.choose_pqq_fused(n)
    assert fused.three_stage_form(n) == ("two_pass", 0)
    x = _signal(2, n, 7, cuda_device)
    tabs = _on(fused.three_stage_tables(p, q1, q2, FftDirection.FORWARD), cuda_device)
    before = (large.large_col_stage.launches, large.large_row_stage.launches)
    fused.three_stage_fft(x, p, q1, q2, tabs)
    torch.cuda.synchronize()
    assert (large.large_col_stage.launches, large.large_row_stage.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 3])
def test_large3_p2_128_on_card(cuda_device, batch):
    """large3_p2 at 2^27's split (P1 = 256, P2 = 128, Q = 4096), the j2
    factor on and off, both directions, against its plain version."""
    p1, p2, _, _, q = large3.choose_split3f(1 << 27)
    assert p2 == 128
    a = _signal(batch, p1 * p2 * q, 27 + batch, cuda_device).reshape(batch, p2 * q, p1)
    for d in DIRECTIONS:
        for factored in (True, False):
            tabs = tuple(None if v is None else torch.from_numpy(v).to(cuda_device)
                         for v in large3.p2_tables(p1, p2, q, d, factored))
            before = large3.large3_p2.launches
            got = large3.large3_p2(a, p1, p2, q, tabs)
            torch.cuda.synchronize()
            assert large3.large3_p2.launches == before + 1
            assert _rel(got, large3.large3_p2_plain(a, p1, p2, q, tabs)) <= VS_PLAIN
            del got
            torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("p1", [96, 8])
def test_large3_p2_128_narrow_chunks_on_card(cuda_device, p1):
    """P2 = 128 at P1 = 96 (a last chunk of 32 of three) and 8 (one chunk
    of 8 of 32 columns), batch 3."""
    p2, q = 128, 2048
    a = _signal(3, p1 * p2 * q, p1, cuda_device).reshape(3, p2 * q, p1)
    for factored in (True, False):
        tabs = tuple(None if v is None else torch.from_numpy(v).to(cuda_device)
                     for v in large3.p2_tables(p1, p2, q, FftDirection.INVERSE, factored))
        got = large3.large3_p2(a, p1, p2, q, tabs)
        torch.cuda.synchronize()
        assert _rel(got, large3.large3_p2_plain(a, p1, p2, q, tabs)) <= VS_PLAIN


@pytest.mark.cuda
def test_2_27_path_on_card(cuda_device):
    """FftPlanner's 2^27 x 1, forward and inverse: one launch each of K11's
    three passes, against torch.fft and the round trip."""
    n = 1 << 27
    planner = FftPlanner(np.complex64, device="cuda")
    x = _signal(1, n, 270, cuda_device)
    counters = (large3.large3_col_stage, large3.large3_p2, large.large_row_stage)
    before = [c.launches for c in counters]
    y = planner.plan_fft_forward(n).process(x)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [b + 1 for b in before]
    assert _rel(y, torch.fft.fft(x)) <= TOL
    z = planner.plan_fft_inverse(n).process(y)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [b + 2 for b in before]
    assert _rel(z, torch.fft.ifft(y) * n) <= TOL
    assert _rel(z, x * n) <= TOL
