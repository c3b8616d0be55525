"""K14's Gauss form on the cluster passes, on the card.

Marked `cuda`: each skips without a GPU (the CUDA kernels have no CPU
mode).  Run on the card with `python -m pytest -m cuda
tests/test_torch_card_gauss_cluster.py`.  This file imports no JAX: each
Gauss pass (`conv_radix_pass1_gauss`, `conv_radix_pass2_gauss`: the radix
body in its Gauss form) is held against its plain torch version (relative
mean error <= 1e-6: the same function, summed in another order) at r = 1,
2, 4, 8, 16, at batch 1, 3 and a batch that leaves the persistent grid of
clusters uneven, with the Rader gather, partial sums, scatter and DC-first
output (65537, r = 4) and with the Bluestein chirp (every r), both
directions, one launch of each a call, and the whole core against
torch.fft (1e-5); then the planner's paths under config.conv_radix_gauss
(the two Gauss passes, no Gauss stage) and under it with
config.rader_in_shift (the four Gauss stages).  The same functions
against the JAX package run on the CPU in tests/test_torch_gauss_cluster.py.
"""
import numpy as np
import pytest
import torch

from rustfft_tpu_torch import FftPlanner, config
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.bluestein import bluestein_tables
from rustfft_tpu_torch.ops.kernels import conv_radix, fused
from rustfft_tpu_torch.ops.raders import raders_tables

DIRECTIONS = (FftDirection.FORWARD, FftDirection.INVERSE)
VS_PLAIN = 1e-6
TOL = 1e-5

#: (n, r, core): the Bluestein core at every r (7919, 15625 and 32749 at m =
#: 16384, 32768 and 65536; 65521 and 131071 at 131072 and 262144) and the
#: Rader 65537 at r = 4
CASES = [(7919, 1, "bluestein"), (15625, 2, "bluestein"), (32749, 4, "bluestein"),
         (65537, 4, "rader"), (65521, 8, "bluestein"), (131071, 16, "bluestein")]

COUNTERS = ("conv_radix_pass1", "conv_radix_pass2", "conv_radix_pass1_gauss",
            "conv_radix_pass2_gauss", "conv_col_stage", "conv_row_stage", "conv_col_stage_gauss",
            "conv_row_stage_gauss")


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


def _on(t, device):
    if isinstance(t, (list, tuple)):
        return [_on(v, device) for v in t]
    return None if t is None else torch.from_numpy(np.ascontiguousarray(t)).to(device)


def _launches():
    return [getattr(conv_radix, name).launches for name in COUNTERS]


def _dft(x, d):
    return torch.fft.fft(x) if d is FftDirection.FORWARD else torch.fft.ifft(x) * x.shape[-1]


def _uneven_batch(r):
    """Two rounds of the resident clusters and one transform more: the last
    round has one cluster busy."""
    return 2 * fused.radix_max_active_clusters(r) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,core", CASES, ids=[f"{n}-r{r}" for n, r, _ in CASES])
@pytest.mark.parametrize("batch", ["1", "3", "uneven"])
@pytest.mark.parametrize("d", DIRECTIONS, ids=["fwd", "inv"])
def test_gauss_passes_match_plain_on_card(cuda_device, n, r, core, batch, d):
    """Pass 1 and pass 2 in the Gauss form within 1e-6 of their plain
    versions, one launch of each and none in the default form; the core
    (pass 2's output) within 1e-5 of torch.fft over the transform."""
    m = r * fused.RADIX_PQ * fused.RADIX_PQ
    assert conv_radix.cluster_form(m, gauss=True) == r
    batch = _uneven_batch(r) if batch == "uneven" else int(batch)
    radix = _on(conv_radix.cluster_tables(r, d, gauss=True), cuda_device)
    if core == "rader":
        perm_in, inv_gather, b_fft = raders_tables(n, d)
        host = conv_radix.radix_conv_tables(m, d, h=b_fft, in_perm=perm_in - 1,
                                            out_perm=inv_gather)
        raw = _signal(batch, n, batch + r, cuda_device)
        x, x0 = raw[:, 1:], raw[:, 0]  # rows read as a view, n apart
        kw1 = dict(perm=_on(host["perm"], cuda_device), emit_sum=True)
        kw2 = dict(conj_out=True, x0=x0, scatter=_on(host["scatter"], cuda_device))
        n_out = m
    else:
        chirp, h_fft = bluestein_tables(n, m, d)
        host = conv_radix.radix_conv_tables(m, d, h=h_fft, pre=chirp, post=chirp)
        raw = x = _signal(batch, n, batch + r, cuda_device)
        kw1 = dict(pre=_on(host["pre"], cuda_device))
        kw2 = dict(conj_out=True, post=_on(host["post"], cuda_device))
        n_out = n
    h = _on(host["h"], cuda_device)
    before = _launches()
    z, part = conv_radix.conv_radix_pass1_gauss(x, m, radix, h, **kw1)
    torch.cuda.synchronize()
    z_p, part_p = conv_radix.conv_radix_pass1_plain(x, m, r, radix, h, kw1.get("pre"),
                                                    kw1.get("perm"), kw1.get("emit_sum", False))
    assert _rel(z, z_p) <= VS_PLAIN
    if core == "rader":
        assert _rel(part, part_p) <= VS_PLAIN
        kw2["partials"] = part
    y = conv_radix.conv_radix_pass2_gauss(z, m, radix, n_out, **kw2)
    torch.cuda.synchronize()
    assert _rel(y, conv_radix.conv_radix_pass2_plain(z, m, r, radix, n_out, **kw2)) <= VS_PLAIN
    got = [a - b for a, b in zip(_launches(), before)]
    assert dict(zip(COUNTERS, got)) == {**dict.fromkeys(COUNTERS, 0),
                                        "conv_radix_pass1_gauss": 1, "conv_radix_pass2_gauss": 1}
    assert y.shape == raw.shape
    assert _rel(y, _dft(raw, d)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65537, 7919, 65521, 131071])
@pytest.mark.parametrize("d", DIRECTIONS, ids=["fwd", "inv"])
def test_gauss_paths_take_the_gauss_passes_on_card(cuda_device, n, d):
    """The planner under config.conv_radix_gauss: one launch of each Gauss
    pass a call and nothing else of the core, within 1e-5 of torch.fft."""
    old = config.conv_radix_gauss
    try:
        config.conv_radix_gauss = True
        planner = FftPlanner(np.complex64, device="cuda")
        plan = planner.plan_fft_forward(n) if d is FftDirection.FORWARD else \
            planner.plan_fft_inverse(n)
    finally:
        config.conv_radix_gauss = old
    x = _signal(3, n, n, cuda_device)
    before = _launches()
    y = plan.process(x)
    torch.cuda.synchronize()
    got = dict(zip(COUNTERS, (a - b for a, b in zip(_launches(), before))))
    assert got == {**dict.fromkeys(COUNTERS, 0),
                   "conv_radix_pass1_gauss": 1, "conv_radix_pass2_gauss": 1}
    assert _rel(y, _dft(x, d)) <= TOL


@pytest.mark.cuda
def test_in_shift_with_gauss_keeps_the_four_stages_on_card(cuda_device):
    """65537 under rader_in_shift and conv_radix_gauss: the four Gauss
    stages (two each), no cluster pass, within 1e-5 of torch.fft."""
    n = 65537
    old = (config.conv_radix_gauss, config.rader_in_shift)
    try:
        config.conv_radix_gauss = config.rader_in_shift = True
        plan = FftPlanner(np.complex64, device="cuda").plan_fft_forward(n)
    finally:
        config.conv_radix_gauss, config.rader_in_shift = old
    x = _signal(3, n, 1, cuda_device)
    before = _launches()
    y = plan.process(x)
    torch.cuda.synchronize()
    got = dict(zip(COUNTERS, (a - b for a, b in zip(_launches(), before))))
    assert got == {**dict.fromkeys(COUNTERS, 0),
                   "conv_col_stage_gauss": 2, "conv_row_stage_gauss": 2}
    assert _rel(y, torch.fft.fft(x)) <= TOL
