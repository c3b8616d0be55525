"""K14's Gauss form on the cluster passes, held on the CPU.

Under config.conv_radix_gauss the two-pass core at m = r*16384 (r = 1, 2,
4, 8, 16) keeps its two cluster passes on csrc/radix.cuh's body, in the
body's Gauss form: DFT_128's radix 16 and radix 8 in stages A and B as
gauss_column on the DFT_16 and DFT_8 tables, compile-time constants in
csrc/gauss16.cuh.  Here: that header against large.gauss_header() and its
DFT_8 constants against large.gauss_tables((8,), d) bit for bit, both
directions, with and without the native host tables; the Gauss DFT_8 of
those constants against np.fft in float64; the plain Gauss radix FFT
(fused.radix_fft_plain on cluster_tables(r, d, gauss=True)) against
numpy's float64 FFT at every r, relative mean error <= 1e-5 (the f32
Gauss chain's own error is a few 1e-7); the cluster rule under the
switches; and the four primes whose core takes the cluster passes (7919,
65537, 65521, 131071) through FftPlanner(device="cpu") under the switch:
one pass 1 and one pass 2 in the Gauss form a call, within 1e-5 of the
float64 oracle and of the JAX FftPlanner (Pallas off on the CPU) on the
same input, both directions.  Inputs are made with numpy from a seed.  On
the CPU each wrapper runs its plain version and launches nothing; the
card tests are in tests/test_torch_card_gauss_cluster.py.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu import config as ref_config
from rustfft_tpu_torch import FftPlanner, config
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import conv_radix, fused, large
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, False), (FftDirection.INVERSE, True)]
DIR_IDS = ["fwd", "inv"]
TOL = 1e-5

HEADER = Path(large.__file__).resolve().parents[2] / "csrc" / "gauss16.cuh"

#: the primes whose two-pass core runs the cluster passes: the Rader 65537
#: (m = 65536, r = 4) and the Bluesteins 7919 (m = 16384, r = 1), 65521
#: (131072, r = 8) and 131071 (262144, r = 16) -> r
CLUSTER_PRIMES = {7919: 1, 65537: 4, 65521: 8, 131071: 16}


def _signal(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n))
            + 1j * rng.standard_normal((batch, n))).astype(np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _tensors(tables):
    return tuple([torch.from_numpy(a) for a in t] if isinstance(t, list) else torch.from_numpy(t)
                 for t in tables)


def _header_constants(r: int, inverse: bool) -> np.ndarray:
    """(3, r) float32 {Wr, Wi, Ws} of Gauss<r><inverse> as the header spells
    them."""
    body = HEADER.read_text().split(f"struct Gauss{r}<{str(inverse).lower()}> {{")[1]
    cases = re.findall(r"case (\d+): return make_float4\(([^,]+)f, ([^,]+)f, ([^,]+)f, 0\.f\);",
                       body.split("};")[0])
    assert [int(c[0]) for c in cases] == list(range(r))
    return np.array([[np.float32(v) for v in c[1:]] for c in cases], dtype=np.float32).T


@pytest.fixture(params=[True, False], ids=["native", "python"])
def use_native(request):
    old_port, old_ref = config.use_native, ref_config.use_native
    config.use_native = ref_config.use_native = request.param
    try:
        yield request.param
    finally:
        config.use_native, ref_config.use_native = old_port, old_ref


@pytest.fixture
def gauss_switch():
    old = (config.conv_radix_gauss, config.rader_in_shift)
    config.conv_radix_gauss, config.rader_in_shift = True, False
    try:
        yield
    finally:
        config.conv_radix_gauss, config.rader_in_shift = old


def test_header_holds_dft8_beside_dft16():
    """The header is large.gauss_header()'s text, with both radices of the
    radix body's chain (16, 8)."""
    text = HEADER.read_text()
    assert text == large.gauss_header()
    assert "struct Gauss16<false>" in text and "struct Gauss8<true>" in text


@pytest.mark.parametrize("d,inverse", DIRECTIONS, ids=DIR_IDS)
def test_dft8_constants_equal_the_tables(d, inverse, use_native):
    """Gauss8<inverse> holds gauss_tables((8,), d) bit for bit (the signs
    of zeros too), whichever host builds the tables."""
    (g,) = large.gauss_tables((8,), d)
    assert g.dtype == np.float32 and g.shape == (3, 8)
    assert np.array_equal(_header_constants(8, inverse).view(np.uint32), g.view(np.uint32))


@pytest.mark.parametrize("d,inverse", DIRECTIONS, ids=DIR_IDS)
def test_dft8_constants_give_dft8(d, inverse):
    """gauss_column's sums on the header's DFT_8 constants are DFT_8 (f64
    sums, relative mean error <= 1e-6: the tables are f32), and the sign of
    Wi(1) in the DFT_16 table the caller passes names the direction, as the
    radix body reads it."""
    wr, wi, ws = _header_constants(8, inverse).astype(np.float64)
    x = _signal(8, 8, seed=8 + inverse).astype(np.complex128)
    e = np.outer(np.arange(8), np.arange(8)) % 8  # [j, k]
    p1 = x.real @ wr[e]
    p2 = x.imag @ wi[e]
    p3 = (x.real + x.imag) @ ws[e]
    got = (p1 - p2) + 1j * (p3 - p1 - p2)
    want = np.fft.ifft(x, axis=1) * 8 if inverse else np.fft.fft(x, axis=1)
    assert _rel(got, want) <= 1e-6
    g16, _ = conv_radix.cluster_tables(1, d, gauss=True)[6]
    assert (g16[1, 1] > 0) == inverse


@pytest.mark.parametrize("r", conv_radix.CLUSTER_RADICES)
@pytest.mark.parametrize("d,inverse", DIRECTIONS, ids=DIR_IDS)
def test_gauss_radix_fft_plain_matches_numpy(r, d, inverse):
    """The Gauss form's plain FFT_m (both DFT_128 chains through
    large.gauss_stages_plain) at m = r*16384 against numpy's f64 FFT,
    relative mean error <= 1e-5, at batch 1 and 2."""
    m = r * 16384
    tables = _tensors(conv_radix.cluster_tables(r, d, gauss=True))
    assert len(tables) == 7 and [tuple(g.shape) for g in tables[6]] == [(3, 16), (3, 8)]
    for batch in (1, 2):
        x = _signal(batch, m, seed=r * 10 + batch)
        got = fused.radix_fft_plain(torch.from_numpy(x), r, fused.RADIX_PQ, tables)
        want = np.fft.ifft(x.astype(np.complex128)) * m if inverse else np.fft.fft(x)
        assert _rel(got, want) <= TOL


@pytest.mark.parametrize("r", conv_radix.CLUSTER_RADICES)
def test_cluster_form_under_the_switches(r):
    """Under gauss the core keeps the cluster passes wherever the default
    form has them; in_shift keeps the four stages in either form."""
    m = r * 16384
    assert conv_radix.cluster_form(m, gauss=True) == conv_radix.cluster_form(m) == r
    assert conv_radix.cluster_form(m, in_shift=True) is None
    assert conv_radix.cluster_form(m, gauss=True, in_shift=True) is None


def test_gauss_tables_must_match_the_form():
    """A pass in the Gauss form needs the seventh table, and the default
    form refuses it."""
    r, m, d = 1, 16384, FftDirection.FORWARD
    x = torch.from_numpy(_signal(1, m, seed=1))
    h = torch.ones(m, dtype=torch.complex64)
    plain, gauss = _tensors(conv_radix.cluster_tables(r, d)), _tensors(
        conv_radix.cluster_tables(r, d, gauss=True))
    with pytest.raises(ValueError):
        conv_radix.conv_radix_pass1_gauss(x, m, plain, h)
    with pytest.raises(ValueError):
        conv_radix.conv_radix_pass1(x, m, gauss, h)
    z, _ = conv_radix.conv_radix_pass1_gauss(x, m, gauss, h)
    with pytest.raises(ValueError):
        conv_radix.conv_radix_pass2(z, m, gauss, m)
    with pytest.raises(ValueError):  # a table of the wrong radix
        conv_radix.conv_radix_pass2_gauss(z, m, (*gauss[:6], gauss[6][::-1]), m)
    want = conv_radix.conv_radix_pass2_plain(z, m, r, gauss, m)
    assert torch.equal(conv_radix.conv_radix_pass2_gauss(z, m, gauss, m), want)


@pytest.mark.parametrize("n", list(CLUSTER_PRIMES))
def test_planner_takes_the_gauss_cluster_passes(n, gauss_switch, monkeypatch):
    """Under conv_radix_gauss alone each prime's core is one pass 1 and one
    pass 2 in the Gauss form a call (no column or row stage), within 1e-5
    of the f64 oracle and of the JAX FftPlanner, both directions; no kernel
    launches on the CPU."""
    counters = (conv_radix.conv_radix_pass1, conv_radix.conv_radix_pass2,
                conv_radix.conv_radix_pass1_gauss, conv_radix.conv_radix_pass2_gauss)
    before = [c.launches for c in counters]
    calls = []
    for name in ("conv_radix_pass1", "conv_radix_pass2", "conv_col_stage", "conv_row_stage"):
        real = getattr(conv_radix, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("gauss", False)))
            return _real(*a, **kw)

        monkeypatch.setattr(conv_radix, name, spy)
    planner = FftPlanner(np.complex64, device="cpu")
    ref_planner = rustfft_tpu.FftPlanner(np.complex64)  # Pallas off on the CPU
    x = _signal(2, n, seed=n)
    for d, plan_of in ((FftDirection.FORWARD, "plan_fft_forward"),
                       (FftDirection.INVERSE, "plan_fft_inverse")):
        calls.clear()
        plan = getattr(planner, plan_of)(n)
        got = plan.process(x)
        assert calls == [("conv_radix_pass1", True), ("conv_radix_pass2", True)]
        assert got.shape == x.shape
        assert _rel(got, host_dft(x, d)) <= TOL
        assert _rel(got, np.asarray(getattr(ref_planner, plan_of)(n).process(x))) <= TOL
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("n", [65537, 7919])
def test_default_paths_keep_the_default_passes(n, monkeypatch):
    """Without the switch the same primes run the passes in the default
    form."""
    calls = []
    for name in ("conv_radix_pass1", "conv_radix_pass2"):
        real = getattr(conv_radix, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("gauss", False)))
            return _real(*a, **kw)

        monkeypatch.setattr(conv_radix, name, spy)
    x = _signal(1, n, seed=n + 1)
    got = FftPlanner(np.complex64, device="cpu").plan_fft_forward(n).process(x)
    assert calls == [("conv_radix_pass1", False), ("conv_radix_pass2", False)]
    assert _rel(got, host_dft(x, FftDirection.FORWARD)) <= TOL
