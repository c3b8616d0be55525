"""K4's Gauss forms on K2's and K3's tile kernels, held on the CPU.

csrc/large_gauss.cu runs the large pipeline's Gauss column and row stages
on K2's and K3's persistent tile kernels where those take the default form
(P = 16 x 16 over 16 columns; Q = 16 x 16 x 16 over 4, P <= 32768), each
radix-16 stage's DFT_16 as gauss_column with its tables as compile-time
constants (csrc/gauss16.cuh).  Here: that header against
large.gauss_header() and its constants against large.gauss_tables((16,), d)
bit for bit, both directions, with and without the native host tables; the
Gauss DFT_16 of those constants against np.fft in float64, and the sign of
Wi(1) the kernels read the direction from; the dispatch rule over the
large route's splits; the Gauss pipeline at 2^20's split and a small one
against the JAX package's make_large_fft_fn(gauss=True) in Pallas
interpret mode at precision HIGHEST and the f64 oracle, relative mean error
<= 1e-5, inputs made with numpy from a seed.  On the CPU each wrapper runs
its plain version (general=True too) and launches nothing; the card tests
are in tests/test_torch_card_gauss_tiles.py.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rustfft_tpu import config as ref_config
from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import large as ref_large
from rustfft_tpu_torch import config
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import large
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
DIR_IDS = ["fwd", "inv"]
HIGHEST = jax.lax.Precision.HIGHEST
TOL = 1e-5

HEADER = Path(large.__file__).resolve().parents[2] / "csrc" / "gauss16.cuh"

#: (P, Q) splits: the large route's at sizes across its domain, and splits
#: off the tile chains (P = 128, Q = 2048, 16 not dividing Q, 4 not
#: dividing P, P above the row-tile kernel's 32768)
SPLITS = sorted({(s[0], s[1] * s[2]) for n in
                 [1 << k for k in range(10, 23)] + [3 << k for k in range(10, 22)]
                 + [5 << k for k in range(10, 20)] + [61440, 409600]
                 for s in [large.choose_pqq(n)] if s is not None}
                | {(256, 4096), (128, 4096), (256, 24), (256, 2048), (6, 4096), (4, 4096),
                   (32768, 4096), (65536, 4096), (256, 4104)})


def _signal(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n))
            + 1j * rng.standard_normal((batch, n))).astype(np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _jax_out(fn, x):
    o_r, o_i = fn((x.real.copy(), x.imag.copy()))
    return np.asarray(o_r) + 1j * np.asarray(o_i)


def _header_constants(inverse: bool) -> np.ndarray:
    """(3, 16) float32 {Wr, Wi, Ws} of Gauss16<inverse> as the header spells
    them."""
    text = HEADER.read_text()
    body = text.split(f"struct Gauss16<{str(inverse).lower()}> {{")[1].split("};")[0]
    cases = re.findall(r"case (\d+): return make_float4\(([^,]+)f, ([^,]+)f, ([^,]+)f, 0\.f\);",
                       body)
    assert [int(c[0]) for c in cases] == list(range(16))
    return np.array([[np.float32(v) for v in c[1:]] for c in cases], dtype=np.float32).T


@pytest.fixture(params=[True, False], ids=["native", "python"])
def use_native(request):
    old_port, old_ref = config.use_native, ref_config.use_native
    config.use_native = ref_config.use_native = request.param
    try:
        yield request.param
    finally:
        config.use_native, ref_config.use_native = old_port, old_ref


def test_header_is_written_from_the_tables():
    assert HEADER.read_text() == large.gauss_header()


@pytest.mark.parametrize("d,inverse", [(FftDirection.FORWARD, False),
                                       (FftDirection.INVERSE, True)], ids=DIR_IDS)
def test_header_constants_equal_the_tables(d, inverse, use_native):
    """Gauss16<inverse> holds gauss_tables((16,), d) bit for bit (the signs
    of zeros too), whichever host builds the tables."""
    (g,) = large.gauss_tables((16,), d)
    assert g.dtype == np.float32 and g.shape == (3, 16)
    assert np.array_equal(_header_constants(inverse).view(np.uint32), g.view(np.uint32))


@pytest.mark.parametrize("d,inverse", [(FftDirection.FORWARD, False),
                                       (FftDirection.INVERSE, True)], ids=DIR_IDS)
def test_header_constants_give_dft16(d, inverse):
    """gauss_column's sums on the header's constants are DFT_16 (f64 sums),
    and the sign of Wi(1) in the table the caller passes names the
    direction, as tile_inverse reads it."""
    wr, wi, ws = _header_constants(inverse).astype(np.float64)
    x = _signal(8, 16, seed=16 + inverse).astype(np.complex128)
    e = np.outer(np.arange(16), np.arange(16)) % 16  # [j, k]
    p1 = x.real @ wr[e]
    p2 = x.imag @ wi[e]
    p3 = (x.real + x.imag) @ ws[e]
    got = (p1 - p2) + 1j * (p3 - p1 - p2)
    want = np.fft.ifft(x, axis=1) * 16 if inverse else np.fft.fft(x, axis=1)
    assert _rel(got, want) <= 1e-6
    (g,) = large.gauss_tables((16,), d)
    assert (g[1, 1] > 0) == inverse


@pytest.mark.parametrize("p,q", SPLITS, ids=[f"{p}x{q}" for p, q in SPLITS])
def test_gauss_takes_the_tile_kernels_where_the_default_does(p, q):
    """The Gauss form runs K2's tile kernel exactly at P = 16 x 16 with 16
    dividing Q, and K3's exactly at Q = 16 x 16 x 16 with 4 dividing P and
    P <= 32768, where the default form runs them; elsewhere the general
    kernels at their own widths."""
    col_tile = (large.stage_radices(p), large.col_tile(p, q)) == large.TILE_COL
    row_tile = ((large.stage_radices(q), large.row_tile(q, p)) == large.TILE_ROW
                and p <= large.ROW_TILE_MAX_P)
    assert col_tile == (large.stage_radices(p) == (16, 16) and q % 16 == 0)
    assert row_tile == (large.stage_radices(q) == (16, 16, 16) and p % 4 == 0 and p <= 32768)
    gauss_col, gauss_row = large.col_tile(p, q, gauss=True), large.row_tile(q, p, gauss=True)
    assert ((large.stage_radices(p), gauss_col) == large.TILE_COL) == col_tile
    assert ((large.stage_radices(q), gauss_row) == large.TILE_ROW) == row_tile
    if not col_tile:
        assert gauss_col == large.general_col_tile(p, q, gauss=True)
    if not row_tile:
        assert gauss_row == large.general_row_tile(q, p, gauss=True)


def test_general_keyword_runs_the_plain_versions_on_the_cpu():
    """general=True (the card's general Gauss body at the tile shapes) is
    the plain version on a CPU tensor, with no launch."""
    p, q = 16, 16
    d = FftDirection.FORWARD
    x = torch.from_numpy(_signal(2, p * q, seed=3))
    col = tuple(t if not isinstance(t, list) else [torch.from_numpy(a) for a in t]
                for t in large.col_tables(p, q, d, gauss=True))
    col = (col[0], col[1], torch.from_numpy(col[2]))
    row = tuple([torch.from_numpy(a) for a in t] for t in large.row_tables(q, d, gauss=True))
    before = (large.large_col_stage_gauss.launches, large.large_row_stage_gauss.launches)
    a = large.large_col_stage_gauss(x, p, q, col, general=True)
    assert torch.equal(a, large.large_col_stage_gauss_plain(x, p, q, col))
    y = large.large_row_stage_gauss(a, q, p, row, general=True)
    assert torch.equal(y, large.large_row_stage_gauss_plain(a, q, p, row))
    assert (large.large_col_stage_gauss.launches,
            large.large_row_stage_gauss.launches) == before
    assert _rel(y, host_dft(x.numpy(), d)) <= TOL


@pytest.mark.parametrize("n,split", [(128, (8, 4, 4)), (1 << 20, (256, 64, 64))],
                         ids=["8x4x4", "2^20"])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_gauss_pipeline_matches_jax_and_oracle(n, split, d, rd):
    """make_large_fft_fn(gauss=True) against the JAX make_large_fft_fn(
    gauss=True) in interpret mode and the f64 oracle: at 2^20's split the
    stages the card runs on the tile kernels, one row."""
    assert large.choose_pqq(n) == split or n != 1 << 20
    x = _signal(1, n, seed=n + 5)
    fn = large.make_large_fft_fn(n, d, np.complex64, split=split, gauss=True)
    assert fn.stages == (large.large_col_stage_gauss, large.large_row_stage_gauss)
    got = fn(torch.from_numpy(x))
    ref = _jax_out(ref_large.make_large_fft_fn(n, rd, np.complex64, split=split, interpret=True,
                                               precision=HIGHEST, gauss=True), x)
    assert _rel(got, host_dft(x, d)) <= TOL
    assert _rel(got, ref) <= TOL
