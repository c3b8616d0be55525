"""K15's tile form and K14's cluster passes held against the plain
compositions they replace and the JAX package.

K15 (ops/kernels/convlarge.py): at m = 2^21 (1000003) the fused large
Bluestein runs three persistent tile walks on the column layout (B, P,
Q): kernel A (`bconv_col_tile`), B_conv (`bconv_row_tile`, two
in-place chains whose first leaves its output digit-reversed) and A2
(`bconv_out_tile`).  K14 (ops/kernels/conv_radix.py): at m = r*16384, r =
1, 2, 4, 8, 16, the two-pass core runs two launches of the radix body
(`conv_radix_pass1`, `conv_radix_pass2`).  On the CPU every wrapper runs
its plain version: those are held against the four-stage (K14) and
three-stage (K15) plain compositions, against the JAX kernels in Pallas
interpret mode and against the f64 oracle, all to 1e-5 relative (two f32
algorithms, and the JAX kernels' bf16x3 tier, differ by a few 1e-7 to
5e-6).  The walks' unit rules are checked to cover every unit once.  Tests
marked `cuda` hold each kernel against its plain version on the card to
1e-6 relative and skip without one.
"""
import numpy as np
import pytest
import torch

from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops import bluestein as ref_bluestein
from rustfft_tpu.ops import raders as ref_raders
from rustfft_tpu.ops.pallas import conv_radix as ref_conv_radix
from rustfft_tpu.ops.pallas import convlarge as ref_convlarge
from rustfft_tpu_torch import FftPlanner, config
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops import bluestein, raders
from rustfft_tpu_torch.ops.kernels import conv_radix, convlarge, fused, large
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
DIR_IDS = ["fwd", "inv"]
TOL = 1e-5
ON_CARD = 1e-6

N15, M15 = 1000003, 1 << 21
P15, Q15 = 256, 8192


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


def _on(t, device):
    if isinstance(t, (list, tuple)):
        return [_on(v, device) for v in t]
    return torch.from_numpy(np.ascontiguousarray(t)).to(device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _k15_tables(d, device="cpu"):
    """(col, row, pre, h, chirp) of the old form and (row, h, outer) of the
    tile form at 1000003, on `device`."""
    host = convlarge.bconv_tables(N15, M15, P15, Q15, d)
    col = (_on(host["col"][0], device), _on(host["col"][1], device),
           _on(host["col"][2], device))
    row = tuple(_on(t, device) for t in host["row"])
    pre, h, chirp = (_on(host[k], device) for k in ("pre", "h", "chirp"))
    tile_row = tuple(_on(t, device) for t in convlarge.bconv_chain_tables(d))
    tile_h = _on(convlarge.bconv_h_table(host["h"]), device)
    return col, row, pre, h, chirp, tile_row, tile_h, convlarge.to_columns(col[2])


# -- the walks ------------------------------------------------------------------

@pytest.mark.parametrize("batch,resident", [(1, 264), (1, 257), (1, 255), (64, 264), (3, 5)],
                         ids=["1-under", "1-one-under", "1-one-over", "64", "3-small-card"])
def test_bconv_walk_covers_every_unit_once(batch, resident):
    """B_conv's units (tile, row), batch rows fastest: block g of
    bconv_grid's grid runs g, g + grid, ... (csrc/convlarge.cu
    bc_offset); at 64 x 2^21 on the H100's 264 blocks (two an SM), and
    with the grid above, at and below the 256 units of one row."""
    tiles = P15
    units = batch * tiles
    grid = convlarge.bconv_grid(units, resident)
    assert grid == min(units, resident)
    seen = [convlarge.bconv_unit(u, batch) for g in range(grid) for u in range(g, units, grid)]
    assert sorted(seen) == [(t, b) for t in range(tiles) for b in range(batch)]
    # the blocks at work at one time share one or two tiles' tables
    assert len({convlarge.bconv_unit(u, batch)[0] for u in range(min(grid, units))}) <= \
        -(-min(grid, units) // batch) + 1


@pytest.mark.parametrize("batch,resident", [(1, 513), (1, 512), (1, 511), (64, 263), (64, 395)],
                         ids=["1-under", "1-equal", "1-one-over", "64-A", "64-A2"])
def test_col_and_out_walks_cover_every_unit_once(batch, resident):
    """Kernel A's and A2's units (16-column or 16-row tile, row), batch
    fastest, contiguous ranges a block (large.col_walk), at 64 x 2^21 with
    the resident blocks the H100 held of each (263 and 395) and around one
    row's 512 units."""
    units = batch * (Q15 // 16)
    grid, per = large.col_walk(units, resident)
    assert grid <= resident
    ranges = large.walk_units(grid, per, units)
    assert sorted(u for r in ranges for u in r) == list(range(units))
    assert all(len(r) for r in ranges)


# -- K15's tile form ----------------------------------------------------------------

def test_tile_form_rule_and_layout():
    assert convlarge.tile_form(P15, Q15) and convlarge.tile_form(256, 6144)
    assert not convlarge.tile_form(256, 192) and not convlarge.tile_form(243, 6144)
    p, q1, q2 = large.choose_pqq(M15)
    assert (p, q1 * q2) == (P15, Q15)
    a = torch.from_numpy(_signal(3 * Q15, P15, seed=1)).reshape(3, Q15, P15)
    cols = convlarge.to_columns(a)
    assert cols.shape == (3, P15, Q15) and cols.is_contiguous()
    assert torch.equal(cols[1, 14, 100:102], a[1, 100:102, 14])
    assert torch.equal(convlarge.from_columns(cols), a)
    pos = convlarge.bconv_positions()
    assert sorted(pos.tolist()) == list(range(Q15))
    assert pos[4096 * 1 + 256 * 3 + 16 * 5 + 7] == 1 + 2 * 3 + 32 * 5 + 512 * 7
    roots, tws = convlarge.bconv_chain_tables(FftDirection.FORWARD)
    assert [r.shape for r in roots] == [(2,), (16,)]
    assert [t.shape for t in tws] == [(2, 4096), (16, 256), (16, 16), (16, 512), (16, 32),
                                      (16, 2)]


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_tile_form_plain_equals_three_stage_plain(d, rd):
    """Each tile wrapper's plain version against the old stage's plain
    version on the same values: kernel A and A2 are the same arithmetic in
    another layout; B_conv runs the chain (2, 16, 16, 16) where the old
    body ran (32, 16, 16)."""
    col, row, pre, h, chirp, tile_row, tile_h, tile_outer = _k15_tables(d)
    x = torch.from_numpy(_signal(2, N15, seed=2))
    a_old, _ = conv_radix.conv_col_stage(x, P15, Q15, col, pre=pre)
    a = convlarge.bconv_col_tile(x, P15, Q15, col, pre)
    assert torch.equal(convlarge.from_columns(a), a_old)
    b_old = convlarge.bconv_row_stage(a_old, Q15, P15, row, h, col[2])
    b = convlarge.bconv_row_tile(a, Q15, P15, tile_row, tile_h, tile_outer)
    assert _rel(convlarge.from_columns(b), b_old) <= TOL
    out_old = convlarge.bconv_out_stage(convlarge.from_columns(b), P15, Q15, col[:2], chirp, N15)
    assert torch.equal(convlarge.bconv_out_tile(b, P15, Q15, col[:2], chirp, N15), out_old)


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_1000003_tile_form_matches_jax_and_oracle(d, rd):
    x = _signal(1, N15, seed=3)
    fn = convlarge.make_bluestein_large_fn(N15, M15, d, np.complex64)
    got = fn(torch.from_numpy(x)).numpy()
    ref = _jax_out(ref_convlarge.make_bluestein_large_fn(N15, M15, rd, np.complex64,
                                                         interpret=True), x)
    assert _rel(got, ref) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


def test_tile_wrappers_check_their_operands():
    col, row, pre, h, chirp, tile_row, tile_h, tile_outer = _k15_tables(FftDirection.FORWARD)
    x = torch.from_numpy(_signal(1, N15, seed=4))
    with pytest.raises(ValueError):
        convlarge.bconv_col_tile(x, 256, 192, col, pre)  # not the tile form
    a = convlarge.bconv_col_tile(x, P15, Q15, col, pre)
    with pytest.raises(ValueError):
        convlarge.bconv_row_tile(convlarge.from_columns(a), Q15, P15, tile_row, tile_h, tile_outer)
    with pytest.raises(ValueError):
        convlarge.bconv_row_tile(a, Q15, P15, row, tile_h, tile_outer)  # the old chain's tables
    with pytest.raises(ValueError):
        convlarge.bconv_out_tile(a, P15, Q15, col[:2], chirp, M15 + 1)


# -- K14's cluster passes ---------------------------------------------------------

def test_cluster_form_rule():
    assert conv_radix.cluster_form(65536) == 4
    assert conv_radix.cluster_form(16384) == 1
    assert [conv_radix.cluster_form(r * 16384) for r in (2, 8, 16)] == [2, 8, 16]
    assert conv_radix.cluster_form(746496) is None  # 746497's Rader
    assert conv_radix.cluster_form(114688) is None  # 7 x 16384
    assert conv_radix.cluster_form(32 * 16384) is None
    assert conv_radix.cluster_form(65536, gauss=True) is None
    assert conv_radix.cluster_form(65536, in_shift=True) is None


def _spy_passes(monkeypatch):
    calls = []
    for name in ("conv_radix_pass1", "conv_radix_pass2", "conv_col_stage", "conv_row_stage"):
        real = getattr(conv_radix, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(conv_radix, name, spy)
    return calls


@pytest.mark.parametrize("n,form", [(65537, "cluster"), (7919, "cluster"),
                                    (65521, "cluster"), (131071, "cluster"),
                                    (65537, "in_shift"), (7919, "gauss")])
def test_planner_takes_the_cluster_passes(n, form, monkeypatch):
    """65537 (Rader, m = 65536), 7919, 65521 and 131071 (Bluestein, m =
    16384, 131072 and 262144: r = 1, 8 and 16) take the two cluster passes;
    under rader_in_shift or conv_radix_gauss they keep the four launches of
    the column and row stages."""
    calls = _spy_passes(monkeypatch)
    old = (config.rader_in_shift, config.conv_radix_gauss)
    try:
        config.rader_in_shift = form == "in_shift"
        config.conv_radix_gauss = form == "gauss"
        plan = FftPlanner(np.complex64, device="cpu").plan_fft_forward(n)
        x = _signal(2, n, seed=n)
        got = plan.process(x)
    finally:
        config.rader_in_shift, config.conv_radix_gauss = old
    if form == "cluster":
        assert calls == ["conv_radix_pass1", "conv_radix_pass2"]
    else:
        assert calls.count("conv_col_stage") == 2 and calls.count("conv_row_stage") == 2
        assert "conv_radix_pass1" not in calls
    assert _rel(got, host_dft(x, FftDirection.FORWARD)) <= TOL


def _rader_host(p, d):
    perm_in, inv_gather, b_fft = raders.raders_tables(p, d)
    return conv_radix.radix_conv_tables(p - 1, d, b_fft, None, None, perm_in - 1, inv_gather)


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_cluster_passes_equal_four_stage_plain_rader(d, rd):
    """The Rader core at m = 65536 with the gather, the sums, the scatter and
    the DC-first layout: the two passes' plain versions against the four
    stages' plain versions on the same tables."""
    m = 65536
    host = _rader_host(m + 1, d)
    p, q = conv_radix.choose_split(m)
    col = (_on(host["col"][0], "cpu"), _on(host["col"][1], "cpu"), _on(host["col"][2], "cpu"))
    row = tuple(_on(t, "cpu") for t in host["row"])
    h, perm, scatter = (_on(host[k], "cpu") for k in ("h", "perm", "scatter"))
    radix = tuple(_on(t, "cpu") for t in conv_radix.cluster_tables(4, d))
    x = torch.from_numpy(_signal(2, m, seed=5))
    x0 = torch.from_numpy(_signal(1, 2, seed=6)[0])
    z, part = conv_radix.conv_radix_pass1(x, m, radix, h, perm=perm, emit_sum=True)
    got = conv_radix.conv_radix_pass2(z, m, radix, m, conj_out=True, x0=x0, scatter=scatter,
                                      partials=part)
    a, part4 = conv_radix.conv_col_stage(x, p, q, col, perm=perm, emit_sum=True)
    z4 = conv_radix.conv_row_stage(a, q, p, row, m, h=h)
    b, _ = conv_radix.conv_col_stage(z4, p, q, col)
    want = conv_radix.conv_row_stage(b, q, p, row, m, conj_out=True, x0=x0, scatter=scatter,
                                     partials=part4)
    assert got.shape == want.shape == (2, m + 1)
    assert _rel(z, z4) <= TOL
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_cluster_passes_equal_four_stage_plain_bluestein(d, rd):
    """The Bluestein core at m = 16384 (7919: the chirp, the zero padding,
    post and n_out < m): the two passes' plain versions against the four
    stages' plain versions on the same tables, and the oracle."""
    n, m = 7919, 16384
    chirp, h_fft = bluestein.bluestein_tables(n, m, d)
    host = conv_radix.radix_conv_tables(m, d, h_fft, chirp, chirp)
    p, q = conv_radix.choose_split(m)
    col = (_on(host["col"][0], "cpu"), _on(host["col"][1], "cpu"), _on(host["col"][2], "cpu"))
    row = tuple(_on(t, "cpu") for t in host["row"])
    h, pre, post = (_on(host[k], "cpu") for k in ("h", "pre", "post"))
    radix = tuple(_on(t, "cpu") for t in conv_radix.cluster_tables(1, d))
    x = torch.from_numpy(_signal(3, n, seed=11))
    z, part = conv_radix.conv_radix_pass1(x, m, radix, h, pre=pre)
    assert part is None
    got = conv_radix.conv_radix_pass2(z, m, radix, n, conj_out=True, post=post)
    a, _ = conv_radix.conv_col_stage(x, p, q, col, pre=pre)
    b, _ = conv_radix.conv_col_stage(conv_radix.conv_row_stage(a, q, p, row, m, h=h), p, q, col)
    want = conv_radix.conv_row_stage(b, q, p, row, n, conj_out=True, post=post)
    assert got.shape == want.shape == (3, n)
    assert _rel(got, want) <= TOL
    assert _rel(got, host_dft(x.numpy(), d)) <= TOL


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_cluster_core_matches_jax_and_oracle(d, rd):
    """The Bluestein core on the cluster passes at r = 2 (15625, m = 32768,
    the JAX package's hole-band recipe) against the JAX two-pass kernel in
    interpret mode and the oracle."""
    n, m = 15625, 32768
    assert conv_radix.cluster_form(m) == 2
    chirp, h_fft = bluestein.bluestein_tables(n, m, d)
    x = _signal(2, n, seed=7)
    got = conv_radix.make_radix_conv_fn(m, d, np.complex64, h=h_fft, pre=chirp, post=chirp,
                                        conj_out=True, n_in=n, n_out=n)(torch.from_numpy(x))
    ref_chirp, ref_h = ref_bluestein.bluestein_tables(n, m, rd)
    ref = ref_conv_radix.make_radix_conv_fn(m, rd, np.complex64, h=ref_h, pre=ref_chirp,
                                            post=ref_chirp, conj_out=True, n_in=n, n_out=n,
                                            interpret=True)
    assert _rel(got, _jax_out(ref, x)) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


def test_cluster_rader_matches_jax_planner():
    """65537 through the port's planner (the cluster passes, the Rader rows
    read as a view) against the JAX Rader kernel path."""
    import rustfft_tpu

    n = 65537
    x = _signal(2, n, seed=8)
    for d, plan_of in ((FftDirection.FORWARD, "plan_fft_forward"),
                       (FftDirection.INVERSE, "plan_fft_inverse")):
        got = getattr(FftPlanner(np.complex64, device="cpu"), plan_of)(n).process(x)
        ref = np.asarray(getattr(rustfft_tpu.FftPlanner(np.complex64), plan_of)(n).process(x))
        assert _rel(got, ref) <= TOL
        assert _rel(got, host_dft(x, d)) <= TOL
    perm_in, _, _ = raders.raders_tables(n, FftDirection.FORWARD)
    ref_perm, _, _ = ref_raders.raders_tables(n, RefDirection.FORWARD)
    assert np.array_equal(perm_in, ref_perm)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_partials_layout_sums_to_the_row(r):
    """Block a of a cluster sums the rows b*r*128 + a*128 + j2 of its slice:
    the (batch, r) partials add up to sum(x), zero padding included."""
    m = r * 16384
    n_in = m - 999
    x = torch.from_numpy(_signal(3, n_in, seed=r))
    tables = tuple(_on(t, "cpu") for t in conv_radix.cluster_tables(r, FftDirection.FORWARD))
    h = torch.ones(m, dtype=torch.complex64)
    _, part = conv_radix.conv_radix_pass1(x, m, tables, h, emit_sum=True)
    assert part.shape == (3, r)
    v = torch.nn.functional.pad(x, (0, m - n_in)).reshape(3, 128, r, 128)
    assert torch.equal(part, v.sum(dim=(1, 3)))
    np.testing.assert_allclose(part.sum(dim=1).numpy(), x.numpy().astype(np.complex128).sum(1),
                               rtol=1e-5, atol=1e-3)


def test_cluster_wrappers_check_their_operands():
    m = 16384
    tables = tuple(_on(t, "cpu") for t in conv_radix.cluster_tables(1, FftDirection.FORWARD))
    h = torch.ones(m, dtype=torch.complex64)
    x = torch.from_numpy(_signal(2, m, seed=9))
    with pytest.raises(ValueError):
        conv_radix.conv_radix_pass1(x, 746496, tables, h)  # no cluster form
    with pytest.raises(ValueError):
        conv_radix.conv_radix_pass1(x[:, :100], m, tables, h,
                                    perm=torch.arange(m, dtype=torch.int32))
    z, _ = conv_radix.conv_radix_pass1(x, m, tables, h)
    with pytest.raises(ValueError):
        conv_radix.conv_radix_pass2(z, m, tables, 100, scatter=torch.arange(m, dtype=torch.int32))
    with pytest.raises(ValueError):
        conv_radix.conv_radix_pass2(z, m, tables, m, partials=torch.zeros(2, 1,
                                                                          dtype=torch.complex64))


# -- on the card -----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
def test_tile_kernels_match_plain_on_card(cuda_device, batch):
    """Kernel A, B_conv and A2 of the tile form at ragged batches, on rows
    that are only 8-byte aligned (a view at an odd offset: 1000003's odd
    rows), both directions."""
    for d, _ in DIRECTIONS:
        col, row, pre, h, chirp, tile_row, tile_h, tile_outer = _k15_tables(d, cuda_device)
        buf = torch.from_numpy(_signal(1, batch * N15 + 1, seed=batch)).to(cuda_device)
        for x in (buf[0, :-1].view(batch, N15), buf[0, 1:].view(batch, N15)):
            a = convlarge.bconv_col_tile(x, P15, Q15, col, pre)
            torch.cuda.synchronize()
            assert _rel(a.cpu(), convlarge.bconv_col_tile_plain(x, P15, Q15, col, pre).cpu()) <= ON_CARD
        b = convlarge.bconv_row_tile(a, Q15, P15, tile_row, tile_h, tile_outer)
        torch.cuda.synchronize()
        want = convlarge.bconv_row_tile_plain(a, Q15, P15, tile_row, tile_h, tile_outer)
        assert _rel(b.cpu(), want.cpu()) <= ON_CARD
        out = convlarge.bconv_out_tile(b, P15, Q15, col[:2], chirp, N15)
        torch.cuda.synchronize()
        assert _rel(out.cpu(), convlarge.bconv_out_tile_plain(b, P15, Q15, col[:2], chirp,
                                                              N15).cpu()) <= ON_CARD
        assert _rel(out.cpu(), host_dft(x.cpu().numpy(), d)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 5])
def test_cluster_passes_match_plain_on_card(cuda_device, batch):
    """Both passes at m = 65536 (the Rader core: gather, sums, scatter,
    full_out, rows read as a view m + 1 apart) and m = 16384 (the Bluestein
    core: chirp, zero padding, post, n_out < m), both directions."""
    for d, _ in DIRECTIONS:
        m = 65536
        host = _rader_host(m + 1, d)
        radix = tuple(_on(t, cuda_device) for t in conv_radix.cluster_tables(4, d))
        h, perm, scatter = (_on(host[k], cuda_device) for k in ("h", "perm", "scatter"))
        raw = torch.from_numpy(_signal(batch, m + 1, seed=batch)).to(cuda_device)
        x, x0 = raw[:, 1:], raw[:, 0]
        z, part = conv_radix.conv_radix_pass1(x, m, radix, h, perm=perm, emit_sum=True)
        torch.cuda.synchronize()
        zp, partp = conv_radix.conv_radix_pass1_plain(x, m, 4, radix, h, None, perm, True)
        assert _rel(z.cpu(), zp.cpu()) <= ON_CARD
        assert _rel(part.cpu(), partp.cpu()) <= ON_CARD
        kw = dict(conj_out=True, x0=x0, scatter=scatter, partials=part)
        y = conv_radix.conv_radix_pass2(z, m, radix, m, **kw)
        torch.cuda.synchronize()
        assert _rel(y.cpu(), conv_radix.conv_radix_pass2_plain(z, m, 4, radix, m, **kw).cpu()) <= ON_CARD
        n, m = 7919, 16384
        chirp, h_fft = bluestein.bluestein_tables(n, m, d)
        host = conv_radix.radix_conv_tables(m, d, h_fft, chirp, chirp)
        radix = tuple(_on(t, cuda_device) for t in conv_radix.cluster_tables(1, d))
        h, pre, post = (_on(host[k], cuda_device) for k in ("h", "pre", "post"))
        x = torch.from_numpy(_signal(batch, n, seed=batch + 10)).to(cuda_device)
        z, _ = conv_radix.conv_radix_pass1(x, m, radix, h, pre=pre)
        torch.cuda.synchronize()
        assert _rel(z.cpu(), conv_radix.conv_radix_pass1_plain(x, m, 1, radix, h, pre)[0].cpu()) <= ON_CARD
        y = conv_radix.conv_radix_pass2(z, m, radix, n, conj_out=True, post=post)
        torch.cuda.synchronize()
        want = conv_radix.conv_radix_pass2_plain(z, m, 1, radix, n, conj_out=True, post=post)
        assert _rel(y.cpu(), want.cpu()) <= ON_CARD


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(65521, 8), (131071, 16)])
@pytest.mark.parametrize("batch", [1, 3])
def test_cluster_passes_largest_clusters_on_card(cuda_device, n, r, batch):
    """Both passes of the Bluestein core on the largest clusters: 65521 (m =
    131072, r = 8) and 131071 (m = 262144, r = 16, a non-portable cluster
    size), against their plain versions and the oracle, both directions."""
    m = r * fused.RADIX_PQ * fused.RADIX_PQ
    for d, _ in DIRECTIONS:
        chirp, h_fft = bluestein.bluestein_tables(n, m, d)
        host = conv_radix.radix_conv_tables(m, d, h_fft, chirp, chirp)
        radix = tuple(_on(t, cuda_device) for t in conv_radix.cluster_tables(r, d))
        h, pre, post = (_on(host[k], cuda_device) for k in ("h", "pre", "post"))
        x = torch.from_numpy(_signal(batch, n, seed=n + batch)).to(cuda_device)
        z, _ = conv_radix.conv_radix_pass1(x, m, radix, h, pre=pre)
        torch.cuda.synchronize()
        assert _rel(z.cpu(), conv_radix.conv_radix_pass1_plain(x, m, r, radix, h, pre)[0].cpu()) <= ON_CARD
        y = conv_radix.conv_radix_pass2(z, m, radix, n, conj_out=True, post=post)
        torch.cuda.synchronize()
        want = conv_radix.conv_radix_pass2_plain(z, m, r, radix, n, conj_out=True, post=post)
        assert _rel(y.cpu(), want.cpu()) <= ON_CARD
        assert _rel(y.cpu(), host_dft(x.cpu().numpy(), d)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,rises", [
    (1000003, {"bconv_col_tile": 1, "bconv_row_tile": 1, "bconv_out_tile": 1}),
    (65537, {"conv_radix_pass1": 1, "conv_radix_pass2": 1}),
    (7919, {"conv_radix_pass1": 1, "conv_radix_pass2": 1}),
    (65521, {"conv_radix_pass1": 1, "conv_radix_pass2": 1}),
    (131071, {"conv_radix_pass1": 1, "conv_radix_pass2": 1}),
    (746497, {"conv_col_stage": 2, "conv_row_stage": 2}),
    (24571, {"conv_col_stage": 1, "bconv_row_stage": 1, "bconv_out_stage": 1}),
])
def test_paths_launch_their_forms_on_card(cuda_device, n, rises):
    counters = {"bconv_col_tile": convlarge.bconv_col_tile,
                "bconv_row_tile": convlarge.bconv_row_tile,
                "bconv_out_tile": convlarge.bconv_out_tile,
                "bconv_row_stage": convlarge.bconv_row_stage,
                "bconv_out_stage": convlarge.bconv_out_stage,
                "conv_radix_pass1": conv_radix.conv_radix_pass1,
                "conv_radix_pass2": conv_radix.conv_radix_pass2,
                "conv_col_stage": conv_radix.conv_col_stage,
                "conv_row_stage": conv_radix.conv_row_stage}
    planner = FftPlanner(np.complex64, device="cuda")
    x = _signal(2, n, seed=n)
    for d, _ in DIRECTIONS:
        plan = planner.plan_fft_forward(n) if d is FftDirection.FORWARD else planner.plan_fft_inverse(n)
        before = {k: c.launches for k, c in counters.items()}
        got = plan.process(torch.from_numpy(x).to(cuda_device))
        torch.cuda.synchronize()
        assert {k: c.launches - before[k] for k, c in counters.items()} == \
            {k: rises.get(k, 0) for k in counters}
        assert _rel(got.cpu(), host_dft(x, d)) <= TOL
