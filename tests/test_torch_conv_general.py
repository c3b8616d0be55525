"""K14's four stages on K12's ragged in-place tiles and K15's tile form at
the general form's inner lengths, held against the forms they replace, the
JAX package and the f64 oracle.

K14 (ops/kernels/conv_radix.py): every inner length without the cluster
passes runs `conv_col_stage` and `conv_row_stage` on K12's kernels with
the core's source and sink (csrc/conv_pad.cu, csrc/conv_pad_row.cu):
tiles of largepad.tile(P) and largepad.tile(Q) columns whatever divides the
other axis, the last one ragged, each column tile with its own partial sum
of the raw input.  K15 (ops/kernels/convlarge.py): the tile form at P = 256
and Q in COLUMN_FORMS (144 .. 1296, 1536 .. 6144 and 12288 besides 8192,
B_conv on csrc/bconv_cols.cu and csrc/bconv_cols_small.cu; 24576 on a
cluster of two blocks, csrc/bconv_pair.cu) at convlarge.split's split.  On
the CPU every wrapper runs its plain version: those are held against the
plain compositions of the old kernels (large.py's chains, K15's general
stages), the JAX kernels in Pallas interpret mode where the JAX kernel
takes the split (above 2^20 the JAX planner's plan, which glues), and the
f64 oracle, to 1e-5 relative (two f32 algorithms differ by a few 1e-7).  Tests marked `cuda` hold each
new form against its plain version on the card to 1e-6 relative and skip
without one.
"""
import jax
import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops import bluestein as ref_bluestein
from rustfft_tpu.ops import raders as ref_raders
from rustfft_tpu.ops.pallas import conv_radix as ref_conv_radix
from rustfft_tpu.ops.pallas import convlarge as ref_convlarge
from rustfft_tpu_torch import FftPlanner, config, executor
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.plan import FftPlan
from rustfft_tpu_torch.planner import FftPlannerGpu
from rustfft_tpu_torch.ops import bluestein, raders
from rustfft_tpu_torch.ops.kernels import conv_radix, convlarge, large, largepad
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
DIR_IDS = ["fwd", "inv"]
TOL = 1e-5
ON_CARD = 1e-6

#: small four-stage inners whose tiles are ragged on both axes: the Rader
#: 17011 (m = 17010 = 243 x 70, P = (9, 9, 3), Q = (7, 5, 2)) and the
#: Bluestein 8209 (m = 17496 = 243 x 72); 15121 (m = 15120 = 252 x 60)
RADER_SMALL = (17011, 15121)
BLUE_SMALL = ((8209, 17496),)

#: the tile form's Q beside 8192, each with the smallest prime of [98000,
#: 2^20] whose Bluestein inner m = 256 Q the planner takes (1536 .. 6144),
#: the smallest prime of [8192, 2^20] on that inner (144 .. 1296), and the
#: smallest prime of (2^20, 2^22] on it (12288, 24576)
K15_NEW = {144: 17509, 192: 23333, 288: 35023, 384: 46663, 432: 52501, 576: 69991,
           768: 93319, 864: 104987, 1152: 139981, 1296: 157477,
           1536: 165901, 1728: 209959, 2048: 221197, 2304: 262147, 3072: 294919,
           4096: 393241, 6144: 524309, 12288: 1048583, 24576: 2097169}


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


def _on(t, device="cpu"):
    if isinstance(t, (list, tuple)):
        return [_on(v, device) for v in t]
    return torch.from_numpy(np.ascontiguousarray(t)).to(device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# -- K14: the ragged tiles and their partial sums ------------------------------

@pytest.mark.parametrize("p,q", [(243, 70), (256, 2916), (243, 1728), (256, 729), (252, 60)])
def test_ragged_tiles_and_partials_layout(p, q):
    """tiles(P, Q) = ceil(Q / largepad.tile(P)), the last tile as wide as
    the columns left; each partial is the sum of its tile's columns, and the
    row of partials adds up to sum(x)."""
    qt = largepad.tile(p)
    n = conv_radix.tiles(p, q)
    assert n == -(-q // qt)
    assert conv_radix.tiles(p, q, gauss=True) == q // conv_radix.col_tile(p, q, True)
    v = torch.from_numpy(_signal(2, p * q, seed=p + q))
    part = conv_radix.tile_partials(v, p, q)
    assert part.shape == (2, n)
    cols = v.reshape(2, p, q).to(torch.complex128).sum(dim=1)
    for t in range(n):
        want = cols[:, t * qt : min(q, (t + 1) * qt)].sum(dim=1)
        np.testing.assert_allclose(part[:, t].numpy(), want.numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(part.sum(dim=1).numpy(), v.numpy().astype(np.complex128).sum(1),
                               rtol=1e-5, atol=1e-2)


def test_ragged_tiles_reach_every_four_stage_inner():
    """The split rule is the parent's (choose_split on large.cuh's dividing
    tiles, so the routes and recipes do not move) and K12's kernels run both
    chains of every four-stage inner the convolution-core rules give the
    primes (FftPlannerGpu._conv_prime_recipe: the recipes the prime rule
    replaces, which chip_smoke.py builds), here those of the primes in
    [8192, 60000] and the FOUR paths."""
    assert conv_radix.choose_split(746496) == (256, 2916)
    assert conv_radix.choose_split(419904) == (243, 1728)
    assert conv_radix.choose_split(186624) == (256, 729)
    from rustfft_tpu_torch import recipes
    from rustfft_tpu_torch.planner import FftPlannerGpu

    planner = FftPlannerGpu(np.complex64)
    seen = set()
    for n in (17011, 15121, 8209, 20161, 19441, 10369, 11677, 8753, 746497, 196613, 88589):
        recipe = planner._conv_prime_recipe(n)
        assert isinstance(recipe, (recipes.Raders, recipes.Bluesteins))
        m = recipe.inner.length
        assert conv_radix.cluster_form(m) is None
        p, q = conv_radix.choose_split(m)
        assert conv_radix._ragged_ok(p, q)
        seen.add(m)
    assert len(seen) == 11


def _old_col_plain(x, p, q, tables, pre=None, perm=None):
    """The parent's column stage, plain: large.py's chain on large.col_tables."""
    v = torch.index_select(x, 1, perm) if perm is not None else x
    v = torch.nn.functional.pad(v, (0, p * q - v.shape[1]))
    if pre is not None:
        v = v * pre
    return large.large_col_stage_plain(v, p, q, tables)


def _old_row_plain(a, q, p, tables, n_out, h=None, conj_out=False, post=None, x0=None,
                   scatter=None):
    z = large.large_row_stage_plain(a, q, p, tables)
    if h is not None:
        z = torch.conj(z * h)
    if conj_out:
        z = torch.conj(z)
    if post is not None:
        z = z * post
    if x0 is not None:
        z = z + x0[:, None]
    z = z.resolve_conj()[:, :n_out]
    if scatter is not None:
        z = torch.empty_like(z).index_copy_(1, scatter.long(), z)
    return z


def _four_stage(m, d, x, host, n_out, x0=None, full_out=False, conj_out=True):
    """The four stages' wrappers (their plain versions on the CPU)."""
    p, q = conv_radix.choose_split(m)
    col = (_on(host["col"][0]), _on(host["col"][1]), _on(host["col"][2]))
    row = (_on(host["row"][0]), _on(host["row"][1]))
    t = {k: _on(host[k]) for k in ("h", "pre", "post", "perm", "scatter") if host[k] is not None}
    a, part = conv_radix.conv_col_stage(x, p, q, col, pre=t.get("pre"), perm=t.get("perm"),
                                        emit_sum=full_out)
    z = conv_radix.conv_row_stage(a, q, p, row, m, h=t["h"])
    b, _ = conv_radix.conv_col_stage(z, p, q, col)
    return conv_radix.conv_row_stage(b, q, p, row, n_out, conj_out=conj_out,
                                     post=t.get("post"), x0=x0, scatter=t.get("scatter"),
                                     partials=part if full_out else None), part


@pytest.mark.parametrize("n", RADER_SMALL)
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_four_stage_rader_plain_equals_old_plain(n, d, rd):
    """The Rader core (gather, sums, scatter, full_out) on the ragged tiles'
    plain versions against the parent's four-stage plain composition (large.py's
    chains on its own tables) and the oracle, at odd P = 243 and 252 with
    Q = 70 and 60 (ragged on both axes, a direct-sum radix 7)."""
    m = n - 1
    perm_in, inv_gather, b_fft = raders.raders_tables(n, d)
    host = conv_radix.radix_conv_tables(m, d, b_fft, None, None, perm_in - 1, inv_gather)
    raw = torch.from_numpy(_signal(3, n, seed=n))
    x, x0 = raw[:, 1:], raw[:, 0]
    got, part = _four_stage(m, d, x, host, m, x0=x0, full_out=True)
    assert got.shape == (3, n)
    p, q = conv_radix.choose_split(m)
    assert part.shape == (3, conv_radix.tiles(p, q))
    old_col = large.col_tables(p, q, d)
    old_col = (_on(old_col[0]), _on(old_col[1]), _on(old_col[2]))
    old_row = tuple(_on(t) for t in large.row_tables(q, d))
    perm, scatter, h = _on(host["perm"]), _on(host["scatter"]), _on(host["h"])
    a = _old_col_plain(x, p, q, old_col, perm=perm)
    z = _old_row_plain(a, q, p, old_row, m, h=h)
    want = _old_row_plain(_old_col_plain(z, p, q, old_col), q, p, old_row, m, conj_out=True,
                          x0=x0, scatter=scatter)
    assert _rel(got[:, 1:], want) <= TOL
    assert _rel(got[:, 0], (x0 + x.sum(dim=1)).numpy()) <= TOL
    assert _rel(got, host_dft(raw.numpy(), d)) <= TOL


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_four_stage_bluestein_plain_equals_old_plain(d, rd):
    """The Bluestein core (chirp, zero padding, post, n_out < m) at m = 17496
    = 243 x 72 against the parent's plain composition and the oracle."""
    n, m = BLUE_SMALL[0]
    chirp, h_fft = bluestein.bluestein_tables(n, m, d)
    host = conv_radix.radix_conv_tables(m, d, h_fft, chirp, chirp)
    x = torch.from_numpy(_signal(2, n, seed=n))
    got, _ = _four_stage(m, d, x, host, n)
    p, q = conv_radix.choose_split(m)
    old_col = large.col_tables(p, q, d)
    old_col = (_on(old_col[0]), _on(old_col[1]), _on(old_col[2]))
    old_row = tuple(_on(t) for t in large.row_tables(q, d))
    pre, h, post = _on(host["pre"]), _on(host["h"]), _on(host["post"])
    z = _old_row_plain(_old_col_plain(x, p, q, old_col, pre=pre), q, p, old_row, m, h=h)
    want = _old_row_plain(_old_col_plain(z, p, q, old_col), q, p, old_row, n, conj_out=True,
                          post=post)
    assert _rel(got, want) <= TOL
    assert _rel(got, host_dft(x.numpy(), d)) <= TOL


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_four_stage_bluestein_radix_27_and_odd_p(d, rd):
    """The chains with a Bluestein stage the old kernels ran as direct sums:
    746496's Q = (27, 12, 9) (the row stage of 746497), 419904's P = (9, 9,
    3) with Q = (16, 12, 9), each stage against the parent's plain stage on
    a small batch."""
    for m in (746496, 419904):
        p, q = conv_radix.choose_split(m)
        host = conv_radix.radix_conv_tables(m, d, np.ones(m))
        col = (_on(host["col"][0]), _on(host["col"][1]), _on(host["col"][2]))
        row = (_on(host["row"][0]), _on(host["row"][1]))
        old_col = tuple(_on(t) for t in large.col_tables(p, q, d))
        old_row = tuple(_on(t) for t in large.row_tables(q, d))
        x = torch.from_numpy(_signal(1, m, seed=m))
        a, _ = conv_radix.conv_col_stage(x, p, q, col)
        assert _rel(a, _old_col_plain(x, p, q, old_col)) <= TOL
        z = conv_radix.conv_row_stage(a, q, p, row, m)
        assert _rel(z, _old_row_plain(a, q, p, old_row, m)) <= TOL
        assert _rel(z, host_dft(x.numpy(), d)) <= TOL


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_four_stage_in_shift_rader_matches_jax(d, rd):
    """Under rader_in_shift the 65537 core keeps the four stages (no cluster
    passes): the port's ragged stages on the raw rows (x[:, 1:] as a view
    m + 1 apart) against the JAX two-pass kernel with in_shift in interpret
    mode, which takes this split (r = 4), and the oracle."""
    n = 65537
    x = _signal(1, n, seed=21)
    old = config.rader_in_shift
    try:
        config.rader_in_shift = True
        plan = FftPlanner(np.complex64, device="cpu")
        plan = plan.plan_fft_forward(n) if d is FftDirection.FORWARD else plan.plan_fft_inverse(n)
        got = plan.process(x)
    finally:
        config.rader_in_shift = old
    perm_in, inv_gather, b_fft = ref_raders.raders_tables(n, rd)
    ref = ref_conv_radix.make_radix_conv_fn(
        n - 1, rd, np.complex64, h=b_fft, conj_out=True, in_perm=perm_in - 1,
        out_perm=inv_gather, x0_add=True, emit_sum=True, full_out=True, in_shift=True,
        interpret=True)
    xr, xi = x.real.copy(), x.imag.copy()
    o_r, o_i = ref((xr, xi), const=(xr[:, :1], xi[:, :1]))
    assert _rel(got, np.asarray(o_r) + 1j * np.asarray(o_i)) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_four_stage_bluestein_matches_jax(d, rd):
    """The four stages' wrappers at m = 32768 = 256 x 128 (15625's inner,
    which the JAX kernel takes at r = 2 and the port's planner runs on the
    cluster passes) against the JAX two-pass kernel in interpret mode."""
    n, m = 15625, 32768
    chirp, h_fft = bluestein.bluestein_tables(n, m, d)
    host = conv_radix.radix_conv_tables(m, d, h_fft, chirp, chirp)
    x = _signal(2, n, seed=22)
    got, _ = _four_stage(m, d, torch.from_numpy(x), host, n)
    ref_chirp, ref_h = ref_bluestein.bluestein_tables(n, m, rd)
    ref = ref_conv_radix.make_radix_conv_fn(m, rd, np.complex64, h=ref_h, pre=ref_chirp,
                                            post=ref_chirp, conj_out=True, n_in=n, n_out=n,
                                            interpret=True)
    assert _rel(got, _jax_out(ref, x)) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


@pytest.mark.parametrize("n", [746497, 196613, 88589])
def test_planner_paths_take_the_ragged_stages(n, monkeypatch):
    """The four-stage paths chip_smoke.py drives (the recipes of the
    convolution-core rules, which the prime rule replaces in the planner,
    through executor.build) run conv_col_stage and conv_row_stage twice
    each, on the in-place chains' tables, and match the oracle on one
    row."""
    calls = []
    for name in ("conv_col_stage", "conv_row_stage", "conv_radix_pass1"):
        real = getattr(conv_radix, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(conv_radix, name, spy)
    x = _signal(1, n, seed=n)
    recipe = FftPlannerGpu(np.complex64, device="cpu")._conv_prime_recipe(n)
    assert FftPlanner(np.complex64, device="cpu").design_fft_for_len(n) != recipe
    got = executor.build(recipe, FftDirection.FORWARD, np.complex64)(torch.from_numpy(x))
    assert calls == ["conv_col_stage", "conv_row_stage"] * 2
    assert _rel(got, host_dft(x, FftDirection.FORWARD)) <= TOL


# -- K15: the tile form's column forms ------------------------------------------

@pytest.mark.parametrize("q", sorted(convlarge.COLUMN_FORMS))
def test_column_forms_positions_and_tables(q):
    """Each form's chain: register radices whose product is Q, W_0 a
    multiple of 16, two blocks an SM (at PAIR_Q each block of the pair holds
    half a column); bconv_positions against a numpy construction (the
    chain's digits as a C-order array, read in Fortran order); bconv_h_table
    the spectrum in those positions; the tables' shapes."""
    chain, width = convlarge.COLUMN_FORMS[q]
    blocks = 2 if q == convlarge.PAIR_Q else 1
    assert int(np.prod(chain)) == q and (q // chain[0] // blocks) % 16 == 0
    assert all(r in (2, 3, 6, 8, 9, 12, 16) for r in chain)
    assert 2 <= len(chain) <= (5 if q == convlarge.PAIR_Q else 4)
    held = q * width // blocks  # the values a block holds
    assert 2 * (8 * (held + sum(chain)) + 1024) <= 233472
    assert 256 % width == 0
    pos_of_k = np.arange(q).reshape(chain).reshape(-1, order="F")
    assert np.array_equal(convlarge.bconv_positions(q), np.argsort(pos_of_k))
    h = _signal(q, 256, seed=q)
    table = convlarge.bconv_h_table(h)
    assert table.shape == (256, q)
    assert np.array_equal(table[:, pos_of_k], h.T)
    roots, tws = convlarge.bconv_chain_tables(FftDirection.FORWARD, q)
    root_shapes, tw_shapes = convlarge.chain_table_shapes(q)
    assert [r.shape for r in roots] == root_shapes
    assert [t.shape for t in tws] == tw_shapes


def test_column_forms_take_the_general_forms_inner_lengths():
    """The forms cover every Q the planner gives a prime of [8192, 2^22] on
    K15 at P = 256 (tools/torch_prime_cores.py: the ten Q of 144 .. 1296
    below 2^20, 12288 and 24576 above it), and each first stage's columns
    fill whole warps with W_0 a multiple of 16 (csrc/bconv_cols.cuh
    bcg_stage's kLanded stage)."""
    assert {144, 192, 288, 384, 432, 576, 768, 864, 1152, 1296, 12288, 24576} <= set(
        convlarge.COLUMN_FORMS)
    for q, (chain, width) in convlarge.COLUMN_FORMS.items():
        if q == convlarge.PAIR_Q:  # the pair's halves run the 12288 chain after the cross stage
            assert chain[0] == 2 and convlarge.COLUMN_FORMS[q // 2][0] == chain[1:]
            continue
        assert (width * q // chain[0]) % 32 == 0, q


def _stage_np(v, r, w, roots, tw, by_hi):
    """One in-place stage of the column kernels in numpy: radix r over the
    position digit of weight w, times tw[k, lo] (or tw[k, hi])."""
    v = v.reshape(-1, r, w)
    dft = roots[(np.arange(r)[:, None] * np.arange(r)[None, :]) % r]
    out = np.einsum("jk,hjl->hkl", dft, v)
    if tw is not None:
        out = out * (tw.T[:, :, None] if by_hi else tw[None, :, :])
    return out.reshape(-1)


@pytest.mark.parametrize("q", sorted(convlarge.COLUMN_FORMS))
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_column_chains_in_place_equal_the_transform(q, d, rd):
    """The two in-place chains as csrc/bconv_cols.cu runs them (chain 1 on
    the position digits W_0 .. 1 with its own twiddles, conj(. * h) in
    position order, chain 2 on the digits reversed with the remapped
    twiddles), simulated in numpy from the host tables, against the
    natural-order FFT_Q(conj(FFT_Q(x) * H))."""
    chain = convlarge.column_chain(q)
    roots, tws = convlarge.bconv_chain_tables(d, q)
    roots = [np.asarray(r) for r in convlarge._stage_roots(q, [torch.from_numpy(r) for r in roots])]
    weights = convlarge._weights(chain)
    n = len(chain)
    x = _signal(1, q, seed=q)[0].astype(np.complex128)
    h = _signal(1, q, seed=q + 1)[0].astype(np.complex128)
    v = x
    for s in range(n):
        v = _stage_np(v, chain[s], weights[s], roots[s], tws[s] if s < n - 1 else None, False)
    v = np.conj(v * h[convlarge.bconv_positions(q)])
    for t in range(n):
        s = n - 1 - t
        v = _stage_np(v, chain[s], weights[s], roots[s], tws[n - 1 + t] if t < n - 1 else None,
                      True)
    def fft(u):  # the f64 transform in the chains' direction, unnormalized
        return np.fft.fft(u) if d is FftDirection.FORWARD else np.fft.ifft(u) * q

    want = fft(np.conj(fft(x) * h))
    assert _rel(v, want) <= TOL


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_pair_form_chains_equal_the_transform(d, rd):
    """The Q = 24576 form as csrc/bconv_pair.cu runs it on a cluster of two
    blocks, each holding half a column (12288 values), simulated in numpy
    from the host tables: chain 1's radix 2 across the halves (place e of
    both halves to the sum and the twiddled difference), each half's
    chain (3, 16, 16, 16) on the Q = 12288 form's digits with chain 1's
    twiddles, conj(. * h) with each half's slice of h in position order,
    chain 2 on each half with its twiddle columns offset by the half
    (hi0 = half * REST / 2), and the radix 2 across the halves again;
    against the natural-order FFT_Q(conj(FFT_Q(x) * H))."""
    q = convlarge.PAIR_Q
    half = q // 2
    chain = convlarge.column_chain(q)
    roots, tws = convlarge.bconv_chain_tables(d, q)
    roots = [np.asarray(r, dtype=np.complex128) for r in roots]
    tws = [np.asarray(t, dtype=np.complex128) for t in tws]
    tw1, tw2 = tws[:4], tws[4:]
    x = _signal(1, q, seed=7)[0].astype(np.complex128)
    h = _signal(1, q, seed=8)[0].astype(np.complex128)
    h_pos = h[convlarge.bconv_positions(q)]
    # chain 1's first stage across the pair, then each half on its own
    a, b = x[:half], x[half:]
    halves = [a + b, (a - b) * tw1[0][1]]
    sub = chain[1:]
    weights = convlarge._weights(sub)
    for rank in range(2):
        v = halves[rank]
        for s, r in enumerate(sub):
            last = s == len(sub) - 1
            v = _stage_np(v, r, weights[s], roots[s + 1], None if last else tw1[s + 1], False)
        v = np.conj(v * h_pos[rank * half:(rank + 1) * half])
        # chain 2 on the half: the radices reversed, every stage twiddled;
        # the columns by the digits above the stage, the half's among them
        for t in range(len(sub)):
            s = len(sub) - 1 - t
            rest = int(np.prod(chain[: s + 1]))  # the full chain's digits below it
            table = tw2[t][:, rank * (rest // 2):(rank + 1) * (rest // 2)]
            v = _stage_np(v, sub[s], weights[s], roots[s + 1], table, True)
        halves[rank] = v
    a, b = halves
    v = np.concatenate([a + b, a - b])

    def fft(u):  # the f64 transform in the chains' direction, unnormalized
        return np.fft.fft(u) if d is FftDirection.FORWARD else np.fft.ifft(u) * q

    want = fft(np.conj(fft(x) * h))
    assert _rel(v, want) <= TOL
    # the same positions the in-place chains of the other forms leave
    assert np.array_equal(convlarge.bconv_positions(q)[:half] % 2, np.zeros(half, np.int64))


def _k15_host(n, q, d, device="cpu"):
    m = 256 * q
    host = convlarge.bconv_tables(n, m, 256, q, d)
    col = (_on(host["col"][0], device), _on(host["col"][1], device),
           _on(host["col"][2], device))
    row = tuple(_on(t, device) for t in host["row"])
    pre, h, chirp = (_on(host[k], device) for k in ("pre", "h", "chirp"))
    tile_row = tuple(_on(t, device) for t in convlarge.bconv_chain_tables(d, q))
    tile_h = _on(convlarge.bconv_h_table(host["h"]), device)
    return m, col, row, pre, h, chirp, tile_row, tile_h, convlarge.to_columns(col[2])


@pytest.mark.parametrize("q", sorted(set(convlarge.COLUMN_FORMS) - {convlarge.TILE_Q}))
def test_tile_form_rule_takes_the_new_q(q):
    """Every Q of COLUMN_FORMS but 8192 at P = 256 is the tile form, at
    convlarge.split's split (large.choose_pqq's but at 3*2^21, where
    choose_pqq took P = 512); other P and Q are not; bconv_supported holds
    and the planner gives the prime that inner length."""
    n = K15_NEW[q]
    m = 256 * q
    assert convlarge.split(m)[0] == 256 and int(np.prod(convlarge.split(m))) == m
    assert convlarge.split(m) == large.choose_pqq(m) or q == convlarge.PAIR_Q
    assert convlarge.bconv_supported(m, np.complex64)
    assert convlarge.tile_form(256, q)
    assert not convlarge.tile_form(256, 200) and not convlarge.tile_form(243, q)
    assert executor.core_form("bluestein", m, np.complex64) == "K15 tile form"
    from rustfft_tpu_torch import recipes
    from rustfft_tpu_torch.planner import FftPlannerGpu

    recipe = FftPlannerGpu(np.complex64)._design_prime(n)
    assert isinstance(recipe, recipes.Bluesteins) and recipe.inner.length == m


@pytest.mark.parametrize("q", sorted(set(convlarge.COLUMN_FORMS) - {convlarge.TILE_Q}))
def test_tile_form_plain_equals_general_plain(q):
    """At each new Q, each tile wrapper's plain version against the general
    form's plain version on the same values (kernel A and A2 are the same
    arithmetic in another layout; B_conv runs the column form's chain)."""
    d = FftDirection.FORWARD
    n = K15_NEW[q]
    m, col, row, pre, h, chirp, tile_row, tile_h, tile_outer = _k15_host(n, q, d)
    x = torch.from_numpy(_signal(1, n, seed=q))
    a_old = _old_col_plain(x, 256, q, col, pre=pre)
    a = convlarge.bconv_col_tile(x, 256, q, col, pre)
    assert _rel(convlarge.from_columns(a), a_old) <= TOL
    b_old = convlarge.bconv_row_stage_plain(a_old, q, 256, row, h, col[2])
    b = convlarge.bconv_row_tile(a, q, 256, tile_row, tile_h, tile_outer)
    assert _rel(convlarge.from_columns(b), b_old) <= TOL
    out_old = convlarge.bconv_out_stage_plain(convlarge.from_columns(b), 256, q, col[:2], chirp, n)
    assert torch.equal(convlarge.bconv_out_tile(b, 256, q, col[:2], chirp, n), out_old)


@pytest.mark.parametrize("q", sorted(set(convlarge.COLUMN_FORMS) - {convlarge.TILE_Q}))
def test_tile_form_matches_jax_and_oracle(q):
    """The path's function at each new Q (the planner's prime) on one row
    against the JAX package and the oracle, the forward direction at some Q
    and the inverse at the others: up to 2^20 the JAX fused large Bluestein
    in interpret mode at the port's split (P = 256; the JAX choose_pqq has
    none at five of the Q below 1536) in full f32 precision; at 3*2^20 and
    3*2^21, where the JAX executor glues, the JAX planner's plan for the
    prime."""
    n = K15_NEW[q]
    m = 256 * q
    forward = q in (1536, 3072, 6144, 1728, 144, 288, 432, 768, 1152, 12288)
    d, rd = DIRECTIONS[0] if forward else DIRECTIONS[1]
    x = _signal(1, n, seed=n)
    got = convlarge.make_bluestein_large_fn(n, m, d, np.complex64)(torch.from_numpy(x)).numpy()
    if m <= 1 << 20:
        ref = _jax_out(ref_convlarge.make_bluestein_large_fn(
            n, m, rd, np.complex64, split=convlarge.split(m), interpret=True,
            precision=jax.lax.Precision.HIGHEST), x)
    else:
        ref = np.asarray(rustfft_tpu.FftPlanner(np.complex64).plan_fft(n, rd).process(x))
    assert _rel(got, ref) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


def test_small_q_keeps_the_general_kernels(monkeypatch):
    """The general kernels stay, on no planner path: the tile form takes
    24571 (Q = 192) by default, and make_bluestein_large_fn(general=True)
    reaches the general kernels at large.choose_pqq's split: kernel A is
    conv_col_stage on csrc/large.cuh (general=True, dividing tiles), whose
    plain version equals the ragged form's on the same values, then
    bconv_row_stage and bconv_out_stage."""
    calls = []
    real = conv_radix.conv_col_stage

    def spy(*a, **kw):
        calls.append(kw.get("general", False))
        return real(*a, **kw)

    monkeypatch.setattr(conv_radix, "conv_col_stage", spy)
    n, m = 24571, 49152
    d = FftDirection.FORWARD
    x = _signal(2, n, seed=24)
    tiled = convlarge.make_bluestein_large_fn(n, m, d, np.complex64)(torch.from_numpy(x))
    assert calls == []
    got = convlarge.make_bluestein_large_fn(n, m, d, np.complex64, general=True)(
        torch.from_numpy(x))
    assert calls == [True]
    assert _rel(got, host_dft(x, d)) <= TOL and _rel(tiled, host_dft(x, d)) <= TOL
    p, q1, q2 = large.choose_pqq(m)
    q = q1 * q2
    assert (p, q) == (256, 192) and convlarge.tile_form(p, q)
    host = convlarge.bconv_tables(n, m, p, q, d)
    col = (_on(host["col"][0]), _on(host["col"][1]), _on(host["col"][2]))
    pre = _on(host["pre"])
    xt = torch.from_numpy(x)
    a_general, part_g = conv_radix.conv_col_stage_plain(xt, p, q, col, pre, None, True,
                                                        general=True)
    a_ragged, part_r = conv_radix.conv_col_stage_plain(xt, p, q, col, pre, None, True)
    assert _rel(a_general, a_ragged) <= TOL
    assert part_g.shape == (2, q // conv_radix.col_tile(p, q))
    assert part_r.shape == (2, conv_radix.tiles(p, q))
    assert _rel(part_g.sum(dim=1), part_r.sum(dim=1)) <= TOL


@pytest.mark.parametrize("n,m", [(1048583, 3 << 20), (2097169, 3 << 21)])
def test_general_form_above_2_20_at_its_split(n, m):
    """Above 2^20 the general form keeps large.choose_pqq's split (P = 256
    at 3*2^20, P = 512 at 3*2^21, which the tile form's split leaves): its
    plain path at that split equals the tile form's on the same row, and
    both the oracle."""
    d = FftDirection.INVERSE
    x = _signal(1, n, seed=n + 1)
    tiled = convlarge.make_bluestein_large_fn(n, m, d, np.complex64)(torch.from_numpy(x))
    general = convlarge.make_bluestein_large_fn(n, m, d, np.complex64, general=True)(
        torch.from_numpy(x))
    assert large.choose_pqq(m)[0] == (512 if m == 3 << 21 else 256)
    assert _rel(general, tiled.numpy()) <= TOL
    assert _rel(tiled, host_dft(x, d)) <= TOL


def test_split_takes_p_256_where_b_conv_has_a_form():
    """convlarge.split: P = 256 with the most balanced q1 x q2 wherever m /
    256 is one of COLUMN_FORMS (3*2^21: P = 256 x Q = 24576, where
    large.choose_pqq takes P = 512 x Q = 12288), large.choose_pqq(m)
    elsewhere (2^22: 512 x 8192; 2^20 * 9: no form); bconv_supported and
    executor.core_form read it."""
    assert large.choose_pqq(3 << 21)[0] == 512
    assert convlarge.split(3 << 21) == (256, 128, 192)
    assert convlarge.split(3 << 20) == large.choose_pqq(3 << 20) == (256, 96, 128)
    for m in (1 << 22, 9 << 20, 49152 * 3):
        assert convlarge.split(m) == large.choose_pqq(m), m
    assert convlarge.bconv_supported(3 << 21, np.complex64)
    assert executor.core_form("bluestein", 3 << 21, np.complex64) == "K15 tile form"
    assert executor.core_form("bluestein", 3 << 21, np.complex64, core_rule=False) == \
        "K15 tile form"


def test_prime_rule_keeps_its_measured_tile_q():
    """The Q the tile form took in this slice serve the Bluesteins the
    planner already gave them: the prime rule's and the composite rule's
    inner (planner.routed_bluestein_inner) takes the tile form only at the Q
    they were measured on (planner.ROUTED_TILE_Q), so a Rader on K14's four
    stages keeps its move onto the cluster passes (17011 -> 65536, not
    36864 on the tile form) and the Bluesteins above 2^20 keep theirs."""
    from rustfft_tpu_torch import planner as port_planner

    assert executor.core_form("bluestein", 36864, np.complex64) == "K15 tile form"
    assert port_planner.routed_bluestein_inner(17011, np.complex64) == 65536
    recipe = FftPlannerGpu(np.complex64, device="cpu")._design_prime(17011)
    assert recipe.inner.length == 65536
    assert set(port_planner.ROUTED_TILE_Q) < set(convlarge.COLUMN_FORMS)
    assert port_planner.routed_bluestein_inner(1048583, np.complex64) is None


def test_tile_wrappers_check_the_column_form():
    """B_conv at a new Q refuses the tables of another Q and the old row
    layout."""
    q = 3072
    n = K15_NEW[q]
    m, col, row, pre, h, chirp, tile_row, tile_h, tile_outer = _k15_host(n, q, FftDirection.FORWARD)
    x = torch.from_numpy(_signal(1, n, seed=5))
    a = convlarge.bconv_col_tile(x, 256, q, col, pre)
    with pytest.raises(ValueError):
        convlarge.bconv_row_tile(a, q, 256, row, tile_h, tile_outer)  # the general chain's tables
    other = tuple(_on(t) for t in convlarge.bconv_chain_tables(FftDirection.FORWARD, 4096))
    with pytest.raises(ValueError):
        convlarge.bconv_row_tile(a, q, 256, other, tile_h, tile_outer)
    with pytest.raises(ValueError):
        convlarge.bconv_row_tile(convlarge.from_columns(a), q, 256, tile_row, tile_h, tile_outer)


# -- on the card -------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [17011, 746497])
@pytest.mark.parametrize("batch", [1, 3])
def test_ragged_rader_stages_match_plain_on_card(cuda_device, n, batch):
    """Every K14 policy launch of the Rader core (gather, sums, scatter,
    full_out; the rows read as a view n apart) against its plain version,
    both directions, ragged tiles on both axes at 17011."""
    m = n - 1
    p, q = conv_radix.choose_split(m)
    for d, _ in DIRECTIONS:
        perm_in, inv_gather, b_fft = raders.raders_tables(n, d)
        host = conv_radix.radix_conv_tables(m, d, b_fft, None, None, perm_in - 1, inv_gather)
        col = (_on(host["col"][0], cuda_device), _on(host["col"][1], cuda_device),
               _on(host["col"][2], cuda_device))
        row = (_on(host["row"][0], cuda_device), _on(host["row"][1], cuda_device))
        h, perm, scatter = (_on(host[k], cuda_device) for k in ("h", "perm", "scatter"))
        raw = torch.from_numpy(_signal(batch, n, seed=n + batch)).to(cuda_device)
        x, x0 = raw[:, 1:], raw[:, 0]
        a, part = conv_radix.conv_col_stage(x, p, q, col, perm=perm, emit_sum=True)
        torch.cuda.synchronize()
        ap, partp = conv_radix.conv_col_stage_plain(x, p, q, col, None, perm, True)
        assert _rel(a.cpu(), ap.cpu()) <= ON_CARD and _rel(part.cpu(), partp.cpu()) <= ON_CARD
        z = conv_radix.conv_row_stage(a, q, p, row, m, h=h)
        torch.cuda.synchronize()
        assert _rel(z.cpu(), conv_radix.conv_row_stage_plain(a, q, p, row, m, h=h).cpu()) <= ON_CARD
        b, _ = conv_radix.conv_col_stage(z, p, q, col)
        torch.cuda.synchronize()
        assert _rel(b.cpu(), conv_radix.conv_col_stage_plain(z, p, q, col)[0].cpu()) <= ON_CARD
        kw = dict(conj_out=True, x0=x0, scatter=scatter, partials=part)
        y = conv_radix.conv_row_stage(b, q, p, row, m, **kw)
        torch.cuda.synchronize()
        assert _rel(y.cpu(), conv_radix.conv_row_stage_plain(b, q, p, row, m, **kw).cpu()) <= ON_CARD
        assert _rel(y.cpu(), host_dft(raw.cpu().numpy(), d)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(8209, 17496), (196613, 419904), (88589, 186624)])
@pytest.mark.parametrize("batch", [1, 3])
def test_ragged_bluestein_stages_match_plain_on_card(cuda_device, n, m, batch):
    """The Bluestein core's four K14 policy launches (chirp, zero padding,
    post, n_out < m) against their plain versions, both directions."""
    p, q = conv_radix.choose_split(m)
    for d, _ in DIRECTIONS:
        chirp, h_fft = bluestein.bluestein_tables(n, m, d)
        host = conv_radix.radix_conv_tables(m, d, h_fft, chirp, chirp)
        col = (_on(host["col"][0], cuda_device), _on(host["col"][1], cuda_device),
               _on(host["col"][2], cuda_device))
        row = (_on(host["row"][0], cuda_device), _on(host["row"][1], cuda_device))
        h, pre, post = (_on(host[k], cuda_device) for k in ("h", "pre", "post"))
        x = torch.from_numpy(_signal(batch, n, seed=n + batch)).to(cuda_device)
        a, _ = conv_radix.conv_col_stage(x, p, q, col, pre=pre)
        torch.cuda.synchronize()
        assert _rel(a.cpu(), conv_radix.conv_col_stage_plain(x, p, q, col, pre)[0].cpu()) <= ON_CARD
        z = conv_radix.conv_row_stage(a, q, p, row, m, h=h)
        b, _ = conv_radix.conv_col_stage(z, p, q, col)
        y = conv_radix.conv_row_stage(b, q, p, row, n, conj_out=True, post=post)
        torch.cuda.synchronize()
        want = conv_radix.conv_row_stage_plain(b, q, p, row, n, conj_out=True, post=post)
        assert _rel(y.cpu(), want.cpu()) <= ON_CARD
        assert _rel(y.cpu(), host_dft(x.cpu().numpy(), d)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("q", sorted(set(convlarge.COLUMN_FORMS) - {convlarge.TILE_Q}))
@pytest.mark.parametrize("batch", [1, 3])
def test_column_forms_match_plain_on_card(cuda_device, q, batch):
    """Kernel A, B_conv and A2 of the tile form at each new Q against their
    plain versions, both directions, on rows only 8-byte aligned."""
    n = K15_NEW[q]
    for d, _ in DIRECTIONS:
        m, col, row, pre, h, chirp, tile_row, tile_h, tile_outer = _k15_host(n, q, d, cuda_device)
        buf = torch.from_numpy(_signal(1, batch * n + 1, seed=batch)).to(cuda_device)
        x = buf[0, 1:].view(batch, n)
        a = convlarge.bconv_col_tile(x, 256, q, col, pre)
        torch.cuda.synchronize()
        assert _rel(a.cpu(), convlarge.bconv_col_tile_plain(x, 256, q, col, pre).cpu()) <= ON_CARD
        b = convlarge.bconv_row_tile(a, q, 256, tile_row, tile_h, tile_outer)
        torch.cuda.synchronize()
        want = convlarge.bconv_row_tile_plain(a, q, 256, tile_row, tile_h, tile_outer)
        assert _rel(b.cpu(), want.cpu()) <= ON_CARD
        out = convlarge.bconv_out_tile(b, 256, q, col[:2], chirp, n)
        torch.cuda.synchronize()
        assert _rel(out.cpu(), convlarge.bconv_out_tile_plain(b, 256, q, col[:2], chirp,
                                                              n).cpu()) <= ON_CARD
        assert _rel(out.cpu(), host_dft(x.cpu().numpy(), d)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,rises", [
    (746497, {"conv_col_stage": 2, "conv_row_stage": 2}),
    (196613, {"conv_col_stage": 2, "conv_row_stage": 2}),
    (88589, {"conv_col_stage": 2, "conv_row_stage": 2}),
    (524309, {"bconv_col_tile": 1, "bconv_row_tile": 1, "bconv_out_tile": 1}),
    (165901, {"bconv_col_tile": 1, "bconv_row_tile": 1, "bconv_out_tile": 1}),
    (24571, {"bconv_col_tile": 1, "bconv_row_tile": 1, "bconv_out_tile": 1}),
    (1048583, {"bconv_col_tile": 1, "bconv_row_tile": 1, "bconv_out_tile": 1}),
    (2097169, {"bconv_col_tile": 1, "bconv_row_tile": 1, "bconv_out_tile": 1}),
    ("24571 general", {"conv_col_stage": 1, "bconv_row_stage": 1, "bconv_out_stage": 1}),
])
def test_general_paths_launch_their_forms_on_card(cuda_device, n, rises):
    counters = {"bconv_col_tile": convlarge.bconv_col_tile,
                "bconv_row_tile": convlarge.bconv_row_tile,
                "bconv_out_tile": convlarge.bconv_out_tile,
                "bconv_row_stage": convlarge.bconv_row_stage,
                "bconv_out_stage": convlarge.bconv_out_stage,
                "conv_radix_pass1": conv_radix.conv_radix_pass1,
                "conv_col_stage": conv_radix.conv_col_stage,
                "conv_row_stage": conv_radix.conv_row_stage}
    planner = FftPlanner(np.complex64, device="cuda")
    general = isinstance(n, str)  # the general form through the keyword, on no planner path
    n = int(n.split()[0]) if general else n
    x = _signal(2, n, seed=n)
    for d, _ in DIRECTIONS:
        plan = planner.plan_fft(n, d)
        process = plan.process
        if rises.get("conv_col_stage") == 2:  # K14's four stages: the prime rule's old recipe
            process = FftPlan(FftPlannerGpu(np.complex64)._conv_prime_recipe(n), d,
                              np.complex64).process
        if general:
            process = convlarge.make_bluestein_large_fn(n, plan.recipe.inner.length, d,
                                                        np.complex64, general=True)
        before = {k: c.launches for k, c in counters.items()}
        got = process(torch.from_numpy(x).to(cuda_device))
        torch.cuda.synchronize()
        assert {k: c.launches - before[k] for k, c in counters.items()} == \
            {k: rises.get(k, 0) for k in counters}
        assert _rel(got.cpu(), host_dft(x, d)) <= TOL
