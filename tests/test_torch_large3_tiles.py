"""K11's two kernels (csrc/large3.cu): pass 1 on K2's persistent column-tile
body with a modular twiddle slice, and pass 2 as a persistent two-buffer
walk with its DFT over j2 split in two radices.

On the CPU: numpy mirrors of each kernel's walk and arithmetic, unit by unit
in the order the kernel takes them (ops/kernels/large3.py col_walk and
col_unit, p2_walk, p2_unit and p2_split, the functions the wrappers size
the launches with), held against the plain torch versions, the JAX
pipeline's passes in Pallas interpret mode (each pass's output taken from
the pipeline's own pallas_call) and the float64 oracle: relative mean error
<= 1e-5 (the JAX kernels' bf16x3 tier in interpret mode is ~4e-6 from the
oracle).  The tests marked `cuda` hold each kernel against its plain
version on the card (relative mean error <= 1e-6: the same stages in
float32, summed in another order than torch's) and skip without a GPU.
"""
import math

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import large3 as ref_large3
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import large, large3
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
TOL = 1e-5
#: relative mean error of a kernel against its plain version on the card
VS_PLAIN = 1e-6

#: resident blocks of an H100 (132 SMs, two of either kernel's blocks an SM)
RESIDENT = 264

#: pass 1's small split for the mirrors: P1 = 256 (the kernel's 16 x 16
#: chain), P2 = 4, Q = 32 (two slices of wob), M = 128
P1_SPLIT = (256, 4, 4, 8, 32)

#: pass 2's small splits: P1 = 128 (two chunks of W = 64 k1), Q = 16
P2_P1, P2_Q = 128, 16


def _signal(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _w(sign, e, m):
    return np.exp(sign * 2j * np.pi * (e % m) / m)


def _jax_passes(monkeypatch, x, split, rd, factored):
    """The JAX pipeline's three pass outputs on x (complex, (B, n)), each
    taken from the pipeline's own pallas_call in interpret mode."""
    caught, orig = [], pl.pallas_call

    def record(*args, **kwargs):
        fn = orig(*args, **kwargs)

        def run(*operands):
            out = fn(*operands)
            caught.append(np.asarray(out[0]) + 1j * np.asarray(out[1]))
            return out

        return run

    monkeypatch.setattr(pl, "pallas_call", record)
    n = split[0] * split[1] * split[4]
    fn = ref_large3.make_large3_fft_fn(n, rd, np.complex64, split=split, interpret=True,
                                       pt=split[0], qt=16, factored=factored)
    fn((x.real.copy(), x.imag.copy()))
    monkeypatch.setattr(pl, "pallas_call", orig)
    assert len(caught) == 3
    return caught


# -- pass 1: the walk ---------------------------------------------------------------

def _pass1_blocks(batch, groups, slices, resident):
    """Each block's units as (b, j2, s, t), from col_walk's grid and per."""
    units = batch * groups * slices
    grid, per = large3.col_walk(batch, groups, slices, resident)
    return grid, per, [[large3.col_unit(v, batch, groups, slices) for v in r]
                       for r in large.walk_units(grid, per, units)]


# the main path's walk (2^26 x 2: P2 = 64 groups of 256 slices), batch 1 and
# 3, a grid that covers the units in one round, ragged last blocks, and
# small grids where a block's range crosses several slices
@pytest.mark.parametrize("batch,groups,slices,resident", [
    (2, 64, 256, RESIDENT), (1, 64, 256, RESIDENT), (3, 64, 256, RESIDENT),
    (2, 4, 2, RESIDENT), (3, 4, 2, 5), (1, 64, 256, 1), (7, 5, 3, 4), (2, 1, 256, RESIDENT),
])
def test_pass1_walk_takes_every_tile_once_and_keeps_its_slice(batch, groups, slices, resident):
    grid, per, blocks = _pass1_blocks(batch, groups, slices, resident)
    units = batch * groups * slices
    assert 1 <= grid <= resident and (grid - 1) * per < units <= grid * per
    seen = [(t, b) for block in blocks for (b, _, _, t) in block]
    assert sorted(seen) == [(t, b) for t in range(groups * slices) for b in range(batch)]
    assert len(set(seen)) == units
    for block in blocks:
        assert block, "every block of the grid has a unit"
        for b, j2, s, t in block:
            # the tile's columns j2*Q + 16s .. + 15, its slice wob rows 16*(t mod Q/16)
            assert (t // slices, t % slices) == (j2, s) and s == t % slices
        loads = 1 + sum(1 for u, v in zip(block, block[1:]) if u[2] != v[2])
        assert loads <= math.ceil(per / (groups * batch)) + 1
        assert [u[2] for u in block] == sorted(u[2] for u in block)  # slice slowest


def test_pass1_walk_at_one_group_is_k2s():
    """One group is K2's order: unit v is tile v // batch of row v % batch,
    its slice the tile's own (csrc/col_tile.cuh: t = s = u / batch)."""
    for batch, tiles in ((1, 256), (3, 88), (64, 256)):
        assert large3.col_walk(batch, 1, tiles, RESIDENT) == large.col_walk(batch * tiles,
                                                                            RESIDENT)
        for v in range(batch * tiles):
            assert large3.col_unit(v, batch, 1, tiles) == (v % batch, 0, v // batch, v // batch)


def test_pass1_walk_at_the_main_path_loads_a_slice_per_128_units():
    """At 2^26 x 2 (P2 = 64, Q/16 = 256 slices) a slice serves P2*B = 128
    consecutive units; a block of the H100's 264 holds 125 and reads at
    most two slices."""
    p1, p2, _, _, q = large3.choose_split3f(1 << 26)
    grid, per, blocks = _pass1_blocks(2, p2, q // 16, RESIDENT)
    assert (grid, per) == (263, 125)
    assert max(len({u[2] for u in block}) for block in blocks) == 2


# -- pass 1: the mirror ---------------------------------------------------------------

def _pass1_mirror(x, p1, m, q, tables, resident):
    """Pass 1 as csrc/col_tile.cuh computes it at P1 = 16 x 16, unit by unit
    in the walk's order: the (256, 16) tile of rows M apart, stage 0 (radix
    16 over the high digit of j1, times tw0[k0, jlow]), stage 1 (radix 16
    over the low digit) times the block's slice of wob, stored transposed
    to rows 16t .. 16t + 15.  Returns y and the slice loads of each block."""
    roots, tws, wob = (np.asarray(t, dtype=np.complex128) if not isinstance(t, list)
                       else [np.asarray(v, dtype=np.complex128) for v in t] for t in tables)
    assert p1 == 256 and len(roots) == 2
    batch = x.shape[0]
    groups, slices = m // q, q // 16
    grid, per = large3.col_walk(batch, groups, slices, resident)
    xb = x.reshape(batch, p1, m).astype(np.complex128)
    d16 = [r[np.outer(np.arange(16), np.arange(16)) % 16] for r in roots]  # [j, k]
    tw0 = tws[0].reshape(16, 16)  # [k0, jlow]
    y = np.full((batch, m, p1), np.nan, dtype=np.complex128)
    loads = []
    for block in large.walk_units(grid, per, batch * groups * slices):
        held, count = None, 0
        for v in block:
            b, _, s, t = large3.col_unit(v, batch, groups, slices)
            if s != held:
                outer, held, count = wob[16 * s:16 * s + 16], s, count + 1  # (16, P1) [c, k1]
            tile = xb[b, :, 16 * t:16 * t + 16].reshape(16, 16, 16)  # [jhigh, jlow, c]
            st0 = np.einsum("hlc,hk->klc", tile, d16[0]) * tw0[:, :, None]  # [k0, jlow, c]
            st1 = np.einsum("klc,lm->mkc", st0, d16[1])  # [khigh, k0, c]
            res = st1.reshape(256, 16)  # [k1, c], k1 = 16*khigh + k0
            y[b, 16 * t:16 * t + 16, :] = res.T * outer
        loads.append(count)
    return y, loads


def _pass1_oracle(x, p1, m, q, d):
    """a[b, jr, k1] = w_n^(k1 * (jr mod Q)) * DFT_P1 over j1, in float64."""
    sign = -1.0 if d is FftDirection.FORWARD else 1.0
    n = p1 * m
    dft = host_dft(x.reshape(x.shape[0], p1, m).transpose(0, 2, 1), d)  # (B, M, P1)
    return dft * _w(sign, (np.arange(m)[:, None] % q) * np.arange(p1)[None, :], n)


@pytest.mark.parametrize("batch", [1, 2, 3])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_pass1_mirror_matches_plain_jax_and_oracle(monkeypatch, batch, d, rd):
    p1, p2, _, _, q = P1_SPLIT
    m, n = p2 * q, p1 * p2 * q
    x = _signal(batch, n, seed=batch + 17)
    tables = large3.col_tables(p1, m, q, d)
    # a small grid, so that blocks cross slices and the last one is ragged
    got, loads = _pass1_mirror(x, p1, m, q, tables, resident=3)
    assert not np.isnan(got).any()
    units = batch * m // 16
    _, per = large3.col_walk(batch, p2, q // 16, 3)
    assert max(loads) <= math.ceil(per / (p2 * batch)) + 1 and per < units
    r, t, wob = tables
    plain = large3.large3_col_stage_plain(torch.from_numpy(x), p1, m, q,
                                          ([torch.from_numpy(v) for v in r],
                                           [torch.from_numpy(v) for v in t],
                                           torch.from_numpy(wob)))
    assert _rel(got, plain) <= TOL
    assert _rel(got, _pass1_oracle(x, p1, m, q, d)) <= TOL
    jax_a = _jax_passes(monkeypatch, x, P1_SPLIT, rd, factored=True)[0]  # (B, M, P1)
    assert jax_a.shape == got.shape and _rel(got, jax_a) <= TOL


# -- pass 2: the walk and the split ----------------------------------------------------

@pytest.mark.parametrize("p2,split", [(64, (8, 8)), (32, (8, 4)), (16, (4, 4)), (8, (8, 1)),
                                      (4, (4, 1)), (2, (2, 1)), (128, (16, 8))])
def test_p2_split(p2, split):
    assert large3.p2_split(p2) == split
    ra, rb = split
    # stage A holds RA values a thread: 16 only at P2 = 128 (2^27)
    assert ra * rb == p2 and ra % 2 == 0 and ra <= (16 if p2 == 128 else 8) and rb <= 8
    # a unit is 32 KiB: W = 64 k1, or 32 at P2 = 128
    assert p2 * large3.p2_cols(p2) * 8 <= 32768 and large3.p2_cols(p2) == (32 if p2 == 128 else 64)


@pytest.mark.parametrize("p2", [0, 1, 3, 12, 256])
def test_p2_split_refuses_other_p2(p2):
    with pytest.raises(ValueError):
        large3.p2_split(p2)


# the main path (2^26 x 2: Q = 4096, four chunks of P1 = 256), batch 1 and
# 3, ragged last blocks, one block, the mirrors' small shapes and narrower
# last chunks (P1 = 96, 8)
@pytest.mark.parametrize("batch,q,p1,resident", [
    (2, 4096, 256, RESIDENT), (1, 4096, 256, RESIDENT), (3, 4096, 256, RESIDENT),
    (3, 16, 128, 5), (2, 16, 128, 1), (1, 2048, 128, RESIDENT), (5, 7, 64, 4),
    (3, 16, 96, 5), (2, 16, 8, 3),
])
def test_p2_walk_takes_every_unit_once(batch, q, p1, resident, p2=64):
    w = large3.p2_cols(p2)
    chunks = large3.p2_chunks(p1, p2)
    assert (chunks - 1) * w < p1 <= chunks * w
    units = batch * q * chunks
    grid, per = large3.p2_walk(batch, q, p1, p2, resident)
    assert 1 <= grid <= resident and (grid - 1) * per < units <= grid * per
    blocks = [[large3.p2_unit(u, batch, q) for u in r] for r in large.walk_units(grid, per, units)]
    seen = [u for block in blocks for u in block]
    assert sorted(seen) == [(c, b, j3) for c in range(chunks) for b in range(batch)
                            for j3 in range(q)]
    for block in blocks:
        assert block and [u[0] for u in block] == sorted(u[0] for u in block)  # chunk slowest
        chunks = len({u[0] for u in block})
        assert chunks <= math.ceil(per / (batch * q)) + 1


def test_p2_walk_at_the_main_path():
    """2^26 x 2: 32768 units of 32 KiB, 125 a block on the H100's 264
    blocks; a block's range holds at most two chunks of wos."""
    p1, p2, _, _, q = large3.choose_split3f(1 << 26)
    assert large3.p2_chunks(p1, p2) == 4
    assert large3.p2_walk(2, q, p1, p2, RESIDENT) == (263, 125)


# -- pass 2: the mirror ---------------------------------------------------------------

def _pass2_mirror(a, p1, p2, q, roots, wos, wm, resident):
    """Pass 2 as p2_ring_kernel computes it, unit by unit in the walk's
    order: the (P2, W) tile of rows Q*P1 apart times the block's wos slice,
    stage A (DFT_RA over ja of rows jb + RB*ja, times w_P2^(jb*ka), back to
    rows jb + RB*ka), stage B (DFT_RB over jb) times wm[j3, k2], stored to
    rows k2 of (b, j3).  Returns y (B, Q, P2*P1) and the wos loads of each
    block."""
    ra, rb = large3.p2_split(p2)
    roots = np.asarray(roots, dtype=np.complex128)
    wm = np.asarray(wm, dtype=np.complex128)
    batch, w = a.shape[0], large3.p2_cols(p2)
    av = a.reshape(batch, p2, q, p1).astype(np.complex128)
    y = np.full((batch, q, p2, p1), np.nan, dtype=np.complex128)
    da = roots[np.outer(np.arange(ra), np.arange(ra)) % ra * rb]  # w_RA^(ja*ka)
    db = roots[np.outer(np.arange(rb), np.arange(rb)) % rb * ra]  # w_RB^(jb*kb)
    inner = roots[np.outer(np.arange(ra), np.arange(rb))]  # w_P2^(ka*jb), [ka, jb]
    grid, per = large3.p2_walk(batch, q, p1, p2, resident)
    loads = []
    for block in large.walk_units(grid, per, batch * q * large3.p2_chunks(p1, p2)):
        held, count = None, 0
        for u in block:
            chunk, b, j3 = large3.p2_unit(u, batch, q)
            cols = slice(chunk * w, min((chunk + 1) * w, p1))
            width = cols.stop - cols.start
            tile = av[b, :, j3, cols]  # (P2, width) [j2, col]
            if wos is not None:
                if chunk != held:
                    sl = np.asarray(wos, dtype=np.complex128)[:, cols]
                    held, count = chunk, count + 1
                tile = tile * sl
            st_a = np.einsum("ajc,ak->kjc", tile.reshape(ra, rb, width), da) * inner[:, :, None]
            st_b = np.einsum("kjc,jl->lkc", st_a, db)  # [kb, ka, col]: k2 = ka + RA*kb
            y[b, j3, :, cols] = st_b.reshape(p2, width) * wm[j3][:, None]
        loads.append(count)
    return y.reshape(batch, q, p2 * p1), loads


def _pass2_oracle(a, p1, p2, q, d, factored):
    """b[b, j3, k2, k1] = w_M^(k2*j3) * DFT_P2 over j2 of wos[j2, k1] *
    a[b, j2, j3, k1], wos = w_{P1P2}^(j2*k1), in float64."""
    sign = -1.0 if d is FftDirection.FORWARD else 1.0
    v = a.reshape(a.shape[0], p2, q, p1).astype(np.complex128)
    if factored:
        v = v * _w(sign, np.arange(p2)[:, None] * np.arange(p1)[None, :], p1 * p2)[:, None, :]
    f = host_dft(v.transpose(0, 2, 3, 1), d)  # (B, Q, P1, P2) [j3, k1, k2]
    f = f * _w(sign, np.arange(q)[:, None, None] * np.arange(p2)[None, None, :], p2 * q)
    return f.transpose(0, 1, 3, 2).reshape(a.shape[0], q, p2 * p1)


@pytest.mark.parametrize("factored", [True, False], ids=["p2f", "p2"])
@pytest.mark.parametrize("p2", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_pass2_mirror_matches_plain_jax_and_oracle(monkeypatch, factored, p2, d, rd):
    p1, q = P2_P1, P2_Q
    split = (p1, p2, 4, 4, q)
    x = _signal(1, p1 * p2 * q, seed=p2 + 5 * factored)
    jax_a, jax_b, _ = _jax_passes(monkeypatch, x, split, rd, factored)
    a = jax_a.astype(np.complex64)  # the JAX pass 1's output, (1, M, P1)
    roots, wos, wm = large3.p2_tables(p1, p2, q, d, factored)
    got, loads = _pass2_mirror(a, p1, p2, q, roots, wos, wm, resident=3)
    assert not np.isnan(got).any()
    if factored:
        assert max(loads) <= 2
    plain = large3.large3_p2_plain(torch.from_numpy(a), p1, p2, q,
                                   (torch.from_numpy(roots),
                                    None if wos is None else torch.from_numpy(wos),
                                    torch.from_numpy(wm)))
    assert _rel(got, plain) <= TOL
    assert _rel(got, _pass2_oracle(a, p1, p2, q, d, factored)) <= TOL
    # the JAX pass 2 writes (B, P2, Q, P1) [k2, j3, k1]; the port (B, Q, P2, P1)
    want = jax_b.reshape(1, p2, q, p1).transpose(0, 2, 1, 3).reshape(1, q, p2 * p1)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("p1,p2", [(96, 4), (8, 8)])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_pass2_mirror_narrow_last_chunk(monkeypatch, p1, p2, d, rd):
    """P1 = 96 (a chunk of 64 and one of 32) and P1 = 8 (one chunk of 8,
    tests/test_torch_top.py's split): the columns past P1 idle."""
    q = P2_Q
    x = _signal(2, p1 * p2 * q, seed=p1 + p2)
    jax_a, jax_b, _ = _jax_passes(monkeypatch, x, (p1, p2, 4, 4, q), rd, True)
    a = jax_a.astype(np.complex64)
    roots, wos, wm = large3.p2_tables(p1, p2, q, d, True)
    got, _ = _pass2_mirror(a, p1, p2, q, roots, wos, wm, resident=3)
    assert not np.isnan(got).any()
    plain = large3.large3_p2_plain(torch.from_numpy(a), p1, p2, q,
                                   tuple(torch.from_numpy(v) for v in (roots, wos, wm)))
    assert _rel(got, plain) <= TOL
    assert _rel(got, _pass2_oracle(a, p1, p2, q, d, True)) <= TOL
    want = jax_b.reshape(2, p2, q, p1).transpose(0, 2, 1, 3).reshape(2, q, p2 * p1)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_pass2_mirror_p2_128_matches_plain_jax_and_oracle(monkeypatch, d, rd):
    """2^27's form, P2 = 128 (units of W = 32 k1, DFT_128 as 16 x 8), at
    the split (8, 128, 4, 4, 16), batch 2 on 3 blocks (a ragged walk):
    the mirror against the plain version, the JAX pass 2 (_kernel_p2f) and
    the oracle, and the port's pipeline against the JAX pipeline."""
    split = p1, p2, _, _, q = (8, 128, 4, 4, 16)
    x = _signal(2, p1 * p2 * q, seed=128)
    jax_a, jax_b, jax_y = _jax_passes(monkeypatch, x, split, rd, True)
    a = jax_a.astype(np.complex64)
    roots, wos, wm = large3.p2_tables(p1, p2, q, d, True)
    got, loads = _pass2_mirror(a, p1, p2, q, roots, wos, wm, resident=3)
    assert not np.isnan(got).any() and max(loads) == 1
    plain = large3.large3_p2_plain(torch.from_numpy(a), p1, p2, q,
                                   tuple(torch.from_numpy(v) for v in (roots, wos, wm)))
    assert _rel(got, plain) <= TOL
    assert _rel(got, _pass2_oracle(a, p1, p2, q, d, True)) <= TOL
    want = jax_b.reshape(2, p2, q, p1).transpose(0, 2, 1, 3).reshape(2, q, p2 * p1)
    assert _rel(got, want) <= TOL
    y = large3.make_large3_fft_fn(p1 * p2 * q, d, np.complex64, split=split, factored=True)(
        torch.from_numpy(x)).numpy()
    assert _rel(y, jax_y.reshape(y.shape)) <= TOL
    assert _rel(y, host_dft(x, d)) <= TOL


@pytest.mark.parametrize("factored", [True, False], ids=["p2f", "p2"])
@pytest.mark.parametrize("batch", [1, 3])
def test_pass2_mirror_p2_128_over_chunks(batch, factored):
    """P2 = 128 at P1 = 96 (chunks of 32 k1: three) and batch 1 and 3 on 5
    blocks: block ranges across chunks, a ragged last block, the j2 factor
    on and off, against the plain version and the oracle."""
    p1, p2, q = 96, 128, 8
    d = FftDirection.INVERSE
    a = _signal(batch, p1 * p2 * q, seed=batch + 128)
    roots, wos, wm = large3.p2_tables(p1, p2, q, d, factored)
    got, loads = _pass2_mirror(a, p1, p2, q, roots, wos, wm, resident=5)
    assert not np.isnan(got).any()
    if factored:
        assert max(loads) == 2
    plain = large3.large3_p2_plain(torch.from_numpy(a), p1, p2, q,
                                   (torch.from_numpy(roots),
                                    None if wos is None else torch.from_numpy(wos),
                                    torch.from_numpy(wm)))
    assert _rel(got, plain) <= TOL
    assert _rel(got, _pass2_oracle(a, p1, p2, q, d, factored)) <= TOL


@pytest.mark.parametrize("batch,q,p1,resident", [
    (1, 4096, 256, RESIDENT), (2, 4096, 256, RESIDENT), (3, 16, 96, 5), (2, 16, 8, 3),
])
def test_p2_walk_at_p2_128_takes_every_unit_once(batch, q, p1, resident):
    """The same walk over units of 32 k1 (2^27 x 1 and x 2, a narrower last
    chunk at P1 = 96, one chunk at P1 = 8)."""
    test_p2_walk_takes_every_unit_once(batch, q, p1, resident, p2=128)


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_pass2_mirror_at_batches(batch):
    """Units of several batch rows, a ragged last block and a block range
    across both chunks, at the main path's P2 = 64."""
    p1, p2, q = P2_P1, 64, P2_Q
    d = FftDirection.FORWARD
    a = _signal(batch, p1 * p2 * q, seed=batch + 40)
    roots, wos, wm = large3.p2_tables(p1, p2, q, d, True)
    got, loads = _pass2_mirror(a, p1, p2, q, roots, wos, wm, resident=5)
    assert not np.isnan(got).any() and max(loads) == 2
    assert _rel(got, _pass2_oracle(a, p1, p2, q, d, True)) <= TOL


# -- on the card -----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_signal(batch, n, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("p2", [64, 4])
@pytest.mark.parametrize("batch", [1, 2, 3])
def test_pass1_kernel_on_card(cuda_device, batch, p2):
    """large3_col_stage on the tile kernel at P1 = 256, Q = 4096 (P2 = 64
    is 2^26), against its plain version, both directions."""
    p1, q = 256, 4096
    m = p2 * q
    x = _card_signal(batch, p1 * m, 11 + batch, cuda_device)
    for d, _ in DIRECTIONS:
        r, t, wob = large3.col_tables(p1, m, q, d)
        tables = ([torch.from_numpy(v).to(cuda_device) for v in r],
                  [torch.from_numpy(v).to(cuda_device) for v in t],
                  torch.from_numpy(wob).to(cuda_device))
        before = large3.large3_col_stage.launches
        got = large3.large3_col_stage(x, p1, m, q, tables)
        torch.cuda.synchronize()
        assert large3.large3_col_stage.launches == before + 1
        want = large3.large3_col_stage_plain(x, p1, m, q, tables)
        assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= VS_PLAIN


@pytest.mark.cuda
@pytest.mark.parametrize("factored", [True, False], ids=["p2f", "p2"])
@pytest.mark.parametrize("batch", [1, 2, 3])
def test_pass2_kernel_on_card(cuda_device, batch, factored):
    """large3_p2 at 2^26's split (P1 = 256, P2 = 64, Q = 4096) against its
    plain version, both directions, the j2 factor on and off."""
    p1, p2, _, _, q = large3.choose_split3f(1 << 26)
    a = _card_signal(batch, p1 * p2 * q, 21 + batch, cuda_device).reshape(batch, p2 * q, p1)
    for d, _ in DIRECTIONS:
        tabs = tuple(None if v is None else torch.from_numpy(v).to(cuda_device)
                     for v in large3.p2_tables(p1, p2, q, d, factored))
        before = large3.large3_p2.launches
        got = large3.large3_p2(a, p1, p2, q, tabs)
        torch.cuda.synchronize()
        assert large3.large3_p2.launches == before + 1
        want = large3.large3_p2_plain(a, p1, p2, q, tabs)
        assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= VS_PLAIN


@pytest.mark.cuda
@pytest.mark.parametrize("p1,p2", [(128, 2), (128, 4), (128, 8), (128, 16), (128, 32),
                                   (96, 64), (8, 8)])
def test_pass2_kernel_smaller_p2_on_card(cuda_device, p1, p2):
    """large3_p2 at every smaller P2 (the split's other forms) and at a
    narrower last chunk (P1 = 96, 8), batch 3, against its plain version,
    the j2 factor on and off."""
    q, batch = 2048, 3
    a = _card_signal(batch, p1 * p2 * q, p2, cuda_device).reshape(batch, p2 * q, p1)
    for factored in (True, False):
        tabs = tuple(None if v is None else torch.from_numpy(v).to(cuda_device)
                     for v in large3.p2_tables(p1, p2, q, FftDirection.INVERSE, factored))
        got = large3.large3_p2(a, p1, p2, q, tabs)
        torch.cuda.synchronize()
        want = large3.large3_p2_plain(a, p1, p2, q, tabs)
        assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= VS_PLAIN
