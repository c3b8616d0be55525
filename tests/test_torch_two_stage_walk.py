"""K7's two kernels with factored register radices, held on the CPU.

K7's one-block band (14464 .. 28800, csrc/fused.cu two_stage_kernel) and
cluster band (28928 .. 261632, two_stage_cluster_kernel on clusters of
`fused.choose_cluster(n)` blocks) run K7's chains, the radices of
`fused.FACTORED_RADICES` in the factored register forms of
csrc/factored_dft.cuh, with 16-byte loads and stores, and read the outer
twiddle transposed (`fused.outer_transposed`) where the path gives it.
Here, inputs made with numpy from a seed:

  - the header's constants against numpy, and a numpy mirror of its
    butterflies (conjugate pairs, one Cooley-Tukey step) against np.fft;
  - the plain chains (`fused.k7_chain_plain`) at one size of each factored
    radix against the JAX K7 in interpret mode (precision="bf16x3", as
    tests/test_torch_cluster.py runs it) and the f64 oracle, relative mean
    error <= 1e-5, both directions;
  - `choose_cluster`'s rule over all 1009 cluster sizes, and each kernel's
    shared memory within `_build.SMEM_MAX` over all 1122 sizes;
  - numpy mirrors of both kernels' index arithmetic (the 16-byte loads into
    the swizzle, DFT_p's places, the fold from either layout of the outer
    twiddle, the exchange, the 16-byte stores) against the oracle.

The tests marked `cuda` hold the kernels against their plain versions on
the card and skip without a GPU.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import fused as ref_fused
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import _build, fused, lanepack, large
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
DIR_IDS = ["fwd", "inv"]
TOL = 1e-5
#: the kernel against its plain version (csrc/fused.cu, chip_smoke.py K7_TOL)
K7_TOL = 1e-6
HEADER = Path(fused.__file__).resolve().parents[2] / "csrc" / "factored_dft.cuh"


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


def _tables(p, q, d, device="cpu"):
    host = fused.two_stage_tables(p, large.stage_radices(q), d)
    return tuple([torch.from_numpy(a).to(device) for a in t] if isinstance(t, list)
                 else torch.from_numpy(t).to(device) for t in host)


def _band():
    """(n, one) for every size the two-stage route takes: one block's band
    (16384 included) and the cluster band."""
    out = []
    for n in range(128, fused.MAX_FUSED_N + 1, 128):
        if fused.radix_supported(n, np.complex64):
            continue
        if fused.two_stage_supported(n, np.complex64):
            out.append((n, True))
        elif fused.two_stage_cluster_supported(n, np.complex64):
            out.append((n, False))
    return out


BAND = _band()
CLUSTER = [n for n, one in BAND if not one]
#: the one-block band's sizes on the one-block kernel (16384 runs the radix body)
ONE = [n for n, one in BAND if one and n != 16384]


# -- the factored forms ----------------------------------------------------------------

def _header_trig():
    """{R: (cos, sin)} of csrc/factored_dft.cuh's trig<R> tables."""
    text = HEADER.read_text()
    out = {}
    for m in re.finditer(r"R == (\d+)\) \{\s*constexpr float c\[\d+\] = \{([^}]*)\};\s*"
                         r"constexpr float s\[\d+\] = \{([^}]*)\};", text):
        out[int(m.group(1))] = tuple(
            np.array([float(v.strip().rstrip("f")) for v in g.split(",")]) for g in m.groups()[1:])
    m = re.search(r"static_assert\(R == 20[^;]*;\s*constexpr float c\[20\] = \{([^}]*)\};\s*"
                  r"constexpr float s\[20\] = \{([^}]*)\};", text)
    out[20] = tuple(np.array([float(v.strip().rstrip("f")) for v in g.split(",")])
                    for g in m.groups())
    return out


TRIG = _header_trig()


def test_factored_radices_are_the_headers():
    assert fused.FACTORED_RADICES == {3, 5, 7, 6, 9, 10, 12, 14, 15, 20}
    assert set(TRIG) == fused.FACTORED_RADICES
    for r, (a, b) in fused.FACTORED_SPLITS.items():
        assert a * b == r and {a, b} <= {2, 3, 4, 5, 7}
    text = HEADER.read_text()
    for r, (a, b) in fused.FACTORED_SPLITS.items():
        assert f"R == {r}) {{\n    dft_factored<{a}, {b}>" in text


@pytest.mark.parametrize("r", sorted(fused.FACTORED_RADICES))
def test_header_constants_are_the_rounded_f64_values(r):
    """cos and sin of 2 pi e / R rounded to float; the entries the kernel
    never reads (the quarter and half turns, which twiddle_k7 takes as
    swaps and signs) may be 0 in place of cos(pi/2)."""
    c, s = TRIG[r]
    e = np.arange(r)
    assert len(c) == len(s) == r
    np.testing.assert_allclose(c, np.cos(2 * np.pi * e / r).astype(np.float32), rtol=0, atol=2e-16)
    np.testing.assert_allclose(s, np.sin(2 * np.pi * e / r).astype(np.float32), rtol=0, atol=2e-16)


def _small_dft(y, sg):
    """csrc/factored_dft.cuh small_dft in numpy, the same steps."""
    n = len(y)
    y = list(y)
    if n == 2:
        return [y[0] + y[1], y[0] - y[1]]
    if n == 4:
        s02, d02, s13 = y[0] + y[2], y[0] - y[2], y[1] + y[3]
        r = 1j * sg * (y[1] - y[3])
        return [s02 + s13, d02 + r, s02 - s13, d02 - r]
    c, s = TRIG[n]
    h = (n - 1) // 2
    t = [y[j] + y[n - j] for j in range(1, h + 1)]
    u = [y[j] - y[n - j] for j in range(1, h + 1)]
    out = [sum(t, y[0])] + [0] * (n - 1)
    for k in range(1, h + 1):
        a = y[0] + sum(c[(j * k) % n] * t[j - 1] for j in range(1, h + 1))
        b = sum(s[(j * k) % n] * u[j - 1] for j in range(1, h + 1))
        out[k], out[n - k] = a + 1j * sg * b, a - 1j * sg * b
    return out


def _twiddle(v, e, r, sg):
    if e == 0:
        return v
    if 4 * e == r:
        return 1j * sg * v
    if 2 * e == r:
        return -v
    if 4 * e == 3 * r:
        return -1j * sg * v
    c, s = TRIG[r]
    return v * (c[e] + 1j * sg * s[e])


def _dft_k7(x, sg):
    """dft_column_k7 in numpy: the butterflies or one Cooley-Tukey step."""
    r = len(x)
    if r in (3, 5, 7):
        return np.array(_small_dft(x, sg))
    a, b = fused.FACTORED_SPLITS[r]
    z = np.zeros((a, b), dtype=np.complex128)
    for j2 in range(b):
        v = _small_dft([x[b * j1 + j2] for j1 in range(a)], sg)
        for k1 in range(a):
            z[k1, j2] = _twiddle(v[k1], j2 * k1, r, sg)
    out = np.zeros(r, dtype=np.complex128)
    for k1 in range(a):
        for k2, v in enumerate(_small_dft(list(z[k1]), sg)):
            out[k1 + a * k2] = v
    return out


@pytest.mark.parametrize("r", sorted(fused.FACTORED_RADICES))
@pytest.mark.parametrize("sg", [-1.0, 1.0], ids=DIR_IDS)
def test_factored_column_mirror_against_numpy(r, sg):
    """The kernel's factored column (sign sg = Im w_R's: -1 forward) is
    DFT_R to the float constants' rounding."""
    x = _signal(1, r, seed=r)[0].astype(np.complex128)
    want = np.fft.fft(x) if sg < 0 else np.fft.ifft(x) * r
    assert np.max(np.abs(_dft_k7(x, sg) - want)) <= 1e-6 * np.max(np.abs(want))


@pytest.mark.parametrize("r", sorted(fused.FACTORED_SPLITS))
def test_plain_factored_step_is_the_dft(r):
    """fused._factored_dft_plain (the plain mirror of one Cooley-Tukey step
    from the stage's roots) against the DFT of the same roots, in the
    layout chain_stages_plain's contraction gives."""
    for d in (FftDirection.FORWARD, FftDirection.INVERSE):
        roots = torch.from_numpy(lanepack.stage_tables(r, (r,), d)[0][0])
        u = torch.from_numpy(_signal(6, r * 4, seed=r).reshape(2, 3, r, 4))
        want = torch.einsum("jk,bljr->bklr", lanepack.dft_from_roots(roots), u)
        assert _rel(fused._factored_dft_plain(u, r, roots), want) <= 1e-6


#: one size of each factored radix the issue names, and (10, 5, 5) and (15, 5, 5)
PLAIN_SIZES = {24576: (16, 12), 98304: (16, 8, 3), 245760: (16, 6, 5), 32000: (10, 5, 5),
               48000: (15, 5, 5)}


@pytest.mark.parametrize("n", sorted(PLAIN_SIZES))
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_plain_chains_match_jax_and_oracle(n, d, rd):
    p, q = fused.choose_pq(n)
    assert PLAIN_SIZES[n] in (large.stage_radices(p), large.stage_radices(q))
    x = _signal(1, n, seed=n)
    fn = fused.make_fused_two_stage_fn(n, d, np.complex64)
    got = fn(torch.from_numpy(x)).numpy()
    ref = ref_fused.make_fused_two_stage_fn(n, rd, np.complex64, interpret=True, batch_tile=1,
                                            variant="gauss", precision="bf16x3")
    assert _rel(got, _jax_out(ref, x)) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL
    # both plain versions, the one-block and the share-by-share, agree
    c = fused.choose_cluster(n)
    tabs = _tables(p, q, d)
    assert _rel(fused.two_stage_cluster_fft_plain(torch.from_numpy(x), p, q, c, tabs),
                fused.two_stage_fft_plain(torch.from_numpy(x), p, q, tabs)) <= K7_TOL


def test_plain_chain_runs_the_factored_step(monkeypatch):
    calls = []
    real = fused._factored_dft_plain
    monkeypatch.setattr(fused, "_factored_dft_plain",
                        lambda u, r, roots: calls.append((tuple(u.shape), r)) or real(u, r, roots))
    p, q = 192, 128
    fused.two_stage_fft_plain(torch.from_numpy(_signal(1, p * q, 2)), p, q,
                              _tables(p, q, FftDirection.FORWARD))
    assert calls == [((q, 16, 12, 1), 12)]  # DFT_p's (16, 12): the second stage


@pytest.mark.parametrize("n", [261632, 40832, 28928])
def test_bluestein_forms_keep_the_chains_own_radices(n, monkeypatch):
    """A chain with a Bluestein stage runs in the kernels' Bluestein form,
    whose register radices are the in-place chain's own (261632 = (73, 7)
    x (8, 8, 8): the 7 a direct sum in registers, not the butterfly), so
    the plain version never takes the factored step there; the outer
    twiddle stays (q, p)."""
    p, q = fused.choose_pq(n)
    assert not fused.k7_factored(large.stage_radices(p), large.stage_radices(q))
    monkeypatch.setattr(fused, "k7_chain_plain", lambda *a: pytest.fail("factored chain"))
    x = torch.from_numpy(_signal(1, n, 3))
    tabs = _tables(p, q, FftDirection.FORWARD)
    got = fused.two_stage_cluster_fft_plain(x, p, q, fused.choose_cluster(n), tabs)
    assert _rel(got, host_dft(x.numpy(), FftDirection.FORWARD)) <= TOL
    assert fused.outer_transposed(p, tabs[2].numpy()) is None


# -- choose_cluster's rule and shared memory ------------------------------------------

def test_band_sizes():
    assert len(CLUSTER) == 1009 and (CLUSTER[0], CLUSTER[-1]) == (28928, 261632)
    assert len(ONE) == 112 and (ONE[0], ONE[-1]) == (14464, 28800)


def test_choose_cluster_rule_over_every_band_size():
    """The fewest blocks whose shares hold at most 16384 values; every
    size's share width q/c is even (the kernel's 16-byte loads)."""
    for n in CLUSTER:
        p, q = fused.choose_pq(n)
        c = fused.choose_cluster(n)
        assert c == next(k for k in fused.CLUSTER_SIZES
                         if q % k == 0 and fused.cluster_share(p, q, k) <= 16384)
        assert p >= c and (q // c) % 2 == 0
    sizes = {c: sum(fused.choose_cluster(n) == c for n in CLUSTER) for c in fused.CLUSTER_SIZES}
    assert sizes == {2: 30, 4: 254, 8: 337, 16: 388}


@pytest.mark.parametrize("n,c", [(28928, 2), (49152, 4), (98304, 8), (196608, 16), (245760, 16),
                                 (260608, 16), (261632, 16)])
def test_choose_cluster_at_the_paths(n, c):
    p, q = fused.choose_pq(n)
    assert fused.choose_cluster(n) == c
    if c > 2:
        assert fused.cluster_share(p, q, c // 2) > fused.CLUSTER_SHARE_MAX


def test_shared_memory_at_every_band_size():
    most = 0
    for n, one in BAND:
        if n == 16384:
            continue
        p, q = fused.choose_pq(n)
        if one:
            nbytes = fused.two_stage_smem_bytes(n, large.stage_radices(p), large.stage_radices(q))
        else:
            nbytes = fused.cluster_smem_bytes(p, q, fused.choose_cluster(n))
            most = max(most, nbytes)
        assert nbytes <= _build.SMEM_MAX
    assert most == 137672  # 506 x 512 = (23, 11, 2) x (16, 16, 2) on 16 blocks


# -- the kernels' index arithmetic ----------------------------------------------------------

def _swz(i):
    i = np.asarray(i)
    return i ^ (((i >> 4) ^ (i >> 8)) & 15)


def _place_of(k, m, radices):
    """Where the in-place chain leaves natural output k (csrc/inplace_chain.cuh
    place_of)."""
    place = 0
    for r in radices:
        m //= r
        place += (k % r) * m
        k //= r
    return place


def _dft(v, sign, axis):
    return np.fft.fft(v, axis=axis) if sign < 0 else np.fft.ifft(v, axis=axis) * v.shape[axis]


def _fold(outer, outer_pq, j2, k1):
    """w_n^(k1*j2) as OuterFoldS reads it: outer_pq[k1*q + j2] from the
    (p, q) table where it is given, else outer[j2*p + k1]."""
    if outer_pq is not None:
        return outer_pq.reshape(-1)[k1 * outer_pq.shape[1] + j2]
    return outer.reshape(-1)[j2 * outer.shape[1] + k1]


def _cluster_mirror(x, p, q, c, outer, outer_pq, sign):
    """The cluster kernel's data movement in numpy for one transform x (n,):
    block b's share by 16-byte loads (pair g = (row, col) of width qs/2 from
    x[row*q + b*qs + 2*col] into swz(2g) and swz(2g + 1)), DFT_p leaving
    output k1 of column t at prow[k1] + t times the fold, the exchange
    (element (i, j2) at swz(i*q + j2) from row lo + i, offset t of block
    j2 // qs), DFT_q leaving output k2 of row i at i*q + qcol[k2], and the
    store: 16-byte pairs (k2, col) of rows 2*col and 2*col + 1 into
    y[k2*p + lo + 2*col] where p, lo and rb are even, else one value a
    thread."""
    pr, qr = large.stage_radices(p), large.stage_radices(q)
    qs, hs = q // c, q // c // 2
    prow = np.array([_place_of(k, p, pr) * qs for k in range(p)])
    qcol = np.array([_place_of(k, q, qr) for k in range(q)])
    bufs = []
    for b in range(c):
        buf = np.zeros(-(-fused.cluster_share(p, q, c) // 16) * 16, dtype=np.complex128)
        g = np.arange(p * qs // 2)
        row, col = g // hs, g % hs
        buf[_swz(2 * g)] = x[row * q + b * qs + 2 * col]
        buf[_swz(2 * g + 1)] = x[row * q + b * qs + 2 * col + 1]
        cols = _dft(buf[_swz(np.arange(p)[:, None] * qs + np.arange(qs))], sign, 0)  # [k1, t]
        j2 = b * qs + np.arange(qs)
        cols = cols * _fold(outer, outer_pq, j2[None, :], np.arange(p)[:, None])
        buf[_swz(prow[:, None] + np.arange(qs))] = cols
        bufs.append(buf)
    y = np.zeros(p * q, dtype=np.complex128)
    for b, (lo, hi) in enumerate(fused.row_shares(p, c)):
        rb = hi - lo
        f = np.arange(rb * q)
        i, j2 = f // q, f % q
        pulled = np.array([bufs[a][s] for a, s in zip(j2 // qs, _swz(prow[lo + i] + j2 % qs))])
        buf = np.zeros_like(bufs[b])
        buf[_swz(f)] = pulled
        rows = _dft(buf[_swz(np.arange(rb)[:, None] * q + np.arange(q))], sign, 1)
        buf[_swz(np.arange(rb)[:, None] * q + qcol)] = rows
        if p % 2 == 0 and lo % 2 == 0 and rb % 2 == 0:
            g = np.arange(rb // 2 * q)
            k2, col = g // (rb // 2), g % (rb // 2)
            y[k2 * p + lo + 2 * col] = buf[_swz(2 * col * q + qcol[k2])]
            y[k2 * p + lo + 2 * col + 1] = buf[_swz((2 * col + 1) * q + qcol[k2])]
        else:
            f = np.arange(rb * q)
            k2, i = f // rb, f % rb
            y[k2 * p + lo + i] = buf[_swz(i * q + qcol[k2])]
    return y


def _one_block_mirror(x, p, q, outer, outer_pq, sign):
    """The one-block kernel's data movement in numpy: 16-byte loads (pair h
    into swz(2h), swz(2h + 1)), DFT_p and the fold, DFT_q, and the store of
    pairs k = 2h, 2h + 1 from their places, (k1 + 1, k2) or (0, k2 + 1)."""
    pr, qr = large.stage_radices(p), large.stage_radices(q)
    prow = np.array([_place_of(k, p, pr) * q for k in range(p)])
    qcol = np.array([_place_of(k, q, qr) for k in range(q)])
    buf = np.zeros(-(-p * q // 16) * 16, dtype=np.complex128)
    h = np.arange(p * q // 2)
    buf[_swz(2 * h)], buf[_swz(2 * h + 1)] = x[2 * h], x[2 * h + 1]
    cols = _dft(buf[_swz(np.arange(p)[:, None] * q + np.arange(q))], sign, 0)  # [k1, j2]
    cols = cols * _fold(outer, outer_pq, np.arange(q)[None, :], np.arange(p)[:, None])
    buf[_swz(prow[:, None] + np.arange(q))] = cols
    rows = _dft(buf[_swz(np.arange(p)[:, None] * q + np.arange(q))], sign, 1)  # [k1, k2]
    buf[_swz(np.arange(p)[:, None] * q + qcol)] = rows
    y = np.zeros(p * q, dtype=np.complex128)
    k1, k2 = (2 * h) % p, (2 * h) // p
    wrap = k1 + 1 == p
    y[2 * h] = buf[_swz(prow[k1] + qcol[k2])]
    y[2 * h + 1] = buf[_swz(prow[np.where(wrap, 0, k1 + 1)] + qcol[np.where(wrap, k2 + 1, k2)])]
    return y


@pytest.mark.parametrize("n", [24576, 14464, 28544, 28928, 32896, 245760, 260608])
@pytest.mark.parametrize("d", [FftDirection.FORWARD, FftDirection.INVERSE], ids=DIR_IDS)
def test_kernel_index_mirror_against_oracle(n, d):
    """Each kernel's indexing with the outer twiddle in the layout the path
    gives it (transposed where outer_transposed has a table), and the
    cluster kernel's also with the (q, p) table, as K8 gives it."""
    p, q = fused.choose_pq(n)
    host = fused.two_stage_tables(p, large.stage_radices(q), d)
    outer = host[2].astype(np.complex128)
    outer_pq = fused.outer_transposed(p, host[2])
    x = _signal(1, n, seed=n)[0].astype(np.complex128)
    want = host_dft(x[None], d)[0]
    sign = -1 if d is FftDirection.FORWARD else 1
    if fused.two_stage_supported(n, np.complex64):
        got = [_one_block_mirror(x, p, q, outer, outer_pq, sign)]
    else:
        c = fused.choose_cluster(n)
        got = [_cluster_mirror(x, p, q, c, outer, o, sign) for o in (outer_pq, None)]
    for g in got:
        assert _rel(g, want) <= 1e-6


# -- the wrappers -----------------------------------------------------------------------

@pytest.mark.parametrize("n,transposed", [(24576, True), (49152, True), (98304, True),
                                          (245760, True), (32000, True), (28928, False),
                                          (14464, False), (260608, False), (261632, False)])
def test_outer_transposed(n, transposed):
    """The (p, q) copy for the kernels' form without a Bluestein stage,
    none where DFT_p's chain has one (28928 = (113, 2), 261632 = (73, 7));
    the path's plan carries it as a sixth table and the wrappers refuse one
    of another shape."""
    p, q = fused.choose_pq(n)
    host = fused.two_stage_tables(p, large.stage_radices(q), FftDirection.FORWARD)
    table = fused.outer_transposed(p, host[2])
    fn = fused.make_fused_two_stage_fn(n, FftDirection.FORWARD, np.complex64)
    flat = sum(1 if isinstance(t, np.ndarray) else len(t) for t in host)
    if transposed:
        assert table.shape == (p, q) and table.flags.c_contiguous
        assert np.array_equal(table, host[2].T)
        assert len(fn.tables.host) == flat + 1
        x = torch.zeros((1, n), dtype=torch.complex64)
        outer = torch.from_numpy(host[2])
        assert fused._outer_arg(p, q, outer, torch.from_numpy(table), x, "t")[1] == 1
        with pytest.raises(ValueError, match="outer_pq"):
            fused._outer_arg(p, q, outer, outer, x, "t")
    else:
        assert table is None
        assert len(fn.tables.host) == flat


def test_cpu_tensors_never_launch():
    n = 24576
    p, q = fused.choose_pq(n)
    before = (fused.two_stage_fft.launches, fused.two_stage_cluster_fft.launches)
    x = torch.from_numpy(_signal(1, n, 1))
    tabs = _tables(p, q, FftDirection.FORWARD)
    opq = torch.from_numpy(fused.outer_transposed(p, tabs[2].numpy()))
    fused.two_stage_fft(x, p, q, tabs, opq)
    fused.two_stage_cluster_fft(x, p, q, 2, tabs, opq)
    assert (fused.two_stage_fft.launches, fused.two_stage_cluster_fft.launches) == before


# -- on the card ------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24576, 14976, 15232, 14464, 32000, 48000, 89600, 128000, 245760,
                               261632, 260608])
def test_kernels_on_card(cuda_device, n):
    """Every factored radix (12, 9 and 7 on the one-block band, 10, 15, 14
    and 20, 6 and 5) and the Bluestein forms (14464, 261632 = (73, 7),
    260608) within 1e-6 of the plain version, at batch 1, 3 and 33, with
    the outer twiddle in both layouts where the path transposes it."""
    p, q = fused.choose_pq(n)
    c = fused.choose_cluster(n)
    one = fused.two_stage_supported(n, np.complex64)
    counter = fused.two_stage_fft if one else fused.two_stage_cluster_fft
    for batch in (1, 3, 33):
        x = torch.from_numpy(_signal(batch, n, n)).to(cuda_device)
        for d, _ in DIRECTIONS:
            tabs = _tables(p, q, d, cuda_device)
            opq = fused.outer_transposed(p, tabs[2].cpu().numpy())
            want = fused.two_stage_fft_plain(x, p, q, tabs).cpu()
            for o in {None, None if opq is None else torch.from_numpy(opq).to(cuda_device)}:
                before = counter.launches
                got = (fused.two_stage_fft(x, p, q, tabs, o) if one
                       else fused.two_stage_cluster_fft(x, p, q, c, tabs, o))
                torch.cuda.synchronize()
                assert counter.launches == before + 1
                assert _rel(got.cpu(), want) <= K7_TOL


@pytest.mark.cuda
def test_attrs_on_card(cuda_device):
    """Every form stays within 128 registers at 512 threads (one block an SM)."""
    for one_block in (False, True):
        for bluestein in (False, True):
            regs, _ = fused.two_stage_attrs(bluestein, one_block)
            assert regs <= 128
