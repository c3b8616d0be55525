"""The one-pass convolution core's chain form (csrc/conv.cu conv_chain_kernel,
ops/kernels/conv.py conv_chain_fft) on the CPU.

A numpy mirror of the kernel's indexing (units of chain_unit(m)
transforms in padded regions, the columns split into (t, hi, lo) through
fdiv's reciprocals, chain 1's digit-reversed places, h in those places,
chain 2 on the reversed digits with its twiddles by hi, the ragged pad and
store) against np.fft in float64; the wrapper's plain version against
conv_fft_plain; the host rules (chain_radices, the h table, the tables'
split, make_conv_fn's choice); and, marked `cuda` (skipped without a card),
the kernel against its plain version.  The JAX kernels at 2063 and 2531
are in tests/test_torch_prime.py.
"""
import math
import re

import numpy as np
import pytest
import torch

from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import _build, conv, lanepack

DIRECTIONS = [FftDirection.FORWARD, FftDirection.INVERSE]
DIR_IDS = ["fwd", "inv"]

#: the mirror's inner lengths: 256 (16 transforms a unit), 270 = 9 x 6 x 5
#: (odd register radices), the prime paths' 1008 (four a unit), 2530 (direct
#: sums of 23 and 11), 3072, 6144 and 8192 (four register stages), 1296 and
#: 2048
MIRROR_MS = (256, 270, 1008, 1296, 2048, 2530, 3072, 6144, 8192)

#: the mirror in float64 from the complex64 tables against np.fft in float64:
#: the tables' rounding (about 6e-8 an entry) through two chains and h
MIRROR_TOL = 1e-6
#: two f32 computations of the same function on different chains
PLAIN_TOL = 1e-5


def _signal(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(
        np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _fdiv(c, d):
    """csrc/conv.cu fdiv: c / d as umulhi(c, ceil(2^32 / d)), c at d = 1."""
    if d == 1:
        return c
    mg = (2 ** 32 + d - 1) // d
    return (c.astype(np.uint64) * np.uint64(mg)) >> np.uint64(32)


def _pad16(v):
    return -(-v // 16) * 16


def _cc_pad(e):
    """csrc/conv.cu cc_pad: value e's place, one pad every 16 values."""
    return e + (e >> 4)


def _mirror(x, radices, tables, n_out, conj_out):
    """The kernel on x (batch, n_in), unit by unit, in float64."""
    roots, tws1, tws2, h, pre, post = (None if t is None else
                                       [np.asarray(a, np.complex128) for a in t]
                                       if isinstance(t, list) else np.asarray(t, np.complex128)
                                       for t in tables)
    m = math.prod(radices)
    k = len(radices)
    T, msp = conv.chain_unit(m), _cc_pad(_pad16(m))
    batch, n_in = x.shape
    weights = conv.chain_weights(radices)
    y = np.zeros((batch, n_out), np.complex128)
    for b0 in range(0, batch, T):
        tn = min(T, batch - b0)
        buf = np.full(T * msp, np.nan, np.complex128)  # the pad is never read
        for t in range(tn):
            buf[t * msp + _cc_pad(np.arange(n_in))] = x[b0 + t]

        def stage(s, first, out, tw, rest):
            r, w, per = radices[s], weights[s], m // radices[s]
            c = np.arange(tn * per)
            t = _fdiv(c, per).astype(np.int64)
            rem = c - t * per
            hi = _fdiv(rem, w).astype(np.int64)
            lo = rem - hi * w
            e = (hi * r * w + lo)[:, None] + np.arange(r)[None, :] * w  # (cols, r)
            at = t[:, None] * msp + _cc_pad(e)
            v = buf[at]
            if first:
                v = np.where(e < n_in, v * (1 if pre is None else pre[np.minimum(e, m - 1)]), 0)
            dft = roots[s][(np.arange(r)[:, None] * np.arange(r)[None, :]) % r]
            v = v @ dft  # output k of each column
            if out == "store":
                if conj_out:
                    v = np.conj(v)
                if post is not None:
                    v = v * post[e]
                keep = e < n_out
                y[b0 + np.broadcast_to(t[:, None], e.shape)[keep], e[keep]] = v[keep]
                return
            if out == "h":
                v = np.conj(v * h[e])
            elif tw is not None:
                col = hi if out == "tw_hi" else lo
                v = v * tw[np.arange(r)[None, :] * rest + col[:, None]]
            buf[at] = v

        for s in range(k):
            last = s == k - 1
            stage(s, s == 0, "h" if last else "tw_lo", None if last else tws1[s].reshape(-1),
                  weights[s])
        for t in range(k):
            s, last = k - 1 - t, t == k - 1
            stage(s, False, "store" if last else "tw_hi",
                  None if last else tws2[t].reshape(-1), m // (radices[s] * weights[s]))
    return y


def _host_tables(m, radices, d, n_in, n_out, with_tables, seed):
    rng = np.random.default_rng(seed)
    roots, tws1, tws2 = conv.double_chain_tables(m, radices, d)
    h = (rng.standard_normal(m) + 1j * rng.standard_normal(m)).astype(np.complex64)
    pre = post = None
    if with_tables:
        pre = np.zeros(m, np.complex64)
        pre[:n_in] = rng.standard_normal(n_in) + 1j * rng.standard_normal(n_in)
        post = np.zeros(m, np.complex64)
        post[:n_out] = rng.standard_normal(n_out) + 1j * rng.standard_normal(n_out)
    return roots, tws1, tws2, h, pre, post


def _fft(u, d):
    """The f64 transform in the chains' direction, unnormalized."""
    return np.fft.fft(u, axis=-1) if d is FftDirection.FORWARD else np.fft.ifft(u, axis=-1) * u.shape[-1]


def _definition(x, m, h, pre, post, n_out, conj_out, d):
    v = np.zeros((x.shape[0], m), np.complex128)
    v[:, : x.shape[1]] = x
    if pre is not None:
        v = v * pre
    out = _fft(np.conj(_fft(v, d) * h), d)[:, :n_out]
    if conj_out:
        out = np.conj(out)
    if post is not None:
        out = out * post[:n_out]
    return out


@pytest.mark.parametrize("m", MIRROR_MS)
@pytest.mark.parametrize("d", DIRECTIONS, ids=DIR_IDS)
def test_mirror_of_the_kernel_matches_the_definition(m, d):
    """The kernel's indexing in numpy at each m, tables on (a ragged n_in and
    n_out, conj) and off, over a batch that leaves the last unit ragged."""
    radices = conv.chain_radices(m)
    assert radices is not None and math.prod(radices) == m
    T = conv.chain_unit(m)
    batch = T + 1 if T > 1 else 2
    for with_tables, n_in, n_out in ((False, m, m), (True, m // 2 + 3, m // 3 + 1)):
        roots, tws1, tws2, h, pre, post = _host_tables(m, radices, d, n_in, n_out, with_tables,
                                                       seed=m)
        x = _signal(batch, n_in, seed=m + n_in)
        tables = (roots, tws1, tws2, conv.chain_h_table(h, radices), pre, post)
        got = _mirror(x, radices, tables, n_out, with_tables)
        want = _definition(x.astype(np.complex128), m, h.astype(np.complex128),
                           None if pre is None else pre.astype(np.complex128),
                           None if post is None else post.astype(np.complex128),
                           n_out, with_tables, d)
        assert _rel(got, want) <= MIRROR_TOL, (m, with_tables)


def test_fdiv_is_exact_over_the_domain():
    """fdiv's reciprocal gives c // d for every column c < T * m and divisor
    (m / r_s or W_s) of every chain the form runs."""
    seen = set()
    for m in range(2, 16385):
        radices = conv.chain_radices(m)
        if radices is None:
            continue
        T = conv.chain_unit(m)
        for r, w in zip(radices, conv.chain_weights(radices)):
            for d in (m // r, w):
                if (T * m, d) in seen:
                    continue
                seen.add((T * m, d))
                c = np.arange(0, T * m, dtype=np.int64)
                assert np.array_equal(_fdiv(c, d), c // d), (m, d)
        assert T * _pad16(m) * m < 2 ** 32


@pytest.mark.parametrize("m,n_in,n_out", [(1008, 1008, 1000), (3072, 1234, 1234),
                                          (2530, 2530, 2530), (270, 200, 141), (8192, 3083, 3083)])
@pytest.mark.parametrize("d", DIRECTIONS, ids=DIR_IDS)
def test_plain_version_matches_conv_fft_plain(m, n_in, n_out, d):
    """conv_chain_fft on CPU tensors (its plain version) against conv_fft's on
    the tile chain, with pre, post and conj on and off."""
    radices = conv.chain_radices(m)
    tile = lanepack.tile_radices(m)
    x = torch.from_numpy(_signal(3, n_in, seed=m + 7))
    for with_tables, conj_out in ((False, False), (True, True), (True, False)):
        roots, tws1, tws2, h, pre, post = _host_tables(m, radices, d, n_in, n_out, with_tables,
                                                       seed=m + 1)
        on = [None if t is None else torch.from_numpy(t) for t in (h, pre, post)]
        chain = ([torch.from_numpy(a) for a in roots], [torch.from_numpy(a) for a in tws1],
                 [torch.from_numpy(a) for a in tws2],
                 torch.from_numpy(conv.chain_h_table(h, radices)), on[1], on[2])
        got = conv.conv_chain_fft(x, radices, chain, n_out, conj_out)
        r2, t2 = lanepack.stage_tables(m, tile, d)
        want = conv.conv_fft_plain(x, m, tile, ([torch.from_numpy(a) for a in r2],
                                                [torch.from_numpy(a) for a in t2], *on),
                                   n_out, conj_out)
        assert got.shape == (3, n_out)
        assert _rel(got.numpy(), want.numpy()) <= PLAIN_TOL


def test_chain_radices_none_exactly_where_a_bluestein_stage_is_needed():
    """Over the one-pass core's domain: the chain form takes choose_radices(m)
    wherever no radix of it needs a Bluestein stage and its two padded
    buffers fit a block, and nothing else; every radix it takes is one the
    kernel compiles.  The buffers leave out 51 lengths from 13650 up (no
    inner length of a prime below 8192), which conv_fft keeps."""
    taken, too_long = 0, []
    for m in range(2, 16385):
        if not conv.conv_supported(m, np.complex64):
            assert conv.chain_radices(m) is None
            continue
        chain = lanepack.choose_radices(m)
        bluestein = any(lanepack.bluestein_stage_m(r) for r in chain)
        fits = conv.chain_smem_bytes(m, chain, m, m, False, False, False) <= _build.SMEM_MAX
        got = conv.chain_radices(m)
        assert (got is None) == (bluestein or not fits), m
        if got is not None:
            taken += 1
            assert got == chain and set(got) <= conv.CHAIN_RADICES
        elif not bluestein:
            too_long.append(m)
    assert taken == 7324 - 5668 - 51
    assert len(too_long) == 51 and min(too_long) == 13650


def test_kernel_compiles_the_radices_of_the_rule():
    """csrc/conv.cu's radix cases (cc_with_radix) are CHAIN_RADICES, the
    register radices those of its form without the direct sums, and
    chain_big names the chains that need the other form."""
    src = (_build.SRC_DIR / "conv.cu").read_text()
    body = src[src.index("static __device__ __forceinline__ void cc_with_radix("):]
    body = body[:body.index("\n}\n")]
    small, big = body.split("if constexpr (kBig)")
    cases = [{int(v) for v in re.findall(r"case (\d+): f\(CcRadix<(?:\d+)>", part)}
             for part in (small, big)]
    assert cases[0] == set(lanepack.REGISTER_RADICES)
    assert cases[0] | cases[1] == set(conv.CHAIN_RADICES)
    assert conv.chain_big((23, 11, 5, 2)) and not conv.chain_big((16, 16, 4, 3))


@pytest.mark.parametrize("m", MIRROR_MS)
def test_h_table_is_a_permutation_of_h(m):
    """h in chain 1's output positions holds every entry of h once, bit for
    bit, entry pos the frequency chain_positions gives."""
    radices = conv.chain_radices(m)
    h = _signal(1, m, seed=m)[0]
    table = conv.chain_h_table(h, radices)
    pos = conv.chain_positions(radices)
    assert np.array_equal(np.sort(pos), np.arange(m))
    assert np.array_equal(table.view(np.uint64), h[pos].view(np.uint64))
    back = np.empty_like(table)
    back[pos] = table
    assert np.array_equal(back.view(np.uint64), h.view(np.uint64))
    # the numpy construction: the chain's digits as a C-order array read in Fortran order
    pos_of_k = np.arange(m).reshape(radices).reshape(-1, order="F")
    assert np.array_equal(pos, np.argsort(pos_of_k))


#: the SMs of an H100 and, for each of them, the shared memory (bytes), what
#: a block reserves of it, and the chain form's block caps by kernel form
#: (csrc/conv.cu cc_form_blocks)
H100_SMS, SM_SMEM, BLOCK_RESERVED, FORM_BLOCKS = 132, 233472, 1024, (3, 2)


def _per_sm(form, smem):
    return min(FORM_BLOCKS[form], SM_SMEM // (smem + BLOCK_RESERVED))


def _h100_resident(device_index, form, smem):
    """A model of conv.chain_resident on an H100 (held against the card by
    test_chain_resident_matches_the_h100_model), which refuses a block
    larger than a block's shared memory as the card's does."""
    if not 0 < smem <= _build.SMEM_MAX:
        raise RuntimeError(f"conv_chain resident blocks: smem={smem} (invalid argument)")
    return H100_SMS * _per_sm(form, smem)


def test_tables_in_shared_memory_where_they_cost_no_block(monkeypatch):
    """h, pre and post stay on chip where the blocks the device holds do
    not drop for them: at 2530 (2 blocks an SM either way) and 256 (3), not
    at 1008 and 3072 (2 with them, 3 without), 6144 (1, 2) and 8192 (they
    do not fit a block; 1 without); the chains with direct sums run their
    own form."""
    monkeypatch.setattr(conv, "chain_resident", _h100_resident)
    for m, n_io, tables, want, form, blocks in ((1008, 1008, False, False, 0, (2, 3)),
                                                (3072, 1234, True, False, 0, (2, 3)),
                                                (2530, 2530, False, True, 1, (2, 2)),
                                                (256, 256, False, True, 0, (3, 3)),
                                                (6144, 2063, True, False, 0, (1, 2)),
                                                (8192, 3083, True, False, 0, (0, 1))):
        radices = conv.chain_radices(m)
        assert conv.chain_kernel_form(radices) == form, m
        assert conv.chain_tables_smem(0, m, radices, n_io, n_io, tables, tables) is want, m
        per_sm = tuple(_per_sm(form, conv.chain_smem_bytes(m, radices, n_io, n_io, tables,
                                                           tables, t)) for t in (True, False))
        assert per_sm == blocks, m


@pytest.mark.parametrize("m", [1008, 3072, 616, 12288, 464, 1160])
def test_make_conv_fn_takes_the_form_the_rule_gives(m, monkeypatch):
    """make_conv_fn launches the chain form (its ChainCore) where
    chain_radices(m) holds and conv_fft elsewhere (464 = 29 x 16 and 1160 =
    29 x 8 x 5 need a Bluestein stage), with the same result."""
    calls = []
    for owner, name in ((conv, "conv_fft"), (conv.ChainCore, "__call__")):
        orig = getattr(owner, name)
        monkeypatch.setattr(owner, name, lambda *a, _o=orig, _n=name, **k: calls.append(_n) or
                            _o(*a, **k))
    rng = np.random.default_rng(m)
    h = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    x = torch.from_numpy(_signal(2, m, seed=m))
    got = conv.make_conv_fn(m, FftDirection.FORWARD, np.complex64, h=h)(x)
    want = _definition(x.numpy().astype(np.complex128), m, h, None, None, m, False,
                       FftDirection.FORWARD)
    assert calls == ["__call__" if conv.chain_radices(m) else "conv_fft"]
    assert (conv.chain_radices(m) is None) == (m in (464, 1160))
    assert _rel(got.numpy(), want) <= PLAIN_TOL


def test_wrapper_checks_its_operands():
    m, radices = 1008, conv.chain_radices(1008)
    roots, tws1, tws2, h, _, _ = _host_tables(m, radices, FftDirection.FORWARD, m, m, False, 1)
    tables = ([torch.from_numpy(a) for a in roots], [torch.from_numpy(a) for a in tws1],
              [torch.from_numpy(a) for a in tws2], torch.from_numpy(h), None, None)
    x = torch.from_numpy(_signal(2, m, seed=1))
    with pytest.raises(ValueError):
        conv.conv_chain_fft(x, (16, 9, 7, 1), tables, m)
    with pytest.raises(ValueError):
        conv.conv_chain_fft(x, radices, tables, m + 1)
    with pytest.raises(ValueError):
        conv.conv_chain_fft(x, radices, (tables[0], tables[1], tables[2][:1], *tables[3:]), m)
    with pytest.raises(ValueError):
        conv.conv_chain_fft(x, (29, 29), tables, m)


def test_chain_core_checks_its_tables_once_and_each_input():
    """ChainCore checks its tables when it is made and each x it is called
    on (shape, dtype, device), and computes what conv_chain_fft does."""
    m, radices = 3072, conv.chain_radices(3072)
    n = 1234
    roots, tws1, tws2, h, pre, post = _host_tables(m, radices, FftDirection.INVERSE, n, n, True,
                                                   seed=5)
    tables = ([torch.from_numpy(a) for a in roots], [torch.from_numpy(a) for a in tws1],
              [torch.from_numpy(a) for a in tws2],
              torch.from_numpy(conv.chain_h_table(h, radices)), torch.from_numpy(pre),
              torch.from_numpy(post))
    with pytest.raises(ValueError):
        conv.ChainCore(radices, (tables[0], tables[1][:1], *tables[2:]), n, n)
    with pytest.raises(ValueError):
        conv.ChainCore(radices, tables, m + 1, n)
    core = conv.ChainCore(radices, tables, n, n, True)
    x = torch.from_numpy(_signal(3, n, seed=6))
    want = conv.conv_chain_fft(x, radices, tables, n, True)
    for _ in range(2):
        assert torch.equal(core(x), want)
    with pytest.raises(ValueError):
        core(x[:, :-1].contiguous())
    with pytest.raises(TypeError):
        core(x.to(torch.complex128))
    with pytest.raises(ValueError):
        core(x[0])
    with pytest.raises(ValueError):
        core(torch.empty((3, n), dtype=torch.complex64, device="meta"))


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m", [256, 1008, 2530, 3072, 6144, 8192])
def test_chain_kernel_matches_its_plain_version_on_the_card(m):
    """conv_chain_fft on the card within 1e-6 of its plain version, both
    directions, tables on and off, at batch 1, a batch that leaves the
    persistent walk ragged and 2049 transforms."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    radices = conv.chain_radices(m)
    T = conv.chain_unit(m)
    for d in DIRECTIONS:
        for with_tables in (False, True):
            n_in = n_out = m if not with_tables else m // 2 + 5
            roots, tws1, tws2, h, pre, post = _host_tables(m, radices, d, n_in, n_out,
                                                           with_tables, seed=m)
            tables = ([torch.from_numpy(a).to(dev) for a in roots],
                      [torch.from_numpy(a).to(dev) for a in tws1],
                      [torch.from_numpy(a).to(dev) for a in tws2],
                      torch.from_numpy(conv.chain_h_table(h, radices)).to(dev),
                      None if pre is None else torch.from_numpy(pre).to(dev),
                      None if post is None else torch.from_numpy(post).to(dev))
            for batch in (1, 3 * T + 1, 2049):
                x = torch.from_numpy(_signal(batch, n_in, seed=batch)).to(dev)
                got = conv.conv_chain_fft(x, radices, tables, n_out, with_tables)
                torch.cuda.synchronize()
                want = conv.conv_chain_fft_plain(x, radices, tables, n_out, with_tables)
                assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= 1e-6, (m, batch, d)


@pytest.mark.cuda
def test_chain_resident_matches_the_h100_model():
    """chain_resident on an H100 is _h100_resident, the model the CPU test
    of chain_tables_smem runs, at the block sizes of the prime paths."""
    if not torch.cuda.is_available() or "H100" not in torch.cuda.get_device_name(0):
        pytest.skip("needs an NVIDIA H100")
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, n_io, tables in ((1008, 1008, False), (3072, 1234, True), (2530, 2530, False),
                            (256, 256, False), (6144, 2063, True), (8192, 3083, True)):
        radices = conv.chain_radices(m)
        form = conv.chain_kernel_form(radices)
        for on_chip in (True, False):
            smem = conv.chain_smem_bytes(m, radices, n_io, n_io, tables, tables, on_chip)
            if smem > _build.SMEM_MAX:
                continue
            assert conv.chain_resident(dev, form, smem) == _per_sm(form, smem) * sms, (
                m, on_chip)
