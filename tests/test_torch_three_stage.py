"""K8 (three_stage_fft) over its whole domain, held against the JAX package.

K8's split rule against the JAX package's (the same 50 sizes, 16384 k for
k = 1 .. 50, all at p = 128), the card's form at every size
(fused.three_stage_form: K9's body at R = 1 at 16384, K7's cluster kernel
on c = 2 .. 16 blocks up to 262144, K2's and K3's stages above), each
form's plain counterpart fed the card's tables against the plain version
(the JAX body's (q1, q2) chain; relative mean error <= 1e-6: the same
DFT by another split of q, rounded in another order), and the plain
version and make_fused_three_stage_fn against the JAX kernel in Pallas
interpret mode and the f64 oracle at 32768 (128, 16, 16) and 49152 (128,
16, 24), both directions (<= 1e-5).  The kernels on the card are held
against the plain version in tests/test_torch_card_k8_k11.py.
"""
import numpy as np
import pytest
import torch

from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import fused as ref_fused
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import fused, large
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
TOL = 1e-5
#: the card's forms against the plain version (same function, other rounding)
FORM_TOL = 1e-6

#: K8's domain: the JAX rule admits these 50 sizes and no other
DOMAIN = [16384 * k for k in range(1, 51)]


def _signal(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _tables(p, q1, q2, d):
    return tuple([torch.from_numpy(a) for a in t] if isinstance(t, list) else torch.from_numpy(t)
                 for t in fused.three_stage_tables(p, q1, q2, d))


# -- the domain and the forms ------------------------------------------------

@pytest.mark.parametrize("lo", range(0, 1 << 20, 1 << 18))
def test_split_rule_equals_jax(lo):
    """Every multiple of 1024 below 2^20, and every multiple of 16384 up to
    2^21: the same splits, so the same domain."""
    sizes = list(range(lo + 1024, lo + (1 << 18) + 1, 1024))
    if lo == 0:
        sizes += list(range(1 << 20, (1 << 21) + 1, 16384))
    for n in sizes:
        assert fused.choose_pqq_fused(n) == ref_fused.choose_pqq_fused(n), n
        assert (fused.three_stage_supported(n, np.complex64)
                == ref_fused.three_stage_supported(n, np.complex64)), n
        assert not fused.three_stage_supported(n, np.complex128)


def test_domain_is_fifty_sizes_at_p_128():
    sizes = [n for n in range(128, (1 << 21) + 1, 128)
             if fused.three_stage_supported(n, np.complex64)]
    assert sizes == DOMAIN
    assert all(fused.choose_pqq_fused(n)[0] == 128 for n in DOMAIN)
    assert fused.choose_pqq_fused(16384) == (128, 8, 16)
    assert fused.choose_pqq_fused(262144) == (128, 32, 64)
    assert fused.choose_pqq_fused(819200) == (128, 80, 80)


def test_form_at_every_size():
    """A form exactly where three_stage_supported holds; the cluster sizes
    of K7's rule; each c divides p and q and its shares fit
    CLUSTER_SHARE_MAX; DFT_q as at most three radices."""
    want_c = {2: [32768], 4: [49152, 65536], 8: [16384 * k for k in range(5, 9)],
              16: [16384 * k for k in range(9, 17)]}
    got_c = {}
    for n in DOMAIN:
        form = fused.three_stage_form(n)
        p, q1, q2 = fused.choose_pqq_fused(n)
        q = q1 * q2
        assert form is not None, n
        assert 1 <= len(large.stage_radices(q)) <= 3
        kind, c = form
        if n == 16384:
            assert form == ("radix", 1) and large.stage_radices(q) == (16, 8)
        elif n <= 262144:
            assert kind == "cluster" and c == fused.choose_cluster(n, (p, q))
            assert p % c == 0 and q % c == 0
            assert fused.cluster_share(p, q, c) <= fused.CLUSTER_SHARE_MAX
            assert fused.cluster_smem_bytes(p, q, c) <= 232448
            got_c.setdefault(c, []).append(n)
        else:
            assert form == ("two_pass", 0)
            assert large.col_tile(p, q) is not None and large.row_tile(q, p) is not None
    assert got_c == want_c
    assert large.stage_radices(2048) == (16, 16, 8)
    for n in (8192, 20480, 16384 * 51, 1 << 21, 16384 * 64):
        assert not fused.three_stage_supported(n, np.complex64)
        assert fused.three_stage_form(n) is None


# -- the card's forms on the CPU -----------------------------------------------

def _card_form_plain(x, p, q1, q2, tables):
    """three_stage_fft's card form at (p, q1*q2) through the plain version
    of the kernel it launches, on the card's tables."""
    q = q1 * q2
    roots_p, tws_p, outer = tables[:3]
    card = (roots_p, tws_p, outer) + tuple(tables[5:])
    kind, c = fused.three_stage_form(p * q, (p, q1, q2))
    if kind == "radix":
        return fused.two_stage_fft_plain(x, p, q, card)
    if kind == "cluster":
        return fused.two_stage_cluster_fft_plain(x, p, q, c, card)
    a = large.large_col_stage_plain(x, p, q, card[:3])
    return large.large_row_stage_plain(a, q, p, card[3:]).reshape(x.shape)


@pytest.mark.parametrize("n", [16384, 32768, 49152, 131072, 147456, 262144, 278528, 393216,
                               819200])
def test_card_forms_compute_the_plain_function(n):
    """Each form's kernel, as its plain version on the card's tables, gives
    three_stage_fft_plain's DFT: radix (16384), clusters of 2, 4, 8 and 16,
    and K2's and K3's stages (278528: a radix-17 stage; 819200)."""
    p, q1, q2 = fused.choose_pqq_fused(n)
    x = torch.from_numpy(_signal(1, n, seed=n // 16384))
    for d, _ in DIRECTIONS:
        tabs = _tables(p, q1, q2, d)
        want = fused.three_stage_fft_plain(x, p, q1, q2, tabs)
        got = _card_form_plain(x, p, q1, q2, tabs)
        assert _rel(got, want) <= FORM_TOL
        assert _rel(got, host_dft(x.numpy(), d)) <= TOL


def test_tables_carry_both_chains():
    p, q1, q2 = 128, 16, 24
    q = q1 * q2
    for d, _ in DIRECTIONS:
        host = fused.three_stage_tables(p, q1, q2, d)
        assert len(host) == 7
        two = fused.two_stage_tables(p, (q1, q2), d)
        for got, want in zip(host[:5], two):
            if isinstance(want, list):
                assert all(np.array_equal(a, b) for a, b in zip(got, want))
            else:
                np.testing.assert_array_equal(got, want)
        roots, tws = large.row_tables(q, d)
        assert [r.shape for r in host[5]] == [(r,) for r in large.stage_radices(q)] == \
            [r.shape for r in roots]
        assert [t.shape for t in host[6]] == [t.shape for t in tws]


def test_wrapper_rejects_bad_tables_and_counts_no_cpu_launch():
    p, q1, q2 = 128, 16, 16
    n = p * q1 * q2
    x = torch.from_numpy(_signal(2, n, 5))
    tabs = _tables(p, q1, q2, FftDirection.FORWARD)
    with pytest.raises(ValueError):
        fused.three_stage_fft(x, p, q1, q2, tabs[:5])  # the card's chain is missing
    with pytest.raises(ValueError):
        fused.three_stage_fft(x, p, q1, q2, tabs[:5] + (tabs[6], tabs[5]))
    bad = _tables(p, 16, 32, FftDirection.FORWARD)  # the chain of another q
    with pytest.raises(ValueError):
        fused.three_stage_fft(x, p, q1, q2, tabs[:5] + bad[5:])
    before = fused.three_stage_fft.launches
    fused.three_stage_fft(x, p, q1, q2, tabs)
    assert fused.three_stage_fft.launches == before


# -- against the JAX package ----------------------------------------------------

@pytest.mark.parametrize("n,split", [(32768, (128, 16, 16)), (49152, (128, 16, 24))],
                         ids=["32768", "49152"])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_three_stage_matches_jax_and_oracle(n, split, d, rd):
    """The plain version (through make_fused_three_stage_fn) against the
    JAX kernel in interpret mode at f32 HIGHEST (precision "bf16x3") and
    the oracle."""
    assert fused.choose_pqq_fused(n) == split
    p, q1, q2 = split
    x = _signal(2, n, seed=n + 3)
    got = fused.make_fused_three_stage_fn(n, d, np.complex64)(torch.from_numpy(x)).numpy()
    ref = ref_fused.make_fused_three_stage_fn(n, rd, np.complex64, split=split, interpret=True,
                                              batch_tile=1, precision="bf16x3")
    o_r, o_i = ref((x.real.copy(), x.imag.copy()))
    want = np.asarray(o_r) + 1j * np.asarray(o_i)
    assert got.shape == x.shape
    assert _rel(got, want) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL
    plain = fused.three_stage_fft_plain(torch.from_numpy(x), p, q1, q2, _tables(p, q1, q2, d))
    assert _rel(plain, want) <= TOL
