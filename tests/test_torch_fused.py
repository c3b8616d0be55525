"""The one-pass mid band (K7, K8, K9) held against the JAX package.

The port's radix, two-stage and three-stage kernels (their plain torch
versions on the CPU) against the JAX kernels of rustfft_tpu/ops/pallas/
fused.py in Pallas interpret mode, both directions, and the f64 oracle:
relative mean error <= 1e-5 against either.  The JAX factories get
precision="bf16x3", which interpret mode resolves to f32 HIGHEST (the
kernels then sit ~4e-7 from the oracle); its default bf16x3s tier sits
~8e-6 from it, too close to the bound to be the comparison.  The tests
marked `cuda` hold each kernel against its plain version on the card and
skip without a GPU.
"""
import numpy as np
import pytest
import torch

import rustfft_tpu
from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.executor import pallas_route
from rustfft_tpu.ops import bluestein as ref_bluestein
from rustfft_tpu.ops.pallas import fused as ref_fused
from rustfft_tpu_torch import FftPlanner, executor, route
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import fused, lanepack, large
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
FWD, INV = DIRECTIONS
TOL = 1e-5
#: the sizes the one-block two-stage route serves: multiples of 128 from
#: 14464 (one above lanepack's two-buffer edge) to 28800 (the last whose
#: transform and roots fit one block's shared memory in place)
ONE_BLOCK = list(range(14464, 28801, 128))


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


def _counts():
    return (fused.radix_fft.launches, fused.two_stage_fft.launches,
            fused.three_stage_fft.launches)


def _check(got, ref_fn, x, d):
    assert got.shape == x.shape
    assert _rel(got, _jax_out(ref_fn, x)) <= TOL
    assert _rel(got, host_dft(x, d)) <= TOL


# -- the kernels against the JAX package and the oracle ---------------------

@pytest.mark.parametrize("n,d,rd", [(32768, *FWD), (32768, *INV), (65536, *FWD), (65536, *INV),
                                    (131072, *FWD), (262144, *FWD)],
                         ids=["2^15-fwd", "2^15-inv", "2^16-fwd", "2^16-inv", "2^17-fwd", "2^18-fwd"])
def test_radix_matches_jax_ctwgx_and_oracle(n, d, rd):
    """Every r (2, 4, 8, 16) against the JAX default variant, ctwgx."""
    x = _signal(1, n, seed=n + 1)
    got = fused.make_fused_radix_fn(n, d, np.complex64)(torch.from_numpy(x))
    ref = ref_fused.make_fused_radix_fn(n, rd, np.complex64, interpret=True, batch_tile=1,
                                        variant="ctwgx", precision="bf16x3")
    _check(got, ref, x, d)


@pytest.mark.parametrize("variant", ["default", "ctw", "ctwg", "ctwgn"])
def test_radix_matches_the_other_jax_variants(variant):
    """The four earlier radix bodies compute the same function (65536)."""
    n = 65536
    x = _signal(2, n, seed=7)
    got = fused.make_fused_radix_fn(n, FftDirection.FORWARD, np.complex64)(torch.from_numpy(x))
    ref = ref_fused.make_fused_radix_fn(n, RefDirection.FORWARD, np.complex64, interpret=True,
                                        batch_tile=1, variant=variant, precision="bf16x3")
    _check(got, ref, x, FftDirection.FORWARD)


@pytest.mark.parametrize("n", [16384, 20480, 24576])
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_two_stage_matches_jax_gauss_and_oracle(n, d, rd):
    x = _signal(2, n, seed=n)
    got = fused.make_fused_two_stage_fn(n, d, np.complex64)(torch.from_numpy(x))
    ref = ref_fused.make_fused_two_stage_fn(n, rd, np.complex64, interpret=True, batch_tile=1,
                                            variant="gauss", precision="bf16x3")
    _check(got, ref, x, d)


@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_three_stage_matches_jax_and_oracle(d, rd):
    n, split = 16384, (128, 8, 16)
    assert fused.choose_pqq_fused(n) == split
    x = _signal(2, n, seed=3)
    got = fused.make_fused_three_stage_fn(n, d, np.complex64, split=split)(torch.from_numpy(x))
    ref = ref_fused.make_fused_three_stage_fn(n, rd, np.complex64, split=split, interpret=True,
                                              batch_tile=1, precision="bf16x3")
    _check(got, ref, x, d)


@pytest.mark.parametrize("split", [(2, 16, 16), (16, 8, 8)], ids=["r2-p16", "r16-p8"])
def test_radix_plain_at_scaled_splits(split):
    """The plain radix chain at small p == q (the card's kernel takes 128)."""
    r, p, q = split
    n = r * p * q
    x = _signal(3, n, seed=r)
    for d, _ in DIRECTIONS:
        got = fused.make_fused_radix_fn(n, d, np.complex64, split=split)(torch.from_numpy(x))
        assert _rel(got, host_dft(x, d)) <= TOL


@pytest.mark.parametrize("n", [14464, 28800])
def test_two_stage_band_edges_against_the_oracle(n):
    """The band's edges: p = 113 (a roots-table stage) and p = 225."""
    x = _signal(2, n, seed=n)
    for d, _ in DIRECTIONS:
        got = fused.make_fused_two_stage_fn(n, d, np.complex64)(torch.from_numpy(x))
        assert _rel(got, host_dft(x, d)) <= TOL


# -- the whole path through the public entry ----------------------------------

@pytest.mark.parametrize("n,route_name", [(16384, "two_stage"), (65536, "radix")])
def test_mid_band_through_the_planner(n, route_name):
    assert route(n, np.complex64) == route_name
    planner = FftPlanner(np.complex64, device="cpu")
    ref_planner = rustfft_tpu.FftPlanner(np.complex64)  # Pallas off on the CPU
    x = _signal(2, n, seed=n + 5)
    before = _counts()
    for plan, ref_plan, d in ((planner.plan_fft_forward(n), ref_planner.plan_fft_forward(n),
                               FftDirection.FORWARD),
                              (planner.plan_fft_inverse(n), ref_planner.plan_fft_inverse(n),
                               FftDirection.INVERSE)):
        got = plan.process(x)
        assert isinstance(got, np.ndarray) and got.dtype == np.complex64 and got.shape == x.shape
        assert _rel(got, np.asarray(ref_plan.process(x))) <= TOL
        assert _rel(got, host_dft(x, d)) <= TOL
    assert _counts() == before  # CPU tensors never launch a kernel


# -- routes and split rules -------------------------------------------------

@pytest.mark.parametrize("log2n", range(14, 19))
def test_routes_equal_jax_pallas_route(log2n):
    n = 1 << log2n
    assert route(n, np.complex64) == pallas_route(n, np.complex64, "tpu")


def test_mid_band_routes():
    two_stage = [n for n in range(128, 65537, 128) if route(n, np.complex64) == "two_stage"]
    assert [n for n in two_stage if fused.two_stage_supported(n, np.complex64)] == ONE_BLOCK
    assert all(fused.two_stage_cluster_supported(n, np.complex64)
               for n in two_stage if n > ONE_BLOCK[-1])  # above it, K7's cluster band
    assert two_stage[len(ONE_BLOCK)] == 28928
    for n in (14336, 12288):
        assert route(n, np.complex64) == "lanepack"  # lanepack keeps its band
    # aligned, but one transform does not fit one block: K7's cluster band
    assert fused.choose_pq(49152) == (192, 256)
    assert route(49152, np.complex64) == "two_stage"  # no radix split: r = 3
    assert not fused.two_stage_supported(49152, np.complex64)
    assert fused.two_stage_cluster_supported(49152, np.complex64)
    assert route(28928, np.complex64) == "two_stage"  # 226 x 128, the cluster band's first size
    assert route(1 << 19, np.complex64) == "large"  # r = 32 is above the cap
    for n in (16384, 65536, 262144):
        assert route(n, np.complex128) is None


@pytest.mark.parametrize("n", [16384, 20480, 24576, 14464, 28800, 32768, 49152, 65536, 98304])
def test_split_rules_equal_jax(n):
    assert fused.choose_pq(n) == ref_fused._choose_pq(n)
    assert fused.fused_supported(n, np.complex64) == ref_fused.fused_supported(n, np.complex64)
    assert fused.choose_pqq_fused(n) == ref_fused.choose_pqq_fused(n)
    assert fused.choose_rpq(n) == ref_fused.choose_rpq(n)
    assert fused.radix_supported(n, np.complex64) == ref_fused.radix_supported(n, np.complex64)
    assert (fused.three_stage_supported(n, np.complex64)
            == ref_fused.three_stage_supported(n, np.complex64))


def test_one_block_rule():
    for n in ONE_BLOCK:
        p, q = fused.choose_pq(n)
        assert q % 128 == 0 and not lanepack.lanepack_supported(n, np.complex64)
        assert fused.two_stage_smem_bytes(n, large.stage_radices(p), large.stage_radices(q)) <= 232448
    assert fused.choose_pq(14464) == (113, 128)  # a prime p: one roots-table stage
    assert not fused.two_stage_supported(28928, np.complex64)  # 226 x 128 and its roots: too big


# -- host tables ---------------------------------------------------------------

@pytest.mark.parametrize("r", [2, 4, 8, 16])
def test_radix_tables_bit_equal_to_jax(r):
    p = q = 128
    n = r * p * q
    for d, rd in DIRECTIONS:
        t1, tn, cfac = fused.radix_twiddles(r, p, q, d)
        np.testing.assert_array_equal(cfac, np.stack(ref_fused._ctw_cfacs(r, q, rd)))
        np.testing.assert_array_equal(t1, rustfft_tpu.twiddles.twiddle_table(r, p, rd))
        merged = rustfft_tpu.twiddles.twiddle_table(r * q, p, rd)  # _ctwg_consts' (rq, p) table
        np.testing.assert_array_equal(tn, merged[:q])
        # the factored product is the merged entry w_n^((a*q+j2)*d)
        product = t1[:, None, :] * tn[None, :, :]  # (r, q, p) [a, j2, d]
        np.testing.assert_allclose(product.reshape(r * q, p), merged, rtol=0, atol=1e-14)
        got = fused.radix_tables(r, p, q, d)
        np.testing.assert_allclose((got[2][:, None, :] * got[3][None, :, :]).reshape(r * q, p),
                                   merged.astype(np.complex64), rtol=0, atol=3e-7)
        np.testing.assert_array_equal(
            got[4], rustfft_tpu.twiddles.dft_matrix(r, rd)[1].astype(np.complex64))
        assert n == r * p * q


def test_two_and_three_stage_tables_bit_equal_to_jax():
    for p, q1, q2 in ((128, 8, 16), (160, 8, 16), (113, 8, 16)):
        q = q1 * q2
        for d, rd in DIRECTIONS:
            roots_p, _, outer, roots_q, tws_q = fused.two_stage_tables(p, (q1, q2), d)
            np.testing.assert_array_equal(
                outer, rustfft_tpu.twiddles.twiddle_table(p, q, rd).T.astype(np.complex64))
            np.testing.assert_array_equal(  # K8's inner twiddle (fused.py:786)
                tws_q[0], rustfft_tpu.twiddles.twiddle_table(q1, q2, rd).astype(np.complex64))
            for roots, r in zip(roots_q, (q1, q2)):
                np.testing.assert_array_equal(
                    roots, rustfft_tpu.twiddles.dft_matrix(r, rd)[1].astype(np.complex64))
            r0 = large.stage_radices(p)[0]
            m = fused.bluestein_stage_m(r0)
            if m:  # a prime p from 29 up: the Bluestein stage's chirp and spectrum
                chirp, spectrum = ref_bluestein.bluestein_tables(r0, m, rd)
                got = fused.bluestein_parts(roots_p[0], r0, m)
                np.testing.assert_array_equal(got[0], chirp.astype(np.complex64))
                np.testing.assert_array_equal(
                    got[1], spectrum[fused.bluestein_lane_order(m)].astype(np.complex64))
                continue
            w = lanepack.dft_from_roots(torch.from_numpy(roots_p[0])).numpy()
            np.testing.assert_array_equal(w, rustfft_tpu.twiddles.dft_matrix(r0, rd).astype(np.complex64))


@pytest.mark.parametrize("n", [32768, 262144])
def test_no_radix_plan_holds_an_n_entry_table(n):
    fn = executor._kernel_fn(n, FftDirection.FORWARD, np.complex64)
    assert max(a.size for a in fn.tables.host) <= 128 * 128 < n


# -- the wrappers --------------------------------------------------------------

def test_wrappers_reject_bad_operands():
    r, p = 4, 16
    n = r * p * p
    tabs = [torch.from_numpy(t) if not isinstance(t, list) else [torch.from_numpy(u) for u in t]
            for t in fused.radix_tables(r, p, p, FftDirection.FORWARD)]
    x = torch.from_numpy(_signal(2, n, 1))
    with pytest.raises(ValueError):
        fused.radix_fft(x.reshape(2, 2, -1), r, p, tabs)
    with pytest.raises(ValueError):
        fused.radix_fft(x, 3, p, tabs)
    with pytest.raises(ValueError):
        fused.radix_fft(x, r, p, tabs[:2] + [tabs[3], tabs[2]] + tabs[4:])
    with pytest.raises(TypeError):
        fused.radix_fft(x.to(torch.complex128), r, p, tabs)
    tables = fused.two_stage_tables(128, (16, 8), FftDirection.FORWARD)
    t = ([torch.from_numpy(v) for v in tables[0]], [torch.from_numpy(v) for v in tables[1]],
         torch.from_numpy(tables[2]), [torch.from_numpy(v) for v in tables[3]],
         [torch.from_numpy(v) for v in tables[4]])
    y = torch.from_numpy(_signal(1, 16384, 2))
    with pytest.raises(ValueError):
        fused.two_stage_fft(y, 128, 128, (t[0], t[1], t[2].t(), t[3], t[4]))
    with pytest.raises(ValueError):
        fused.three_stage_fft(y, 128, 8, 16, t)  # tables of (16, 8), not (8, 16)
    with pytest.raises(ValueError):
        fused.make_fused_radix_fn(3 * 16384, FftDirection.FORWARD, np.complex64)
    with pytest.raises(ValueError):
        fused.make_fused_two_stage_fn(1 << 19, FftDirection.FORWARD, np.complex64)  # above the band
    with pytest.raises(ValueError):
        fused.make_fused_radix_fn(65536, FftDirection.FORWARD, np.complex128)


def test_cpu_wrappers_count_no_launches():
    before = _counts()
    x = torch.from_numpy(_signal(1, 1024, 3))
    fused.make_fused_radix_fn(1024, FftDirection.FORWARD, np.complex64, split=(4, 16, 16))(x)
    fused.make_fused_two_stage_fn(1024, FftDirection.FORWARD, np.complex64, split=(32, 32))(x)
    fused.make_fused_three_stage_fn(1024, FftDirection.FORWARD, np.complex64, split=(16, 8, 8))(x)
    assert _counts() == before


def _walk(cluster, clusters, batch):
    """The transforms a cluster runs, as csrc/fused.cu's radix_kernel walks
    them: t = cluster, cluster + clusters, ... while t < batch."""
    return range(cluster, batch, clusters)


@pytest.mark.parametrize("r", [1, 2, 4, 16])
@pytest.mark.parametrize("resident", [1, 2, 3, 7, 66, 132])
def test_radix_persistent_grid_covers_each_transform_once(r, resident):
    """The radix kernel's persistent grid (radix_grid) and the kernel's walk
    over it: cluster g = block // r; every transform of the batch runs
    exactly once, and every block of a cluster runs the same transforms, so
    it passes the same cluster barriers."""
    for batch in [1, 2, resident - 1, resident, resident + 1, 2 * resident + 1,
                  3 * resident + 1, 5 * resident + 3]:
        if batch < 1:
            continue
        clusters = fused.radix_grid(batch, resident)
        assert 1 <= clusters <= min(batch, resident)
        assert clusters == min(batch, resident)  # no resident cluster left idle
        walks = [list(_walk(block // r, clusters, batch)) for block in range(clusters * r)]
        for block in range(clusters * r):
            assert walks[block] == walks[block - block % r]  # the cluster's walk
        done = sorted(t for g in range(clusters) for t in _walk(g, clusters, batch))
        assert done == list(range(batch))
        counts = [len(_walk(g, clusters, batch)) for g in range(clusters)]
        assert max(counts) - min(counts) <= 1


def test_radix_grid_rejects_empty_inputs():
    with pytest.raises(ValueError):
        fused.radix_grid(0, 7)
    with pytest.raises(ValueError):
        fused.radix_grid(5, 0)


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(tables, device):
    return [[torch.from_numpy(u).to(device) for u in t] if isinstance(t, list)
            else torch.from_numpy(t).to(device) for t in tables]


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 4, 8, 16])
def test_radix_fft_on_card(cuda_device, r):
    """At batch 1, 2 and 3 x the resident clusters + 1: the persistent walk's
    second and later passes, its overlapped loads and a remainder."""
    n = r * 128 * 128
    resident = fused.radix_max_active_clusters(r)
    assert resident >= 1
    for batch in (1, 2, 3 * resident + 1):
        x = torch.from_numpy(_signal(batch, n, r)).to(cuda_device)
        for d, _ in DIRECTIONS:
            tabs = _on(fused.radix_tables(r, 128, 128, d), cuda_device)
            before = fused.radix_fft.launches
            got = fused.radix_fft(x, r, 128, tabs)
            torch.cuda.synchronize()
            assert fused.radix_fft.launches == before + 1
            assert _rel(got.cpu(), fused.radix_fft_plain(x, r, 128, tabs).cpu()) <= TOL


@pytest.mark.cuda
def test_two_stage_16384_persistent_on_card(cuda_device):
    """K7's 16384 runs the radix body at R = 1 on a persistent grid of the
    blocks the card holds: at a batch of 3 x those + 1."""
    batch = 3 * fused.radix_max_active_clusters(1) + 1
    x = torch.from_numpy(_signal(batch, 16384, 1)).to(cuda_device)
    for d, _ in DIRECTIONS:
        tabs = _on(fused.two_stage_tables(128, large.stage_radices(128), d), cuda_device)
        before = fused.two_stage_fft.launches
        got = fused.two_stage_fft(x, 128, 128, tabs)
        torch.cuda.synchronize()
        assert fused.two_stage_fft.launches == before + 1
        assert _rel(got.cpu(), fused.two_stage_fft_plain(x, 128, 128, tabs).cpu()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32768, 16384])
def test_radix_body_odd_offset_on_card(cuda_device, n):
    """An input whose data starts 8 bytes past a 16-byte boundary (a view at
    an odd element offset) still runs the radix kernel, whose bulk copies
    need 16-byte aligned rows: the wrapper copies it first.  radix_fft at r
    = 2 and two_stage_fft at 16384 (the body at R = 1)."""
    batch = 5
    buf = torch.from_numpy(_signal(1, batch * n + 1, n)).to(cuda_device)
    x = buf[0, 1:].view(batch, n)
    assert x.data_ptr() % 16 == 8
    r = n // 16384
    for d, _ in DIRECTIONS:
        if r == 1:
            tabs = _on(fused.two_stage_tables(128, large.stage_radices(128), d), cuda_device)
            counter, before = fused.two_stage_fft, fused.two_stage_fft.launches
            got = fused.two_stage_fft(x, 128, 128, tabs)
            want = fused.two_stage_fft_plain(x, 128, 128, tabs)
        else:
            tabs = _on(fused.radix_tables(r, 128, 128, d), cuda_device)
            counter, before = fused.radix_fft, fused.radix_fft.launches
            got = fused.radix_fft(x, r, 128, tabs)
            want = fused.radix_fft_plain(x, r, 128, tabs)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert _rel(got.cpu(), want.cpu()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("split", [(128, 128), (160, 128), (192, 128), (113, 128), (225, 128),
                                   (128, 8, 16)], ids=lambda s: "x".join(map(str, s)))
def test_two_and_three_stage_on_card(cuda_device, split):
    n = int(np.prod(split))
    x = torch.from_numpy(_signal(3, n, n)).to(cuda_device)
    for d, _ in DIRECTIONS:
        if len(split) == 3:
            p, q1, q2 = split
            tabs = _on(fused.three_stage_tables(p, q1, q2, d), cuda_device)
            got = fused.three_stage_fft(x, p, q1, q2, tabs)
            want = fused.three_stage_fft_plain(x, p, q1, q2, tabs)
        else:
            p, q = split
            tabs = _on(fused.two_stage_tables(p, large.stage_radices(q), d), cuda_device)
            got = fused.two_stage_fft(x, p, q, tabs)
            want = fused.two_stage_fft_plain(x, p, q, tabs)
        torch.cuda.synchronize()
        assert _rel(got.cpu(), want.cpu()) <= TOL
