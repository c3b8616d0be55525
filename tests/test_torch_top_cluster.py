"""K10's fused column stage on clusters (csrc/large2f.cu col_cluster_kernel).

On the CPU: a numpy simulation of the cluster decomposition, block by block
(block r the rows J = r mod C, the chain's stages but the last with the
chain's own twiddles, the last stage over values gathered from every
block, each block's output runs), held against large2f_col_stage_plain and
the JAX large2f pipeline in Pallas interpret mode at the splits
tests/test_torch_top.py uses, at every cluster size their radices allow,
and against the float64 oracle; a mirror of the kernel's index
arithmetic (its stages' column maps and twiddle offsets, the exchange and
the stores) at the route's four chains, P = 1024 .. 8192; the host rules:
the cluster size by P, the grid, and the walk, every (batch, tile) unit
visited once, ragged walks included.  The tests marked `cuda` hold the
kernel against its plain version (relative mean error <= 1e-6: the same
stages in float32, summed in another order) and skip without a GPU.
"""
import numpy as np
import pytest
import torch

from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import large2f as ref_large2f
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import large, large2f
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
#: tests/test_torch_top.py's splits (P = 16, 32, 64 over Q = 16)
SPLITS = [(8, 2, 4, 4, 16), (8, 4, 4, 4, 16), (8, 8, 4, 4, 16)]
TOL = 1e-5
#: the simulation and the mirror against the plain version: the same DFT in
#: float64 from the same float32 tables
VS_PLAIN = 1e-6
#: the route's splits, 2^22 .. 2^25
ROUTE = [22, 23, 24, 25]


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


def _tables(p1, p2, q, d):
    r, t, wob, wm = large2f.col_tables(p1, p2, q, d)
    return [a.astype(np.complex128) for a in r], [a.astype(np.complex128) for a in t], \
        wob.astype(np.complex128), wm.astype(np.complex128)


def _dft(v, axis, roots):
    """DFT over `axis` with W[j, k] = roots[(j*k) mod r]."""
    r = v.shape[axis]
    j = np.arange(r)
    w = roots[(j[:, None] * j[None, :]) % r]
    return np.moveaxis(np.tensordot(np.moveaxis(v, axis, -1), w, axes=([-1], [0])), -1, axis)


def simulate_clusters(x, p1, p2, q, tables, c):
    """The column stage (batch, Q, P) as clusters of c blocks compute it, in
    float64, c dividing the chain's last radix R and P / R: block r takes
    the rows J = r mod c and runs the chain's stages but the last on them
    (the chain's own twiddles, indexed by the global digits), leaving
    Z_r[u, h] (j_last = r + c*u, h the natural order of k_0 .. k_{k-2}).
    Block s then owns h in [s*H, (s+1)*H), H = P/(R*c), gathers for each
    (h, j3) the R values y[r + c*u] = Z_r[u, h] from every block, runs the
    last stage DFT_R over them and writes X[h + (P/R)*k] times the factored
    outer twiddle, a run of H contiguous K per k and column.  Every (j3, K)
    must be written once."""
    roots, tws, wob, wm = tables
    p = p1 * p2
    rad = large.stage_radices(p)
    k, last = len(rad), rad[-1]
    m, lead = last // c, p // last
    h_len = lead // c
    batch = x.shape[0]
    xt = x.astype(np.complex128).reshape(batch, p, q)
    z = []
    for r in range(c):
        loc = list(rad[:-1]) + [m]
        v = xt[:, r::c, :].reshape(batch, *loc, q)  # [b, j_0 .. j_{k-2}, u, j3]
        for s in range(k - 1):
            # axes [b, k_{s-1} .. k_0, j_s, j_{s+1} .., u, j3]: DFT over j_s
            v = _dft(v, 1 + s, roots[s])
            # the twiddle tw_s[k_s, j_rest], j_rest the global digits after j_s
            rest = np.zeros(loc[s + 1 :], dtype=np.int64)
            stride = 1
            for axis in range(len(loc) - 1, s, -1):
                idx = np.arange(loc[axis])
                shape = [1] * len(rest.shape)
                shape[axis - s - 1] = loc[axis]
                digit = idx if axis < len(loc) - 1 else r + c * idx
                rest = rest + digit.reshape(shape) * stride
                stride *= rad[axis]
            tw = tws[s][:, rest]  # [k_s, j_{s+1} .., u]
            v = v * tw.reshape((1,) * (1 + s) + tw.shape + (1,))
            v = np.moveaxis(v, 1 + s, 1)  # k_s to the front
        # [b, k_{k-2} .. k_0, u, j3] -> Z_r [b, u, h, j3]
        z.append(np.moveaxis(v.reshape(batch, lead, m, q), 2, 1))
    out = np.zeros((batch, q, p), dtype=np.complex128)
    written = np.zeros((q, p), dtype=np.int64)
    j3 = np.arange(q)[:, None]
    for s in range(c):
        h = np.arange(s * h_len, (s + 1) * h_len)
        # y[b, j_last, h, j3], j_last = r + c*u
        y = np.stack([z[j_last % c][:, j_last // c, h, :] for j_last in range(last)], axis=1)
        xk = _dft(y, 1, roots[-1])  # [b, k_last, h, j3]
        for kl in range(last):
            kk = h + lead * kl  # this block's run of H contiguous K
            twid = wob[j3, kk[None, :] % p1] * wm[j3, kk[None, :] // p1]
            out[:, :, kk] = xk[:, kl].transpose(0, 2, 1) * twid
            written[:, kk] += 1
    assert (written == 1).all()
    return out


def mirror_kernel(x, p1, p2, q, tables):
    """col_cluster_kernel's own index arithmetic in numpy, at a route chain
    (C = P/512 blocks a cluster, 512 rows a block): the tile loaded in plain
    order (element rho*16 + t = row C*rho + r), each k10_stage's column
    map, input and output offsets and twiddle offsets as csrc/large2f.cu
    writes them (without the bank swizzle of stage 0's outputs, a bijection
    applied on both sides), Z[g, t] at k10_z's t*512 + (g ^ t), the
    exchange's (t, h) of pair e and its peer reads, and the stores y[b, j3,
    h + R0*R1*k2]."""
    roots, tws, wob, wm = tables
    p = p1 * p2
    r0, r1, r2 = large.stage_radices(p)
    rows, t_cols = large2f.CLUSTER_ROWS, large2f.CLUSTER_COLS
    c = p // rows
    m, h_len = r2 // c, r0 * r1 // c
    tw0, tw1 = tws[0].reshape(-1), tws[1].reshape(-1)
    batch = x.shape[0]
    xr = x.astype(np.complex128).reshape(batch, p, q)
    y = np.full((batch, q, p), np.nan, dtype=np.complex128)

    def z_at(g, t):  # csrc/large2f.cu k10_z: column-major, g permuted by t
        return t * rows + (g ^ t)

    def stage(buf, radix, cols, roots_r, in_at, out_at, tw):
        col = np.arange(cols)[:, None]
        j = np.arange(radix)
        vals = buf[in_at(col, j[None, :])]  # [c, j]
        out = vals @ roots_r[(j[:, None] * j[None, :]) % radix]  # [c, k]
        out = tw(col, j[None, :], out)
        new = np.full_like(buf, np.nan)
        new[out_at(col, j[None, :])] = out
        return new

    for b in range(batch):
        for tile in range(q // t_cols):
            bufs = []
            for r in range(c):
                buf = xr[b, r::c, tile * t_cols : (tile + 1) * t_cols].reshape(-1)
                k0c = r1 * m * t_cols
                buf = stage(buf, r0, k0c, roots[0], lambda cc, j: j * k0c + cc,
                            lambda cc, k: k * k0c + cc,
                            lambda cc, k, z: np.where(
                                k == 0, z, z * tw0[k * (r1 * r2) + (cc // t_cols // m) * r2 + r
                                                   + c * ((cc // t_cols) % m)]))
                k1c, rt = r0 * m * t_cols, m * t_cols
                buf = stage(buf, r1, k1c, roots[1],
                            lambda cc, j: (cc // rt) * r1 * rt + j * rt + cc % rt,
                            lambda cc, k: z_at((cc % rt) // t_cols * (r0 * r1) + k * r0 + cc // rt,
                                               cc % t_cols),
                            lambda cc, k, z: np.where(
                                k == 0, z, z * tw1[k * r2 + r + c * ((cc % rt) // t_cols)]))
                assert not np.isnan(buf).any()
                bufs.append(buf)
            w = roots[2][(np.arange(r2)[:, None] * np.arange(r2)[None, :]) % r2]  # [j2, k2]
            for s in range(c):
                e = np.arange(t_cols * h_len)
                t, h = e // h_len, s * h_len + e % h_len
                v = np.stack([bufs[j2 % c][z_at((j2 // c) * (r0 * r1) + h, t)]
                              for j2 in range(r2)])  # [j2, e]
                xk = w.T @ v  # [k2, e]
                j3 = tile * t_cols + t
                wo = wob[j3, h % p1]
                for k2 in range(r2):
                    k = h + r0 * r1 * k2
                    assert np.isnan(y[b, j3, k]).all()
                    y[b, j3, k] = xk[k2] * (wo * wm[j3, k // p1])
    assert not np.isnan(y).any()
    return y


def _cluster_sizes(p):
    """Every c the decomposition takes at P: c divides the last radix R and
    P / R (each block stores at least one h)."""
    last = large.stage_radices(p)[-1]
    return [c for c in (1, 2, 4, 8, 16) if last % c == 0 and (p // last) % c == 0]


@pytest.mark.parametrize("split", SPLITS, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=["fwd", "inv"])
def test_cluster_simulation_matches_plain_jax_and_oracle(split, d, rd):
    p1, p2, _, _, q = split
    p, n = p1 * p2, p1 * p2 * q
    x = _signal(3, n, seed=n + p2)
    tables = _tables(p1, p2, q, d)
    col = tuple([torch.from_numpy(a) for a in t] if isinstance(t, list) else torch.from_numpy(t)
                for t in large2f.col_tables(p1, p2, q, d))
    plain = large2f.large2f_col_stage_plain(torch.from_numpy(x), p1, p2, q, col).numpy()
    dft = host_dft(x.reshape(3, p, q).transpose(0, 2, 1), d)  # (3, Q, P) [j3, K]
    sign = -1.0 if d is FftDirection.FORWARD else 1.0
    oracle = dft * np.exp(sign * 2j * np.pi * (np.arange(q)[:, None] * np.arange(p)) / n)
    ref = _jax_out(ref_large2f.make_large2f_fft_fn(n, rd, np.complex64, split=split,
                                                   interpret=True, pt=8, qt3=16), x)
    row = tuple([torch.from_numpy(a) for a in t] for t in large.row_tables(q, d))
    for c in _cluster_sizes(p):
        sim = simulate_clusters(x, p1, p2, q, tables, c)
        assert _rel(sim, plain) <= VS_PLAIN, c
        assert _rel(sim, oracle) <= VS_PLAIN, c
        # the simulated column stage, then the plain Q pass: the JAX pipeline
        out = large.large_row_stage_plain(torch.from_numpy(sim.astype(np.complex64)), q, p, row)
        assert _rel(out.numpy(), ref) <= TOL, c
        assert _rel(out.numpy(), host_dft(x, d)) <= TOL, c


@pytest.mark.parametrize("log2n", ROUTE)
@pytest.mark.parametrize("d", [FftDirection.FORWARD, FftDirection.INVERSE], ids=["fwd", "inv"])
def test_mirror_of_the_kernel_matches_plain(log2n, d):
    """The kernel's index arithmetic at the route's chains, Q cut to 32 (two
    column tiles), batch 2."""
    p1, p2, _, _, _ = large2f.choose_split2f(1 << log2n)
    q = 32
    x = _signal(2, p1 * p2 * q, seed=log2n)
    tables = _tables(p1, p2, q, d)
    col = tuple([torch.from_numpy(a) for a in t] if isinstance(t, list) else torch.from_numpy(t)
                for t in large2f.col_tables(p1, p2, q, d))
    plain = large2f.large2f_col_stage_plain(torch.from_numpy(x), p1, p2, q, col).numpy()
    got = mirror_kernel(x, p1, p2, q, tables)
    assert _rel(got, plain) <= VS_PLAIN
    sim = simulate_clusters(x, p1, p2, q, tables, p1 * p2 // large2f.CLUSTER_ROWS)
    assert _rel(got, sim) <= VS_PLAIN


@pytest.mark.parametrize("log2n,c", [(22, 2), (23, 4), (24, 8), (25, 16)])
def test_cluster_size_by_p(log2n, c):
    p1, p2, _, _, q = large2f.choose_split2f(1 << log2n)
    assert large2f.cluster_form(p1 * p2, p1, q) == c == p1 * p2 // large2f.CLUSTER_ROWS
    assert large.stage_radices(p1 * p2) in large2f.CLUSTER_CHAINS
    # the route's chains are large.FIXED_COL's; col_tile, which the route
    # reads, is unchanged
    assert large.stage_radices(p1 * p2) in large.FIXED_COL
    assert large.col_tile(p1 * p2, q) == 16384 // (p1 * p2)


def test_cluster_form_elsewhere():
    # the CPU splits, 2^26's P = 16384, Q not a multiple of 16, P1 not dividing 512
    for p1, p2, _, _, q in SPLITS:
        assert large2f.cluster_form(p1 * p2, p1, q) is None
    assert large2f.cluster_form(16384, 256, 4096) is None
    assert large2f.cluster_form(2048, 128, 4104) is None
    assert large2f.cluster_form(2048, 2048, 4096) is None
    assert large2f.cluster_form(2048, 1024, 4096) is None
    assert large2f.cluster_form(2048, 256, 2048) == 4


@pytest.mark.parametrize("batch,tiles,resident", [
    (1, 256, 66), (2, 256, 66), (16, 256, 132), (8, 256, 66), (4, 256, 33), (2, 256, 16),
    (1, 3, 66), (3, 7, 5), (1, 1, 1),
])
def test_cluster_walk_visits_every_unit_once(batch, tiles, resident):
    units = batch * tiles
    clusters = large2f.cluster_grid(units, resident)
    assert clusters == min(units, resident)
    walks = large2f.cluster_walk(clusters, units, tiles)
    assert len(walks) == clusters and all(walks)
    seen = [unit for walk in walks for unit in walk]
    assert sorted(seen) == [(b, t) for b in range(batch) for t in range(tiles)]
    # ragged walks differ by at most one unit; the clusters at work at one
    # time hold consecutive units (neighbouring tiles of the same rows)
    lengths = {len(w) for w in walks}
    assert max(lengths) - min(lengths) <= 1
    for step in range(max(lengths)):
        at = [w[step][0] * tiles + w[step][1] for w in walks if len(w) > step]
        assert at == list(range(at[0], at[0] + len(at)))


def test_cluster_grid_rejects_empty():
    with pytest.raises(ValueError):
        large2f.cluster_grid(0, 66)
    with pytest.raises(ValueError):
        large2f.cluster_grid(5, 0)


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("log2n", ROUTE)
def test_cluster_kernel_matches_plain_on_card(cuda_device, log2n):
    """Batch 1, a batch past the resident clusters (its last round part-full
    where the clusters do not divide its units), and a view 8 bytes into its
    storage (the wrapper copies it)."""
    n = 1 << log2n
    p1, p2, _, _, q = large2f.choose_split2f(n)
    c = large2f.cluster_form(p1 * p2, p1, q)
    resident = large2f.max_active_clusters(p1 * p2)
    ragged = next((b for b in range(2, 64) if b * (q // 16) % resident), 3)
    for d, _ in DIRECTIONS:
        col = tuple([torch.from_numpy(a).to(cuda_device) for a in t] if isinstance(t, list)
                    else torch.from_numpy(t).to(cuda_device)
                    for t in large2f.col_tables(p1, p2, q, d))
        for batch in (1, ragged):
            x = torch.from_numpy(_signal(batch, n, log2n + batch)).to(cuda_device)
            before = large2f.large2f_col_stage.launches
            got = large2f.large2f_col_stage(x, p1, p2, q, col)
            torch.cuda.synchronize()
            assert large2f.large2f_col_stage.launches == before + 1
            want = large2f.large2f_col_stage_plain(x, p1, p2, q, col)
            assert _rel(got.cpu(), want.cpu()) <= VS_PLAIN
        store = torch.from_numpy(_signal(1, n + 1, log2n)).to(cuda_device)
        view = store.reshape(-1)[1:].reshape(1, n)
        assert torch.equal(large2f.large2f_col_stage(view, p1, p2, q, col),
                           large2f.large2f_col_stage(view.clone(), p1, p2, q, col))
