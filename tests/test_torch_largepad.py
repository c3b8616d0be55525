"""K12 (large_pad) on K7's in-place chain, held against the JAX package.

The port's two ragged-tile stages run each stage of their chains as K7's
kernels do (fused.chain_tables): register radices, a Bluestein stage for
the prime P from 29 to 509 and most radices from 24 up, a direct sum for
the rest.  On the CPU the wrappers run their plain versions
(fused.chain_stages_plain, every Bluestein stage step by step): small
explicit splits that put each stage kind on each stage go through
make_largepad_fft_fn and are held against the JAX package's
make_largepad_fft_fn in Pallas interpret mode and the f64 oracle, relative
mean error <= 1e-5, both directions, inputs made with numpy from a seed.
Also pinned: each stage's plain version against large's on the same split,
the one-buffer tile widths, the chains the kernels refuse, and the route
counts of tools/torch_routes.py on a slice.  The tests marked `cuda` hold
each form of both kernels against its plain version on the card within
1e-6, ragged last tiles included, and skip without a GPU.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import largepad as ref_largepad
from rustfft_tpu_torch import FftPlanner, route
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import _build, fused, large, largepad
from rustfft_tpu_torch.twiddles import host_dft

DIRECTIONS = [(FftDirection.FORWARD, RefDirection.FORWARD),
              (FftDirection.INVERSE, RefDirection.INVERSE)]
DIR_IDS = ["fwd", "inv"]
TOL = 1e-5
#: a kernel against its plain version: the same tables and stages, the sums
#: in another order
CARD_TOL = 1e-6

#: (split, P's Bluestein lengths, Q's): a prime from 29 to 256 on each stage
#: (37; 29 beside a register radix), a prime from 257 to 509 as P (M =
#: 1024), a direct sum (23) beside a Bluestein stage (31), and a Bluestein
#: stage beside a direct sum in one chain (319 = 29 x 11)
SPLITS = [((37, 29, 8), [128], [64, 0]), ((257, 8, 4), [1024], [0, 0]),
          ((23, 31, 4), [0], [64, 0]), ((319, 4, 8), [64, 0], [0, 0])]
SPLIT_IDS = ["37x29x8", "257x8x4", "23x31x4", "319x4x8"]

#: route sizes whose stages the card tests cover: register chains (177147),
#: direct sums (50666's P, 775575's Q), Bluestein M = 64 (78125's and
#: 531441's Q), 128 (234617's Q beside a direct sum), 256 (412519's Q), 512
#: (17161 = 131 x 131, both stages), 1024 (234617's and 775575's P); each
#: with a ragged last tile on both axes
CARD_SIZES = [78125, 177147, 531441, 17161, 234617, 775575, 412519, 50666]


def _signal(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _counts():
    return largepad.largepad_col_stage.launches, largepad.largepad_row_stage.launches


def _tables(p, q, d, device="cpu"):
    r, t, outer = largepad.col_tables(p, q, d)
    col = ([torch.from_numpy(a).to(device) for a in r], [torch.from_numpy(a).to(device) for a in t],
           torch.from_numpy(outer).to(device))
    row = tuple([torch.from_numpy(a).to(device) for a in tabs]
                for tabs in largepad.row_tables(q, d))
    return col, row


@pytest.mark.parametrize("split,mp,mq", SPLITS, ids=SPLIT_IDS)
@pytest.mark.parametrize("d,rd", DIRECTIONS, ids=DIR_IDS)
def test_plain_path_matches_jax_and_oracle(split, mp, mq, d, rd):
    p, q1, q2 = split
    q = q1 * q2
    n = p * q
    assert fused.bluestein_ms(large.stage_radices(p))[:len(mp)] == mp
    assert fused.bluestein_ms(large.stage_radices(q))[:len(mq)] == mq
    x = _signal(2, n, seed=n)
    before = _counts()
    got = largepad.make_largepad_fft_fn(n, d, np.complex64, split=split)(torch.from_numpy(x))
    assert _counts() == before
    o_r, o_i = ref_largepad.make_largepad_fft_fn(n, rd, np.complex64, split=split,
                                                 interpret=True)((x.real.copy(), x.imag.copy()))
    assert _rel(got, host_dft(x, d)) <= TOL
    assert _rel(got, np.asarray(o_r) + 1j * np.asarray(o_i)) <= TOL


@pytest.mark.parametrize("split", [s for s, _, _ in SPLITS], ids=SPLIT_IDS)
def test_stages_match_large_stages(split):
    """Each plain stage on K7's chain against large's plain stage (every
    stage a dense DFT from a roots table) on the same split: the same
    function."""
    p, q1, q2 = split
    q = q1 * q2
    x = torch.from_numpy(_signal(3, p * q, seed=p))
    for d in (FftDirection.FORWARD, FftDirection.INVERSE):
        col, row = _tables(p, q, d)
        lcol = tuple([torch.from_numpy(a) for a in t] if isinstance(t, list) else torch.from_numpy(t)
                     for t in large.col_tables(p, q, d))
        lrow = tuple([torch.from_numpy(a) for a in t] for t in large.row_tables(q, d))
        a = largepad.largepad_col_stage(x, p, q, col)
        assert _rel(a, large.large_col_stage_plain(x, p, q, lcol)) <= TOL
        y = largepad.largepad_row_stage(a, q, p, row)
        assert _rel(y, large.large_row_stage_plain(a, q, p, lrow)) <= TOL
        assert _rel(y, host_dft(x.numpy(), d)) <= TOL


@pytest.mark.parametrize("n", [17161, 234617])
def test_route_sizes_through_the_planner(n):
    """Route sizes with a Bluestein stage on both stages (17161 = 131 x 131,
    M = 512) and a 1024-point one on P (234617 = 373 x 629) through the
    planner on the CPU."""
    assert route(n, np.complex64) == "large_pad"
    planner = FftPlanner(np.complex64, device="cpu")
    x = _signal(1, n, seed=7)
    before = _counts()
    for plan, d in ((planner.plan_fft_forward(n), FftDirection.FORWARD),
                    (planner.plan_fft_inverse(n), FftDirection.INVERSE)):
        assert _rel(plan.process(x), host_dft(x, d)) <= TOL
    assert _counts() == before


def test_tile_widths():
    """One buffer, and the widest tile at which two blocks fit an SM: 16
    columns at every P and at Q = 729 (93 KB), 4 at Q = 2025 .. 3149 (8
    would fit one block only)."""
    widths = {m: largepad.tile(m) for m in (125, 243, 373, 383, 625, 629, 729, 2025, 2187, 3149)}
    assert widths == {125: 16, 243: 16, 373: 16, 383: 16, 625: 16, 629: 16, 729: 16, 2025: 4,
                      2187: 4, 3149: 4}
    assert largepad.smem_bytes(729, 16, large.stage_radices(729)) == 729 * 16 * 8 + 27 * 8 + 1472
    assert largepad.blocks_per_sm(729, 16) == 2
    for m, w in widths.items():
        radices = large.stage_radices(m)
        assert largepad.smem_bytes(m, w, radices) <= _build.SMEM_MAX
        assert largepad.blocks_per_sm(m, w) >= 2
        assert w == 16 or largepad.blocks_per_sm(m, 2 * w) < 2
    # where two blocks fit at no width, the widest that fits one
    assert largepad.blocks_per_sm(12288, 1) == 1 and largepad.tile(12288) == 2


def test_smem_counts_direct_roots_only():
    """A Bluestein stage's table stays in device memory: only the direct
    stages' roots take shared memory."""
    assert largepad.smem_bytes(373, 16, (373,)) == -(-373 * 16 // 16) * 16 * 8 + 752
    assert largepad.smem_bytes(629, 16, (37, 17)) == 629 * 16 * 8 + 17 * 8 + 1264


def test_chains_the_kernels_refuse():
    """The kernels run Bluestein lengths up to 1024 (column) and 512 (row)
    and direct sums up to 256; other chains raise before any launch."""
    largepad._check_chain(509, (509,), largepad.COL_MAX_M, "col")
    largepad._check_chain(131, (131,), largepad.ROW_MAX_M, "row")
    with pytest.raises(ValueError):
        largepad._check_chain(521, (521,), largepad.COL_MAX_M, "col")  # a direct sum of 521
    with pytest.raises(ValueError):
        largepad._check_chain(257, (257,), largepad.ROW_MAX_M, "row")  # M = 1024 on the row
    with pytest.raises(ValueError):
        largepad._check_chain(65537 * 2, (2, 65537), largepad.COL_MAX_M, "col")


def test_wrappers_check_tables():
    p, q = 37, 8
    x = torch.from_numpy(_signal(2, p * q, seed=1))
    col, row = _tables(p, q, FftDirection.FORWARD)
    r, t, _ = large.col_tables(p, q, FftDirection.FORWARD)
    with pytest.raises(ValueError):  # large's roots where the Bluestein table goes
        largepad.largepad_col_stage(x, p, q, ([torch.from_numpy(a) for a in r], col[1], col[2]))
    with pytest.raises(ValueError):
        largepad.largepad_col_stage(x.reshape(2, p, q), p, q, col)
    a = largepad.largepad_col_stage(x, p, q, col)
    with pytest.raises(ValueError):
        largepad.largepad_row_stage(a.reshape(2, -1), q, p, row)


def test_phase_stamp_blocks():
    assert largepad.stamp_blocks(64, 243, 2187) == 64 * 137  # 2187 / 16 columns
    assert largepad.stamp_blocks(64, 2187, 243) == 64 * 61   # 243 / 4 columns
    assert largepad.PHASE_STAMPS == 4


def _routes_tool():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "torch_routes.py")
    spec = importlib.util.spec_from_file_location("torch_routes", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_route_counts_unchanged_on_a_slice():
    """tools/torch_routes.py over [14464, 24464): the counts of the tree
    before K12's in-place chain (route, narrowed_by_division and
    choose_pqq do not change)."""
    tool = _routes_tool()
    counts, first, by_chain = tool.count_routes(14464, 24464, with_chains=True)
    assert dict(counts) == {"two_stage": 79, "large_pad": 4811, None: 5077, "lanepack": 3,
                            "large": 30}
    assert first["large_pad"][:2] == [14465, 14471]
    assert sum(c for key, c in by_chain.items() if key[0] == "large_pad") == 4811
    assert tool.chain_class(373) == "Bluestein 257-509"
    assert tool.chain_class(629) == "Bluestein r<=256"  # (37, 17)
    assert tool.chain_class(2025) == "direct sum"       # (15, 15, 9)
    assert tool.chain_class(729) == "register"


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_SIZES)
def test_kernel_forms_match_plain_on_card(cuda_device, n):
    """Both kernels, each in the form its chain takes (with or without the
    Bluestein stage), against their plain versions within 1e-6, ragged last
    tiles on both axes, both directions."""
    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    assert (q % largepad.tile(p), p % largepad.tile(q)) != (0, 0)
    x = torch.from_numpy(_signal(2, n, seed=n)).to(cuda_device)
    for d, _ in DIRECTIONS:
        col, row = _tables(p, q, d, cuda_device)
        before = _counts()
        a = largepad.largepad_col_stage(x, p, q, col)
        torch.cuda.synchronize()
        assert _rel(a.cpu(), largepad.largepad_col_stage_plain(x, p, q, col).cpu()) <= CARD_TOL
        y = largepad.largepad_row_stage(a, q, p, row)
        torch.cuda.synchronize()
        assert _rel(y.cpu(), largepad.largepad_row_stage_plain(a, q, p, row).cpu()) <= CARD_TOL
        assert _counts() == (before[0] + 1, before[1] + 1)
        assert _rel(y.cpu(), host_dft(x.cpu().numpy(), d)) <= TOL


@pytest.mark.cuda
def test_phase_stamps_on_card(cuda_device):
    """The stamped forms (the RF_PHASE_STAMPS library) give the kernels'
    output bit for bit, with every block's stamps in order."""
    n = 531441
    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    x = torch.from_numpy(_signal(2, n, seed=3)).to(cuda_device)
    col, row = _tables(p, q, FftDirection.FORWARD, cuda_device)
    a, sa = largepad.largepad_col_phase_stamps(x, p, q, col)
    y, sy = largepad.largepad_row_phase_stamps(a, q, p, row)
    torch.cuda.synchronize()
    assert torch.equal(a, largepad.largepad_col_stage(x, p, q, col))
    assert torch.equal(y, largepad.largepad_row_stage(a, q, p, row))
    for s in (sa, sy):
        assert bool((s[:, 1:] >= s[:, :-1]).all()) and bool((s[:, 0] > 0).all())
