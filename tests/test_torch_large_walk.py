"""K2's and K3's persistent tile kernels (csrc/large.cu): the rules that size
their grids and hand out their units, and, on the card, each kernel against
its plain version.

On the CPU: ops/kernels/large.py col_walk (K2: contiguous ranges of units,
batch fastest) and row_grid (K3: block g takes the tiles g, g + grid, ...)
are the functions the wrappers size the launches with; every (batch, tile)
unit must fall to exactly one block.  The tests marked `cuda` hold the
kernels against their plain versions (relative mean error <= 1e-6: the same
stages in float32, in another order of summation than torch's contraction)
and skip without a GPU.
"""
import numpy as np
import pytest
import torch

from rustfft_tpu.common import FftDirection as RefDirection
from rustfft_tpu.ops.pallas import large as ref_large
from rustfft_tpu_torch.common import FftDirection
from rustfft_tpu_torch.ops.kernels import conv_radix, large

#: relative mean error of a kernel against its plain version on the card
VS_PLAIN = 1e-6

#: resident blocks of an H100 (132 SMs): K2's tile kernel holds two an SM,
#: K3's one
COL_RESIDENT = 264
ROW_RESIDENT = 132

#: (batch, tiles a row) at n = 2^20: K2's Q/16 = 256 tiles, K3's P/4 = 64
N20_COL_TILES = 256
N20_ROW_TILES = 64


def _signal(batch, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _col_units(batch, tiles, resident):
    """Block g's (tile, batch row) units in walk order, from col_walk's
    grid and per and the kernel's unit order (unit v: tile v // batch, row
    v % batch)."""
    units = batch * tiles
    grid, per = large.col_walk(units, resident)
    return grid, per, [[(v // batch, v % batch) for v in r]
                       for r in large.walk_units(grid, per, units)]


# batch 1, a batch whose units stay under the resident blocks, one whose
# units pass them by one (tiles a row chosen so), and the flagship batch
@pytest.mark.parametrize("batch,tiles,resident", [
    (1, N20_COL_TILES, COL_RESIDENT),
    (1, 200, COL_RESIDENT),
    (1, COL_RESIDENT + 1, COL_RESIDENT),
    (3, 88, COL_RESIDENT),
    (1024, N20_COL_TILES, COL_RESIDENT),
    (100, N20_COL_TILES, COL_RESIDENT),
    (7, 5, 4),
    (64, N20_COL_TILES, 1),
])
def test_col_walk_takes_every_unit_once_in_contiguous_ranges(batch, tiles, resident):
    grid, per, blocks = _col_units(batch, tiles, resident)
    units = batch * tiles
    assert 1 <= grid <= resident and grid <= units
    assert (grid - 1) * per < units <= grid * per  # no empty block, none left over
    assert per == -(-units // resident)  # the fewest units a block
    seen = [u for block in blocks for u in block]
    assert sorted(seen) == sorted((t, b) for t in range(tiles) for b in range(batch))
    assert len(seen) == len(set(seen)) == units
    flat = [v for r in large.walk_units(grid, per, units) for v in r]
    assert flat == list(range(units))  # contiguous ranges, in block order
    for block in blocks:
        assert block, "every block of the grid has a unit"
        for (t0, b0), (t1, b1) in zip(block, block[1:]):
            # batch fastest: the row moves on and the tile stays, or the
            # rows wrap and the tile moves on by one
            assert (t1, b1) == ((t0, b0 + 1) if b0 + 1 < batch else (t0 + 1, 0))


def test_col_walk_at_the_flagship_batch_keeps_a_slice_for_many_rows():
    # 2^20 x 1024: each block walks 993 units, so it changes its outer
    # slice (its tile) at most twice
    grid, per, blocks = _col_units(1024, N20_COL_TILES, COL_RESIDENT)
    assert (grid, per) == (264, 993)
    assert max(len({t for t, _ in block}) for block in blocks) <= 2


@pytest.mark.parametrize("tiles,resident", [
    (N20_ROW_TILES, ROW_RESIDENT),              # 2^20 x 1: under the grid
    (2 * N20_ROW_TILES, ROW_RESIDENT),          # x 2: still under
    (ROW_RESIDENT + 1, ROW_RESIDENT),           # one over: a ragged walk
    (3 * N20_ROW_TILES, ROW_RESIDENT),          # x 3
    (1024 * N20_ROW_TILES, ROW_RESIDENT),       # x 1024
    (8 * 512, ROW_RESIDENT),                    # K10's Q pass at 2^23 x 8
    (5, 1),
])
def test_row_grid_takes_every_tile_once(tiles, resident):
    grid = large.row_grid(tiles, resident)
    assert grid == min(tiles, resident)
    walks = [list(range(g, tiles, grid)) for g in range(grid)]
    seen = [u for w in walks for u in w]
    assert sorted(seen) == list(range(tiles)) and len(set(seen)) == tiles
    assert all(walks)
    # the blocks at work at one time hold neighbouring tiles
    assert [w[0] for w in walks] == list(range(grid))
    assert max(map(len, walks)) - min(map(len, walks)) <= 1


@pytest.mark.parametrize("fn,args", [(large.col_walk, (0, 4)), (large.col_walk, (4, 0)),
                                     (large.row_grid, (0, 4)), (large.row_grid, (4, 0))])
def test_walk_rules_refuse_empty(fn, args):
    with pytest.raises(ValueError):
        fn(*args)


def test_tile_chains_are_the_main_path_split():
    # the 2^20 main path's split runs both tile kernels, as the JAX rule
    # splits it
    p, q1, q2 = large.choose_pqq(1 << 20)
    assert (p, q1, q2) == ref_large.choose_pqq(1 << 20) == (256, 64, 64)
    assert (large.stage_radices(p), large.col_tile(p, q1 * q2)) == large.TILE_COL
    assert (large.stage_radices(q1 * q2), large.row_tile(q1 * q2, p)) == large.TILE_ROW
    # K10's and K11's Q passes (P = 2048 .. 16384) take the row tile kernel
    for p in (2048, 4096, 8192, 16384):
        assert (large.stage_radices(4096), large.row_tile(4096, p)) == large.TILE_ROW


@pytest.mark.parametrize("d,rd", [(FftDirection.FORWARD, RefDirection.FORWARD),
                                  (FftDirection.INVERSE, RefDirection.INVERSE)],
                         ids=["fwd", "inv"])
def test_misaligned_view_runs_the_plain_version_on_cpu(d, rd):
    # a view one element into its storage, as the card tests below give
    # the kernels; on the CPU the wrappers run the plain versions on it
    n, p, q = 4096, 16, 256
    x = _signal(2, n, 3)
    base = torch.zeros(2 * n + 1, dtype=torch.complex64)
    base[1:] = torch.from_numpy(x.reshape(-1))
    view = base[1:].view(2, n)
    assert view.storage_offset() == 1
    c = large.col_tables(p, q, d)
    col = ([torch.from_numpy(a) for a in c[0]], [torch.from_numpy(a) for a in c[1]],
           torch.from_numpy(c[2]))
    got = large.large_col_stage(view, p, q, col)
    want = large.large_col_stage(torch.from_numpy(x), p, q, col)
    assert torch.equal(got, want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card(arrays, dev):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _col_tabs(p, q, d, dev):
    r, t, outer = large.col_tables(p, q, d)
    return _card(r, dev), _card(t, dev), torch.from_numpy(outer).to(dev)


def _row_tabs(q, d, dev):
    r, t = large.row_tables(q, d)
    return _card(r, dev), _card(t, dev)


def _ragged_batch(dev):
    """The smallest batch at 2^20 at which both walks are ragged on this
    card: K2's last block takes fewer units than the others and K3's blocks
    fewer tiles than some."""
    col_res, row_res = large.resident_blocks("col"), large.resident_blocks("row")
    for batch in range(2, 4096):
        units = batch * N20_COL_TILES
        grid, per = large.col_walk(units, col_res)
        tiles = batch * N20_ROW_TILES
        if units % per and tiles % large.row_grid(tiles, row_res):
            return batch
    raise AssertionError("no ragged batch")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, "ragged"])
def test_tile_kernels_match_plain_on_card(cuda_device, batch):
    n = 1 << 20
    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    if batch == "ragged":
        batch = _ragged_batch(cuda_device)
    x = torch.from_numpy(_signal(batch, n, 12)).to(cuda_device)
    for d in (FftDirection.FORWARD, FftDirection.INVERSE):
        col, row = _col_tabs(p, q, d, cuda_device), _row_tabs(q, d, cuda_device)
        before = (large.large_col_stage.launches, large.large_row_stage.launches)
        a = large.large_col_stage(x, p, q, col)
        y = large.large_row_stage(a, q, p, row)
        torch.cuda.synchronize()
        assert (large.large_col_stage.launches, large.large_row_stage.launches) == (
            before[0] + 1, before[1] + 1)
        assert _rel(a.cpu(), large.large_col_stage_plain(x, p, q, col).cpu()) <= VS_PLAIN
        assert _rel(y.cpu(), large.large_row_stage_plain(a, q, p, row).cpu()) <= VS_PLAIN


@pytest.mark.cuda
def test_row_tile_kernel_at_k10_q_pass_on_card(cuda_device):
    q, p = 4096, 2048
    a = torch.from_numpy(_signal(2, q * p, 13).reshape(2, q, p)).to(cuda_device)
    for d in (FftDirection.FORWARD, FftDirection.INVERSE):
        row = _row_tabs(q, d, cuda_device)
        y = large.large_row_stage(a, q, p, row)
        torch.cuda.synchronize()
        assert _rel(y.cpu(), large.large_row_stage_plain(a, q, p, row).cpu()) <= VS_PLAIN


@pytest.mark.cuda
def test_misaligned_inputs_are_copied_on_card(cuda_device):
    # a view one element (8 bytes) into its storage: not 16-byte aligned,
    # so each wrapper copies it before the 16-byte copies read it
    n = 1 << 20
    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    x = torch.from_numpy(_signal(2, n, 14)).to(cuda_device)
    base = torch.zeros(2 * n + 1, dtype=torch.complex64, device=cuda_device)
    base[1:] = x.reshape(-1)
    xv = base[1:].view(2, n)
    assert xv.data_ptr() % 16 == 8
    d = FftDirection.FORWARD
    col, row = _col_tabs(p, q, d, cuda_device), _row_tabs(q, d, cuda_device)
    a = large.large_col_stage(xv, p, q, col)
    want_a = large.large_col_stage(x, p, q, col)
    base[1:] = want_a.reshape(-1)
    av = base[1:].view(2, q, p)
    y = large.large_row_stage(av, q, p, row)
    torch.cuda.synchronize()
    assert torch.equal(a, want_a)
    assert torch.equal(y, large.large_row_stage(want_a, q, p, row))
    assert _rel(y.cpu(), large.large_row_stage_plain(want_a, q, p, row).cpu()) <= VS_PLAIN


@pytest.mark.cuda
def test_k14_column_stage_at_65536_on_card(cuda_device):
    # K14's column stage at m = 65536 (P = 256) stays on large.cuh's body
    m = 65536
    p, q = conv_radix.choose_split(m)
    assert large.stage_radices(p) == (16, 16)
    x = torch.from_numpy(_signal(3, m, 15)).to(cuda_device)
    for d in (FftDirection.FORWARD, FftDirection.INVERSE):
        tabs = conv_radix.radix_conv_tables(m, d)
        col = tuple(_card(t, cuda_device) if isinstance(t, list) else torch.from_numpy(t).to(
            cuda_device) for t in tabs["col"])
        a, _ = conv_radix.conv_col_stage(x, p, q, col)
        torch.cuda.synchronize()
        want, _ = conv_radix.conv_col_stage_plain(x, p, q, col)
        assert _rel(a.cpu(), want.cpu()) <= VS_PLAIN
