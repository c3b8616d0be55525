"""The two-pass pipeline on ragged tiles: the port of K12.

Replaces rustfft_tpu/ops/pallas/largepad.py (`_kernel_a_pad`,
`_kernel_b_pad`, `largepad_supported`, `make_largepad_fft_fn`): K2/K3's two
passes (ops/kernels/large.py) for splits n = P * Q whose axes do not suit
the stages' tiles.  The JAX package pads Q and P to multiples of 128 lanes
in device memory, writes a (B, Q', P') intermediate and slices after.  On
the card the constraint is another: `large` takes column and row tiles that
divide Q and P, so at an odd axis its tiles are one column wide and each
load reads one 8-byte element per 32-byte sector.  This module ports the
capability, not the padding (csrc/largepad.cu):

  column stage (`largepad_col_stage`): tiles of `tile(P)` columns j2
      (16: 128-byte row segments), DFT_P over j1 with the outer twiddle
      folded into its last stage, a transposed store;
  row stage (`largepad_row_stage`): tiles of `tile(Q)` columns k1, the
      length-Q FFT over j2, the store in natural order;

where the last tile on each axis holds the columns left: nothing is loaded
or stored past the edge and the intermediate stays (B, Q, P).  Both
kernels run K7's in-place chain on one shared buffer (csrc/
inplace_chain.cuh): the radices of `large.stage_radices`, each stage as
K7's kernels run it (`fused.chain_tables`: a Bluestein stage, one warp a
column, for the prime P from 29 to 509 and most radices from 24 up;
registers for 2-9, 12, 16; a direct sum for the rest).  The split is
`large.choose_pqq` at any P; at 78125, 177147 and 531441 it equals the JAX
package's `choose_pq_padded`.  That rule itself, `PAD_RATIO_MAX` and the
q1, q2 >= 8 Mosaic limit govern padding device memory to 128 lanes, which
the port does not do, and are not ported.

`executor.route` sends n here ("large_pad") where `large`'s tile on either
stage is narrower than shared memory allows only because it must divide Q
or P (`narrowed_by_division`).  Each wrapper runs its plain version
(`fused.chain_stages_plain`, every Bluestein stage step by step) on a CPU
tensor and launches its kernel on a CUDA tensor, or raises.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...common import FftDirection
from .. import calg
from . import _build, fused, large
from .lanepack import check_operand, check_stage_tables, require_cuda

#: the kernels' Bluestein caps (csrc/largepad.cu kPadColMaxM, kPadRowMaxM):
#: the column stage's chain may be one prime P up to 509 (M = 1024), the
#: row stage's radices stay at or below 256
COL_MAX_M = 1024
ROW_MAX_M = 512

#: tile widths, widest first (16 columns are 128-byte row segments)
WIDTHS = (16, 8, 4, 2, 1)

#: shared memory of one SM, and what the card reserves for each block
#: (bytes): an SM holds SM_SMEM // (smem + BLOCK_RESERVED) blocks
#: (csrc/largepad.cu kSmShared, kBlockReserved)
SM_SMEM = 233472
BLOCK_RESERVED = 1024

#: the stamped forms' stamps a block: its start and the ends of the load,
#: the chain and the store (tools/torch_phase_times.py)
PHASES = ("load", "chain", "store")
PHASE_STAMPS = len(PHASES) + 1


def smem_bytes(m: int, width: int, radices: Sequence[int]) -> int:
    """Shared memory of a block over `width` columns of a length-m chain
    (csrc/largepad.cu pad_smem_bytes): ONE buffer (rounded up to 16
    values), the roots of the direct stages (a Bluestein stage reads its
    table from device memory) and a 16-bit place per output."""
    return (-(-m * width // 16) * 16 * 8
            + 8 * sum(r for r in radices if not fused.bluestein_stage_m(r))
            + -(-2 * m // 16) * 16)


def blocks_per_sm(m: int, width: int) -> int:
    """Blocks of `width` columns of a length-m chain one SM's shared memory
    holds."""
    return SM_SMEM // (smem_bytes(m, width, large.stage_radices(m)) + BLOCK_RESERVED)


@functools.lru_cache(maxsize=1024)
def tile(m: int) -> Optional[int]:
    """Columns per block of a stage whose chain has length m (P for the
    column stage, Q for the row stage; it need not divide the other axis):
    the widest of WIDTHS at which two blocks fit an SM's shared memory,
    else the widest at which one does.  A row-stage block has 256 threads
    where two fit, else 512 (csrc/largepad_row.cu pad_threads): an SM holds
    512 threads either way at its 128 registers a thread; a column-stage
    block has 256 (csrc/largepad.cuh).  16 columns up to m of about 890, 8
    up to about 1750, 4 up to about 3400 (the direct stages' roots move
    each edge a little): P <= 512 and Q = 729 take 16 (93 KB), Q = 2187 and
    3149 take 4.

    Two blocks an SM beat a wider tile in one: `tools/torch_largepad_tiles.py`
    timed every width (NVIDIA H100 80GB HBM3, 700 W; ms).  Row stage at
    531441 x 64 (Q = 2187): 8 columns (one block an SM) 1.428, 4 (three)
    1.398, 2 1.574.  At 775575 x 64 (Q = 2025): 8 2.035, 4 1.882.  At
    412519 x 128 (Q = 3149): 8 2.875, 4 2.744.  At 177147 x 256 (Q = 729,
    two blocks of 16): 16 0.829, 8 0.845.  Column stages take 16 columns
    at every P (234617 x 256: 16 1.661, 8 1.686)."""
    radices = large.stage_radices(m)
    fits = [w for w in WIDTHS if smem_bytes(m, w, radices) <= _build.SMEM_MAX]
    return next((w for w in fits if blocks_per_sm(m, w) >= 2), fits[0] if fits else None)


def largepad_supported(n: int, dtype) -> bool:
    """c64 and a split with a tile on both stages."""
    return np.dtype(dtype) == np.complex64 and large.choose_pqq(n) is not None


def narrowed_by_division(n: int) -> bool:
    """At large.choose_pqq(n), large's column or row tile is narrower than
    the same rule gives when the tile need not divide Q or P.  The odd
    composites (15625, 19683, 59049, 78125, 177147, 531441: one-column
    tiles on both stages) and P * Q with Q or P off the tile widths (28928 =
    256 x 113, 746496 = 256 x 2916) are; 10^6, 2^20, 2^21 and 393216 are
    not: their tiles are what shared memory allows."""
    split = large.choose_pqq(n)
    if split is None:
        return False
    p, q = split[0], split[1] * split[2]
    return (large.col_tile(p, q) < large.col_tile(p, q, ragged=True)
            or large.row_tile(q, p) < large.row_tile(q, p, ragged=True))


def col_tables(p: int, q: int, direction: FftDirection):
    """Host tables of the column stage, complex64: DFT_P's chain
    (fused.chain_tables: a Bluestein stage's table in place of its roots)
    and the outer twiddle (Q, P) [j2, k1] = w_n^(k1*j2)."""
    roots, tws = fused.chain_tables(p, large.stage_radices(p), direction)
    return roots, tws, large.col_tables(p, q, direction)[2]


def row_tables(q: int, direction: FftDirection):
    """Host tables of the row stage: the length-Q FFT's chain
    (fused.chain_tables)."""
    return fused.chain_tables(q, large.stage_radices(q), direction)


def _check_chain(m: int, radices: Sequence[int], max_m: int, what: str) -> None:
    """Raise unless the kernel of Bluestein cap max_m runs the chain: every
    Bluestein length at most max_m, every direct sum at most
    fused.MAX_INPLACE_RADIX (csrc/inplace_chain.cuh chain_ok), the place
    table's 16 bits hold m."""
    for r in radices:
        bm = fused.bluestein_stage_m(r)
        if (bm or 0) > max_m or (not bm and r > fused.MAX_INPLACE_RADIX) or m > 65535:
            raise ValueError(f"{what}: the kernel cannot run the radix {r} of {m} "
                             f"({tuple(radices)}: Bluestein length {bm}, cap {max_m})")


def _width(m: int, what: str) -> int:
    width = tile(m)
    if width is None:
        raise ValueError(f"{what}: no tile fits shared memory at {m}")
    return width


def largepad_col_stage_plain(x: torch.Tensor, p: int, q: int, tables) -> torch.Tensor:
    """Plain torch version of largepad_col_stage: DFT_P by K7's chain
    stages, then the outer twiddle."""
    roots, tws, outer = tables
    xt = x.reshape(-1, p, q).transpose(1, 2)  # (B, Q, P) [j2, j1]
    return (fused.chain_stages_plain(xt, large.stage_radices(p), roots, tws) * outer).contiguous()


def largepad_row_stage_plain(a: torch.Tensor, q: int, p: int, tables) -> torch.Tensor:
    """Plain torch version of largepad_row_stage."""
    roots, tws = tables
    d = fused.chain_stages_plain(a.transpose(1, 2), large.stage_radices(q), roots, tws)
    return d.transpose(1, 2).reshape(a.shape[0], -1)  # [k2, k1]


def _check_col(x, p, q, tables, what):
    roots, tws, outer = tables
    radices = large.stage_radices(p)
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (batch, n), got {tuple(x.shape)}")
    check_operand(x, (x.shape[0], p * q), f"{what} input")
    check_stage_tables(p, radices, roots, tws, x.device, what,
                       root_lens=fused.chain_root_lens(radices))
    check_operand(outer, (q, p), f"{what} outer twiddle")
    if outer.device != x.device:
        raise ValueError(f"{what}: tables on {outer.device}, input on {x.device}")


def _launch_col(x, p, q, tables, what, stamps=None):
    """One launch of csrc/largepad.cu's column kernel; y.  With `stamps`,
    its stamped form from the library built for it."""
    roots, tws, outer = tables
    radices = large.stage_radices(p)
    require_cuda(x, what)
    _check_chain(p, radices, COL_MAX_M, what)
    qt = _width(p, what)
    y = torch.empty((x.shape[0], q, p), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    lib = _build.load(phase_stamps=stamps is not None)
    args = (x.data_ptr(), y.data_ptr(), x.shape[0], p, q, qt,
            *fused.chain_args(radices, roots, tws), outer.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if stamps is None:
            code = lib.rf_largepad_col_stage(*args, stream)
        else:
            code = lib.rf_largepad_col_phase_stamps(*args, stamps.data_ptr(), stream)
    _build.check(lib, code, what)
    return y


def largepad_col_stage(x: torch.Tensor, p: int, q: int, tables) -> torch.Tensor:
    """Column stage of x (batch, P*Q) complex64 -> (batch, Q, P) on tiles
    of tile(P) columns, the last one ragged.

    tables = (roots, tws, outer) from col_tables, on x's device.
    """
    what = "largepad_col_stage"
    _check_col(x, p, q, tables, what)
    if x.device.type == "cpu":
        return largepad_col_stage_plain(x, p, q, tables)
    y = _launch_col(x, p, q, tables, what)
    largepad_col_stage.launches += 1
    return y


#: kernel launches since the count was last set to 0
largepad_col_stage.launches = 0


def _check_row(a, q, p, tables, what):
    roots, tws = tables
    radices = large.stage_radices(q)
    if a.dim() != 3:
        raise ValueError(f"{what}: expected (batch, Q, P), got {tuple(a.shape)}")
    check_operand(a, (a.shape[0], q, p), f"{what} input")
    check_stage_tables(q, radices, roots, tws, a.device, what,
                       root_lens=fused.chain_root_lens(radices))


def _launch_row(a, q, p, tables, what, stamps=None):
    """One launch of csrc/largepad.cu's row kernel; y.  With `stamps`, its
    stamped form."""
    roots, tws = tables
    radices = large.stage_radices(q)
    require_cuda(a, what)
    _check_chain(q, radices, ROW_MAX_M, what)
    pt = _width(q, what)
    y = torch.empty((a.shape[0], q * p), dtype=a.dtype, device=a.device)
    if a.shape[0] == 0:
        return y
    lib = _build.load(phase_stamps=stamps is not None)
    args = (a.data_ptr(), y.data_ptr(), a.shape[0], q, p, pt,
            *fused.chain_args(radices, roots, tws))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if stamps is None:
            code = lib.rf_largepad_row_stage(*args, stream)
        else:
            code = lib.rf_largepad_row_phase_stamps(*args, stamps.data_ptr(), stream)
    _build.check(lib, code, what)
    return y


def largepad_row_stage(a: torch.Tensor, q: int, p: int, tables) -> torch.Tensor:
    """Row stage of a (batch, Q, P) complex64 -> (batch, Q*P) natural order
    on tiles of tile(Q) columns, the last one ragged.

    tables = (roots, tws) from row_tables, on a's device.
    """
    what = "largepad_row_stage"
    _check_row(a, q, p, tables, what)
    if a.device.type == "cpu":
        return largepad_row_stage_plain(a, q, p, tables)
    y = _launch_row(a, q, p, tables, what)
    largepad_row_stage.launches += 1
    return y


largepad_row_stage.launches = 0


def stamp_blocks(batch: int, m: int, other: int) -> int:
    """Blocks of a stage over a length-m chain whose other axis has
    `other` columns: batch times ceil(other / tile(m))."""
    return batch * -(-other // tile(m))


def largepad_col_phase_stamps(x: torch.Tensor, p: int, q: int, tables):
    """largepad_col_stage on the card through the kernel's stamped form,
    which only the library built with RF_PHASE_STAMPS holds (no route
    launches it): (y, stamps), stamps (blocks, PHASE_STAMPS) int64
    nanoseconds of %globaltimer, read by each block's thread 0 after a
    block barrier at its start and at the end of each of PHASES."""
    what = "largepad_col_phase_stamps"
    _check_col(x, p, q, tables, what)
    stamps = torch.zeros((stamp_blocks(x.shape[0], p, q), PHASE_STAMPS), dtype=torch.int64,
                         device=x.device)
    y = _launch_col(x, p, q, tables, what, stamps)
    largepad_col_phase_stamps.launches += 1
    return y, stamps


largepad_col_phase_stamps.launches = 0


def largepad_row_phase_stamps(a: torch.Tensor, q: int, p: int, tables):
    """largepad_row_stage through the kernel's stamped form: (y, stamps),
    as largepad_col_phase_stamps."""
    what = "largepad_row_phase_stamps"
    _check_row(a, q, p, tables, what)
    stamps = torch.zeros((stamp_blocks(a.shape[0], q, p), PHASE_STAMPS), dtype=torch.int64,
                         device=a.device)
    y = _launch_row(a, q, p, tables, what, stamps)
    largepad_row_phase_stamps.launches += 1
    return y, stamps


largepad_row_phase_stamps.launches = 0


def make_largepad_fft_fn(n: int, direction: FftDirection, dtype,
                         split: Optional[Tuple[int, int, int]] = None):
    """Return fn: complex64 (..., n) -> (..., n), the two passes on ragged
    tiles at `split` = (P, q1, q2) (default large.choose_pqq(n)); each
    stage's chain is large.stage_radices of its axis (Q = q1 * q2)."""
    if np.dtype(dtype) != np.complex64:
        raise ValueError(f"the largepad pipeline is complex64 only, got {np.dtype(dtype)}")
    split = split or large.choose_pqq(n)
    if split is None or math.prod(split) != n:
        raise ValueError(f"no largepad split for n={n}: {split}")
    p, q = split[0], split[1] * split[2]
    if tile(p) is None or tile(q) is None:
        raise ValueError(f"largepad: no tile for P={p}, Q={q}")
    roots_p, tws_p, outer = col_tables(p, q, direction)
    roots_q, tws_q = row_tables(q, direction)
    tables = calg.DeviceTables(roots_p + tws_p + [outer] + roots_q + tws_q)
    kp, kq = len(roots_p), len(roots_q)

    def apply(x):
        t = tables.on(x.device)
        col = (t[:kp], t[kp : 2 * kp - 1], t[2 * kp - 1])
        row = (t[2 * kp : 2 * kp + kq], t[2 * kp + kq :])
        a = largepad_col_stage(x.reshape(-1, n).contiguous(), p, q, col)
        return largepad_row_stage(a, q, p, row).reshape(x.shape)

    return apply
