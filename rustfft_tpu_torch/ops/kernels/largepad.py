"""The two-pass pipeline on ragged tiles: the port of K12.

Replaces rustfft_tpu/ops/pallas/largepad.py (`_kernel_a_pad`,
`_kernel_b_pad`, `largepad_supported`, `make_largepad_fft_fn`): K2/K3's two
passes (ops/kernels/large.py) for splits n = P * Q whose axes do not suit
the stages' tiles.  The JAX package pads Q and P to multiples of 128 lanes
in device memory, writes a (B, Q', P') intermediate and slices after.  On
the card the constraint is another: `large` takes column and row tiles that
divide Q and P, so at an odd axis its tiles are one column wide and each
load reads one 8-byte element per 32-byte sector.  This module ports the
capability, not the padding: the stages of csrc/large.cuh with ragged last
tiles (csrc/largepad.cu),

  column stage (`largepad_col_stage`): tiles of `tile(P)` columns j2
      (16: 128-byte row segments), the last one ragged;
  row stage (`largepad_row_stage`): the widest (Q, pt) tile of 16, 8, 4,
      2, 1 columns k1 that fits shared memory (`tile(Q)`), the last one
      ragged,

where a ragged tile loads zero past the edge and skips its stores there:
the padding lives in shared memory only and the intermediate stays
(B, Q, P).  The split is `large.choose_pqq` at any P; at 78125, 177147 and
531441 it equals the JAX package's `choose_pq_padded`.  That rule itself,
`PAD_RATIO_MAX` and the q1, q2 >= 8 Mosaic limit govern padding device
memory to 128 lanes, which the port does not do, and are not ported.

`executor.route` sends n here ("large_pad") where `large`'s tile on either
stage is narrower than shared memory allows only because it must divide Q
or P (`narrowed_by_division`).  Each wrapper runs the plain version of the
same stage (large.py) on a CPU tensor and launches its kernel on a CUDA
tensor, or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...common import FftDirection
from .. import calg
from . import _build, large
from .lanepack import (
    check_operand, check_stage_tables, padded_stage_args, require_cuda, smem_bytes,
)


def tile(m: int) -> Optional[int]:
    """Columns per block of a stage whose chain has length m (P for the
    column stage, Q for the row stage): the widest of 16, 8, 4, 2, 1 (16
    columns are 128-byte segments) whose (m, width) tile fits shared
    memory; it need not divide the other axis."""
    radices = large.stage_radices(m)
    return next((w for w in (16, 8, 4, 2, 1) if smem_bytes(m * w, radices) <= _build.SMEM_MAX),
                None)


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


def largepad_col_stage(x: torch.Tensor, p: int, q: int, tables) -> torch.Tensor:
    """Column stage of x (batch, P*Q) complex64 -> (batch, Q, P) on ragged
    tiles of tile(P) columns.

    tables = (roots, tws, outer) from large.col_tables, on x's device.
    """
    roots, tws, outer = tables
    if x.dim() != 2:
        raise ValueError(f"largepad_col_stage: expected (batch, n), got {tuple(x.shape)}")
    check_operand(x, (x.shape[0], p * q), "largepad_col_stage input")
    check_stage_tables(p, large.stage_radices(p), roots, tws, x.device, "largepad_col_stage")
    check_operand(outer, (q, p), "largepad_col_stage outer twiddle")
    if outer.device != x.device:
        raise ValueError(f"largepad_col_stage: tables on {outer.device}, input on {x.device}")
    if x.device.type == "cpu":
        return large.large_col_stage_plain(x, p, q, tables)
    require_cuda(x, "largepad_col_stage")
    qt = tile(p)
    if qt is None:
        raise ValueError(f"largepad_col_stage: no tile for P={p}")
    y = torch.empty((x.shape[0], q, p), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.rf_largepad_col_stage(
            x.data_ptr(), y.data_ptr(), x.shape[0], p, q, qt,
            *padded_stage_args(large.stage_radices(p), roots, tws), outer.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "largepad_col_stage")
    largepad_col_stage.launches += 1
    return y


#: kernel launches since the count was last set to 0
largepad_col_stage.launches = 0


def largepad_row_stage(a: torch.Tensor, q: int, p: int, tables) -> torch.Tensor:
    """Row stage of a (batch, Q, P) complex64 -> (batch, Q*P) natural order
    on ragged tiles of tile(Q) columns.

    tables = (roots, tws) from large.row_tables, on a's device.
    """
    roots, tws = tables
    if a.dim() != 3:
        raise ValueError(f"largepad_row_stage: expected (batch, Q, P), got {tuple(a.shape)}")
    check_operand(a, (a.shape[0], q, p), "largepad_row_stage input")
    radices = large.stage_radices(q)
    check_stage_tables(q, radices, roots, tws, a.device, "largepad_row_stage")
    if a.device.type == "cpu":
        return large.large_row_stage_plain(a, q, p, tables)
    require_cuda(a, "largepad_row_stage")
    pt = tile(q)
    if pt is None:
        raise ValueError(f"largepad_row_stage: no tile for Q={q}")
    y = torch.empty((a.shape[0], q * p), dtype=a.dtype, device=a.device)
    if a.shape[0] == 0:
        return y
    lib = _build.load()
    with torch.cuda.device(a.device):
        code = lib.rf_largepad_row_stage(
            a.data_ptr(), y.data_ptr(), a.shape[0], q, p, pt,
            *padded_stage_args(radices, roots, tws),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _build.check(lib, code, "largepad_row_stage")
    largepad_row_stage.launches += 1
    return y


largepad_row_stage.launches = 0


def make_largepad_fft_fn(n: int, direction: FftDirection, dtype,
                         split: Optional[Tuple[int, int, int]] = None):
    """Return fn: complex64 (..., n) -> (..., n), the two passes on ragged
    tiles at `split` = (P, q1, q2) (default large.choose_pqq(n))."""
    if np.dtype(dtype) != np.complex64:
        raise ValueError(f"the largepad pipeline is complex64 only, got {np.dtype(dtype)}")
    split = split or large.choose_pqq(n)
    if split is None or split[0] * split[1] * split[2] != n:
        raise ValueError(f"no largepad split for n={n}: {split}")
    p, q = split[0], split[1] * split[2]
    if tile(p) is None or tile(q) is None:
        raise ValueError(f"largepad: no tile for P={p}, Q={q}")
    roots_p, tws_p, outer = large.col_tables(p, q, direction)
    roots_q, tws_q = large.row_tables(q, direction)
    tables = calg.DeviceTables(roots_p + tws_p + [outer] + roots_q + tws_q)
    kp, kq = len(roots_p), len(roots_q)

    def apply(x):
        t = tables.on(x.device)
        col = (t[:kp], t[kp : 2 * kp - 1], t[2 * kp - 1])
        row = (t[2 * kp : 2 * kp + kq], t[2 * kp + kq :])
        a = largepad_col_stage(x.reshape(-1, n).contiguous(), p, q, col)
        return largepad_row_stage(a, q, p, row).reshape(x.shape)

    return apply
