"""Large-n FFT as two passes: the ports of K2 and K3.

Replaces rustfft_tpu/ops/pallas/large.py (`_kernel_a`, `_kernel_b` with
`fftq_sublane`, `choose_pqq`, `make_large_fft_fn`).  For n = P * Q,
Q = q1 * q2, the input viewed as (B, P, Q) [j1, j2]:

  column stage (`large_col_stage`, K2):
      a[b, j2, k1] = w_n^(k1*j2) * sum_j1 x[b, j1, j2] * w_P^(j1*k1)
      written as (B, Q, P);
  row stage (`large_row_stage`, K3):
      a length-Q FFT over j2 for every k1, written in natural order
      X[b, k2*P + k1].

The JAX kernels contract a dense DFT_P and split Q as q1 x q2 for the
matrix unit; on the CUDA cores both stages compute their DFT in the radix
stages `stage_radices` picks (the same chain as the lanepack kernel), an
exact DFT either way.  `choose_pqq` keeps the JAX rule for P, q1, q2.

Two reads and two writes of the signal in device memory.  Each wrapper runs
its plain torch version on a CPU tensor and launches its kernel in
csrc/large.cu on a CUDA tensor, or raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ...common import FftDirection
from ... import twiddles
from .. import calg
from . import _build
from .lanepack import (
    cheapest_split, check_operand, check_stage_tables, fft_stages_plain,
    padded_stage_args, require_cuda, smem_bytes, stage_tables,
)

#: split bounds, as in the JAX package: P <= 512, q1, q2 <= 256
MAX_P = 512
MAX_Q_FACTOR = 256


@functools.lru_cache(maxsize=1024)
def stage_radices(m: int) -> Tuple[int, ...]:
    """The radix stages a large-pipeline kernel computes a length-m DFT with
    (DFT_P in the column stage, the length-Q FFT in the row stage): the
    cheapest split of m into 1-3 radices, or one dense stage for a prime P
    above 256.  Any split gives the same DFT as the JAX kernels' dense DFT_P
    and q1 x q2 FFT."""
    return cheapest_split(m, 1) or (m,)


#: the row-stage chain with a compile-time kernel in csrc/large.cuh and its
#: tile width; other chains run the general kernel.
FIXED_ROW = ((16, 16, 16), 4)

#: the column-stage chains with a compile-time kernel in csrc/large.cuh and
#: their tile widths: P = 256 over 16 columns, and the top band's one
#: 128 KiB tile in place, 16384 / P columns at P = 1024 .. 8192
FIXED_COL = {(16, 16): 16, (16, 16, 4): 16, (16, 16, 8): 8, (16, 16, 16): 4, (32, 16, 16): 2}


def col_tile(p: int, q: int, ragged: bool = False) -> Optional[int]:
    """Columns j2 per column-stage block: the compile-time kernel's width
    (FIXED_COL) where it divides Q, else 16 (128-byte row segments) where it
    divides Q and two buffers fit shared memory, else the next smaller power
    of 2.  ragged: the same rule without "divides Q" (the width the tile
    would have if it need not divide, ops/kernels/largepad.py)."""
    fixed = FIXED_COL.get(stage_radices(p))
    if fixed is not None and (ragged or q % fixed == 0):
        return fixed
    for qt in (16, 8, 4, 2, 1):
        if (ragged or q % qt == 0) and smem_bytes(p * qt, stage_radices(p)) <= _build.SMEM_MAX:
            return qt
    return None


def row_tile(q: int, p: int, ragged: bool = False) -> Optional[int]:
    """Columns k1 per row-stage block: 4 for the compile-time chain (one
    buffer of 128 KiB), else 2 where a (Q, 2) tile fits shared memory, else
    1; None when one column does not fit.  ragged: the same rule without
    "divides P"."""
    radices = stage_radices(q)
    if radices == FIXED_ROW[0] and (ragged or p % FIXED_ROW[1] == 0):
        return FIXED_ROW[1]
    for pt in (2, 1):
        if (ragged or p % pt == 0) and smem_bytes(q * pt, radices) <= _build.SMEM_MAX:
            return pt
    return None


@functools.lru_cache(maxsize=1024)
def choose_pqq(n: int) -> Optional[Tuple[int, int, int]]:
    """Split n = P * q1 * q2 with P <= 512, q1, q2 <= 256.

    The JAX package's rule (large.py:choose_pqq) without its TPU-only
    constraints (128-multiple tiles, the VMEM budget): the largest P up to
    256 (else the smallest above it), then the most balanced q1 x q2.  The
    card's constraint is that both kernels' tiles fit shared memory.
    """
    best = None
    for p in range(8, MAX_P + 1):
        if n % p:
            continue
        rest = n // p
        if rest < 4:
            continue
        inner = None
        for q1 in range(2, MAX_Q_FACTOR + 1):
            if rest % q1:
                continue
            q2 = rest // q1
            if q2 > MAX_Q_FACTOR:
                continue
            key = (q1 + q2, abs(q1 - q2))
            if inner is None or key < inner[0]:
                inner = (key, q1, q2)
        if inner is None:
            continue
        _, q1, q2 = inner
        if col_tile(p, rest) is None or row_tile(rest, p) is None:
            continue
        key = (0 if p <= 256 else 1, -p if p <= 256 else p, q1 + q2, abs(q1 - q2))
        if best is None or key < best[0]:
            best = (key, p, q1, q2)
    if best is None:
        return None
    _, p, q1, q2 = best
    return p, q1, q2


def large_supported(n: int, dtype) -> bool:
    return np.dtype(dtype) == np.complex64 and choose_pqq(n) is not None


def col_tables(p: int, q: int, direction: FftDirection):
    """Host tables of the column stage: DFT_P's stage tables and the outer
    twiddle (Q, P) [j2, k1] = w_n^(k1*j2), complex64."""
    roots, tws = stage_tables(p, stage_radices(p), direction)
    outer = np.ascontiguousarray(twiddles.twiddle_table(p, q, direction).T)
    return roots, tws, outer.astype(np.complex64)


def row_tables(q: int, direction: FftDirection):
    """Host tables of the row stage: the length-Q FFT's stage tables."""
    return stage_tables(q, stage_radices(q), direction)


def large_col_stage_plain(x: torch.Tensor, p: int, q: int, tables) -> torch.Tensor:
    """Plain torch version of large_col_stage."""
    roots, tws, outer = tables
    xt = x.reshape(-1, p, q).transpose(1, 2)  # (B, Q, P) [j2, j1]
    return (fft_stages_plain(xt, stage_radices(p), roots, tws) * outer).contiguous()


def large_col_stage(x: torch.Tensor, p: int, q: int, tables) -> torch.Tensor:
    """Column stage of x (batch, P*Q) complex64 -> (batch, Q, P).

    tables = (roots, tws, outer) from col_tables, on x's device.
    """
    roots, tws, outer = tables
    if x.dim() != 2:
        raise ValueError(f"large_col_stage: expected (batch, n), got {tuple(x.shape)}")
    check_operand(x, (x.shape[0], p * q), "large_col_stage input")
    check_stage_tables(p, stage_radices(p), roots, tws, x.device, "large_col_stage")
    check_operand(outer, (q, p), "large_col_stage outer twiddle")
    if outer.device != x.device:
        raise ValueError(f"large_col_stage: tables on {outer.device}, input on {x.device}")
    if x.device.type == "cpu":
        return large_col_stage_plain(x, p, q, tables)
    require_cuda(x, "large_col_stage")
    qt = col_tile(p, q)
    if qt is None:
        raise ValueError(f"large_col_stage: no tile for P={p}, Q={q}")
    y = torch.empty((x.shape[0], q, p), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.rf_large_col_stage(
            x.data_ptr(), y.data_ptr(), x.shape[0], p, q, qt,
            *padded_stage_args(stage_radices(p), roots, tws), outer.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "large_col_stage")
    large_col_stage.launches += 1
    return y


large_col_stage.launches = 0


def large_row_stage_plain(a: torch.Tensor, q: int, p: int, tables) -> torch.Tensor:
    """Plain torch version of large_row_stage."""
    roots, tws = tables
    d = fft_stages_plain(a.transpose(1, 2), stage_radices(q), roots, tws)  # [k1, k2]
    return d.transpose(1, 2).reshape(a.shape[0], -1)


def large_row_stage(a: torch.Tensor, q: int, p: int, tables) -> torch.Tensor:
    """Row stage of a (batch, Q, P) complex64 -> (batch, Q*P) natural order.

    tables = (roots, tws) from row_tables, on a's device.
    """
    roots, tws = tables
    if a.dim() != 3:
        raise ValueError(f"large_row_stage: expected (batch, Q, P), got {tuple(a.shape)}")
    check_operand(a, (a.shape[0], q, p), "large_row_stage input")
    radices = stage_radices(q)
    check_stage_tables(q, radices, roots, tws, a.device, "large_row_stage")
    if a.device.type == "cpu":
        return large_row_stage_plain(a, q, p, tables)
    require_cuda(a, "large_row_stage")
    pt = row_tile(q, p)
    if pt is None:
        raise ValueError(f"large_row_stage: no tile for Q={q}, P={p}")
    y = torch.empty((a.shape[0], q * p), dtype=a.dtype, device=a.device)
    if a.shape[0] == 0:
        return y
    lib = _build.load()
    with torch.cuda.device(a.device):
        code = lib.rf_large_row_stage(
            a.data_ptr(), y.data_ptr(), a.shape[0], q, p, pt,
            *padded_stage_args(radices, roots, tws),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _build.check(lib, code, "large_row_stage")
    large_row_stage.launches += 1
    return y


large_row_stage.launches = 0


def make_large_fft_fn(n: int, direction: FftDirection, dtype):
    """Return fn: complex64 (..., n) -> (..., n), the two-pass pipeline at
    the split choose_pqq(n)."""
    if not large_supported(n, dtype):
        raise ValueError(f"no large pipeline for n={n}, dtype={np.dtype(dtype)}")
    p, q1, q2 = choose_pqq(n)
    q = q1 * q2
    roots_p, tws_p, outer = col_tables(p, q, direction)
    roots_q, tws_q = row_tables(q, direction)
    tables = calg.DeviceTables(roots_p + tws_p + [outer] + roots_q + tws_q)
    kp, kq = len(roots_p), len(roots_q)

    def apply(x):
        t = tables.on(x.device)
        col = (t[:kp], t[kp : 2 * kp - 1], t[2 * kp - 1])
        row = (t[2 * kp : 2 * kp + kq], t[2 * kp + kq :])
        a = large_col_stage(x.reshape(-1, n).contiguous(), p, q, col)
        return large_row_stage(a, q, p, row).reshape(x.shape)

    return apply
