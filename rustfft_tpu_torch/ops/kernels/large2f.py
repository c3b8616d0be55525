"""The top power-of-two band as two passes: the port of K10.

Replaces rustfft_tpu/ops/pallas/large2f.py (`_kernel_a12`, `_kernel_a12_2d`,
`_kernel_q_2d`, `outer_table`, `choose_split2f`, `large2f_supported`,
`make_large2f_fft_fn`).  For n = P1 * P2 * Q, P = P1 * P2, the input viewed
as (B, P, Q) with row J = j1*P2 + j2:

  fused column stage (`large2f_col_stage`):
      a[b, j3, K] = w_n^(K*j3) * sum_J x[b, J, j3] * w_P^(J*K),
      w_n^(K*j3) = wob[j3, k1] * wm[j3, k2],  K = k2*P1 + k1,
      written as (B, Q, P);
  Q-FFT pass: K3's row stage, `large.large_row_stage` at (Q, P), which
      writes X[k3*P + K] in natural order.

The TPU kernel computes DFT_P1 on its matrix unit, multiplies by
w_{P1P2}^(k1*j2) and runs the P2 chain on its vector unit; the card runs
the whole length-P DFT as one register chain (`large.stage_radices(P)`), the
same transform.  The outer twiddle is factored into a (Q, P1) and a (Q, P2)
table, as on the TPU, so no table of n entries exists.  Four traversals of
the signal in device memory.  The wrapper runs its plain torch version on a
CPU tensor and launches csrc/large2f.cu on a CUDA tensor, or raises.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ...common import FftDirection
from ... import twiddles
from .. import calg
from . import _build, large
from .lanepack import (
    check_operand, check_stage_tables, fft_stages_plain, padded_stage_args, require_cuda,
    stage_tables,
)


def outer_table(q: int, p1: int, n: int, direction: FftDirection) -> np.ndarray:
    """(Q, P1) table t[j3, k1] = w_n^(j3*k1) in f64 (exponent < Q*P1 <= n)."""
    sign = -1.0 if direction == FftDirection.FORWARD else 1.0
    e = np.arange(q, dtype=np.int64)[:, None] * np.arange(p1, dtype=np.int64)
    return np.exp(sign * 2j * np.pi * e / n)


@functools.lru_cache(maxsize=256)
def choose_split2f(n: int) -> Optional[Tuple[int, int, int, int, int]]:
    """Pick n = P1 * P2 * (q1*q2) as (P1, P2, q1, q2, Q), the JAX package's
    rule: P1 in {256, 128}, P2 a power of 2 in [8, 64], Q = q1*q2 in
    {4096, 2048} with q1, q2 <= 256 (the most balanced pair); the largest Q,
    then the smallest P1.  On the card Q = 4096 is the row stage's
    compile-time kernel, and P = P1*P2 must leave the column stage a tile in
    shared memory (large2f_supported)."""
    best = None
    for p1 in (256, 128):
        if n % p1:
            continue
        m = n // p1
        for q in (4096, 2048):
            if m % q:
                continue
            p2 = m // q
            if p2 < 8 or p2 > 64 or (p2 & (p2 - 1)):
                continue
            inner = None
            for q1 in range(2, 257):
                if q % q1:
                    continue
                q2 = q // q1
                if q2 > 256:
                    continue
                key = (q1 + q2, abs(q1 - q2))
                if inner is None or key < inner[0]:
                    inner = (key, q1, q2)
            if inner is None:
                continue
            _, q1, q2 = inner
            key = (-q, p1)
            if best is None or key < best[0]:
                best = (key, p1, p2, q1, q2)
    if best is None:
        return None
    _, p1, p2, q1, q2 = best
    return p1, p2, q1, q2, q1 * q2


def large2f_supported(n: int, dtype) -> bool:
    """c64, a split exists, and both passes' tiles fit shared memory: the
    column stage's (P, 16384/P) tile holds P = P1*P2 up to 8192 (n = 2^25);
    2^26's only split, P = 16384, does not fit (the JAX package stops at
    the same n)."""
    if np.dtype(dtype) != np.complex64:
        return False
    sp = choose_split2f(n)
    if sp is None:
        return False
    p1, p2, _, _, q = sp
    return large.col_tile(p1 * p2, q) is not None and large.row_tile(q, p1 * p2) is not None


def col_tables(p1: int, p2: int, q: int, direction: FftDirection):
    """Host tables of the fused column stage, complex64: DFT_P's stage
    tables (P = P1*P2), wob (Q, P1) = w_n^(j3*k1) and wm (Q, P2) =
    w_{P2*Q}^(j3*k2)."""
    p = p1 * p2
    roots, tws = stage_tables(p, large.stage_radices(p), direction)
    wob = outer_table(q, p1, p * q, direction).astype(np.complex64)
    wm = twiddles.twiddle_table(q, p2, direction).astype(np.complex64)
    return roots, tws, wob, wm


def large2f_col_stage_plain(x: torch.Tensor, p1: int, p2: int, q: int, tables) -> torch.Tensor:
    """Plain torch version of large2f_col_stage."""
    roots, tws, wob, wm = tables
    p = p1 * p2
    xt = x.reshape(-1, p, q).transpose(1, 2)  # (B, Q, P) [j3, J]
    a = fft_stages_plain(xt, large.stage_radices(p), roots, tws)  # [j3, K]
    outer = wm[:, :, None] * wob[:, None, :]  # (Q, P2, P1) [j3, k2, k1]
    return (a.reshape(-1, q, p2, p1) * outer).reshape(-1, q, p).contiguous()


def large2f_col_stage(x: torch.Tensor, p1: int, p2: int, q: int, tables) -> torch.Tensor:
    """Fused column stage of x (batch, P1*P2*Q) complex64 -> (batch, Q, P1*P2).

    tables = (roots, tws, wob, wm) from col_tables, on x's device.
    """
    roots, tws, wob, wm = tables
    p = p1 * p2
    if x.dim() != 2:
        raise ValueError(f"large2f_col_stage: expected (batch, n), got {tuple(x.shape)}")
    check_operand(x, (x.shape[0], p * q), "large2f_col_stage input")
    check_stage_tables(p, large.stage_radices(p), roots, tws, x.device, "large2f_col_stage")
    check_operand(wob, (q, p1), "large2f_col_stage wob")
    check_operand(wm, (q, p2), "large2f_col_stage wm")
    if wob.device != x.device or wm.device != x.device:
        raise ValueError(f"large2f_col_stage: tables on {wob.device}, input on {x.device}")
    if x.device.type == "cpu":
        return large2f_col_stage_plain(x, p1, p2, q, tables)
    require_cuda(x, "large2f_col_stage")
    qt = large.col_tile(p, q)
    if qt is None:
        raise ValueError(f"large2f_col_stage: no tile for P={p}, Q={q}")
    y = torch.empty((x.shape[0], q, p), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.rf_large2f_col_stage(
            x.data_ptr(), y.data_ptr(), x.shape[0], p1, p2, q, qt,
            *padded_stage_args(large.stage_radices(p), roots, tws), wob.data_ptr(),
            wm.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "large2f_col_stage")
    large2f_col_stage.launches += 1
    return y


large2f_col_stage.launches = 0


def make_large2f_fft_fn(n: int, direction: FftDirection, dtype,
                        split: Optional[Tuple[int, int, int, int, int]] = None):
    """Return fn: complex64 (..., n) -> (..., n), the two-pass pipeline at
    split = (P1, P2, q1, q2, Q) (default choose_split2f(n)); a split given
    by the caller, as the CPU tests give scaled-down ones, is taken as is.
    `fn.tables` holds the plan's host tables."""
    if np.dtype(dtype) != np.complex64:
        raise ValueError(f"large2f pipeline is complex64 only, got {np.dtype(dtype)}")
    sp = split or (choose_split2f(n) if large2f_supported(n, dtype) else None)
    if sp is None:
        raise ValueError(f"no large2f pipeline for n={n}")
    p1, p2, q1, q2, q = sp
    if q1 * q2 != q or p1 * p2 * q != n:
        raise ValueError(f"split {sp} does not give n={n}")
    p = p1 * p2
    roots_p, tws_p, wob, wm = col_tables(p1, p2, q, direction)
    roots_q, tws_q = large.row_tables(q, direction)
    tables = calg.DeviceTables(roots_p + tws_p + [wob, wm] + roots_q + tws_q)
    kp, kq = len(roots_p), len(roots_q)

    def apply(x):
        t = tables.on(x.device)
        col = (t[:kp], t[kp : 2 * kp - 1], t[2 * kp - 1], t[2 * kp])
        row = (t[2 * kp + 1 : 2 * kp + 1 + kq], t[2 * kp + 1 + kq :])
        a = large2f_col_stage(x.reshape(-1, n).contiguous(), p1, p2, q, col)
        return large.large_row_stage(a, q, p, row).reshape(x.shape)

    apply.tables = tables
    return apply
