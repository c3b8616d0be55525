"""The top power-of-two band as three passes: the port of K11.

Replaces rustfft_tpu/ops/pallas/large3.py (`_kernel_p2`, `_kernel_p2f`,
`_kernel_q`, `choose_split3`, `choose_split3f`, `large3_supported`,
`large3f_supported`, `make_large3_fft_fn`) and, as the P2 chain's plain
version, fused.py:_vpu_fft_list.  n = P1 * P2 * Q, j = j1*(P2*Q) + j2*Q + j3,
X[k3*(P1*P2) + k2*P1 + k1]:

  pass 1: K2's column stage at P = P1 over M = P2*Q columns; factored
      ("large3f", `large3_col_stage`) it applies only the j3 factor
      wob[jr mod Q, k1] = w_n^(k1*j3) of the outer twiddle, unfactored
      (`large.large_col_stage`) the full w_n^(k1*jr) from an (M, P1) table
      of n entries: (B, M, P1) [j2*Q + j3, k1];
  pass 2 (`large3_p2`): times the j2 factor wos[j2, k1] = w_{P1P2}^(k1*j2)
      when factored, DFT_P2 over j2, times w_M^(k2*j3), written as
      (B, Q, P2*P1) [j3, K], K = k2*P1 + k1;
  pass 3: K3's row stage, `large.large_row_stage` at (Q, P1*P2).

Six traversals of the signal.  Each wrapper runs its plain torch version on
a CPU tensor and launches csrc/large3.cu on a CUDA tensor, or raises.  Both
kernels are persistent: a grid sized here from the blocks the card holds
(`resident_blocks`), each block walking a contiguous range of units with
the next unit's input landing by cp.async while it computes.  Pass 1 at P1
= 16 x 16 runs K2's column-tile kernel (csrc/col_tile.cuh) in the unit
order of `col_walk` / `col_unit`: (j3 tile, j2, batch), batch fastest, so
that a block keeps one slice of wob; pass 2 walks the units of `p2_walk` /
`p2_unit`, (k1 chunk, b, j3), units of `p2_cols` k1, and splits DFT_P2 as
`p2_split`.  An input that is not 16-byte aligned is copied first.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...common import FftDirection
from ... import twiddles
from .. import calg
from . import _build, large
from .large2f import outer_table
from .lanepack import (
    check_operand, check_stage_tables, fft_stages_plain, padded_stage_args, require_cuda,
    stage_tables,
)

#: the largest P2 of the factored split, the JAX rule's (2^27): pass 2's
#: kernel splits DFT_P2 into two radices, RA <= 16 and RB <= 8 (p2_split)
MAX_P2 = 128


def _balanced_q(q: int) -> Optional[Tuple[int, int]]:
    """The most balanced q = q1 * q2 with q1, q2 <= 256."""
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
    return None if inner is None else inner[1:]


def _choose(n: int, p2_max: int, key) -> Optional[Tuple[int, int, int, int, int]]:
    best = None
    for p1 in (256, 128):
        if n % p1:
            continue
        m = n // p1
        for q in (4096, 2048):
            if m % q:
                continue
            p2 = m // q
            if p2 < 2 or p2 > p2_max or (p2 & (p2 - 1)):
                continue
            qq = _balanced_q(q)
            if qq is None:
                continue
            k = key(q, p1, p2)
            if best is None or k < best[0]:
                best = (k, p1, p2) + qq
    if best is None:
        return None
    _, p1, p2, q1, q2 = best
    return p1, p2, q1, q2, q1 * q2


@functools.lru_cache(maxsize=256)
def choose_split3(n: int) -> Optional[Tuple[int, int, int, int, int]]:
    """(P1, P2, q1, q2, Q) for the unfactored pipeline, the JAX package's
    rule: P1 in {256, 128}, P2 a power of 2 in [2, 16], Q = q1*q2 in
    {4096, 2048}; the largest Q, then the smallest P1.  P2 <= 16 keeps pass
    1's (M, P1) twiddle table, n entries, at 2^24 and below; large3f has no
    such table."""
    return _choose(n, 16, lambda q, p1, p2: (-q, p1, p2))


def large3_supported(n: int, dtype) -> bool:
    return np.dtype(dtype) == np.complex64 and _fits(choose_split3(n))


@functools.lru_cache(maxsize=256)
def choose_split3f(n: int) -> Optional[Tuple[int, int, int, int, int]]:
    """(P1, P2, q1, q2, Q) for the factored pipeline, the JAX package's
    rule: choose_split3's with P2 up to MAX_P2 and the preference largest
    Q, then the smallest P2, then the smallest P1.  2^26 gives (256, 64,
    64, 64, 4096), 2^27 (256, 128, 64, 64, 4096)."""
    return _choose(n, MAX_P2, lambda q, p1, p2: (-q, p2, p1))


def large3f_supported(n: int, dtype) -> bool:
    return np.dtype(dtype) == np.complex64 and _fits(choose_split3f(n))


def _fits(sp) -> bool:
    """Pass 1's and pass 3's tiles fit shared memory."""
    if sp is None:
        return False
    p1, p2, _, _, q = sp
    return large.col_tile(p1, p2 * q) is not None and large.row_tile(q, p1 * p2) is not None


def col_walk(batch: int, groups: int, slices: int, resident: int) -> Tuple[int, int]:
    """(grid, per) of pass 1's persistent grid over batch * groups * slices
    units (groups = P2, slices = Q/16 tiles of 16 columns j3) when the card
    holds `resident` blocks at once: large.col_walk's contiguous ranges, in
    the order of col_unit."""
    return large.col_walk(batch * groups * slices, resident)


def col_unit(v: int, batch: int, groups: int, slices: int) -> Tuple[int, int, int, int]:
    """(batch row, j2, slice s, tile t) of pass 1's unit v: batch fastest,
    then j2 < groups, then the j3 tile s < slices, the slowest; the tile t =
    j2 * slices + s holds the columns j2*Q + 16s .. + 15 and reads wob's
    rows 16s .. 16s + 15 (s = t mod slices).  One group is K2's order
    (large.col_walk: t = s = v // batch)."""
    b, w = v % batch, v // batch
    s, j2 = divmod(w, groups)
    return b, j2, s, j2 * slices + s


def p2_split(p2: int) -> Tuple[int, int]:
    """(RA, RB) with RA * RB = P2 of pass 2's split DFT (csrc/large3.cu
    P2Split): j2 = jb + RB*ja, k2 = ka + RA*kb, DFT_RA over ja in stage A,
    DFT_RB over jb in stage B; 16 x 8 at 128, 8 x 8 at 64, 8 x 4, 4 x 4,
    and one radix (RB = 1) at 8, 4 and 2."""
    if p2 < 2 or p2 > MAX_P2 or p2 & (p2 - 1):
        raise ValueError(f"p2_split: P2={p2} is not a power of 2 in [2, {MAX_P2}]")
    ra = 4 if p2 == 16 else 16 if p2 == 128 else min(p2, 8)
    return ra, p2 // ra


def p2_cols(p2: int) -> int:
    """W, the k1 of pass 2's unit (csrc/large3.cu P2Split::W): P2 row
    pieces of W*8 bytes, 32 KiB a unit; 64 up to P2 = 64, 32 at 128."""
    return 32 if p2 > 64 else 64


def p2_chunks(p1: int, p2: int) -> int:
    """Pass 2's chunks of W = p2_cols(P2) k1 (the last one narrower where
    W does not divide P1)."""
    return -(-p1 // p2_cols(p2))


def p2_walk(batch: int, q: int, p1: int, p2: int, resident: int) -> Tuple[int, int]:
    """(grid, per) of pass 2's persistent grid over batch * Q *
    p2_chunks(P1, P2) units when the card holds `resident` blocks at once:
    contiguous ranges (large.col_walk) in the order of p2_unit."""
    return large.col_walk(batch * q * p2_chunks(p1, p2), resident)


def p2_unit(u: int, batch: int, q: int) -> Tuple[int, int, int]:
    """(k1 chunk, b, j3) of pass 2's unit u: j3 fastest, then the batch
    row, the chunk of W k1 the slowest, so that a block's range holds few
    chunks and keeps one slice of wos over many units."""
    chunk, r = divmod(u, batch * q)
    b, j3 = divmod(r, q)
    return chunk, b, j3


def resident_blocks(which: int) -> int:
    """The blocks the current device holds at once of pass 1's tile kernel
    (which = 0) or of pass 2's kernel at P2 = which."""
    lib = _build.load()
    out = ctypes.c_int(0)
    _build.check(lib, lib.rf_large3_resident_blocks(which, ctypes.byref(out)),
                 "large3 resident_blocks")
    return out.value


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, which: int) -> int:
    with torch.cuda.device(device_index):
        return resident_blocks(which)


def _resident_on(device: torch.device, which: int) -> int:
    return _resident(device.index if device.index is not None else torch.cuda.current_device(),
                     which)


def col_tables(p1: int, m: int, q: int, direction: FftDirection):
    """Host tables of the factored pass 1, complex64: DFT_P1's stage tables
    and wob (Q, P1) = w_n^(j3*k1), n = P1*M."""
    roots, tws = stage_tables(p1, large.stage_radices(p1), direction)
    return roots, tws, outer_table(q, p1, p1 * m, direction).astype(np.complex64)


def p2_tables(p1: int, p2: int, q: int, direction: FftDirection, factored: bool):
    """Host tables of pass 2, complex64: the roots w_P2^e (P2,), wos (P2, P1)
    = w_{P1P2}^(j2*k1) (None unfactored) and wm (Q, P2) = w_{P2*Q}^(j3*k2)."""
    roots = stage_tables(p2, (p2,), direction)[0][0]
    wos = twiddles.twiddle_table(p2, p1, direction).astype(np.complex64) if factored else None
    return roots, wos, twiddles.twiddle_table(q, p2, direction).astype(np.complex64)


def large3_col_stage_plain(x: torch.Tensor, p1: int, m: int, q: int, tables) -> torch.Tensor:
    """Plain torch version of large3_col_stage."""
    roots, tws, wob = tables
    xt = x.reshape(-1, p1, m).transpose(1, 2)  # (B, M, P1) [jr, j1]
    a = fft_stages_plain(xt, large.stage_radices(p1), roots, tws)
    return (a.reshape(-1, m // q, q, p1) * wob).reshape(-1, m, p1).contiguous()


def large3_col_stage(x: torch.Tensor, p1: int, m: int, q: int, tables) -> torch.Tensor:
    """Factored pass 1 of x (batch, P1*M) complex64 -> (batch, M, P1).

    tables = (roots, tws, wob) from col_tables, on x's device.
    """
    roots, tws, wob = tables
    if x.dim() != 2:
        raise ValueError(f"large3_col_stage: expected (batch, n), got {tuple(x.shape)}")
    if m % q:
        raise ValueError(f"large3_col_stage: Q={q} does not divide M={m}")
    check_operand(x, (x.shape[0], p1 * m), "large3_col_stage input")
    check_stage_tables(p1, large.stage_radices(p1), roots, tws, x.device, "large3_col_stage")
    check_operand(wob, (q, p1), "large3_col_stage wob")
    if wob.device != x.device:
        raise ValueError(f"large3_col_stage: tables on {wob.device}, input on {x.device}")
    if x.device.type == "cpu":
        return large3_col_stage_plain(x, p1, m, q, tables)
    require_cuda(x, "large3_col_stage")
    qt = large.col_tile(p1, m)
    if qt is None:
        raise ValueError(f"large3_col_stage: no tile for P={p1}, M={m}")
    y = torch.empty((x.shape[0], m, p1), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    walk = [0, 0]
    if (large.stage_radices(p1), qt) == large.TILE_COL and q % qt == 0:
        x = large._aligned16(x)
        walk = list(col_walk(x.shape[0], m // q, q // qt, _resident_on(x.device, 0)))
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.rf_large3_col_stage(
            x.data_ptr(), y.data_ptr(), x.shape[0], p1, m, q, qt,
            *padded_stage_args(large.stage_radices(p1), roots, tws), wob.data_ptr(), *walk,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "large3_col_stage")
    large3_col_stage.launches += 1
    return y


large3_col_stage.launches = 0


def p2_chain_plain(vs: List[torch.Tensor], roots: torch.Tensor) -> List[torch.Tensor]:
    """Radix-2 decimation-in-time FFT over a list of equal-shape tensors,
    natural order in and out (fused.py:_vpu_fft_list): the butterfly
    twiddle w_r^c of a length-r sub-transform is roots[c * (P2 / r)]."""
    r = len(vs)
    if r == 1:
        return vs
    even = p2_chain_plain(vs[0::2], roots)
    odd = p2_chain_plain(vs[1::2], roots)
    h = r // 2
    stride = roots.shape[0] // r
    out = [None] * r
    for c in range(h):
        t = odd[c] * roots[c * stride]
        out[c] = even[c] + t
        out[c + h] = even[c] - t
    return out


def large3_p2_plain(a: torch.Tensor, p1: int, p2: int, q: int, tables) -> torch.Tensor:
    """Plain torch version of large3_p2."""
    roots, wos, wm = tables
    v = a.reshape(-1, p2, q, p1)
    if wos is not None:
        v = v * wos[:, None, :]
    b = torch.stack(p2_chain_plain(list(v.unbind(1)), roots), dim=2)  # (B, Q, P2, P1) [j3, k2, k1]
    return (b * wm[:, :, None]).reshape(-1, q, p2 * p1)


def large3_p2(a: torch.Tensor, p1: int, p2: int, q: int, tables) -> torch.Tensor:
    """Pass 2 of a (batch, P2*Q, P1) complex64 -> (batch, Q, P2*P1).

    tables = (roots, wos, wm) from p2_tables, on a's device; wos None skips
    the j2 factor.
    """
    roots, wos, wm = tables
    if a.dim() != 3:
        raise ValueError(f"large3_p2: expected (batch, M, P1), got {tuple(a.shape)}")
    if p2 < 2 or p2 & (p2 - 1):
        raise ValueError(f"large3_p2: P2={p2} is not a power of 2 >= 2")
    check_operand(a, (a.shape[0], p2 * q, p1), "large3_p2 input")
    check_operand(roots, (p2,), "large3_p2 roots")
    check_operand(wm, (q, p2), "large3_p2 wm")
    if wos is not None:
        check_operand(wos, (p2, p1), "large3_p2 wos")
    if any(t is not None and t.device != a.device for t in tables):
        raise ValueError(f"large3_p2: tables on another device than the input ({a.device})")
    if a.device.type == "cpu":
        return large3_p2_plain(a, p1, p2, q, tables)
    require_cuda(a, "large3_p2")
    if p2 > MAX_P2:
        raise ValueError(f"large3_p2: P2={p2} above {MAX_P2}")
    if p1 % 2:
        raise ValueError(f"large3_p2: P1={p1} is odd (the kernel copies 16-byte pieces)")
    y = torch.empty((a.shape[0], q, p2 * p1), dtype=a.dtype, device=a.device)
    if a.shape[0] == 0:
        return y
    a = large._aligned16(a)
    grid, per = p2_walk(a.shape[0], q, p1, p2, _resident_on(a.device, p2))
    lib = _build.load()
    with torch.cuda.device(a.device):
        code = lib.rf_large3_p2(
            a.data_ptr(), y.data_ptr(), a.shape[0], p1, p2, q, roots.data_ptr(),
            None if wos is None else wos.data_ptr(), wm.data_ptr(), grid, per,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _build.check(lib, code, "large3_p2")
    large3_p2.launches += 1
    return y


large3_p2.launches = 0


def make_large3_fft_fn(n: int, direction: FftDirection, dtype,
                       split: Optional[Tuple[int, int, int, int, int]] = None,
                       factored: bool = False):
    """Return fn: complex64 (..., n) -> (..., n), the three-pass pipeline at
    split = (P1, P2, q1, q2, Q) (default choose_split3f(n) when factored,
    else choose_split3(n)); a split given by the caller is taken as is.
    `fn.tables` holds the plan's host tables."""
    if np.dtype(dtype) != np.complex64:
        raise ValueError(f"large3 pipeline is complex64 only, got {np.dtype(dtype)}")
    if split is None:
        supported = large3f_supported if factored else large3_supported
        split = (choose_split3f if factored else choose_split3)(n) if supported(n, dtype) else None
    if split is None:
        raise ValueError(f"no large3{'f' if factored else ''} pipeline for n={n}")
    p1, p2, q1, q2, q = split
    if q1 * q2 != q or p1 * p2 * q != n:
        raise ValueError(f"split {split} does not give n={n}")
    m = p2 * q
    if factored:
        roots1, tws1, outer = col_tables(p1, m, q, direction)
    else:
        roots1, tws1, outer = large.col_tables(p1, m, direction)
    roots2, wos, wm = p2_tables(p1, p2, q, direction, factored)
    roots_q, tws_q = large.row_tables(q, direction)
    mid = [roots2, wm] + ([wos] if factored else [])
    tables = calg.DeviceTables(roots1 + tws1 + [outer] + mid + roots_q + tws_q)
    k1, kq, k2 = len(roots1), len(roots_q), len(mid)

    def apply(x):
        t = tables.on(x.device)
        col = (t[:k1], t[k1 : 2 * k1 - 1], t[2 * k1 - 1])
        r2, w_m = t[2 * k1], t[2 * k1 + 1]
        w_os = t[2 * k1 + 2] if factored else None
        row = (t[2 * k1 + k2 : 2 * k1 + k2 + kq], t[2 * k1 + k2 + kq :])
        x2 = x.reshape(-1, n).contiguous()
        a = (large3_col_stage(x2, p1, m, q, col) if factored
             else large.large_col_stage(x2, p1, m, col))
        b = large3_p2(a, p1, p2, q, (r2, w_os, w_m))
        return large.large_row_stage(b, q, p1 * p2, row).reshape(x.shape)

    apply.tables = tables
    return apply
