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

At the route's splits (P = 512*C, C = 2, 4, 8, 16; `cluster_form`) the
column stage runs csrc/large2f.cu's col_cluster_kernel: a thread-block
cluster of C blocks holds a (P, 16) tile, block r the rows J = r mod C, so
every row piece is 128 bytes; each block runs the chain's first two stages
on its rows, the last stage runs across the cluster through distributed
shared memory, and a persistent grid of clusters (`cluster_grid`) walks the
(batch, tile) units (`cluster_walk`).  Other splits keep csrc/large.cuh's
column stage at the tile width large.col_tile gives.
"""
from __future__ import annotations

import ctypes
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


#: the column chains with a cluster kernel, P = 1024 .. 8192
#: (csrc/large2f.cu col_cluster_chain)
CLUSTER_CHAINS = ((16, 16, 4), (16, 16, 8), (16, 16, 16), (32, 16, 16))

#: rows a block of the cluster kernel holds, P / C, and columns of a unit
CLUSTER_ROWS = 512
CLUSTER_COLS = 16


def cluster_form(p: int, p1: int, q: int) -> Optional[int]:
    """The cluster size C = P / CLUSTER_ROWS of col_cluster_kernel at P = p,
    or None where the column stage keeps large.cuh's kernel: a chain
    (R0, R1, R2) of CLUSTER_CHAINS, Q a multiple of 16 and P1 dividing R0*R1
    (the kernel reads wob[j3, K mod P1] once for the R2 outputs K = h +
    R0*R1*k2)."""
    radices = large.stage_radices(p)
    if radices not in CLUSTER_CHAINS or q % CLUSTER_COLS or (radices[0] * radices[1]) % p1:
        return None
    return p // CLUSTER_ROWS


def cluster_grid(units: int, resident: int) -> int:
    """Clusters of the cluster kernel's persistent grid for `units`
    (batch*Q/16) units when the card holds `resident` clusters at once: every
    resident cluster, at most one a unit."""
    if units < 1 or resident < 1:
        raise ValueError(f"cluster_grid: units={units}, resident={resident}")
    return min(units, resident)


def cluster_walk(clusters: int, units: int, tiles: int):
    """The units cluster g of cluster_grid's grid runs, for g < clusters, as
    (batch row, column tile): unit u = b*tiles + tile, cluster g taking u =
    g, g + clusters, ... (csrc/large2f.cu col_cluster_kernel), so that the
    clusters at work at one time hold neighbouring tiles of the same rows."""
    return [[divmod(u, tiles) for u in range(g, units, clusters)] for g in range(clusters)]


def max_active_clusters(p: int) -> int:
    """The clusters of the cluster kernel at P = p (P / 512 blocks each) the
    current device holds at once (cudaOccupancyMaxActiveClusters)."""
    lib = _build.load()
    out = ctypes.c_int(0)
    _build.check(lib, lib.rf_large2f_max_active_clusters(p, ctypes.byref(out)),
                 "large2f max_active_clusters")
    return out.value


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, p: int) -> int:
    with torch.cuda.device(device_index):
        return max_active_clusters(p)


def large2f_col_stage_plain(x: torch.Tensor, p1: int, p2: int, q: int, tables) -> torch.Tensor:
    """Plain torch version of large2f_col_stage."""
    roots, tws, wob, wm = tables
    p = p1 * p2
    xt = x.reshape(-1, p, q).transpose(1, 2)  # (B, Q, P) [j3, J]
    a = fft_stages_plain(xt, large.stage_radices(p), roots, tws)  # [j3, K]
    outer = wm[:, :, None] * wob[:, None, :]  # (Q, P2, P1) [j3, k2, k1]
    return (a.reshape(-1, q, p2, p1) * outer).reshape(-1, q, p).contiguous()


def _col_stage(x: torch.Tensor, p1: int, p2: int, q: int, tables, counter,
               stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """large2f_col_stage; counter.launches counts the launches.  With
    `stamps`, the cluster kernel's stamped form (the library built with
    RF_PHASE_STAMPS)."""
    what = counter.__name__
    roots, tws, wob, wm = tables
    p = p1 * p2
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (batch, n), got {tuple(x.shape)}")
    check_operand(x, (x.shape[0], p * q), f"{what} input")
    check_stage_tables(p, large.stage_radices(p), roots, tws, x.device, what)
    check_operand(wob, (q, p1), f"{what} wob")
    check_operand(wm, (q, p2), f"{what} wm")
    if wob.device != x.device or wm.device != x.device:
        raise ValueError(f"{what}: tables on {wob.device}, input on {x.device}")
    if x.device.type == "cpu":
        return large2f_col_stage_plain(x, p1, p2, q, tables)
    require_cuda(x, what)
    c = cluster_form(p, p1, q)
    qt = CLUSTER_COLS if c is not None else large.col_tile(p, q)
    if qt is None:
        raise ValueError(f"{what}: no tile for P={p}, Q={q}")
    y = torch.empty((x.shape[0], q, p), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    clusters = 0
    if c is not None:
        if x.data_ptr() % 16:  # the tiles land by 16-byte copies
            x = x.clone()
        index = x.device.index if x.device.index is not None else torch.cuda.current_device()
        clusters = cluster_grid(x.shape[0] * (q // CLUSTER_COLS), _resident(index, p))
    lib = _build.load(phase_stamps=stamps is not None)
    args = [x.data_ptr(), y.data_ptr(), x.shape[0], p1, p2, q, qt,
            *padded_stage_args(large.stage_radices(p), roots, tws), wob.data_ptr(),
            wm.data_ptr(), c or 0, clusters]
    launch = lib.rf_large2f_col_stage
    if stamps is not None:
        launch, args = lib.rf_large2f_col_phase_stamps, args + [stamps.data_ptr()]
    with torch.cuda.device(x.device):
        code = launch(*args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, what)
    counter.launches += 1
    return y


def large2f_col_stage(x: torch.Tensor, p1: int, p2: int, q: int, tables) -> torch.Tensor:
    """Fused column stage of x (batch, P1*P2*Q) complex64 -> (batch, Q, P1*P2).

    tables = (roots, tws, wob, wm) from col_tables, on x's device.
    """
    return _col_stage(x, p1, p2, q, tables, large2f_col_stage)


large2f_col_stage.launches = 0

#: the phases of the cluster kernel's stamped form: the wait for a unit's
#: tile, the two local stages, the exchange with the last stage, the next
#: unit's copies with the twiddled stores
K10_PHASES = ("wait", "stages", "exchange", "store")


def large2f_col_phase_stamps(x: torch.Tensor, p1: int, p2: int, q: int, tables):
    """large2f_col_stage on the card through the cluster kernel's stamped
    form (cluster_form only; only the library built with RF_PHASE_STAMPS
    has it, and no route launches it): (y, stamps), stamps (blocks, 5)
    int64 nanoseconds of %globaltimer, each block's start and that start
    plus the running sums of its K10_PHASES over its units, each read by
    the block's thread 0 after a block barrier."""
    what = "large2f_col_phase_stamps"
    require_cuda(x, what)
    p = p1 * p2
    c = cluster_form(p, p1, q)
    if c is None or x.shape[0] == 0:
        raise ValueError(f"{what}: P={p}, Q={q}, batch {x.shape[0]} has no stamped form")
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    blocks = c * cluster_grid(x.shape[0] * (q // CLUSTER_COLS), _resident(index, p))
    stamps = torch.zeros((blocks, len(K10_PHASES) + 1), dtype=torch.int64, device=x.device)
    y = _col_stage(x, p1, p2, q, tables, large2f_col_phase_stamps, stamps)
    return y, stamps


large2f_col_phase_stamps.launches = 0


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

