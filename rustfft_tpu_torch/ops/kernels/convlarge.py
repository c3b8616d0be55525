"""The fused large Bluestein convolution: the port of K15.

Replaces rustfft_tpu/ops/pallas/convlarge.py (`_kernel_bconv`, `_kernel_a2`,
`bconv_supported`, `make_bluestein_large_fn`): a Bluestein of length n on
an inner m = P * Q (`split(m)`) in three launches, where the two-pass core
(ops/kernels/conv_radix.py) takes four:

  A       the zero pad, the chirp, DFT_P and w_m^(k1*j2), (B, n) -> (B, Q,
          P).  It takes the place of the JAX package's XLA prologue and
          `large._kernel_a`;
  B_conv  per column k1, FFT_Q, conj(. * H), FFT_Q in the same direction
          and w_m^(l1*k1), [j2, k1] -> [l1, k1] (the mirrored
          factorisation, convlarge.py:13-32);
  A2      DFT_P over k1 and out[l2*Q + l1] = chirp[l] * conj(.) for l < n,
          -> (B, n).

The JAX kernel slices DFT_P to its `pkeep` live rows and slices the output
after; here A2 computes every row and skips the stores with l >= n, so the
epilogue's slice pass disappears.

`split(m)` puts P = 16 x 16 wherever m / 256 is one of COLUMN_FORMS (Q =
144 .. 1296, 1536 .. 8192, 12288 and 24576: every inner length the planner
gives a prime of [8192, 2^22] that takes K15, tools/torch_prime_cores.py),
and there the tile form runs (`tile_form`): three persistent tile walks
that hold the signal between them in columns (B, P, Q) (`to_columns`), so
that a B_conv unit of T columns and its slices of h and outer (held the
same way) are T*Q consecutive values:
  `bconv_col_tile` (kernel A): K2's column-tile kernel with a chirp source
      (pre from L1 in stage 0, rows beyond n zero, 8-byte copies of the
      rows that are not 16-byte aligned) and a column store;
  `bconv_row_tile` (B_conv): two blocks an SM, the unit landing by
      cp.async, two in-place chains of register radices (the first leaves
      its output digit-reversed, `bconv_positions`, and multiplies by h,
      which the host stores in that order, `bconv_h_table`; the second,
      the first reversed, ends in natural order), the last stage storing
      times outer: csrc/convlarge.cu at Q = 8192 (one column a unit),
      csrc/bconv_cols.cu and csrc/bconv_cols_small.cu at the other Q up to
      12288 (1 to 64 columns a unit), csrc/bconv_pair.cu at Q = 24576 (a
      cluster of two blocks a column, the chain's first and last radix 2
      across the pair);
  `bconv_out_tile` (A2): 16 rows l1 a unit, DFT_P in place, the next
      unit's tile landing in a second buffer, 16 consecutive l a store.
B_conv's units run batch rows fastest (`bconv_unit`, `bconv_grid`), kernel
A's and A2's contiguous ranges of them (large.col_walk), so the tables'
slices are read from device memory about once.  Other splits keep the
general kernels, and `make_bluestein_large_fn(..., general=True)` builds
them at large.choose_pqq(m) anywhere (no planner path takes them; the tests
and tools hold the tile form against them): kernel A is
`conv_radix.conv_col_stage(general=True)` (the two-pass core's column stage
on csrc/large.cuh), then `bconv_row_stage` and `bconv_out_stage`: B_conv
holds a (Q, pt) tile of the row layout (B, Q, P) in two buffers,
`bconv_tile` checks that it fits.  Host tables are the JAX package's,
built in f64 and cast to complex64: the chirp, H = h_fft as (Q, P), the
(Q, P) outer twiddle and the output chirp.  Each wrapper runs its plain
version on a CPU tensor and launches its kernel (csrc/convlarge.cu,
csrc/bconv_cols.cu, csrc/bconv_pair.cu) on a CUDA tensor, or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ...common import FftDirection
from .. import calg
from ..bluestein import bluestein_tables
from . import _build, conv, conv_radix, fused, large, largepad
from .lanepack import (
    check_operand, check_stage_tables, fft_stages_plain, padded_stage_args, require_cuda,
)


def bconv_tile(q: int, p: int) -> Optional[int]:
    """Columns k1 per block of the general B_conv kernel: the widest of 16,
    8, 4, 2, 1 that divides P and whose (Q, pt) tile (two buffers, both
    chains in turn) fits shared memory."""
    return conv_radix.row_tile(q, p)


def out_tile(p: int, q: int) -> Optional[int]:
    """Rows l1 per A2 block: the row-stage rule with the axes swapped, the
    widest of 16, 8, 4, 2, 1 that divides Q and whose (P, qt) tile fits
    shared memory (16 rows: 128-byte stores)."""
    return conv_radix.row_tile(p, q)


def _tiles_fit(p: int, q: int) -> bool:
    return (conv_radix.col_tile(p, q) is not None and bconv_tile(q, p) is not None
            and out_tile(p, q) is not None)


def bconv_supported(m: int, dtype) -> bool:
    """c64, K15's split of m (`split`) in the tile form or with the general
    kernels' tiles fitting shared memory, and executor.route(m) == "large"
    (the JAX rule: the JAX executor's
    condition pallas_route(m) == "large"), or "two_stage" on a cluster
    where the route was "large" before K7's cluster band took it: large's
    tiles are not narrowed (largepad.narrowed_by_division), as at 36864
    and 49152.  The band's former large_pad m (41472 = 256 x 162, 62208 =
    256 x 243) stay off K15, as before the band.  The JAX rule would leave the former
    "large" m to the two-pass core, and K15 beat it on the card: 24571 x
    2048 (m = 49152) ran 5.846 / 5.854 ms on K15 against 7.208 / 7.233 ms on
    the two-pass core, in turns (chip_smoke.py; NVIDIA H100 80GB HBM3,
    700 W)."""
    from ... import executor

    if np.dtype(dtype) != np.complex64 or not large.large_supported(m, dtype):
        return False
    name = executor.route(m, dtype)
    if name != "large" and not (name == "two_stage" and fused.two_stage_cluster_supported(m, dtype)
                                and not largepad.narrowed_by_division(m)):
        return False
    p, q1, q2 = split(m)
    return tile_form(p, q1 * q2) or _tiles_fit(p, q1 * q2)


def bconv_tables(n: int, m: int, p: int, q: int, direction: FftDirection):
    """Host tables by name, complex64: "col" (roots, tws, outer) of DFT_P
    and the (Q, P) outer twiddle (large.col_tables; A2 uses its roots and
    tws), "row" (roots, tws) of FFT_Q, "pre" the chirp zero-extended to m,
    "h" the spectrum h_fft as (Q, P), "chirp" the output chirp (n,)."""
    chirp, h_fft = bluestein_tables(n, m, direction)
    return {
        "col": large.col_tables(p, q, direction),
        "row": large.row_tables(q, direction),
        "pre": conv_radix.zero_extended(chirp, m),
        "h": np.ascontiguousarray(h_fft.reshape(q, p)).astype(np.complex64),
        "chirp": chirp.astype(np.complex64),
    }


def bconv_row_stage_plain(a: torch.Tensor, q: int, p: int, tables, h, outer) -> torch.Tensor:
    """Plain torch version of bconv_row_stage."""
    x = large.large_row_stage_plain(a, q, p, tables)  # X[k2*P + k1]
    z = torch.conj(x * h.reshape(-1)).resolve_conj().reshape(-1, q, p)
    u = large.large_row_stage_plain(z, q, p, tables)  # [l1*P + k1]
    return (u * outer.reshape(-1)).reshape(-1, q, p)


def bconv_row_stage(a: torch.Tensor, q: int, p: int, tables, h: torch.Tensor,
                    outer: torch.Tensor) -> torch.Tensor:
    """B_conv: a (batch, Q, P) complex64 [j2, k1] -> (batch, Q, P) [l1, k1]:
    FFT_Q, conj(. * h), FFT_Q, times outer.

    tables = (roots, tws) from large.row_tables(Q, direction); h, outer:
    (Q, P) complex64, on a's device.
    """
    roots, tws = tables
    if a.dim() != 3:
        raise ValueError(f"bconv_row_stage: expected (batch, Q, P), got {tuple(a.shape)}")
    check_operand(a, (a.shape[0], q, p), "bconv_row_stage input")
    radices = large.stage_radices(q)
    check_stage_tables(q, radices, roots, tws, a.device, "bconv_row_stage")
    for t, what in ((h, "h"), (outer, "outer twiddle")):
        check_operand(t, (q, p), f"bconv_row_stage {what}")
        if t.device != a.device:
            raise ValueError(f"bconv_row_stage: {what} on {t.device}, input on {a.device}")
    if a.device.type == "cpu":
        return bconv_row_stage_plain(a, q, p, tables, h, outer)
    require_cuda(a, "bconv_row_stage")
    pt = bconv_tile(q, p)
    if pt is None:
        raise ValueError(f"bconv_row_stage: no tile for Q={q}, P={p}")
    y = torch.empty_like(a)
    if a.shape[0] == 0:
        return y
    lib = _build.load()
    with torch.cuda.device(a.device):
        code = lib.rf_bconv_row_stage(
            a.data_ptr(), y.data_ptr(), a.shape[0], q, p, pt,
            *padded_stage_args(radices, roots, tws), h.data_ptr(), outer.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _build.check(lib, code, "bconv_row_stage")
    bconv_row_stage.launches += 1
    return y


#: kernel launches since the count was last set to 0
bconv_row_stage.launches = 0


def bconv_out_stage_plain(b: torch.Tensor, p: int, q: int, tables, chirp: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Plain torch version of bconv_out_stage."""
    roots, tws = tables
    d = fft_stages_plain(b, large.stage_radices(p), roots, tws)  # [l1, l2]
    d = d.transpose(1, 2).reshape(b.shape[0], -1)[:, :n]  # l = l2*Q + l1
    return (chirp * torch.conj(d)).resolve_conj()


def bconv_out_stage(b: torch.Tensor, p: int, q: int, tables, chirp: torch.Tensor,
                    n: int) -> torch.Tensor:
    """A2: b (batch, Q, P) complex64 [l1, k1] -> (batch, n):
    out[l2*Q + l1] = chirp[l] * conj(DFT_P over k1) for l < n.

    tables = (roots, tws) of DFT_P (large.col_tables(P, Q, direction)[:2]);
    chirp (n,) complex64; on b's device.
    """
    roots, tws = tables
    if b.dim() != 3:
        raise ValueError(f"bconv_out_stage: expected (batch, Q, P), got {tuple(b.shape)}")
    check_operand(b, (b.shape[0], q, p), "bconv_out_stage input")
    if not 0 < n <= p * q:
        raise ValueError(f"bconv_out_stage: n={n} not in [1, {p * q}]")
    radices = large.stage_radices(p)
    check_stage_tables(p, radices, roots, tws, b.device, "bconv_out_stage")
    check_operand(chirp, (n,), "bconv_out_stage chirp")
    if chirp.device != b.device:
        raise ValueError(f"bconv_out_stage: chirp on {chirp.device}, input on {b.device}")
    if b.device.type == "cpu":
        return bconv_out_stage_plain(b, p, q, tables, chirp, n)
    require_cuda(b, "bconv_out_stage")
    qt = out_tile(p, q)
    if qt is None:
        raise ValueError(f"bconv_out_stage: no tile for P={p}, Q={q}")
    y = torch.empty((b.shape[0], n), dtype=b.dtype, device=b.device)
    if b.shape[0] == 0:
        return y
    lib = _build.load()
    with torch.cuda.device(b.device):
        code = lib.rf_bconv_out_stage(
            b.data_ptr(), y.data_ptr(), b.shape[0], p, q, qt, n,
            *padded_stage_args(radices, roots, tws), chirp.data_ptr(),
            torch.cuda.current_stream(b.device).cuda_stream,
        )
    _build.check(lib, code, "bconv_out_stage")
    bconv_out_stage.launches += 1
    return y


bconv_out_stage.launches = 0


# -- the tile form (P = 16 x 16 and the Q of COLUMN_FORMS) -------------------

#: the tile form's chains: DFT_P of kernel A and A2 at P = 256 (K2's
#: column-tile kernel, csrc/col_tile.cuh, and bconv_out_tile_kernel)
TILE_P = (16, 16)
#: Q of the 1000003 path (m = 2^21), whose B_conv has its own kernel
#: (csrc/convlarge.cu bconv_tile_kernel)
TILE_Q = 8192

#: B_conv's forms by Q: chain 1's radices (register radices, the first
#: leaving W_0 = Q / r_0 a multiple of 16) and the columns a unit holds, the
#: most that divide 256 and leave two 256-thread blocks an SM
#: (csrc/bconv_cols.cu with_form and csrc/bconv_cols_small.cu
#: with_small_form; 8192, one column, csrc/convlarge.cu; PAIR_Q,
#: csrc/bconv_pair.cu, one column on a cluster of two blocks).  Chain 1, in
#: place, leaves its output digit-reversed (bconv_positions); chain 2 is the
#: chain reversed and ends in natural order.  The Q below 8192 carry 52817
#: of the primes in [8192, 2^20]; 12288 and 24576 carry the 107354
#: Bluesteins of (2^20, 2^22] on 3*2^20 and 3*2^21
#: (tools/torch_prime_cores.py).
COLUMN_FORMS = {
    144: ((9, 16), 64),
    192: ((12, 16), 64),
    288: ((2, 9, 16), 32),
    384: ((3, 8, 16), 32),
    432: ((3, 9, 16), 32),
    576: ((6, 6, 16), 16),
    768: ((3, 16, 16), 16),
    864: ((6, 9, 16), 16),
    1152: ((9, 8, 16), 8),
    1296: ((9, 9, 16), 8),
    1536: ((6, 16, 16), 8),
    1728: ((12, 16, 9), 8),
    2048: ((8, 16, 16), 4),
    2304: ((9, 16, 16), 4),
    3072: ((12, 16, 16), 4),
    4096: ((16, 16, 16), 2),
    6144: ((3, 8, 16, 16), 2),
    TILE_Q: ((2, 16, 16, 16), 1),
    12288: ((3, 16, 16, 16), 1),
    24576: ((2, 3, 16, 16, 16), 1),
}

#: the Q whose column is held by a cluster of two blocks, 12288 values each
#: (csrc/bconv_pair.cu): chain 1's first radix 2 and chain 2's last run
#: across the pair, the other stages are the Q = 12288 form's
PAIR_Q = 24576


def tile_form(p: int, q: int) -> bool:
    """The split runs the tile form: DFT_P as 16 x 16 (P = 256) and Q one
    of COLUMN_FORMS; other splits keep the general kernels."""
    return large.stage_radices(p) == TILE_P and q in COLUMN_FORMS


def split(m: int) -> Optional[Tuple[int, int, int]]:
    """K15's split (P, q1, q2) of m: P = 256 where m / 256 has a B_conv form
    (COLUMN_FORMS), so that kernel A and A2 run their tile kernels, with the
    most balanced q1 x q2 of at most 256 each; large.choose_pqq(m)
    elsewhere.  Only 3*2^21 differs from choose_pqq, whose P = 512 x Q =
    12288 the general kernels ran."""
    p, q = TILE_P[0] * TILE_P[1], m // (TILE_P[0] * TILE_P[1])
    pqq = large.choose_pqq(m)
    if m % p or q not in COLUMN_FORMS or (pqq is not None and pqq[0] == p):
        return pqq
    pairs = [(a, q // a) for a in range(2, large.MAX_Q_FACTOR + 1)
             if q % a == 0 and q // a <= large.MAX_Q_FACTOR]
    q1, q2 = min(pairs, key=lambda t: (t[0] + t[1], abs(t[0] - t[1])))
    return p, q1, q2


#: split, under a name that make_bluestein_large_fn's keyword does not hide
_k15_split = split


def column_chain(q: int) -> Tuple[int, ...]:
    """Chain 1's radices of B_conv at Q (COLUMN_FORMS)."""
    return COLUMN_FORMS[q][0]


def _weights(chain) -> list:
    """The position weight W_s = Q / (r_0 .. r_s) of each digit of chain 1."""
    return conv.chain_weights(chain)


@functools.lru_cache(maxsize=16)
def bconv_positions(q: int = TILE_Q) -> np.ndarray:
    """(Q,) int64: the frequency k whose value chain 1 (radices r_s) leaves
    at position pos = sum_s k_s * W_s, k = k_0 + r_0*k_1 + r_0*r_1*k_2 + ...
    (at Q = 8192: pos = 4096*k0 + 256*k1 + 16*k2 + k3, k = k0 + 2*k1 +
    32*k2 + 512*k3): conv.chain_positions of the form's chain."""
    return conv.chain_positions(column_chain(q))


def bconv_chain_tables(direction: FftDirection, q: int = TILE_Q):
    """B_conv's tables in the tile form, complex64: (roots, tws).  roots: at
    Q = 8192 the roots of w_2 and w_16, else each stage's roots; tws: chain
    1's twiddle tables (r_s, W_s) and chain 2's, whose columns (the input
    digits not yet taken) are laid out by the column's position digits
    above the stage (conv.double_chain_tables)."""
    roots, tws1, tws2 = conv.double_chain_tables(q, column_chain(q), direction)
    if q == TILE_Q:
        roots = [roots[0], roots[1]]
    return roots, tws1 + tws2


def bconv_h_table(h: np.ndarray) -> np.ndarray:
    """B_conv's h in the tile form: the (Q, P) spectrum as columns (P, Q),
    each column in chain 1's output positions (bconv_positions)."""
    h = np.asarray(h)
    return np.ascontiguousarray(h.T[:, bconv_positions(h.shape[0])])


def to_columns(a: torch.Tensor) -> torch.Tensor:
    """(..., Q, P) -> the column layout (..., P, Q) of the tile form: the Q
    values of a column, one B_conv tile, are consecutive."""
    return a.transpose(-2, -1).contiguous()


def from_columns(a: torch.Tensor) -> torch.Tensor:
    """The inverse of to_columns: (..., P, Q) -> (..., Q, P)."""
    return a.transpose(-2, -1).contiguous()


def bconv_unit(u: int, batch: int) -> Tuple[int, int]:
    """(column, batch row) of unit u of B_conv's tile walk: batch rows
    fastest, so that the blocks at work at one time share one or two
    columns' slices of h and outer (csrc/convlarge.cu bc_offset)."""
    return u // batch, u % batch


def bconv_grid(units: int, resident: int) -> int:
    """Blocks of B_conv's persistent grid for `units` (batch * P) units
    when the card holds `resident` blocks at once: every resident block, at
    most one a unit.  Block g runs the units g, g + grid, ... below units
    (bconv_unit)."""
    if units < 1 or resident < 1:
        raise ValueError(f"bconv_grid: units={units}, resident={resident}")
    return min(units, resident)


#: the tile kernels, by resident_blocks' index
TILE_KERNELS = ("col", "row", "out")


def resident_blocks(kind: str) -> int:
    """The blocks of the tile form's kernel A ("col"), B_conv ("row") or A2
    ("out") the current device holds at once."""
    lib = _build.load()
    out = ctypes.c_int(0)
    _build.check(lib, lib.rf_bconv_resident_blocks(TILE_KERNELS.index(kind), ctypes.byref(out)),
                 "bconv resident_blocks")
    return out.value


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, kind: str) -> int:
    with torch.cuda.device(device_index):
        return resident_blocks(kind)


def _resident_on(device: torch.device, kind: str) -> int:
    return _resident(device.index if device.index is not None else torch.cuda.current_device(),
                     kind)


def _check_tile_form(p: int, q: int, what: str) -> None:
    if not tile_form(p, q):
        raise ValueError(f"{what}: P={p}, Q={q} is not the tile form ({TILE_P}, Q in "
                         f"{sorted(COLUMN_FORMS)})")


@functools.lru_cache(maxsize=None)
def _cols_resident(device_index: int, q: int) -> int:
    """The blocks of B_conv's form at Q (csrc/bconv_cols.cu) the device
    holds at once."""
    with torch.cuda.device(device_index):
        lib = _build.load()
        out = ctypes.c_int(0)
        _build.check(lib, lib.rf_bconv_cols_resident(q, ctypes.byref(out)),
                     "bconv_cols resident_blocks")
        return out.value


@functools.lru_cache(maxsize=None)
def _pair_clusters(device_index: int) -> int:
    """The clusters of B_conv's pair form (csrc/bconv_pair.cu) the device
    runs at once."""
    with torch.cuda.device(device_index):
        lib = _build.load()
        out = ctypes.c_int(0)
        _build.check(lib, lib.rf_bconv_pair_clusters(ctypes.byref(out)), "bconv_pair clusters")
        return out.value


def _row_tile_resident(device: torch.device, q: int) -> int:
    """The blocks of B_conv's tile kernel at Q the device holds at once (at
    PAIR_Q, its clusters of two blocks)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if q == TILE_Q:
        return _resident_on(device, "row")
    if q == PAIR_Q:
        return _pair_clusters(index)
    return _cols_resident(index, q)


def bconv_col_tile_plain(x: torch.Tensor, p: int, q: int, tables, pre) -> torch.Tensor:
    """Plain torch version of bconv_col_tile."""
    return to_columns(conv_radix.conv_col_stage_plain(x, p, q, tables, pre)[0])


def _col_tile_checks(x, p, q, tables, pre, what):
    conv_radix._check_rows(x, f"{what} input")
    _check_tile_form(p, q, what)
    if not 0 < x.shape[1] <= p * q:
        raise ValueError(f"{what}: n={x.shape[1]} not in [1, {p * q}]")
    roots, tws, outer = tables
    check_stage_tables(p, TILE_P, roots, tws, x.device, what)
    for t, shape, name in ((outer, (q, p), "outer twiddle"), (pre, (p * q,), "pre")):
        check_operand(t, shape, f"{what} {name}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, input on {x.device}")


def _col_tile_launch(x, p, q, tables, pre, what, stamps=None):
    roots, tws, outer = tables
    batch = x.shape[0]
    a = torch.empty((batch, p, q), dtype=x.dtype, device=x.device)
    grid, per = large.col_walk(batch * (q // 16), _resident_on(x.device, "col"))
    lib = _build.load(phase_stamps=stamps is not None)
    args = (x.data_ptr(), a.data_ptr(), batch, x.shape[1],
            x.stride(0) if batch > 1 else x.shape[1], p, q, 2, 16, 16, roots[0].data_ptr(),
            roots[1].data_ptr(), tws[0].data_ptr(), outer.data_ptr(), pre.data_ptr(), grid, per)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if stamps is None:
            code = lib.rf_bconv_col_tile(*args, stream)
        else:
            code = lib.rf_bconv_col_tile_stamps(*args, stamps.data_ptr(), stream)
    _build.check(lib, code, what)
    return a


def bconv_col_tile(x: torch.Tensor, p: int, q: int, tables, pre: torch.Tensor) -> torch.Tensor:
    """Kernel A of the tile form: x (batch, n) complex64, rows contiguous
    (any stride between them) -> (batch, P, Q) in columns: the
    input zero-padded to m = P*Q, times pre, DFT_P over j1 and w_m^(k1*j2).

    tables = (roots, tws, outer) from large.col_tables(P, Q, direction);
    pre (m,) complex64, zero from n.  K2's persistent column-tile kernel
    (csrc/col_tile.cuh) on col_walk's grid with a chirp source that copies
    rows 8 bytes at a time where they are not 16-byte aligned, so a
    misaligned input is never copied.
    """
    what = "bconv_col_tile"
    _col_tile_checks(x, p, q, tables, pre, what)
    if x.device.type == "cpu":
        return bconv_col_tile_plain(x, p, q, tables, pre)
    require_cuda(x, what)
    if x.shape[0] == 0:
        return torch.empty((0, p, q), dtype=x.dtype, device=x.device)
    a = _col_tile_launch(x, p, q, tables, pre, what)
    bconv_col_tile.launches += 1
    return a


#: kernel launches since the count was last set to 0
bconv_col_tile.launches = 0


def _stage_roots(q: int, roots):
    """Each stage's roots of chain 1 from bconv_chain_tables' roots."""
    if q == TILE_Q:
        r2, r16 = roots
        return [r2, r16, r16, r16]
    return list(roots)


def bconv_row_tile_plain(a: torch.Tensor, q: int, p: int, tables, h, outer) -> torch.Tensor:
    """Plain torch version of bconv_row_tile, in natural order: FFT_Q of each
    column by chain 1's stages, conj(. * h), FFT_Q, times outer."""
    roots, tws = tables
    chain = column_chain(q)
    roots = _stage_roots(q, roots)
    inv = torch.from_numpy(np.argsort(bconv_positions(q))).to(h.device)
    chain_tws = tws[: len(chain) - 1]
    z = fft_stages_plain(a, chain, roots, chain_tws)
    z = torch.conj(z * torch.index_select(h, -1, inv)).resolve_conj()
    return fft_stages_plain(z, chain, roots, chain_tws) * outer


def chain_table_shapes(q: int):
    """(roots shapes, twiddle shapes) of bconv_chain_tables at Q."""
    chain = column_chain(q)
    weights = _weights(chain)
    tw1 = [(r, w) for r, w in zip(chain[:-1], weights[:-1])]
    tw2 = [(chain[-1 - t], int(np.prod(chain[: len(chain) - 1 - t])))
           for t in range(len(chain) - 1)]
    roots = [(2,), (16,)] if q == TILE_Q else [(r,) for r in chain]
    return roots, tw1 + tw2


def _row_tile_checks(a, q, p, tables, h, outer, what):
    _check_tile_form(p, q, what)
    if a.dim() != 3:
        raise ValueError(f"{what}: expected (batch, P, Q), got {tuple(a.shape)}")
    check_operand(a, (a.shape[0], p, q), f"{what} input")
    roots, tws = tables
    root_shapes, tw_shapes = chain_table_shapes(q)
    if len(roots) != len(root_shapes) or len(tws) != len(tw_shapes):
        raise ValueError(f"{what}: expected {len(root_shapes)} roots and {len(tw_shapes)} "
                         "twiddle tables")
    for i, (t, shape) in enumerate(zip(roots, root_shapes)):
        check_operand(t, shape, f"{what} roots[{i}]")
    for i, (t, shape) in enumerate(zip(tws, tw_shapes)):
        check_operand(t, shape, f"{what} tws[{i}]")
    for t in [*roots, *tws]:
        if t.device != a.device:
            raise ValueError(f"{what}: tables on {t.device}, input on {a.device}")
    for t, name in ((h, "h"), (outer, "outer twiddle")):
        check_operand(t, (p, q), f"{what} {name}")
        if t.device != a.device:
            raise ValueError(f"{what}: {name} on {t.device}, input on {a.device}")


def _row_tile_launch(a, q, p, tables, h, outer, what, stamps=None):
    roots, tws = tables
    y = torch.empty_like(a)
    src = large._aligned16(a)
    chain, width = COLUMN_FORMS[q]
    grid = bconv_grid(a.shape[0] * (p // width), _row_tile_resident(a.device, q))
    tw = (ctypes.c_void_p * len(tws))(*[t.data_ptr() for t in tws])  # host array of pointers
    lib = _build.load(phase_stamps=stamps is not None)
    if q == TILE_Q:
        r2, r16 = roots
        args = (src.data_ptr(), y.data_ptr(), a.shape[0], p, r2.data_ptr(), r16.data_ptr(),
                ctypes.addressof(tw), h.data_ptr(), outer.data_ptr(), grid)
        launch = lib.rf_bconv_row_tile_stamps if stamps is not None else lib.rf_bconv_row_tile
    elif q == PAIR_Q:  # grid: clusters of two blocks
        rp = (ctypes.c_void_p * len(roots))(*[t.data_ptr() for t in roots])
        args = (src.data_ptr(), y.data_ptr(), a.shape[0], p, ctypes.addressof(rp),
                ctypes.addressof(tw), h.data_ptr(), outer.data_ptr(), grid)
        launch = lib.rf_bconv_pair_stamps if stamps is not None else lib.rf_bconv_pair
    else:
        rp = (ctypes.c_void_p * len(roots))(*[t.data_ptr() for t in roots])
        radices = list(chain) + [1] * (4 - len(chain))
        args = (src.data_ptr(), y.data_ptr(), a.shape[0], p, q, len(chain), *radices, width,
                ctypes.addressof(rp), ctypes.addressof(tw), h.data_ptr(), outer.data_ptr(), grid)
        launch = lib.rf_bconv_cols_stamps if stamps is not None else lib.rf_bconv_cols
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if stamps is None:
            code = launch(*args, stream)
        else:
            code = launch(*args, stamps.data_ptr(), stream)
    _build.check(lib, code, what)
    return y


def bconv_row_tile(a: torch.Tensor, q: int, p: int, tables, h: torch.Tensor,
                   outer: torch.Tensor) -> torch.Tensor:
    """B_conv of the tile form: a (batch, P, Q) [k1, j2] in columns -> the
    same layout [k1, l1]: FFT_Q, conj(. * h), FFT_Q, times outer
    (bconv_row_stage on columns).

    tables = bconv_chain_tables(direction, Q) on a's device, Q one of
    COLUMN_FORMS; h (P, Q) from bconv_h_table, outer (P, Q) (to_columns of
    the (Q, P) outer twiddle), complex64 on a's device.  A persistent grid
    of bconv_grid blocks over units of COLUMN_FORMS[Q][1] columns, two
    blocks an SM: at Q = 8192 one column of 64 KiB (csrc/convlarge.cu), at
    PAIR_Q one column on a cluster of two blocks of 96 KiB
    (csrc/bconv_pair.cu; the grid counts clusters), else 64-108 KiB
    (csrc/bconv_cols.cu, csrc/bconv_cols_small.cu).
    """
    what = "bconv_row_tile"
    _row_tile_checks(a, q, p, tables, h, outer, what)
    if a.device.type == "cpu":
        return bconv_row_tile_plain(a, q, p, tables, h, outer)
    require_cuda(a, what)
    if a.shape[0] == 0:
        return torch.empty_like(a)
    y = _row_tile_launch(a, q, p, tables, h, outer, what)
    bconv_row_tile.launches += 1
    return y


bconv_row_tile.launches = 0


def bconv_out_tile_plain(b: torch.Tensor, p: int, q: int, tables, chirp, n: int) -> torch.Tensor:
    """Plain torch version of bconv_out_tile."""
    return bconv_out_stage_plain(from_columns(b), p, q, tables, chirp, n)


def _out_tile_checks(b, p, q, tables, chirp, n, what):
    _check_tile_form(p, q, what)
    if b.dim() != 3:
        raise ValueError(f"{what}: expected (batch, P, Q), got {tuple(b.shape)}")
    check_operand(b, (b.shape[0], p, q), f"{what} input")
    if not 0 < n <= p * q:
        raise ValueError(f"{what}: n={n} not in [1, {p * q}]")
    roots, tws = tables
    check_stage_tables(p, TILE_P, roots, tws, b.device, what)
    check_operand(chirp, (n,), f"{what} chirp")
    if chirp.device != b.device:
        raise ValueError(f"{what}: chirp on {chirp.device}, input on {b.device}")


def _out_tile_launch(b, p, q, tables, chirp, n, what, stamps=None):
    roots, tws = tables
    y = torch.empty((b.shape[0], n), dtype=b.dtype, device=b.device)
    src = large._aligned16(b)
    grid, per = large.col_walk(b.shape[0] * (q // 16), _resident_on(b.device, "out"))
    lib = _build.load(phase_stamps=stamps is not None)
    args = (src.data_ptr(), y.data_ptr(), b.shape[0], q, n, n, 2, 16, 16, roots[0].data_ptr(),
            roots[1].data_ptr(), tws[0].data_ptr(), chirp.data_ptr(), grid, per)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream(b.device).cuda_stream
        if stamps is None:
            code = lib.rf_bconv_out_tile(*args, stream)
        else:
            code = lib.rf_bconv_out_tile_stamps(*args, stamps.data_ptr(), stream)
    _build.check(lib, code, what)
    return y


def bconv_out_tile(b: torch.Tensor, p: int, q: int, tables, chirp: torch.Tensor,
                   n: int) -> torch.Tensor:
    """A2 of the tile form: b (batch, P, Q) [k1, l1] in columns -> (batch,
    n): out[l2*Q + l1] = chirp[l] * conj(DFT_P over k1) for l < n
    (bconv_out_stage on columns).

    tables = (roots, tws) of DFT_P = 16 x 16; chirp (n,) complex64.  A
    persistent grid of col_walk blocks over (16-row tile, batch) units,
    batch fastest.
    """
    what = "bconv_out_tile"
    _out_tile_checks(b, p, q, tables, chirp, n, what)
    if b.device.type == "cpu":
        return bconv_out_tile_plain(b, p, q, tables, chirp, n)
    require_cuda(b, what)
    if b.shape[0] == 0:
        return torch.empty((0, n), dtype=b.dtype, device=b.device)
    y = _out_tile_launch(b, p, q, tables, chirp, n, what)
    bconv_out_tile.launches += 1
    return y


bconv_out_tile.launches = 0


#: the phases of the tile kernels' stamped forms (tools/torch_phase_times.py):
#: kernel A's load with stage 0, stage 1 with the outer twiddle, the store in
#: columns (large.COL_PHASES); B_conv's wait for its tile with chain 1 and
#: h, chain 2's first three stages, its last stage with the store and the
#: next tile's copies started; A2's stage 0 (with the wait), stage 1, the
#: store
COL_TILE_PHASES = ("load+s0", "s1", "store")
ROW_TILE_PHASES = ("load+chain1+h", "chain2 s0-s2", "s3+store")
OUT_TILE_PHASES = ("load+s0", "s1", "store")


def _stamps(x: torch.Tensor, kind: str, what: str, resident: Optional[int] = None) -> torch.Tensor:
    require_cuda(x, what)
    if x.shape[0] == 0:
        raise ValueError(f"{what}: an empty batch has no phases")
    blocks = _resident_on(x.device, kind) if resident is None else resident
    return torch.zeros((blocks, 4), dtype=torch.int64, device=x.device)


def bconv_col_tile_stamps(x: torch.Tensor, p: int, q: int, tables, pre: torch.Tensor):
    """bconv_col_tile on the card through its stamped form (the
    RF_PHASE_STAMPS library, which no route loads): (a, stamps), stamps
    (blocks, 4) int64 nanoseconds of %globaltimer, each block's start and
    that start plus the running sums of COL_TILE_PHASES over its units."""
    what = "bconv_col_tile_stamps"
    _col_tile_checks(x, p, q, tables, pre, what)
    stamps = _stamps(x, "col", what)
    a = _col_tile_launch(x, p, q, tables, pre, what, stamps)
    return a, stamps[stamps[:, 0] != 0]


def bconv_row_tile_stamps(a: torch.Tensor, q: int, p: int, tables, h: torch.Tensor,
                          outer: torch.Tensor):
    """bconv_row_tile through its stamped form, as bconv_col_tile_stamps:
    (y, stamps) with ROW_TILE_PHASES."""
    what = "bconv_row_tile_stamps"
    _row_tile_checks(a, q, p, tables, h, outer, what)
    blocks = _row_tile_resident(a.device, q) * (2 if q == PAIR_Q else 1)
    stamps = _stamps(a, "row", what, blocks)
    y = _row_tile_launch(a, q, p, tables, h, outer, what, stamps)
    return y, stamps[stamps[:, 0] != 0]


def bconv_out_tile_stamps(b: torch.Tensor, p: int, q: int, tables, chirp: torch.Tensor, n: int):
    """bconv_out_tile through its stamped form, as bconv_col_tile_stamps:
    (y, stamps) with OUT_TILE_PHASES."""
    what = "bconv_out_tile_stamps"
    _out_tile_checks(b, p, q, tables, chirp, n, what)
    stamps = _stamps(b, "out", what)
    y = _out_tile_launch(b, p, q, tables, chirp, n, what, stamps)
    return y, stamps[stamps[:, 0] != 0]


def make_bluestein_large_fn(n: int, m: int, direction: FftDirection, dtype,
                            split: Optional[Tuple[int, int, int]] = None, general: bool = False):
    """Return fn: complex64 (..., n) -> (..., n): Bluestein through the three
    kernels at inner m = P * q1 * q2 >= 2n - 1 (split default split(m)):
    the tile form where tile_form(P, Q) holds, else the general kernels.
    general=True: the general kernels at `split` (default
    large.choose_pqq(m)), the form the tile form replaced, which no planner
    path takes."""
    if np.dtype(dtype) != np.complex64:
        raise ValueError(f"the fused large Bluestein is complex64 only, got {np.dtype(dtype)}")
    split = split or (large.choose_pqq(m) if general else _k15_split(m))
    if split is None or split[0] * split[1] * split[2] != m:
        raise ValueError(f"no split for the inner length m={m}: {split}")
    p, q = split[0], split[1] * split[2]
    tiled = tile_form(p, q) and not general
    if not tiled and not _tiles_fit(p, q):
        raise ValueError(f"fused large Bluestein: no tiles for P={p}, Q={q}")
    host = bconv_tables(n, m, p, q, direction)
    roots_p, tws_p, outer = host["col"]
    roots_q, tws_q = host["row"]
    kp, kq = len(roots_p), len(roots_q)
    h = host["h"]
    bconv_outer = outer
    if tiled:  # B_conv's chain and tables as columns
        roots_q, tws_q = bconv_chain_tables(direction, q)
        kq = len(roots_q)
        h, bconv_outer = bconv_h_table(h), to_columns(torch.from_numpy(outer)).numpy()
    tables = calg.DeviceTables([*roots_p, *tws_p, outer, *roots_q, *tws_q,
                                host["pre"], h, bconv_outer, host["chirp"]])

    kt = len(tws_q)

    def apply(x):
        t = tables.on(x.device)
        col = (t[:kp], t[kp : 2 * kp - 1], t[2 * kp - 1])
        row = (t[2 * kp : 2 * kp + kq], t[2 * kp + kq : 2 * kp + kq + kt])
        pre, h, bconv_outer, chirp = t[2 * kp + kq + kt :]
        rows = x.reshape(-1, n)
        if tiled:
            a = bconv_col_tile(rows if rows.stride(-1) == 1 else rows.contiguous(), p, q, col, pre)
            b = bconv_row_tile(a, q, p, row, h, bconv_outer)
            return bconv_out_tile(b, p, q, col[:2], chirp, n).reshape(x.shape)
        a, _ = conv_radix.conv_col_stage(rows.contiguous(), p, q, col, pre=pre, general=True)
        b = bconv_row_stage(a, q, p, row, h, bconv_outer)
        return bconv_out_stage(b, p, q, col[:2], chirp, n).reshape(x.shape)

    return apply
