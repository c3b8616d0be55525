"""Large-n FFT as two passes: the ports of K2, K3 and K4.

Replaces rustfft_tpu/ops/pallas/large.py (`_kernel_a`, `_kernel_b` with
`fftq_sublane`, their Gauss, deep and 2-D forms, `choose_pqq`,
`make_large_fft_fn`).  For n = P * Q, Q = q1 * q2, the input viewed as
(B, P, Q) [j1, j2]:

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

K4's Gauss kernels (`_kernel_a_gauss`, `_kernel_b_gauss` with
`fftq_sublane_gauss`) are `large_col_stage_gauss` and
`large_row_stage_gauss` (csrc/large_gauss.cu): the same stages with every
radix stage's DFT as three real products (P1 = xr.Wr, P2 = xi.Wi,
P3 = (xr + xi).Ws; re = P1 - P2, im = P3 - P1 - P2) from `gauss_tables`.
At TILE_COL and TILE_ROW they run K2's and K3's tile kernels in that form,
DFT_16 with its tables as constants (csrc/gauss16.cuh, `gauss_header`);
elsewhere csrc/large.cuh's general kernels.  K4's deep and 2-D forms are
K2 and K3 themselves (see make_large_fft_fn).

Two reads and two writes of the signal in device memory.  Each wrapper runs
its plain torch version on a CPU tensor and launches its kernel in
csrc/large.cu or csrc/large_gauss.cu on a CUDA tensor, or raises.  The 2^20
main path's chains (TILE_COL: P = 16 x 16 over 16 columns; TILE_ROW: Q = 16
x 16 x 16 over 4, also K10's and K11's Q passes) run csrc/large.cu's
persistent tile kernels: a grid sized here from the blocks the card holds
(col_walk, row_grid, resident_blocks), each block walking its units with
the next one's input landing by cp.async while it computes; an input that
is not 16-byte aligned is copied first.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...common import FftDirection
from ...config import config
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

#: the widest P the row-tile kernel takes (csrc/row_tile.cuh: a (4096, P)
#: row's offsets in 32 bits)
ROW_TILE_MAX_P = 32768

#: the column-stage chains with a compile-time kernel in csrc/large.cuh and
#: their tile widths: P = 256 over 16 columns, and the top band's one
#: 128 KiB tile in place, 16384 / P columns at P = 1024 .. 8192
FIXED_COL = {(16, 16): 16, (16, 16, 4): 16, (16, 16, 8): 8, (16, 16, 16): 4, (32, 16, 16): 2}


def col_tile(p: int, q: int, ragged: bool = False, gauss: bool = False) -> Optional[int]:
    """Columns j2 per column-stage block: the compile-time kernel's width
    (FIXED_COL) where it divides Q, else 16 (128-byte row segments) where it
    divides Q and two buffers fit shared memory, else the next smaller power
    of 2.  ragged: the same rule without "divides Q" (the width the tile
    would have if it need not divide; largepad.narrowed_by_division
    compares the two).  gauss: the Gauss form, whose one compile-time
    kernel is the tile kernel's (TILE_COL: P = 16 x 16 over 16 columns);
    elsewhere it runs the general kernel (general_col_tile)."""
    fixed = (TILE_COL[1] if stage_radices(p) == TILE_COL[0] else None) if gauss else \
        FIXED_COL.get(stage_radices(p))
    if fixed is not None and (ragged or q % fixed == 0):
        return fixed
    return general_col_tile(p, q, ragged, gauss)


def general_col_tile(p: int, q: int, ragged: bool = False, gauss: bool = False) -> Optional[int]:
    """Columns j2 per block of csrc/large.cuh's general column kernel: 16
    where it divides Q and two buffers fit shared memory, else the next
    smaller power of 2 (col_tile's rule off the compile-time kernels)."""
    for qt in (16, 8, 4, 2, 1):
        if ((ragged or q % qt == 0)
                and smem_bytes(p * qt, stage_radices(p), gauss) <= _build.SMEM_MAX):
            return qt
    return None


def row_tile(q: int, p: int, ragged: bool = False, gauss: bool = False) -> Optional[int]:
    """Columns k1 per row-stage block: 4 for the compile-time chain (one
    buffer of 128 KiB), else 2 where a (Q, 2) tile fits shared memory, else
    1; None when one column does not fit.  ragged: the same rule without
    "divides P".  gauss: the Gauss form, whose one compile-time kernel is
    the tile kernel's (TILE_ROW, at P <= ROW_TILE_MAX_P); elsewhere it runs
    the general kernel (general_row_tile)."""
    radices = stage_radices(q)
    if (radices == FIXED_ROW[0] and (ragged or p % FIXED_ROW[1] == 0)
            and (not gauss or p <= ROW_TILE_MAX_P)):
        return FIXED_ROW[1]
    return general_row_tile(q, p, ragged, gauss)


def general_row_tile(q: int, p: int, ragged: bool = False, gauss: bool = False) -> Optional[int]:
    """Columns k1 per block of csrc/large.cuh's general row kernel: 2 where
    a (Q, 2) tile fits shared memory, else 1; None when one column does not
    fit (row_tile's rule off the compile-time kernels)."""
    radices = stage_radices(q)
    for pt in (2, 1):
        if (ragged or p % pt == 0) and smem_bytes(q * pt, radices, gauss) <= _build.SMEM_MAX:
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


#: the column and row chains that run the persistent tile kernels of
#: csrc/large.cu (K2 at P = 16 x 16, K3 at Q = 16 x 16 x 16)
TILE_COL = ((16, 16), 16)
TILE_ROW = FIXED_ROW


def row_grid(tiles: int, resident: int) -> int:
    """Blocks of K3's persistent grid for `tiles` (batch*P/4) tiles when the
    card holds `resident` blocks at once: every resident block, at most one
    a tile.  Block g runs the tiles g, g + grid, ... below tiles, so the
    blocks at work at one time hold neighbouring tiles."""
    if tiles < 1 or resident < 1:
        raise ValueError(f"row_grid: tiles={tiles}, resident={resident}")
    return min(tiles, resident)


def col_walk(units: int, resident: int) -> Tuple[int, int]:
    """(grid, per) of K2's persistent grid for `units` (batch*Q/16) units
    when the card holds `resident` blocks at once.  Unit v is the tile v //
    batch of the batch row v % batch (batch fastest); block g runs the
    contiguous units [g*per, min((g + 1)*per, units)), so that it keeps one
    tile, and with it one slice of the outer twiddle, over many rows.  per
    is the fewest units a block that lets `resident` blocks cover them; grid
    the blocks that then hold any."""
    if units < 1 or resident < 1:
        raise ValueError(f"col_walk: units={units}, resident={resident}")
    per = -(-units // resident)
    return -(-units // per), per


def walk_units(grid: int, per: int, units: int):
    """The units block g of col_walk's grid runs, for g < grid: the ranges
    the kernel walks (csrc/large.cu col_tile_kernel)."""
    return [range(g * per, min((g + 1) * per, units)) for g in range(grid)]


#: the tile kernels whose resident blocks resident_blocks reads: K2's and
#: K3's, and their Gauss forms (K4's column and row stages)
RESIDENT_KINDS = ("col", "row", "col_gauss", "row_gauss")


def resident_blocks(kind: str) -> int:
    """The blocks of K2's ("col") or K3's ("row") tile kernel, or of its
    Gauss form ("col_gauss", "row_gauss"), the current device holds at once
    (its SMs times cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = _build.load()
    out = ctypes.c_int(0)
    which = RESIDENT_KINDS.index(kind)
    fn = lib.rf_large_resident_blocks if which < 2 else lib.rf_large_gauss_resident_blocks
    _build.check(lib, fn(which % 2, ctypes.byref(out)), "resident_blocks")
    return out.value


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, kind: str) -> int:
    with torch.cuda.device(device_index):
        return resident_blocks(kind)


def _resident_on(device: torch.device, kind: str) -> int:
    return _resident(device.index if device.index is not None else torch.cuda.current_device(),
                     kind)


def _aligned16(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it where its data is not 16-byte aligned (a view at
    an odd offset): the tile kernels read their input by 16-byte copies."""
    return x.clone() if x.data_ptr() % 16 else x


def large_supported(n: int, dtype) -> bool:
    return np.dtype(dtype) == np.complex64 and choose_pqq(n) is not None


def gauss_tables(radices: Sequence[int], direction: FftDirection) -> List[np.ndarray]:
    """The Gauss form's stage tables: per radix r a (3, r) float32 array of
    Wr, Wi and Ws = Wr + Wi of the roots w_r^e, each computed in float64 and
    cast, so that W[j][k] = table[:, (j*k) mod r] is the entry of the JAX
    package's gauss_tables(dft_matrix(r)) (rustfft_tpu/ops/pallas/fused.py,
    without its bf16 split: the card contracts in float32)."""
    out = []
    for r in radices:
        w = twiddles.dft_matrix(r, direction)[1]
        out.append(np.stack([w.real, w.imag, w.real + w.imag]).astype(np.float32))
    return out


def gauss_header() -> str:
    """The text of csrc/gauss16.cuh: gauss_tables((r,), direction) of both
    directions for r = 16 and 8 as the float literals of Gauss16<kInverse>
    and Gauss8<kInverse>, whose call at root index e is {Wr, Wi, Ws, 0}
    there, each the shortest decimal that reads back as the same float32
    (the DFT_16 constants of the Gauss tile kernels, and the DFT_16 and
    DFT_8 constants of the radix body's Gauss form)."""
    lines = [
        "// The constants of the Gauss form's DFT_16 and DFT_8: DFT_16 in the tile",
        "// kernels (csrc/tile_walk.cuh tile_dft16), both in the radix body's Gauss",
        "// form (csrc/radix.cuh gauss_dft), each through csrc/fft_tile.cuh",
        "// gauss_column.  GaussR<kInverse>{}(e) = {Wr, Wi, Ws, 0} at root index e,",
        "// 0 <= e < R, the columns of rustfft_tpu_torch/ops/kernels/large.py",
        "// gauss_tables((R,), direction) (Wr + i Wi = w_R^(+-e), Ws = Wr + Wi, each",
        "// computed in float64 and cast to float32).  Written by large.py",
        "// gauss_header(); tests/test_torch_gauss_tiles.py and",
        "// tests/test_torch_gauss_cluster.py hold this file to it.  Every call in the",
        "// kernels has a constant e after unrolling, so each switch folds to",
        "// immediates.",
        "#pragma once",
        "",
        "#include <cuda_runtime.h>",
        "",
        "namespace rf {",
    ]
    for r in (16, 8):
        lines += ["", "template <bool kInverse>", f"struct Gauss{r};"]
        for inverse, d in ((False, FftDirection.FORWARD), (True, FftDirection.INVERSE)):
            (g,) = gauss_tables((r,), d)
            lines += ["", "template <>", f"struct Gauss{r}<{str(inverse).lower()}> {{",
                      "  __device__ __forceinline__ float4 operator()(int e) const {",
                      "    switch (e) {"]
            for e in range(r):
                vals = ", ".join(f"{np.float32(v)!s}f" for v in g[:, e])
                lines.append(f"      case {e}: return make_float4({vals}, 0.f);")
            lines += ["      default: return make_float4(0.f, 0.f, 0.f, 0.f);", "    }", "  }",
                      "};"]
    lines += ["", "}  // namespace rf", ""]
    return "\n".join(lines)


def col_tables(p: int, q: int, direction: FftDirection, gauss: bool = False):
    """Host tables of the column stage: DFT_P's stage tables (the Gauss
    tables in place of the roots with `gauss`) and the outer twiddle (Q, P)
    [j2, k1] = w_n^(k1*j2), complex64."""
    roots, tws = stage_tables(p, stage_radices(p), direction)
    if gauss:
        roots = gauss_tables(stage_radices(p), direction)
    outer = np.ascontiguousarray(twiddles.twiddle_table(p, q, direction).T)
    return roots, tws, outer.astype(np.complex64)


def row_tables(q: int, direction: FftDirection, gauss: bool = False):
    """Host tables of the row stage: the length-Q FFT's stage tables (the
    Gauss tables in place of the roots with `gauss`)."""
    roots, tws = stage_tables(q, stage_radices(q), direction)
    if gauss:
        roots = gauss_tables(stage_radices(q), direction)
    return roots, tws


def gauss_stages_plain(x: torch.Tensor, radices: Sequence[int], gtabs, tws) -> torch.Tensor:
    """lanepack.fft_stages_plain with every stage's contraction in the Gauss
    form: three real products P1 = xr.Wr, P2 = xi.Wi, P3 = (xr + xi).Ws,
    then re = P1 - P2, im = P3 - P1 - P2; the twiddles stay complex
    products."""
    shape = x.shape
    m = shape[-1]
    v = x.reshape(-1, 1, m)
    lead, rest = 1, m
    for s, r in enumerate(radices):
        rest //= r
        j = torch.arange(r, device=x.device)
        w = gtabs[s][:, (j[:, None] * j[None, :]) % r]  # (3, r, r) [., j, k]
        u = v.reshape(-1, lead, r, rest)
        ur, ui = u.real, u.imag
        p1 = torch.einsum("jk,bljr->bklr", w[0], ur)
        p2 = torch.einsum("jk,bljr->bklr", w[1], ui)
        p3 = torch.einsum("jk,bljr->bklr", w[2], ur + ui)
        a = torch.complex(p1 - p2, p3 - p1 - p2)
        if s + 1 < len(radices):
            a = a * tws[s].reshape(1, r, 1, rest)
        lead *= r
        v = a.reshape(-1, lead, rest)
    return v.reshape(shape)


def large_col_stage_plain(x: torch.Tensor, p: int, q: int, tables) -> torch.Tensor:
    """Plain torch version of large_col_stage."""
    roots, tws, outer = tables
    xt = x.reshape(-1, p, q).transpose(1, 2)  # (B, Q, P) [j2, j1]
    return (fft_stages_plain(xt, stage_radices(p), roots, tws) * outer).contiguous()


def large_col_stage_gauss_plain(x: torch.Tensor, p: int, q: int, tables) -> torch.Tensor:
    """Plain torch version of large_col_stage_gauss."""
    gtabs, tws, outer = tables
    xt = x.reshape(-1, p, q).transpose(1, 2)  # (B, Q, P) [j2, j1]
    return (gauss_stages_plain(xt, stage_radices(p), gtabs, tws) * outer).contiguous()


def _col_stage(x: torch.Tensor, p: int, q: int, tables, gauss: bool, counter,
               stamps: Optional[torch.Tensor] = None, general: bool = False) -> torch.Tensor:
    """The column stage in either form; counter.launches counts the launches.
    With `stamps`, the tile kernel's stamped form (the library built with
    RF_PHASE_STAMPS).  Gauss form: `general` launches the general body where
    the tile kernel would run."""
    what = counter.__name__
    roots, tws, outer = tables
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (batch, n), got {tuple(x.shape)}")
    check_operand(x, (x.shape[0], p * q), f"{what} input")
    check_stage_tables(p, stage_radices(p), roots, tws, x.device, what, gauss)
    check_operand(outer, (q, p), f"{what} outer twiddle")
    if outer.device != x.device:
        raise ValueError(f"{what}: tables on {outer.device}, input on {x.device}")
    if x.device.type == "cpu":
        plain = large_col_stage_gauss_plain if gauss else large_col_stage_plain
        return plain(x, p, q, tables)
    require_cuda(x, what)
    qt = general_col_tile(p, q, gauss=gauss) if general else col_tile(p, q, gauss=gauss)
    if qt is None:
        raise ValueError(f"{what}: no tile for P={p}, Q={q}")
    tile = not general and (stage_radices(p), qt) == TILE_COL
    y = torch.empty((x.shape[0], q, p), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    lib = _build.load(phase_stamps=stamps is not None)
    launch = lib.rf_large_col_stage_gauss if gauss else lib.rf_large_col_stage
    walk = [0, 0]
    if tile:
        x = _aligned16(x)
        walk = list(col_walk(x.shape[0] * (q // qt),
                             _resident_on(x.device, "col_gauss" if gauss else "col")))
    args = [x.data_ptr(), y.data_ptr(), x.shape[0], p, q, qt,
            *padded_stage_args(stage_radices(p), roots, tws), outer.data_ptr(), *walk]
    if stamps is not None:
        launch, args = lib.rf_large_col_phase_stamps, args + [stamps.data_ptr()]
    with torch.cuda.device(x.device):
        code = launch(*args, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, what)
    counter.launches += 1
    return y


def large_col_stage(x: torch.Tensor, p: int, q: int, tables) -> torch.Tensor:
    """Column stage of x (batch, P*Q) complex64 -> (batch, Q, P).

    tables = (roots, tws, outer) from col_tables, on x's device.
    """
    return _col_stage(x, p, q, tables, False, large_col_stage)


large_col_stage.launches = 0


def large_col_stage_gauss(x: torch.Tensor, p: int, q: int, tables,
                          general: bool = False) -> torch.Tensor:
    """large_col_stage in the Gauss form (K4's _kernel_a_gauss): DFT_P's
    radix stages as three real products each; at TILE_COL K2's tile kernel
    in that form, elsewhere csrc/large.cuh's general body.

    tables = (gauss tables, tws, outer) from col_tables(..., gauss=True), on
    x's device.  general (for the tests): the general body at TILE_COL too.
    """
    return _col_stage(x, p, q, tables, True, large_col_stage_gauss, general=general)


large_col_stage_gauss.launches = 0


def large_row_stage_plain(a: torch.Tensor, q: int, p: int, tables) -> torch.Tensor:
    """Plain torch version of large_row_stage."""
    roots, tws = tables
    d = fft_stages_plain(a.transpose(1, 2), stage_radices(q), roots, tws)  # [k1, k2]
    return d.transpose(1, 2).reshape(a.shape[0], -1)


def large_row_stage_gauss_plain(a: torch.Tensor, q: int, p: int, tables) -> torch.Tensor:
    """Plain torch version of large_row_stage_gauss."""
    gtabs, tws = tables
    d = gauss_stages_plain(a.transpose(1, 2), stage_radices(q), gtabs, tws)  # [k1, k2]
    return d.transpose(1, 2).reshape(a.shape[0], -1)


def _row_stage(a: torch.Tensor, q: int, p: int, tables, gauss: bool, counter,
               stamps: Optional[torch.Tensor] = None, general: bool = False) -> torch.Tensor:
    """The row stage in either form; counter.launches counts the launches.
    With `stamps`, the tile kernel's stamped form (the library built with
    RF_PHASE_STAMPS); `general` as in _col_stage."""
    what = counter.__name__
    roots, tws = tables
    if a.dim() != 3:
        raise ValueError(f"{what}: expected (batch, Q, P), got {tuple(a.shape)}")
    check_operand(a, (a.shape[0], q, p), f"{what} input")
    radices = stage_radices(q)
    check_stage_tables(q, radices, roots, tws, a.device, what, gauss)
    if a.device.type == "cpu":
        plain = large_row_stage_gauss_plain if gauss else large_row_stage_plain
        return plain(a, q, p, tables)
    require_cuda(a, what)
    pt = general_row_tile(q, p, gauss=gauss) if general else row_tile(q, p, gauss=gauss)
    if pt is None:
        raise ValueError(f"{what}: no tile for Q={q}, P={p}")
    tile = not general and (radices, pt) == TILE_ROW
    y = torch.empty((a.shape[0], q * p), dtype=a.dtype, device=a.device)
    if a.shape[0] == 0:
        return y
    lib = _build.load(phase_stamps=stamps is not None)
    launch = lib.rf_large_row_stage_gauss if gauss else lib.rf_large_row_stage
    grid = [0]
    if tile:
        a = _aligned16(a)
        grid = [row_grid(a.shape[0] * (p // pt),
                         _resident_on(a.device, "row_gauss" if gauss else "row"))]
    args = [a.data_ptr(), y.data_ptr(), a.shape[0], q, p, pt,
            *padded_stage_args(radices, roots, tws), *grid]
    if stamps is not None:
        launch, args = lib.rf_large_row_phase_stamps, args + [stamps.data_ptr()]
    with torch.cuda.device(a.device):
        code = launch(*args, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(lib, code, what)
    counter.launches += 1
    return y


def large_row_stage(a: torch.Tensor, q: int, p: int, tables) -> torch.Tensor:
    """Row stage of a (batch, Q, P) complex64 -> (batch, Q*P) natural order.

    tables = (roots, tws) from row_tables, on a's device.
    """
    return _row_stage(a, q, p, tables, False, large_row_stage)


large_row_stage.launches = 0


def large_row_stage_gauss(a: torch.Tensor, q: int, p: int, tables,
                          general: bool = False) -> torch.Tensor:
    """large_row_stage in the Gauss form (K4's _kernel_b_gauss with
    fftq_sublane_gauss): the length-Q FFT's radix stages as three real
    products each; at TILE_ROW (P <= ROW_TILE_MAX_P) K3's tile kernel in
    that form, elsewhere csrc/large.cuh's general body.

    tables = (gauss tables, tws) from row_tables(..., gauss=True), on a's
    device.  general (for the tests): the general body at TILE_ROW too.
    """
    return _row_stage(a, q, p, tables, True, large_row_stage_gauss, general=general)


large_row_stage_gauss.launches = 0



#: the phases of K2's and K3's stamped forms: the tables and the load with
#: stage 0, stage 1, and the last step (K3: stage 2 with the store; K2: the
#: twiddled transposed store)
COL_PHASES = ("load+s0", "s1", "store")
ROW_PHASES = ("load+s0", "s1", "s2+store")


def _stamped(stage, inp, m: int, other: int, tables, kind: str, counter):
    """One launch of a tile kernel's stamped form: (y, the rows of the
    blocks that ran), from a stamps tensor of a row for every block the card
    holds (the grid's most)."""
    what = counter.__name__
    require_cuda(inp, what)
    if inp.shape[0] == 0:
        raise ValueError(f"{what}: an empty batch has no phases")
    stamps = torch.zeros((_resident_on(inp.device, kind), len(COL_PHASES) + 1),
                         dtype=torch.int64, device=inp.device)
    y = stage(inp, m, other, tables, False, counter, stamps)
    return y, stamps[stamps[:, 0] != 0]


def large_col_phase_stamps(x: torch.Tensor, p: int, q: int, tables):
    """large_col_stage on the card through the tile kernel's stamped form
    (P = 16 x 16; only the library built with RF_PHASE_STAMPS has it, and
    no route launches it): (y, stamps), stamps (blocks, 4) int64
    nanoseconds of %globaltimer, each block's start and that start plus
    the running sums of its COL_PHASES over its units, each read by the
    block's thread 0 after a block barrier."""
    if (stage_radices(p), col_tile(p, q)) != TILE_COL:
        raise ValueError(f"large_col_phase_stamps: P={p}, Q={q} has no stamped form")
    return _stamped(_col_stage, x, p, q, tables, "col", large_col_phase_stamps)


large_col_phase_stamps.launches = 0


def large_row_phase_stamps(a: torch.Tensor, q: int, p: int, tables):
    """large_row_stage on the card through the tile kernel's stamped form
    (Q = 16 x 16 x 16), as large_col_phase_stamps: (y, stamps), stamps
    (blocks, 4) with ROW_PHASES over each block's tiles."""
    if (stage_radices(q), row_tile(q, p)) != TILE_ROW:
        raise ValueError(f"large_row_phase_stamps: Q={q}, P={p} has no stamped form")
    return _stamped(_row_stage, a, q, p, tables, "row", large_row_phase_stamps)


large_row_phase_stamps.launches = 0


def copy_probe(x: torch.Tensor, p: int, strided: bool) -> torch.Tensor:
    """The access-pattern probe of K3's tile (the RF_PHASE_STAMPS library
    only; for timing): a copy of x (batch, 4096*P) complex64 by the grid
    and threads of large.cuh's compile-time row body (one 1024-thread block
    a (4096, 4) tile), 16 values a thread loaded, then stored.  strided:
    each block moves the 32-byte segments of its window from rows P*8 bytes
    apart, as that body's stage 0 loads and its stage 2 stores; else 128 KiB
    of consecutive values."""
    what = "copy_probe"
    check_operand(x, (x.shape[0], 4096 * p), what)
    require_cuda(x, what)
    if p % 4:
        raise ValueError(f"{what}: P={p} is not a multiple of 4")
    y = torch.empty_like(x)
    lib = _build.load(phase_stamps=True)
    with torch.cuda.device(x.device):
        code = lib.rf_large_copy_probe(x.data_ptr(), y.data_ptr(), x.shape[0], p, int(strided),
                                       torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, what)
    return y


#: make_large_fft_fn's contraction orders of the TPU row stage
VARIANTS = ("swap", "wlhs")


def make_large_fft_fn(n: int, direction: FftDirection, dtype,
                      split: Optional[Tuple[int, int, int]] = None, variant: str = "swap",
                      deep_a: Optional[bool] = None, gauss: Optional[bool] = None,
                      blocks2d: Optional[bool] = None):
    """Return fn: complex64 (..., n) -> (..., n), the two-pass pipeline at
    split = (P, q1, q2) (default choose_pqq(n)), with the keywords of the
    JAX package's make_large_fft_fn (large.py:376-619):

      gauss     None resolves to config.large_gauss: the column and row
                stages in the Gauss form, large_col_stage_gauss and
                large_row_stage_gauss (K4's _kernel_a_gauss, _kernel_b_gauss);
      deep_a    None resolves to False, as in the JAX package.  K4's
                _kernel_a_deep computes DFT_P in 2-3 radix stages, then the
                outer twiddle and a (P, qt) -> (qt, P) transposed store: that
                is what large_col_stage already does, so deep_a runs it;
      blocks2d  None resolves to config.large_blocks2d.  K4's _kernel_a_2d
                and _kernel_b_2d are K2 and K3 on (B*P, Q) and (B*Q, P)
                block descriptions of the same bytes; in flat device memory
                those are the same pointer and strides as (B, P, Q) and
                (B, Q, P), so blocks2d runs large_col_stage and
                large_row_stage.  With deep_a or gauss it raises, as the JAX
                package asserts;
      variant   "swap" or "wlhs": two contraction orders of the TPU row
                stage's q1 x q2 split.  The card's row stage runs the radix
                stages of stage_radices(Q) for either.

    A split given by the caller (the CPU tests give small ones) is taken as
    is when P*q1*q2 == n and both stages have a tile.  Not ported: qt and pt
    (TPU block shapes; the card's tiles are col_tile and row_tile),
    precision (the MXU tiers; the card computes in float32) and interpret.
    `fn.stages` holds the column and row stage wrappers the pipeline runs.
    """
    if np.dtype(dtype) != np.complex64:
        raise ValueError(f"large pipeline is complex64 only, got {np.dtype(dtype)}")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    gauss = config.large_gauss if gauss is None else bool(gauss)
    blocks2d = config.large_blocks2d if blocks2d is None else bool(blocks2d)
    if blocks2d and (deep_a or gauss):
        raise ValueError("blocks2d: default kernels only (no deep_a, no gauss)")
    pqq = split or choose_pqq(n)
    if pqq is None:
        raise ValueError(f"no large pipeline for n={n}")
    p, q1, q2 = pqq
    q = q1 * q2
    if p * q != n:
        raise ValueError(f"split {tuple(pqq)} does not give n={n}")
    if col_tile(p, q, gauss=gauss) is None or row_tile(q, p, gauss=gauss) is None:
        raise ValueError(f"split {tuple(pqq)}: no tile fits shared memory")
    roots_p, tws_p, outer = col_tables(p, q, direction, gauss)
    roots_q, tws_q = row_tables(q, direction, gauss)
    tables = calg.DeviceTables(roots_p + tws_p + [outer] + roots_q + tws_q)
    kp, kq = len(roots_p), len(roots_q)
    col_stage, row_stage = ((large_col_stage_gauss, large_row_stage_gauss) if gauss
                            else (large_col_stage, large_row_stage))

    def apply(x):
        t = tables.on(x.device)
        col = (t[:kp], t[kp : 2 * kp - 1], t[2 * kp - 1])
        row = (t[2 * kp : 2 * kp + kq], t[2 * kp + kq :])
        a = col_stage(x.reshape(-1, n).contiguous(), p, q, col)
        return row_stage(a, q, p, row).reshape(x.shape)

    apply.stages = (col_stage, row_stage)
    return apply
