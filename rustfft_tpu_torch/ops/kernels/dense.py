"""The whole DFT as one dense product: the port of K5.

Replaces rustfft_tpu/ops/pallas/dense.py (`_kernel_block`, `_kernel_gauss`,
`dense_supported`, `choose_variant`, `make_dense_fft_fn`): out = x @ W_n for
a (batch, n) batch, no factorisation and one read and one write of device
memory, in either complex form of the JAX package:

    "block": re = xr.Wr - xi.Wi, im = xr.Wi + xi.Wr (4 real products);
    "gauss": P1 = xr.Wr, P2 = xi.Wi, P3 = (xr + xi).(Wr + Wi),
             re = P1 - P2, im = P3 - P1 - P2 (3 real products).

`dense_fft` launches csrc/dense.cu on a CUDA tensor, or raises, and runs
`dense_fft_plain` on a CPU tensor.  The tables are the JAX package's: W_n =
twiddles.dft_matrix cast to complex64, and for the Gauss form its f32
Wr + Wi.  Two kernels:

- the block form at 2 <= n <= PAIR_MAX (the route's primes 5..23;
  `pair_form`): `dense_pair_kernel<n>`, one row a thread in registers in
  the conjugate-pair form of RustFFT's prime butterflies, with the
  cosines and sines of dft_matrix's entries as compile-time constants
  (csrc/dense_pair.cuh, written by `pair_header`): for k and n - k the
  sums over j = 1..(n-1)/2 of cos(2 pi jk/n)(x_j + x_{n-j}) and
  sin(2 pi jk/n)(x_j - x_{n-j}), about (n-1)^2 + 4n real operations a row
  (594 at n = 23) against the tiled product's 8 * 32^2.  A persistent grid
  (`pair_grid`) of blocks walks tiles of `pair_rows(n)` rows, each tile one
  contiguous run of bytes landing by 16-byte cp.async in one of two
  buffers while the other computes and is stored, so bytes bound it.  The
  kernel reads the direction from the table (Im W[1, 1] > 0 for the
  inverse) and nothing else of it.  `pair_dft_plain` is the pair form step
  by step in torch (for the tests);
- the Gauss form, and the block form at larger n: `dense_kernel`, a tiled
  FP32 product on the CUDA cores.

The product costs 8n FP32 operations a point (2008 at n = 251).  Where the
in-place Bluestein stage is cheaper (`lanepack.bluestein_stage_m(n)`: the
primes from 29 to 251 of the "dense" route, M = 64 .. 512, about 158 to 208
operations a point), `make_dense_fft_fn` takes the chain form instead:
`dense_chain_fft`, one Bluestein stage on K1's chain kernel
(csrc/lanepack.cu, `lanepack.chain_width(n)` transforms a block), whose
plain version is `lanepack.bluestein_dft_plain`.  The primes 5..23 keep the
product, as K7's chains keep the direct sum there; an explicit "block" or
"gauss" runs the product at any n.

Not ported, because they serve the TPU's lanes, its v5e measurements or its
VMEM budget: `_pack_group` (g = 128 // n transforms per lane row with
block-diagonal weights; on the card that would multiply the work by g),
`pad_worth_it` (a v5e routing gate), the 128-lane `npad` / `aligned`
padding, the batch tile and the bf16 precision tiers.  Without packing,
`choose_variant`'s rule reads "block" up to n = 256 and "gauss" above.

On the card the product costs 8 n^2 FP32 operations per transform (6 n^2
in the Gauss form) against 16 n bytes: arithmetic bounds it from n ~ 8 up;
the pair form's (n-1)^2 + 4n leaves bytes the bound up to 23.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from ...common import FftDirection
from ... import twiddles
from .. import calg
from . import _build
from . import lanepack
from .lanepack import check_operand, require_cuda

VARIANTS = ("block", "gauss")


def dense_supported(n: int, dtype) -> bool:
    """The JAX rule without its VMEM term: c64 and n >= 4."""
    return np.dtype(dtype) == np.complex64 and n >= 4


def choose_variant(n: int) -> str:
    """The JAX package's choose_variant without lane packing: the 4-multiply
    "block" form while the (packed, 128-padded) row is at most 256 lanes,
    which is n <= 256, and the 3-multiply "gauss" form above."""
    return "block" if n <= 256 else "gauss"


#: the largest n of the pair form (dense_pair_kernel)
PAIR_MAX = 23

#: threads of a dense_pair_kernel block, one row each per pass
PAIR_THREADS = 256

#: the header of the pair form's constants (pair_header)
PAIR_HEADER = Path(__file__).resolve().parents[2] / "csrc" / "dense_pair.cuh"


def pair_form(n: int, variant: str) -> bool:
    """dense_fft runs dense_pair_kernel: the block form at 2 <= n <= PAIR_MAX."""
    return variant == "block" and 2 <= n <= PAIR_MAX


def pair_rows(n: int) -> int:
    """Rows of one tile of dense_pair_kernel<n>: PAIR_THREADS times
    max(1, 24 // n) rows a thread, a run of 40-48 KiB (26 KiB at 13, 35-39
    at 17 and 19) that starts 16-byte aligned (an even count of rows)."""
    return PAIR_THREADS * max(1, 24 // n)


def pair_grid(batch: int, n: int, resident: int) -> int:
    """Blocks of dense_pair_kernel's persistent grid for `batch` rows when
    the card holds `resident` blocks at once: at most one a tile.  Block g
    runs the tiles g, g + grid, ... (pair_walk)."""
    if batch < 1 or resident < 1:
        raise ValueError(f"pair_grid: batch={batch}, resident={resident}")
    return min(-(-batch // pair_rows(n)), resident)


def pair_walk(grid: int, batch: int, n: int):
    """The tiles block g of pair_grid's grid runs, for g < grid, each as
    (first row, rows): the walk of csrc/dense.cu dense_pair_kernel."""
    rows = pair_rows(n)
    tiles = -(-batch // rows)
    return [[(t * rows, min(rows, batch - t * rows)) for t in range(g, tiles, grid)]
            for g in range(grid)]


def pair_roots(n: int):
    """(cos, sin), float32 (n,): cos[m] = Re W[1, m] and sin[m] = -Im W[1, m]
    of the forward dft_matrix(n) cast to float32, so that W[j, k] in f32 is
    cos[jk mod n] - i sin[jk mod n] (the inverse's is its conjugate): the
    pair form's constants."""
    w = twiddles.dft_matrix(n, FftDirection.FORWARD)[1]
    return w.real.astype(np.float32), (-w.imag).astype(np.float32)


def pair_header() -> str:
    """The text of csrc/dense_pair.cuh: pair_roots(n) for 2 <= n <= PAIR_MAX
    as the float literals of PairRoots<n>::c(m) and ::s(m), each the
    shortest decimal that reads back as the same float32."""
    lines = [
        "// The constants of the pair form (csrc/dense.cu dense_pair_kernel):",
        "// PairRoots<n>::c(m) = cos(2 pi m / n) and ::s(m) = sin(2 pi m / n), 0 <= m",
        "// < n, as the forward twiddles.dft_matrix(n)'s entry W[1, m] = c - i s holds",
        "// them, cast to float32.  Written by",
        "// rustfft_tpu_torch/ops/kernels/dense.py pair_header(); tests/",
        "// test_torch_dense_pair.py holds this file to it.  Every call in the kernel",
        "// has a constant m after unrolling, so each switch folds to an immediate.",
        "#pragma once",
        "",
        "namespace rf {",
        "",
        "template <int N>",
        "struct PairRoots;",
    ]
    for n in range(2, PAIR_MAX + 1):
        lines += ["", "template <>", f"struct PairRoots<{n}> {{"]
        for name, vals in zip(("c", "s"), pair_roots(n)):
            lines.append(f"  static __device__ __forceinline__ float {name}(int m) {{")
            lines.append("    switch (m) {")
            for m, v in enumerate(vals):
                lines.append(f"      case {m}: return {np.float32(v)!s}f;")
            lines += ["      default: return 0.f;", "    }", "  }"]
        lines.append("};")
    lines += ["", "}  // namespace rf", ""]
    return "\n".join(lines)


def pair_dft_plain(x: torch.Tensor, direction: FftDirection) -> torch.Tensor:
    """The pair form step by step in float32 (for the tests; dense_fft_plain
    is the wrapper's plain version): a_j = x_j + x_{n-j}, b_j = x_j -
    x_{n-j} (x_{n-j} - x_j for the inverse), j = 1..(n-1)/2; X_0 = x_0 +
    sum a_j; for k = 1..(n-1)/2 the real sums C = x_0 + sum_j cos[jk] a_j
    and S = sum_j sin[jk] b_j, X_k = C - iS and X_{n-k} = C + iS (re and im
    parts as csrc/dense.cu forms them); at even n the middle term x_{n/2}
    and X_{n/2}.  cos, sin: pair_roots(n)."""
    n = x.shape[-1]
    h = (n - 1) // 2
    cos, sin = (torch.from_numpy(t).to(x.device) for t in pair_roots(n))
    xr, xi = x.real, x.imag
    j = torch.arange(1, h + 1, device=x.device)
    sign = -1.0 if direction == FftDirection.INVERSE else 1.0
    ar, ai = xr[..., j] + xr[..., n - j], xi[..., j] + xi[..., n - j]
    br, bi = sign * (xr[..., j] - xr[..., n - j]), sign * (xi[..., j] - xi[..., n - j])
    m = (j[:, None] * j[None, :]) % n  # [j, k]
    c, s = cos[m], sin[m]
    cr = xr[..., :1] + ar @ c
    ci = xi[..., :1] + ai @ c
    sr, si = bi @ s, br @ s
    out_r = torch.empty_like(xr)
    out_i = torch.empty_like(xi)
    out_r[..., 0], out_i[..., 0] = xr[..., 0] + ar.sum(-1), xi[..., 0] + ai.sum(-1)
    if n % 2 == 0:
        alt = (-1.0) ** j.to(xr.dtype)
        mr, mi = xr[..., n // 2 : n // 2 + 1], xi[..., n // 2 : n // 2 + 1]
        cr, ci = cr + mr * alt, ci + mi * alt
        out_r[..., 0] += mr[..., 0]
        out_i[..., 0] += mi[..., 0]
        half = (-1.0) ** (n // 2)
        out_r[..., n // 2] = xr[..., 0] + half * mr[..., 0] + ar @ alt
        out_i[..., n // 2] = xi[..., 0] + half * mi[..., 0] + ai @ alt
    out_r[..., 1 : h + 1], out_i[..., 1 : h + 1] = cr + sr, ci - si
    out_r[..., n - h :], out_i[..., n - h :] = (cr - sr).flip(-1), (ci + si).flip(-1)
    return torch.complex(out_r, out_i)


def resident_blocks(n: int) -> int:
    """The blocks of dense_pair_kernel<n> the current device holds at once
    (its SMs times cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = _build.load()
    out = ctypes.c_int(0)
    _build.check(lib, lib.rf_dense_pair_resident(n, ctypes.byref(out)), "dense resident_blocks")
    return out.value


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, n: int) -> int:
    with torch.cuda.device(device_index):
        return resident_blocks(n)


def dense_tables(n: int, direction: FftDirection, variant: str):
    """Host tables: (W_n (n, n) complex64, Wr + Wi (n, n) float32 for the
    Gauss form, else None), as the JAX package builds them."""
    if variant not in VARIANTS:
        raise ValueError(f"dense variant must be one of {VARIANTS}, got {variant!r}")
    w = twiddles.dft_matrix(n, direction)
    w64 = w.astype(np.complex64)
    if variant == "block":
        return w64, None
    wr = np.ascontiguousarray(w.real).astype(np.float32)
    wi = np.ascontiguousarray(w.imag).astype(np.float32)
    return w64, wr + wi


def dense_fft_plain(x: torch.Tensor, tables, variant: str) -> torch.Tensor:
    """Plain torch version of dense_fft: the same complex form in f32."""
    w, ws = tables
    if variant == "block":
        return x @ w
    xr, xi = x.real, x.imag
    p1 = xr @ w.real
    p2 = xi @ w.imag
    p3 = (xr + xi) @ ws
    return torch.complex(p1 - p2, p3 - p1 - p2)


def dense_fft(x: torch.Tensor, tables, variant: str) -> torch.Tensor:
    """DFT of every row of x (batch, n) complex64 as one dense product (in
    the pair form where pair_form(n, variant)).

    tables = (w, ws) from dense_tables, on x's device.
    """
    w, ws = tables
    if x.dim() != 2:
        raise ValueError(f"dense_fft: expected (batch, n), got shape {tuple(x.shape)}")
    n = x.shape[1]
    check_operand(x, (x.shape[0], n), "dense_fft input")
    check_operand(w, (n, n), "dense_fft W")
    if variant not in VARIANTS:
        raise ValueError(f"dense_fft: variant must be one of {VARIANTS}, got {variant!r}")
    if variant == "gauss":
        if not isinstance(ws, torch.Tensor) or ws.dtype != torch.float32 \
                or tuple(ws.shape) != (n, n) or not ws.is_contiguous():
            raise ValueError("dense_fft: the Gauss form needs Wr + Wi as a contiguous "
                             f"({n}, {n}) float32 tensor")
    for t in (w, ws):
        if t is not None and t.device != x.device:
            raise ValueError(f"dense_fft: tables on {t.device}, input on {x.device}")
    if x.device.type == "cpu":
        return dense_fft_plain(x, tables, variant)
    require_cuda(x, "dense_fft")
    y = torch.empty_like(x)
    if x.shape[0] == 0:
        return y
    grid = 0
    if pair_form(n, variant):
        if x.data_ptr() % 16:  # the tiles land by 16-byte copies
            x = x.clone()
        index = x.device.index if x.device.index is not None else torch.cuda.current_device()
        grid = pair_grid(x.shape[0], n, _resident(index, n))
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.rf_dense_fft(
            x.data_ptr(), y.data_ptr(), x.shape[0], n, int(variant == "gauss"),
            w.data_ptr(), None if ws is None else ws.data_ptr(), grid,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "dense_fft")
    dense_fft.launches += 1
    return y


#: kernel launches since the count was last set to 0
dense_fft.launches = 0


def chain_form(n: int) -> bool:
    """The whole DFT runs as one in-place Bluestein stage (dense_chain_fft):
    lanepack.bluestein_stage_m(n) names a length and the chain kernel runs
    it (n <= lanepack.MAX_STAGE, M <= 512)."""
    return n <= lanepack.MAX_STAGE and lanepack.bluestein_stage_m(n) is not None


def chain_table(n: int, direction: FftDirection) -> np.ndarray:
    """The Bluestein stage's table of the chain form
    (lanepack.bluestein_stage_tables at bluestein_stage_m(n))."""
    return lanepack.bluestein_stage_tables(n, lanepack.bluestein_stage_m(n), direction)


def dense_chain_fft_plain(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain torch version of dense_chain_fft: the Bluestein stage step by
    step."""
    n = x.shape[1]
    return lanepack.bluestein_dft_plain(x, n, lanepack.bluestein_stage_m(n), table)


def dense_chain_fft(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """DFT of every row of x (batch, n) complex64 as one in-place Bluestein
    stage on K1's chain kernel, chain_form(n).

    table from chain_table, on x's device.
    """
    what = "dense_chain_fft"
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (batch, n), got shape {tuple(x.shape)}")
    n = x.shape[1]
    if not chain_form(n):
        raise ValueError(f"{what}: n={n} has no Bluestein stage of at most 512 points")
    lanepack.check_stage_tables(n, (n,), [table], [], x.device, what,
                                root_lens=lanepack.chain_root_lens((n,)))
    check_operand(x, (x.shape[0], n), f"{what} input")
    if x.device.type == "cpu":
        return dense_chain_fft_plain(x, table)
    y = lanepack.launch_chain(x, (n,), ([table], []), what)
    dense_chain_fft.launches += 1
    return y


dense_chain_fft.launches = 0


def make_dense_fft_fn(n: int, direction: FftDirection, dtype, variant=None):
    """Return fn: complex64 (..., n) -> (..., n), the unnormalized DFT of
    every length-n row: with no `variant` through dense_chain_fft where
    chain_form(n), else through dense_fft in `variant` (default
    choose_variant(n))."""
    if not dense_supported(n, dtype):
        raise ValueError(f"no dense kernel for n={n}, dtype={np.dtype(dtype)}")
    if variant is None and chain_form(n):
        tables = calg.DeviceTables([chain_table(n, direction)])

        def apply_chain(x):
            y = dense_chain_fft(x.reshape(-1, n).contiguous(), tables.on(x.device)[0])
            return y.reshape(x.shape)

        return apply_chain
    variant = variant or choose_variant(n)
    w, ws = dense_tables(n, direction, variant)
    tables = calg.DeviceTables([w] if ws is None else [w, ws])

    def apply(x):
        t = tables.on(x.device)
        y = dense_fft(x.reshape(-1, n).contiguous(), (t[0], t[1] if len(t) > 1 else None),
                      variant)
        return y.reshape(x.shape)

    return apply
