"""The whole DFT as one dense product: the port of K5.

Replaces rustfft_tpu/ops/pallas/dense.py (`_kernel_block`, `_kernel_gauss`,
`dense_supported`, `choose_variant`, `make_dense_fft_fn`): out = x @ W_n for
a (batch, n) batch, no factorisation and one read and one write of device
memory, in either complex form of the JAX package:

    "block": re = xr.Wr - xi.Wi, im = xr.Wi + xi.Wr (4 real products);
    "gauss": P1 = xr.Wr, P2 = xi.Wi, P3 = (xr + xi).(Wr + Wi),
             re = P1 - P2, im = P3 - P1 - P2 (3 real products).

`dense_fft` launches csrc/dense.cu (a tiled FP32 product on the CUDA cores)
on a CUDA tensor, or raises, and runs `dense_fft_plain` on a CPU tensor.
The tables are the JAX package's: W_n = twiddles.dft_matrix cast to
complex64, and for the Gauss form its f32 Wr + Wi.

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
in the Gauss form) against 16 n bytes: arithmetic bounds it from n ~ 8 up.
"""
from __future__ import annotations

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
    """DFT of every row of x (batch, n) complex64 as one dense product.

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
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.rf_dense_fft(
            x.data_ptr(), y.data_ptr(), x.shape[0], n, int(variant == "gauss"),
            w.data_ptr(), None if ws is None else ws.data_ptr(),
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
