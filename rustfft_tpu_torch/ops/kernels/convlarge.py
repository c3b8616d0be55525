"""The fused large Bluestein convolution: the port of K15.

Replaces rustfft_tpu/ops/pallas/convlarge.py (`_kernel_bconv`, `_kernel_a2`,
`bconv_supported`, `make_bluestein_large_fn`): a Bluestein of length n on
an inner m = P * Q (large.choose_pqq(m)) in three launches, where the
two-pass core (ops/kernels/conv_radix.py) takes four:

  A       `conv_radix.conv_col_stage` with pre = the chirp: the zero pad, the
          chirp, DFT_P and w_m^(k1*j2), (B, n) -> (B, Q, P).  It takes the
          place of the JAX package's XLA prologue and `large._kernel_a`;
  B_conv  `bconv_row_stage`: per (Q, pt) tile, FFT_Q, conj(. * H), FFT_Q
          in the same direction and w_m^(l1*k1), (B, Q, P) -> (B, Q, P)
          [l1, k1] (the mirrored factorisation, convlarge.py:13-32);
  A2      `bconv_out_stage`: DFT_P over k1 and out[l2*Q + l1] =
          chirp[l] * conj(.) for l < n, (B, Q, P) -> (B, n).

The JAX kernel slices DFT_P to its `pkeep` live rows and slices the output
after; here A2 computes every row and skips the stores with l >= n, so the
epilogue's slice pass disappears.  B_conv holds one (Q, pt) tile in shared
memory for both chains; the tile rule `bconv_tile` checks that it fits.
The general kernel's two buffers hold one column at Q = 8192 (m = 2^21);
there a compile-time chain runs both FFTs in place in one buffer of two
columns (FIXED_BCONV).  Q = 6144 (m = 1572864) takes two columns on the
general kernel.  Host tables are the JAX package's, built in f64 and cast
to complex64: the chirp, H = h_fft as (Q, P), the (Q, P) outer twiddle and
the output chirp.  Each
wrapper runs its plain version on a CPU tensor and launches its kernel
(csrc/convlarge.cu) on a CUDA tensor, or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...common import FftDirection
from .. import calg
from ..bluestein import bluestein_tables
from . import _build, conv_radix, fused, large, largepad
from .lanepack import (
    check_operand, check_stage_tables, fft_stages_plain, padded_stage_args, require_cuda,
)


#: B_conv's compile-time chain (csrc/convlarge.cu bconv_fixed_kernel): the
#: radices of Q -> the tile width, both chains in place in one buffer
FIXED_BCONV = {(32, 16, 16): 2}


def bconv_tile(q: int, p: int) -> Optional[int]:
    """Columns k1 per B_conv block: the compile-time kernel's width
    (FIXED_BCONV) where it divides P, else the widest of 16, 8, 4, 2, 1
    that divides P and whose (Q, pt) tile (two buffers, both chains in
    turn) fits shared memory."""
    fixed = FIXED_BCONV.get(large.stage_radices(q))
    if fixed is not None and p % fixed == 0:
        return fixed
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
    """c64, a large split of m whose three kernels' tiles fit shared memory,
    and executor.route(m) == "large" (the JAX rule: the JAX executor's
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
    p, q1, q2 = large.choose_pqq(m)
    return _tiles_fit(p, q1 * q2)


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


def make_bluestein_large_fn(n: int, m: int, direction: FftDirection, dtype,
                            split: Optional[Tuple[int, int, int]] = None):
    """Return fn: complex64 (..., n) -> (..., n): Bluestein through the three
    kernels at inner m = P * q1 * q2 >= 2n - 1 (split default
    large.choose_pqq(m))."""
    if np.dtype(dtype) != np.complex64:
        raise ValueError(f"the fused large Bluestein is complex64 only, got {np.dtype(dtype)}")
    split = split or large.choose_pqq(m)
    if split is None or split[0] * split[1] * split[2] != m:
        raise ValueError(f"no split for the inner length m={m}: {split}")
    p, q = split[0], split[1] * split[2]
    if not _tiles_fit(p, q):
        raise ValueError(f"fused large Bluestein: no tiles for P={p}, Q={q}")
    host = bconv_tables(n, m, p, q, direction)
    roots_p, tws_p, outer = host["col"]
    roots_q, tws_q = host["row"]
    kp, kq = len(roots_p), len(roots_q)
    tables = calg.DeviceTables([*roots_p, *tws_p, outer, *roots_q, *tws_q,
                                host["pre"], host["h"], host["chirp"]])

    def apply(x):
        t = tables.on(x.device)
        col = (t[:kp], t[kp : 2 * kp - 1], t[2 * kp - 1])
        row = (t[2 * kp : 2 * kp + kq], t[2 * kp + kq : 2 * kp + 2 * kq - 1])
        pre, h, chirp = t[2 * kp + 2 * kq - 1 :]
        a, _ = conv_radix.conv_col_stage(x.reshape(-1, n).contiguous(), p, q, col, pre=pre)
        b = bconv_row_stage(a, q, p, row, h, col[2])
        return bconv_out_stage(b, p, q, col[:2], chirp, n).reshape(x.shape)

    return apply
