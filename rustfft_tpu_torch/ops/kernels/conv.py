"""One-pass convolution core and the prime-size kernel paths: the port of K13
and K6.

Replaces rustfft_tpu/ops/pallas/conv.py (`_kernel`, `conv_supported`,
`conv_any_supported`, `_conv_core_fn`, `make_conv_fn`, `make_bluestein_fn`,
`make_raders_fn`) and rustfft_tpu/ops/pallas/lanepack.py (`_conv_kernel`,
`make_lanepack_conv_fn`).  Both TPU kernels compute the Bluestein / Rader core

    out = [post *] maybe_conj( FFT_m( conj( FFT_m([pre *] zeropad(x)) * H ) ) )

and differ only in their layout (m on lanes for 128-aligned m, on sublanes
otherwise); `conv_fft` (csrc/conv.cu) serves both: one block owns one
transform in shared memory, so its domain is that of the lanepack kernel,
m up to ~14.5k with a 2-3 radix split.  Larger inner lengths go to the
two-pass core (ops/kernels/conv_radix.py).

`conv_fft` runs `conv_fft_plain` on a CPU tensor and launches the kernel on
a CUDA tensor, or raises.  H, pre and post are the JAX package's f64 tables
cast to f32; H stays in natural order, the order the port's chains emit.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ...common import FftDirection
from ...config import config
from .. import calg
from ..bluestein import bluestein_tables
from ..raders import raders_tables
from . import _build, conv_radix, lanepack, large
from .lanepack import (
    check_operand, check_stage_tables, fft_stages_plain, padded_stage_args, require_cuda,
)
from .conv_radix import zero_extended
from .permute import make_permute_fn


def conv_supported(m: int, dtype) -> bool:
    """The one-pass core serves m: c64, a 2-3 radix split, and one
    transform (two m-point buffers and the roots) fits a block's shared
    memory: the lanepack kernel's domain."""
    return lanepack.lanepack_supported(m, dtype)


def conv_any_supported(m: int, dtype) -> bool:
    """The one-pass core or the two-pass core serves m."""
    return conv_supported(m, dtype) or conv_radix.radix_conv_supported(m, dtype)


def conv_aligned(m: int, dtype) -> bool:
    """A convolution core serves m with register stages only: every radix
    of its chains (the one-pass chain, or the two-pass core's P and Q
    chains) is in lanepack.REGISTER_RADICES.  The card's counterpart of the
    JAX planner's "MXU-aligned" inner (planner.py:516-532): other radices
    take the generic stage, about twice the work per point
    (lanepack.stage_cost)."""
    if conv_supported(m, dtype):
        chains = [lanepack.tile_radices(m)]
    elif conv_radix.radix_conv_supported(m, dtype):
        p, q = conv_radix.choose_split(m)
        chains = [large.stage_radices(p), large.stage_radices(q)]
    else:
        return False
    return all(r in lanepack.REGISTER_RADICES for chain in chains for r in chain)


def conv_fft_plain(x: torch.Tensor, m: int, radices: Sequence[int], tables, n_out: int,
                   conj_out: bool) -> torch.Tensor:
    """Plain torch version of conv_fft."""
    roots, tws, h, pre, post = tables
    v = torch.nn.functional.pad(x, (0, m - x.shape[1]))
    if pre is not None:
        v = v * pre
    z = torch.conj(fft_stages_plain(v, radices, roots, tws) * h).resolve_conj()
    out = fft_stages_plain(z, radices, roots, tws)[:, :n_out]
    if conj_out:
        out = torch.conj(out).resolve_conj()
    if post is not None:
        out = out * post[:n_out]
    return out


def conv_fft(x: torch.Tensor, radices: Sequence[int], tables, n_out: int,
             conj_out: bool = False) -> torch.Tensor:
    """The convolution core for x (batch, n_in) complex64 -> (batch, n_out),
    m = prod(radices) >= n_in, n_out.

    tables = (roots, tws, h, pre, post) on x's device: roots, tws from
    lanepack.stage_tables(m, radices, direction); h (m,); pre, post (m,)
    complex64 or None (zero beyond n_in / n_out).
    """
    roots, tws, h, pre, post = tables
    m = math.prod(radices)
    if x.dim() != 2:
        raise ValueError(f"conv_fft: expected (batch, n_in), got shape {tuple(x.shape)}")
    n_in = x.shape[1]
    check_operand(x, (x.shape[0], n_in), "conv_fft input")
    if not (0 < n_in <= m and 0 < n_out <= m):
        raise ValueError(f"conv_fft: n_in={n_in}, n_out={n_out} must lie in [1, {m}]")
    check_stage_tables(m, radices, roots, tws, x.device, "conv_fft")
    for t, what in ((h, "h"), (pre, "pre"), (post, "post")):
        if t is not None or what == "h":  # h is required
            check_operand(t, (m,), f"conv_fft {what}")
            if t.device != x.device:
                raise ValueError(f"conv_fft: {what} on {t.device}, input on {x.device}")
    if x.device.type == "cpu":
        return conv_fft_plain(x, m, radices, tables, n_out, conj_out)
    require_cuda(x, "conv_fft")
    if lanepack.smem_bytes(m, radices) > _build.SMEM_MAX or max(radices) > lanepack.MAX_STAGE:
        raise ValueError(f"conv_fft: m={m} with radices {tuple(radices)} does not fit one block")
    y = torch.empty((x.shape[0], n_out), dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    lib = _build.load()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        code = lib.rf_conv_fft(
            x.data_ptr(), y.data_ptr(), x.shape[0], n_in, n_out, m,
            *padded_stage_args(radices, roots, tws), h.data_ptr(), ptr(pre), ptr(post),
            int(conj_out), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "conv_fft")
    conv_fft.launches += 1
    return y


#: kernel launches since the count was last set to 0
conv_fft.launches = 0


def make_conv_fn(
    m: int,
    direction: FftDirection,
    dtype,
    h: np.ndarray,
    pre: Optional[np.ndarray] = None,
    post: Optional[np.ndarray] = None,
    conj_out: bool = False,
    n_in: Optional[int] = None,
    n_out: Optional[int] = None,
):
    """Build fn: complex64 (..., n_in) -> (..., n_out) computing

        out = [post *] maybe_conj( FFT_m( conj( FFT_m([pre *] zeropad(x)) * H ) ) )

    through conv_fft at lanepack.tile_radices(m).  h, pre, post are
    complex128 host arrays; pre / post may be shorter than m (zero-extended,
    which is the Bluestein zero-padding).  n_in / n_out default to m.
    """
    if not conv_supported(m, dtype):
        raise ValueError(f"no one-pass conv core for m={m}, dtype={np.dtype(dtype)}")
    radices = lanepack.tile_radices(m)
    n_in = n_in or m
    n_out = n_out or m
    roots, tws = lanepack.stage_tables(m, radices, direction)
    extra = [zero_extended(h, m), zero_extended(pre, m), zero_extended(post, m)]
    present = [t is not None for t in extra]
    tables = calg.DeviceTables(roots + tws + [t for t in extra if t is not None])
    k = len(radices)

    def apply(x):
        t = tables.on(x.device)
        rest = iter(t[2 * k - 1:])
        h_t, pre_t, post_t = (next(rest) if has else None for has in present)
        shape = x.shape
        y = conv_fft(x.reshape(-1, n_in).contiguous(), radices,
                     (t[:k], t[k : 2 * k - 1], h_t, pre_t, post_t), n_out, conj_out)
        return y.reshape(shape[:-1] + (n_out,))

    return apply


def _conv_core_fn(m: int, direction: FftDirection, dtype, **kw):
    """The convolution core for inner length m: one pass when one transform
    fits a block, else the two-pass core."""
    if conv_supported(m, dtype):
        return make_conv_fn(m, direction, dtype, **kw)
    return conv_radix.make_radix_conv_fn(m, direction, dtype, **kw)


def make_bluestein_fn(n: int, m: int, direction: FftDirection, dtype):
    """Whole Bluestein transform of length n (inner length m) as one
    convolution core: chirp as pre and post, the inner-FFT spectrum of the
    wrapped conjugate chirp as H (reference: bluesteins_algorithm.rs:62-87)."""
    chirp, h_fft = bluestein_tables(n, m, direction)
    return _conv_core_fn(m, direction, dtype, h=h_fft, pre=chirp, post=chirp,
                         conj_out=True, n_in=n, n_out=n)


def make_raders_fn(p: int, direction: FftDirection, dtype):
    """Whole Rader transform of prime length p around a convolution core of
    m = p - 1 (reference: raders_algorithm.rs:86-109, 174-233).

    One-pass core: the root-order gathers are two permute launches around it
    (the JAX package's default rader_gather = "kernel"), and the DC bin and
    the "+x0" fixup are torch glue.  Two-pass core: both gathers and the +x0
    ride its passes (x0_add, emit_sum); with config.rader_full_out the
    DC-first layout too, and with config.rader_in_shift as well the core
    reads the raw rows (no copy of x[:, 1:]), as the JAX package's
    conv.py:286-350 does.  The reference's "+x0 to the DC bin before the
    second transform" is hoisted out of the core:
    FFT(c + conj(x0) e0) = FFT(c) + conj(x0).
    """
    m = p - 1
    perm_in, inv_gather, b_fft = raders_tables(p, direction)
    if not conv_supported(m, dtype):
        full_out = bool(config.rader_full_out)
        in_shift = full_out and bool(config.rader_in_shift)
        core = conv_radix.make_radix_conv_fn(
            m, direction, dtype, h=b_fft, conj_out=True, in_perm=perm_in - 1,
            out_perm=inv_gather, x0_add=True, emit_sum=True, full_out=full_out,
            in_shift=in_shift,
        )

        def apply_fused(x):
            flat = x.reshape(-1, p)
            if in_shift:
                out = core(flat)
            elif full_out:
                out = core(flat[:, 1:], const=flat[:, :1])
            else:
                # out[0] = x0 + sum(x[1:]); the rest already holds conj(D[inv]) + x0
                x0 = flat[:, :1].contiguous()
                rest, sums = core(flat[:, 1:].contiguous(), const=x0)
                out = torch.cat([x0 + sums, rest], dim=1)
            return out.reshape(x.shape)

        return apply_fused

    core = make_conv_fn(m, direction, dtype, h=b_fft)
    gather_in = make_permute_fn(perm_in - 1)
    gather_out = make_permute_fn(inv_gather)

    def apply(x):
        flat = x.reshape(-1, p)
        d = gather_out(core(gather_in(flat[:, 1:].contiguous())))
        out = torch.empty_like(flat)
        # out[0] = x[0] + A[0] = sum(x): A[0] sums the permuted x[1:]
        out[:, 0] = flat.sum(dim=-1)
        # rest = conj(D[inv] + conj(x0)) = conj(D[inv]) + x0, in one pass
        torch.add(torch.conj(d), flat[:, :1], out=out[:, 1:])
        return out.reshape(x.shape)

    return apply
