"""Bluestein's chirp-z algorithm: any length n via an inner FFT of m >= 2n-1.

Port of rustfft_tpu/ops/bluestein.py (reference:
bluesteins_algorithm.rs:39-226).  The inner-FFT spectrum of the
symmetric-wrapped, 1/m-scaled conjugate chirp is computed on the host in
f64 (bluesteins_algorithm.rs:62-87); the second inner transform reuses the
same-direction inner FFT by conjugation (bluesteins_algorithm.rs:116-135).
This is the plain recipe branch, for any dtype; the c64 kernel path is
ops/kernels/conv.py:make_bluestein_fn.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..common import FftDirection
from .. import twiddles
from . import calg


def bluestein_tables(n: int, m: int, direction: FftDirection):
    """Plan-time constants shared by the plain and kernel Bluestein paths.

    Returns (chirp, h_fft) in complex128:
    * chirp - applied before and after (bluesteins_algorithm.rs:87-89),
    * h_fft - the inner-FFT spectrum of the conjugate-direction chirp,
      scaled by 1/m and wrapped symmetrically (bluesteins_algorithm.rs:62-84).
    """
    if m < 2 * n - 1:
        raise ValueError(f"Bluestein inner length {m} < 2*{n}-1")
    chirp = twiddles.bluesteins_twiddles(n, direction)
    h = twiddles.bluesteins_twiddles(n, direction.opposite()) / m
    h_full = np.zeros(m, dtype=np.complex128)
    h_full[0] = h[0]
    h_full[1:n] = h[1:]
    h_full[m - n + 1:] = h[1:][::-1]
    h_fft = twiddles.host_dft(h_full, direction)
    return chirp, h_fft


def make_bluestein_fn(n: int, m: int, inner_fn: Callable, direction: FftDirection, dtype):
    """Return fn: complex (..., n) -> (..., n).  inner_fn: length-m FFT."""
    chirp, h_fft = bluestein_tables(n, m, direction)
    dtype = np.dtype(dtype)
    tables = calg.DeviceTables([chirp.astype(dtype), h_fft.astype(dtype)])

    def apply(x):
        ch, hf = tables.on(x.device)
        y = torch.nn.functional.pad(x * ch, (0, m - n))
        z = torch.conj(inner_fn(y) * hf).resolve_conj()
        zf = inner_fn(z)
        return torch.conj(zf[..., :n]).resolve_conj() * ch

    return apply
