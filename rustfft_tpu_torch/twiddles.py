"""Twiddle-factor tables, computed on host in float64.

Copy of rustfft_tpu/twiddles.py (reference: src/twiddles.rs).  Every angle
is computed in f64 from an exponent reduced mod n in integer arithmetic, even
for f32 transforms, and cast once at the end; tables are built at plan time
and moved to the device once.  There is no per-call trig on device.
"""
from __future__ import annotations

import numpy as np

from . import native
from .common import FftDirection
from .config import config


def compute_twiddle(index: int, fft_len: int, direction: FftDirection) -> complex:
    """e^(-2*pi*i*index/fft_len), conjugated for inverse (twiddles.rs:6-23)."""
    angle = -2.0 * np.pi * (index % fft_len) / fft_len
    result = complex(np.cos(angle), np.sin(angle))
    return result if direction is FftDirection.FORWARD else result.conjugate()


def dft_matrix(n: int, direction: FftDirection) -> np.ndarray:
    """Dense n x n DFT matrix W[j,k] = e^(-2*pi*i*jk/n) in complex128."""
    if config.use_native:
        mat = native.dft_matrix(n, direction is FftDirection.INVERSE)
        if mat is not None:
            return mat
    j = np.arange(n, dtype=np.int64)
    exponents = np.outer(j, j) % n
    angle = -2.0 * np.pi / n
    mat = np.exp(1j * angle * exponents.astype(np.float64))
    if direction is FftDirection.INVERSE:
        mat = np.conj(mat)
    return mat


def twiddle_table(p: int, q: int, direction: FftDirection) -> np.ndarray:
    """Cooley-Tukey inter-stage twiddles tw[k1, j2] = w_{p*q}^(k1*j2)."""
    if config.use_native:
        table = native.twiddle_table(p, q, direction is FftDirection.INVERSE)
        if table is not None:
            return table
    n = p * q
    k1 = np.arange(p, dtype=np.int64)
    j2 = np.arange(q, dtype=np.int64)
    exponents = np.outer(k1, j2) % n
    angle = -2.0 * np.pi / n
    table = np.exp(1j * angle * exponents.astype(np.float64))
    if direction is FftDirection.INVERSE:
        table = np.conj(table)
    return table


def bluesteins_twiddles(length: int, direction: FftDirection) -> np.ndarray:
    """Chirp twiddles w_{2n}^(k^2 mod 2n) (reference: twiddles.rs:25-57),
    k^2 reduced exactly in Python integers."""
    if config.use_native:
        table = native.bluestein_chirp(length, direction is FftDirection.INVERSE)
        if table is not None:
            return table
    twice_len = 2 * length
    exponents = np.array([k * k % twice_len for k in range(length)], dtype=np.int64)
    angle = -2.0 * np.pi / twice_len
    table = np.exp(1j * angle * exponents.astype(np.float64))
    if direction is FftDirection.INVERSE:
        table = np.conj(table)
    return table


def host_dft(x: np.ndarray, direction: FftDirection) -> np.ndarray:
    """Unnormalized host-side DFT over the last axis, in complex128: the
    correctness oracle.  Forward = np.fft.fft; inverse = n * np.fft.ifft."""
    x = np.asarray(x, dtype=np.complex128)
    if direction is FftDirection.FORWARD:
        return np.fft.fft(x, axis=-1)
    return np.fft.ifft(x, axis=-1) * x.shape[-1]
