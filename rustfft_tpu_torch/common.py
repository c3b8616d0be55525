"""Core enums, dtype helpers, and validation errors.

Port of rustfft_tpu/common.py (reference: src/lib.rs:140-278,
src/common.rs:11-104): the same Python types, with a mapping from the numpy
complex dtypes to torch's.
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class FftDirection(enum.Enum):
    """Transform direction (reference: src/lib.rs:146-171).

    Forward uses twiddles e^(-2*pi*i*jk/n); Inverse conjugates them.
    Neither direction normalizes: a forward+inverse roundtrip scales by n
    (reference: src/lib.rs:81-86).
    """

    FORWARD = "forward"
    INVERSE = "inverse"

    def opposite(self) -> "FftDirection":
        """reference: src/lib.rs:164-170 (`opposite_direction`)."""
        return (
            FftDirection.INVERSE
            if self is FftDirection.FORWARD
            else FftDirection.FORWARD
        )

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"FftDirection.{self.name}"


# Aliases matching the reference naming.
Forward = FftDirection.FORWARD
Inverse = FftDirection.INVERSE


def canonical_complex_dtype(dtype) -> np.dtype:
    d = np.dtype(dtype)
    if d == np.complex64 or d == np.complex128:
        return d
    if d == np.float32:
        return np.dtype(np.complex64)
    if d == np.float64:
        return np.dtype(np.complex128)
    raise ValueError(
        f"Unsupported dtype {dtype!r}: expected complex64/complex128 (or "
        f"float32/float64 as shorthand for the matching complex type)"
    )


def torch_dtype(dtype) -> torch.dtype:
    """torch complex dtype of a canonical numpy complex dtype."""
    return torch.complex64 if np.dtype(dtype) == np.complex64 else torch.complex128


class FftBufferError(ValueError):
    """Buffer/scratch misuse errors.

    The reference panics with formatted messages for misuse
    (reference: src/common.rs:11-104); in Python we raise instead.
    """


def validate_buffer_len(buffer_len: int, fft_len: int) -> int:
    """Check RustFFT's batching contract and return the chunk count.

    Any buffer whose length is a multiple of ``fft_len`` is processed as
    independent chunks (reference: src/lib.rs:195-211, src/fft_helper.rs:9-28).
    A zero-length FFT accepts only an empty buffer.
    """
    if fft_len == 0:
        if buffer_len != 0:
            raise FftBufferError(
                f"A zero-length FFT can only process an empty buffer, got "
                f"buffer of length {buffer_len}"
            )
        return 0
    if buffer_len % fft_len != 0:
        raise FftBufferError(
            f"Buffer length {buffer_len} is not a multiple of FFT length {fft_len}"
        )
    return buffer_len // fft_len
