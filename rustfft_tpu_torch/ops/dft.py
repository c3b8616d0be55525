"""Dense DFT as one matmul against the DFT matrix.

Port of rustfft_tpu/ops/dft.py: the leaf of every recipe tree (Dft and
Butterfly recipes).  The DFT matrix is symmetric (W[j,k] = w^(jk)), so
x @ W transforms the last axis.
"""
from __future__ import annotations

from ..common import FftDirection
from .. import twiddles
from . import calg


def make_dft_fn(n: int, direction: FftDirection, dtype):
    """Return fn: complex (..., n) -> complex (..., n), the unnormalized DFT."""
    if n == 0 or n == 1:
        return lambda x: x
    tables = calg.DeviceTables([twiddles.dft_matrix(n, direction).astype(dtype)])

    def apply(x):
        (w,) = tables.on(x.device)
        return x @ w

    return apply
