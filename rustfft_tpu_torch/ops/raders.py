"""Rader's algorithm: FFT of prime length p via a cyclic convolution of p-1.

Port of rustfft_tpu/ops/raders.py (reference: raders_algorithm.rs:41-330).
The permutations by powers of the primitive root are precomputed gather
indices; the second inner transform reuses the same-direction inner FFT by
conjugating its input and output (raders_algorithm.rs:207-233).  This is the
plain recipe branch, for any dtype; the c64 kernel path is
ops/kernels/conv.py:make_raders_fn.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..common import FftDirection
from .. import math_utils, twiddles
from . import calg


def raders_tables(p: int, direction: FftDirection):
    """Plan-time constants shared by the plain and kernel Rader paths.

    Returns (perm_in, inv_gather, b_fft):
    * perm_in - input gather a[i] = x[g^(i+1) mod p] (raders_algorithm.rs:185-191),
    * inv_gather - the output scatter out[g^-(i+1)] = conj(D[i]) as a gather
      (raders_algorithm.rs:228-233),
    * b_fft - inner-FFT spectrum of b[i] = w_p^(g^-i) / (p-1)
      (raders_algorithm.rs:86-109), complex128.
    """
    if not math_utils.is_prime(p):
        raise ValueError(f"Rader's algorithm requires prime length, got {p}")
    m = p - 1
    g = math_utils.primitive_root(p)
    g_inv = math_utils.mod_inverse(g, p)

    perm_in = np.empty(m, dtype=np.int64)
    idx = 1
    for i in range(m):
        idx = idx * g % p
        perm_in[i] = idx

    out_idx = np.empty(m, dtype=np.int64)
    idx = 1
    for i in range(m):
        idx = idx * g_inv % p
        out_idx[i] = idx
    inv_gather = np.empty(m, dtype=np.int64)
    inv_gather[out_idx - 1] = np.arange(m)

    b = np.empty(m, dtype=np.complex128)
    t = 1
    for i in range(m):
        b[i] = twiddles.compute_twiddle(t, p, direction)
        t = t * g_inv % p
    b_fft = twiddles.host_dft(b / m, direction)
    return perm_in, inv_gather, b_fft


def make_raders_fn(p: int, inner_fn: Callable, direction: FftDirection, dtype):
    """Return fn: complex (..., p) -> (..., p).  inner_fn: length p-1 FFT."""
    perm_in, inv_gather, b_fft = raders_tables(p, direction)
    tables = calg.DeviceTables([
        perm_in, inv_gather, b_fft.astype(np.dtype(dtype)),
    ])

    def apply(x):
        perm, inv, bf = tables.on(x.device)
        a = torch.index_select(x, -1, perm)
        aft = inner_fn(a)
        # out[0] = x[0] + A[0]  (raders_algorithm.rs:202)
        out0 = x[..., :1] + aft[..., :1]
        # multiply by the precomputed spectrum, conjugated to set up the
        # inverse-via-forward inner FFT (raders_algorithm.rs:207-217), and
        # add conj(x[0]) to the DC bin (raders_algorithm.rs:219-221)
        c = torch.conj(aft * bf).resolve_conj()
        c[..., 0] += torch.conj(x[..., 0])
        d = inner_fn(c)
        rest = torch.conj(torch.index_select(d, -1, inv)).resolve_conj()
        return torch.cat([out0, rest], dim=-1)

    return apply
