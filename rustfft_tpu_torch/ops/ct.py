"""Cooley-Tukey decomposition stages on complex tensors.

Port of rustfft_tpu/ops/ct.py: MixedRadix six-step, Radix4 and RadixN as
chains of matmul stages.  For n = p*q with input index j = j1*q + j2 and
output index k = k2*p + k1,

    X[k2*p + k1] = sum_{j2} w_q^(j2*k2) * [ w_n^(k1*j2) * sum_{j1} x[j1,j2] * w_p^(j1*k1) ]

i.e. (1) DFT_p over the j1 axis, (2) twiddle by w_n^(k1*j2), (3) DFT_q over
the j2 axis, (4) swap the (k1, k2) axes.  The per-level axis swap makes the
decomposition self-sorting: no digit reversal anywhere.  These are plain
matmuls in the JAX package too (XLA einsums), so no kernel of their own.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from ..common import FftDirection
from .. import twiddles
from . import calg


def make_ct_stage_fn(p: int, q: int, rest_fn: Callable, direction: FftDirection, dtype):
    """One CT level: matmul DFT_p over the middle axis, twiddle, recurse on q."""
    tables = calg.DeviceTables([
        twiddles.dft_matrix(p, direction).astype(dtype),
        twiddles.twiddle_table(p, q, direction).astype(dtype),
    ])

    def apply(x):
        w, tw = tables.on(x.device)
        shape = x.shape
        a = w @ x.reshape(shape[:-1] + (p, q))  # [..., k1, j2]
        d = rest_fn(a * tw)  # FFT over j2 -> [..., k1, k2]
        return d.transpose(-1, -2).reshape(shape)  # k = k2*p + k1

    return apply


def make_ct_stage_general_fn(
    p: int, q: int, left_fn: Callable, right_fn: Callable, direction: FftDirection, dtype
):
    """One CT level with arbitrary composed inner FFTs (both last-axis): the
    reference six-step shape (mixed_radix.rs:128-158) for two large halves."""
    tw_t = np.ascontiguousarray(twiddles.twiddle_table(p, q, direction).T)
    tables = calg.DeviceTables([tw_t.astype(dtype)])

    def apply(x):
        (tw,) = tables.on(x.device)
        shape = x.shape
        t = x.reshape(shape[:-1] + (p, q)).transpose(-1, -2)  # [j2, j1]
        a = left_fn(t.contiguous()) * tw  # DFT_p -> [j2, k1], twiddled
        d = right_fn(a.transpose(-1, -2).contiguous())  # DFT_q -> [k1, k2]
        return d.transpose(-1, -2).reshape(shape)  # k = k2*p + k1

    return apply


def make_ct_chain_fn(factors, base_len: int, base_fn: Callable, direction: FftDirection, dtype):
    """FFT of n = prod(factors) * base_len as a chain of matmul CT stages
    (Recipe.Radix4 and Recipe.RadixN)."""
    fn = base_fn
    n = base_len
    # innermost stage first; wrap outward so factors[0] is the outermost split
    for f in reversed(factors):
        q = n
        n = f * q
        fn = make_ct_stage_fn(f, q, fn, direction, dtype)
    return fn
