"""Good-Thomas (Prime-Factor) algorithm: coprime n = p*q with no twiddles.

Port of rustfft_tpu/ops/good_thomas.py (reference:
good_thomas_algorithm.rs:40-649).  Both re-indexings are precomputed flat
index maps applied as single gathers.  With the input map
j = (q*j1 + p*j2) mod n, w_n^(jk) splits exactly into w_p^(j1*k) * w_q^(j2*k),
so X[k] = (DFT_p (x) DFT_q)(x3)[k mod p, k mod q]: a 2-D DFT with no twiddle
multiplies.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import calg
from .kernels import permute


def make_index_maps(p: int, q: int):
    """Gather indices for the input (CRT) and output (residue) maps, int32."""
    n = p * q
    j1 = np.arange(p, dtype=np.int64)[:, None]
    j2 = np.arange(q, dtype=np.int64)[None, :]
    input_map = ((q * j1 + p * j2) % n).reshape(-1)  # x3[j1, j2] = x[input_map]
    k = np.arange(n, dtype=np.int64)
    output_map = (k % p) * q + (k % q)  # X[k] = yflat[output_map[k]]
    return input_map.astype(np.int32), output_map.astype(np.int32)


def make_good_thomas_fn(p: int, q: int, left_fn: Callable, right_fn: Callable,
                        use_kernel: bool):
    """left_fn / right_fn: last-axis FFTs of length p / q.

    use_kernel (c64 with config.kernels == "auto", as the JAX package's
    Pallas modes): both re-index gathers go through ops/kernels/permute.py,
    which launches K16 on a CUDA tensor; otherwise torch.index_select.
    """
    input_map, output_map = make_index_maps(p, q)
    if use_kernel:
        gather_in = permute.make_permute_fn(input_map)
        gather_out = permute.make_permute_fn(output_map)
    else:
        tables = calg.DeviceTables([input_map.astype(np.int64), output_map.astype(np.int64)])

        def gather_in(x):
            return torch.index_select(x, -1, tables.on(x.device)[0])

        def gather_out(x):
            return torch.index_select(x, -1, tables.on(x.device)[1])

    def apply(x):
        shape = x.shape
        x3 = gather_in(x).reshape(shape[:-1] + (p, q))
        y = right_fn(x3)  # DFT over j2 -> [j1, k2]
        y = left_fn(y.transpose(-1, -2).contiguous())  # DFT over j1 -> [k2, k1]
        yflat = y.transpose(-1, -2).reshape(shape)  # [k mod p, k mod q]
        return gather_out(yflat)

    return apply
