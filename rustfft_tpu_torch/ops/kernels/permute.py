"""Fixed permutations of batched rows: the port of K16.

Replaces rustfft_tpu/ops/pallas/permute.py (`_kernel`, `_apply_phases`,
`make_permute_fn`): out[b, i] = x[b, idx[i]] over (batch, m) complex64, the
Rader root-order gathers and the Good-Thomas index maps.  The TPU kernel
factors the permutation into five Benes phases because a Mosaic gather stays
inside one 128-lane vreg (permute.py:10-16); the card gathers from any
address, so the port is a plain gather and has no host-side decomposition.

`permute` is the wrapper: on a CPU tensor it runs `permute_plain`
(torch.index_select); on a CUDA tensor it launches csrc/permute.cu or
raises.  Indices are int32, checked on the host to be a permutation of
range(m) when the table is made (`permutation_index`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import calg
from . import _build
from .lanepack import check_operand, require_cuda


def permutation_index(perm) -> np.ndarray:
    """perm as an int32 array, after checking that it permutes range(m)."""
    perm = np.asarray(perm)
    if perm.ndim != 1 or not np.issubdtype(perm.dtype, np.integer):
        raise ValueError(f"a permutation is a 1-D integer array, got {perm.dtype} {perm.shape}")
    m = perm.shape[0]
    if m >= 2**31:
        raise ValueError(f"permutation of length {m} does not fit int32 indices")
    if not np.array_equal(np.sort(perm), np.arange(m)):
        raise ValueError(f"not a permutation of range({m})")
    return perm.astype(np.int32)


def check_index(idx: torch.Tensor, m: int, device, what: str) -> None:
    if not isinstance(idx, torch.Tensor) or idx.dtype != torch.int32:
        raise TypeError(f"{what}: expected an int32 index tensor")
    if tuple(idx.shape) != (m,) or not idx.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous ({m},) index, got {tuple(idx.shape)}")
    if idx.device != device:
        raise ValueError(f"{what}: index on {idx.device}, input on {device}")


def permute_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version of permute."""
    return torch.index_select(x, 1, idx)


def permute(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, i] = x[b, idx[i]] for x (batch, m) complex64 and idx an int32
    permutation of range(m) (from permutation_index) on x's device."""
    if x.dim() != 2:
        raise ValueError(f"permute: expected (batch, m), got shape {tuple(x.shape)}")
    m = x.shape[1]
    check_operand(x, (x.shape[0], m), "permute input")
    check_index(idx, m, x.device, "permute")
    if x.device.type == "cpu":
        return permute_plain(x, idx)
    require_cuda(x, "permute")
    y = torch.empty_like(x)
    if x.shape[0] == 0 or m == 0:
        return y
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.rf_permute(x.data_ptr(), y.data_ptr(), idx.data_ptr(), x.shape[0], m,
                              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "permute")
    permute.launches += 1
    return y


#: kernel launches since the count was last set to 0
permute.launches = 0


def make_permute_fn(perm):
    """Return fn: complex64 (..., m) -> (..., m), x[..., perm] through permute."""
    idx = permutation_index(perm)
    m = idx.shape[0]
    tables = calg.DeviceTables([idx])

    def apply(x):
        (t,) = tables.on(x.device)
        return permute(x.reshape(-1, m).contiguous(), t).reshape(x.shape)

    return apply
