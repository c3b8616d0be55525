"""Fixed permutations of batched rows: the port of K16.

Replaces rustfft_tpu/ops/pallas/permute.py (`_kernel`, `_apply_phases`,
`make_permute_fn`): out[b, i] = x[b, idx[i]] over (batch, m) complex64, the
Rader root-order gathers and the Good-Thomas index maps.  The TPU kernel
factors the permutation into five Benes phases because a Mosaic gather stays
inside one 128-lane vreg (permute.py:10-16); the card gathers from any
address, so the port is a plain gather and has no host-side decomposition.

`permute` is the wrapper: on a CPU tensor it runs `permute_plain`
(torch.index_select); on a CUDA tensor it launches csrc/permute.cu or
raises.  Rows of up to SMEM_ROW_MAX values go through shared memory,
`smem_rows(m)` of them a block; longer rows take the direct gather.
Indices are int32, checked on the host to be a permutation of range(m)
when the table is made (`permutation_index`).
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


#: the longest row the kernel reads whole into shared memory: one row fills
#: a block's 227 KB.  On the H100 the shared-memory form smem_rows(m) read
#: faster than the direct gather at every m measured, 256 to 29056 (0.0640
#: against 0.0682 ms at 256 x 32768, 0.0788 against 0.0879 at 1008 x 8192,
#: 0.0905 against 0.1118 at 29056 x 288: tools/torch_permute_rows.py, the
#: forms in turns); longer rows keep the direct gather
SMEM_ROW_MAX = _build.SMEM_MAX // 8

#: values a block gathers on the shared-memory path: whole rows, as many as
#: fill 8 KiB, so that eight blocks of 256 threads share an SM.  Short rows
#: need several a block to keep enough bytes in flight: on the H100 (same
#: tool) four rows of 256 read 0.0640 ms against one row's 0.0742 (two
#: 0.0654, eight 0.0644), three of 262 0.0753 against 0.0868; from m = 1008
#: up one to four rows read within 3% of each other (1008: 0.0788, 0.0780,
#: 0.0802), and one row is the rule there
SMEM_BLOCK_VALUES = 1024


def smem_rows(m: int) -> int:
    """Rows of length m a block of csrc/permute.cu reads whole into shared
    memory and gathers from there (as many as SMEM_BLOCK_VALUES holds, at
    least one), or 0 where m > SMEM_ROW_MAX: the direct gather from device
    memory."""
    if m < 1:
        raise ValueError(f"smem_rows: m={m}")
    if m > SMEM_ROW_MAX:
        return 0
    return max(1, SMEM_BLOCK_VALUES // m)


def permute_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version of permute."""
    return torch.index_select(x, 1, idx)


def permute(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, i] = x[b, idx[i]] for x (batch, m) complex64 and idx an int32
    permutation of range(m) (from permutation_index) on x's device."""
    m = _check(x, idx, "permute")
    if x.device.type == "cpu":
        return permute_plain(x, idx)
    require_cuda(x, "permute")
    if x.shape[0] == 0 or m == 0:
        return torch.empty_like(x)
    y = _launch(x, idx, smem_rows(m), "permute")
    permute.launches += 1
    return y


#: kernel launches since the count was last set to 0
permute.launches = 0


def permute_rows(x: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """permute on the card with the rows a block reads into shared memory
    chosen by the caller (0: the direct gather), whatever smem_rows says;
    no route calls it (tools/torch_ab.py times both forms at one m)."""
    _check(x, idx, "permute_rows")
    require_cuda(x, "permute_rows")
    if x.numel() == 0:
        return torch.empty_like(x)
    y = _launch(x, idx, rows, "permute_rows")
    permute_rows.launches += 1
    return y


permute_rows.launches = 0


def _check(x, idx, what) -> int:
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (batch, m), got shape {tuple(x.shape)}")
    m = x.shape[1]
    check_operand(x, (x.shape[0], m), f"{what} input")
    check_index(idx, m, x.device, what)
    return m


def _launch(x, idx, rows, what):
    """One launch of csrc/permute.cu on a non-empty CUDA tensor; y."""
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.rf_permute(x.data_ptr(), y.data_ptr(), idx.data_ptr(), x.shape[0],
                              x.shape[1], rows, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, what)
    return y


def make_permute_fn(perm):
    """Return fn: complex64 (..., m) -> (..., m), x[..., perm] through permute."""
    idx = permutation_index(perm)
    m = idx.shape[0]
    tables = calg.DeviceTables([idx])

    def apply(x):
        (t,) = tables.on(x.device)
        return permute(x.reshape(-1, m).contiguous(), t).reshape(x.shape)

    return apply
