"""Complex helpers on torch tensors.

The JAX package carries complex arrays as (re, im) real pairs because its TPU
runtime had no complex dtypes (rustfft_tpu/ops/calg.py).  torch has complex64
and complex128 on CPU and CUDA, so the port computes on complex tensors and
keeps the pair form only at the edge: `from_pair` / `to_pair` adapt between
the two for the comparison tests and `FftPlan.process_pair`.

Host tables (numpy, built in f64 and cast once) reach a device through
`DeviceTables`, which copies them once per device.

Matmuls run in full precision: complex matmuls use no TF32 unless
`torch.backends.cuda.matmul.allow_tf32` is set, which the port never does.
"""
from __future__ import annotations

import threading
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def from_pair(re, im, dtype=torch.complex64) -> torch.Tensor:
    """Complex tensor from a (re, im) pair of real arrays or tensors."""
    re = torch.as_tensor(re)
    im = torch.as_tensor(im, device=re.device)
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    return torch.complex(re.to(rdt), im.to(rdt))


def to_pair(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) pair of contiguous real tensors."""
    return x.real.contiguous(), x.imag.contiguous()


class DeviceTables:
    """Host numpy tables, copied to each device once on first use."""

    def __init__(self, arrays: Sequence[np.ndarray]):
        self._arrays = tuple(np.ascontiguousarray(a) for a in arrays)
        self._by_device: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        self._lock = threading.Lock()

    @property
    def host(self) -> Tuple[np.ndarray, ...]:
        """The host tables, as given."""
        return self._arrays

    def on(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        tables = self._by_device.get(device)
        if tables is None:
            with self._lock:
                tables = self._by_device.get(device)
                if tables is None:
                    tables = tuple(
                        torch.from_numpy(a).to(device) for a in self._arrays
                    )
                    self._by_device[device] = tables
        return tables

