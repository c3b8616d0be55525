"""Flagship workload: batched large-N FFTs.

Port of rustfft_tpu/models/flagship.py.  The headline scenario (BASELINE.md
config 5) is a batched 4096 x 2^20-point c64 transform.  `make_forward_fn`
is its single-device step; the sharded spectral step waits for the multi-GPU
port (ROADMAP A7).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from ..planner import FftPlanner


@dataclass(frozen=True)
class FlagshipConfig:
    batch: int = 4096
    n: int = 1 << 20
    dtype: type = np.complex64


def make_forward_fn(n: int, dtype=np.complex64) -> Callable:
    """Single-device batched forward FFT on complex tensors (..., n), run on
    the tensor's device."""
    return FftPlanner(dtype).plan_fft_forward(n).raw_fn
