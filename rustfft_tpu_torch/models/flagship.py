"""Flagship workload: batched large-N FFT pipelines.

Port of rustfft_tpu/models/flagship.py.  The headline scenario (BASELINE.md
config 5) is a batched 4096 x 2^20-point c64 transform with the batch
dimension sharded across devices.  This module packages that workload:

* `make_forward_fn` - single-device batched planned FFT on complex tensors.
* `make_spectral_step` - the full multi-device step on a DeviceMesh:
  distributed forward FFT, pointwise spectral low-pass, distributed inverse
  FFT, 1/n normalization - a spectral pipeline that exercises every sharded
  code path (three all-to-alls per transform over the 'fft' axis, the batch
  split over 'data').  One NCCL rank a card; on the CPU, gloo ranks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..common import FftDirection, canonical_complex_dtype
from ..ops import calg
from ..parallel import make_distributed_fft
from ..parallel.sharded import axis_size, mesh_device
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


def spectral_filter(n: int) -> np.ndarray:
    """The step's smooth Gaussian low-pass over the n frequencies, float64
    (computed on the host, as in the JAX package)."""
    k = np.arange(n)
    return np.exp(-((np.minimum(k, n - k) / (n / 4.0)) ** 2))


def make_spectral_step(mesh, n: int, dtype=np.complex64) -> Callable:
    """Full sharded step: FFT -> spectral low-pass -> IFFT -> normalize.

    fn: the rank's complex (B_loc, n/d) shard -> its output shard, the batch
    split over the mesh's 'data' axis and n over its 'fft' axis (d ranks), as
    make_distributed_fft lays them out.  The filter is sliced to the rank's
    frequencies once, here.
    """
    dtype = canonical_complex_dtype(dtype)
    fwd = make_distributed_fft(n, FftDirection.FORWARD, dtype, mesh)
    inv = make_distributed_fft(n, FftDirection.INVERSE, dtype, mesh)
    rdt = np.float32 if dtype == np.complex64 else np.float64
    d = axis_size(mesh, "fft")
    lo = mesh.get_local_rank("fft") * (n // d)
    filt = calg.DeviceTables([spectral_filter(n)[lo:lo + n // d].astype(rdt)])
    filt.on(mesh_device(mesh))
    scale = float(rdt(1.0 / n))

    def step(x: torch.Tensor) -> torch.Tensor:
        f = fwd(x)
        f.mul_(filt.on(f.device)[0])
        o = inv(f)
        del f
        return o.mul_(scale)

    return step
