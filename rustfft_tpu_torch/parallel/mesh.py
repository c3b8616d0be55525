"""Mesh construction helpers: port of rustfft_tpu/parallel/mesh.py.

A torch rank is one process on one device.  The mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the world the caller has
initialised with `torch.distributed.init_process_group` (one NCCL rank a
card, or gloo ranks on the CPU with device_type="cpu").
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(
    axis_sizes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data", "fft"),
    device_type: str = "cuda",
) -> DeviceMesh:
    """Build a DeviceMesh over the ranks of the initialised world.

    With no axis_sizes, every rank goes on the first axis (batch sharding)
    and the remaining axes get size 1.  Every rank calls this with the same
    arguments, in the same order as its other collectives.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: call torch.distributed.init_process_group first (one rank a device)")
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis_sizes {axis_sizes} does not match {n} ranks")
    return init_device_mesh(device_type, tuple(axis_sizes), mesh_dim_names=tuple(axis_names))


def split_devices_2d(n_devices: int) -> Tuple[int, int]:
    """Factor n_devices into a near-square (data, fft) grid."""
    best = (n_devices, 1)
    for d in range(1, int(np.sqrt(n_devices)) + 1):
        if n_devices % d == 0:
            best = (n_devices // d, d)
    return best
