"""Sharded FFT execution: batch sharding and the distributed six-step.

Port of rustfft_tpu/parallel/sharded.py (the reference is single-node;
SURVEY.md §2.5).  A torch rank holds only its own shard, so each function
built here maps the rank's local shard to its local output shard, in the
layout of the JAX package's in/out specs: the batch split over `batch_axis`
(or replicated when it is None) and, over `fft_axis`, the contiguous slice
my*n/d .. (my+1)*n/d of the length-n axis, d the axis size and my the
rank's coordinate on it.  Every rank calls the built function in the same
order, as with any collective.

1. `make_batch_sharded_fft` - the plan's function on the rank's rows of the
   batch; no collective.

2. `make_distributed_fft` - one transform sharded across ranks.  The seam is
   the MixedRadix six-step (mixed_radix.rs:128-158): n = p*q, and the three
   transposes of the six-step become three all-to-alls over the fft axis,
   with the p- and q-sized FFTs running shard-locally through the executor
   (the card's kernels on a CUDA shard) and the inter-stage twiddles built
   shard-locally (no global table is ever made).

Derivation (same DIT identity as ops/ct.py): with j = j1*q + j2 and
k = k2*p + k1,

    X[k2*p+k1] = sum_{j2} wq^(j2 k2) * w_n^(k1 j2) * sum_{j1} x[j1,j2] wp^(j1 k1)

Steps (local shapes for fft-axis size d; requires p % d == 0, q % d == 0):
    x (B, p, q) sharded on p
    1. all-to-all transpose -> (B, q, p) sharded on q
    2. local FFT_p over last axis          -> A[j2, k1]
    3. local twiddle by w_n^(k1 * j2_global)
    4. all-to-all transpose -> (B, p, q) sharded on p
    5. local FFT_q over last axis          -> X3[k1, k2]
    6. all-to-all transpose -> (B, q, p) sharded on q
       = output flat (B, n) in ascending-frequency order, sharded on n.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import executor
from ..common import FftDirection, canonical_complex_dtype, torch_dtype
from ..ops import calg
from ..planner import FftPlannerGpu


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of the mesh's axis named `axis`; ValueError if it has none."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {names}")
    return mesh.shape[names.index(axis)]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on: its current card for a CUDA
    mesh, the CPU for a gloo one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_batch_sharded_fft(
    plan,
    mesh: DeviceMesh,
    batch_axis: str = "data",
) -> Callable:
    """fn: the rank's (B_loc, len) rows -> their FFTs, B split over
    `batch_axis`.

    Every rank runs the plan's function on its own shard; no collective is
    needed (pure data parallelism).
    """
    axis_size(mesh, batch_axis)
    n = len(plan)
    fn = plan.raw_fn

    def local(x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2 or x.shape[-1] != n:
            raise ValueError(f"expected a (B_loc, {n}) shard, got {tuple(x.shape)}")
        return fn(x)

    return local


def choose_split(n: int, n_shards: int) -> Tuple[int, int]:
    """Pick n = p*q with p,q both divisible by n_shards and near-balanced.

    The divisibility makes all three all_to_all transposes equal-split.
    """
    best: Optional[Tuple[int, int]] = None
    target = math.isqrt(n)
    for p in range(n_shards, n + 1, n_shards):
        if n % p:
            continue
        q = n // p
        if q % n_shards:
            continue
        if best is None or abs(p - target) < abs(best[0] - target):
            best = (p, q)
    if best is None:
        raise ValueError(
            f"Cannot shard FFT of size {n} over {n_shards} devices: need a "
            f"factorization n = p*q with both p and q divisible by {n_shards}"
        )
    return best


def shard_twiddles(n: int, p: int, j2_lo: int, j2_hi: int,
                   direction: FftDirection) -> np.ndarray:
    """The shard-local six-step twiddles tw[j2 - j2_lo, k1] = w_n^(k1*j2) for
    j2 in [j2_lo, j2_hi), k1 in [0, p), complex128.  The exponent is reduced
    mod n in integer arithmetic and the angle taken in f64 (the precision
    discipline of twiddles.rs:11-17)."""
    j2 = np.arange(j2_lo, j2_hi, dtype=np.int64)[:, None]
    k1 = np.arange(p, dtype=np.int64)[None, :]
    expo = (j2 * k1) % n  # < p*q = n < 2^31: no overflow
    sign = -1.0 if direction is FftDirection.FORWARD else 1.0
    return np.exp(1j * (sign * 2.0 * np.pi / n) * expo.astype(np.float64))


def _a2a_transpose(x: torch.Tensor, d: int, group) -> torch.Tensor:
    """Distributed transpose of the trailing (rows, cols) pair of axes:
    global (B, r, c) sharded on r, local (B, r/d, c) -> global (B, c, r)
    sharded on c, local (B, c/d, r): one equal-split all-to-all over one
    contiguous complex buffer.  On an axis of one rank the all-to-all would
    only copy the buffer onto itself, so it is skipped and the transpose is
    the local one alone.  The result is contiguous on every axis size: left
    a strided view, the transpose's copy would move into its consumer and
    sit beside the consumer's own output."""
    b, r_loc, c = x.shape
    c_loc = c // d
    send = x.reshape(b, r_loc, d, c_loc).permute(2, 0, 1, 3).contiguous()
    if d == 1:
        recv = send
    else:
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
    del send
    # recv[i] = rank i's rows, this rank's columns: (d, B, r_loc, c_loc)
    return recv.permute(1, 3, 0, 2).reshape(b, c_loc, d * r_loc).contiguous()


def make_distributed_fft(
    n: int,
    direction: FftDirection,
    dtype,
    mesh: DeviceMesh,
    fft_axis: str = "fft",
    batch_axis: Optional[str] = "data",
    split: Optional[Tuple[int, int]] = None,
) -> Callable:
    """Build fn: the rank's (B_loc, n/d) shard -> its (B_loc, n/d) output
    shard, n sharded over `fft_axis` of the mesh (d its size).

    The batch is split over `batch_axis` when that axis exists in the mesh
    (set batch_axis=None to replicate the batch: the ranks along the other
    axes then hold the same rows).  Output is the ascending-frequency
    unnormalized DFT, sharded like the input.  The shard-local FFTs, the
    twiddle table and the process group are made once, here.
    """
    dtype = canonical_complex_dtype(dtype)
    d = axis_size(mesh, fft_axis)
    if batch_axis is not None:
        axis_size(mesh, batch_axis)
    if split is None:
        split = choose_split(n, d)
    p, q = split
    assert p * q == n and p % d == 0 and q % d == 0, (n, p, q, d)
    if n >= 2**31:
        raise ValueError("distributed FFT supports n < 2^31 (int32 twiddle indices)")
    p_loc, q_loc = p // d, q // d
    group = mesh.get_group(fft_axis)
    my = mesh.get_local_rank(fft_axis)
    device = mesh_device(mesh)

    planner = FftPlannerGpu(dtype, device)
    fft_p = executor.build(planner.design_fft_for_len(p), direction, dtype)
    fft_q = executor.build(planner.design_fft_for_len(q), direction, dtype)
    tw = calg.DeviceTables([
        shard_twiddles(n, p, my * q_loc, (my + 1) * q_loc, direction).astype(dtype)])
    tw.on(device)
    tdt = torch_dtype(dtype)

    def local_step(x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2 or x.shape[-1] != n // d:
            raise ValueError(f"expected a (B_loc, {n // d}) shard, got {tuple(x.shape)}")
        b = x.shape[0]
        x3 = x.to(tdt).reshape(b, p_loc, q)
        # 1. distributed transpose (B, p, q)@p -> (B, q, p)@q
        t = _a2a_transpose(x3, d, group)  # rows j2 in [my*q_loc, ...)
        # 2. shard-local FFT over p -> [j2, k1]
        a = fft_p(t)
        del t
        # 3. shard-local twiddle w_n^(k1 * j2_global)
        a.mul_(tw.on(a.device)[0])  # a is this step's own tensor
        # 4. distributed transpose (B, q, p)@q -> (B, p, q)@p
        u = _a2a_transpose(a, d, group)  # rows k1 in [my*p_loc, ...)
        del a
        # 5. shard-local FFT over q -> [k1, k2]
        x5 = fft_q(u)
        del u
        # 6. distributed transpose -> (B, q, p)@q == flat k = k2*p + k1
        v = _a2a_transpose(x5, d, group)
        return v.reshape(b, q_loc * p)

    return local_step
