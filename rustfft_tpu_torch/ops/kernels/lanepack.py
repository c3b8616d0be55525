"""Batched whole small transforms: the port of K1.

Replaces rustfft_tpu/ops/pallas/lanepack.py (`_kernel`, `_fft_sublane`,
`_stage_consts`): a batch of length-n transforms, n = r0*r1[*r2] with every
radix <= MAX_STAGE, each one a decimation-in-time chain of DFT stages with
twiddles between them, in one read and one write of device memory.

`lanepack_fft` is the wrapper: on a CPU tensor it runs `lanepack_fft_plain`,
the same chain in plain torch; on a CUDA tensor it launches the hand-written
kernel in csrc/lanepack.cu or raises.  The DFT matrices of both come from a
table of r roots, roots[e] = w_r^e, and W[j, k] = roots[(j*k) mod r] is
bit-equal to the JAX package's f64-computed, f32-cast matrix entry.
`make_lanepack_fn` takes the JAX factory's `radices=` and `variant=`;
variant="flat" (the JAX kernel's flat I/O, `_flat_group_load`,
`_flat_group_store`) names the same function as "block".
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...common import FftDirection
from ... import twiddles
from .. import calg
from . import _build

#: per-stage radix cap (the JAX kernel's MAX_STAGE)
MAX_STAGE = 256

#: radices with an unrolled register stage in csrc/fft_tile.cuh (run_stage);
#: the powers of 2 among them run as radix-2 FFTs, the others as direct sums
REGISTER_RADICES = frozenset({2, 3, 4, 5, 6, 7, 8, 9, 12, 16})


def stage_cost(radices: Sequence[int]) -> int:
    """Work of a DIT chain in the kernel's units (about one complex
    multiply-add), per point: 2*log2(r) for a power-of-2 register stage, r
    for another register stage, about 2r for the rest (csrc/fft_tile.cuh
    fft_stage, which indexes its roots table per multiply-add); plus 8 per
    stage for its pass over shared memory."""

    def cost(r):
        if r in REGISTER_RADICES:
            return 2 * (r.bit_length() - 1) if r & (r - 1) == 0 else r
        return 2 * (-(-r // 8) * 8)

    return sum(cost(r) + 8 for r in radices)


def _splits(n: int):
    """Every factorization of n into 1-3 radices in [2, MAX_STAGE]
    (ascending within a split)."""
    if 2 <= n <= MAX_STAGE:
        yield (n,)
    for r1 in range(2, min(n, MAX_STAGE) + 1):
        if n % r1:
            continue
        rest = n // r1
        if r1 <= rest <= MAX_STAGE:
            yield (r1, rest)
        for r2 in range(r1, MAX_STAGE + 1):
            if r2 * r2 > rest:
                break
            if rest % r2 == 0 and rest // r2 <= MAX_STAGE:
                yield (r1, r2, rest // r2)


def cheapest_split(n: int, min_stages: int) -> Optional[Tuple[int, ...]]:
    """The split of n into min_stages..3 radices <= MAX_STAGE with the least
    stage_cost (then the fewest stages, then the smallest largest radix), big
    radix first; None when there is none."""
    best = None
    for split in _splits(n):
        if len(split) < min_stages:
            continue
        key = (stage_cost(split), len(split), max(split))
        if best is None or key < best[0]:
            best = (key, split)
    return None if best is None else tuple(sorted(best[1], reverse=True))


@functools.lru_cache(maxsize=4096)
def choose_radices(n: int) -> Optional[Tuple[int, ...]]:
    """The lanepack kernel's radices for n: the cheapest split into 2 or 3
    radices <= MAX_STAGE, or None.

    The JAX kernel's rule (lanepack.py:choose_radices) picks a trailing
    radix near 16, e.g. (256, 16) at 4096: fewer, fatter matrix-unit passes
    were faster on the TPU.  On the CUDA cores work grows with the sum of the
    radices, so this rule takes (16, 16, 16) there (measured faster on the
    H100, PERF.md).
    """
    return cheapest_split(n, 2)


def smem_bytes(elems: int, radices: Sequence[int], gauss: bool = False) -> int:
    """Shared memory of a kernel tile (csrc/fft_tile.cuh tile_smem_bytes):
    two buffers of `elems` complex values (rounded up to 16) and the roots
    tables, 8 bytes per root (16 in the Gauss form: {Wr, Wi, Ws, 0})."""
    return (2 * (-(-elems // 16) * 16) + (2 if gauss else 1) * sum(radices)) * 8


def lanepack_supported(n: int, dtype) -> bool:
    """c64, a 2-3 radix split exists, and one transform fits a block's
    shared memory."""
    if np.dtype(dtype) != np.complex64:
        return False
    radices = choose_radices(n)
    return radices is not None and smem_bytes(n, radices) <= _build.SMEM_MAX


def stage_tables(m: int, radices: Sequence[int], direction: FftDirection):
    """Host tables of the DIT chain over a length-m axis, complex64:
    roots[s] = (w_{r_s}^e for e < r_s) and tws[s] = twiddle_table(r_s, rest_s)
    after every stage but the last (the JAX kernel's _stage_consts twiddles)."""
    roots = [twiddles.dft_matrix(r, direction)[1].astype(np.complex64) for r in radices]
    tws = []
    rest = m
    for r in radices[:-1]:
        rest //= r
        tws.append(twiddles.twiddle_table(r, rest, direction).astype(np.complex64))
    return roots, tws


def dft_from_roots(roots: torch.Tensor) -> torch.Tensor:
    """(r, r) DFT matrix W[j, k] = roots[(j*k) mod r]."""
    r = roots.shape[0]
    j = torch.arange(r, device=roots.device)
    return roots[(j[:, None] * j[None, :]) % r]


def fft_stages_plain(x: torch.Tensor, radices: Sequence[int], roots, tws) -> torch.Tensor:
    """Natural-order DFT over the last axis of x (..., m) by the kernels' DIT
    chain: stage s contracts the most significant remaining input digit,
    twiddles, and puts its output digit in front of those already produced."""
    shape = x.shape
    m = shape[-1]
    v = x.reshape(-1, 1, m)
    lead, rest = 1, m
    for s, r in enumerate(radices):
        rest //= r
        a = torch.einsum(
            "jk,bljr->bklr", dft_from_roots(roots[s]), v.reshape(-1, lead, r, rest)
        )
        if s + 1 < len(radices):
            a = a * tws[s].reshape(1, r, 1, rest)
        lead *= r
        v = a.reshape(-1, lead, rest)
    return v.reshape(shape)


def check_operand(t: torch.Tensor, shape, what: str) -> None:
    """Raise unless t is a contiguous complex64 tensor of the given shape."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.complex64:
        raise TypeError(f"{what}: expected complex64, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def check_stage_tables(m: int, radices: Sequence[int], roots, tws, device, what: str,
                       gauss: bool = False, root_lens: Optional[Sequence[int]] = None) -> None:
    """Raise unless roots and tws are the DIT chain's tables for `radices`
    on `device`; with gauss, roots are the Gauss form's (3, r) float32
    tables (ops/kernels/large.py gauss_tables); root_lens: the length of
    each stage's roots table where it is not r (ops/kernels/fused.py
    chain_tables)."""
    if len(radices) not in (1, 2, 3) or math.prod(radices) != m:
        raise ValueError(f"{what}: radices {tuple(radices)} do not split {m}")
    if len(roots) != len(radices) or len(tws) != len(radices) - 1:
        raise ValueError(f"{what}: expected {len(radices)} roots and "
                         f"{len(radices) - 1} twiddle tables")
    rest = m
    for s, r in enumerate(radices):
        rest //= r
        if gauss:
            t = roots[s]
            if (not isinstance(t, torch.Tensor) or t.dtype != torch.float32
                    or tuple(t.shape) != (3, r) or not t.is_contiguous()):
                raise ValueError(f"{what}: Gauss table {s} must be a contiguous (3, {r}) "
                                 "float32 tensor")
        else:
            check_operand(roots[s], (root_lens[s] if root_lens else r,), f"{what} roots[{s}]")
        if s < len(tws):
            check_operand(tws[s], (r, rest), f"{what} tws[{s}]")
    for t in list(roots) + list(tws):
        if t.device != device:
            raise ValueError(f"{what}: tables on {t.device}, input on {device}")


def require_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: runs on CPU or CUDA tensors, got {x.device}")


def padded_stage_args(radices, roots, tws) -> List:
    """(k, r0, r1, r2, roots0..2, tw0, tw1) for a C launcher, unused slots
    as 1 / NULL."""
    k = len(radices)
    return (
        [k] + list(radices) + [1] * (3 - k)
        + [t.data_ptr() for t in roots] + [None] * (3 - k)
        + [t.data_ptr() for t in tws] + [None] * (2 - len(tws))
    )


def lanepack_fft_plain(x: torch.Tensor, radices: Sequence[int], tables) -> torch.Tensor:
    """Plain torch version of lanepack_fft."""
    roots, tws = tables
    return fft_stages_plain(x, radices, roots, tws)


def lanepack_fft(x: torch.Tensor, radices: Sequence[int], tables) -> torch.Tensor:
    """DFT of every row of x (batch, n) complex64 by the DIT chain `radices`.

    tables = (roots, tws) from stage_tables, on x's device.  CPU tensors run
    the plain version; CUDA tensors launch csrc/lanepack.cu.
    """
    roots, tws = tables
    n = math.prod(radices)
    if x.dim() != 2:
        raise ValueError(f"lanepack_fft: expected (batch, n), got shape {tuple(x.shape)}")
    check_operand(x, (x.shape[0], n), "lanepack_fft input")
    check_stage_tables(n, radices, roots, tws, x.device, "lanepack_fft")
    if x.device.type == "cpu":
        return lanepack_fft_plain(x, radices, tables)
    require_cuda(x, "lanepack_fft")
    if smem_bytes(n, radices) > _build.SMEM_MAX or max(radices) > MAX_STAGE:
        raise ValueError(f"lanepack_fft: n={n} with radices {tuple(radices)} "
                         "does not fit one block")
    y = torch.empty_like(x)
    if x.shape[0] == 0:
        return y
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.rf_lanepack_fft(
            x.data_ptr(), y.data_ptr(), x.shape[0], n,
            *padded_stage_args(radices, roots, tws),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, code, "lanepack_fft")
    lanepack_fft.launches += 1
    return y


#: kernel launches since the count was last set to 0
lanepack_fft.launches = 0


#: the I/O views make_lanepack_fn accepts (the JAX package's lanepack variants)
VARIANTS = ("block", "flat")


def make_lanepack_fn(n: int, direction: FftDirection, dtype,
                     radices: Optional[Sequence[int]] = None, variant: str = "block"):
    """Return fn: complex64 (..., n) -> (..., n), the unnormalized DFT of
    every length-n row through lanepack_fft, with the keywords of the JAX
    package's make_lanepack_fn (lanepack.py:339-369):

      radices  the DIT chain (default choose_radices(n)): 1-3 radices from
               2 to MAX_STAGE whose product is n and whose tile fits shared
               memory; any other raises;
      variant  "block" or "flat", an alias: both build the same function.
               The JAX kernel's flat variant reads and writes whole
               (tb, pack * n) rows (_flat_group_load, _flat_group_store)
               for the TPU's DMA; in device memory those rows are the same
               bytes as (batch, n), so on the card there is nothing to vary.

    Not ported: group, stack, precision, interpret and in_place (TPU block
    shapes, MXU tiers and aliasing).
    """
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if radices is None:
        if not lanepack_supported(n, dtype):
            raise ValueError(f"no lanepack kernel for n={n}, dtype={np.dtype(dtype)}")
        radices = choose_radices(n)
    radices = tuple(radices)
    if (np.dtype(dtype) != np.complex64 or not 1 <= len(radices) <= 3
            or math.prod(radices) != n or not all(2 <= r <= MAX_STAGE for r in radices)
            or smem_bytes(n, radices) > _build.SMEM_MAX):
        raise ValueError(f"lanepack kernel cannot run n={n} as {radices} "
                         f"({np.dtype(dtype)})")
    roots, tws = stage_tables(n, radices, direction)
    tables = calg.DeviceTables(roots + tws)
    k = len(radices)

    def apply(x):
        t = tables.on(x.device)
        y = lanepack_fft(x.reshape(-1, n).contiguous(), radices, (t[:k], t[k:]))
        return y.reshape(x.shape)

    apply.radices = radices
    return apply
