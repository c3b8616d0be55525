"""Batched whole small transforms: the port of K1, and the host side of
K7's in-place chain, which K1 now runs.

Replaces rustfft_tpu/ops/pallas/lanepack.py (`_kernel`, `_fft_sublane`,
`_stage_consts`): a batch of length-n transforms, each one a
decimation-in-time chain of DFT stages with twiddles between them, in one
read and one write of device memory.  Two kernels in csrc/lanepack.cu:

  `lanepack_pipe_fft`  n = 4096 as (16, 16, 16), the main path: persistent
      blocks, each computing one transform while the next one's load is in
      flight into a second buffer, the twiddles in shared memory;
  `lanepack_chain_fft` every other chain: K7's in-place chain
      (csrc/inplace_chain.cuh) on ONE shared buffer holding `chain_width(n)`
      interleaved transforms (the card's form of the TPU kernel's lane
      packing), up to four stages, each as the in-place chain runs its
      radix: registers for 2-9, 12 and 16, the Bluestein stage (one warp a
      column, M <= 512) for every radix `bluestein_stage_m` names (the
      primes from 29 and most radices from 24 up), a direct sum for the
      rest.

`lanepack_fft` takes the one that serves the chain; each wrapper runs
`chain_stages_plain` (every Bluestein stage step by step) on a CPU tensor
and launches its kernel on a CUDA tensor, or raises.  The chain of n is the
cheapest by `stage_cost`, which prices each stage as the in-place chain
runs it.  The route's domain (`lanepack_supported`) is the earlier
two-buffer kernel's, so that no size changes route; `tile_radices` is that
kernel's chain, which the one-pass convolution core (csrc/conv.cu) and
`large.stage_radices` still run on csrc/fft_tile.cuh's two-buffer tile.

The DFT matrices come from a table of r roots, roots[e] = w_r^e, and W[j, k]
= roots[(j*k) mod r] is bit-equal to the JAX package's f64-computed,
f32-cast matrix entry.  `make_lanepack_fn` takes the JAX factory's
`radices=` and `variant=`; variant="flat" (the JAX kernel's flat I/O,
`_flat_group_load`, `_flat_group_store`) names the same function as
"block".
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
from ..bluestein import bluestein_tables
from . import _build

#: per-stage radix cap (the JAX kernel's MAX_STAGE); the chain kernel's
#: Bluestein stages are then at most 512 points
MAX_STAGE = 256

#: stages of the chain kernel (csrc/lanepack.cu kLpMaxStages), and of the
#: two-buffer tile's chains (csrc/fft_tile.cuh kMaxStages)
MAX_STAGES = 4
TILE_MAX_STAGES = 3

#: radices with an unrolled register stage in csrc/fft_tile.cuh (run_stage)
#: and csrc/inplace_chain.cuh (run_stage_inplace); the powers of 2 among
#: them run as radix-2 FFTs, the others as direct sums
REGISTER_RADICES = frozenset({2, 3, 4, 5, 6, 7, 8, 9, 12, 16})

#: the chain kernel's buffer: chain_width(n) transforms of n values, at
#: most this many values (32 KB, a block of 128 threads, six an SM) unless
#: one transform is longer (then 256 threads: chain_threads)
CHAIN_TILE = 4096

#: the compile-time chain of lanepack_pipe_fft
PIPE_RADICES = (16, 16, 16)


# -- the in-place Bluestein stage -------------------------------------------

def bluestein_ops(r: int, m: int) -> float:
    """FP32 operations a point of the in-place Bluestein stage of radix r at
    length m: two FFT_m, the spectrum product and the chirp before and
    after, (m / r) * (10 log2 m + 6) + 12."""
    return m / r * (10 * math.log2(m) + 6) + 12


@functools.lru_cache(maxsize=1024)
def bluestein_stage_m(r: int) -> Optional[int]:
    """The length M of the in-place Bluestein stage that computes a radix-r
    stage of K7's chains (csrc/inplace_chain.cuh stage_bluestein_inplace),
    or None where the direct sum stays: M is the power of 2 >= 2r - 1 (at
    least 64, two values a lane of a warp), taken where the stage's FP32
    operations a point (bluestein_ops) are fewer than the direct sum's 8r.
    That holds for every prime from 29 (M = 64: 158 against 232) to 509
    (M = 1024: 225 against 4072); 11, 13, 17, 19 and 23 (23: 196 against
    184) and the register radices keep their stages."""
    if r in REGISTER_RADICES or r > 512:
        return None
    m = max(64, 1 << (2 * r - 2).bit_length())
    return m if bluestein_ops(r, m) < 8 * r else None


def bluestein_table_len(r: int, m: int) -> int:
    """Entries of a Bluestein stage's table (bluestein_stage_tables)."""
    return r + 2 * m + m // 32 + 32


def _bitrev(k: np.ndarray, size: int) -> np.ndarray:
    bits = size.bit_length() - 1
    return sum(((k >> b) & 1) << (bits - 1 - b) for b in range(bits))


def bluestein_lane_order(m: int) -> np.ndarray:
    """order[s*32 + l]: the frequency that lane l's register s holds after
    the stage's forward FFT_M, bitrev_V(s) + V*bitrev_32(l) with V = m/32
    (the chain (V, 32): a radix-V FFT in registers, bit-reversed out, then
    radix-2 steps across the lanes, bit-reversed lanes out)."""
    v = m // 32
    return (_bitrev(np.arange(v), v)[:, None] + v * _bitrev(np.arange(32), 32)[None, :]).reshape(-1)


def bluestein_stage_tables(r: int, m: int, direction: FftDirection) -> np.ndarray:
    """The table of a Bluestein stage of radix r at length m, complex64,
    from f64 values, one array in the kernel's order:
      [0, r)           the chirp w_j = exp(-+i pi j^2 / r) (j^2 mod 2r in
                       integers; ops/bluestein.py bluestein_tables);
      [r, r + m)       the spectrum FFT_m(b) / m of the conjugate chirp b,
                       wrapped cyclically, in bluestein_lane_order(m);
      then m entries   the twiddle (V, 32) [k1][l] = w_m^(k1*l) of the
                       FFT_m chain (V, 32), V = m/32;
      V entries        the roots w_V^e;
      32 entries       the roots w_32^e.
    The chain's tables are the forward direction's in both directions: the
    wrapped conjugate chirp is symmetric, so its spectrum is the same under
    either FFT, and the stage runs FFT_m forward twice (the second on the
    conjugate: the inverse)."""
    chirp, spectrum = bluestein_tables(r, m, direction)
    roots, tws = stage_tables(m, (m // 32, 32), FftDirection.FORWARD)
    return np.concatenate([chirp.astype(np.complex64),
                           spectrum[bluestein_lane_order(m)].astype(np.complex64),
                           tws[0].reshape(-1), roots[0], roots[1]])


def bluestein_parts(table, r: int, m: int):
    """(chirp, spectrum in lane order, chain twiddle (V, 32), roots w_V^e,
    roots w_32^e): views of a bluestein_stage_tables array."""
    v = m // 32
    cuts = np.cumsum([r, m, m, v])
    chirp, spectrum, tw, roots_v, roots_32 = (table[a:b] for a, b in zip((0, *cuts),
                                                                         (*cuts, len(table))))
    return chirp, spectrum, tw.reshape(v, 32), roots_v, roots_32


def bluestein_dft_plain(u: torch.Tensor, r: int, m: int, table: torch.Tensor) -> torch.Tensor:
    """DFT_r over the last axis of u (..., r) as the kernels' Bluestein
    stage computes it, step by step from its table: the chirp, the zero pad
    to m, the forward FFT_m by the chain (V, 32), the spectrum, the
    conjugate and the same FFT_m again (the inverse), the conjugate, the
    chirp."""
    chirp, spectrum, tw, roots_v, roots_32 = bluestein_parts(table, r, m)
    h = torch.empty_like(spectrum)
    h[torch.from_numpy(bluestein_lane_order(m)).to(u.device)] = spectrum
    chain = ((m // 32, 32), [roots_v, roots_32], [tw])
    a = fft_stages_plain(torch.nn.functional.pad(u * chirp, (0, m - r)), *chain)
    z = fft_stages_plain(torch.conj(a * h).resolve_conj(), *chain)
    return torch.conj(z[..., :r]).resolve_conj() * chirp


# -- chain rules ------------------------------------------------------------

def tile_cost(radices: Sequence[int]) -> int:
    """Work of a chain on csrc/fft_tile.cuh's two-buffer tile, in about one
    complex multiply-add a unit, per point: 2*log2(r) for a power-of-2
    register stage, r for another register stage, about 2r for the rest
    (fft_stage, which indexes its roots table per multiply-add); plus 8 per
    stage for its pass over shared memory.  The rule of tile_radices and
    large.stage_radices."""

    def cost(r):
        if r in REGISTER_RADICES:
            return 2 * (r.bit_length() - 1) if r & (r - 1) == 0 else r
        return 2 * (-(-r // 8) * 8)

    return sum(cost(r) + 8 for r in radices)


#: FP32 operations a point that a stage's pass over the shared buffer is
#: worth: each point read and written once, 16 bytes at 128 bytes a clock
#: an SM, against 256 FP32 operations a clock
PASS_COST = 32


def radix_cost(r: int) -> float:
    """FP32 operations a point of a radix-r stage as the in-place chain runs
    it (csrc/inplace_chain.cuh run_stage_inplace), one issue slot counted
    as two:
      register, a power of 2   5 log2 r (a radix-2 FFT in registers);
      register, other          8r (an unrolled direct sum);
      Bluestein                bluestein_ops plus 160 M / r: M values through
                               ten radix-2 steps across the lanes, two
                               __shfl_xor_sync each, at 32 a clock an SM
                               (8 FP32 operations' worth);
      direct sum               12r: r complex multiply-adds an output and the
                               root index's add and wrap per term."""
    if r in REGISTER_RADICES:
        return 5 * math.log2(r) if r & (r - 1) == 0 else 8 * r
    m = bluestein_stage_m(r)
    if m:
        return bluestein_ops(r, m) + 160 * m / r
    return 12 * r


def stage_cost(radices: Sequence[int]) -> float:
    """FP32 operations a point of the in-place chain `radices`: radix_cost
    and PASS_COST for every stage, and 6 for every inter-stage twiddle."""
    return sum(radix_cost(r) + PASS_COST for r in radices) + 6 * (len(radices) - 1)


def _splits(n: int, max_stages: int, lo: int = 2):
    """Every factorization of n into 1..max_stages radices in [lo,
    MAX_STAGE], ascending within a split."""
    if lo <= n <= MAX_STAGE:
        yield (n,)
    if max_stages > 1:
        for r in range(lo, min(n, MAX_STAGE) + 1):
            if r * r > n:
                break
            if n % r == 0:
                for rest in _splits(n // r, max_stages - 1, r):
                    yield (r,) + rest


def cheapest_split(n: int, min_stages: int) -> Optional[Tuple[int, ...]]:
    """The split of n into min_stages..3 radices <= MAX_STAGE with the least
    tile_cost (then the fewest stages, then the smallest largest radix), big
    radix first; None when there is none."""
    best = None
    for split in _splits(n, TILE_MAX_STAGES):
        if len(split) < min_stages:
            continue
        key = (tile_cost(split), len(split), max(split))
        if best is None or key < best[0]:
            best = (key, split)
    return None if best is None else tuple(sorted(best[1], reverse=True))


@functools.lru_cache(maxsize=4096)
def tile_radices(n: int) -> Optional[Tuple[int, ...]]:
    """The cheapest split of n into 2 or 3 radices <= MAX_STAGE by tile_cost,
    or None: the chain of the one-pass convolution core (csrc/conv.cu, on
    the two-buffer tile) and the one the lanepack route's domain is
    decided by (lanepack_supported).

    The JAX kernel's rule (lanepack.py:choose_radices) picks a trailing
    radix near 16, e.g. (256, 16) at 4096: fewer, fatter matrix-unit passes
    were faster on the TPU.  On the CUDA cores work grows with the sum of the
    radices, so this rule takes (16, 16, 16) there (measured faster on the
    H100, PERF.md).
    """
    return cheapest_split(n, 2)


@functools.lru_cache(maxsize=4096)
def choose_radices(n: int) -> Optional[Tuple[int, ...]]:
    """The lanepack kernels' chain for n: the split into 1..MAX_STAGES radices
    <= MAX_STAGE with the least stage_cost (then the fewest stages, then the
    smallest largest radix), big radix first, or None.  Every n that is a
    product of at most four register radices gets a register chain (8192 as
    (16, 16, 16, 2), 6144 as (16, 16, 8, 3), 1000 as (8, 5, 5, 5)): a
    Bluestein or direct-sum stage costs more than any register stage it
    could replace.  A prime factor from 29 makes a Bluestein stage."""
    best = None
    for split in _splits(n, MAX_STAGES):
        key = (stage_cost(split), len(split), max(split))
        if best is None or key < best[0]:
            best = (key, split)
    return None if best is None else tuple(sorted(best[1], reverse=True))


def smem_bytes(elems: int, radices: Sequence[int], gauss: bool = False) -> int:
    """Shared memory of a two-buffer tile (csrc/fft_tile.cuh
    tile_smem_bytes): two buffers of `elems` complex values (rounded up to
    16) and the roots tables, 8 bytes per root (16 in the Gauss form: {Wr,
    Wi, Ws, 0})."""
    return (2 * (-(-elems // 16) * 16) + (2 if gauss else 1) * sum(radices)) * 8


def lanepack_supported(n: int, dtype) -> bool:
    """The lanepack route's domain: c64, a 2-3 radix split exists
    (tile_radices) and two buffers of one transform fit a block's shared
    memory, as for the two-buffer kernel the route was drawn for (n up to
    about 14500).  The chain kernel runs every such n in one buffer."""
    if np.dtype(dtype) != np.complex64:
        return False
    radices = tile_radices(n)
    return radices is not None and smem_bytes(n, radices) <= _build.SMEM_MAX


def chain_width(n: int) -> int:
    """Transforms a chain-kernel block holds: the largest power of 2 T with
    n * T <= CHAIN_TILE, at least 1 (T = 1 at 4000, 16 at 251, 64 at
    64)."""
    return 1 << max(0, (CHAIN_TILE // n).bit_length() - 1)


def chain_threads(n: int) -> int:
    """Threads of a chain-kernel block: 128 for the transforms of n <=
    CHAIN_TILE (six blocks an SM at 80 registers: one block's load overlaps
    another's stages), 256 for one longer transform."""
    return 128 if n <= CHAIN_TILE else 256


def chain_smem_bytes(n: int, width: int, radices: Sequence[int]) -> int:
    """Shared memory of a chain-kernel block (csrc/lanepack.cu
    lp_smem_bytes): ONE buffer of width * n values (rounded up to 16) and
    the roots of the direct stages (a Bluestein stage reads its table from
    device memory)."""
    return (-(-n * width // 16) * 16 * 8
            + 8 * sum(r for r in radices if not bluestein_stage_m(r)))


def chain_runs(n: int, radices: Sequence[int]) -> bool:
    """The chain kernel runs `radices` over n: 1..MAX_STAGES radices from 2
    to MAX_STAGE whose product is n, one transform with its tables in
    shared memory."""
    return (1 <= len(radices) <= MAX_STAGES and math.prod(radices) == n
            and all(2 <= r <= MAX_STAGE for r in radices)
            and chain_smem_bytes(n, 1, radices) <= _build.SMEM_MAX)


# -- tables and plain versions ----------------------------------------------

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


def chain_tables(m: int, radices: Sequence[int], direction: FftDirection):
    """Tables of an in-place chain over a length-m axis: stage_tables, with
    the Bluestein table in place of the roots of each stage that has one."""
    roots, tws = stage_tables(m, radices, direction)
    for s, r in enumerate(radices):
        bm = bluestein_stage_m(r)
        if bm:
            roots[s] = bluestein_stage_tables(r, bm, direction)
    return roots, tws


def chain_root_lens(radices: Sequence[int]):
    """The length of each stage's table in chain_tables."""
    return [bluestein_table_len(r, bluestein_stage_m(r)) if bluestein_stage_m(r) else r
            for r in radices]


def bluestein_ms(radices: Sequence[int], slots: int = TILE_MAX_STAGES):
    """Each stage's Bluestein length (0: none), unused slots 0."""
    return [bluestein_stage_m(r) or 0 for r in radices] + [0] * (slots - len(radices))


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


def chain_stages_plain(x: torch.Tensor, radices: Sequence[int], roots, tws) -> torch.Tensor:
    """fft_stages_plain for the in-place chains (chain_tables): a stage with a
    Bluestein stage runs bluestein_dft_plain over its digit."""
    shape = x.shape
    m = shape[-1]
    v = x.reshape(-1, 1, m)
    lead, rest = 1, m
    for s, r in enumerate(radices):
        rest //= r
        u = v.reshape(-1, lead, r, rest)
        bm = bluestein_stage_m(r)
        if bm:
            a = bluestein_dft_plain(u.transpose(2, 3), r, bm, roots[s]).permute(0, 3, 1, 2)
        else:
            a = torch.einsum("jk,bljr->bklr", dft_from_roots(roots[s]), u)
        if s + 1 < len(radices):
            a = a * tws[s].reshape(1, r, 1, rest)
        lead *= r
        v = a.reshape(-1, lead, rest)
    return v.reshape(shape)


# -- operand checks and launch arguments ------------------------------------

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
                       gauss: bool = False, root_lens: Optional[Sequence[int]] = None,
                       max_stages: int = TILE_MAX_STAGES) -> None:
    """Raise unless roots and tws are the DIT chain's tables for `radices`
    (1..max_stages of them) on `device`; with gauss, roots are the Gauss
    form's (3, r) float32 tables (ops/kernels/large.py gauss_tables);
    root_lens: the length of each stage's roots table where it is not r
    (chain_tables)."""
    if not 1 <= len(radices) <= max_stages or math.prod(radices) != m:
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


def padded_stage_args(radices, roots, tws, slots: int = TILE_MAX_STAGES) -> List:
    """(k, r0.., roots0.., tw0..) for a C launcher, `slots` radices and roots
    and slots - 1 twiddles, unused slots as 1 / NULL."""
    k = len(radices)
    return (
        [k] + list(radices) + [1] * (slots - k)
        + [t.data_ptr() for t in roots] + [None] * (slots - k)
        + [t.data_ptr() for t in tws] + [None] * (slots - 1 - len(tws))
    )


def chain_args(radices: Sequence[int], roots, tws, slots: int = TILE_MAX_STAGES):
    """padded_stage_args and bluestein_ms for an in-place chain's launcher
    (csrc/fused.cu and csrc/largepad.cu at three slots, csrc/lanepack.cu at
    four)."""
    return padded_stage_args(radices, roots, tws, slots) + bluestein_ms(radices, slots)


# -- the kernels ------------------------------------------------------------

def _check(x: torch.Tensor, radices: Sequence[int], tables, what: str) -> int:
    roots, tws = tables
    n = math.prod(radices)
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (batch, n), got shape {tuple(x.shape)}")
    check_operand(x, (x.shape[0], n), f"{what} input")
    check_stage_tables(n, radices, roots, tws, x.device, what,
                       root_lens=chain_root_lens(radices), max_stages=MAX_STAGES)
    return n


def launch_chain(x: torch.Tensor, radices: Sequence[int], tables, what: str,
                 stamps: Optional[torch.Tensor] = None, width: Optional[int] = None,
                 threads: Optional[int] = None) -> torch.Tensor:
    """One launch of csrc/lanepack.cu's chain kernel on x (batch, n), n =
    prod(radices), over blocks of `width` transforms (default
    chain_width(n)) and `threads` threads (default chain_threads(n)); y.
    With `stamps`, its stamped form from the library built for it."""
    roots, tws = tables
    n = math.prod(radices)
    width = width or chain_width(n)
    threads = threads or chain_threads(n)
    require_cuda(x, what)
    if not chain_runs(n, radices) or chain_smem_bytes(n, width, radices) > _build.SMEM_MAX:
        raise ValueError(f"{what}: the chain kernel cannot run n={n} as {tuple(radices)} "
                         f"{width} a block")
    y = torch.empty_like(x)
    if x.shape[0] == 0:
        return y
    lib = _build.load(phase_stamps=stamps is not None)
    args = (x.data_ptr(), y.data_ptr(), x.shape[0], n, width, threads,
            *chain_args(radices, roots, tws, MAX_STAGES))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if stamps is None:
            code = lib.rf_lanepack_chain(*args, stream)
        else:
            code = lib.rf_lanepack_chain_phase_stamps(*args, stamps.data_ptr(), stream)
    _build.check(lib, code, what)
    return y


def lanepack_fft_plain(x: torch.Tensor, radices: Sequence[int], tables) -> torch.Tensor:
    """Plain torch version of lanepack_fft and of each kernel's wrapper: the
    chain's stages, every Bluestein stage step by step."""
    return chain_stages_plain(x, radices, *tables)


def lanepack_chain_fft(x: torch.Tensor, radices: Sequence[int], tables) -> torch.Tensor:
    """DFT of every row of x (batch, n) complex64 by the in-place chain
    `radices` (1..MAX_STAGES of them), chain_width(n) transforms a block.

    tables = (roots, tws) from chain_tables, on x's device.
    """
    what = "lanepack_chain_fft"
    _check(x, radices, tables, what)
    if x.device.type == "cpu":
        return lanepack_fft_plain(x, radices, tables)
    y = launch_chain(x, radices, tables, what)
    lanepack_chain_fft.launches += 1
    return y


#: kernel launches since the count was last set to 0
lanepack_chain_fft.launches = 0


def _launch_pipe(x: torch.Tensor, tables, what: str,
                 stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    roots, tws = tables
    require_cuda(x, what)
    y = torch.empty_like(x)
    if x.shape[0] == 0:
        return y
    lib = _build.load(phase_stamps=stamps is not None)
    args = (x.data_ptr(), y.data_ptr(), x.shape[0], *[t.data_ptr() for t in roots],
            *[t.data_ptr() for t in tws])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if stamps is None:
            code = lib.rf_lanepack_pipe(*args, stream)
        else:
            code = lib.rf_lanepack_pipe_phase_stamps(*args, stamps.data_ptr(), stream)
    _build.check(lib, code, what)
    return y


def lanepack_pipe_fft(x: torch.Tensor, tables) -> torch.Tensor:
    """DFT of every row of x (batch, 4096) complex64 by the chain (16, 16,
    16) on csrc/lanepack.cu's persistent, double-buffered kernel.

    tables = (roots, tws) from stage_tables(4096, PIPE_RADICES, direction),
    on x's device.
    """
    what = "lanepack_pipe_fft"
    _check(x, PIPE_RADICES, tables, what)
    if x.device.type == "cpu":
        return lanepack_fft_plain(x, PIPE_RADICES, tables)
    y = _launch_pipe(x, tables, what)
    lanepack_pipe_fft.launches += 1
    return y


lanepack_pipe_fft.launches = 0


def lanepack_fft(x: torch.Tensor, radices: Sequence[int], tables) -> torch.Tensor:
    """DFT of every row of x (batch, n) complex64 by the chain `radices`:
    lanepack_pipe_fft for (16, 16, 16), lanepack_chain_fft for any other.

    tables = (roots, tws) from chain_tables, on x's device.
    """
    if tuple(radices) == PIPE_RADICES:
        return lanepack_pipe_fft(x, tables)
    return lanepack_chain_fft(x, radices, tables)


#: the stamped forms' phases (tools/torch_phase_times.py): a chain-kernel
#: block's load, chain and store; the pipelined kernel's time waiting for
#: its loads (its tables' included), in stages 0 and 1, and in stage 2 with
#: the store, summed over the transforms of its block
CHAIN_PHASES = ("load", "chain", "store")
PIPE_PHASES = ("wait", "stages 0-1", "stage 2+store")
PHASE_STAMPS = 4


def lanepack_phase_stamps(x: torch.Tensor, radices: Sequence[int], tables):
    """lanepack_fft through the stamped form of the kernel that serves
    `radices`, which only the library built with RF_PHASE_STAMPS holds (no
    route launches it): (y, stamps, phases), stamps (blocks, PHASE_STAMPS)
    int64 nanoseconds of %globaltimer, read by each block's thread 0 after a
    block barrier: a chain-kernel block's start and the ends of its
    CHAIN_PHASES; a pipelined block's start and that start plus the running
    sums of its PIPE_PHASES."""
    what = "lanepack_phase_stamps"
    n = _check(x, radices, tables, what)
    require_cuda(x, what)
    if tuple(radices) == PIPE_RADICES:
        # a row a transform, the most the grid can have; the rows of the
        # blocks it launched are the ones stamped
        stamps = torch.zeros((x.shape[0], PHASE_STAMPS), dtype=torch.int64, device=x.device)
        y = _launch_pipe(x, tables, what, stamps)
        return y, stamps[stamps[:, 0] != 0], PIPE_PHASES
    blocks = -(-x.shape[0] // chain_width(n))
    stamps = torch.zeros((blocks, PHASE_STAMPS), dtype=torch.int64, device=x.device)
    return launch_chain(x, radices, tables, what, stamps), stamps, CHAIN_PHASES


#: the I/O views make_lanepack_fn accepts (the JAX package's lanepack variants)
VARIANTS = ("block", "flat")


def make_lanepack_fn(n: int, direction: FftDirection, dtype,
                     radices: Optional[Sequence[int]] = None, variant: str = "block"):
    """Return fn: complex64 (..., n) -> (..., n), the unnormalized DFT of
    every length-n row through lanepack_fft, with the keywords of the JAX
    package's make_lanepack_fn (lanepack.py:339-369):

      radices  the DIT chain (default choose_radices(n)): 1-4 radices from
               2 to MAX_STAGE whose product is n and whose buffer fits
               shared memory (chain_runs); any other raises.  Each radix
               runs as the in-place chain runs it (chain_tables);
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
    if np.dtype(dtype) != np.complex64 or not chain_runs(n, radices):
        raise ValueError(f"lanepack kernel cannot run n={n} as {radices} "
                         f"({np.dtype(dtype)})")
    roots, tws = chain_tables(n, radices, direction)
    tables = calg.DeviceTables(roots + tws)
    k = len(radices)

    def apply(x):
        t = tables.on(x.device)
        y = lanepack_fft(x.reshape(-1, n).contiguous(), radices, (t[:k], t[k:]))
        return y.reshape(x.shape)

    apply.radices = radices
    return apply
