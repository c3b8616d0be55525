"""One-pass convolution core and the prime-size kernel paths: the port of K13
and K6.

Replaces rustfft_tpu/ops/pallas/conv.py (`_kernel`, `conv_supported`,
`conv_any_supported`, `_conv_core_fn`, `make_conv_fn`, `make_bluestein_fn`,
`make_raders_fn`) and rustfft_tpu/ops/pallas/lanepack.py (`_conv_kernel`,
`make_lanepack_conv_fn`).  Both TPU kernels compute the Bluestein / Rader core

    out = [post *] maybe_conj( FFT_m( conj( FFT_m([pre *] zeropad(x)) * H ) ) )

and differ only in their layout (m on lanes for 128-aligned m, on sublanes
otherwise); one kernel form serves both on the card.  The core's domain is
that of the lanepack kernel, m up to ~14.5k with a 2-3 radix split; larger
inner lengths go to the two-pass core (ops/kernels/conv_radix.py).  Two
kernels (csrc/conv.cu):

  `conv_chain_fft`  the chain form, wherever `chain_radices(m)` holds (the
      four-stage chain of register radices and direct sums, no Bluestein
      stage; every inner length the planner gives a prime of [257, 8191]):
      persistent blocks walking units of transforms, the next unit landing
      while the current one runs two in-place chains, h stored in chain
      1's output order (`chain_h_table`), chain 2 on the reversed digits;
  `conv_fft`        the parent form, one block a transform on the two-buffer
      tile at `lanepack.tile_radices(m)`, for the other lengths.

Each runs its plain version on a CPU tensor and launches its kernel on a
CUDA tensor, or raises.  H, pre and post are the JAX package's f64 tables
cast to f32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...common import FftDirection
from ...config import config
from .. import calg
from ..bluestein import bluestein_tables
from ..raders import raders_tables
from . import _build, conv_radix, lanepack, large
from .lanepack import (
    check_operand, check_stage_tables, fft_stages_plain, padded_stage_args, require_cuda,
)
from .conv_radix import zero_extended
from .permute import make_permute_fn


def conv_supported(m: int, dtype) -> bool:
    """The one-pass core serves m: c64, a 2-3 radix split, and one
    transform (two m-point buffers and the roots) fits a block's shared
    memory: the lanepack kernel's domain."""
    return lanepack.lanepack_supported(m, dtype)


def conv_any_supported(m: int, dtype) -> bool:
    """The one-pass core or the two-pass core serves m."""
    return conv_supported(m, dtype) or conv_radix.radix_conv_supported(m, dtype)


def conv_aligned(m: int, dtype) -> bool:
    """A convolution core serves m with register stages only: every radix
    of its chains (the one-pass chain, or the two-pass core's P and Q
    chains) is in lanepack.REGISTER_RADICES.  The card's counterpart of the
    JAX planner's "MXU-aligned" inner (planner.py:516-532): other radices
    take the generic stage, about twice the work per point
    (lanepack.stage_cost)."""
    if conv_supported(m, dtype):
        chains = [lanepack.tile_radices(m)]
    elif conv_radix.radix_conv_supported(m, dtype):
        p, q = conv_radix.choose_split(m)
        chains = [large.stage_radices(p), large.stage_radices(q)]
    else:
        return False
    return all(r in lanepack.REGISTER_RADICES for chain in chains for r in chain)


def conv_fft_plain(x: torch.Tensor, m: int, radices: Sequence[int], tables, n_out: int,
                   conj_out: bool) -> torch.Tensor:
    """Plain torch version of conv_fft."""
    roots, tws, h, pre, post = tables
    v = torch.nn.functional.pad(x, (0, m - x.shape[1]))
    if pre is not None:
        v = v * pre
    z = torch.conj(fft_stages_plain(v, radices, roots, tws) * h).resolve_conj()
    out = fft_stages_plain(z, radices, roots, tws)[:, :n_out]
    if conj_out:
        out = torch.conj(out).resolve_conj()
    if post is not None:
        out = out * post[:n_out]
    return out


def _conv_fft_checks(x, radices, tables, n_out, what) -> int:
    """Raise unless conv_fft takes these operands; return m."""
    roots, tws, h, pre, post = tables
    m = math.prod(radices)
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (batch, n_in), got shape {tuple(x.shape)}")
    n_in = x.shape[1]
    check_operand(x, (x.shape[0], n_in), f"{what} input")
    if not (0 < n_in <= m and 0 < n_out <= m):
        raise ValueError(f"{what}: n_in={n_in}, n_out={n_out} must lie in [1, {m}]")
    check_stage_tables(m, radices, roots, tws, x.device, what)
    for t, name in ((h, "h"), (pre, "pre"), (post, "post")):
        if t is not None or name == "h":  # h is required
            check_operand(t, (m,), f"{what} {name}")
            if t.device != x.device:
                raise ValueError(f"{what}: {name} on {t.device}, input on {x.device}")
    return m


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_fits(m, radices, what) -> None:
    if lanepack.smem_bytes(m, radices) > _build.SMEM_MAX or max(radices) > lanepack.MAX_STAGE:
        raise ValueError(f"{what}: m={m} with radices {tuple(radices)} does not fit one block")


def _conv_fft_launch(x, radices, tables, n_out, conj_out, what, stamps=None):
    roots, tws, h, pre, post = tables
    m = math.prod(radices)
    y = torch.empty((x.shape[0], n_out), dtype=x.dtype, device=x.device)
    lib = _build.load(phase_stamps=stamps is not None)
    args = (x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1], n_out, m,
            *padded_stage_args(radices, roots, tws), h.data_ptr(), _ptr(pre), _ptr(post),
            int(conj_out))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if stamps is None:
            code = lib.rf_conv_fft(*args, stream)
        else:
            code = lib.rf_conv_fft_stamps(*args, stamps.data_ptr(), stream)
    _build.check(lib, code, what)
    return y


def conv_fft(x: torch.Tensor, radices: Sequence[int], tables, n_out: int,
             conj_out: bool = False) -> torch.Tensor:
    """The convolution core for x (batch, n_in) complex64 -> (batch, n_out),
    m = prod(radices) >= n_in, n_out.

    tables = (roots, tws, h, pre, post) on x's device: roots, tws from
    lanepack.stage_tables(m, radices, direction); h (m,); pre, post (m,)
    complex64 or None (zero beyond n_in / n_out).
    """
    m = _conv_fft_checks(x, radices, tables, n_out, "conv_fft")
    if x.device.type == "cpu":
        return conv_fft_plain(x, m, radices, tables, n_out, conj_out)
    require_cuda(x, "conv_fft")
    _check_fits(m, radices, "conv_fft")
    if x.shape[0] == 0:
        return torch.empty((0, n_out), dtype=x.dtype, device=x.device)
    y = _conv_fft_launch(x, radices, tables, n_out, conj_out, "conv_fft")
    conv_fft.launches += 1
    return y


#: kernel launches since the count was last set to 0
conv_fft.launches = 0

#: the stamped form's phases (tools/torch_phase_times.py)
CONV_PHASES = ("load", "chain 1", "H", "chain 2", "store")


def conv_phase_stamps(x: torch.Tensor, radices: Sequence[int], tables, n_out: int,
                      conj_out: bool = False):
    """conv_fft through its stamped form, which only the library built with
    RF_PHASE_STAMPS holds (no route launches it): (y, stamps, phases),
    stamps (batch, len(phases) + 1) int64 nanoseconds of %globaltimer, read
    by each block's thread 0 after a block barrier at its start and at the
    end of each phase."""
    what = "conv_phase_stamps"
    m = _conv_fft_checks(x, radices, tables, n_out, what)
    require_cuda(x, what)
    _check_fits(m, radices, what)
    stamps = torch.zeros((x.shape[0], len(CONV_PHASES) + 1), dtype=torch.int64,
                         device=x.device)
    return _conv_fft_launch(x, radices, tables, n_out, conj_out, what, stamps), stamps, CONV_PHASES


# -- the chain form: csrc/conv.cu conv_chain_kernel ------------------------------

#: the radices the chain form runs in registers: lanepack.REGISTER_RADICES
#: and every direct sum lanepack.choose_radices gives a length of the
#: core's domain without a Bluestein stage (csrc/conv.cu cc_with_radix)
CHAIN_RADICES = lanepack.REGISTER_RADICES | frozenset(
    {10, 11, 13, 14, 15, 17, 18, 19, 21, 23, 35})

def chain_big(radices: Sequence[int]) -> bool:
    """The chain runs on the chain form's kernel with the direct sums (a
    radix outside lanepack.REGISTER_RADICES); the other kernel compiles the
    register stages only."""
    return not all(r in lanepack.REGISTER_RADICES for r in radices)


def chain_weights(radices: Sequence[int]) -> list:
    """The position weight W_s = m / (r_0 .. r_s) of each digit of an
    in-place chain over m = prod(radices): stage s runs radix r_s over the
    digit of weight W_s (W_{S-1} = 1)."""
    w, out = math.prod(radices), []
    for r in radices:
        w //= r
        out.append(w)
    return out


def chain_positions(radices: Sequence[int]) -> np.ndarray:
    """(m,) int64: the frequency k whose value the in-place DIT chain
    `radices` leaves at position pos = sum_s k_s * W_s, k = k_0 + r_0*k_1 +
    r_0*r_1*k_2 + ... (digit-reversed: its stage s puts output digit k_s
    where it read input digit s)."""
    m = math.prod(radices)
    pos = np.arange(m)
    k, scale = np.zeros(m, np.int64), 1
    for r, w in zip(radices, chain_weights(radices)):
        k += (pos // w % r) * scale
        scale *= r
    return k


def double_chain_tables(m: int, radices: Sequence[int], direction: FftDirection):
    """Tables of the double in-place chain over m = prod(radices),
    complex64: (roots, tws1, tws2).  roots[s]: stage s's roots w_{r_s}^e
    (chain 2 reads the same ones); tws1: chain 1's twiddles (r_s, W_s)
    after every stage but the last (lanepack.stage_tables); tws2: chain
    2's, which runs the radices reversed over the position digits: its
    stage t (radix r_{S-1-t}, digit W_{S-1-t}) multiplies output k by
    tws2[t][k, hi], hi = the position of its column over the digits above
    it (pos // W_{S-2-t}), the reversed chain's twiddle column of the
    input digits k_0 .. k_{S-2-t} not yet taken."""
    n = len(radices)
    roots, tws1 = lanepack.stage_tables(m, radices, direction)
    _, tws2 = lanepack.stage_tables(m, radices[::-1], direction)
    weights = chain_weights(radices)
    remapped = []
    for t, table in enumerate(tws2):
        top = n - 2 - t  # the lowest chain-1 digit above the stage
        hi = np.arange(table.shape[1])
        rest, scale = np.zeros_like(hi), 1
        for s in range(top + 1):
            rest += (hi // (weights[s] // weights[top]) % radices[s]) * scale
            scale *= radices[s]
        remapped.append(np.ascontiguousarray(table[:, rest]))
    return list(roots), list(tws1), remapped


@functools.lru_cache(maxsize=4096)
def chain_radices(m: int) -> Optional[Tuple[int, ...]]:
    """The chain form's chain for inner length m, or None: the four-stage
    rule lanepack.choose_radices(m) wherever it needs no Bluestein stage
    (every radix a register radix or a direct sum of CHAIN_RADICES) and the
    form's two padded buffers fit a block (not for 51 lengths from 13650
    up); None elsewhere, where conv_fft keeps m."""
    if not conv_supported(m, np.complex64):
        return None
    radices = lanepack.choose_radices(m)
    if radices is None or not all(r in CHAIN_RADICES for r in radices):
        return None
    if chain_smem_bytes(m, radices, m, m, False, False, False) > _build.SMEM_MAX:
        return None
    return radices


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def _padded(v: int) -> int:
    """Values of a padded region of v values (csrc/conv.cu cc_pad of
    pad16(v)): one pad every 16."""
    p = _pad16(v)
    return p + p // 16


def chain_unit(m: int) -> int:
    """Transforms a unit of the chain form: lanepack.chain_width of
    pad16(m), the values a transform's padded region holds before its
    pads, so that a unit holds at most 4096 of them unless one transform
    is longer."""
    return lanepack.chain_width(_pad16(m))


def chain_smem_bytes(m: int, radices: Sequence[int], n_in: int, n_out: int, has_pre: bool,
                     has_post: bool, tables_smem: bool) -> int:
    """Shared memory of a chain-form block (csrc/conv.cu cc_smem_bytes): two
    buffers of chain_unit(m) transforms, each a padded region of pad16(m)
    values (one pad every 16); with tables_smem h, pre (n_in values) and
    post (n_out) padded the same way; every stage's roots."""
    values = 2 * chain_unit(m) * _padded(m) + sum(radices)
    if tables_smem:
        values += _padded(m) + (_padded(n_in) if has_pre else 0) + (_padded(n_out) if has_post
                                                                   else 0)
    return 8 * values


def chain_kernel_form(radices: Sequence[int]) -> int:
    """The chain form's kernel that runs `radices` (csrc/conv.cu kCcForms):
    1, the one with the direct sums, where a radix needs it (chain_big), at
    two blocks an SM (128 registers); else 0, the register radices at three
    (80 registers and a spill of a few hundred bytes)."""
    return 1 if chain_big(radices) else 0


def chain_tables_smem(device_index: int, m: int, radices: Sequence[int], n_in: int, n_out: int,
                      has_pre: bool, has_post: bool) -> bool:
    """The chain form holds h, pre and post in shared memory for a block's
    life where they fit a block and the device still holds as many of its
    blocks at once (chain_resident), and reads them through L2 elsewhere."""
    form = chain_kernel_form(radices)
    with_tables, without = (chain_smem_bytes(m, radices, n_in, n_out, has_pre, has_post, on_chip)
                            for on_chip in (True, False))
    return with_tables <= _build.SMEM_MAX and (chain_resident(device_index, form, with_tables)
                                               >= chain_resident(device_index, form, without))


def chain_h_table(h: np.ndarray, radices: Sequence[int]) -> np.ndarray:
    """h (m,) in chain 1's output positions: entry pos holds
    h[chain_positions(radices)[pos]]."""
    return np.ascontiguousarray(np.asarray(h)[chain_positions(radices)])


def conv_chain_fft_plain(x: torch.Tensor, radices: Sequence[int], tables, n_out: int,
                         conj_out: bool) -> torch.Tensor:
    """Plain torch version of conv_chain_fft: conv_fft_plain on chain 1's
    tables with h back in natural order."""
    roots, tws1, _, h, pre, post = tables
    m = math.prod(radices)
    inv = torch.from_numpy(np.argsort(chain_positions(radices))).to(h.device)
    return conv_fft_plain(x, m, radices, (roots, tws1, h[inv], pre, post), n_out, conj_out)


def _chain_table_checks(radices, tables, n_in, n_out, what) -> int:
    """Raise unless the chain form takes these tables for rows of n_in
    values and n_out outputs; return m."""
    roots, tws1, tws2, h, pre, post = tables
    m = math.prod(radices)
    if not (1 <= len(radices) <= lanepack.MAX_STAGES
            and all(r in CHAIN_RADICES for r in radices)):
        raise ValueError(f"{what}: radices {radices} are not 1..{lanepack.MAX_STAGES} of "
                         f"{sorted(CHAIN_RADICES)}")
    if not (0 < n_in <= m and 0 < n_out <= m):
        raise ValueError(f"{what}: n_in={n_in}, n_out={n_out} must lie in [1, {m}]")
    check_operand(h, (m,), f"{what} h")
    device = h.device
    check_stage_tables(m, radices, roots, tws1, device, what, max_stages=lanepack.MAX_STAGES)
    weights = chain_weights(radices)
    if len(tws2) != len(radices) - 1:
        raise ValueError(f"{what}: expected {len(radices) - 1} chain-2 twiddle tables")
    for t, table in enumerate(tws2):
        s = len(radices) - 1 - t
        check_operand(table, (radices[s], m // (radices[s] * weights[s])), f"{what} tws2[{t}]")
        if table.device != device:
            raise ValueError(f"{what}: tws2[{t}] on {table.device}, h on {device}")
    for t, name in ((pre, "pre"), (post, "post")):
        if t is not None:
            check_operand(t, (m,), f"{what} {name}")
            if t.device != device:
                raise ValueError(f"{what}: {name} on {t.device}, h on {device}")
    return m


@functools.lru_cache(maxsize=None)
def chain_resident(device_index: int, form: int, smem: int) -> int:
    """The blocks of the chain form's kernel `form` (chain_kernel_form) of
    `smem` bytes (chain_smem_bytes) the device holds at once."""
    with torch.cuda.device(device_index):
        lib = _build.load()
        out = ctypes.c_int(0)
        _build.check(lib, lib.rf_conv_chain_resident(form, smem, ctypes.byref(out)),
                     "conv_chain resident blocks")
        return out.value


def chain_grid(units: int, resident: int) -> int:
    """Blocks of the chain form's persistent grid: every resident block, at
    most one a unit; block g runs the units g, g + grid, ..."""
    if units < 1 or resident < 1:
        raise ValueError(f"chain_grid: units={units}, resident={resident}")
    return min(units, resident)


class ChainCore:
    """conv_chain_fft on one set of tables, checked and laid out once:
    ChainCore(radices, tables, n_in, n_out, conj_out)(x) is
    conv_chain_fft(x, radices, tables, n_out, conj_out) for x (batch,
    n_in) on the tables' device.  make_conv_fn keeps one a device, so that
    a call checks x alone and passes launch arguments made once."""

    def __init__(self, radices: Sequence[int], tables, n_in: int, n_out: int,
                 conj_out: bool = False):
        self.radices = tuple(radices)
        self.tables = tables
        self.n_in, self.n_out, self.conj_out = n_in, n_out, conj_out
        self.m = _chain_table_checks(self.radices, tables, n_in, n_out, "conv_chain_fft")
        self.device = tables[3].device
        self._laid_out = {}  # tables_smem -> (lib, unit, resident, arguments)

    def _check(self, x, what):
        if x.dim() != 2 or x.shape[1] != self.n_in:
            raise ValueError(f"{what}: expected (batch, {self.n_in}), got shape "
                             f"{tuple(x.shape)}")
        check_operand(x, x.shape, f"{what} input")
        if x.device != self.device:
            raise ValueError(f"{what}: input on {x.device}, tables on {self.device}")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        what = "conv_chain_fft"
        self._check(x, what)
        if x.device.type == "cpu":
            return conv_chain_fft_plain(x, self.radices, self.tables, self.n_out, self.conj_out)
        require_cuda(x, what)
        if x.shape[0] == 0:
            return torch.empty((0, self.n_out), dtype=x.dtype, device=x.device)
        y, _ = self._launch(x, what)
        conv_chain_fft.launches += 1
        return y

    def _lay_out(self, tables_smem: Optional[bool], phase_stamps: bool):
        """(lib, unit, resident blocks, the launcher's arguments from n_in to
        form) of a launch, by the rules above where tables_smem is None."""
        key = (tables_smem, phase_stamps)
        if key in self._laid_out:
            return self._laid_out[key]
        roots, tws1, tws2, h, pre, post = self.tables
        m, radices, n_in, n_out = self.m, self.radices, self.n_in, self.n_out
        device = self.device.index if self.device.index is not None else (
            torch.cuda.current_device())
        if tables_smem is None:
            tables_smem = chain_tables_smem(device, m, radices, n_in, n_out, pre is not None,
                                            post is not None)
        smem = chain_smem_bytes(m, radices, n_in, n_out, pre is not None, post is not None,
                                tables_smem)
        if smem > _build.SMEM_MAX:
            raise ValueError(f"conv_chain_fft: radices {radices} do not fit one block")
        form = chain_kernel_form(radices)
        k = len(radices)
        rp = (ctypes.c_void_p * k)(*[t.data_ptr() for t in roots])  # host arrays of pointers
        tw = (ctypes.c_void_p * (2 * k))(*[t.data_ptr() for t in list(tws1) + list(tws2)],
                                         None, None)
        args = (n_in, n_out, chain_unit(m), k, *(radices + (1,) * (lanepack.MAX_STAGES - k)),
                ctypes.addressof(rp), ctypes.addressof(tw), h.data_ptr(), _ptr(pre), _ptr(post),
                int(self.conj_out), int(tables_smem), form)
        out = (_build.load(phase_stamps=phase_stamps), chain_unit(m),
               chain_resident(device, form, smem), args, (rp, tw))  # rp, tw kept alive
        self._laid_out[key] = out
        return out

    def _launch(self, x, what, tables_smem=None, stamps=None):
        """Launch the kernel on x (checked), h, pre and post where
        tables_smem says (the rule where None), stamped where stamps is
        given; return (y, grid)."""
        lib, unit, resident, args, _ = self._lay_out(tables_smem, stamps is not None)
        grid = chain_grid(-(-x.shape[0] // unit), resident)
        y = torch.empty((x.shape[0], self.n_out), dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if stamps is None:
                code = lib.rf_conv_chain_fft(x.data_ptr(), y.data_ptr(), x.shape[0], *args, grid,
                                             stream)
            else:
                code = lib.rf_conv_chain_fft_stamps(x.data_ptr(), y.data_ptr(), x.shape[0],
                                                    *args, grid, stamps.data_ptr(), stream)
        _build.check(lib, code, what)
        return y, grid


def conv_chain_fft(x: torch.Tensor, radices: Sequence[int], tables, n_out: int,
                   conj_out: bool = False) -> torch.Tensor:
    """The convolution core's chain form for x (batch, n_in) complex64 ->
    (batch, n_out), m = prod(radices) >= n_in, n_out: the same function as
    conv_fft on 1..4 radices of CHAIN_RADICES (chain_radices).

    tables = (roots, tws1, tws2, h, pre, post) on x's device: roots, tws1,
    tws2 from double_chain_tables(m, radices, direction); h (m,) in chain
    1's output positions (chain_h_table); pre, post (m,) complex64 or None
    (zero beyond n_in / n_out).  A persistent grid (chain_grid) walks units
    of chain_unit(m) transforms, the next unit's rows landing while the
    current one runs its chains; h, pre and post are read from shared
    memory or through L2 by chain_tables_smem.  ChainCore checks the tables
    once for many calls.
    """
    if x.dim() != 2:
        raise ValueError(f"conv_chain_fft: expected (batch, n_in), got shape {tuple(x.shape)}")
    return ChainCore(radices, tables, x.shape[1], n_out, conj_out)(x)


#: kernel launches since the count was last set to 0
conv_chain_fft.launches = 0

#: the chain form's stamped phases, summed over a persistent block's units
#: (tools/torch_phase_times.py): waiting for its rows, chain 1 with the
#: pre-multiply and h, chain 2 with the store
CHAIN_PHASES = ("wait", "chain 1+H", "chain 2+store")


def conv_chain_phase_stamps(x: torch.Tensor, radices: Sequence[int], tables, n_out: int,
                            conj_out: bool = False):
    """conv_chain_fft through its stamped form, which only the library
    built with RF_PHASE_STAMPS holds (no route launches it): (y, stamps,
    phases), stamps (grid, 4) int64 nanoseconds of %globaltimer: a block's
    start and that start plus the running sums of its CHAIN_PHASES."""
    what = "conv_chain_phase_stamps"
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (batch, n_in), got shape {tuple(x.shape)}")
    core = ChainCore(radices, tables, x.shape[1], n_out, conj_out)
    core._check(x, what)
    require_cuda(x, what)
    stamps = torch.zeros((x.shape[0], len(CHAIN_PHASES) + 1), dtype=torch.int64,
                         device=x.device)
    y, grid = core._launch(x, what, stamps=stamps)
    return y, stamps[:grid], CHAIN_PHASES


def make_conv_fn(
    m: int,
    direction: FftDirection,
    dtype,
    h: np.ndarray,
    pre: Optional[np.ndarray] = None,
    post: Optional[np.ndarray] = None,
    conj_out: bool = False,
    n_in: Optional[int] = None,
    n_out: Optional[int] = None,
):
    """Build fn: complex64 (..., n_in) -> (..., n_out) computing

        out = [post *] maybe_conj( FFT_m( conj( FFT_m([pre *] zeropad(x)) * H ) ) )

    through the chain form wherever chain_radices(m) holds (a ChainCore
    for each device: conv_chain_fft with its tables checked once; faster
    than conv_fft at every length timed on an H100: PERF.md), else through
    conv_fft at lanepack.tile_radices(m).  h, pre, post are
    complex128 host arrays; pre / post may be shorter than m (zero-extended,
    which is the Bluestein zero-padding).  n_in / n_out default to m.
    """
    if not conv_supported(m, dtype):
        raise ValueError(f"no one-pass conv core for m={m}, dtype={np.dtype(dtype)}")
    n_in = n_in or m
    n_out = n_out or m
    extra = [zero_extended(h, m), zero_extended(pre, m), zero_extended(post, m)]
    present = [t is not None for t in extra]
    radices = chain_radices(m)
    chained = radices is not None
    if chained:
        groups = list(double_chain_tables(m, radices, direction))
        extra[0] = chain_h_table(extra[0], radices)
    else:
        radices = lanepack.tile_radices(m)
        groups = list(lanepack.stage_tables(m, radices, direction))
    cuts = np.cumsum([len(g) for g in groups])
    tables = calg.DeviceTables([a for g in groups for a in g]
                               + [t for t in extra if t is not None])

    cores = {}  # device -> ChainCore

    def on(device):
        t = tables.on(device)
        rest = iter(t[cuts[-1]:])
        chains = [list(t[a:b]) for a, b in zip((0, *cuts[:-1]), cuts)]
        return (*chains, *(next(rest) if has else None for has in present))

    def apply(x):
        flat = x.reshape(-1, n_in).contiguous()
        if chained:
            core = cores.get(x.device)
            if core is None:
                core = cores[x.device] = ChainCore(radices, on(x.device), n_in, n_out, conj_out)
            y = core(flat)
        else:
            y = conv_fft(flat, radices, on(x.device), n_out, conj_out)
        return y.reshape(x.shape[:-1] + (n_out,))

    return apply


def _conv_core_fn(m: int, direction: FftDirection, dtype, **kw):
    """The convolution core for inner length m: one pass when one transform
    fits a block, else the two-pass core."""
    if conv_supported(m, dtype):
        return make_conv_fn(m, direction, dtype, **kw)
    return conv_radix.make_radix_conv_fn(m, direction, dtype, **kw)


def make_bluestein_fn(n: int, m: int, direction: FftDirection, dtype):
    """Whole Bluestein transform of length n (inner length m) as one
    convolution core: chirp as pre and post, the inner-FFT spectrum of the
    wrapped conjugate chirp as H (reference: bluesteins_algorithm.rs:62-87)."""
    chirp, h_fft = bluestein_tables(n, m, direction)
    return _conv_core_fn(m, direction, dtype, h=h_fft, pre=chirp, post=chirp,
                         conj_out=True, n_in=n, n_out=n)


def make_raders_fn(p: int, direction: FftDirection, dtype):
    """Whole Rader transform of prime length p around a convolution core of
    m = p - 1 (reference: raders_algorithm.rs:86-109, 174-233).

    One-pass core: the root-order gathers are two permute launches around it
    (the JAX package's default rader_gather = "kernel"), and the DC bin and
    the "+x0" fixup are torch glue.  Two-pass core: both gathers and the +x0
    ride its passes (x0_add, emit_sum); with config.rader_full_out the
    DC-first layout too, and with config.rader_in_shift as well the core
    reads the raw rows (no copy of x[:, 1:]), as the JAX package's
    conv.py:286-350 does.  The reference's "+x0 to the DC bin before the
    second transform" is hoisted out of the core:
    FFT(c + conj(x0) e0) = FFT(c) + conj(x0).
    """
    m = p - 1
    perm_in, inv_gather, b_fft = raders_tables(p, direction)
    if not conv_supported(m, dtype):
        full_out = bool(config.rader_full_out)
        in_shift = full_out and bool(config.rader_in_shift)
        core = conv_radix.make_radix_conv_fn(
            m, direction, dtype, h=b_fft, conj_out=True, in_perm=perm_in - 1,
            out_perm=inv_gather, x0_add=True, emit_sum=True, full_out=full_out,
            in_shift=in_shift,
        )

        def apply_fused(x):
            flat = x.reshape(-1, p)
            if in_shift:
                out = core(flat)
            elif full_out:
                out = core(flat[:, 1:], const=flat[:, :1])
            else:
                # out[0] = x0 + sum(x[1:]); the rest already holds conj(D[inv]) + x0
                x0 = flat[:, :1].contiguous()
                rest, sums = core(flat[:, 1:].contiguous(), const=x0)
                out = torch.cat([x0 + sums, rest], dim=1)
            return out.reshape(x.shape)

        return apply_fused

    core = make_conv_fn(m, direction, dtype, h=b_fft)
    gather_in = make_permute_fn(perm_in - 1)
    gather_out = make_permute_fn(inv_gather)

    def apply(x):
        flat = x.reshape(-1, p)
        d = gather_out(core(gather_in(flat[:, 1:].contiguous())))
        out = torch.empty_like(flat)
        # out[0] = x[0] + A[0] = sum(x): A[0] sums the permuted x[1:]
        out[:, 0] = flat.sum(dim=-1)
        # rest = conj(D[inv] + conj(x0)) = conj(D[inv]) + x0, in one pass
        torch.add(torch.conj(d), flat[:, :1], out=out[:, 1:])
        return out.reshape(x.shape)

    return apply
