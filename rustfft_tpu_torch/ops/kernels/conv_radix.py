"""Two-pass convolution core: the port of K14.

Replaces rustfft_tpu/ops/pallas/conv_radix.py (`_kernel`, `_make_pass`,
`radix_conv_supported`, `make_radix_conv_fn`): the Bluestein / Rader core

    out = [post *] maybe_conj( FFT_m( conj( FFT_m([pre *] zeropad(x)) * H ) ) )

for inner lengths m whose transform does not fit one block, at the split
choose_split(m) = (P, Q).  Two forms:

  the cluster passes (cluster_form: m = r*16384, r = 1, 2, 4, 8, 16): each
      FFT_m one launch of csrc/radix.cuh's body, `conv_radix_pass1` and
      `conv_radix_pass2`, the pointwise work in its load and store;
  the four stages (every other m: 633 inner lengths of the primes in
      [8192, 2^20], tools/torch_prime_cores.py): each FFT_m K12's column
      and row stage on ragged in-place tiles (csrc/largepad.cuh; `tile(P)`
      and `tile(Q)` columns a block whatever divides the other axis, K7's
      register, Bluestein and direct stages, ops/kernels/largepad.py), with
      the pointwise work in their source and sink (csrc/conv_pad.cu,
      csrc/conv_pad_row.cu):

  pass 1: `conv_col_stage` loads [pre *] x or the Rader gather x[perm[j]]
          and emits per-(row, tile) partial sums of the raw input;
          `conv_row_stage` stores conj(. * H) in natural order;
  pass 2: `conv_col_stage` plain (K12's own source); `conv_row_stage`
          stores [conj] [* post] [+ x0], scattered by the Rader output
          permutation, with full_out in the DC-first layout out[0] = x0 +
          sum(x).

Four launches and eight traversals of m (the TPU kernel: two and four).

The JAX kernel's two options, off by default there and here:
  gauss     (config.conv_radix_gauss; conv_radix.py:183, :232, :266): every
            stage in the Gauss form.  By that switch the four stages run
            csrc/large.cuh's general kernels (tiles that divide the other
            axis, two buffers; csrc/conv_radix.cu), counted by
            `conv_col_stage_gauss` and `conv_row_stage_gauss`; the only
            other launch left there is the column stage's default form
            (`conv_col_stage(general=True)`), the fused large Bluestein's
            kernel A at Q below 1536 (ops/kernels/convlarge.py);
  in_shift  (config.rader_in_shift; conv_radix.py:161, :327): the Rader
            core reads the raw (batch, m + 1) rows.  Pass 1's column stage
            takes the view x[:, 1:] (rows m + 1 apart, no copy) and pass 2
            reads x0 = x[:, 0] from the same rows; the DC bin stays x0 plus
            the partial sums of the raw input, never the core's output.
Each wrapper runs its plain torch version on a CPU tensor and launches its
kernel on a CUDA tensor, or raises.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...common import FftDirection
from ...config import config
from .. import calg
from . import _build, fused, large, largepad
from .lanepack import (
    check_operand, check_stage_tables, padded_stage_args, require_cuda, smem_bytes,
    stage_tables,
)
from .permute import check_index, permutation_index

#: bytes of static shared memory the column stage's partial sums (block_sum)
#: hold beside its tile
_COL_STATIC_SMEM = 32 * 8


def col_tile(p: int, q: int, gauss: bool = False) -> Optional[int]:
    """Columns j2 per block of csrc/large.cuh's column kernels (the Gauss
    form's and conv_col_stage(general=True)'s; choose_split's rule): the
    largest of 16, 8, 4, 2, 1 that divides Q and fits shared memory (with
    the Gauss tables with `gauss`)."""
    for qt in (16, 8, 4, 2, 1):
        need = smem_bytes(p * qt, large.stage_radices(p), gauss) + _COL_STATIC_SMEM
        if q % qt == 0 and need <= _build.SMEM_MAX:
            return qt
    return None


def row_tile(q: int, p: int, gauss: bool = False) -> Optional[int]:
    """Columns k1 per block of csrc/large.cuh's general row kernel (the
    Gauss form's; choose_split's rule): the largest of 16, 8, 4, 2, 1 that
    divides P and fits shared memory (16 columns are 128-byte segments)."""
    for pt in (16, 8, 4, 2, 1):
        if p % pt == 0 and smem_bytes(q * pt, large.stage_radices(q), gauss) <= _build.SMEM_MAX:
            return pt
    return None


@functools.lru_cache(maxsize=1024)
def choose_split(m: int) -> Optional[Tuple[int, int]]:
    """(P, Q) of the two-pass core for m: large.choose_pqq(m) with Q = q1*q2,
    when both stages have a tile; else None."""
    pqq = large.choose_pqq(m)
    if pqq is None:
        return None
    p, q = pqq[0], pqq[1] * pqq[2]
    if col_tile(p, q) is None or row_tile(q, p) is None:
        return None
    return p, q


def tiles(p: int, q: int, gauss: bool = False, general: bool = False) -> int:
    """Column-stage tiles a batch row has, one partial sum each: ceil(Q /
    largepad.tile(P)) on the ragged tiles, Q / col_tile on csrc/large.cuh's
    kernels (the Gauss form, `general`)."""
    if gauss or general:
        return q // col_tile(p, q, gauss)
    return -(-q // largepad.tile(p))


def _ragged_ok(p: int, q: int) -> bool:
    """K12's kernels run both chains of the split (largepad's Bluestein caps
    and tiles)."""
    try:
        largepad._check_chain(p, large.stage_radices(p), largepad.COL_MAX_M, "col")
        largepad._check_chain(q, large.stage_radices(q), largepad.ROW_MAX_M, "row")
    except ValueError:
        return False
    return largepad.tile(p) is not None and largepad.tile(q) is not None


def radix_conv_supported(m: int, dtype) -> bool:
    return np.dtype(dtype) == np.complex64 and choose_split(m) is not None


def _check_table(t, shape, device, what: str) -> None:
    """A complex64 operand that may be absent: shape, contiguity, device."""
    if t is None:
        return
    check_operand(t, shape, what)
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, input on {device}")


def _check_rows(x: torch.Tensor, what: str) -> None:
    """A (batch, width) complex64 tensor whose rows are contiguous, each at
    least `width` elements after the one before: a contiguous tensor, or a
    column slice such as x[:, 1:] of one."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.complex64:
        raise TypeError(f"{what}: expected complex64, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (batch, n_in), got {tuple(x.shape)}")
    if (x.shape[1] > 1 and x.stride(1) != 1) or (x.shape[0] > 1 and x.stride(0) < x.shape[1]):
        raise ValueError(f"{what}: rows must be contiguous and must not overlap")


def tile_partials(v: torch.Tensor, p: int, q: int, gauss: bool = False,
                  general: bool = False) -> torch.Tensor:
    """(batch, tiles(P, Q)): the sums of v (batch, P*Q) over each column
    tile, qt = largepad.tile(P) columns (col_tile on csrc/large.cuh's
    kernels), the last one as wide as the columns left."""
    qt = col_tile(p, q, gauss) if gauss or general else largepad.tile(p)
    cols = torch.nn.functional.pad(v.reshape(-1, p, q), (0, -q % qt))
    return cols.reshape(cols.shape[0], p, -1, qt).sum(dim=(1, 3))


def conv_col_stage_plain(x, p, q, tables, pre=None, perm=None, emit_sum=False, gauss=False,
                         general=False):
    """Plain torch version of conv_col_stage."""
    m = p * q
    v = torch.index_select(x, 1, perm) if perm is not None else x
    v = torch.nn.functional.pad(v, (0, m - v.shape[1]))
    partials = tile_partials(v, p, q, gauss, general) if emit_sum else None
    if pre is not None:
        v = v * pre
    plain = (large.large_col_stage_gauss_plain if gauss else
             large.large_col_stage_plain if general else largepad.largepad_col_stage_plain)
    return plain(v, p, q, tables), partials


def _check_chain_tables(m: int, roots, tws, device, what: str, gauss: bool,
                        general: bool = False) -> None:
    """The tables of the length-m chain of the stage's form: the Gauss
    form's (3, r) tables, csrc/large.cuh's roots (`general`), else the
    in-place chain's (largepad.col_tables / row_tables: a Bluestein stage's
    table in place of its roots)."""
    radices = large.stage_radices(m)
    check_stage_tables(m, radices, roots, tws, device, what, gauss,
                       root_lens=None if gauss or general else fused.chain_root_lens(radices))


def conv_col_stage(x: torch.Tensor, p: int, q: int, tables, pre=None, perm=None,
                   emit_sum: bool = False, gauss: bool = False, general: bool = False):
    """Column stage of FFT_m, m = P*Q, for x (batch, n_in) complex64 zero-padded
    to m -> (a (batch, Q, P), partials (batch, tiles(P, Q)) or None).

    x's rows need only be contiguous: the Rader core's in_shift passes the
    view x[:, 1:] of the raw (batch, m + 1) rows.  tables = (roots, tws,
    outer) from largepad.col_tables(P, Q, direction) (in the Gauss form
    large.col_tables(P, Q, direction, gauss=True)); pre: (m,) complex64
    multiplied in after the load; perm: (m,) int32 gather a[j] = x[perm[j]]
    (needs n_in == m); emit_sum: also return the sums of the raw input over
    each block's tile, largepad.tile(P) columns j2 with the last one ragged
    (tile_partials; their row sum is sum(x)); gauss: the Gauss form on
    csrc/large.cuh's general kernel (counted by conv_col_stage_gauss);
    general: the default form on csrc/large.cuh's kernels (tiles that divide
    Q, large.col_tables), which the fused large Bluestein's general form
    takes as its kernel A (convlarge.make_bluestein_large_fn).  Else, on
    the card, K14's ragged source (csrc/conv_pad.cu), or K12's own column
    kernel where the stage is plain (pass 2: no pre, perm or sums, rows of
    m contiguous values).
    """
    what = "conv_col_stage"
    _check_rows(x, f"{what} input")
    m = p * q
    n_in = x.shape[1]
    if not 0 < n_in <= m:
        raise ValueError(f"{what}: n_in={n_in} not in [1, {m}]")
    roots, tws, outer = tables
    _check_chain_tables(p, roots, tws, x.device, what, gauss, general)
    _check_table(outer, (q, p), x.device, f"{what} outer twiddle")
    _check_table(pre, (m,), x.device, f"{what} pre")
    if perm is not None:
        check_index(perm, m, x.device, f"{what} perm")
        if n_in != m:
            raise ValueError(f"{what}: a gather needs n_in == m, got {n_in} != {m}")
    qt = col_tile(p, q, gauss) if gauss or general else largepad.tile(p)
    if qt is None:
        raise ValueError(f"{what}: no tile for P={p}, Q={q}")
    if x.device.type == "cpu":
        return conv_col_stage_plain(x, p, q, tables, pre, perm, emit_sum, gauss, general)
    require_cuda(x, what)
    radices = large.stage_radices(p)
    if not (gauss or general):
        largepad._check_chain(p, radices, largepad.COL_MAX_M, what)
    batch = x.shape[0]
    a = torch.empty((batch, q, p), dtype=x.dtype, device=x.device)
    partials = (torch.empty((batch, tiles(p, q, gauss, general)), dtype=x.dtype,
                            device=x.device) if emit_sum else None)
    if batch == 0:
        return a, partials
    ld = x.stride(0) if batch > 1 else n_in
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if gauss or general:
            code = lib.rf_conv_col_stage(
                x.data_ptr(), a.data_ptr(), None if partials is None else partials.data_ptr(),
                batch, n_in, ld, p, q, qt, int(gauss), *padded_stage_args(radices, roots, tws),
                outer.data_ptr(), None if pre is None else pre.data_ptr(),
                None if perm is None else perm.data_ptr(), stream)
        elif pre is None and perm is None and not emit_sum and n_in == m and ld == m:
            code = lib.rf_largepad_col_stage(x.data_ptr(), a.data_ptr(), batch, p, q, qt,
                                             *fused.chain_args(radices, roots, tws),
                                             outer.data_ptr(), stream)
        else:
            code = lib.rf_conv_pad_col_stage(
                x.data_ptr(), a.data_ptr(), None if partials is None else partials.data_ptr(),
                batch, n_in, ld, p, q, qt, *fused.chain_args(radices, roots, tws),
                outer.data_ptr(), None if pre is None else pre.data_ptr(),
                None if perm is None else perm.data_ptr(), stream)
    _build.check(lib, code, what)
    (conv_col_stage_gauss if gauss else conv_col_stage).launches += 1
    return a, partials


#: kernel launches since the count was last set to 0 (the default form)
conv_col_stage.launches = 0


def conv_col_stage_gauss(x: torch.Tensor, p: int, q: int, tables, **kw):
    """conv_col_stage in the Gauss form (K14's gauss_mode); its launches are
    counted here.  tables from large.col_tables(P, Q, direction, gauss=True)."""
    return conv_col_stage(x, p, q, tables, gauss=True, **kw)


conv_col_stage_gauss.launches = 0


def conv_row_stage_plain(a, q, p, tables, n_out, h=None, conj_out=False, post=None,
                         x0=None, scatter=None, partials=None, gauss=False):
    """Plain torch version of conv_row_stage."""
    plain = large.large_row_stage_gauss_plain if gauss else largepad.largepad_row_stage_plain
    z = plain(a, q, p, tables)
    if h is not None:
        z = torch.conj(z * h)
    if conj_out:
        z = torch.conj(z)
    if post is not None:
        z = z * post
    if x0 is not None:
        z = z + x0[:, None]
    z = z.resolve_conj()[:, :n_out]
    if scatter is not None:
        z = torch.empty_like(z).index_copy_(1, scatter.long(), z)
    if partials is not None:
        z = torch.cat([(x0 + partials.sum(dim=1))[:, None], z], dim=1)
    return z


def conv_row_stage(a: torch.Tensor, q: int, p: int, tables, n_out: int, h=None,
                   conj_out: bool = False, post=None, x0=None, scatter=None,
                   partials=None, gauss: bool = False) -> torch.Tensor:
    """Row stage of FFT_m and the core's epilogue: a (batch, Q, P) complex64
    -> z (batch, n_out), z[k] for the natural-order FFT output k < n_out.

    tables = (roots, tws) from largepad.row_tables(Q, direction) (in the
    Gauss form large.row_tables(Q, direction, gauss=True)).  In order: h
    (m,): z = conj(z * h); conj_out: z = conj(z); post (m,): z = z * post;
    x0 (batch,), any stride (the in_shift core passes the view x[:, 0] of
    the raw rows): z = z + x0; scatter (m,) int32 (n_out == m): z[k] is
    written to position scatter[k]; partials (batch, tiles) from pass 1's
    conv_col_stage (needs x0 and scatter, full_out): the output is (batch,
    m + 1) with out[0] = x0 + sum(partials) and the rest shifted by 1;
    gauss: the Gauss form on csrc/large.cuh's general kernel (counted by
    conv_row_stage_gauss).  On the card K14's ragged sink
    (csrc/conv_pad_row.cu) over largepad.tile(Q) columns k1 a block.
    """
    what = "conv_row_stage"
    if a.dim() != 3:
        raise ValueError(f"{what}: expected (batch, Q, P), got {tuple(a.shape)}")
    m = p * q
    batch = a.shape[0]
    check_operand(a, (batch, q, p), f"{what} input")
    roots, tws = tables
    _check_chain_tables(q, roots, tws, a.device, what, gauss)
    if not 0 < n_out <= m:
        raise ValueError(f"{what}: n_out={n_out} not in [1, {m}]")
    _check_table(h, (m,), a.device, f"{what} h")
    _check_table(post, (m,), a.device, f"{what} post")
    if x0 is not None and (x0.dtype != torch.complex64 or tuple(x0.shape) != (batch,)
                           or x0.device != a.device):
        raise ValueError(f"{what}: x0 must be a ({batch},) complex64 tensor on {a.device}")
    if scatter is not None:
        check_index(scatter, m, a.device, f"{what} scatter")
        if n_out != m:
            raise ValueError(f"{what}: a scatter needs n_out == m")
    if partials is not None:
        if x0 is None or scatter is None or partials.dim() != 2:
            raise ValueError(f"{what}: full_out needs x0, scatter and 2-D partials")
        _check_table(partials, (batch, partials.shape[1]), a.device, f"{what} partials")
    pt = row_tile(q, p, gauss) if gauss else largepad.tile(q)
    if pt is None:
        raise ValueError(f"{what}: no tile for Q={q}, P={p}")
    if a.device.type == "cpu":
        return conv_row_stage_plain(a, q, p, tables, n_out, h, conj_out, post, x0,
                                    scatter, partials, gauss)
    require_cuda(a, what)
    radices = large.stage_radices(q)
    if not gauss:
        largepad._check_chain(q, radices, largepad.ROW_MAX_M, what)
    width = n_out + (1 if partials is not None else 0)
    y = torch.empty((batch, width), dtype=a.dtype, device=a.device)
    if batch == 0:
        return y
    lib = _build.load()

    def ptr(t):
        return None if t is None else t.data_ptr()

    epilogue = (ptr(h), ptr(post), ptr(x0), 0 if x0 is None else x0.stride(0), ptr(scatter),
                ptr(partials), 0 if partials is None else partials.shape[1], int(conj_out),
                n_out, width)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if gauss:
            code = lib.rf_conv_row_stage_gauss(a.data_ptr(), y.data_ptr(), batch, q, p, pt,
                                               *padded_stage_args(radices, roots, tws),
                                               *epilogue, stream)
        else:
            code = lib.rf_conv_pad_row_stage(a.data_ptr(), y.data_ptr(), batch, q, p, pt,
                                             *fused.chain_args(radices, roots, tws), *epilogue,
                                             stream)
    _build.check(lib, code, what)
    (conv_row_stage_gauss if gauss else conv_row_stage).launches += 1
    return y


#: kernel launches since the count was last set to 0 (the default form)
conv_row_stage.launches = 0


def conv_row_stage_gauss(a: torch.Tensor, q: int, p: int, tables, n_out: int, **kw):
    """conv_row_stage in the Gauss form (K14's gauss_mode); its launches are
    counted here.  tables from large.row_tables(Q, direction, gauss=True)."""
    return conv_row_stage(a, q, p, tables, n_out, gauss=True, **kw)


conv_row_stage_gauss.launches = 0


# -- the cluster form: each pass one launch of the radix body ---------------

#: the inner lengths m = r * 128 * 128 the radix body serves (K9's r = 2 ..
#: 16 and K7's 16384 at r = 1)
CLUSTER_RADICES = (1, 2, 4, 8, 16)


def cluster_form(m: int, gauss: bool = False, in_shift: bool = False) -> Optional[int]:
    """r where the core runs as two cluster passes (conv_radix_pass1,
    conv_radix_pass2: one launch of csrc/radix.cuh's body each) at m =
    r*16384, r in CLUSTER_RADICES; None where it keeps the four launches
    of the column and row stages: every other m (746496, and any whose
    split is not 128 x 128 x r), the Gauss form (the radix body has none)
    and in_shift (its x0 column rides the raw rows; the cluster form's
    pass 1 would take the ld stride, but the switch's own path stays as
    the JAX package's)."""
    if gauss or in_shift or m % (fused.RADIX_PQ * fused.RADIX_PQ):
        return None
    r = m // (fused.RADIX_PQ * fused.RADIX_PQ)
    return r if r in CLUSTER_RADICES else None


def cluster_tables(r: int, direction: FftDirection):
    """The radix body's tables at m = r*16384, complex64: (roots, tws) of
    the DFT_128 chain (16, 8), t1, tn, rroots, cfac (fused.radix_tables; at
    r = 1, where the body reads tn alone, t1, rroots and cfac are ones)."""
    if r > 1:
        return fused.radix_tables(r, fused.RADIX_PQ, fused.RADIX_PQ, direction)
    p = fused.RADIX_PQ
    roots, tws = stage_tables(p, large.stage_radices(p), direction)
    _, tn, _ = fused.radix_twiddles(1, p, p, direction)
    ones = np.ones((1, p), np.complex64)
    return roots, tws, ones, tn.astype(np.complex64), np.ones(1, np.complex64), ones


def _check_cluster_tables(r: int, tables, device, what: str) -> None:
    roots, tws, t1, tn, rroots, cfac = tables
    p = fused.RADIX_PQ
    check_stage_tables(p, large.stage_radices(p), roots, tws, device, what)
    for t, shape, name in ((t1, (r, p), "t1"), (tn, (p, p), "tn"), (rroots, (r,), "roots_r"),
                           (cfac, (r, p), "cfac")):
        check_operand(t, shape, f"{what} {name}")
        if t.device != device:
            raise ValueError(f"{what}: tables on {t.device}, input on {device}")


def _cluster_fft_plain(v: torch.Tensor, r: int, tables) -> torch.Tensor:
    return fused.radix_fft_plain(v, r, fused.RADIX_PQ, tables)


def _cluster_args(r: int, tables, device):
    roots, tws, t1, tn, rroots, cfac = tables
    clusters_of = fused._resident_clusters(device, r)
    return ([r, *padded_stage_args(large.stage_radices(fused.RADIX_PQ), roots, tws),
             t1.data_ptr(), tn.data_ptr(), rroots.data_ptr(), cfac.data_ptr()], clusters_of)


def conv_radix_pass1_plain(x, m, r, tables, h, pre=None, perm=None, emit_sum=False):
    """Plain torch version of conv_radix_pass1."""
    v = torch.index_select(x, 1, perm) if perm is not None else x
    v = torch.nn.functional.pad(v, (0, m - v.shape[1]))
    partials = None
    if emit_sum:  # block a of a cluster sums the rows b*r*128 + a*128 + j2 of its slice
        partials = v.reshape(-1, fused.RADIX_PQ, r, fused.RADIX_PQ).sum(dim=(1, 3))
    if pre is not None:
        v = v * pre
    z = torch.conj(_cluster_fft_plain(v, r, tables) * h).resolve_conj()
    return z, partials


def conv_radix_pass1(x: torch.Tensor, m: int, tables, h: torch.Tensor, pre=None, perm=None,
                     emit_sum: bool = False):
    """Pass 1 of the cluster form at m = r*16384 (cluster_form): x (batch,
    n_in) complex64 -> (z (batch, m) = conj(FFT_m([pre *] x zero-padded to
    m) * h), partials (batch, r) or None).

    x's rows need only be contiguous (any stride between them, any 8-byte
    alignment: the loads are direct).  tables = cluster_tables(r,
    direction) on x's device; h, pre (m,) complex64; perm (m,) int32 the
    Rader gather a[j] = x[perm[j]] (needs n_in == m); emit_sum: the sums
    of the raw input over each cluster block's slice (their row sum is
    sum(x)).
    """
    what = "conv_radix_pass1"
    _check_rows(x, f"{what} input")
    r = cluster_form(m)
    if r is None:
        raise ValueError(f"{what}: m={m} has no cluster form")
    n_in = x.shape[1]
    if not 0 < n_in <= m:
        raise ValueError(f"{what}: n_in={n_in} not in [1, {m}]")
    _check_cluster_tables(r, tables, x.device, what)
    _check_table(h, (m,), x.device, f"{what} h")
    _check_table(pre, (m,), x.device, f"{what} pre")
    if perm is not None:
        check_index(perm, m, x.device, f"{what} perm")
        if n_in != m:
            raise ValueError(f"{what}: a gather needs n_in == m, got {n_in} != {m}")
    if x.device.type == "cpu":
        return conv_radix_pass1_plain(x, m, r, tables, h, pre, perm, emit_sum)
    require_cuda(x, what)
    batch = x.shape[0]
    z = torch.empty((batch, m), dtype=x.dtype, device=x.device)
    partials = (torch.empty((batch, r), dtype=x.dtype, device=x.device) if emit_sum else None)
    if batch == 0:
        return z, partials
    args, resident = _cluster_args(r, tables, x.device)
    lib = _build.load()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        code = lib.rf_conv_radix_pass1(
            x.data_ptr(), z.data_ptr(), ptr(partials), batch, n_in,
            x.stride(0) if batch > 1 else n_in, *args, h.data_ptr(), ptr(pre), ptr(perm),
            fused.radix_grid(batch, resident), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, what)
    conv_radix_pass1.launches += 1
    return z, partials


conv_radix_pass1.launches = 0


def conv_radix_pass2_plain(z, m, r, tables, n_out, conj_out=False, post=None, x0=None,
                           scatter=None, partials=None):
    """Plain torch version of conv_radix_pass2."""
    u = _cluster_fft_plain(z, r, tables)
    if conj_out:
        u = torch.conj(u)
    if post is not None:
        u = u * post
    if x0 is not None:
        u = u + x0[:, None]
    u = u.resolve_conj()[:, :n_out]
    if scatter is not None:
        u = torch.empty_like(u).index_copy_(1, scatter.long(), u)
    if partials is not None:
        u = torch.cat([(x0 + partials.sum(dim=1))[:, None], u], dim=1)
    return u


def conv_radix_pass2(z: torch.Tensor, m: int, tables, n_out: int, conj_out: bool = False,
                     post=None, x0=None, scatter=None, partials=None) -> torch.Tensor:
    """Pass 2 of the cluster form at m = r*16384: z (batch, m) complex64 ->
    (batch, n_out): FFT_m, then in order [conj] [* post (m,)] [+ x0
    (batch,), any stride]; scatter (m,) int32 (n_out == m): bin k goes to
    position scatter[k]; partials (batch, r) from pass 1 (full_out: needs
    x0 and scatter): the output is (batch, m + 1) with out[0] = x0 +
    sum(partials) and the rest shifted by 1.  tables = cluster_tables(r,
    direction) on z's device.
    """
    what = "conv_radix_pass2"
    r = cluster_form(m)
    if r is None:
        raise ValueError(f"{what}: m={m} has no cluster form")
    check_operand(z, (z.shape[0], m), f"{what} input")
    batch = z.shape[0]
    if not 0 < n_out <= m:
        raise ValueError(f"{what}: n_out={n_out} not in [1, {m}]")
    _check_cluster_tables(r, tables, z.device, what)
    _check_table(post, (m,), z.device, f"{what} post")
    if x0 is not None and (x0.dtype != torch.complex64 or tuple(x0.shape) != (batch,)
                           or x0.device != z.device):
        raise ValueError(f"{what}: x0 must be a ({batch},) complex64 tensor on {z.device}")
    if scatter is not None:
        check_index(scatter, m, z.device, f"{what} scatter")
        if n_out != m:
            raise ValueError(f"{what}: a scatter needs n_out == m")
    if partials is not None:
        if x0 is None or scatter is None:
            raise ValueError(f"{what}: full_out needs x0 and scatter")
        _check_table(partials, (batch, r), z.device, f"{what} partials")
    if z.device.type == "cpu":
        return conv_radix_pass2_plain(z, m, r, tables, n_out, conj_out, post, x0, scatter,
                                      partials)
    require_cuda(z, what)
    width = n_out + (1 if partials is not None else 0)
    y = torch.empty((batch, width), dtype=z.dtype, device=z.device)
    if batch == 0:
        return y
    src = fused._aligned16(z)
    args, resident = _cluster_args(r, tables, z.device)
    lib = _build.load()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(z.device):
        code = lib.rf_conv_radix_pass2(
            src.data_ptr(), y.data_ptr(), batch, *args, ptr(post), ptr(x0),
            0 if x0 is None else x0.stride(0), ptr(scatter), ptr(partials),
            0 if partials is None else r, int(conj_out), n_out, width,
            fused.radix_grid(batch, resident), torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(lib, code, what)
    conv_radix_pass2.launches += 1
    return y


conv_radix_pass2.launches = 0


#: gather_probe's modes
GATHER_MODES = ("streaming", "gather", "scatter")


def gather_probe(x: torch.Tensor, idx: torch.Tensor, mode: str) -> torch.Tensor:
    """The access-pattern probe of the Rader core's permutations (the
    RF_PHASE_STAMPS library only; for timing): x (batch, m) complex64 into
    y, one thread an element: "streaming" y = x, "gather" y[:, i] =
    x[:, idx[i]] (8-byte reads at the permutation), "scatter" y[:, idx[i]]
    = x[:, i] (8-byte writes); idx (m,) int32 a permutation."""
    what = "gather_probe"
    check_operand(x, (x.shape[0], x.shape[1]), what)
    check_index(idx, x.shape[1], x.device, what)
    require_cuda(x, what)
    y = torch.empty_like(x)
    lib = _build.load(phase_stamps=True)
    with torch.cuda.device(x.device):
        code = lib.rf_gather_probe(x.data_ptr(), y.data_ptr(), idx.data_ptr(), x.shape[0],
                                   x.shape[1], GATHER_MODES.index(mode),
                                   torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, what)
    return y


def zero_extended(a, m: int) -> Optional[np.ndarray]:
    """Complex table zero-extended (or cut) to length m, complex64."""
    if a is None:
        return None
    a = np.asarray(a)
    full = np.zeros(m, np.complex128)
    full[: min(len(a), m)] = a[:m]
    return full.astype(np.complex64)


def radix_conv_tables(m: int, direction: FftDirection, h=None, pre=None, post=None,
                      in_perm=None, out_perm=None, gauss: bool = False) -> Dict[str, Any]:
    """Host tables of the two-pass core for m, by name: "col" (roots, tws,
    outer) of the column stage and "row" (roots, tws) of the row stage, as
    largepad.col_tables / row_tables at choose_split(m) (the in-place
    chains' tables; with `gauss` large.col_tables / row_tables in the Gauss
    form); "h", "pre", "post" zero-extended to (m,) complex64; "perm" the
    in_perm gather and "scatter" the inverse of out_perm, (m,) int32; absent
    ones None."""
    p, q = choose_split(m)
    if gauss:
        col, row = large.col_tables(p, q, direction, True), large.row_tables(q, direction, True)
    else:
        col, row = largepad.col_tables(p, q, direction), largepad.row_tables(q, direction)
    roots_p, tws_p, outer = col
    return {
        "col": (roots_p, tws_p, outer),
        "row": row,
        "h": zero_extended(h, m), "pre": zero_extended(pre, m), "post": zero_extended(post, m),
        "perm": None if in_perm is None else permutation_index(in_perm),
        "scatter": (None if out_perm is None
                    else np.argsort(permutation_index(out_perm)).astype(np.int32)),
    }


def make_radix_conv_fn(
    m: int,
    direction: FftDirection,
    dtype,
    h: np.ndarray,
    pre: Optional[np.ndarray] = None,
    post: Optional[np.ndarray] = None,
    conj_out: bool = False,
    n_in: Optional[int] = None,
    n_out: Optional[int] = None,
    in_perm: Optional[np.ndarray] = None,
    out_perm: Optional[np.ndarray] = None,
    x0_add: bool = False,
    emit_sum: bool = False,
    full_out: bool = False,
    gauss: Optional[bool] = None,
    in_shift: bool = False,
):
    """Build fn: complex64 (..., n_in) -> (..., n_out) computing

        out = [post *] maybe_conj( FFT_m( conj( FFT_m([pre *] zeropad(x)) * H ) ) )

    with the contract of the JAX package's make_radix_conv_fn
    (conv_radix.py:643-773): h, pre, post are complex128 host arrays
    (pre/post zero-extended to m); in_perm / out_perm are m-point gather
    permutations fused into pass 1's load and pass 2's store (n_in == m,
    no pre / no post); x0_add: fn(x, const) adds const (..., 1) to every
    bin; emit_sum: fn returns (out, sums (..., 1)), the f32 sums of the raw
    input; full_out (needs all of them): fn returns the whole DC-first
    (..., m + 1) Rader output, out[0] = const + sum.  gauss: None resolves
    to config.conv_radix_gauss (conv_radix.py:720); every stage in the Gauss
    form.  in_shift (needs full_out and in_perm, as conv_radix.py:726
    asserts): fn(x) takes the raw (..., m + 1) Rader rows; pass 1 reads
    x[..., 1:] and pass 2 takes const = x[..., 0], both from those rows, with
    no copy.
    """
    if not radix_conv_supported(m, dtype):
        raise ValueError(f"no two-pass conv core for m={m}, dtype={np.dtype(dtype)}")
    p, q = choose_split(m)
    n_in = n_in or m
    n_out = n_out or m
    gauss = config.conv_radix_gauss if gauss is None else bool(gauss)
    if in_perm is not None and (n_in != m or pre is not None):
        raise ValueError("in_perm needs n_in == m and no pre table")
    if out_perm is not None and post is not None:
        raise ValueError("out_perm needs no post table")
    if full_out and not (x0_add and emit_sum and out_perm is not None and n_out == m):
        raise ValueError("full_out needs x0_add, emit_sum, out_perm and n_out == m")
    if in_shift and not (full_out and in_perm is not None):
        raise ValueError("in_shift needs full_out and in_perm")
    if gauss and (col_tile(p, q, gauss) is None or row_tile(q, p, gauss) is None):
        raise ValueError(f"no two-pass conv core for m={m} in the Gauss form")
    if not gauss and not _ragged_ok(p, q):
        raise ValueError(f"no two-pass conv core for m={m} on the ragged tiles")
    r = cluster_form(m, gauss, in_shift)
    if r is not None:
        return _cluster_conv_fn(m, r, direction, h, pre, post, conj_out, n_in, n_out, in_perm,
                                out_perm, x0_add, emit_sum, full_out)
    host = radix_conv_tables(m, direction, h, pre, post, in_perm, out_perm, gauss)
    kp, kq = len(host["col"][0]), len(host["row"][0])
    names = [k for k in ("h", "pre", "post", "perm", "scatter") if host[k] is not None]
    tables = calg.DeviceTables([*host["col"][0], *host["col"][1], host["col"][2],
                                *host["row"][0], *host["row"][1]] + [host[k] for k in names])

    def apply(x, const=None):
        t = tables.on(x.device)
        col = (t[:kp], t[kp : 2 * kp - 1], t[2 * kp - 1])
        row = (t[2 * kp : 2 * kp + kq], t[2 * kp + kq : 2 * kp + 2 * kq - 1])
        tab = dict(zip(names, t[2 * kp + 2 * kq - 1 :]))
        shape = x.shape
        if in_shift:
            if const is not None:
                raise ValueError("in_shift: x0 comes from the raw rows; call fn(x)")
            raw = x.reshape(-1, m + 1)
            if raw.shape[1] > 1 and raw.stride(1) != 1:
                raw = raw.contiguous()
            flat, x0 = raw[:, 1:], raw[:, 0]
        else:
            flat = x.reshape(-1, n_in).contiguous()
            x0 = None
            if x0_add:
                if const is None:
                    raise ValueError("x0_add: call fn(x, const)")
                x0 = const.reshape(-1).contiguous()
        a, partials = conv_col_stage(flat, p, q, col, pre=tab.get("pre"),
                                     perm=tab.get("perm"), emit_sum=emit_sum, gauss=gauss)
        z = conv_row_stage(a, q, p, row, m, h=tab.get("h"), gauss=gauss)
        b, _ = conv_col_stage(z, p, q, col, gauss=gauss)
        out = conv_row_stage(b, q, p, row, n_out, conj_out=conj_out, post=tab.get("post"),
                             x0=x0, scatter=tab.get("scatter"),
                             partials=partials if full_out else None, gauss=gauss)
        out = out.reshape(shape[:-1] + (out.shape[-1],))
        if emit_sum and not full_out:
            return out, partials.sum(dim=1).reshape(shape[:-1] + (1,))
        return out

    return apply


def _cluster_conv_fn(m, r, direction, h, pre, post, conj_out, n_in, n_out, in_perm, out_perm,
                     x0_add, emit_sum, full_out):
    """make_radix_conv_fn's core in the cluster form: conv_radix_pass1 and
    conv_radix_pass2 at m = r*16384."""
    host = radix_conv_tables(m, direction, h, pre, post, in_perm, out_perm)
    roots, tws, *rest = cluster_tables(r, direction)
    names = [k for k in ("h", "pre", "post", "perm", "scatter") if host[k] is not None]
    k = len(roots)
    tables = calg.DeviceTables([*roots, *tws, *rest] + [host[n] for n in names])

    def apply(x, const=None):
        t = tables.on(x.device)
        radix = (t[:k], t[k : 2 * k - 1], *t[2 * k - 1 : 2 * k + 3])
        tab = dict(zip(names, t[2 * k + 3 :]))
        shape = x.shape
        flat = x.reshape(-1, n_in)
        if flat.shape[1] > 1 and flat.stride(1) != 1:
            flat = flat.contiguous()
        x0 = None
        if x0_add:
            if const is None:
                raise ValueError("x0_add: call fn(x, const)")
            x0 = const.reshape(-1)
        z, partials = conv_radix_pass1(flat, m, radix, tab["h"], pre=tab.get("pre"),
                                       perm=tab.get("perm"), emit_sum=emit_sum)
        out = conv_radix_pass2(z, m, radix, n_out, conj_out=conj_out, post=tab.get("post"),
                               x0=x0, scatter=tab.get("scatter"),
                               partials=partials if full_out else None)
        out = out.reshape(shape[:-1] + (out.shape[-1],))
        if emit_sum and not full_out:
            return out, partials.sum(dim=1).reshape(shape[:-1] + (1,))
        return out

    return apply
