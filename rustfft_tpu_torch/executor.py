"""Recipe -> torch function compiler.

Port of rustfft_tpu/executor.py.  A recipe lowers into one nested function on
complex tensors: matmul DFT leaves and Cooley-Tukey stages (ops/dft.py,
ops/ct.py), Good-Thomas, Rader and Bluestein nodes (ops/good_thomas.py,
ops/raders.py, ops/bluestein.py), with every subtree whose length `route`
names replaced by that whole-transform kernel (ops/kernels/).  With the
kernels on, c64 Rader and Bluestein nodes run as one convolution core
(ops/kernels/conv.py), or a Bluestein whose inner length runs on `large` as
the fused large Bluestein (ops/kernels/convlarge.py), and Good-Thomas
re-indexing as permute launches.
Constant tables are precomputed on the host in f64 at build time and copied
to each device once.

A pinned build (`pinned=True`, the hand-built constructors of algorithm.py)
runs the literal recipe, where the JAX package's `allow_fused=False` acts: no
whole-transform kernel at any node and no convolution core for Rader or
Bluestein nodes; Good-Thomas keeps its permute gathers, as in the JAX package.

Built functions are memoized per (recipe, direction, dtype, pinned, config
state), the analogue of the reference's FftCache (fft_cache.rs:5-39) shared
across planners because recipes are pure hashable data.  The config state is
config.switch_key(): every field a built function bakes in.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Tuple

import numpy as np

from . import recipes
from .common import FftDirection
from .config import config
from .ops import bluestein as op_bluestein
from .ops import ct as op_ct
from .ops import dft as op_dft
from .ops import good_thomas as op_gt
from .ops import raders as op_raders
from .ops.kernels import conv, convlarge, dense, fused, lanepack, large, large2f, large3, largepad

# Left factors whose DFT matrix is small enough for the middle-axis matmul
# form of a CT stage (executor.py:_MATRIX_LEAF_MAX of the JAX package).
_MATRIX_LEAF_MAX = 512

_CACHE: "OrderedDict[Tuple, Callable]" = OrderedDict()
_CACHE_MAX = 512


def route(n: int, dtype) -> Optional[str]:
    """Name the whole-transform kernel serving length n, or None (the torch
    recipe tree).  The single source of truth for kernel dispatch, like the
    JAX package's pallas_route, but structural only:

      'lanepack'  c64, a 2-3 radix split with radices <= 256 exists, and one
                  transform fits a block's shared memory;
      'radix'     c64, n = r * 128 * 128 with r in {2, 4, 8, 16}
                  (fused.choose_rpq): 32768 .. 262144, one thread-block
                  cluster of r blocks per transform;
      'two_stage' c64, fused.choose_pq(n) = (p, q) with q % 128 == 0 and
                  lanepack does not serve n (the JAX package's aligned
                  sizes): one block per transform where it fits shared
                  memory in place, the multiples of 128 from 14464 to 28800,
                  else one thread-block cluster of 2-16 blocks
                  (fused.choose_cluster), the 1009 aligned sizes from 28928
                  to 261632 that radix does not take;
      'large_pad' c64, the 'large' split exists and large's column or row
                  tile is narrower than shared memory allows only because it
                  must divide Q or P (largepad.narrowed_by_division): the
                  odd composites 15625, 19683, 59049, 78125, 177147, 531441
                  (one-column tiles on large) and splits such as 129 x 113
                  (14577);
      'large'     c64, n = P * q1 * q2 with P <= 512, q1, q2 <= 256 and both
                  passes' tiles in shared memory (config.large_gauss and
                  large_blocks2d pick its stages' form; no other route
                  reads them);
      'large2f'   c64, n = P1 * P2 * Q (large2f.choose_split2f) with the
                  fused column stage's (P1*P2, 16384/(P1*P2)) tile in shared
                  memory: 2^23 .. 2^25, and 2^22, which it takes from
                  'large' (_large2f_first);
      'large3f'   c64, n = P1 * P2 * Q (large3.choose_split3f), P2 <= 64:
                  2^26;
      'dense'     c64, 4 <= n <= config.dense_dft_max (the planner's Dft-leaf
                  bound) and no route above serves n: the primes 5..251.
                  256 stays on lanepack and 1009 and 1234 on the convolution
                  cores: dense_fft measured slower there on the H100
                  (chip_smoke.py, PERF.md).

    The route does not depend on the device: a CPU tensor runs the kernel's
    plain torch version, a CUDA tensor the kernel.
    """
    if config.kernels not in ("auto", "off"):
        raise ValueError(f"config.kernels must be 'auto' or 'off', got {config.kernels!r}")
    if config.kernels == "off":
        return None
    if lanepack.lanepack_supported(n, dtype):
        return "lanepack"
    if fused.radix_supported(n, dtype):
        return "radix"
    if fused.two_stage_supported(n, dtype) or fused.two_stage_cluster_supported(n, dtype):
        return "two_stage"
    if largepad.largepad_supported(n, dtype) and largepad.narrowed_by_division(n):
        return "large_pad"
    if large.large_supported(n, dtype) and not _large2f_first(n, dtype):
        return "large"
    if large2f.large2f_supported(n, dtype):
        return "large2f"
    if large3.large3f_supported(n, dtype):
        return "large3f"
    if dense.dense_supported(n, dtype) and n <= config.dense_dft_max:
        return "dense"
    return None


def _large2f_first(n: int, dtype) -> bool:
    """Where both two-pass routes serve n, large2f takes it when only its
    row stage is the compile-time Q = 4096 kernel: 2^22, whose large split
    (P = 512, Q = 8192) runs both stages on the general kernels (measured
    3.2x slower on the H100, PERF.md).  2^21 (Q = 8192 against 2048, neither
    compile-time) stays on large."""
    if not large2f.large2f_supported(n, dtype):
        return False
    fixed = large.FIXED_ROW[0]
    p, q1, q2 = large.choose_pqq(n)
    q = large2f.choose_split2f(n)[4]
    return large.stage_radices(q) == fixed and large.stage_radices(q1 * q2) != fixed


def kernels_on(dtype) -> bool:
    """The hand-written kernels serve this dtype: c64 with config.kernels
    "auto" (route checks the setting)."""
    return np.dtype(dtype) == np.complex64 and config.kernels == "auto"


def _kernel_fn(n: int, direction: FftDirection, dtype) -> Optional[Callable]:
    name = route(n, dtype)
    if name == "lanepack":
        return lanepack.make_lanepack_fn(n, direction, dtype)
    if name == "radix":
        return fused.make_fused_radix_fn(n, direction, dtype)
    if name == "two_stage":
        return fused.make_fused_two_stage_fn(n, direction, dtype)
    if name == "large_pad":
        return largepad.make_largepad_fft_fn(n, direction, dtype)
    if name == "large":
        return large.make_large_fft_fn(n, direction, dtype)
    if name == "large2f":
        return large2f.make_large2f_fft_fn(n, direction, dtype)
    if name == "large3f":
        return large3.make_large3_fft_fn(n, direction, dtype, factored=True)
    if name == "dense":
        return dense.make_dense_fft_fn(n, direction, dtype)
    return None


def build(recipe: recipes.Recipe, direction: FftDirection, dtype,
          pinned: bool = False) -> Callable:
    """Return fn: complex (..., n) -> complex (..., n), the unnormalized DFT.

    pinned=True runs the literal recipe at every node of the tree (the JAX
    package's allow_fused=False)."""
    dtype = np.dtype(dtype)
    key = (recipe, direction, dtype, pinned) + config.switch_key()
    fn = _CACHE.get(key)
    if fn is None:
        fn = None if pinned else _kernel_fn(recipe.length, direction, dtype)
        if fn is None:
            fn = _build(recipe, direction, dtype, pinned)
        _CACHE[key] = fn
        if len(_CACHE) > _CACHE_MAX:
            _CACHE.popitem(last=False)
    else:
        _CACHE.move_to_end(key)
    return fn


def _build(recipe: recipes.Recipe, direction: FftDirection, dtype,
           pinned: bool = False) -> Callable:
    if isinstance(recipe, (recipes.Dft, recipes.Butterfly)):
        return op_dft.make_dft_fn(recipe.length, direction, dtype)

    if isinstance(recipe, recipes.Radix4):
        base_fn = build(recipe.base, direction, dtype, pinned)
        return op_ct.make_ct_chain_fn(
            (4,) * recipe.k, recipe.base.length, base_fn, direction, dtype
        )

    if isinstance(recipe, recipes.RadixN):
        base_fn = build(recipe.base, direction, dtype, pinned)
        return op_ct.make_ct_chain_fn(
            recipe.factors, recipe.base.length, base_fn, direction, dtype
        )

    if isinstance(recipe, (recipes.MixedRadix, recipes.MixedRadixSmall)):
        p = recipe.left.length
        q = recipe.right.length
        right_fn = build(recipe.right, direction, dtype, pinned)
        if (
            isinstance(recipe.left, (recipes.Dft, recipes.Butterfly))
            and p <= _MATRIX_LEAF_MAX
        ):
            return op_ct.make_ct_stage_fn(p, q, right_fn, direction, dtype)
        left_fn = build(recipe.left, direction, dtype, pinned)
        return op_ct.make_ct_stage_general_fn(p, q, left_fn, right_fn, direction, dtype)

    if isinstance(recipe, (recipes.GoodThomas, recipes.GoodThomasSmall)):
        left_fn = build(recipe.left, direction, dtype, pinned)
        right_fn = build(recipe.right, direction, dtype, pinned)
        return op_gt.make_good_thomas_fn(
            recipe.left.length, recipe.right.length, left_fn, right_fn,
            use_kernel=kernels_on(dtype),
        )

    if isinstance(recipe, recipes.Raders):
        # the kernel path: the convolution core with the root-order gathers
        # as permute launches (one-pass core) or fused into it (two-pass)
        if not pinned and kernels_on(dtype) and conv.conv_any_supported(recipe.inner.length, dtype):
            return conv.make_raders_fn(recipe.length, direction, dtype)
        inner_fn = build(recipe.inner, direction, dtype, pinned)
        return op_raders.make_raders_fn(recipe.length, inner_fn, direction, dtype)

    if isinstance(recipe, recipes.Bluesteins):
        # the kernel path, in the JAX package's order (executor.py:371-390):
        # the one-pass core; the fused large Bluestein where the inner length
        # runs on 'large'; the two-pass core
        m = recipe.inner.length
        if not pinned and kernels_on(dtype):
            if not conv.conv_supported(m, dtype) and convlarge.bconv_supported(m, dtype):
                return convlarge.make_bluestein_large_fn(recipe.length, m, direction, dtype)
            if conv.conv_any_supported(m, dtype):
                return conv.make_bluestein_fn(recipe.length, m, direction, dtype)
        inner_fn = build(recipe.inner, direction, dtype, pinned)
        return op_bluestein.make_bluestein_fn(recipe.length, m, inner_fn, direction, dtype)

    raise TypeError(f"Unknown recipe node: {recipe!r}")
