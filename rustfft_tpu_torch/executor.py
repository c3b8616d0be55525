"""Recipe -> torch function compiler.

Port of rustfft_tpu/executor.py.  A recipe lowers into one nested function on
complex tensors: matmul DFT leaves and Cooley-Tukey stages (ops/dft.py,
ops/ct.py), Good-Thomas, Rader and Bluestein nodes (ops/good_thomas.py,
ops/raders.py, ops/bluestein.py), with every subtree whose length `route`
names replaced by that whole-transform kernel (ops/kernels/).  With the
kernels on, c64 Rader and Bluestein nodes run as one convolution core
(ops/kernels/conv.py), or a Bluestein whose inner length runs on `large` as
the fused large Bluestein (ops/kernels/convlarge.py), as `core_form` says
(above 2^20 it keeps some of them glued, R5), and Good-Thomas re-indexing
as permute launches.
Constant tables are precomputed on the host in f64 at build time and copied
to each device once.

A pinned build (`pinned=True`, the hand-built constructors of algorithm.py)
runs the literal recipe, where the JAX package's `allow_fused=False` acts: no
whole-transform kernel at any node and no convolution core for Rader or
Bluestein nodes; Good-Thomas keeps its permute gathers, as in the JAX package.

Built functions are memoized per (recipe, direction, dtype, pinned, config
state), the analogue of the reference's FftCache (fft_cache.rs:5-39) shared
across planners (and threads, under a lock) because recipes are pure
hashable data.  The config state is config.switch_key(): every field a
built function bakes in.
"""
from __future__ import annotations

import threading
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
from .ops.kernels import (
    conv, conv_radix, convlarge, dense, fused, lanepack, large, large2f, large3, largepad,
)

# Left factors whose DFT matrix is small enough for the middle-axis matmul
# form of a CT stage (executor.py:_MATRIX_LEAF_MAX of the JAX package).
_MATRIX_LEAF_MAX = 512

_CACHE: "OrderedDict[Tuple, Callable]" = OrderedDict()
_CACHE_MAX = 512
#: guards _CACHE: plans are built and used from several threads, and a
#: lookup, its move to the end and an eviction must not interleave
_CACHE_LOCK = threading.Lock()


def route(n: int, dtype, *, hole_band: bool = True) -> Optional[str]:
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
      'large3f'   c64, n = P1 * P2 * Q (large3.choose_split3f), P2 <= 128:
                  2^26 (P2 = 64) and 2^27 (P2 = 128);
      'dense'     c64, 4 <= n <= max(config.dense_dft_max,
                  config.dense_fallback_max_n) and no route above serves n:
                  the primes 5..251.  256 stays on lanepack, and with
                  dense_fallback_max_n off (its default) the 442 sizes of
                  [257, 2042] that no route serves stay on the convolution
                  cores: dense_fft measured 1.9-15x slower there on the
                  H100 (tools/torch_planner_rules.py, PERF.md).

    An odd composite of the hole band (hole_band_inner names its inner
    length) has no route: large_pad would serve it, and the planner's
    Bluestein runs on the two-pass core instead (hole_band=False: the route
    without the hole band, which hole_band_inner reads).

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
        if hole_band and hole_band_inner(n, dtype) is not None:
            return None
        return "large_pad"
    if large.large_supported(n, dtype) and not _large2f_first(n, dtype):
        return "large"
    if large2f.large2f_supported(n, dtype):
        return "large2f"
    if large3.large3f_supported(n, dtype):
        return "large3f"
    if dense.dense_supported(n, dtype) and n <= max(config.dense_dft_max,
                                                    config.dense_fallback_max_n):
        return "dense"
    return None


def hole_band_inner(n: int, dtype) -> Optional[int]:
    """The inner length of the hole band's Bluestein for n, or None: with
    config.bconv_misaligned and the c64 kernels on, an odd n >=
    config.bconv_misaligned_min_n that route would give large_pad takes
    the smallest m = r*16384 >= 2n - 1, r in (2, 4, 8, 16), that the
    two-pass core runs as its cluster passes, when m <=
    config.bconv_misaligned_max_pad * n; past the first such r, none.  The
    JAX planner's rule and _radix_conv_inner (rustfft_tpu/planner.py:363-404)
    with its pallas_route read as large_pad.  route leaves these sizes
    without a route and the planner gives them Bluesteins(n, m), the same
    m."""
    if not (config.bconv_misaligned and kernels_on(dtype) and n % 2 == 1
            and n >= config.bconv_misaligned_min_n):
        return None
    if route(n, dtype, hole_band=False) != "large_pad":
        return None
    for r in HOLE_BAND_RADICES:
        m = r * fused.RADIX_PQ * fused.RADIX_PQ
        if m < 2 * n - 1:
            continue
        if (m <= config.bconv_misaligned_max_pad * n and conv_radix.cluster_form(m) == r
                and conv_radix.radix_conv_supported(m, dtype)):
            return m
        return None
    return None


#: the cluster passes' r of the hole band's inner lengths (the JAX
#: _radix_conv_inner's, from conv_radix_min_m = 32768)
HOLE_BAND_RADICES = (2, 4, 8, 16)

#: the convolution cores a Raders or Bluesteins node runs on with the c64
#: kernels on (core_form), in the order tools/torch_prime_cores.py prints
CORE_FORMS = ("one-pass core", "K15 tile form", "K15 general form", "K14 cluster passes",
              "K14 four stages", "glued form")

#: R5, the core rule above 2^20: a Bluesteins node whose inner length is
#: above this and whose core would be K14's four stages runs the glued form
CORE_RULE_MIN_M = 1 << 20


def core_form(kind: str, m: int, dtype, *, core_rule: bool = True) -> str:
    """The core _build runs a Raders ("rader") or Bluesteins ("bluestein")
    node of inner length m on with the c64 kernels on (_core_fn): the
    one-pass core (K6 / K13), the fused large Bluestein in its tile form
    (convlarge.tile_form) or general form (K15), the two-pass core's
    cluster passes (conv_radix.cluster_form) or its four stages (K14), else
    the glued form: ops/bluestein.py or ops/raders.py around two calls of
    the inner FFT, which executor.build runs on route(m)'s kernel.

    Then R5, the core rule above 2^20: a Bluesteins node of m >
    CORE_RULE_MIN_M whose core would be K14's four stages (the primes of
    (1.5*2^20, 2^21] on m = 2^22) runs the glued form, its inner on
    large2f, as the JAX executor does at these lengths (executor.py:346-390:
    neither conv_any_supported nor bconv_supported with the large route
    holds there).  The card measured the glued form 2.41-2.51x faster at
    all 10 primes timed, 6 sampled and 4 held out (1572869 x 32: 7.460
    against 18.754 ms, queued device time).  The JAX executor glues the
    other nodes above 2^20 too, but the card measured the port's cores
    faster at every prime timed there, 10 a class, and they keep them: the
    Raders on n - 1 in (2^20, 2^22] on the four stages (the glued form
    1.04-1.19x slower), the Bluesteins on 3*2^20 and 3*2^21 on K15's tile
    form at convlarge.split's P = 256 x Q = 12288 and 24576 (the glued
    form 4.7-5.0x and 5.5-5.8x slower: 1048583 x 32 3.004 against 14.858
    ms, 2097169 x 16 3.791 against 21.901), which replaced K15's general
    form there (1.11-1.13x and 1.27-1.29x faster than the glued form)
    (tools/torch_planner_rules.py --rules R5, PLANNER_RULES_GPU.md; NVIDIA
    H100 80GB HBM3, 700.00 W).
    core_rule=False: the core without R5, which the tools and tests build
    to hold the form it replaced."""
    if conv.conv_supported(m, dtype):
        return CORE_FORMS[0]
    if kind == "bluestein" and convlarge.bconv_supported(m, dtype):
        p, q1, q2 = convlarge.split(m)
        return CORE_FORMS[1] if convlarge.tile_form(p, q1 * q2) else CORE_FORMS[2]
    if conv_radix.radix_conv_supported(m, dtype):
        if conv_radix.cluster_form(m) is not None:
            return CORE_FORMS[3]
        if core_rule and kind == "bluestein" and m > CORE_RULE_MIN_M:
            return CORE_FORMS[5]
        return CORE_FORMS[4]
    return CORE_FORMS[5]


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
          pinned: bool = False, core_rule: bool = True) -> Callable:
    """Return fn: complex (..., n) -> complex (..., n), the unnormalized DFT.

    pinned=True runs the literal recipe at every node of the tree (the JAX
    package's allow_fused=False); core_rule=False builds its Raders and
    Bluesteins nodes on their cores before R5 (core_form)."""
    dtype = np.dtype(dtype)
    key = (recipe, direction, dtype, pinned, core_rule) + config.switch_key()
    with _CACHE_LOCK:
        fn = _CACHE.get(key)
        if fn is not None:
            _CACHE.move_to_end(key)
            return fn
    # built outside the lock: a build recurses into build for its subtrees
    fn = None if pinned else _kernel_fn(recipe.length, direction, dtype)
    if fn is None:
        fn = _build(recipe, direction, dtype, pinned, core_rule)
    with _CACHE_LOCK:
        # a thread that built the same key meanwhile got there first: share its function
        fn = _CACHE.setdefault(key, fn)
        _CACHE.move_to_end(key)
        if len(_CACHE) > _CACHE_MAX:
            _CACHE.popitem(last=False)
    return fn


def _build(recipe: recipes.Recipe, direction: FftDirection, dtype,
           pinned: bool = False, core_rule: bool = True) -> Callable:
    if isinstance(recipe, (recipes.Dft, recipes.Butterfly)):
        return op_dft.make_dft_fn(recipe.length, direction, dtype)

    if isinstance(recipe, recipes.Radix4):
        base_fn = build(recipe.base, direction, dtype, pinned, core_rule)
        return op_ct.make_ct_chain_fn(
            (4,) * recipe.k, recipe.base.length, base_fn, direction, dtype
        )

    if isinstance(recipe, recipes.RadixN):
        base_fn = build(recipe.base, direction, dtype, pinned, core_rule)
        return op_ct.make_ct_chain_fn(
            recipe.factors, recipe.base.length, base_fn, direction, dtype
        )

    if isinstance(recipe, (recipes.MixedRadix, recipes.MixedRadixSmall)):
        p = recipe.left.length
        q = recipe.right.length
        right_fn = build(recipe.right, direction, dtype, pinned, core_rule)
        if (
            isinstance(recipe.left, (recipes.Dft, recipes.Butterfly))
            and p <= _MATRIX_LEAF_MAX
        ):
            return op_ct.make_ct_stage_fn(p, q, right_fn, direction, dtype)
        left_fn = build(recipe.left, direction, dtype, pinned, core_rule)
        return op_ct.make_ct_stage_general_fn(p, q, left_fn, right_fn, direction, dtype)

    if isinstance(recipe, (recipes.GoodThomas, recipes.GoodThomasSmall)):
        left_fn = build(recipe.left, direction, dtype, pinned, core_rule)
        right_fn = build(recipe.right, direction, dtype, pinned, core_rule)
        return op_gt.make_good_thomas_fn(
            recipe.left.length, recipe.right.length, left_fn, right_fn,
            use_kernel=kernels_on(dtype),
        )

    if isinstance(recipe, (recipes.Raders, recipes.Bluesteins)):
        return _core_fn(recipe, direction, dtype, pinned, core_rule)

    raise TypeError(f"Unknown recipe node: {recipe!r}")


def _core_fn(recipe, direction: FftDirection, dtype, pinned: bool, core_rule: bool) -> Callable:
    """A Raders or Bluesteins node on the core core_form names (the JAX
    package's order, executor.py:346-390): the one-pass core, or the
    two-pass core's cluster passes or four stages, with the root-order
    gathers as permute launches or fused into it (ops/kernels/conv.py); the
    fused large Bluestein (ops/kernels/convlarge.py); the glued form, whose
    inner is built like any recipe.  Pinned, or with the kernels off, the
    glued form."""
    rader = isinstance(recipe, recipes.Raders)
    n, m = recipe.length, recipe.inner.length
    form = CORE_FORMS[5]
    if not pinned and kernels_on(dtype):
        form = core_form("rader" if rader else "bluestein", m, dtype, core_rule=core_rule)
    if form in (CORE_FORMS[1], CORE_FORMS[2]):
        return convlarge.make_bluestein_large_fn(n, m, direction, dtype)
    if form != CORE_FORMS[5]:
        return (conv.make_raders_fn(n, direction, dtype) if rader
                else conv.make_bluestein_fn(n, m, direction, dtype))
    inner_fn = build(recipe.inner, direction, dtype, pinned, core_rule)
    if rader:
        return op_raders.make_raders_fn(n, inner_fn, direction, dtype)
    return op_bluestein.make_bluestein_fn(n, m, inner_fn, direction, dtype)
