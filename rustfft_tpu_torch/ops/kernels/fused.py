"""The one-pass mid band: the ports of K7, K8 and K9.

Replaces rustfft_tpu/ops/pallas/fused.py: the split rules (`_choose_pq`,
`fused_supported`, `choose_pqq_fused`, `three_stage_supported`,
`choose_rpq`, `radix_supported`) without their VMEM terms, the tables
(`_ctw_cfacs`, the f64 part of `_ctwg_consts`, the two- and three-stage
twiddles) and the three kernels, each in one read and one write of the
signal in device memory:

  `radix_fft` (K9: `_fused_kernel_vpur`, `_ctw`, `_ctwg`, `_ctwgn`,
      `_ctwgx`): n = r * p * q, p = q = 128, r in {2, 4, 8, 16};
      j = b*rq + a*q + j2, k = k2*rp + c*p + d:
        A[a, j2, d] = sum_b x[b, a, j2] * w_p^(b*d)            (stage A)
        C[c, j2, d] = w_n^(j2*d) * w_rq^(c*j2)
                      * sum_a A[a, j2, d] * w_rp^(a*d) * w_r^(a*c)
        X[k2, c, d] = sum_j2 C[c, j2, d] * w_q^(j2*k2)         (stage B)
      The merged twiddle w_n^((a*q+j2)*d) of the JAX kernels is factored
      as w_rp^(a*d) * w_n^(j2*d): an (r, p) and a (q, p) table, none of n
      entries.  On the card one cluster of r blocks computes a transform,
      block a holding the slice a; the DFT_r crosses the cluster through
      distributed shared memory, and a persistent grid of radix_grid
      clusters walks the batch (csrc/fused.cu).
  `two_stage_fft` (K7: `_fused_kernel`, `_fused_kernel_gauss`,
      `_fused_kernel_twodot`): n = p * q, j = j1*q + j2, k = k2*p + k1:
      DFT_p over j1, the twiddle w_n^(k1*j2), DFT_q over j2 (14464 ..
      28800, the sizes whose transform and roots fit one block's shared
      memory in place): one block per transform on the card, K7's
      factored chains, 16-byte loads and stores (16384: the radix body at
      R = 1).
  `two_stage_cluster_fft` (K7's cluster band, 28928 .. 261632): the same
      function on one thread-block cluster of c = choose_cluster(n) blocks
      per transform.  Block b runs DFT_p on the columns j2 of its share,
      pulls the rows k1 of its share from every block through distributed
      shared memory, and runs DFT_q on them; 16-byte loads and stores.
      Both K7 kernels, in their forms without a Bluestein stage
      (k7_factored), run the radices 3, 5, 6, 7, 9, 10, 12, 14, 15 and 20
      in factored register forms (FACTORED_RADICES; k7_chain_plain mirrors
      them) and read the outer twiddle transposed where the caller gives
      outer_transposed's table.
  `three_stage_fft` (K8: `_fused_kernel_3s`): n = p * q1 * q2, DFT_p, the
      outer twiddle, then DFT_q as DFT_q1, the inner twiddle w_q^(ka*jb)
      and DFT_q2.  That is the two-stage function at (p, q): the card runs
      DFT_q as a register chain of q (large.stage_radices), not (q1, q2),
      on K7's and K9's bodies (three_stage_form); the plain version keeps
      (q1, q2).  Not routed (as in the JAX package, whose
      `three_stage_min_n` is 2^40).

The JAX kernels contract dense DFT blocks on the matrix unit with bf16
weight splits (`w_split`, `gauss_*`, `contract_*`); the card runs every DFT
as register radix stages in FP32 on the CUDA cores (`large.stage_radices`),
so those helpers have no counterpart here.  Each wrapper runs its plain
torch version, stage for stage, on a CPU tensor and launches its kernel in
csrc/fused.cu on a CUDA tensor, or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...common import FftDirection
from ... import twiddles
from .. import calg
from . import _build, large
from .lanepack import (  # noqa: F401 (the in-place chain's host side, also as fused.*)
    REGISTER_RADICES, bluestein_dft_plain, bluestein_lane_order, bluestein_ms, bluestein_parts,
    bluestein_stage_m, bluestein_stage_tables, bluestein_table_len, chain_args, chain_root_lens,
    chain_stages_plain, chain_tables, check_operand, check_stage_tables, dft_from_roots,
    fft_stages_plain, lanepack_supported, padded_stage_args, require_cuda, stage_tables,
)
from .large3 import p2_chain_plain

#: largest fused transform and factor, as in the JAX package
MAX_FUSED_N = 512 * 512
MAX_FACTOR = 512

#: the radix kernel's fixed slice: p = q = 128 (csrc/fused.cu)
RADIX_PQ = 128

#: the largest radix of the one-block band's chains (part of its rule,
#: _one_block_fits) and of a direct-sum stage in the in-place chains
#: (csrc/inplace_chain.cuh kMaxDirectRadix); the cluster band's primes p
#: above it run the Bluestein stage
MAX_INPLACE_RADIX = 256

#: the cluster kernel's blocks per transform, and the most values a block
#: holds: 512 threads carry a share through the exchange in registers, 32
#: values each (csrc/fused.cu two_stage_cluster_kernel)
CLUSTER_SIZES = (2, 4, 8, 16)
CLUSTER_SHARE_MAX = 512 * 32

#: the radices K7's chains run in factored register forms
#: (csrc/factored_dft.cuh): 3, 5 and 7 as butterflies on conjugate pairs,
#: the others as one Cooley-Tukey step A x B (FACTORED_SPLITS); 10, 14, 15
#: and 20 leave the roots-table stage for registers
FACTORED_SPLITS = {6: (2, 3), 9: (3, 3), 10: (2, 5), 12: (4, 3), 14: (2, 7), 15: (3, 5),
                   20: (4, 5)}
FACTORED_RADICES = frozenset({3, 5, 7, *FACTORED_SPLITS})


# -- split rules ------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def choose_pq(n: int) -> Optional[Tuple[int, int]]:
    """Split n = p*q with p, q <= MAX_FACTOR (the JAX package's `_choose_pq`
    without its VMEM term): q a multiple of 128 first, then a multiple of
    8, then any; ties by the least p + q, then the least |p - q|."""
    best = None
    for p in range(2, MAX_FACTOR + 1):
        if n % p:
            continue
        q = n // p
        if q > MAX_FACTOR:
            continue
        rank = 0 if q % 128 == 0 else (1 if q % 8 == 0 else 2)
        key = (rank, p + q, abs(p - q))
        if best is None or key < best[0]:
            best = (key, p, q)
    return None if best is None else best[1:]


def fused_supported(n: int, dtype) -> bool:
    """c64 and a split exists (the JAX package's rule)."""
    if np.dtype(dtype) != np.complex64 or n < 4 or n > MAX_FUSED_N:
        return False
    return choose_pq(n) is not None


def _with_chain_tables(fixed: int, radices: Sequence[int]) -> int:
    """Bytes of a two-stage kernel's shared memory whose buffer and index
    tables take `fixed` (csrc/fused.cu with_chain_tables), with the roots of
    the direct stages: a Bluestein stage reads its table from device
    memory."""
    return fixed + 8 * sum(r for r in radices if not bluestein_stage_m(r))


def two_stage_smem_bytes(n: int, p_radices: Sequence[int], q_radices: Sequence[int]) -> int:
    """Shared memory of the in-place two-stage kernel: one transform
    (rounded up to 16 values), the store's two index tables (p + q ints)
    and the chains' tables (_with_chain_tables)."""
    return _with_chain_tables(-(-n // 16) * 16 * 8 + 4 * (math.prod(p_radices)
                                                          + math.prod(q_radices)),
                              tuple(p_radices) + tuple(q_radices))


def _one_block_fits(p: int, q: int) -> bool:
    """One transform of the split p x q with its roots fits one block's
    shared memory in place, and no radix is above MAX_INPLACE_RADIX."""
    pr, qr = large.stage_radices(p), large.stage_radices(q)
    return (max(pr + qr) <= MAX_INPLACE_RADIX
            and two_stage_smem_bytes(p * q, pr, qr) <= _build.SMEM_MAX)


def _aligned(n: int, dtype) -> bool:
    """c64, choose_pq(n) gives q % 128 == 0 (the JAX package's `aligned`,
    which routes n to K7), and the lanepack kernel does not serve n."""
    if not fused_supported(n, dtype) or lanepack_supported(n, dtype):
        return False
    return choose_pq(n)[1] % 128 == 0


def two_stage_supported(n: int, dtype) -> bool:
    """The one-block two-stage route: aligned (_aligned) and one transform
    with its roots fits one block's shared memory in place (14464 ..
    28800)."""
    return _aligned(n, dtype) and _one_block_fits(*choose_pq(n))


def cluster_share(p: int, q: int, c: int) -> int:
    """Values a cluster kernel's block holds: its column share (p rows of
    q/c columns) or its widest row share (ceil(p/c) rows of q), whichever is
    more (csrc/fused.cu cluster_share)."""
    return max(p * (q // c), -(-p // c) * q)


def cluster_smem_bytes(p: int, q: int, c: int) -> int:
    """Shared memory of a cluster kernel's block: its share (rounded up to
    16 values), the index tables (p + 2q ints) and the chains' tables
    (_with_chain_tables); at most 137672 bytes over K7's band (at 506 x
    512), 148480 over K8's cluster form (at 128 x 2048)."""
    return _with_chain_tables(-(-cluster_share(p, q, c) // 16) * 16 * 8 + 4 * (p + 2 * q),
                              large.stage_radices(p) + large.stage_radices(q))


@functools.lru_cache(maxsize=4096)
def choose_cluster(n: int, split: Optional[Tuple[int, int]] = None) -> Optional[int]:
    """Blocks per transform of the cluster kernel at split = (p, q)
    (default choose_pq(n)): the fewest of CLUSTER_SIZES that divides q and
    whose shares hold at most CLUSTER_SHARE_MAX values, or None.

    The fewest blocks that fit give the widest load segments (q/c columns
    of a row, 8q/c bytes) and the fewest blocks waiting on each cluster
    barrier; more blocks only shorten each thread's exchange (the share it
    holds in registers).  On the card the fewest were the fastest at every
    size timed: 49152 x 2048 ran 3.407 ms on 4 blocks, 3.929 on 8 and 6.859
    on 16 (tools/torch_cluster_sizes.py; NVIDIA H100 80GB HBM3, 700 W).  The
    cap is the exchange's: a share goes through 512 threads' registers, 32
    values each, since a second buffer does not fit beside one of up to 128
    KiB.  So 28928 (226 x 128) takes 2 blocks, 49152 (192 x 256) 4, 98304
    (256 x 384) 8 and 196608 (384 x 512) 16.
    """
    sp = split or choose_pq(n)
    if sp is None:
        return None
    p, q = sp
    return next((c for c in CLUSTER_SIZES
                 if q % c == 0 and cluster_share(p, q, c) <= CLUSTER_SHARE_MAX), None)


def two_stage_cluster_supported(n: int, dtype) -> bool:
    """The cluster two-stage route: aligned (_aligned), one block does not
    hold a transform (two_stage_supported), and a cluster of at most 16
    blocks does (choose_cluster): the aligned sizes from 28928 to 261632."""
    return (_aligned(n, dtype) and not _one_block_fits(*choose_pq(n))
            and choose_cluster(n) is not None)


def row_shares(p: int, c: int):
    """The rows k1 of DFT_q each block of a cluster of c takes: (lo, hi)
    with lo = b*p // c, shares differing by at most one row."""
    return [(b * p // c, (b + 1) * p // c) for b in range(c)]


#: the JAX package's VMEM budget of K8's split rule (90% of its default
#: config.pallas_vmem_limit, 64 MiB): it bounds K8's domain to the 50 sizes
#: 16384 k, k = 1 .. 50, all at p = 128
THREE_STAGE_BUDGET = int(64 * 2**20 * 0.9)


@functools.lru_cache(maxsize=1024)
def choose_pqq_fused(n: int) -> Optional[Tuple[int, int, int]]:
    """Split n = p * (q1*q2) with p and q1*q2 multiples of 128, q1, q2 <= 256
    (the most balanced pair), minimizing p + q1 + q2, then |p - q|: the JAX
    package's rule with its VMEM term at THREE_STAGE_BUDGET, so that K8 has
    the JAX package's domain."""
    best = None
    for p in range(128, MAX_FACTOR + 1, 128):
        if n % p:
            continue
        q = n // p
        if q % 128 or q < 128:
            continue
        inner = None
        for q1 in range(2, 257):
            if q % q1:
                continue
            q2 = q // q1
            if q2 > 256:
                continue
            key = (q1 + q2, abs(q1 - q2))
            if inner is None or key < inner[0]:
                inner = (key, q1, q2)
        if inner is None:
            continue
        _, q1, q2 = inner
        consts = 4 * (4 * p * p + 4 * q1 * q1 + 4 * q2 * q2 + 2 * q * p + 2 * q1 * q2)
        if consts + 16 * 4 * n > THREE_STAGE_BUDGET:
            continue
        key = (p + q1 + q2, abs(p - q))
        if best is None or key < best[0]:
            best = (key, p, q1, q2)
    return None if best is None else best[1:]


def three_stage_supported(n: int, dtype) -> bool:
    """c64 and a split exists (the JAX rule); three_stage_form then names
    the card's form."""
    return np.dtype(dtype) == np.complex64 and choose_pqq_fused(n) is not None


def three_stage_form(n: int, split: Optional[Tuple[int, int, int]] = None
                     ) -> Optional[Tuple[str, int]]:
    """The card's form of K8 at split = (p, q1, q2) (default
    choose_pqq_fused(n)), by q = q1*q2:

      ("radix", 1)      p = q = 128 (16384): K9's persistent body at R = 1,
                        as K7's 16384 runs it;
      ("cluster", c)    a cluster of c = choose_cluster(n, (p, q)) blocks
                        holds a transform: K7's cluster kernel (32768 ..
                        262144; c = 2, 4, 8, 16);
      ("two_pass", 0)   else, where K2's and K3's tiles hold (p, q): their
                        column and row stages (278528 .. 819200).

    None without a split or a form.  Each form runs DFT_q as the register
    chain large.stage_radices(q) (at most three radices, 2048 = 16 x 16 x
    8): q1 and q2 reach 100 and include composites no register stage holds,
    and any split of q gives the same DFT."""
    sp = split or choose_pqq_fused(n)
    if sp is None:
        return None
    p, q = sp[0], sp[1] * sp[2]
    if p == q == RADIX_PQ:
        return "radix", 1
    c = choose_cluster(p * q, (p, q))
    if c is not None and p >= c:
        return "cluster", c
    if large.col_tile(p, q) is not None and large.row_tile(q, p) is not None:
        return "two_pass", 0
    return None


def choose_rpq(n: int) -> Optional[Tuple[int, int, int]]:
    """Split n = r * 128 * 128 with r a power of two in [2, 16] (the JAX
    package's rule without its VMEM term; the card's cluster holds r
    blocks of one 128 x 128 slice each, and 16 is the largest cluster)."""
    if n % (RADIX_PQ * RADIX_PQ):
        return None
    r = n // (RADIX_PQ * RADIX_PQ)
    if r < 2 or r > 16 or r & (r - 1):
        return None
    return r, RADIX_PQ, RADIX_PQ


def radix_supported(n: int, dtype) -> bool:
    return np.dtype(dtype) == np.complex64 and choose_rpq(n) is not None


# -- host tables -------------------------------------------------------------

def ctw_cfacs(r: int, q: int, direction: FftDirection) -> np.ndarray:
    """(r, q) c-twiddle rows w_rq^(c*j2), f64 (the JAX `_ctw_cfacs`)."""
    rq = r * q
    j2 = np.arange(q, dtype=np.int64)
    rows = []
    for c in range(r):
        cfac = np.exp(-2j * np.pi * ((c * j2) % rq).astype(np.float64) / rq)
        rows.append(np.conj(cfac) if direction is FftDirection.INVERSE else cfac)
    return np.stack(rows)


def radix_twiddles(r: int, p: int, q: int, direction: FftDirection):
    """The radix kernel's twiddles in f64: t1 (r, p) = w_rp^(a*d), tn (q, p)
    = w_n^(j2*d) (the a = 0 rows of the JAX merged table
    twiddle_table(r*q, p)) and the c-twiddle cfac (r, q) = w_rq^(c*j2).
    t1[a, d] * tn[j2, d] is the merged entry w_n^((a*q+j2)*d)."""
    t1 = twiddles.twiddle_table(r, p, direction)
    tn = twiddles.twiddle_table(r * q, p, direction)[:q]
    return t1, tn, ctw_cfacs(r, q, direction)


def radix_tables(r: int, p: int, q: int, direction: FftDirection):
    """Host tables of radix_fft, complex64: the DFT_p chain's roots and
    twiddles (stage A; stage B uses the same chain, p == q), t1, tn, the
    roots w_r^e of the DFT_r and cfac."""
    if p != q:
        raise ValueError(f"radix split needs p == q, got p={p}, q={q}")
    roots, tws = stage_tables(p, large.stage_radices(p), direction)
    t1, tn, cfac = radix_twiddles(r, p, q, direction)
    rroots = stage_tables(r, (r,), direction)[0][0]
    c64 = [t.astype(np.complex64) for t in (t1, tn)]
    return roots, tws, c64[0], c64[1], rroots, cfac.astype(np.complex64)


def three_stage_tables(p: int, q1: int, q2: int, direction: FftDirection):
    """Host tables of three_stage_fft, complex64: two_stage_tables(p, (q1,
    q2)) (DFT_p's chain, the outer twiddle, the chain (q1, q2) with the
    inner twiddle, which the plain version runs) and the card's chain of
    DFT_q, stage_tables(q, large.stage_radices(q)) (three_stage_form)."""
    q = q1 * q2
    return two_stage_tables(p, (q1, q2), direction) + large.row_tables(q, direction)


def two_stage_tables(p: int, q_radices: Sequence[int], direction: FftDirection):
    """Host tables of the two-stage kernel, complex64: DFT_p's chain
    (chain_tables: a Bluestein stage's table in place of its roots), the
    outer twiddle (q, p) [j2, k1] = w_n^(k1*j2), DFT_q's chain over
    q_radices (K8's (q1, q2) carries the inner twiddle w_q^(ka*jb))."""
    q = math.prod(q_radices)
    _, _, outer = large.col_tables(p, q, direction)
    roots_p, tws_p = chain_tables(p, large.stage_radices(p), direction)
    roots_q, tws_q = chain_tables(q, q_radices, direction)
    return roots_p, tws_p, outer, roots_q, tws_q


# -- radix_fft (K9) ----------------------------------------------------------

def radix_fft_plain(x: torch.Tensor, r: int, p: int, tables) -> torch.Tensor:
    """Plain torch version of radix_fft, stage for stage.  With a seventh
    table, the Gauss tables of the DFT_p chain (large.gauss_tables; the
    Gauss form of the two-pass core's cluster passes,
    conv_radix.cluster_tables(..., gauss=True)), both DFT_p chains run in
    the Gauss form (large.gauss_stages_plain); the twiddles and the DFT_r
    stay as they are."""
    roots, tws, t1, tn, rroots, cfac, *gauss = tables
    q = p
    radices = large.stage_radices(p)

    def chain(u):
        if gauss:
            return large.gauss_stages_plain(u, radices, gauss[0], tws)
        return fft_stages_plain(u, radices, roots, tws)

    v = x.reshape(-1, p, r, q).permute(0, 2, 3, 1)  # (B, r, q, p) [a, j2, b]
    a = chain(v) * t1[:, None, :]  # [a, j2, d]
    cs = p2_chain_plain(list(a.unbind(1)), rroots)  # DFT_r: r of (B, q, p) [j2, d]
    c = torch.stack([cc * tn * cfac[i][:, None] for i, cc in enumerate(cs)], dim=1)
    e = chain(c.transpose(2, 3))  # (B, r, p, q) [c, d, k2]
    return e.permute(0, 3, 1, 2).reshape(-1, r * p * q)  # [k2, c, d]


def _check_radix(x, r, p, tables, what):
    roots, tws, t1, tn, rroots, cfac = tables
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (batch, n), got {tuple(x.shape)}")
    if r < 2 or r & (r - 1):
        raise ValueError(f"{what}: r={r} is not a power of 2 >= 2")
    check_operand(x, (x.shape[0], r * p * p), f"{what} input")
    check_stage_tables(p, large.stage_radices(p), roots, tws, x.device, what)
    for t, shape, name in ((t1, (r, p), "t1"), (tn, (p, p), "tn"), (rroots, (r,), "roots_r"),
                           (cfac, (r, p), "cfac")):
        check_operand(t, shape, f"{what} {name}")
        if t.device != x.device:
            raise ValueError(f"{what}: tables on {t.device}, input on {x.device}")


def radix_fft(x: torch.Tensor, r: int, p: int, tables) -> torch.Tensor:
    """DFT of every row of x (batch, r*p*p) complex64 by the radix-r split.

    tables = radix_tables(r, p, p) on x's device.  CPU tensors run the
    plain version; CUDA tensors launch csrc/fused.cu's kernel (p = 128
    only) on a persistent grid of radix_grid clusters of r blocks, cluster
    g walking the rows g, g + clusters, ...
    """
    _check_radix(x, r, p, tables, "radix_fft")
    if x.device.type == "cpu":
        return radix_fft_plain(x, r, p, tables)
    require_cuda(x, "radix_fft")
    if x.shape[0] == 0:
        return torch.empty_like(x)
    y = _launch_radix(x, r, p, tables, "radix_fft")
    radix_fft.launches += 1
    return y


#: kernel launches since the count was last set to 0
radix_fft.launches = 0


def _launch_radix(x, r, p, tables, what, stamps=None):
    """One launch of csrc/fused.cu's radix kernel on a non-empty batch on the
    card; y.  With `stamps`, a (blocks, RADIX_PHASES + 1) int64 tensor, its
    stamped form from the library built for it
    (_build.load(phase_stamps=True))."""
    if p != RADIX_PQ or r > 16:
        raise ValueError(f"{what}: the kernel takes p = q = {RADIX_PQ}, r <= 16; "
                         f"got r={r}, p={p}")
    y = torch.empty_like(x)
    x = _aligned16(x)
    roots, tws, t1, tn, rroots, cfac = tables
    lib = _build.load(phase_stamps=stamps is not None)
    clusters = radix_grid(x.shape[0], _resident_clusters(x.device, r))
    args = (x.data_ptr(), y.data_ptr(), x.shape[0], clusters, r,
            *padded_stage_args(large.stage_radices(p), roots, tws),
            t1.data_ptr(), tn.data_ptr(), rroots.data_ptr(), cfac.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if stamps is None:
            code = lib.rf_radix_fft(*args, stream)
        else:
            code = lib.rf_radix_phase_stamps(*args, stamps.data_ptr(), stream)
    _build.check(lib, code, what)
    return y


#: the radix kernel's phases: stage A's load and radix 16 (the first with the
#: tables' load and the cluster's start stagger), stage A's radix 8, the
#: wait at the cluster barrier before the exchange, the exchange, the wait
#: at the barrier after it, stage B's radix 16, stage B's radix 8 with the
#: store and the next transform's copies started
RADIX_PHASES = ("load+A16", "A8", "barrier1", "exchange", "barrier2", "B16", "B8+store")


def radix_phase_stamps(x: torch.Tensor, r: int, p: int, tables):
    """radix_fft on the card through the kernel's stamped form, which only
    the library built with RF_PHASE_STAMPS holds (no route launches it; the
    first call builds that library): (y, stamps), stamps (blocks,
    len(RADIX_PHASES) + 1) int64 nanoseconds of %globaltimer, each block's
    start and that start plus the running sums of its RADIX_PHASES, each
    read by the block's thread 0 after a block barrier."""
    what = "radix_phase_stamps"
    _check_radix(x, r, p, tables, what)
    require_cuda(x, what)
    if x.shape[0] == 0:
        raise ValueError(f"{what}: an empty batch has no phases")
    blocks = radix_grid(x.shape[0], _resident_clusters(x.device, r)) * r
    stamps = torch.zeros((blocks, len(RADIX_PHASES) + 1), dtype=torch.int64, device=x.device)
    y = _launch_radix(x, r, p, tables, what, stamps)
    radix_phase_stamps.launches += 1
    return y, stamps[stamps[:, 0] != 0]


radix_phase_stamps.launches = 0


def radix_max_active_clusters(r: int) -> int:
    """cudaOccupancyMaxActiveClusters of radix_fft's cluster of r blocks on
    the current device (at r = 1, K7's 16384 on the same body, the blocks
    the card holds at once)."""
    lib = _build.load()
    out = ctypes.c_int(0)
    _build.check(lib, lib.rf_radix_max_active_clusters(r, ctypes.byref(out)),
                 "radix_max_active_clusters")
    return out.value


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, r: int) -> int:
    with torch.cuda.device(device_index):
        return radix_max_active_clusters(r)


def _resident_clusters(device: torch.device, r: int) -> int:
    return _resident(device.index if device.index is not None else torch.cuda.current_device(), r)


def radix_grid(batch: int, resident: int) -> int:
    """Clusters of the radix kernel's persistent grid for `batch`
    transforms when the card holds `resident` clusters at once: every
    resident cluster, at most one a transform.  Cluster g runs the
    transforms g, g + clusters, ... below batch: a walk of the cluster's
    index, so every block of a cluster passes the same cluster barriers."""
    if batch < 1 or resident < 1:
        raise ValueError(f"radix_grid: batch={batch}, resident={resident}")
    return min(batch, resident)


def _aligned16(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it where its data is not 16-byte aligned (a view at
    an odd offset): the radix kernel reads its rows by bulk copies."""
    return x.clone() if x.data_ptr() % 16 else x


# -- two_stage_fft (K7) and three_stage_fft (K8) -----------------------------

def _factored_dft_plain(u: torch.Tensor, r: int, roots: torch.Tensor) -> torch.Tensor:
    """DFT_r over dim 2 of u (B, lead, r, rest) as K7's factored column
    (csrc/factored_dft.cuh dft_factored): j = B*j1 + j2, DFT_A over j1, the
    twiddle w_r^(j2*k1), DFT_B over j2, output k = k1 + A*k2; each small
    DFT and twiddle from the stage's roots w_r^e.  (B, r, lead, rest) [k,
    l, t], as chain_stages_plain's contraction gives it."""
    a_, b_ = FACTORED_SPLITS[r]
    v = u.reshape(u.shape[0], u.shape[1], a_, b_, u.shape[3])  # [j1, j2]
    ka = torch.arange(a_, device=u.device)
    kb = torch.arange(b_, device=u.device)
    wa = roots[(ka[:, None] * ka[None, :]) % a_ * (r // a_)]  # DFT_A [j1, k1]
    wb = roots[(kb[:, None] * kb[None, :]) % b_ * (r // b_)]  # DFT_B [j2, k2]
    y = torch.einsum("jk,bljmr->blkmr", wa, v)  # [k1, j2]
    y = y * roots[ka[:, None] * kb[None, :]].reshape(1, 1, a_, b_, 1)
    z = torch.einsum("mn,blkmr->blnkr", wb, y)  # [k2, k1]: k = k1 + A*k2
    return z.reshape(u.shape).permute(0, 2, 1, 3)


def k7_chain_plain(x: torch.Tensor, radices: Sequence[int], roots, tws) -> torch.Tensor:
    """chain_stages_plain in K7's factored forms (the kernels' forms without
    a Bluestein stage, k7_factored): a radix of FACTORED_SPLITS runs its
    Cooley-Tukey step (_factored_dft_plain), every other stage as
    chain_stages_plain runs it (3, 5 and 7 as the DFT, which their
    butterflies compute to rounding)."""
    if not FACTORED_SPLITS.keys() & set(radices):
        return chain_stages_plain(x, radices, roots, tws)
    shape = x.shape
    m = shape[-1]
    v = x.reshape(-1, 1, m)
    lead, rest = 1, m
    for s, r in enumerate(radices):
        rest //= r
        u = v.reshape(-1, lead, r, rest)
        if r in FACTORED_SPLITS:
            a = _factored_dft_plain(u, r, roots[s])
        else:
            a = chain_stages_plain(u.transpose(2, 3), (r,), [roots[s]], []).permute(0, 3, 1, 2)
        if s + 1 < len(radices):
            a = a * tws[s].reshape(1, r, 1, rest)
        lead *= r
        v = a.reshape(-1, lead, rest)
    return v.reshape(shape)


def k7_factored(p_radices: Sequence[int], q_radices: Sequence[int]) -> bool:
    """Whether K7's kernels run these chains in their form without a
    Bluestein stage, the one with K7's factored radices and the transposed
    outer twiddle (csrc/fused.cu); the Bluestein forms keep the in-place
    chain's own radices."""
    return not any(bluestein_stage_m(r) for r in (*p_radices, *q_radices))


def _two_stage_plain(x, p, p_radices, q_radices, tables):
    roots_p, tws_p, outer, roots_q, tws_q = tables
    q = math.prod(q_radices)
    chain = k7_chain_plain if k7_factored(p_radices, q_radices) else chain_stages_plain
    a = chain(x.reshape(-1, p, q).transpose(1, 2), p_radices, roots_p, tws_p)
    d = chain((a * outer).transpose(1, 2), q_radices, roots_q, tws_q)  # [k1, k2]
    return d.transpose(1, 2).reshape(-1, p * q)


def _check_two_stage(x, p, p_radices, q_radices, tables, what):
    roots_p, tws_p, outer, roots_q, tws_q = tables
    q = math.prod(q_radices)
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (batch, n), got {tuple(x.shape)}")
    check_operand(x, (x.shape[0], p * q), f"{what} input")
    check_stage_tables(p, p_radices, roots_p, tws_p, x.device, what,
                       root_lens=chain_root_lens(p_radices))
    check_stage_tables(q, q_radices, roots_q, tws_q, x.device, what,
                       root_lens=chain_root_lens(q_radices))
    check_operand(outer, (q, p), f"{what} outer twiddle")
    if outer.device != x.device:
        raise ValueError(f"{what}: tables on {outer.device}, input on {x.device}")


def outer_transposed(p: int, outer: np.ndarray) -> Optional[np.ndarray]:
    """The (p, q) copy of two_stage_tables' outer twiddle (q, p) that K7's
    kernels read in its place in their form without a Bluestein stage
    (k7_factored), whose last stage of DFT_p runs neighbouring columns j2
    on neighbouring threads, which so read neighbouring entries of it
    (csrc/inplace_chain.cuh OuterFoldS); None where DFT_p's chain has a
    Bluestein stage (the Bluestein form reads the (q, p) table; K7's DFT_q
    chains never have one).  make_fused_two_stage_fn makes it once with the
    plan's tables and passes it to the wrappers as outer_pq."""
    if not k7_factored(large.stage_radices(p), ()):
        return None
    return np.ascontiguousarray(outer.T)


def _outer_arg(p, q, outer, outer_pq, x, what):
    """(table, transposed) that a K7 launch reads: outer_pq where it is
    given and the kernel's form takes it (k7_factored), else the (q, p)
    table."""
    if outer_pq is None or not k7_factored(large.stage_radices(p), large.stage_radices(q)):
        return outer, 0
    if tuple(outer_pq.shape) != (p, q) or outer_pq.device != x.device:
        raise ValueError(f"{what}: outer_pq {tuple(outer_pq.shape)} on {outer_pq.device}; "
                         f"expected ({p}, {q}) on {x.device}")
    return outer_pq, 1


def _launch_two_stage(x, p, q, tables, what, outer_pq=None, stamps=None):
    """One launch of csrc/fused.cu's rf_two_stage_fft on a non-empty batch
    at chains large.stage_radices(p) and (q); y.  p = q = 128 runs the radix
    body at R = 1 on a persistent grid (radix_grid), every other split the
    one-block kernel (K7's factored chains, 16-byte loads and stores; the
    outer twiddle from outer_pq where given, _outer_arg), which raises
    where a transform does not fit one block's shared memory in place.
    With `stamps`, a (batch, ONE_BLOCK_PHASE_STAMPS) int64 tensor, its
    stamped form from the library built for it (not at 16384)."""
    p_radices, q_radices = large.stage_radices(p), large.stage_radices(q)
    roots_p, tws_p, outer, roots_q, tws_q = tables
    if (two_stage_smem_bytes(p * q, p_radices, q_radices) > _build.SMEM_MAX
            or max(p_radices + q_radices) > MAX_INPLACE_RADIX):
        raise ValueError(f"{what}: n={p * q} ({p_radices} x {q_radices}) "
                         "does not fit one block in place")
    y = torch.empty_like(x)
    x = _aligned16(x)
    clusters, transposed = 0, 0
    if p_radices == q_radices == (16, 8):  # 16384: the radix body at R = 1
        clusters = radix_grid(x.shape[0], _resident_clusters(x.device, 1))
    else:
        outer, transposed = _outer_arg(p, q, outer, outer_pq, x, what)
    lib = _build.load(phase_stamps=stamps is not None)
    args = (x.data_ptr(), y.data_ptr(), x.shape[0], p, q, *chain_args(p_radices, roots_p, tws_p),
            *chain_args(q_radices, roots_q, tws_q), outer.data_ptr(), transposed)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if stamps is None:
            code = lib.rf_two_stage_fft(*args, clusters, stream)
        else:
            code = lib.rf_two_stage_phase_stamps(*args, stamps.data_ptr(), stream)
    _build.check(lib, code, what)
    return y


def two_stage_fft_plain(x: torch.Tensor, p: int, q: int, tables) -> torch.Tensor:
    """Plain torch version of two_stage_fft (K7's chains, k7_chain_plain)."""
    return _two_stage_plain(x, p, large.stage_radices(p), large.stage_radices(q), tables)


def two_stage_fft(x: torch.Tensor, p: int, q: int, tables, outer_pq=None) -> torch.Tensor:
    """DFT of every row of x (batch, p*q) complex64: DFT_p, the outer
    twiddle, DFT_q, natural order; each chain at large.stage_radices.

    tables = two_stage_tables(p, large.stage_radices(q)) on x's device;
    outer_pq, optional, outer_transposed(p, tables[2]) on x's device, which
    the kernel then reads in place of tables[2] (the same values).  A CPU
    tensor runs the plain version; a CUDA tensor the one-block kernel (the
    radix body at R = 1 at 16384), or raises.
    """
    what = "two_stage_fft"
    _check_two_stage(x, p, large.stage_radices(p), large.stage_radices(q), tables, what)
    if x.device.type == "cpu":
        return two_stage_fft_plain(x, p, q, tables)
    require_cuda(x, what)
    if x.shape[0] == 0:
        return torch.empty_like(x)
    y = _launch_two_stage(x, p, q, tables, what, outer_pq)
    two_stage_fft.launches += 1
    return y


two_stage_fft.launches = 0

#: the one-block kernel's phase stamps a block: its start, and the ends of
#: the load, DFT_p, DFT_q and the store
ONE_BLOCK_PHASES = ("load", "DFT_p", "DFT_q", "store")
ONE_BLOCK_PHASE_STAMPS = len(ONE_BLOCK_PHASES) + 1


def two_stage_phase_stamps(x: torch.Tensor, p: int, q: int, tables, outer_pq=None):
    """two_stage_fft on the card through the one-block kernel's stamped
    form (not at 16384, whose body radix_phase_stamps stamps), which only
    the library built with RF_PHASE_STAMPS holds (no route launches it):
    (y, stamps), stamps (batch, ONE_BLOCK_PHASE_STAMPS) int64 nanoseconds
    of %globaltimer, read by each block's thread 0 after a block barrier at
    the start and at the end of each of ONE_BLOCK_PHASES."""
    what = "two_stage_phase_stamps"
    _check_two_stage(x, p, large.stage_radices(p), large.stage_radices(q), tables, what)
    require_cuda(x, what)
    if x.shape[0] == 0 or p == q == RADIX_PQ:
        raise ValueError(f"{what}: no one-block kernel's phases at batch {x.shape[0]}, "
                         f"{p} x {q}")
    stamps = torch.zeros((x.shape[0], ONE_BLOCK_PHASE_STAMPS), dtype=torch.int64,
                         device=x.device)
    y = _launch_two_stage(x, p, q, tables, what, outer_pq, stamps)
    two_stage_phase_stamps.launches += 1
    return y, stamps


two_stage_phase_stamps.launches = 0


def two_stage_cluster_fft_plain(x: torch.Tensor, p: int, q: int, c: int, tables) -> torch.Tensor:
    """Plain torch version of two_stage_cluster_fft, share by share as the
    cluster computes it: block b's columns j2 in [b*q/c, (b+1)*q/c) through
    DFT_p and the outer twiddle; the exchange (block b takes the rows
    row_shares(p, c)[b] of every block's columns); DFT_q on those rows; the
    store at k2*p + k1.  Each chain as K7 runs it (k7_chain_plain where
    k7_factored)."""
    roots_p, tws_p, outer, roots_q, tws_q = tables
    qs = q // c
    v = x.reshape(-1, p, q)
    p_radices, q_radices = large.stage_radices(p), large.stage_radices(q)
    chain = k7_chain_plain if k7_factored(p_radices, q_radices) else chain_stages_plain
    cols = [chain(v[:, :, b * qs:(b + 1) * qs].transpose(1, 2), p_radices, roots_p, tws_p)
            * outer[b * qs:(b + 1) * qs] for b in range(c)]  # c of (B, q/c, p) [j2, k1]
    rows = [chain(torch.cat([a[:, :, lo:hi] for a in cols], dim=1).transpose(1, 2), q_radices,
                  roots_q, tws_q)
            for lo, hi in row_shares(p, c)]  # c of (B, hi - lo, q) [k1, k2]
    return torch.cat(rows, dim=1).transpose(1, 2).reshape(-1, p * q)


def _check_cluster(x, p, q, c, tables, what):
    _check_two_stage(x, p, large.stage_radices(p), large.stage_radices(q), tables, what)
    if c < 1 or q % c:
        raise ValueError(f"{what}: a cluster of {c} blocks does not split q={q}")


def _launch_cluster(x, p, q, c, tables, what, outer_pq=None, stamps=None):
    """One launch of csrc/fused.cu's cluster kernel (the outer twiddle from
    outer_pq where given, _outer_arg); y.  With `stamps`, a (batch*c,
    PHASE_STAMPS) int64 tensor, its stamped form from the library built for
    it (_build.load(phase_stamps=True))."""
    require_cuda(x, what)
    if (c not in CLUSTER_SIZES or cluster_share(p, q, c) > CLUSTER_SHARE_MAX
            or (q // c) % 2):
        raise ValueError(f"{what}: the kernel takes c in {CLUSTER_SIZES} with shares of at most "
                         f"{CLUSTER_SHARE_MAX} values and q/c even; got p={p}, q={q}, c={c}")
    y = torch.empty_like(x)
    if x.shape[0] == 0:
        return y
    x = _aligned16(x)
    roots_p, tws_p, outer, roots_q, tws_q = tables
    outer, transposed = _outer_arg(p, q, outer, outer_pq, x, what)
    lib = _build.load(phase_stamps=stamps is not None)
    args = (x.data_ptr(), y.data_ptr(), x.shape[0], p, q, c,
            *chain_args(large.stage_radices(p), roots_p, tws_p),
            *chain_args(large.stage_radices(q), roots_q, tws_q), outer.data_ptr(), transposed)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if stamps is None:
            code = lib.rf_two_stage_cluster_fft(*args, stream)
        else:
            code = lib.rf_two_stage_cluster_phase_stamps(*args, stamps.data_ptr(), stream)
    _build.check(lib, code, what)
    return y


def two_stage_cluster_fft(x: torch.Tensor, p: int, q: int, c: int, tables,
                          outer_pq=None) -> torch.Tensor:
    """DFT of every row of x (batch, p*q) complex64 as two_stage_fft
    computes it, by one thread-block cluster of c blocks per row on the
    card (csrc/fused.cu two_stage_cluster_kernel): c in CLUSTER_SIZES
    dividing q into an even width, every share at most CLUSTER_SHARE_MAX
    values, radices up to 512 (above MAX_INPLACE_RADIX a Bluestein stage).

    tables = two_stage_tables(p, large.stage_radices(q)) on x's device;
    outer_pq as two_stage_fft's.  CPU tensors run the plain version (any c
    dividing q); CUDA tensors launch the kernel or raise.
    """
    what = "two_stage_cluster_fft"
    _check_cluster(x, p, q, c, tables, what)
    if x.device.type == "cpu":
        return two_stage_cluster_fft_plain(x, p, q, c, tables)
    y = _launch_cluster(x, p, q, c, tables, what, outer_pq)
    two_stage_cluster_fft.launches += 1
    return y


two_stage_cluster_fft.launches = 0

#: the cluster kernel's phase stamps a block: its start, and the ends of the
#: load, DFT_p, the exchange, DFT_q and the store
PHASES = ("load", "DFT_p", "exchange", "DFT_q", "store")
PHASE_STAMPS = len(PHASES) + 1


def two_stage_cluster_phase_stamps(x: torch.Tensor, p: int, q: int, c: int, tables,
                                   outer_pq=None):
    """two_stage_cluster_fft on the card through the kernel's stamped form,
    which only the library built with RF_PHASE_STAMPS holds (no route
    launches it; the first call builds that library): (y, stamps), stamps
    (batch*c, PHASE_STAMPS) int64 nanoseconds of %globaltimer, read by each
    block's thread 0 after a block barrier at the start and at the end of
    each of PHASES."""
    what = "two_stage_cluster_phase_stamps"
    _check_cluster(x, p, q, c, tables, what)
    stamps = torch.zeros((x.shape[0] * c, PHASE_STAMPS), dtype=torch.int64, device=x.device)
    y = _launch_cluster(x, p, q, c, tables, what, outer_pq, stamps)
    two_stage_cluster_phase_stamps.launches += 1
    return y, stamps


two_stage_cluster_phase_stamps.launches = 0


def two_stage_cluster_max_active_clusters(c: int) -> int:
    """cudaOccupancyMaxActiveClusters of two_stage_cluster_fft's cluster of
    c blocks on the current device, at the most shared memory a block
    takes."""
    lib = _build.load()
    out = ctypes.c_int(0)
    _build.check(lib, lib.rf_two_stage_cluster_max_active_clusters(c, ctypes.byref(out)),
                 "two_stage_cluster_max_active_clusters")
    return out.value


def two_stage_attrs(bluestein: bool, one_block: bool = False) -> Tuple[int, int]:
    """(registers a thread, local memory bytes) of the cluster kernel's
    form (or, with one_block, the one-block kernel's) with or without the
    Bluestein stage (cudaFuncGetAttributes; the local memory holds what it
    spills and the chains' stage tables indexed at run time)."""
    lib = _build.load()
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    form = 2 * int(one_block) + int(bluestein)
    _build.check(lib, lib.rf_two_stage_attrs(form, ctypes.byref(regs), ctypes.byref(local)),
                 "two_stage_attrs")
    return regs.value, local.value


def three_stage_fft_plain(x: torch.Tensor, p: int, q1: int, q2: int, tables) -> torch.Tensor:
    """Plain torch version of three_stage_fft, as the JAX body computes it:
    DFT_p, the outer twiddle, DFT_q1 over ja, the inner twiddle
    w_q^(ka*jb), DFT_q2 over jb (tables[:5])."""
    return _two_stage_plain(x, p, large.stage_radices(p), (q1, q2), tables[:5])


def three_stage_fft(x: torch.Tensor, p: int, q1: int, q2: int, tables) -> torch.Tensor:
    """DFT of every row of x (batch, p*q1*q2) complex64 by K8's split.

    tables = three_stage_tables(p, q1, q2) on x's device: the plain
    version's five and the card's chain of DFT_q (roots, tws).  A CPU
    tensor runs the plain version; a CUDA tensor the card's form at (p,
    q1*q2) (three_stage_form): K9's body at R = 1, K7's cluster kernel on
    clusters of c blocks, or K2's and K3's stages; without a form it
    raises before any launch.  One call on the card counts one launch.
    """
    what = "three_stage_fft"
    if len(tables) != 7:
        raise ValueError(f"{what}: expected three_stage_tables' seven tables, got {len(tables)}")
    q = q1 * q2
    p_radices, q_radices = large.stage_radices(p), large.stage_radices(q)
    _check_two_stage(x, p, p_radices, (q1, q2), tables[:5], what)
    roots_c, tws_c = tables[5:]
    check_stage_tables(q, q_radices, roots_c, tws_c, x.device, what)
    if x.device.type == "cpu":
        return three_stage_fft_plain(x, p, q1, q2, tables)
    require_cuda(x, what)
    form = three_stage_form(p * q, (p, q1, q2))
    if form is None:
        raise ValueError(f"{what}: no card form for p={p}, q={q}")
    if x.shape[0] == 0:
        return torch.empty_like(x)
    roots_p, tws_p, outer = tables[:3]
    card = (roots_p, tws_p, outer, roots_c, tws_c)
    kind, c = form
    if kind == "radix":
        y = _launch_two_stage(x, p, q, card, what)
    elif kind == "cluster":
        y = _launch_cluster(x, p, q, c, card, what)
    else:
        a = large.large_col_stage(x, p, q, (roots_p, tws_p, outer))
        y = large.large_row_stage(a, q, p, (roots_c, tws_c)).reshape(x.shape)
    three_stage_fft.launches += 1
    return y


three_stage_fft.launches = 0


# -- plan functions ---------------------------------------------------------

def _plan(n, tables, run):
    """fn over rows of n: run(x, t), t the copy of tables on x's device in
    tables' groups (a tuple of arrays and lists of arrays, such as
    two_stage_tables gives); fn.tables holds the arrays in order."""
    groups = [None if isinstance(t, np.ndarray) else len(t) for t in tables]
    dev_tables = calg.DeviceTables([a for t in tables
                                    for a in ((t,) if isinstance(t, np.ndarray) else t)])

    def regroup(flat):
        out, i = [], 0
        for k in groups:
            out.append(flat[i] if k is None else flat[i:i + k])
            i += 1 if k is None else k
        return tuple(out)

    def apply(x):
        t = regroup(dev_tables.on(x.device))
        return run(x.reshape(-1, n).contiguous(), t).reshape(x.shape)

    apply.tables = dev_tables
    return apply


def make_fused_two_stage_fn(n: int, direction: FftDirection, dtype,
                            split: Optional[Tuple[int, int]] = None):
    """Return fn: complex64 (..., n) -> (..., n), K7's two-stage DFT at
    split = (p, q) (default choose_pq(n) where a two-stage route serves
    n): two_stage_fft where one block holds a transform, else
    two_stage_cluster_fft on a cluster of choose_cluster(n, split) blocks,
    each given the plan's outer_transposed table where it has one.  A split
    given by the caller is taken as is."""
    if np.dtype(dtype) != np.complex64:
        raise ValueError(f"two-stage kernel is complex64 only, got {np.dtype(dtype)}")
    routed = two_stage_supported(n, dtype) or two_stage_cluster_supported(n, dtype)
    sp = split or (choose_pq(n) if routed else None)
    if sp is None:
        raise ValueError(f"no two-stage kernel for n={n}")
    p, q = sp
    if p * q != n:
        raise ValueError(f"split {sp} does not give n={n}")
    tables = two_stage_tables(p, large.stage_radices(q), direction)
    if _one_block_fits(p, q):
        def run(x, t):
            return two_stage_fft(x, p, q, t[:5], *t[5:])
    else:
        c = choose_cluster(n, (p, q))
        if c is None:
            raise ValueError(f"split {sp}: neither one block nor a cluster holds n={n}")

        def run(x, t):
            return two_stage_cluster_fft(x, p, q, c, t[:5], *t[5:])
    outer_pq = outer_transposed(p, tables[2]) if p * q != RADIX_PQ * RADIX_PQ else None
    return _plan(n, tables + ((outer_pq,) if outer_pq is not None else ()), run)


def make_fused_three_stage_fn(n: int, direction: FftDirection, dtype,
                              split: Optional[Tuple[int, int, int]] = None):
    """Return fn: complex64 (..., n) -> (..., n) through three_stage_fft at
    split = (p, q1, q2) (default choose_pqq_fused(n)), with the tables of
    three_stage_tables."""
    if np.dtype(dtype) != np.complex64:
        raise ValueError(f"three-stage kernel is complex64 only, got {np.dtype(dtype)}")
    sp = split or choose_pqq_fused(n)
    if sp is None:
        raise ValueError(f"no three-stage split for n={n}")
    p, q1, q2 = sp
    if p * q1 * q2 != n:
        raise ValueError(f"split {sp} does not give n={n}")
    return _plan(n, three_stage_tables(p, q1, q2, direction),
                 lambda x, t: three_stage_fft(x, p, q1, q2, t))


def make_fused_radix_fn(n: int, direction: FftDirection, dtype,
                        split: Optional[Tuple[int, int, int]] = None):
    """Return fn: complex64 (..., n) -> (..., n) through radix_fft at split
    = (r, p, q), p == q (default choose_rpq(n)); the card's kernel takes
    p = q = 128, a CPU tensor any p == q."""
    if np.dtype(dtype) != np.complex64:
        raise ValueError(f"radix kernel is complex64 only, got {np.dtype(dtype)}")
    sp = split or choose_rpq(n)
    if sp is None:
        raise ValueError(f"no radix split for n={n}")
    r, p, q = sp
    if r * p * q != n or p != q:
        raise ValueError(f"split {sp} does not give n={n} with p == q")
    return _plan(n, radix_tables(r, p, q, direction), lambda x, t: radix_fft(x, r, p, t))
