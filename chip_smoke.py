#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rustfft_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no result line) on failure:

1. the card's name and power limit (nvidia-smi); build every CUDA kernel
   from rustfft_tpu_torch/csrc (one nvcc per source, in parallel) and time
   the build;
2. each kernel against its plain torch version on the card, forward and
   inverse, relative mean error <= 1e-5: the whole-transform kernels
   (K1 within 1e-6: the pipelined 4096 kernel, and the chain kernel at
   packed small n, four register stages, Bluestein stages of 512 points,
   direct sums, ragged last blocks; large: K2's and K3's persistent tile
   kernels within 1e-6 at 2^20 x 1, x 3, x 4 and at a batch that leaves
   both walks ragged, each grid printed, 32768 x 3, and each stage on a
   view 8 bytes into its storage, which the wrapper copies), the one-pass convolution core: its parent form
   (conv_fft) at m = 1008 (the Rader 1009 shape) and m = 3072 (the
   Bluestein 1234 shape) with its tables and conj off and on and at m = 928
   and 3712, where it still serves, and its chain form (conv_chain_fft,
   within 1e-6) at the inner length of every CORE path (m = 256, 1008,
   2530, 3072, 6144, 8192), both directions, tables and conj off and on
   (ragged n_in and n_out), at batch 1, a batch that leaves its last unit
   and its persistent walk ragged, and the path's batch; the two-pass core's cluster passes within 1e-6 at
   65537 x 1 and x 3 (Rader: gather, sums, scatter, x0, full output) and
   7919 x 1 and x 5, 65521 x 1 and x 3 and 131071 x 1 and x 2 (Bluestein
   at r = 1, 8 and 16, each against the float64 oracle), and its four
   stages stage by stage at m = 746496 (the Rader 746497, the form the
   planner gives it), 65536 and 16384 (the forms the switches run),
   and the permutation at m = 1008 and 114688 and on both sides of its
   shared-memory cut-over (permute.SMEM_ROW_MAX = 29056 through shared
   memory, 29057 direct);
   The top power-of-two band: large2f's fused column stage (K10's cluster
   kernel, within 1e-6) at P = 1024, 2048, 4096 and 8192 at batch 1 and at
   a batch that leaves its walk of clusters ragged (the resident clusters
   of each cluster size printed) and the row stage after it at batch 1,
   large3f's pass 1
   (the modular j3 twiddle), its pass 2 with the j2 factor on and off, and
   the row stage at P = 16384.  The one-pass mid band at batch 2: radix_fft
   at r = 2, 4, 8 and 16 (a persistent grid of clusters of r blocks; the
   cudaOccupancyMaxActiveClusters of each r is printed, and each r and
   16384 run again at 3 x that + 1 transforms), two_stage_fft at
   16384 (the radix body at R = 1), 20480, 24576 and 14464 (a prime p = 113)
   and three_stage_fft at K8's split (128, 8, 16); two_stage_fft at the ONE
   paths' n (a prime p from 113 to 223 as a Bluestein stage, its table read
   from device memory).  K7's cluster band at batch 2:
   two_stage_cluster_fft at every CLUSTER path's n and at 32896 and 65792
   (a Bluestein stage on clusters of 2, 4, 8 and 16 blocks; ragged row
   shares at 32896, 65792 and 260608), 29184 and 132480 (a direct-sum
   stage, p = (19, 12) and (23, 5, 3)) and 40832 (a Bluestein stage, then
   a direct sum: p = (29, 11)), with the cudaOccupancyMaxActiveClusters of
   each cluster size.  The last three tiers
   at small batches: dense_fft at n = 5, 23, 127, 251 and 1009 in both
   forms (the block form at 5 and 23 is K5's pair kernel, within 1e-6 at
   batch 300, 1, 3 and a batch that leaves its persistent walk ragged, the
   resident blocks printed), K5's chain form (dense_chain_fft, one Bluestein stage on K1's
   chain kernel) within 1e-6 at 29, 127 and 251,
   the two ragged-tile stages of large_pad (K12's in-place chain) within
   1e-6 at PAD_CHECKS: every stage kind (register, direct sum, Bluestein at
   M = 64 .. 1024) and a ragged last tile on both axes (17161 counts into
   the 412519 entries), and the fused large Bluestein's three kernels:
   the tile form's within 1e-6 at every Q of convlarge.COLUMN_FORMS x 1 and
   x 3 (BLUE's paths 1000003, 524309, 393241, 294919 and K15_CHECKS'
   primes 165901, 209959, 221197, 262147) and at 746497's Bluestein inner
   (m = 1572864) x 2, the general form's at 24571 (m = 49152), with the
   result against the float64 oracle.  The kernel-variant switches: K4's Gauss
   column and row stages at 2^20 x 1 and x 64, deep_a and blocks2d bit-equal
   to the default at 2^20 x 64, and the two-pass core's Gauss stages and
   in_shift column stage stage by stage at m = 65536 (Rader) and 16384
   (Bluestein, Gauss only), with the result against the float64 oracle;
3. the main paths through the public entry,
   FftPlanner(np.complex64, device="cuda").plan_fft_forward/inverse(n)
   .process(x): n = 4096 at batch 8 and 16384 (the pipelined kernel), K1's
   chain kernel at 64 x 2^20, 1000 x 65536, 2008 x 32768, 8192 x 8192 and
   14400 x 4096, n = 2^20 at batch 1024
   (the flagship n; batch cut from 4096 so that input, intermediate and
   output fit the card), the prime path at 1009 x 8192, 1234 x 8192,
   2063, 3083 and 2531 x 8192 and 257 x 65536 (the core's chain form),
   7919 x 4096 and 65537 x 512 (the JAX bench's rows and the 7919 cell;
   their cluster passes also at 7919 x 1 and x 5, 65537 x 1 and x 3) and
   the cluster passes' largest forms at 65521 x 512 and x 3 (r = 8) and
   131071 x 256 and x 3 (r = 16),
   the top band at 2^22 x 16, 2^23 x 8, 2^24 x 4, 2^25 x 2 (the JAX
   bench's rows) and 2^26 x 2, and the mid band at 16384 x 4096 and 24576 x 2048
   (two_stage), 14464 and 16256 x 4096 and 28544 x 2048 (two_stage with a
   Bluestein stage), 32768 x 2048, 65536 x 1024 (the JAX bench's row),
   131072 x 512 and 262144 x 256 (radix), K7's cluster band at 28928 x
   4096, 49152 x 2048, 98304 x 1024, 196608 x 512, 245760 x 256 and
   260608 x 256 (two_stage, one cluster launch each), the primes 29 x
   2^20, 127 x 262144 and 251 x 131072 (dense, K5's chain form) and 5 x
   2^23 and 23 x 2^21 (dense, the product's pair kernel), the odd composites 15625 x 4096, 78125 x 512,
   177147 x 256 and 531441 x 64 and the route's bulk 234617 x 256, 775575
   x 64, 412519 x 128 and 50666 x 1024 (large_pad), 1000003 x 64, 524309 x
   64, 393241 x 64 and 294919 x 128, each also x 1 and x 3 (the fused large
   Bluestein's tile form at Q = 8192, 6144, 4096, 3072) and 24571 x 2048
   (its general form; 24571's inner m = 49152 is on the cluster band), and
   the two-pass core's four stages at 746497 x 64 (Rader), 196613 x 256
   and 88589 x 512 (Bluestein).  Then the
   switched paths, each switch set just before its plans are made and set
   back in a `finally`: 2^20 x 1024 under config.large_gauss (the Gauss
   stages), under config.large_blocks2d and through
   make_large_fft_fn(deep_a=True) (the default stages, bit-equal to the
   default on 64 rows), 65537 x 512 under config.rader_in_shift,
   config.conv_radix_gauss and both, 7919 x 4096 under conv_radix_gauss,
   and with every switch on 15625 x 4096, 1000003 x 64, 2^23 x 8 and 2^26 x 2
   (no Gauss stage: the switches do not reach large_pad, K15, large2f or
   large3f), and the core's parent form through executor.build at
   Raders(928) (the prime 929) and Bluesteins(1234, 3712), 8192 rows each.
   Every launch counter is set to 0 just before each run and
   read just after: each path must launch exactly its kernels.  Errors
   against a float64 numpy oracle on 4 rows (1 row from 2^23 up) and
   against torch.fft (an oracle only) on the whole batch, and the round
   trip divided by n against the input;
4. each kernel against its plain version again at the shape its main path
   launches it with (the same relative bound; max_abs_err covers phases 2
   and 4), then times from CUDA events (median of 7 after 2 warm-ups):
   each kernel against its plain version, its bound (the larger of its
   bytes over 3.35 TB/s and the FP32 operations its function needs, 5 n
   log2 n a transform and 6 a twiddle, over 67 TFLOP/s, from this run's
   shapes) and, where one PyTorch call computes the same function,
   that call; every path against torch.fft, GF/s as 5*n*log2(n) per
   transform; 1234 three ways (whole-n Bluestein at m = 3072 and 2592, and
   MixedRadix(2, Raders(617))); 2^24 x 4 also through the recipe tree the
   planner designs (MixedRadix(4096, 4096) on lanepack leaves); 2^22 x 16
   through the large and the large2f routes; every mid-band path against
   the large route it replaced, and three_stage_fft at 16384 x 4096.  K7's
   two-stage paths with a Bluestein stage (ONE) and cluster band: the
   kernel at each path's shape against its plain version (K7 within 1e-6),
   its bound and torch.fft (with the operations its chain spends,
   chain_ops), and each cluster path against the large or large_pad route
   it replaced; 24571 x 2048 (Bluestein, m = 49152) on K15, which the
   planner keeps, and on the two-pass core the JAX rule gives it, in turns.
   The two-stage kernel's general body is reported at 24576 (its phase 2
   check at 20480 counts into that entry's max_abs_err) and at each ONE
   path.  K1: each kernel at each of its paths against its plain version
   (within 1e-6), its bound, torch.fft and the operations its chain spends;
   the pipelined kernel also against the chain kernel on the same chain.
   The last three tiers: K5's chain form against its plain version (within
   1e-6), its bound, torch.fft (its one-call PyTorch time), x @ W and the
   block product; the product at 5 and 23 (the pair kernel, within 1e-6)
   against x @ W (the Dft leaf it replaced, and the one-call PyTorch time),
   its other form and torch.fft;
   each dense path against torch.fft; dense_fft against the lanepack route
   at 256 x 262144 and the
   convolution cores at 1009 and 1234 x 8192 (the dense crossover); the
   one-pass core's chain form at each CORE path against its plain version
   (within 1e-6), its bound and, at 1009 and 1234, the parent form on the
   same inputs, and the parent form at m = 928 and 3712; each
   large_pad stage against its plain version (within 1e-6), its bound,
   the operations its chain spends and large's stage at one-column tiles, and each
   large_pad path against the large route and torch.fft; the fused large
   Bluestein's tile kernels at 1000003 x 64 (within 1e-6) and the path
   against the two-pass core and torch.fft, also at 524309 x 64, 393241 x
   64 and 294919 x 128 (the column forms of csrc/bconv_cols.cu), its
   general kernel A (the two-pass core's column stage with the chirp),
   B_conv and A2 at 24571 x 2048; the two-pass core's cluster passes at
   65537 x 512, 7919 x 4096, 65521 x 512 and 131071 x 256 (within 1e-6);
   its four stages on the ragged tiles (within 1e-6) at the Rader 746497 x
   64 (m = 746496: pass 1's column stage with the gather and sums, pass 2's
   row stage with the scatter and the DC-first output), the Bluesteins
   196613 x 256 and 88589 x 512 (pass 1's column stage with the chirp,
   pass 2's row stage with post), the middle two launches of each printed
   with their bounds, and at 65537 x 512 on the raw rows (in_shift); 746497 x 64 as
   Raders(746496) on the two-pass core
   and as Bluesteins(746497, 1572864) on the fused large Bluestein.  The
   switches: K4's Gauss stages at 64 x 2^20 against the default stages,
   their plain versions, their bound (that of the default stages, with the
   Gauss form's own operation count beside it) and, for the row stage, torch.fft over dim 1; the two-pass core's
   Gauss stages at the Rader 65537 x 512 shape against in_shift's default
   stages; every switched path against its default path (in turns: the
   default, each variant, the variants in reverse, the default) and
   torch.fft;
5. pinned plans (rustfft_tpu_torch.algorithm), c64, both directions: each
   of the ten constructors through utils.testing.check_fft_algorithm's
   checks and against the float64 oracle (relative mean error <= 1e-5),
   among them Radix4(4096), MixedRadix(Radix4(64), Radix4(64)),
   GoodThomasAlgorithm(Butterfly(7), Radix4(128)) and RadersAlgorithm over
   the planner's 1008; the launch counters: the pinned 4096 launches no
   lanepack kernel and the planner's 4096 one, the pinned 1009 no
   convolution core and the planner's its core and two gathers, each pair
   built in both orders into an empty executor cache; the pinned
   Good-Thomas launches K16 twice;
6. the flagship spectral step (models.flagship.make_spectral_step) at n =
   2^20, batch 1024, on one NCCL rank (a (1, 1) DeviceMesh, so the
   six-step's transposes are local), its first run counted (exactly four
   launches of K1's chain kernel: FFT_p and FFT_q at 1024 on 2^20 rows, a
   transform each way): against the same step built from FftPlanner and
   the float64 oracle on 4 rows, make_batch_sharded_fft bit-equal to
   plan.process, K1's chain kernel at that shape (1024 on 2^20 rows, both
   directions) within 1e-6 of its plain version and timed beside it, its
   bound and torch.fft (the kernels line's lanepack_chain_fft/1024; phase
   2 also checks 1024 with a ragged last block), then the step's time
   beside the planner's step and the step on torch.fft, and its peak
   device memory; the process group is destroyed before the last lines.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 1e-5
#: K7's and K12's kernels against their plain versions (the same in-place
#: chain's tables and stages, the sums in another order)
K7_TOL = 1e-6
SEED = 0

#: the card's peaks for the bound (NVIDIA's H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

#: the top band's paths: n -> batch, and the tag of their kernel entries
TOP = {1 << 22: 16, 1 << 23: 8, 1 << 24: 4, 1 << 25: 2, 1 << 26: 2}

#: the one-pass mid band's paths: n -> batch (256-512 MiB each)
MID = {16384: 4096, 24576: 2048, 1 << 15: 2048, 1 << 16: 1024, 1 << 17: 512, 1 << 18: 256}

#: K7 on one block with a prime p that runs a Bluestein stage: n -> batch
#: (113, 127 and 223 x 128; 28544 = 223 x 128 is the one-block size with
#: the least shared memory left)
ONE = {14464: 4096, 16256: 4096, 28544: 2048}

#: K7's cluster band (two_stage_cluster_fft): n -> batch (480-904 MiB each);
#: p x q and the blocks per transform: 226 x 128 (a radix-113 stage) on 2,
#: 192 x 256 on 4, 256 x 384 on 8, 384 x 512, 480 x 512 and 509 x 512 (a
#: prime p as one Bluestein stage, ragged row shares) on 16
CLUSTER = {28928: 4096, 49152: 2048, 98304: 1024, 196608: 512, 245760: 256, 260608: 256}

#: the kernels redesigned onto new bodies, held within 1e-6 of their plain
#: versions: K5's pair kernel (dense_fft's block form at n <= 23) and K10's
#: cluster kernel (large2f_col_stage)
PAIR_TOL = 1e-6

#: K1's chain kernel (lanepack_chain_fft) at the route's sizes: n -> batch
#: (450-512 MiB each): 64 (128 transforms a block), 1000 = 8 x 5 x 5 x 5
#: and 8192 = 16 x 16 x 16 x 2 (four register stages), 2008 = 251 x 8 (a
#: 512-point Bluestein stage), 14400 = 16 x 10 x 10 x 9 (direct sums)
LANE = {64: 1 << 20, 1000: 65536, 2008: 32768, 8192: 8192, 14400: 4096}

#: the flagship spectral step (phase 6): n = 2^20 at batch 1024 on a (1, 1)
#: mesh; its six-step's local FFTs (p = q = 1024) are K1's chain kernel at
#: STEP_LOCAL on STEP_BATCH * STEP_N / STEP_LOCAL = 2^20 rows
STEP_N, STEP_BATCH, STEP_LOCAL = 1 << 20, 1024, 1024

#: the dense tier's paths (K5): the primes from 29 as one Bluestein stage on
#: K1's chain kernel (dense_chain_fft), n -> batch (232-266 MiB), and 5 and
#: 23, the smallest and largest primes below the Bluestein crossover, on the
#: product (dense_fft: the pair kernel), 320 and 368 MiB
DENSE = {29: 1 << 20, 127: 262144, 251: 131072}
DENSE_PRODUCT = {5: 1 << 23, 23: 1 << 21}

#: the ragged-tile paths (K12): the odd composites n -> batch, and the
#: route's bulk at about 400 MiB each: 234617 = 373 x (37 x 17) (a
#: 1024-point Bluestein stage on the column stage; 128-point and a direct
#: sum on the row stage), 775575 = 383 x (15 x 15 x 9) (1024; direct sums),
#: 412519 = 131 x (67 x 47) (512; 256 and 128, eight-column row tiles) and
#: 50666 = (11 x 7 x 2) x (47 x 7) (a direct sum; 128)
PAD = {15625: 4096, 78125: 512, 177147: 256, 531441: 64, 234617: 256, 775575: 64, 412519: 128,
       50666: 1024}

#: K12's kernels against their plain versions at batch 2, both directions:
#: every stage kind (register 177147's chains; direct sums 50666's P and
#: 775575's Q; Bluestein M = 64 at 78125's and 531441's Q, 128 and 256 at
#: 412519's Q, 512 at 17161 = 131 x 131 on both stages, 1024 at 234617's and
#: 775575's P; a Bluestein stage beside a direct sum at 234617's Q) and a
#: ragged last tile on both axes at each
PAD_CHECKS = (78125, 177147, 531441, 17161, 234617, 775575, 412519, 50666)

#: the fused large Bluestein's paths (K15): the prime n -> (inner m, batch)
BLUE = {1000003: (1 << 21, 64), 524309: (1572864, 64), 393241: (1 << 20, 64),
        294919: (786432, 128)}

#: the tile form's other new Q (1536, 1728, 2048, 2304), each at the
#: smallest prime whose inner the planner puts there, and 746497's Bluestein
#: inner (m = 1572864): checked at small batches, counted into the entries of
#: the BLUE path named
K15_CHECKS = {165901: 294919, 209959: 294919, 221197: 294919, 262147: 294919, 746497: 524309}

#: the primes whose two-pass core runs the four stages on the ragged tiles
#: (K14 at every other m): the Rader 746497 (m = 746496 = 256 x 2916) and
#: the Bluesteins 196613 (419904 = 243 x 1728) and 88589 (186624 = 256 x
#: 729) -> batch
FOUR = {746497: 64, 196613: 256, 88589: 512}

#: the primes whose two-pass core runs the cluster passes (K14 at m =
#: r*16384): the Rader 65537 (m = 65536, r = 4) and the Bluesteins 7919
#: (16384, r = 1), 65521 (131072, r = 8) and 131071 (262144, r = 16) ->
#: batch
CLUSTER_PRIMES = {65537: 512, 7919: 4096, 65521: 512, 131071: 256}

#: kernels ported and checked but on no route (the JAX package routes none
#: of them either)
NOT_ROUTED = {"three_stage_fft"}

#: the one-pass convolution core's paths on its chain form (conv_chain_fft):
#: the Rader 1009 (m = 1008, K6's shape), 2531 (m = 2530, direct sums of 23
#: and 11) and 257 (m = 256), the Bluestein 1234 (m = 3072, K13's shape),
#: 2063 (m = 6144) and 3083 (m = 8192) -> batch
CORE = {1009: 8192, 1234: 8192, 2063: 8192, 3083: 8192, 2531: 8192, 257: 65536}

#: the parent form of the core (conv_fft) keeps the inner lengths whose
#: four-stage chain needs a Bluestein stage, which no prime of [257, 8191]
#: gets from the planner: its paths, built through executor.build, a Rader
#: (K6's layout, m = 928 = 29 x 32) and a Bluestein of 1234 at m = 3712 =
#: 29 x 128 (K13's), 8192 rows each
CONV_FFT_PATHS = {"K6": (929, 928), "K13": (1234, 3712)}

#: every ported kernel: (its source, the TPU kernel it replaces); conv_fft
#: and conv_chain_fft serve K13 and K6, reported at the shape of each
KERNELS = {
    "lanepack_pipe_fft": ("rustfft_tpu_torch/csrc/lanepack.cu",
                          "rustfft_tpu/ops/pallas/lanepack.py:250"),
    "large_col_stage": ("rustfft_tpu_torch/csrc/large.cu", "rustfft_tpu/ops/pallas/large.py:60"),
    "large_row_stage": ("rustfft_tpu_torch/csrc/large.cu", "rustfft_tpu/ops/pallas/large.py:241"),
    "conv_fft/K13": ("rustfft_tpu_torch/csrc/conv.cu", "rustfft_tpu/ops/pallas/conv.py:119"),
    "conv_fft/K6": ("rustfft_tpu_torch/csrc/conv.cu", "rustfft_tpu/ops/pallas/lanepack.py:501"),
    "permute": ("rustfft_tpu_torch/csrc/permute.cu", "rustfft_tpu/ops/pallas/permute.py:229"),
}
#: the core's chain form at each of its paths: K6 at 1009 and the other
#: Raders, K13 at 1234 and the other Bluesteins
for _n in CORE:
    _tag = {1009: "K6", 1234: "K13"}.get(_n, str(_n))
    KERNELS[f"conv_chain_fft/{_tag}"] = (
        "rustfft_tpu_torch/csrc/conv.cu",
        "rustfft_tpu/ops/pallas/" + ("conv.py:119" if _n in (1234, 2063, 3083, 257)
                                     else "lanepack.py:501"))
#: the top band's kernels, one entry per path shape: K10's fused column
#: stage and its Q-FFT pass (K3's row stage), K11's three passes
for _t in ("2^22", "2^23", "2^24", "2^25"):
    KERNELS[f"large2f_col_stage/{_t}"] = ("rustfft_tpu_torch/csrc/large2f.cu",
                                          "rustfft_tpu/ops/pallas/large2f.py:149")
    KERNELS[f"large_row_stage/{_t}"] = ("rustfft_tpu_torch/csrc/large.cu",
                                        "rustfft_tpu/ops/pallas/large2f.py:245")
KERNELS["large3_col_stage/2^26"] = ("rustfft_tpu_torch/csrc/large3.cu",
                                    "rustfft_tpu/ops/pallas/large.py:60")
KERNELS["large3_p2/2^26"] = ("rustfft_tpu_torch/csrc/large3.cu",
                             "rustfft_tpu/ops/pallas/large3.py:194")
KERNELS["large_row_stage/2^26"] = ("rustfft_tpu_torch/csrc/large.cu",
                                   "rustfft_tpu/ops/pallas/large3.py:221")
#: the mid band: K9 at every r, K7 at 16384 (the radix body at R = 1) and at
#: 24576 (the general in-place body), K8 at its split of 16384
for _t in ("2^15", "2^16", "2^17", "2^18"):
    KERNELS[f"radix_fft/{_t}"] = ("rustfft_tpu_torch/csrc/fused.cu",
                                  "rustfft_tpu/ops/pallas/fused.py:1212")
for _n in (16384, 24576, *ONE):
    KERNELS[f"two_stage_fft/{_n}"] = ("rustfft_tpu_torch/csrc/fused.cu",
                                      "rustfft_tpu/ops/pallas/fused.py:439")
KERNELS["three_stage_fft/16384"] = ("rustfft_tpu_torch/csrc/fused.cu",
                                   "rustfft_tpu/ops/pallas/fused.py:711")
#: K7's cluster band at each of its paths
for _n in CLUSTER:
    KERNELS[f"two_stage_cluster_fft/{_n}"] = ("rustfft_tpu_torch/csrc/fused.cu",
                                              "rustfft_tpu/ops/pallas/fused.py:439")
#: K1's chain kernel at each of its paths
for _n in (*LANE, STEP_LOCAL):
    KERNELS[f"lanepack_chain_fft/{_n}"] = ("rustfft_tpu_torch/csrc/lanepack.cu",
                                           "rustfft_tpu/ops/pallas/lanepack.py:250")
#: the last three tiers: K5 at each dense path (the chain form from 29, the
#: product's block form below), K12's two stages at each odd composite,
#: K15's three kernels (its kernel A is the two-pass core's column stage, in
#: place of large._kernel_a)
for _n in DENSE:
    KERNELS[f"dense_chain_fft/{_n}"] = ("rustfft_tpu_torch/csrc/lanepack.cu",
                                        "rustfft_tpu/ops/pallas/dense.py:161")
for _n in DENSE_PRODUCT:
    KERNELS[f"dense_fft/{_n}"] = ("rustfft_tpu_torch/csrc/dense.cu",
                                  "rustfft_tpu/ops/pallas/dense.py:161")
for _n in PAD:
    KERNELS[f"largepad_col_stage/{_n}"] = ("rustfft_tpu_torch/csrc/largepad.cu",
                                           "rustfft_tpu/ops/pallas/largepad.py:109")
    KERNELS[f"largepad_row_stage/{_n}"] = ("rustfft_tpu_torch/csrc/largepad.cu",
                                           "rustfft_tpu/ops/pallas/largepad.py:134")
for _n, (_m, _) in BLUE.items():  # the tile form (convlarge.tile_form)
    KERNELS[f"bconv_col_tile/{_n}"] = ("rustfft_tpu_torch/csrc/convlarge.cu",
                                       "rustfft_tpu/ops/pallas/large.py:60")
    KERNELS[f"bconv_row_tile/{_n}"] = ("rustfft_tpu_torch/csrc/"
                                       + ("convlarge.cu" if _m == 1 << 21 else "bconv_cols.cu"),
                                       "rustfft_tpu/ops/pallas/convlarge.py:72")
    KERNELS[f"bconv_out_tile/{_n}"] = ("rustfft_tpu_torch/csrc/convlarge.cu",
                                       "rustfft_tpu/ops/pallas/convlarge.py:99")
#: K15's general form at 24571 (Q = 192; its kernel A is conv_col_stage on
#: csrc/large.cuh's kernels, general=True)
KERNELS["conv_col_stage/24571"] = ("rustfft_tpu_torch/csrc/conv_radix.cu",
                                   "rustfft_tpu/ops/pallas/large.py:60")
KERNELS["bconv_row_stage/24571"] = ("rustfft_tpu_torch/csrc/convlarge.cu",
                                    "rustfft_tpu/ops/pallas/convlarge.py:72")
KERNELS["bconv_out_stage/24571"] = ("rustfft_tpu_torch/csrc/convlarge.cu",
                                    "rustfft_tpu/ops/pallas/convlarge.py:99")
#: K14's four stages on the ragged tiles at each of their paths: pass 1's
#: column stage (the gather or the chirp, the sums) and pass 2's row stage
#: (the epilogue)
for _n in FOUR:
    KERNELS[f"conv_col_stage/{_n}"] = ("rustfft_tpu_torch/csrc/conv_pad.cu",
                                       "rustfft_tpu/ops/pallas/conv_radix.py:70")
    KERNELS[f"conv_row_stage/{_n}"] = ("rustfft_tpu_torch/csrc/conv_pad_row.cu",
                                       "rustfft_tpu/ops/pallas/conv_radix.py:70")
#: K14's cluster passes (m = r*16384 on the radix body) at each of their paths
for _n in CLUSTER_PRIMES:
    KERNELS[f"conv_radix_pass1/{_n}"] = ("rustfft_tpu_torch/csrc/conv_radix.cu",
                                         "rustfft_tpu/ops/pallas/conv_radix.py:70")
    KERNELS[f"conv_radix_pass2/{_n}"] = ("rustfft_tpu_torch/csrc/conv_radix.cu",
                                         "rustfft_tpu/ops/pallas/conv_radix.py:70")
#: the kernel-variant switches: K4's Gauss stages, K14's stages in the Gauss
#: form, and K14's four stages with the column stage on the raw Rader rows
#: (in_shift; its launches are conv_col_stage's and conv_row_stage's on the
#: 65537 in_shift path)
KERNELS["large_col_stage_gauss"] = ("rustfft_tpu_torch/csrc/large_gauss.cu",
                                    "rustfft_tpu/ops/pallas/large.py:76")
KERNELS["large_row_stage_gauss"] = ("rustfft_tpu_torch/csrc/large_gauss.cu",
                                    "rustfft_tpu/ops/pallas/large.py:131")
KERNELS["conv_col_stage_gauss"] = ("rustfft_tpu_torch/csrc/conv_radix.cu",
                                   "rustfft_tpu/ops/pallas/conv_radix.py:70")
KERNELS["conv_row_stage_gauss"] = ("rustfft_tpu_torch/csrc/conv_radix.cu",
                                   "rustfft_tpu/ops/pallas/conv_radix.py:70")
KERNELS["conv_col_stage/in_shift"] = ("rustfft_tpu_torch/csrc/conv_pad.cu",
                                      "rustfft_tpu/ops/pallas/conv_radix.py:70")
KERNELS["conv_row_stage/in_shift"] = ("rustfft_tpu_torch/csrc/conv_pad_row.cu",
                                      "rustfft_tpu/ops/pallas/conv_radix.py:70")

#: the path whose launches a "kernel/tag" entry reports, for tags that are
#: not a size
TAGGED = {"in_shift": "65537 in_shift"}


def tag(n: int) -> str:
    return f"2^{n.bit_length() - 1}"


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the FP32 operations over the peak rate.  `flops` is what the
    function needs (fft_ops for a DFT), not what a kernel's algorithm
    spends on it: a direct sum, a Gauss form or a dense product is the
    kernel's choice, and its count (chain_ops, gauss_ops, dense_ops) is
    printed beside the bound, never put in it."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def fft_ops(m: float) -> float:
    """FP32 operations of one length-m transform: 5*m*log2(m)."""
    return 5 * m * math.log2(m)


def chain_ops(radices, stage_m) -> float:
    """FP32 operations per point of a DIT chain as K7's kernels run it (a
    diagnostic beside the bound, not the bound): 5 log2(r) for a power-of-2
    radix (a radix-2 FFT in registers), (M/r)(10 log2 M + 6) + 12 for a
    Bluestein stage of length M = stage_m(r) (two FFT_M, the spectrum and
    the chirps), 8r for any other (a direct sum, r complex multiply-adds per
    output), and 6 per inter-stage twiddle."""

    def ops(r):
        if r & (r - 1) == 0:
            return 5 * math.log2(r)
        m = stage_m(r)
        return m / r * (10 * math.log2(m) + 6) + 12 if m else 8 * r

    return sum(ops(r) for r in radices) + 6 * (len(radices) - 1)


def gauss_ops(radices) -> float:
    """FP32 operations per point of a DIT chain in the Gauss form (a
    diagnostic beside the bound, not the bound)
    (csrc/fft_tile.cuh gauss_stage): per radix-r stage three multiply-adds
    per term (6r), the xr + xi add and the three subtractions of
    re = P1 - P2, im = P3 - P1 - P2 (4), and a complex product (6) per
    inter-stage twiddle."""
    return sum(6 * r + 4 for r in radices) + 6 * (len(radices) - 1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().double().sum() / want.abs().double().sum()).item()


def rel_err_chunked(got: torch.Tensor, want_rows) -> float:
    """Relative mean error of got (B, n) against want_rows(i, j) -> rows i:j,
    in chunks of at least 64 rows and about 2^22 points."""
    rows = max(64, (1 << 22) // got.shape[1])
    num = den = 0.0
    for i in range(0, got.shape[0], rows):
        want = want_rows(i, i + rows)
        num += (got[i : i + rows] - want).abs().double().sum().item()
        den += want.abs().double().sum().item()
    return num / den


def check(what: str, value: float, bound: float = TOL) -> None:
    print(f"  {what}: {value:.3e} (bound {bound:.0e})", flush=True)
    if not value <= bound:
        raise AssertionError(f"{what}: {value:.3e} > {bound:.0e}")


def median_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gflops(n: int, batch: int, ms: float) -> float:
    return 5 * n * math.log2(n) * batch / (ms * 1e6)


def free() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def switched(config, switches, fn):
    """fn() with the config switches set, every one set back after, also
    when fn raises."""
    old = {name: getattr(config, name) for name in switches}
    for name, value in switches.items():
        setattr(config, name, value)
    try:
        return fn()
    finally:
        for name, value in old.items():
            setattr(config, name, value)


def run_counted(counters, fn, expected, what, totals=()):
    """fn() with every launch counter set to 0 just before and read just
    after: exactly the expected launches (a name left out: none), each added
    to every dict of `totals`."""
    for counter in counters.values():
        counter.launches = 0
    y = fn()
    torch.cuda.synchronize()
    got = {name: counter.launches for name, counter in counters.items()}
    want = {name: expected.get(name, 0) for name in counters}
    if got != want:
        raise AssertionError(f"{what}: launches "
                             f"{ {k: v for k, v in got.items() if v} }, expected {expected}")
    for tally in totals:
        for name, count in got.items():
            tally[name] = tally.get(name, 0) + count
    return y


def pinned_phase(counters, signal, t0) -> None:
    """Phase 5: the hand-built constructors of rustfft_tpu_torch.algorithm on
    the card, c64, both directions.  Each of the ten through
    utils.testing.check_fft_algorithm's checks (length, direction, the three
    other entry points equal to process, the (3, n) batch equal to the flat
    buffer, the input untouched) and against the float64 oracle at a relative
    mean error <= 1e-5; then the launch counters: a pinned plan runs its
    literal recipe (Radix4(4096) no lanepack kernel, the Rader 1009 no
    convolution core, Good-Thomas its two K16 gathers), the planner's 4096
    and 1009 their kernels, with the pinned and the planner's plan built in
    both orders into an empty executor cache."""
    from rustfft_tpu_torch import FftDirection, FftPlanner, algorithm as alg, executor
    from rustfft_tpu_torch.utils.testing import check_fft_algorithm

    print(f"phase 5: pinned plans, rustfft_tpu_torch.algorithm on the card (t = "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    for d in (FftDirection.FORWARD, FftDirection.INVERSE):
        planner = FftPlanner(np.complex64, device="cuda")
        built = (
            (alg.Dft(50, d), 50),
            (alg.Butterfly(16, d), 16),
            (alg.Radix4(4096, d), 4096),
            (alg.Radix3(729, d), 729),
            (alg.MixedRadix(alg.Radix4(64, d), alg.Radix4(64, d)), 4096),
            (alg.MixedRadixSmall(alg.Butterfly(4, d), alg.Butterfly(6, d)), 24),
            (alg.GoodThomasAlgorithm(alg.Butterfly(7, d), alg.Radix4(128, d)), 896),
            (alg.GoodThomasAlgorithmSmall(alg.Butterfly(9, d), alg.Butterfly(16, d)), 144),
            (alg.RadersAlgorithm(planner.plan_fft(1008, d)), 1009),
            (alg.BluesteinsAlgorithm(1234, alg.Radix4(4096, d)), 1234),
        )
        for plan, n in built:
            if not plan.pinned or plan.device.type != "cuda":
                raise AssertionError(f"{plan!r}: not a pinned plan on the card")
            check(f"{plan!r} {plan.recipe!r}"[:150] + " check_fft_algorithm vs float64 oracle",
                  check_fft_algorithm(plan, n, d))
        for n, pinned_of, planned in (
            (4096, lambda: alg.Radix4(4096, d), {"lanepack_pipe_fft": 1}),
            (1009, lambda: alg.RadersAlgorithm(planner.plan_fft(1008, d)),
             {"conv_chain_fft": 1, "permute": 2}),
        ):
            for first in ("pinned", "planner"):
                saved = executor._CACHE
                executor._CACHE = type(saved)()
                try:
                    plans = {}
                    for which in ((first, "planner") if first == "pinned" else (first, "pinned")):
                        plans[which] = (pinned_of() if which == "pinned" else
                                        FftPlanner(np.complex64, device="cuda").plan_fft(n, d))
                finally:
                    executor._CACHE = saved
                if plans["pinned"].raw_fn is plans["planner"].raw_fn:
                    raise AssertionError(f"{n}: the pinned and the planner's plan share a function")
                x = signal(64, n)
                want = torch.fft.fft(x) if d is FftDirection.FORWARD else torch.fft.ifft(x) * n
                for which, expected in (("pinned", {}), ("planner", planned)):
                    what = f"{which} {n} x 64 {d.name} ({first} built first)"
                    y = run_counted(counters, lambda: plans[which].process(x), expected, what)
                    print(f"  {what}: launches {expected or 'none'}", flush=True)
                    check(f"{which} {n} x 64 {d.name} vs torch.fft", rel_err(y, want))
        gt = alg.GoodThomasAlgorithm(alg.Butterfly(7, d), alg.Radix4(128, d))
        x = signal(64, 896)
        what = f"pinned GoodThomas(7, 128) x 64 {d.name}"
        y = run_counted(counters, lambda: gt.process(x), {"permute": 2}, what)
        print(f"  {what}: launches {{'permute': 2}}", flush=True)
        want = torch.fft.fft(x) if d is FftDirection.FORWARD else torch.fft.ifft(x) * 896
        check(f"pinned GoodThomas(7, 128) x 64 {d.name} vs torch.fft", rel_err(y, want))
    free()


def spectral_phase(counters, signal, card, t0, totals):
    """Phase 6: the flagship spectral step (models.flagship.make_spectral_step)
    at n = STEP_N, batch STEP_BATCH, on one NCCL rank (a (1, 1) mesh: the
    six-step's transposes are local, no all-to-all runs), its first run
    counted (two K1 chain launches a transform, added to `totals`), against
    the same step built from FftPlanner (forward, filter, inverse, scale)
    and the float64 oracle on 4 rows; make_batch_sharded_fft on the same
    mesh bit-equal to plan.process; K1's chain kernel at the shape the step
    gives it (STEP_LOCAL on 2^20 rows) against its plain version in both
    directions and timed beside it, its bound and torch.fft; the step's time
    (CUDA events, median of 7), the same step on torch.fft and the peak
    device memory.  Returns K1's entry at STEP_LOCAL for the kernels line:
    its times, bound and max_abs_err."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from rustfft_tpu_torch import FftDirection, FftPlanner
    from rustfft_tpu_torch.models.flagship import make_spectral_step, spectral_filter
    from rustfft_tpu_torch.ops.kernels import lanepack
    from rustfft_tpu_torch.parallel import make_batch_sharded_fft, make_mesh

    print(f"phase 6: the flagship spectral step on one NCCL rank (t = "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}/init", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1))
        n, batch, m = STEP_N, STEP_BATCH, STEP_LOCAL
        what = f"spectral step n=2^20 batch={batch}, mesh (data=1, fft=1)"
        step = make_spectral_step(mesh, n, np.complex64)
        planner = FftPlanner(np.complex64, device="cuda")
        fwd, inv = planner.plan_fft_forward(n), planner.plan_fft_inverse(n)
        filt = torch.from_numpy(spectral_filter(n).astype(np.float32)).cuda()

        def planner_step(x):
            f = fwd.process(x)
            f.mul_(filt)
            return inv.process(f).mul_(float(np.float32(1.0 / n)))

        def library_step(x):
            return torch.fft.ifft(torch.fft.fft(x) * filt)

        x = signal(batch, n)
        free()
        torch.cuda.reset_peak_memory_stats()
        y = run_counted(counters, lambda: step(x), {"lanepack_chain_fft": 4}, what, totals)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  {what}: launches {{'lanepack_chain_fft': 4}}", flush=True)
        if y.shape != x.shape or y.dtype != torch.complex64:
            raise AssertionError(f"{what}: output {tuple(y.shape)} {y.dtype}")
        if not bool(torch.isfinite(torch.view_as_real(y)).all()):
            raise AssertionError(f"{what}: non-finite output")
        rows = x[:4].cpu().numpy().astype(np.complex128)
        want = np.fft.ifft(np.fft.fft(rows) * spectral_filter(n))
        got = y[:4].cpu().numpy().astype(np.complex128)
        check(f"{what} vs float64 oracle (4 rows)",
              float(np.mean(np.abs(got - want)) / np.mean(np.abs(want))))
        check(f"{what} vs the planner's step",
              rel_err_chunked(y, lambda i, j: planner_step(x[i:j])))
        del y
        free()
        sharded = make_batch_sharded_fft(fwd, mesh)
        if not torch.equal(sharded(x), fwd.process(x)):
            raise AssertionError("make_batch_sharded_fft differs from plan.process")
        print(f"  make_batch_sharded_fft n=2^20 batch={batch}: bit-equal to plan.process",
              flush=True)
        free()

        # K1's chain kernel at the local FFTs' shape, on the step's input
        # seen as (2^20, 1024) rows
        rows = x.reshape(-1, m)
        radices = lanepack.choose_radices(m)
        max_abs = 0.0
        tables = {d: tuple([torch.from_numpy(a).cuda() for a in part]
                           for part in lanepack.chain_tables(m, radices, d))
                  for d in (FftDirection.FORWARD, FftDirection.INVERSE)}
        for d, tabs in tables.items():
            got = lanepack.lanepack_chain_fft(rows, radices, tabs)
            num = den = 0.0
            for i in range(0, rows.shape[0], 1 << 16):
                want = lanepack.lanepack_fft_plain(rows[i:i + (1 << 16)], radices, tabs)
                diff = (got[i:i + (1 << 16)] - want).abs()
                num += diff.double().sum().item()
                den += want.abs().double().sum().item()
                max_abs = max(max_abs, diff.max().item())
            check(f"lanepack_chain_fft n={m} {radices} batch={rows.shape[0]} {d.name} (the "
                  f"spectral step's shape) vs its plain version", num / den, K7_TOL)
            del got, want, diff
            free()
        tabs = tables[FftDirection.FORWARD]
        k_ms = median_ms(lambda: lanepack.lanepack_chain_fft(rows, radices, tabs))
        plain_ms = median_ms(lambda: lanepack.lanepack_fft_plain(rows, radices, tabs))
        ref_ms = median_ms(lambda: torch.fft.fft(rows))
        free()
        nbytes = 16 * rows.numel() + sum(a.numel() * a.element_size()
                                         for part in tabs for a in part)
        bound_ms, bound_by = bound(nbytes, rows.shape[0] * fft_ops(m))
        print(f"  lanepack_chain_fft n={m} {radices} batch={rows.shape[0]}: kernel {k_ms:.3f} ms "
              f"({gflops(m, rows.shape[0], k_ms):.0f} GF/s), plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.3f} ms ({bound_by}), torch.fft {ref_ms:.3f} ms", flush=True)
        del rows

        ms = median_ms(lambda: step(x))
        planner_ms = median_ms(lambda: planner_step(x))
        library_ms = median_ms(lambda: library_step(x))
        print(f"  {what}: {ms:.3f} ms; the planner's step (no six-step) {planner_ms:.3f} ms; "
              f"torch.fft step {library_ms:.3f} ms; peak device memory of the step {peak:.2f} "
              f"GiB ({card})", flush=True)
        del x
        free()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous, ignore_errors=True)
    return {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": ref_ms}


def main() -> None:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: needs an NVIDIA GPU")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rustfft_tpu_torch import FftDirection, FftPlanner, config, executor, recipes, route
    from rustfft_tpu_torch.ops.bluestein import bluestein_tables
    from rustfft_tpu_torch.ops.kernels import (
        _build, conv, conv_radix, convlarge, dense, fused, lanepack, large, large2f, large3,
        largepad, permute,
    )
    from rustfft_tpu_torch.ops.raders import raders_tables
    from rustfft_tpu_torch.planner import routed_bluestein_inner
    from rustfft_tpu_torch.twiddles import host_dft

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def signal(batch: int, n: int) -> torch.Tensor:
        return torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)

    def on_card(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    def card_tables(tables):
        """A kernel's host tables (arrays and lists of arrays) on the card."""
        return tuple(on_card(t) if isinstance(t, list) else torch.from_numpy(t).to(dev)
                     for t in tables)

    def table_bytes(tables):
        """Bytes of a kernel's tables: host arrays or card tensors, and lists
        of either."""
        return sum(a.numel() * a.element_size() if isinstance(a, torch.Tensor) else a.nbytes
                   for t in tables for a in (t if isinstance(t, list) else [t]))

    def mid_kernel(n, d):
        """(name, kernel(x), plain(x), host tables) of the mid-band kernel
        routed at n (K9, K7 on one block, or K7 on a cluster)."""
        if fused.radix_supported(n, np.complex64):
            r = n // (128 * 128)
            host = fused.radix_tables(r, 128, 128, d)
            tabs = card_tables(host)
            return (f"radix_fft/{tag(n)}", lambda x: fused.radix_fft(x, r, 128, tabs),
                    lambda x: fused.radix_fft_plain(x, r, 128, tabs), host)
        p, q = fused.choose_pq(n)
        host = fused.two_stage_tables(p, large.stage_radices(q), d)
        tabs = card_tables(host)
        if fused.two_stage_cluster_supported(n, np.complex64):
            c = fused.choose_cluster(n)
            return (f"two_stage_cluster_fft/{n}",
                    lambda x: fused.two_stage_cluster_fft(x, p, q, c, tabs),
                    lambda x: fused.two_stage_cluster_fft_plain(x, p, q, c, tabs), host)
        name = ("two_stage_fft/16384" if (p, q) == (128, 128) else
                f"two_stage_fft/{n}" if n in ONE else "two_stage_fft/24576")
        return (name, lambda x: fused.two_stage_fft(x, p, q, tabs),
                lambda x: fused.two_stage_fft_plain(x, p, q, tabs), host)

    def dense_card(n, d, variant):
        """dense_fft's tables (W, and Wr + Wi in the Gauss form) on the card."""
        return tuple(None if t is None else torch.from_numpy(t).to(dev)
                     for t in dense.dense_tables(n, d, variant))

    def pad_card(n, d, tables=largepad):
        """(P, Q, column-stage tables, row-stage tables) of large_pad at n,
        on the card (tables=large: large's, for its stages on the same
        split)."""
        p, q1, q2 = large.choose_pqq(n)
        q = q1 * q2
        return p, q, card_tables(tables.col_tables(p, q, d)), card_tables(tables.row_tables(q, d))

    def bconv_card(n, m, d):
        """(P, Q, column tables, row tables, pre, h, chirp) of the fused large
        Bluestein of length n at inner m, on the card."""
        p, q1, q2 = large.choose_pqq(m)
        q = q1 * q2
        host = convlarge.bconv_tables(n, m, p, q, d)
        return (p, q, card_tables(host["col"]), card_tables(host["row"]),
                *(torch.from_numpy(host[k]).to(dev) for k in ("pre", "h", "chirp")))

    def bconv_tile_card(n, m, d, col):
        """B_conv's tables of the tile form on the card: (its chain's
        tables, h in chain 1's output positions, the outer twiddle), both
        in column pairs."""
        p, q = col[2].shape[::-1]
        host = convlarge.bconv_tables(n, m, p, q, d)
        return (card_tables(convlarge.bconv_chain_tables(d, q)),
                torch.from_numpy(convlarge.bconv_h_table(host["h"])).to(dev),
                convlarge.to_columns(col[2]))

    def cluster_card(n, d):
        """(m, r, the radix body's tables, pass 1's and pass 2's keywords, n_in,
        n_out) of the two-pass core of the prime n on its cluster passes, on
        the card: 65537 the Rader core (gather, sums, scatter; pass 2's x0
        and partials are the caller's), the others the Bluestein core at
        the inner length the planner gives them."""
        if n == 65537:
            m = n - 1
            perm_in, inv_gather, b_fft = raders_tables(n, d)
            tabs = conv_radix.radix_conv_tables(m, d, h=b_fft, in_perm=perm_in - 1,
                                                out_perm=inv_gather)
            kw1 = dict(perm=torch.from_numpy(tabs["perm"]).to(dev), emit_sum=True)
            kw2 = dict(conj_out=True, scatter=torch.from_numpy(tabs["scatter"]).to(dev))
            n_in = n_out = m
        else:
            m = FftPlanner(np.complex64, device="cuda").plan_fft_forward(n).recipe.inner.length
            chirp, h_fft = bluestein_tables(n, m, d)
            tabs = conv_radix.radix_conv_tables(m, d, h=h_fft, pre=chirp, post=chirp)
            kw1 = dict(pre=torch.from_numpy(tabs["pre"]).to(dev))
            kw2 = dict(conj_out=True, post=torch.from_numpy(tabs["post"]).to(dev))
            n_in = n_out = n
        kw1["h"] = torch.from_numpy(tabs["h"]).to(dev)
        r = conv_radix.cluster_form(m)
        return m, r, card_tables(conv_radix.cluster_tables(r, d)), kw1, kw2, n_in, n_out

    directions = (FftDirection.FORWARD, FftDirection.INVERSE)

    # ---- phase 1: build ----
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    start = time.perf_counter()
    _build.load()
    print(f"phase 1: kernels built from {_build.SRC_DIR.name}/ in "
          f"{time.perf_counter() - start:.1f} s (nvcc {_build.last_build_seconds:.1f} s) "
          f"-> {_build.library_path()}", flush=True)

    # ---- phase 2: each kernel against its plain version on the card ----
    print(f"phase 2: kernels against their plain torch versions (t = "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    max_abs = {name: 0.0 for name in KERNELS}

    def note(name, got, want, what, tol=TOL):
        check(what, rel_err(got, want), tol)
        max_abs[name] = max(max_abs[name], (got - want).abs().max().item())

    # K1's two kernels within 1e-6 of their plain versions: the pipelined
    # 4096 kernel (257 rows: a ragged last wave), and the chain kernel at
    # packed small n with a ragged last block (64, 12), four register stages
    # (1000, 8192), Bluestein stages (M = 512 at 2008 and in the explicit
    # chains (256, 16) and (16, 243)), direct sums (14400) and the spectral
    # step's local FFT (1024, a ragged last block); the entries of sizes
    # that are not paths count into 2008's
    for n, batch, radices in ((4096, 257, lanepack.PIPE_RADICES), (64, 300, None),
                              (1000, 17, None), (2008, 9, None), (8192, 3, None),
                              (14400, 2, None), (12, 1000, None), (4096, 5, (256, 16)),
                              (3888, 5, (16, 243)),
                              (STEP_LOCAL, 3 * lanepack.chain_width(STEP_LOCAL) + 1, None)):
        radices = radices or lanepack.choose_radices(n)
        name = ("lanepack_pipe_fft" if radices == lanepack.PIPE_RADICES else
                f"lanepack_chain_fft/{n if n in (*LANE, STEP_LOCAL) else 2008}")
        x = signal(batch, n)
        for d in directions:
            tables = card_tables(lanepack.chain_tables(n, radices, d))
            got = lanepack.lanepack_fft(x, radices, tables)
            torch.cuda.synchronize()
            want = lanepack.lanepack_fft_plain(x, radices, tables)
            check(f"{name.split('/')[0]} n={n} {radices} Bluestein "
                  f"{lanepack.bluestein_ms(radices, lanepack.MAX_STAGES)} width "
                  f"{lanepack.chain_width(n)} batch={batch} {d.name}", rel_err(got, want), K7_TOL)
            max_abs[name] = max(max_abs[name], (got - want).abs().max().item())
    # K2's and K3's persistent tile kernels within 1e-6 of their plain
    # versions at 2^20 x 1, x 3, x 4 and a batch at which both walks are
    # ragged (K2's last block takes fewer units, K3's blocks unequal tiles),
    # each grid printed; 32768 x 3 on K2's tile kernel at Q = 128 and the
    # general row kernel; at 2^20 x 2 each stage on a view one element into
    # its storage (not 16-byte aligned: the wrapper copies it)
    col_res, row_res = large.resident_blocks("col"), large.resident_blocks("row")
    ragged = next(b for b in range(2, 4096)
                  if (b * 256) % large.col_walk(b * 256, col_res)[1]
                  and (b * 64) % large.row_grid(b * 64, row_res))
    for n, batch in ((1 << 20, 1), (1 << 20, 3), (1 << 20, 4), (1 << 20, ragged), (32768, 3)):
        p, q1, q2 = large.choose_pqq(n)
        q = q1 * q2
        x = signal(batch, n)
        for d in directions:
            r, t, outer = large.col_tables(p, q, d)
            col = (on_card(r), on_card(t), torch.from_numpy(outer).to(dev))
            r, t = large.row_tables(q, d)
            row = (on_card(r), on_card(t))
            a = large.large_col_stage(x, p, q, col)
            torch.cuda.synchronize()
            a_plain = large.large_col_stage_plain(x, p, q, col)
            walk = (f"grid {large.col_walk(batch * q // 16, col_res)} (blocks, units a block) of "
                    f"{col_res} resident" if (large.stage_radices(p), large.col_tile(p, q))
                    == large.TILE_COL else "general kernel")
            check(f"large_col_stage n={n} P={p} {large.stage_radices(p)} batch={batch} {walk} "
                  f"{d.name}", rel_err(a, a_plain), K7_TOL)
            y = large.large_row_stage(a, q, p, row)
            torch.cuda.synchronize()
            y_plain = large.large_row_stage_plain(a, q, p, row)
            walk = (f"grid {large.row_grid(batch * p // 4, row_res)} of {row_res} resident"
                    if (large.stage_radices(q), large.row_tile(q, p)) == large.TILE_ROW
                    else "general kernel")
            check(f"large_row_stage n={n} Q={q} {large.stage_radices(q)} batch={batch} {walk} "
                  f"{d.name}", rel_err(y, y_plain), K7_TOL)
            max_abs["large_col_stage"] = max(max_abs["large_col_stage"], (a - a_plain).abs().max().item())
            max_abs["large_row_stage"] = max(max_abs["large_row_stage"], (y - y_plain).abs().max().item())
    n, d = 1 << 20, directions[0]
    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    col, row = card_tables(large.col_tables(p, q, d)), card_tables(large.row_tables(q, d))
    x = signal(2, n)
    base = torch.zeros(2 * n + 1, dtype=torch.complex64, device=dev)
    base[1:] = x.reshape(-1)
    a = large.large_col_stage(base[1:].view(2, n), p, q, col)
    torch.cuda.synchronize()
    note("large_col_stage", a, large.large_col_stage_plain(x, p, q, col),
         f"large_col_stage n=2^20 batch=2 on a view at data_ptr % 16 = "
         f"{base[1:].data_ptr() % 16} {d.name}", K7_TOL)
    base[1:] = a.reshape(-1)
    y = large.large_row_stage(base[1:].view(2, q, p), q, p, row)
    torch.cuda.synchronize()
    note("large_row_stage", y, large.large_row_stage_plain(a, q, p, row),
         f"large_row_stage n=2^20 batch=2 on a view at data_ptr % 16 = "
         f"{base[1:].data_ptr() % 16} {d.name}", K7_TOL)
    del x, a, a_plain, y, y_plain, base
    free()

    # K4 at 2^20: the Gauss stages against their plain versions at batch 1
    # and 64; deep_a and blocks2d (the default stages) bit-equal to the default
    n = 1 << 20
    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    for batch in (1, 64):
        x = signal(batch, n)
        for d in directions:
            col = card_tables(large.col_tables(p, q, d, gauss=True))
            row = card_tables(large.row_tables(q, d, gauss=True))
            a = large.large_col_stage_gauss(x, p, q, col)
            torch.cuda.synchronize()
            note("large_col_stage_gauss", a, large.large_col_stage_gauss_plain(x, p, q, col),
                 f"large_col_stage_gauss n=2^20 P={p} {large.stage_radices(p)} batch={batch} "
                 f"{d.name}")
            y = large.large_row_stage_gauss(a, q, p, row)
            torch.cuda.synchronize()
            note("large_row_stage_gauss", y, large.large_row_stage_gauss_plain(a, q, p, row),
                 f"large_row_stage_gauss n=2^20 Q={q} {large.stage_radices(q)} batch={batch} "
                 f"{d.name}")
            if batch > 1:
                want = large.make_large_fft_fn(n, d, np.complex64, gauss=False, blocks2d=False)(x)
                for kw in (dict(deep_a=True), dict(blocks2d=True)):
                    got = large.make_large_fft_fn(n, d, np.complex64, **kw)(x)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"make_large_fft_fn({kw}) differs from the default")
                    print(f"  make_large_fft_fn(2^20, {kw}) batch={batch} {d.name}: bit-equal to "
                          "the default", flush=True)
        del x, a, y
        free()

    def conv_tables(m, d, h, pre=None, post=None):
        radices = lanepack.tile_radices(m)
        roots, tws = lanepack.stage_tables(m, radices, d)
        extra = [None if t is None else torch.from_numpy(conv_radix.zero_extended(t, m)).to(dev)
                 for t in (h, pre, post)]
        return radices, (on_card(roots), on_card(tws), *extra)

    # the one-pass core: Rader 1009 (m = 1008, K6's shape) and Bluestein
    # 1234 (m = 3072, K13's shape), tables and conj off and on
    for m, n_blue, batch in ((1008, 504, 257), (3072, 1234, 257)):
        key = "conv_fft/K6" if m == 1008 else "conv_fft/K13"
        for d in directions:
            chirp, h_blue = bluestein_tables(n_blue, m, d)
            h_plain = raders_tables(1009, d)[2] if m == 1008 else h_blue
            for tables_on in (False, True):
                if tables_on:  # Bluestein n_blue: pre, post, conj, ragged n_in / n_out
                    radices, tables = conv_tables(m, d, h_blue, chirp, chirp)
                    n = n_blue
                else:
                    radices, tables = conv_tables(m, d, h_plain)
                    n = m
                x = signal(batch, n)
                got = conv.conv_fft(x, radices, tables, n, conj_out=tables_on)
                torch.cuda.synchronize()
                want = conv.conv_fft_plain(x, m, radices, tables, n, tables_on)
                note(key, got, want, f"conv_fft m={m} {radices} n={n} pre/post/conj={tables_on} "
                                     f"batch={batch} {d.name}")
    # the parent form where it still serves: m = 928 (K6's layout) and 3712
    # (K13's), whose four-stage chains need a Bluestein stage
    for key, (p_or_n, m) in CONV_FFT_PATHS.items():
        d = directions[0]
        rader = m == p_or_n - 1
        n = m if rader else p_or_n
        h, pre = ((raders_tables(p_or_n, d)[2], None) if rader
                  else bluestein_tables(p_or_n, m, d)[::-1])
        radices, tables = conv_tables(m, d, h, pre, pre)
        x = signal(257, n)
        note(f"conv_fft/{key}", conv.conv_fft(x, radices, tables, n, not rader),
             conv.conv_fft_plain(x, m, radices, tables, n, not rader),
             f"conv_fft m={m} {radices} n={n} batch=257 {d.name} (where it serves)")

    def chain_tables(m, d, h, pre=None, post=None):
        """The chain form's tables on the card: h in chain 1's positions."""
        radices = conv.chain_radices(m)
        roots, tws1, tws2 = conv.double_chain_tables(m, radices, d)
        h = conv.chain_h_table(conv_radix.zero_extended(h, m), radices)
        extra = [None if t is None else torch.from_numpy(conv_radix.zero_extended(t, m)).to(dev)
                 for t in (pre, post)]
        return radices, (on_card(roots), on_card(tws1), on_card(tws2),
                         torch.from_numpy(h).to(dev), *extra)

    # the chain form within 1e-6 of its plain version at m = 256, 1008, 2530,
    # 3072, 6144 and 8192, both directions, tables on (a Bluestein's pre,
    # post, conj and ragged n_in / n_out) and off, at batch 1, a batch whose
    # last unit is ragged and whose units are not a multiple of the grid,
    # and the path's batch; each counts into the entry of its path
    planner_cpu = FftPlanner(np.complex64, device="cpu")  # recipes only
    core_m = {n: planner_cpu.plan_fft_forward(n).recipe.inner.length for n in CORE}
    for n, path_batch in CORE.items():
        m = core_m[n]
        key = "conv_chain_fft/" + {1009: "K6", 1234: "K13"}.get(n, str(n))
        radices = conv.chain_radices(m)
        unit = conv.chain_unit(m)
        # the blocks the grid of the checks without tables has
        index = torch.cuda.current_device()
        smem = conv.chain_smem_bytes(m, radices, m, m, False, False,
                                     conv.chain_tables_smem(index, m, radices, m, m, False, False))
        resident = conv.chain_resident(index, conv.chain_kernel_form(radices), smem)
        ragged = unit * (resident + 3) + 1
        for d in directions:
            n_blue = (m + 1) // 2  # a Bluestein of n_blue at inner m: ragged n_in and n_out
            chirp, h = bluestein_tables(n_blue, m, d)
            for tables_on in (False, True):
                if tables_on:
                    radices, tables = chain_tables(m, d, h, chirp, chirp)
                    n_io = n_blue
                else:
                    radices, tables = chain_tables(m, d, h)
                    n_io = m
                for batch in (1, ragged, path_batch):
                    x = signal(batch, n_io)
                    got = conv.conv_chain_fft(x, radices, tables, n_io, conj_out=tables_on)
                    torch.cuda.synchronize()
                    want = conv.conv_chain_fft_plain(x, radices, tables, n_io, tables_on)
                    note(key, got, want, f"conv_chain_fft m={m} {radices} unit {unit} n={n_io} "
                                         f"pre/post/conj={tables_on} batch={batch} {d.name}",
                         K7_TOL)
                    del x, got, want
        free()

    def two_pass_stages(x, m, d, tabs, batch_what, n_out, conj_out=False, x0=None,
                        full_out=False, gauss=False, in_shift=False, key="746497",
                        tol=TOL):
        """The two-pass core stage by stage, each kernel against its plain
        version (within tol) on the kernel's own input; tabs from
        radix_conv_tables(..., gauss).  in_shift: x and x0 are views x[:, 1:]
        and x[:, 0] of the raw Rader rows.  The default stages' errors count
        into the entries of `key` (a FOUR path) or of in_shift."""
        p, q = conv_radix.choose_split(m)
        col = card_tables(tabs["col"])
        row = card_tables(tabs["row"])
        t = {k: None if tabs[k] is None else torch.from_numpy(tabs[k]).to(dev)
             for k in ("h", "pre", "post", "perm", "scatter")}
        key = "in_shift" if in_shift else key
        col_name, row_name = (("conv_col_stage_gauss", "conv_row_stage_gauss") if gauss
                              else (f"conv_col_stage/{key}", f"conv_row_stage/{key}"))
        form = f"{'Gauss form ' if gauss else ''}{'in_shift ' if in_shift else ''}"
        a, part = conv_radix.conv_col_stage(x, p, q, col, pre=t["pre"], perm=t["perm"],
                                            emit_sum=full_out, gauss=gauss)
        torch.cuda.synchronize()
        a_p, part_p = conv_radix.conv_col_stage_plain(x, p, q, col, t["pre"], t["perm"], full_out,
                                                      gauss)
        note(col_name, a, a_p, f"conv_col_stage pass 1 {form}{batch_what} {d.name}", tol)
        if full_out:
            check(f"conv_col_stage partial sums {form}{batch_what} {d.name}", rel_err(part, part_p),
                  tol)
        z = conv_radix.conv_row_stage(a, q, p, row, m, h=t["h"], gauss=gauss)
        torch.cuda.synchronize()
        note(row_name, z, conv_radix.conv_row_stage_plain(a, q, p, row, m, h=t["h"], gauss=gauss),
             f"conv_row_stage pass 1 {form}{batch_what} {d.name}", tol)
        b, _ = conv_radix.conv_col_stage(z, p, q, col, gauss=gauss)
        torch.cuda.synchronize()
        note(col_name, b, conv_radix.conv_col_stage_plain(z, p, q, col, gauss=gauss)[0],
             f"conv_col_stage pass 2 {form}{batch_what} {d.name}", tol)
        kw = dict(conj_out=conj_out, post=t["post"], x0=x0, scatter=t["scatter"],
                  partials=part if full_out else None, gauss=gauss)
        out = conv_radix.conv_row_stage(b, q, p, row, n_out, **kw)
        torch.cuda.synchronize()
        note(row_name, out, conv_radix.conv_row_stage_plain(b, q, p, row, n_out, **kw),
             f"conv_row_stage pass 2 {form}{batch_what} {d.name}", tol)
        return out

    # the two-pass core: Rader 65537 (m = 65536, gathers, x0, sums and the
    # DC-first output fused) and Bluestein 7919 (m = 16384), in the default
    # form and the Gauss form, Rader also on the raw rows (in_shift)
    for d in directions:
        p_prime = 65537
        perm_in, inv_gather, b_fft = raders_tables(p_prime, d)
        x = signal(3, p_prime)
        for gauss, in_shift in ((False, False), (True, False), (False, True), (True, True)):
            tabs = conv_radix.radix_conv_tables(p_prime - 1, d, h=b_fft, in_perm=perm_in - 1,
                                                out_perm=inv_gather, gauss=gauss)
            src, x0 = ((x[:, 1:], x[:, 0]) if in_shift
                       else (x[:, 1:].contiguous(), x[:, 0].contiguous()))
            out = two_pass_stages(src, p_prime - 1, d, tabs, "m=65536 Rader batch=3",
                                  p_prime - 1, conj_out=True, x0=x0, full_out=True, gauss=gauss,
                                  in_shift=in_shift, tol=TOL if gauss else K7_TOL)
            check(f"Rader 65537 two-pass core gauss={gauss} in_shift={in_shift} vs float64 "
                  f"oracle {d.name}",
                  rel_err(out.cpu().to(torch.complex128),
                          torch.from_numpy(host_dft(x.cpu().numpy(), d))))
        n, m = 7919, 16384
        chirp, h_fft = bluestein_tables(n, m, d)
        x = signal(3, n)
        for gauss in (False, True):
            tabs = conv_radix.radix_conv_tables(m, d, h=h_fft, pre=chirp, post=chirp, gauss=gauss)
            out = two_pass_stages(x, m, d, tabs, "m=16384 Bluestein 7919 batch=3", n,
                                  conj_out=True, gauss=gauss, tol=TOL if gauss else K7_TOL)
            check(f"Bluestein 7919 two-pass core gauss={gauss} vs float64 oracle {d.name}",
                  rel_err(out.cpu().to(torch.complex128),
                          torch.from_numpy(host_dft(x.cpu().numpy(), d))))
        # the four stages on the ragged tiles (K14's source and sink on K12's
        # kernels) within 1e-6 of plain at batch 1 and 3, as the main paths
        # run them: the Rader 746497 (m = 746496, Q = 2916: ragged column
        # tiles) and the Bluesteins 196613 (P = 243: ragged row tiles) and
        # 88589 (Q = 729); the Rader 17011 (m = 17010 = 243 x 70, ragged on
        # both axes, a direct-sum radix 7) counts into 746497's entries
        for n, batch in ((746497, 1), (746497, 3), (17011, 3), (196613, 1), (196613, 3),
                         (88589, 1), (88589, 3)):
            key = n if n in FOUR else 746497
            planned = FftPlanner(np.complex64, device="cuda").plan_fft_forward(n).recipe
            m = planned.inner.length
            if isinstance(planned, recipes.Raders):
                perm_in, inv_gather, b_fft = raders_tables(n, d)
                tabs = conv_radix.radix_conv_tables(m, d, h=b_fft, in_perm=perm_in - 1,
                                                    out_perm=inv_gather)
                x = signal(batch, n)
                out = two_pass_stages(x[:, 1:].contiguous(), m, d, tabs,
                                      f"m={m} Rader batch={batch}", m, conj_out=True,
                                      x0=x[:, 0].contiguous(), full_out=True, key=key,
                                      tol=K7_TOL)
            else:
                chirp, h_fft = bluestein_tables(n, m, d)
                tabs = conv_radix.radix_conv_tables(m, d, h=h_fft, pre=chirp, post=chirp)
                x = signal(batch, n)
                out = two_pass_stages(x, m, d, tabs, f"m={m} Bluestein batch={batch}", n,
                                      conj_out=True, key=key, tol=K7_TOL)
            check(f"{type(planned).__name__} {n} four stages batch={batch} vs float64 oracle "
                  f"{d.name}", rel_err(out.cpu().to(torch.complex128),
                                       torch.from_numpy(host_dft(x.cpu().numpy(), d))))
    for m, batch in ((1008, 257), (114688, 5), (permute.SMEM_ROW_MAX, 33),
                     (permute.SMEM_ROW_MAX + 1, 33)):
        idx = torch.from_numpy(permute.permutation_index(
            np.random.default_rng(m).permutation(m))).to(dev)
        x = signal(batch, m)
        got = permute.permute(x, idx)
        torch.cuda.synchronize()
        note("permute", got, permute.permute_plain(x, idx), f"permute m={m} batch={batch}")
    del x, got, out
    free()

    def top2f_tables(n, d):
        """(split, column-stage tables, row-stage tables) of large2f at n, on the card."""
        p1, p2, _, _, q = large2f.choose_split2f(n)
        r, t, wob, wm = large2f.col_tables(p1, p2, q, d)
        return (p1, p2, q), (on_card(r), on_card(t), *on_card([wob, wm])), \
            tuple(on_card(v) for v in large.row_tables(q, d))

    def top3f_tables(d):
        """(split, pass-1 tables, pass-2 tables with the j2 factor on and
        off, row-stage tables) of large3f at 2^26, on the card."""
        p1, p2, _, _, q = large3.choose_split3f(1 << 26)
        r, t, wob = large3.col_tables(p1, p2 * q, q, d)
        mids = []
        for factored in (True, False):
            roots, wos, wm = large3.p2_tables(p1, p2, q, d, factored)
            mids.append((*on_card([roots]), None if wos is None else on_card([wos])[0],
                         *on_card([wm])))
        return ((p1, p2, q), (on_card(r), on_card(t), on_card([wob])[0]), mids,
                tuple(on_card(v) for v in large.row_tables(q, d)))

    # the top band at batch 1: large2f's column stage at each split and the
    # row stage after it, the column stage (K10's cluster kernel) also at a
    # batch that leaves its walk of clusters ragged; large3f's pass 1, pass 2
    # (j2 factor on and off) and the row stage at P = 16384
    for n in [m for m in TOP if m < 1 << 26]:
        p1, p2, _, _, q = large2f.choose_split2f(n)
        p = p1 * p2
        c = large2f.cluster_form(p, p1, q)
        resident = large2f.max_active_clusters(p)
        print(f"  cudaOccupancyMaxActiveClusters of large2f's cluster kernel at P={p}: {resident} "
              f"clusters of {c}", flush=True)
        tiles = q // large2f.CLUSTER_COLS
        # a batch whose units leave the last round of clusters part-full
        # (none where the resident clusters divide every batch's units)
        ragged = next((b for b in range(2, 64) if b * tiles % resident), 3)
        for batch in (1, ragged):
            x = signal(batch, n)
            for d in directions:
                (p1, p2, q), col, row = top2f_tables(n, d)
                a = large2f.large2f_col_stage(x, p1, p2, q, col)
                torch.cuda.synchronize()
                note(f"large2f_col_stage/{tag(n)}", a,
                     large2f.large2f_col_stage_plain(x, p1, p2, q, col),
                     f"large2f_col_stage n={tag(n)} P={p1}x{p2} {large.stage_radices(p)} on "
                     f"clusters of {c}, {large2f.cluster_grid(batch * tiles, resident)} "
                     f"clusters, {batch * tiles} units, batch={batch} {d.name}", PAIR_TOL)
                if batch == 1:
                    y = large.large_row_stage(a, q, p, row)
                    torch.cuda.synchronize()
                    note(f"large_row_stage/{tag(n)}", y, large.large_row_stage_plain(a, q, p, row),
                         f"large_row_stage n={tag(n)} Q={q} P={p} batch=1 {d.name}")
            del x, a
            free()
    x = signal(1, 1 << 26)
    for d in directions:
        (p1, p2, q), col, mids, row = top3f_tables(d)
        a = large3.large3_col_stage(x, p1, p2 * q, q, col)
        torch.cuda.synchronize()
        note("large3_col_stage/2^26", a, large3.large3_col_stage_plain(x, p1, p2 * q, q, col),
             f"large3_col_stage n=2^26 P1={p1} M={p2 * q} batch=1 {d.name}")
        for tabs, onoff in zip(mids, ("on", "off")):
            b = large3.large3_p2(a, p1, p2, q, tabs)
            torch.cuda.synchronize()
            note("large3_p2/2^26", b, large3.large3_p2_plain(a, p1, p2, q, tabs),
                 f"large3_p2 n=2^26 P2={p2} j2 factor {onoff} batch=1 {d.name}")
        b = large3.large3_p2(a, p1, p2, q, mids[0])
        y = large.large_row_stage(b, q, p1 * p2, row)
        torch.cuda.synchronize()
        note("large_row_stage/2^26", y, large.large_row_stage_plain(b, q, p1 * p2, row),
             f"large_row_stage n=2^26 Q={q} P={p1 * p2} batch=1 {d.name}")
    del x, a, b, y
    free()

    # the one-pass mid band at batch 2: radix_fft at every r, two_stage_fft
    # at the band's shapes (16384 on the radix body, the others on the
    # general in-place kernel, 14464 with a prime p = 113), three_stage_fft
    # at K8's split
    print("  cudaOccupancyMaxActiveClusters of radix_fft: " + ", ".join(
        f"r={r} {fused.radix_max_active_clusters(r)}" for r in (2, 4, 8, 16)), flush=True)
    for n in (1 << 15, 1 << 16, 1 << 17, 1 << 18, 16384, 20480, 24576, *ONE):
        x = signal(2, n)
        for d in directions:
            name, kernel, plain, _ = mid_kernel(n, d)
            got = kernel(x)
            torch.cuda.synchronize()
            note(name, got, plain(x), f"{name.split('/')[0]} n={n} batch=2 {d.name}",
                 K7_TOL if name.startswith("two_stage") else TOL)
    # the radix body's persistent walk at 3 x the resident clusters + 1 (a
    # second and third pass, the overlapped loads and a remainder); R = 1
    # at 16384
    for n in (1 << 15, 1 << 16, 1 << 17, 1 << 18, 16384):
        r = n // (128 * 128)
        batch = 3 * fused.radix_max_active_clusters(r) + 1
        x = signal(batch, n)
        for d in directions:
            name, kernel, plain, _ = mid_kernel(n, d)
            got = kernel(x)
            torch.cuda.synchronize()
            note(name, got, plain(x), f"{name.split('/')[0]} n={n} batch={batch} {d.name}",
                 K7_TOL if name.startswith("two_stage") else TOL)
    x = signal(2, 16384)
    for d in directions:
        tabs = card_tables(fused.two_stage_tables(128, (8, 16), d))
        got = fused.three_stage_fft(x, 128, 8, 16, tabs)
        torch.cuda.synchronize()
        note("three_stage_fft/16384", got, fused.three_stage_fft_plain(x, 128, 8, 16, tabs),
             f"three_stage_fft n=16384 (128, 8, 16) batch=2 {d.name}")
    del x, got
    free()

    # K7's cluster band at batch 2: two_stage_cluster_fft at every path's n,
    # at 32896 (257 x 128 on 4 blocks: a prime p above 256 and ragged row
    # shares) and at 65792 (257 x 256 on 8), so that a Bluestein stage runs
    # on clusters of 2, 4, 8 and 16 blocks; at 29184 (228 = (19, 12) on 2)
    # and 132480 (345 = (23, 5, 3) on 16), a direct sum in the kernel's form
    # without a Bluestein stage, and at 40832 (319 = (29, 11) on 4), a
    # Bluestein stage before a direct sum; each n off the paths counts into
    # the entry of the path with its cluster size
    print("  cudaOccupancyMaxActiveClusters of two_stage_cluster_fft: " + ", ".join(
        f"c={c} {fused.two_stage_cluster_max_active_clusters(c)}" for c in fused.CLUSTER_SIZES),
        flush=True)
    for n in (*CLUSTER, 32896, 65792, 29184, 40832, 132480):
        x = signal(2, n)
        p, q = fused.choose_pq(n)
        c = fused.choose_cluster(n)
        key = n if n in CLUSTER else next(m for m in CLUSTER if fused.choose_cluster(m) == c)
        for d in directions:
            _, kernel, plain, _ = mid_kernel(n, d)
            got = kernel(x)
            torch.cuda.synchronize()
            note(f"two_stage_cluster_fft/{key}", got, plain(x),
                 f"two_stage_cluster_fft n={n} ({p} x {q}, {large.stage_radices(p)} x "
                 f"{large.stage_radices(q)}) on {c} blocks, row shares "
                 f"{sorted({hi - lo for lo, hi in fused.row_shares(p, c)})}, Bluestein lengths "
                 f"{fused.bluestein_ms(large.stage_radices(p))} batch=2 {d.name}", K7_TOL)
    del x, got
    free()

    # the last three tiers: dense_fft in both forms (5 and 127 count into
    # the 127 entry, 251 and 1009 into the 251 one); large_pad's stages with
    # a ragged last tile on both axes; the fused large Bluestein's kernels at
    # both inner lengths (746497 counts into the 1000003 entries unless it
    # is a path of its own)
    for n in (5, 23, 127, 251, 1009):
        x = signal(300, n)
        for d in directions:
            for variant in dense.VARIANTS:
                tabs = dense_card(n, d, variant)
                got = dense.dense_fft(x, tabs, variant)
                torch.cuda.synchronize()
                pair = dense.pair_form(n, variant)
                note(f"dense_fft/{5 if n == 5 else 23}", got,
                     dense.dense_fft_plain(x, tabs, variant),
                     f"dense_fft n={n} {variant} batch=300 {d.name}", PAIR_TOL if pair else TOL)
    # K5's pair kernel (the block form at 5 and 23) at batches 1 and 3 and at
    # a batch that leaves its persistent walk ragged
    for n in DENSE_PRODUCT:
        blocks = dense.resident_blocks(n)
        ragged = blocks * dense.pair_rows(n) + 3
        print(f"  dense_pair_kernel<{n}>: {blocks} resident blocks, "
              f"{dense.pair_rows(n)} rows a tile", flush=True)
        for batch in (1, 3, ragged):
            x = signal(batch, n)
            for d in directions:
                tabs = dense_card(n, d, "block")
                got = dense.dense_fft(x, tabs, "block")
                torch.cuda.synchronize()
                note(f"dense_fft/{n}", got, dense.dense_fft_plain(x, tabs, "block"),
                     f"dense_fft n={n} block (pair form) on "
                     f"{dense.pair_grid(batch, n, blocks)} blocks, batch={batch} {d.name}",
                     PAIR_TOL)
    # K5's chain form within 1e-6: one Bluestein stage at M = 64, 256, 512
    for n in DENSE:
        x = signal(300, n)
        for d in directions:
            table = torch.from_numpy(dense.chain_table(n, d)).to(dev)
            got = dense.dense_chain_fft(x, table)
            torch.cuda.synchronize()
            note(f"dense_chain_fft/{n}", got, dense.dense_chain_fft_plain(x, table),
                 f"dense_chain_fft n={n} Bluestein {lanepack.bluestein_stage_m(n)} width "
                 f"{lanepack.chain_width(n)} batch=300 {d.name}", K7_TOL)
    for n in PAD_CHECKS:
        x = signal(2, n)
        key = n if n in PAD else 412519
        for d in directions:
            p, q, col, row = pad_card(n, d)
            qt, pt = largepad.tile(p), largepad.tile(q)
            rp, rq = large.stage_radices(p), large.stage_radices(q)
            a = largepad.largepad_col_stage(x, p, q, col)
            torch.cuda.synchronize()
            note(f"largepad_col_stage/{key}", a, largepad.largepad_col_stage_plain(x, p, q, col),
                 f"largepad_col_stage n={n} P={p} {rp} Bluestein {fused.bluestein_ms(rp)} Q={q} "
                 f"tile {qt} (last {q % qt or qt}) batch=2 {d.name}", K7_TOL)
            y = largepad.largepad_row_stage(a, q, p, row)
            torch.cuda.synchronize()
            note(f"largepad_row_stage/{key}", y, largepad.largepad_row_stage_plain(a, q, p, row),
                 f"largepad_row_stage n={n} Q={q} {rq} Bluestein {fused.bluestein_ms(rq)} P={p} "
                 f"tile {pt} (last {p % pt or pt}) batch=2 {d.name}", K7_TOL)
    # the fused large Bluestein: the tile form's kernels within 1e-6 of
    # plain at batch 1 and 3 at every Q of convlarge.COLUMN_FORMS (the BLUE
    # paths' and K15_CHECKS'), on 746497's Bluestein inner (m = 1572864),
    # and the general form's at 24571 (m = 49152)
    for n, m, batches in ((1000003, 1 << 21, (1, 3)),
                          *((n, m, (1, 3)) for n, (m, _) in BLUE.items() if n != 1000003),
                          *((n, None, (1, 3)) for n in K15_CHECKS if n != 746497),
                          (746497, routed_bluestein_inner(746497, np.complex64), (2,)),
                          (24571, 49152, (2,))):
        m = m or FftPlanner(np.complex64, device="cuda").plan_fft_forward(n).recipe.inner.length
        key = K15_CHECKS.get(n, n)
        for batch, d in ((b, d) for b in batches for d in directions):
            x = signal(batch, n)
            p, q, col, row, pre, h, chirp = bconv_card(n, m, d)
            what = f"n={n} m={m} P={p} Q={q} batch={batch} {d.name}"
            if convlarge.tile_form(p, q):
                trow, th, touter = bconv_tile_card(n, m, d, col)
                a = convlarge.bconv_col_tile(x, p, q, col, pre)
                torch.cuda.synchronize()
                note(f"bconv_col_tile/{key}", a, convlarge.bconv_col_tile_plain(x, p, q, col, pre),
                     f"bconv_col_tile (kernel A) {what}", K7_TOL)
                b = convlarge.bconv_row_tile(a, q, p, trow, th, touter)
                torch.cuda.synchronize()
                note(f"bconv_row_tile/{key}", b,
                     convlarge.bconv_row_tile_plain(a, q, p, trow, th, touter),
                     f"bconv_row_tile (B_conv) {convlarge.COLUMN_FORMS[q]} {what}", K7_TOL)
                out = convlarge.bconv_out_tile(b, p, q, col[:2], chirp, n)
                torch.cuda.synchronize()
                note(f"bconv_out_tile/{key}", out,
                     convlarge.bconv_out_tile_plain(b, p, q, col[:2], chirp, n),
                     f"bconv_out_tile (A2) {what}", K7_TOL)
            else:
                a, _ = conv_radix.conv_col_stage(x, p, q, col, pre=pre, general=True)
                torch.cuda.synchronize()
                note("conv_col_stage/24571", a,
                     conv_radix.conv_col_stage_plain(x, p, q, col, pre, general=True)[0],
                     f"conv_col_stage (kernel A) {what}")
                b = convlarge.bconv_row_stage(a, q, p, row, h, col[2])
                torch.cuda.synchronize()
                note("bconv_row_stage/24571", b,
                     convlarge.bconv_row_stage_plain(a, q, p, row, h, col[2]),
                     f"bconv_row_stage {what}")
                out = convlarge.bconv_out_stage(b, p, q, col[:2], chirp, n)
                torch.cuda.synchronize()
                note("bconv_out_stage/24571", out,
                     convlarge.bconv_out_stage_plain(b, p, q, col[:2], chirp, n),
                     f"bconv_out_stage {what}")
            check(f"fused large Bluestein {what} vs float64 oracle",
                  rel_err(out.cpu().to(torch.complex128),
                          torch.from_numpy(host_dft(x.cpu().numpy(), d))))
            del x, a, b, out
            free()

    # K14's cluster passes at 65537 x 1 and x 3 (the Rader core: gather,
    # sums, scatter, full_out) and the Bluestein core at 7919 x 1 and x 5,
    # 65521 x 1 and x 3 (r = 8) and 131071 x 1 and x 2 (r = 16), within
    # 1e-6 of plain, with the result against the float64 oracle
    for n, batches in ((65537, (1, 3)), (7919, (1, 5)), (65521, (1, 3)), (131071, (1, 2))):
        for batch, d in ((b, d) for b in batches for d in directions):
            m, r, radix, kw1, kw2, n_in, n_out = cluster_card(n, d)
            x = signal(batch, n_in)
            what = f"n={n} m={m} (r = {r}) batch={batch} {d.name}"
            z, part = conv_radix.conv_radix_pass1(x, m, radix, **kw1)
            torch.cuda.synchronize()
            z_p, part_p = conv_radix.conv_radix_pass1_plain(x, m, r, radix, kw1["h"],
                                                            kw1.get("pre"), kw1.get("perm"),
                                                            kw1.get("emit_sum", False))
            note(f"conv_radix_pass1/{n}", z, z_p, f"conv_radix_pass1 {what}", K7_TOL)
            if part is not None:
                check(f"conv_radix_pass1 partial sums {what}", rel_err(part, part_p), K7_TOL)
                check(f"conv_radix_pass1 partial sums {what} vs sum(x)",
                      rel_err(part.sum(dim=1), x.sum(dim=1)))
                kw2 = dict(kw2, x0=signal(batch, 1).reshape(-1), partials=part)
            y = conv_radix.conv_radix_pass2(z, m, radix, n_out, **kw2)
            torch.cuda.synchronize()
            note(f"conv_radix_pass2/{n}", y,
                 conv_radix.conv_radix_pass2_plain(z, m, r, radix, n_out, **kw2),
                 f"conv_radix_pass2 {what}", K7_TOL)
            if n != 65537:  # the Bluestein core is the whole transform
                check(f"Bluestein {n} cluster passes {what} vs float64 oracle",
                      rel_err(y.cpu().to(torch.complex128),
                              torch.from_numpy(host_dft(x.cpu().numpy(), d))))
            del x, z, part, y
            free()

    # ---- phase 3: the main path through the public entry ----
    print(f"phase 3: main path, FftPlanner(np.complex64, device='cuda') (t = "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    counters = {"lanepack_pipe_fft": lanepack.lanepack_pipe_fft,
                "lanepack_chain_fft": lanepack.lanepack_chain_fft,
                "large_col_stage": large.large_col_stage,
                "large_row_stage": large.large_row_stage,
                "conv_fft": conv.conv_fft,
                "conv_chain_fft": conv.conv_chain_fft,
                "conv_col_stage": conv_radix.conv_col_stage,
                "conv_row_stage": conv_radix.conv_row_stage,
                "permute": permute.permute,
                "large2f_col_stage": large2f.large2f_col_stage,
                "large3_col_stage": large3.large3_col_stage,
                "large3_p2": large3.large3_p2,
                "radix_fft": fused.radix_fft,
                "two_stage_fft": fused.two_stage_fft,
                "two_stage_cluster_fft": fused.two_stage_cluster_fft,
                "three_stage_fft": fused.three_stage_fft,
                "dense_fft": dense.dense_fft,
                "dense_chain_fft": dense.dense_chain_fft,
                "largepad_col_stage": largepad.largepad_col_stage,
                "largepad_row_stage": largepad.largepad_row_stage,
                "bconv_row_stage": convlarge.bconv_row_stage,
                "bconv_out_stage": convlarge.bconv_out_stage,
                "bconv_col_tile": convlarge.bconv_col_tile,
                "bconv_row_tile": convlarge.bconv_row_tile,
                "bconv_out_tile": convlarge.bconv_out_tile,
                "conv_radix_pass1": conv_radix.conv_radix_pass1,
                "conv_radix_pass2": conv_radix.conv_radix_pass2,
                "large_col_stage_gauss": large.large_col_stage_gauss,
                "large_row_stage_gauss": large.large_row_stage_gauss,
                "conv_col_stage_gauss": conv_radix.conv_col_stage_gauss,
                "conv_row_stage_gauss": conv_radix.conv_row_stage_gauss}
    planner = FftPlanner(np.complex64, device="cuda")
    assert route(4096, np.complex64) == "lanepack" and route(1 << 20, np.complex64) == "large"
    assert [route(n, np.complex64) for n in TOP] == ["large2f"] * 4 + ["large3f"]
    assert [route(n, np.complex64) for n in MID] == ["two_stage"] * 2 + ["radix"] * 4
    assert [route(n, np.complex64) for n in CLUSTER] == ["two_stage"] * len(CLUSTER)
    assert [route(n, np.complex64) for n in ONE] == ["two_stage"] * len(ONE)
    assert [route(n, np.complex64) for n in {**DENSE, **DENSE_PRODUCT}] == ["dense"] * 5
    assert [route(n, np.complex64) for n in LANE] == ["lanepack"] * len(LANE)
    assert [route(n, np.complex64) for n in PAD] == ["large_pad"] * len(PAD)
    assert route(10 ** 6, np.complex64) == "large"
    # the fused large Bluestein's tile form (1000003) and its general form
    # (24571); the two-pass core's cluster passes (65537, 7919)
    k15 = {"bconv_col_tile": 1, "bconv_row_tile": 1, "bconv_out_tile": 1}
    k15_general = {"conv_col_stage": 1, "bconv_row_stage": 1, "bconv_out_stage": 1}
    k14 = {"conv_radix_pass1": 1, "conv_radix_pass2": 1}
    for n, (m, _) in BLUE.items():
        recipe = planner.plan_fft_forward(n).recipe
        assert isinstance(recipe, recipes.Bluesteins) and recipe.inner.length == m, recipe
        assert executor.build(recipe, FftDirection.FORWARD, np.complex64).__module__ == \
            convlarge.__name__

    four = {"conv_col_stage": 2, "conv_row_stage": 2}
    for n in FOUR:
        recipe = planner.plan_fft_forward(n).recipe
        m = recipe.inner.length
        assert isinstance(recipe, (recipes.Raders, recipes.Bluesteins)), recipe
        assert (conv_radix.radix_conv_supported(m, np.complex64) and conv_radix.cluster_form(m)
                is None and not convlarge.bconv_supported(m, np.complex64)), (n, m)
    main_launches = {name: 0 for name in counters}
    path_launches = {}

    def oracle_rows(x, got, direction, what):
        rows = 1 if x.shape[-1] >= 1 << 23 else 4
        ref = host_dft(x[:rows].cpu().numpy(), direction)
        out = got[:rows].cpu().numpy().astype(np.complex128)
        check(f"{what} vs float64 oracle ({rows} row{'s' if rows > 1 else ''})",
              float(np.mean(np.abs(out - ref)) / np.mean(np.abs(ref))))

    paths = (
        (4096, 8, {"lanepack_pipe_fft": 1}),
        (4096, 16384, {"lanepack_pipe_fft": 1}),
        *((n, batch, {"lanepack_chain_fft": 1}) for n, batch in LANE.items()),
        (1 << 20, 1024, {"large_col_stage": 1, "large_row_stage": 1}),
        *((n, batch, {"conv_chain_fft": 1, **({"permute": 2} if core_m[n] == n - 1 else {})})
          for n, batch in CORE.items()),
        (7919, 4096, k14), (7919, 1, k14), (7919, 5, k14),
        (65537, 512, k14), (65537, 1, k14), (65537, 3, k14),
        (65521, 512, k14), (65521, 3, k14), (131071, 256, k14), (131071, 3, k14),
        *((n, batch, {"large2f_col_stage": 1, "large_row_stage": 1} if n < 1 << 26 else
           {"large3_col_stage": 1, "large3_p2": 1, "large_row_stage": 1})
          for n, batch in TOP.items()),
        *((n, batch, {"radix_fft" if n >= 1 << 15 else "two_stage_fft": 1})
          for n, batch in MID.items()),
        *((n, batch, {"two_stage_fft": 1}) for n, batch in ONE.items()),
        *((n, batch, {"two_stage_cluster_fft": 1}) for n, batch in CLUSTER.items()),
        *((n, batch, {"dense_chain_fft": 1}) for n, batch in DENSE.items()),
        *((n, batch, {"dense_fft": 1}) for n, batch in DENSE_PRODUCT.items()),
        *((n, batch, {"largepad_col_stage": 1, "largepad_row_stage": 1})
          for n, batch in PAD.items()),
        *((n, batch, k15) for n, (_, batch) in BLUE.items()),
        *((n, batch, k15) for n in BLUE for batch in (1, 3)),
        (24571, 2048, k15_general),
        *((n, batch, four) for n, batch in FOUR.items()),
    )

    def drive(key, n, batch, expected, fwd, inv, what, same_as=None):
        """fwd and inv through run_counted, each against the float64 oracle
        and torch.fft, and the round trip; same_as(direction, rows): the
        output the default path gives for those rows, which fwd's and inv's
        must equal bit for bit."""
        x = signal(batch, n)
        y = run_counted(counters, lambda: fwd(x), expected, f"forward {what}",
                        (main_launches, path_launches.setdefault(key, {})))
        if y.shape != x.shape or y.dtype != torch.complex64 or y.device != x.device:
            raise AssertionError(f"{what}: output {tuple(y.shape)} {y.dtype} on {y.device}")
        if not bool(torch.isfinite(torch.view_as_real(y)).all()):
            raise AssertionError(f"{what}: non-finite output")
        oracle_rows(x, y, FftDirection.FORWARD, f"forward {what}")
        check(f"forward {what} vs torch.fft",
              rel_err_chunked(y, lambda i, j: torch.fft.fft(x[i:j])))
        z = run_counted(counters, lambda: inv(y), expected, f"inverse {what}",
                        (main_launches, path_launches.setdefault(key, {})))
        oracle_rows(y, z, FftDirection.INVERSE, f"inverse {what}")
        check(f"inverse {what} vs torch.fft",
              rel_err_chunked(z, lambda i, j: torch.fft.ifft(y[i:j]) * n))
        check(f"round trip / n {what} vs input", rel_err_chunked(z, lambda i, j: x[i:j] * n))
        if same_as is not None:
            for d, inp, out in ((FftDirection.FORWARD, x, y), (FftDirection.INVERSE, y, z)):
                if not torch.equal(out[:64], same_as(d, inp[:64])):
                    raise AssertionError(f"{what} {d.name}: differs from the default path")
            print(f"  {what}: bit-equal to the default path on 64 rows", flush=True)
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB (t = "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        del x, y, z
        free()
        torch.cuda.reset_peak_memory_stats()

    for n, batch, expected in paths:
        fwd = planner.plan_fft_forward(n)
        inv = planner.plan_fft_inverse(n)
        drive(n, n, batch, expected, fwd.process, inv.process,
              f"n={n} batch={batch} ({type(fwd.recipe).__name__})")

    # the switched paths: each switch set just before its plans are made and
    # set back after; with every switch on, the routes the switches must not
    # reach launch their default kernels
    every = dict(large_gauss=True, large_blocks2d=True, conv_radix_gauss=True,
                 rader_in_shift=True)
    gauss4 = {"conv_col_stage_gauss": 2, "conv_row_stage_gauss": 2}
    default_large = {"large_col_stage": 1, "large_row_stage": 1}

    def default_2_20(d, rows):
        return large.make_large_fft_fn(1 << 20, d, np.complex64, gauss=False,
                                       blocks2d=False)(rows)

    switched_paths = (
        ("gauss", 1 << 20, 1024, {"large_col_stage_gauss": 1, "large_row_stage_gauss": 1},
         dict(large_gauss=True), None),
        ("blocks2d", 1 << 20, 1024, default_large, dict(large_blocks2d=True), default_2_20),
        ("in_shift", 65537, 512, {"conv_col_stage": 2, "conv_row_stage": 2},
         dict(rader_in_shift=True), None),
        ("gauss", 65537, 512, gauss4, dict(conv_radix_gauss=True), None),
        ("in_shift+gauss", 65537, 512, gauss4, dict(rader_in_shift=True, conv_radix_gauss=True),
         None),
        ("gauss", 7919, 4096, gauss4, dict(conv_radix_gauss=True), None),
        ("every switch", 15625, 4096, {"largepad_col_stage": 1, "largepad_row_stage": 1}, every,
         None),
        ("every switch", 1000003, 64, k15, every, None),
        ("every switch", 1 << 23, 8, {"large2f_col_stage": 1, "large_row_stage": 1}, every, None),
        ("every switch", 1 << 26, 2, {"large3_col_stage": 1, "large3_p2": 1, "large_row_stage": 1},
         every, None),
    )
    for tag_, n, batch, expected, switches, same_as in switched_paths:
        fwd, inv = switched(config, switches, lambda: (planner.plan_fft_forward(n),
                                                       planner.plan_fft_inverse(n)))
        drive(f"{n} {tag_}", n, batch, expected, fwd.process, inv.process,
              f"n={n} batch={batch} {tag_} ({type(fwd.recipe).__name__})", same_as)
    fwd, inv = (large.make_large_fft_fn(1 << 20, d, np.complex64, deep_a=True) for d in directions)
    drive(f"{1 << 20} deep_a", 1 << 20, 1024, default_large, fwd, inv,
          "n=1048576 batch=1024 make_large_fft_fn(deep_a=True)", default_2_20)
    # the parent form of the one-pass core where it still serves, through
    # executor.build: Raders(928) and Bluesteins(1234, 3712)
    for tag_, (n, m) in CONV_FFT_PATHS.items():
        recipe = (recipes.Raders(recipes.Dft(m)) if m == n - 1
                  else recipes.Bluesteins(n, recipes.Dft(m)))
        fwd, inv = (executor.build(recipe, d, np.complex64) for d in directions)
        drive(f"conv_fft {tag_}", n, 8192,
              {"conv_fft": 1, **({"permute": 2} if m == n - 1 else {})}, fwd, inv,
              f"n={n} batch=8192 {recipe!r}")
    print(f"  launches on the main paths: {main_launches}", flush=True)
    for name, count in main_launches.items():
        if count == 0 and name not in NOT_ROUTED:
            raise AssertionError(f"{name} was not launched on the main paths")

    # ---- phase 4: times ----
    print(f"phase 4: times on {card} (CUDA events, median of 7; t = "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    results = {}

    def record(name, k, plain, nbytes, flops, library=None):
        """A kernel's times at its path's shape, with its bound from this
        run's bytes and operations and the one-call PyTorch time, if any."""
        bound_ms, bound_by = bound(nbytes, flops)
        results[name] = {"ms": k, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library}
        print(f"  {name}: kernel {k:.3f} ms, plain {plain:.3f} ms, bound {bound_ms:.3f} ms "
              f"({bound_by}), library "
              f"{'none' if library is None else f'{library:.3f} ms'} (t = "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)

    # K1: the pipelined kernel at the main path's shape (and the chain
    # kernel on the same chain, the design it replaced at 4096), then the
    # chain kernel at each of its paths; each against its plain version,
    # its bound (with the operations its chain spends, chain_ops) and
    # torch.fft
    for n, batch in ((4096, 16384), *LANE.items()):
        x = signal(batch, n)
        radices = lanepack.choose_radices(n)
        tables = card_tables(lanepack.chain_tables(n, radices, FftDirection.FORWARD))
        name = ("lanepack_pipe_fft" if radices == lanepack.PIPE_RADICES
                else f"lanepack_chain_fft/{n}")
        note(name, lanepack.lanepack_fft(x, radices, tables),
             lanepack.lanepack_fft_plain(x, radices, tables),
             f"{name} n={n} {radices} batch={batch} (the main path's shape)", K7_TOL)
        free()
        k = median_ms(lambda: lanepack.lanepack_fft(x, radices, tables))
        plain = median_ms(lambda: lanepack.lanepack_fft_plain(x, radices, tables))
        ref = median_ms(lambda: torch.fft.fft(x))
        plan = planner.plan_fft_forward(n)
        path = median_ms(lambda: plan.process(x))
        extra = ""
        if name == "lanepack_pipe_fft":
            general = median_ms(lambda: lanepack.lanepack_chain_fft(x, radices, tables))
            extra = f"; the chain kernel on the same chain {general:.3f} ms"
        print(f"  {name} n={n} {radices} batch={batch}: kernel {k:.3f} ms "
              f"({gflops(n, batch, k):.0f} GF/s){extra}; path {path:.3f} ms; torch.fft {ref:.3f} "
              f"ms; the chain's operations "
              f"{batch * n * chain_ops(radices, lanepack.bluestein_stage_m) / FP32_FLOPS * 1e3:.3f} "
              "ms at the FP32 peak", flush=True)
        record(name, k, plain, 16 * batch * n + table_bytes(tables), batch * fft_ops(n), ref)
        del x
        free()

    n = 1 << 20
    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    r, t, outer = large.col_tables(p, q, FftDirection.FORWARD)
    col = (on_card(r), on_card(t), torch.from_numpy(outer).to(dev))
    r, t = large.row_tables(q, FftDirection.FORWARD)
    row = (on_card(r), on_card(t))
    batch = 64  # the bench row: the plain versions' intermediates fit here
    x = signal(batch, n)
    a = large.large_col_stage(x, p, q, col)
    note("large_col_stage", a, large.large_col_stage_plain(x, p, q, col),
         f"large_col_stage n={n} P={p} batch={batch}")
    note("large_row_stage", large.large_row_stage(a, q, p, row),
         large.large_row_stage_plain(a, q, p, row), f"large_row_stage n={n} Q={q} batch={batch}")
    free()
    k = median_ms(lambda: large.large_col_stage(x, p, q, col))
    plain = median_ms(lambda: large.large_col_stage_plain(x, p, q, col))
    print(f"  large_col_stage n={n} P={p} batch={batch}:", flush=True)
    record("large_col_stage", k, plain, 16 * batch * n + 8 * n, batch * n * (fft_ops(p) / p + 6))
    k = median_ms(lambda: large.large_row_stage(a, q, p, row))
    plain = median_ms(lambda: large.large_row_stage_plain(a, q, p, row))
    lib = median_ms(lambda: torch.fft.fft(a, dim=1))
    print(f"  large_row_stage n={n} Q={q} {large.stage_radices(q)} batch={batch}:", flush=True)
    record("large_row_stage", k, plain, 16 * batch * n, batch * p * fft_ops(q), lib)
    # K4's Gauss stages at the same shape, against the default stages above
    gcol = card_tables(large.col_tables(p, q, FftDirection.FORWARD, gauss=True))
    grow = card_tables(large.row_tables(q, FftDirection.FORWARD, gauss=True))
    ga = large.large_col_stage_gauss(x, p, q, gcol)
    note("large_col_stage_gauss", ga, large.large_col_stage_gauss_plain(x, p, q, gcol),
         f"large_col_stage_gauss n={n} P={p} batch={batch}")
    note("large_row_stage_gauss", large.large_row_stage_gauss(ga, q, p, grow),
         large.large_row_stage_gauss_plain(ga, q, p, grow),
         f"large_row_stage_gauss n={n} Q={q} batch={batch}")
    free()
    for name, kernel, plain_fn, nbytes, ops, library in (
        ("large_col_stage_gauss", lambda: large.large_col_stage_gauss(x, p, q, gcol),
         lambda: large.large_col_stage_gauss_plain(x, p, q, gcol),
         16 * batch * n + 8 * n + table_bytes(gcol[:2]),
         batch * n * (gauss_ops(large.stage_radices(p)) + 6), None),
        ("large_row_stage_gauss", lambda: large.large_row_stage_gauss(ga, q, p, grow),
         lambda: large.large_row_stage_gauss_plain(ga, q, p, grow),
         16 * batch * n + table_bytes(grow), batch * n * gauss_ops(large.stage_radices(q)),
         lambda: torch.fft.fft(ga, dim=1)),
    ):
        k = median_ms(kernel)
        plain = median_ms(plain_fn)
        lib = None if library is None else median_ms(library)
        default_ms = results[name[:-len("_gauss")]]["ms"]
        print(f"  {name} n={n} batch={batch}: {k:.3f} ms against the default form's "
              f"{default_ms:.3f} ({k / default_ms:.2f}x); the Gauss form's operations "
              f"{ops / FP32_FLOPS * 1e3:.3f} ms at the FP32 peak, its bytes "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms:", flush=True)
        # the bound: the default stages' need (the same function)
        record(name, k, plain, nbytes, batch * (n * (fft_ops(p) / p + 6) if "col" in name
                                                 else p * fft_ops(q)), lib)
    del x, a, ga
    free()
    for batch in (64, 1024):
        x = signal(batch, n)
        plan = planner.plan_fft_forward(n)
        path = median_ms(lambda: plan.process(x), reps=5)
        ref = median_ms(lambda: torch.fft.fft(x), reps=5)
        print(f"  main path n={n} batch={batch}: {path:.3f} ms ({gflops(n, batch, path):.0f} GF/s); "
              f"torch.fft {ref:.3f} ms ({gflops(n, batch, ref):.0f} GF/s)", flush=True)
        del x
        free()

    # the one-pass core at the prime paths' shapes: the chain form at each
    # CORE path against its plain version, its bound and, at 1009 and 1234,
    # the parent form on the same inputs; the parent form where it serves
    # (m = 928 and 3712); two length-m transforms and the pointwise tables
    # (H; with a Bluestein's chirp also pre and post) per row
    def core_inputs(n, m, d, form):
        rader = m == n - 1
        h, pre = ((raders_tables(n, d)[2], None) if rader
                  else bluestein_tables(n, m, d)[::-1])
        radices, tables = form(m, d, h, pre, pre)
        return rader, (m if rader else n), radices, tables

    for n, batch in CORE.items():
        m = core_m[n]
        key = "conv_chain_fft/" + {1009: "K6", 1234: "K13"}.get(n, str(n))
        rader, n_io, radices, tables = core_inputs(n, m, FftDirection.FORWARD, chain_tables)
        x = signal(batch, n_io)
        note(key, conv.conv_chain_fft(x, radices, tables, n_io, not rader),
             conv.conv_chain_fft_plain(x, radices, tables, n_io, not rader),
             f"conv_chain_fft m={m} {radices} n={n_io} batch={batch} (the main path's shape)",
             K7_TOL)
        free()
        k = median_ms(lambda: conv.conv_chain_fft(x, radices, tables, n_io, not rader))
        plain = median_ms(lambda: conv.conv_chain_fft_plain(x, radices, tables, n_io, not rader))
        extra = ""
        if n in (1009, 1234):
            _, _, tile, parent_tables = core_inputs(n, m, FftDirection.FORWARD, conv_tables)
            parent = median_ms(lambda: conv.conv_fft(x, tile, parent_tables, n_io, not rader))
            extra = (f"; conv_fft at {tile} on the same inputs {parent:.3f} ms "
                     f"({parent / k:.2f}x the chain form's time)")
        spent = batch * m * 2 * chain_ops(radices, lambda r: None)
        on_chip = conv.chain_tables_smem(torch.cuda.current_device(), m, radices, n_io, n_io,
                                         not rader, not rader)
        print(f"  {key} m={m} {radices} n={n_io} batch={batch} unit {conv.chain_unit(m)} "
              f"tables on chip {on_chip}: the operations its chains spend "
              f"{spent / FP32_FLOPS * 1e3:.3f} ms at the FP32 "
              f"peak{extra}", flush=True)
        record(key, k, plain, 16 * batch * n_io + 8 * m * (1 if rader else 3),
               batch * (2 * fft_ops(m) + 6 * m * (1 if rader else 3)))
        del x
        free()
    for tag_, (n, m) in CONV_FFT_PATHS.items():
        key = f"conv_fft/{tag_}"
        rader, n_io, radices, tables = core_inputs(n, m, FftDirection.FORWARD, conv_tables)
        x = signal(8192, n_io)
        note(key, conv.conv_fft(x, radices, tables, n_io, not rader),
             conv.conv_fft_plain(x, m, radices, tables, n_io, not rader),
             f"conv_fft m={m} {radices} n={n_io} batch=8192 (where it serves)")
        k = median_ms(lambda: conv.conv_fft(x, radices, tables, n_io, not rader))
        plain = median_ms(lambda: conv.conv_fft_plain(x, m, radices, tables, n_io, not rader))
        print(f"  {key} m={m} {radices} n={n_io} batch=8192:", flush=True)
        record(key, k, plain, 16 * 8192 * n_io + 8 * m * (1 if rader else 3),
               8192 * (2 * fft_ops(m) + 6 * m * (1 if rader else 3)))
        del x
        free()
    idx = torch.from_numpy(permute.permutation_index(
        raders_tables(1009, FftDirection.FORWARD)[0] - 1)).to(dev)
    x = signal(8192, 1008)
    note("permute", permute.permute(x, idx), permute.permute_plain(x, idx),
         "permute m=1008 batch=8192 (the main path's shape)")
    k = median_ms(lambda: permute.permute(x, idx))
    plain = median_ms(lambda: permute.permute_plain(x, idx))
    lib = median_ms(lambda: torch.index_select(x, 1, idx))
    print("  permute m=1008 batch=8192 (Rader 1009 input gather):", flush=True)
    record("permute", k, plain, 16 * 8192 * 1008 + 4 * 1008, 0, lib)
    del x
    free()

    # the two-pass core's four stages (which 7919 and 65537 ran before their
    # cluster passes, and 746497 runs) at the Bluestein 7919 x 4096 shape,
    # against their plain versions
    n, m = 7919, 16384
    chirp, h_fft = bluestein_tables(n, m, FftDirection.FORWARD)
    tabs = conv_radix.radix_conv_tables(m, FftDirection.FORWARD, h=h_fft, pre=chirp, post=chirp)
    two_pass_stages(signal(4096, n), m, FftDirection.FORWARD, tabs,
                    "m=16384 Bluestein 7919 batch=4096 (the four stages)", n, conj_out=True)
    free()

    def middle_stages(a, z, p, q, col, row, h, batch, m, key):
        """The times of the four stages' middle launches, pass 1's row stage
        (conj(. * h)) and pass 2's plain column stage (K12's own), printed
        beside their bounds: neither has an entry of its own."""
        row1 = median_ms(lambda: conv_radix.conv_row_stage(a, q, p, row, m, h=h))
        col2 = median_ms(lambda: conv_radix.conv_col_stage(z, p, q, col))
        b1, _ = bound(16 * batch * m + 8 * m + table_bytes(row), batch * (p * fft_ops(q) + 6 * m))
        b2, _ = bound(16 * batch * m + 8 * m + table_bytes(col[:2]),
                      batch * m * (fft_ops(p) / p + 6))
        print(f"  {key}: pass 1's row stage {row1:.3f} ms (bound {b1:.3f}), pass 2's column "
              f"stage {col2:.3f} ms (bound {b2:.3f})", flush=True)

    def rader_stages(n, batch, key, in_shift=False):
        """The two-pass core's four stages of the Rader n at (batch, n) rows,
        each against its plain version within 1e-6, the result against the
        float64 oracle on 4 rows; pass 1's column stage (the gather and
        sums) and pass 2's row stage (the scatter, x0 and the DC-first
        output) timed as conv_col_stage/key and conv_row_stage/key.
        in_shift: pass 1 reads the raw rows.  Returns what the Gauss form's
        run reuses."""
        m = n - 1
        p, q = conv_radix.choose_split(m)
        perm_in, inv_gather, b_fft = raders_tables(n, FftDirection.FORWARD)
        tabs = conv_radix.radix_conv_tables(m, FftDirection.FORWARD, h=b_fft,
                                            in_perm=perm_in - 1, out_perm=inv_gather)
        col, row = card_tables(tabs["col"]), card_tables(tabs["row"])
        perm, scatter, h = (torch.from_numpy(tabs[k]).to(dev) for k in ("perm", "scatter", "h"))
        raw = signal(batch, n)
        x, x0 = ((raw[:, 1:], raw[:, 0]) if in_shift
                 else (raw[:, 1:].contiguous(), raw[:, 0].contiguous()))
        col_name, row_name = f"conv_col_stage/{key}", f"conv_row_stage/{key}"
        what = (f"m={m} P={p} Q={q} Rader batch={batch}{' in_shift' if in_shift else ''} "
                "(the main path's shape)")
        a, part = conv_radix.conv_col_stage(x, p, q, col, perm=perm, emit_sum=True)
        a_p, part_p = conv_radix.conv_col_stage_plain(x, p, q, col, None, perm, True)
        note(col_name, a, a_p, f"conv_col_stage pass 1 {what}", K7_TOL)
        check(f"conv_col_stage partial sums {what}", rel_err(part, part_p), K7_TOL)
        del a_p, part_p
        z = conv_radix.conv_row_stage(a, q, p, row, m, h=h)
        note(row_name, z, conv_radix.conv_row_stage_plain(a, q, p, row, m, h=h),
             f"conv_row_stage pass 1 {what}", K7_TOL)
        b, _ = conv_radix.conv_col_stage(z, p, q, col)
        note(col_name, b, conv_radix.conv_col_stage_plain(z, p, q, col)[0],
             f"conv_col_stage pass 2 {what}", K7_TOL)
        middle_stages(a, z, p, q, col, row, h, batch, m, key)
        del a, z
        kw = dict(conj_out=True, x0=x0, scatter=scatter, partials=part)
        out = conv_radix.conv_row_stage(b, q, p, row, m, **kw)
        note(row_name, out, conv_radix.conv_row_stage_plain(b, q, p, row, m, **kw),
             f"conv_row_stage pass 2 {what}", K7_TOL)
        check(f"Rader {n} four stages {what} vs float64 oracle (4 rows)",
              rel_err(out[:4].cpu().to(torch.complex128),
                      torch.from_numpy(host_dft(raw[:4].cpu().numpy(), FftDirection.FORWARD))))
        del out
        free()
        k = median_ms(lambda: conv_radix.conv_col_stage(x, p, q, col, perm=perm, emit_sum=True))
        plain = median_ms(lambda: conv_radix.conv_col_stage_plain(x, p, q, col, None, perm, True))
        print(f"  {col_name} m={m} P={p} batch={batch}, pass 1 with the Rader gather and sums:",
              flush=True)
        record(col_name, k, plain, 16 * batch * m + 12 * m + 8 * part.numel(),
               batch * m * (fft_ops(p) / p + 8))
        k = median_ms(lambda: conv_radix.conv_row_stage(b, q, p, row, m, **kw))
        plain = median_ms(lambda: conv_radix.conv_row_stage_plain(b, q, p, row, m, **kw))
        print(f"  {row_name} m={m} Q={q} batch={batch}, pass 2 with the scatter and full "
              "output:", flush=True)
        record(row_name, k, plain, 16 * batch * m + 4 * m + 16 * batch + 8 * part.numel(),
               batch * (p * fft_ops(q) + 2 * m))
        del b
        free()
        return raw, x, x0, p, q, col, perm, scatter, part, (perm_in, inv_gather, b_fft)

    def bluestein_stages(n, batch):
        """The two-pass core's four stages of the Bluestein n at (batch, n)
        rows (the planner's inner m), each against its plain version within
        1e-6, the result against the float64 oracle on 4 rows; pass 1's
        column stage (the chirp) and pass 2's row stage (post, n_out < m)
        timed as conv_col_stage/n and conv_row_stage/n."""
        m = planner.plan_fft_forward(n).recipe.inner.length
        p, q = conv_radix.choose_split(m)
        chirp, h_fft = bluestein_tables(n, m, FftDirection.FORWARD)
        tabs = conv_radix.radix_conv_tables(m, FftDirection.FORWARD, h=h_fft, pre=chirp,
                                            post=chirp)
        col, row = card_tables(tabs["col"]), card_tables(tabs["row"])
        h, pre, post = (torch.from_numpy(tabs[k]).to(dev) for k in ("h", "pre", "post"))
        x = signal(batch, n)
        col_name, row_name = f"conv_col_stage/{n}", f"conv_row_stage/{n}"
        what = f"m={m} P={p} Q={q} Bluestein batch={batch} (the main path's shape)"
        a, _ = conv_radix.conv_col_stage(x, p, q, col, pre=pre)
        note(col_name, a, conv_radix.conv_col_stage_plain(x, p, q, col, pre)[0],
             f"conv_col_stage pass 1 {what}", K7_TOL)
        z = conv_radix.conv_row_stage(a, q, p, row, m, h=h)
        note(row_name, z, conv_radix.conv_row_stage_plain(a, q, p, row, m, h=h),
             f"conv_row_stage pass 1 {what}", K7_TOL)
        b, _ = conv_radix.conv_col_stage(z, p, q, col)
        note(col_name, b, conv_radix.conv_col_stage_plain(z, p, q, col)[0],
             f"conv_col_stage pass 2 {what}", K7_TOL)
        kw = dict(conj_out=True, post=post)
        out = conv_radix.conv_row_stage(b, q, p, row, n, **kw)
        note(row_name, out, conv_radix.conv_row_stage_plain(b, q, p, row, n, **kw),
             f"conv_row_stage pass 2 {what}", K7_TOL)
        check(f"Bluestein {n} four stages {what} vs float64 oracle (4 rows)",
              rel_err(out[:4].cpu().to(torch.complex128),
                      torch.from_numpy(host_dft(x[:4].cpu().numpy(), FftDirection.FORWARD))))
        del out
        free()
        middle_stages(a, z, p, q, col, row, h, batch, m, n)
        del z
        free()
        k = median_ms(lambda: conv_radix.conv_col_stage(x, p, q, col, pre=pre))
        plain = median_ms(lambda: conv_radix.conv_col_stage_plain(x, p, q, col, pre))
        print(f"  {col_name} m={m} P={p} {large.stage_radices(p)} tile {largepad.tile(p)} "
              f"batch={batch}, pass 1 with the chirp:", flush=True)
        record(col_name, k, plain, 8 * batch * (n + m) + 16 * m + table_bytes(col[:2]),
               batch * m * (fft_ops(p) / p + 12))
        k = median_ms(lambda: conv_radix.conv_row_stage(b, q, p, row, n, **kw))
        plain = median_ms(lambda: conv_radix.conv_row_stage_plain(b, q, p, row, n, **kw))
        print(f"  {row_name} m={m} Q={q} {large.stage_radices(q)} tile {largepad.tile(q)} "
              f"batch={batch}, pass 2 with post and n_out = n:", flush=True)
        record(row_name, k, plain, 8 * batch * (m + n) + 8 * n + table_bytes(row),
               batch * (p * fft_ops(q) + 6 * n))
        del x, a, b
        free()

    # the two-pass core's four stages at the main path's Rader 746497 x 64
    # (m = 746496); at 65537 x 512 on the raw rows (the in_shift path), with
    # the copy of x[:, 1:] that in_shift saves, and in the Gauss form (its
    # paths' form) against in_shift's default stages
    rader_stages(746497, 64, "746497")
    free()
    for n, batch in FOUR.items():
        if n != 746497:
            bluestein_stages(n, batch)
    m, batch = 65536, 512
    raw, src, x0, p, q, col, perm, scatter, part, (perm_in, inv_gather, b_fft) = rader_stages(
        m + 1, batch, "in_shift", in_shift=True)
    copy = median_ms(lambda: src.contiguous())
    copied = median_ms(lambda: conv_radix.conv_col_stage(src.contiguous(), p, q, col, perm=perm,
                                                         emit_sum=True))
    print(f"  conv_col_stage in_shift m={m} batch={batch}: the copy of x[:, 1:] it saves "
          f"{copy:.3f} ms; copy and stage {copied:.3f} ms; on the raw rows "
          f"{results['conv_col_stage/in_shift']['ms']:.3f} ms", flush=True)
    what = f"m={m} Rader batch={batch} on the raw rows"
    gtabs = conv_radix.radix_conv_tables(m, FftDirection.FORWARD, h=b_fft, in_perm=perm_in - 1,
                                         out_perm=inv_gather, gauss=True)
    gcol, grow = card_tables(gtabs["col"]), card_tables(gtabs["row"])
    a, part = conv_radix.conv_col_stage_gauss(src, p, q, gcol, perm=perm, emit_sum=True)
    note("conv_col_stage_gauss", a,
         conv_radix.conv_col_stage_plain(src, p, q, gcol, None, perm, True, True)[0],
         f"conv_col_stage_gauss pass 1 {what}")
    kw = dict(conj_out=True, x0=x0, scatter=scatter, partials=part)
    note("conv_row_stage_gauss", conv_radix.conv_row_stage_gauss(a, q, p, grow, m, **kw),
         conv_radix.conv_row_stage_plain(a, q, p, grow, m, gauss=True, **kw),
         f"conv_row_stage_gauss pass 2 {what}")
    free()
    k = median_ms(lambda: conv_radix.conv_col_stage_gauss(src, p, q, gcol, perm=perm,
                                                          emit_sum=True))
    plain = median_ms(lambda: conv_radix.conv_col_stage_plain(src, p, q, gcol, None, perm, True,
                                                              True))
    print(f"  conv_col_stage_gauss m={m} batch={batch}: the default form "
          f"{results['conv_col_stage/in_shift']['ms']:.3f} ms; in the Gauss form:", flush=True)
    print(f"    the Gauss form's operations "
          f"{batch * m * (gauss_ops(large.stage_radices(p)) + 8) / FP32_FLOPS * 1e3:.3f} ms "
          "at the FP32 peak", flush=True)
    record("conv_col_stage_gauss", k, plain, 16 * batch * m + 12 * m + 8 * part.numel(),
           batch * m * (fft_ops(p) / p + 8))
    k = median_ms(lambda: conv_radix.conv_row_stage_gauss(a, q, p, grow, m, **kw))
    plain = median_ms(lambda: conv_radix.conv_row_stage_plain(a, q, p, grow, m, gauss=True, **kw))
    print(f"  conv_row_stage_gauss m={m} batch={batch}: the default form "
          f"{results['conv_row_stage/in_shift']['ms']:.3f} ms; in the Gauss form:", flush=True)
    print(f"    the Gauss form's operations "
          f"{batch * m * (gauss_ops(large.stage_radices(q)) + 2) / FP32_FLOPS * 1e3:.3f} ms "
          "at the FP32 peak", flush=True)
    record("conv_row_stage_gauss", k, plain, 16 * batch * m + 4 * m + 16 * batch + 8 * part.numel(),
           batch * (p * fft_ops(q) + 2 * m))
    del raw, src, x0, a, part, kw
    free()

    # every switched path against its default path and torch.fft (the
    # switches set while the plan is made), timed in turns: the default, each
    # variant, each variant again in reverse order, the default again
    for n, batch, variants in (
        (1 << 20, 1024, (("large_gauss", dict(large_gauss=True)),
                         ("large_blocks2d", dict(large_blocks2d=True)))),
        (65537, 512, (("rader_in_shift", dict(rader_in_shift=True)),
                      ("conv_radix_gauss", dict(conv_radix_gauss=True)),
                      ("rader_in_shift + conv_radix_gauss",
                       dict(rader_in_shift=True, conv_radix_gauss=True)),
                      ("rader_full_out off", dict(rader_full_out=False)))),
        (7919, 4096, (("conv_radix_gauss", dict(conv_radix_gauss=True)),)),
    ):
        x = signal(batch, n)
        reps = 5 if n > 65537 else 7
        fns = {"default": planner.plan_fft_forward(n).process}
        for name, switches in variants:
            fns[name] = switched(config, switches, lambda: planner.plan_fft_forward(n)).process
        if n == 1 << 20:
            fns["deep_a"] = large.make_large_fft_fn(n, FftDirection.FORWARD, np.complex64,
                                                    deep_a=True)
        order = list(fns) + list(fns)[::-1]
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(median_ms(lambda: fns[name](x), reps=reps))
        ref = median_ms(lambda: torch.fft.fft(x), reps=reps)
        print(f"  switched paths n={n} batch={batch}, in turns: " + "; ".join(
            f"{name} {t[0]:.3f} / {t[1]:.3f} ms ({gflops(n, batch, sum(t) / 2):.0f} GF/s)"
            for name, t in times.items()) + f"; torch.fft {ref:.3f} ms "
              f"({gflops(n, batch, ref):.0f} GF/s)", flush=True)
        del x, fns
        free()

    # every prime-path size against torch.fft
    for n, batch in ((1009, 8192), (1234, 8192), *CLUSTER_PRIMES.items()):
        x = signal(batch, n)
        plan = planner.plan_fft_forward(n)
        path = median_ms(lambda: plan.process(x))
        ref = median_ms(lambda: torch.fft.fft(x))
        print(f"  prime path n={n} batch={batch} ({type(plan.recipe).__name__}): {path:.3f} ms "
              f"({gflops(n, batch, path):.0f} GF/s); torch.fft {ref:.3f} ms "
              f"({gflops(n, batch, ref):.0f} GF/s)", flush=True)
        del x
        free()
    # 1234 three ways, each built through executor.build
    x = signal(8192, 1234)
    for what, recipe in (
        ("whole-n Bluestein m=3072", recipes.Bluesteins(1234, recipes.Dft(3072))),
        ("whole-n Bluestein m=2592", recipes.Bluesteins(1234, recipes.Dft(2592))),
        ("MixedRadix(2, Raders(617))",
         recipes.MixedRadix(recipes.Dft(2), recipes.Raders(recipes.Dft(616)))),
    ):
        fn = executor.build(recipe, FftDirection.FORWARD, np.complex64)
        check(f"1234 as {what} vs torch.fft", rel_err(fn(x), torch.fft.fft(x)))
        t = median_ms(lambda: fn(x))
        print(f"  1234 x 8192 as {what}: {t:.3f} ms ({gflops(1234, 8192, t):.0f} GF/s)", flush=True)
    del x
    free()

    # the top band at its paths' shapes: each kernel against its plain
    # version, then times; pass 1's achieved rate; each path against
    # torch.fft and its peak memory; 2^24 also through the recipe tree
    for n, batch in TOP.items():
        x = signal(batch, n)
        what = f"n={tag(n)} batch={batch} (the main path's shape)"
        if n < 1 << 26:
            (p1, p2, q), col, row = top2f_tables(n, FftDirection.FORWARD)
            p = p1 * p2
            name = f"large2f_col_stage/{tag(n)}"
            a = large2f.large2f_col_stage(x, p1, p2, q, col)
            note(name, a, large2f.large2f_col_stage_plain(x, p1, p2, q, col), f"{name} {what}",
                 PAIR_TOL)
            free()
            k = median_ms(lambda: large2f.large2f_col_stage(x, p1, p2, q, col))
            plain = median_ms(lambda: large2f.large2f_col_stage_plain(x, p1, p2, q, col))
            print(f"  {name} P={p1}x{p2} batch={batch}: pass 1 at "
                  f"{16 * batch * n / (k * 1e6):.0f} GB/s", flush=True)
            record(name, k, plain, 16 * batch * n + 8 * q * (p1 + p2),
                   batch * n * (fft_ops(p) / p + 12))
        else:
            (p1, p2, q), col, mids, row = top3f_tables(FftDirection.FORWARD)
            p, m = p1 * p2, p2 * q
            name = "large3_col_stage/2^26"
            b = large3.large3_col_stage(x, p1, m, q, col)
            note(name, b, large3.large3_col_stage_plain(x, p1, m, q, col), f"{name} {what}")
            free()
            k = median_ms(lambda: large3.large3_col_stage(x, p1, m, q, col))
            plain = median_ms(lambda: large3.large3_col_stage_plain(x, p1, m, q, col))
            print(f"  {name} P1={p1} batch={batch}: pass 1 at "
                  f"{16 * batch * n / (k * 1e6):.0f} GB/s", flush=True)
            record(name, k, plain, 16 * batch * n + 8 * q * p1, batch * n * (fft_ops(p1) / p1 + 6))
            name = "large3_p2/2^26"
            a = large3.large3_p2(b, p1, p2, q, mids[0])
            note(name, a, large3.large3_p2_plain(b, p1, p2, q, mids[0]), f"{name} {what}")
            free()
            k = median_ms(lambda: large3.large3_p2(b, p1, p2, q, mids[0]))
            plain = median_ms(lambda: large3.large3_p2_plain(b, p1, p2, q, mids[0]))
            print(f"  {name} P2={p2} batch={batch}: pass 2 at "
                  f"{16 * batch * n / (k * 1e6):.0f} GB/s", flush=True)
            record(name, k, plain, 16 * batch * n + 8 * (p2 * p1 + q * p2 + p2),
                   batch * n * (fft_ops(p2) / p2 + 12))
            del b
        name = f"large_row_stage/{tag(n)}"
        note(name, large.large_row_stage(a, q, p, row), large.large_row_stage_plain(a, q, p, row),
             f"{name} Q={q} P={p} {what}")
        free()
        k = median_ms(lambda: large.large_row_stage(a, q, p, row))
        plain = median_ms(lambda: large.large_row_stage_plain(a, q, p, row))
        lib = median_ms(lambda: torch.fft.fft(a, dim=1))
        record(name, k, plain, 16 * batch * n, batch * p * fft_ops(q), lib)
        del a
        free()
        plan = planner.plan_fft_forward(n)
        torch.cuda.reset_peak_memory_stats()
        path = median_ms(lambda: plan.process(x), reps=5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ref = median_ms(lambda: torch.fft.fft(x), reps=5)
        print(f"  top-band path n={tag(n)} batch={batch} ({route(n, np.complex64)}): {path:.3f} ms "
              f"({gflops(n, batch, path):.0f} GF/s), peak {peak:.2f} GiB; torch.fft {ref:.3f} ms "
              f"({gflops(n, batch, ref):.0f} GF/s)", flush=True)
        if n == 1 << 24:
            # the recipe tree the planner designs, the route bypassed
            tree = executor._build(plan.recipe, FftDirection.FORWARD, np.complex64)
            check(f"2^24 x {batch} through the recipe tree {plan.recipe!r} vs torch.fft",
                  rel_err_chunked(tree(x), lambda i, j: torch.fft.fft(x[i:j])))
            free()
            t = median_ms(lambda: tree(x), reps=5)
            print(f"  2^24 x {batch} through the recipe tree: {t:.3f} ms "
                  f"({gflops(n, batch, t):.0f} GF/s) against the route's {path:.3f} ms", flush=True)
        del x
        free()

    # 2^22 x 16 (the JAX bench's row) through both two-pass routes that serve it
    n, batch = 1 << 22, 16
    x = signal(batch, n)
    want = torch.fft.fft(x)
    for what, make in (("large (P = 512, Q = 8192)", large.make_large_fft_fn),
                       ("large2f (P = 1024, Q = 4096)", large2f.make_large2f_fft_fn)):
        fn = make(n, FftDirection.FORWARD, np.complex64)
        check(f"2^22 x {batch} via {what} vs torch.fft", rel_err(fn(x), want))
        t = median_ms(lambda: fn(x))
        print(f"  2^22 x {batch} via {what}: {t:.3f} ms ({gflops(n, batch, t):.0f} GF/s)",
              flush=True)
    print(f"  2^22 routes to {route(n, np.complex64)}", flush=True)
    del x, want
    free()

    # the one-pass mid band at its paths' shapes: each kernel against its
    # plain version, then times, the achieved rate and the bound; each path
    # against torch.fft and against the large route it replaced
    for n, batch in MID.items():
        x = signal(batch, n)
        name, kernel, plain, host = mid_kernel(n, FftDirection.FORWARD)
        note(name, kernel(x), plain(x), f"{name} n={n} batch={batch} (the main path's shape)",
             K7_TOL if name.startswith("two_stage") else TOL)
        free()
        k = median_ms(lambda: kernel(x))
        plain_ms = median_ms(lambda: plain(x))
        lib = median_ms(lambda: torch.fft.fft(x))
        print(f"  {name} n={n} batch={batch}: one pass at {16 * batch * n / (k * 1e6):.0f} GB/s",
              flush=True)
        # the DFT's 5 n log2 n and the merged, c- (radix) or outer (two-stage) twiddles
        record(name, k, plain_ms, 16 * batch * n + table_bytes(host),
               batch * (fft_ops(n) + 6 * n * (3 if name.startswith("radix") else 1)), lib)
        plan = planner.plan_fft_forward(n)
        path = median_ms(lambda: plan.process(x))
        old = large.make_large_fft_fn(n, FftDirection.FORWARD, np.complex64)
        check(f"n={n} x {batch} via the large route vs torch.fft", rel_err(old(x), torch.fft.fft(x)))
        free()
        old_ms = median_ms(lambda: old(x))
        print(f"  mid-band path n={n} batch={batch} ({route(n, np.complex64)}): {path:.3f} ms "
              f"({gflops(n, batch, path):.0f} GF/s); the large route {old_ms:.3f} ms "
              f"({gflops(n, batch, old_ms):.0f} GF/s); torch.fft {lib:.3f} ms "
              f"({gflops(n, batch, lib):.0f} GF/s)", flush=True)
        if n == 16384:
            host = fused.two_stage_tables(128, (8, 16), FftDirection.FORWARD)
            tabs = card_tables(host)
            name = "three_stage_fft/16384"
            note(name, fused.three_stage_fft(x, 128, 8, 16, tabs),
                 fused.three_stage_fft_plain(x, 128, 8, 16, tabs),
                 f"{name} (128, 8, 16) batch={batch} (the two-stage path's shape)")
            free()
            k = median_ms(lambda: fused.three_stage_fft(x, 128, 8, 16, tabs))
            plain_ms = median_ms(lambda: fused.three_stage_fft_plain(x, 128, 8, 16, tabs))
            print(f"  {name} batch={batch} (not routed):", flush=True)
            record(name, k, plain_ms, 16 * batch * n + table_bytes(host),
                   batch * (fft_ops(n) + 6 * n), lib)
        del x
        free()

    # K7 on one block with a prime p (a Bluestein stage) at its paths'
    # shapes: the kernel against its plain version, then times, the achieved
    # rate, the operations its chain spends and the bound; each path
    # against torch.fft
    for n, batch in ONE.items():
        x = signal(batch, n)
        name, kernel, plain, host = mid_kernel(n, FftDirection.FORWARD)
        p, q = fused.choose_pq(n)
        note(name, kernel(x), plain(x), f"{name} {p} x {q} batch={batch} (the main path's shape)",
             K7_TOL)
        free()
        k = median_ms(lambda: kernel(x))
        plain_ms = median_ms(lambda: plain(x))
        lib = median_ms(lambda: torch.fft.fft(x))
        spent = batch * n * (chain_ops(large.stage_radices(p), fused.bluestein_stage_m)
                             + chain_ops(large.stage_radices(q), fused.bluestein_stage_m) + 6)
        print(f"  {name} {p} x {q} ({large.stage_radices(p)} x {large.stage_radices(q)}, "
              f"Bluestein lengths {fused.bluestein_ms(large.stage_radices(p))}), shared memory "
              f"{fused.two_stage_smem_bytes(n, large.stage_radices(p), large.stage_radices(q))} "
              f"bytes, batch={batch}: one pass at {16 * batch * n / (k * 1e6):.0f} GB/s; the "
              f"operations its chain spends {spent / FP32_FLOPS * 1e3:.3f} ms at the FP32 peak:",
              flush=True)
        record(name, k, plain_ms, 16 * batch * n + table_bytes(host), batch * (fft_ops(n) + 6 * n),
               lib)
        plan = planner.plan_fft_forward(n)
        path = median_ms(lambda: plan.process(x))
        print(f"  one-block path n={n} batch={batch}: {path:.3f} ms ({gflops(n, batch, path):.0f} "
              f"GF/s); torch.fft {lib:.3f} ms ({gflops(n, batch, lib):.0f} GF/s)", flush=True)
        del x
        free()

    # K7's cluster band at its paths' shapes: the kernel against its plain
    # version, then times, the achieved rate and the bound; each path
    # against the route it replaced (large or large_pad, built directly) and
    # torch.fft
    for n, batch in CLUSTER.items():
        x = signal(batch, n)
        name, kernel, plain, host = mid_kernel(n, FftDirection.FORWARD)
        p, q = fused.choose_pq(n)
        c = fused.choose_cluster(n)
        note(name, kernel(x), plain(x), f"{name} {p} x {q} on {c} blocks batch={batch} "
                                        "(the main path's shape)", K7_TOL)
        free()
        k = median_ms(lambda: kernel(x))
        plain_ms = median_ms(lambda: plain(x))
        lib = median_ms(lambda: torch.fft.fft(x))
        spent = batch * n * (chain_ops(large.stage_radices(p), fused.bluestein_stage_m)
                             + chain_ops(large.stage_radices(q), fused.bluestein_stage_m) + 6)
        nbytes = 16 * batch * n + table_bytes(host)
        print(f"  {name} {p} x {q} ({large.stage_radices(p)} x {large.stage_radices(q)}) on {c} "
              f"blocks, batch={batch}: one pass at {16 * batch * n / (k * 1e6):.0f} GB/s; the "
              f"operations its chain spends {spent / FP32_FLOPS * 1e3:.3f} ms at the FP32 peak, "
              f"its bytes {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms:", flush=True)
        # the bound: the DFT's 5 n log2 n and the outer twiddle, as at 24576
        record(name, k, plain_ms, nbytes, batch * (fft_ops(n) + 6 * n), lib)
        plan = planner.plan_fft_forward(n)
        path = median_ms(lambda: plan.process(x))
        pad = largepad.largepad_supported(n, np.complex64) and largepad.narrowed_by_division(n)
        old_route = "large_pad" if pad else "large"
        old = (largepad.make_largepad_fft_fn if pad else large.make_large_fft_fn)(
            n, FftDirection.FORWARD, np.complex64)
        check(f"n={n} x {batch} via the {old_route} route vs torch.fft",
              rel_err(old(x), torch.fft.fft(x)))
        free()
        old_ms = median_ms(lambda: old(x))
        print(f"  cluster-band path n={n} batch={batch}: {path:.3f} ms "
              f"({gflops(n, batch, path):.0f} GF/s); the {old_route} route {old_ms:.3f} ms "
              f"({gflops(n, batch, old_ms):.0f} GF/s); torch.fft {lib:.3f} ms "
              f"({gflops(n, batch, lib):.0f} GF/s)", flush=True)
        del x
        free()

    # 24571 x 2048: a Bluestein prime whose inner m = 49152 left "large" for
    # the cluster band, where the JAX rule would hand it to the two-pass
    # core; the fused large Bluestein (K15, which convlarge.bconv_supported
    # keeps) against that core, in turns
    n, batch = 24571, 2048
    recipe = planner.plan_fft_forward(n).recipe
    m = recipe.inner.length
    assert executor.build(recipe, FftDirection.FORWARD, np.complex64).__module__ == \
        convlarge.__name__
    x = signal(batch, n)
    want = torch.fft.fft(x)
    cores = {"K15": convlarge.make_bluestein_large_fn(n, m, FftDirection.FORWARD, np.complex64),
             "the two-pass core": conv.make_bluestein_fn(n, m, FftDirection.FORWARD, np.complex64)}
    for what, fn in cores.items():
        check(f"{n} x {batch} (m = {m}) on {what} vs torch.fft", rel_err(fn(x), want))
        free()
    times = {what: [] for what in cores}
    for what in (*cores, *reversed(cores)):
        times[what].append(median_ms(lambda: cores[what](x)))
    ref = median_ms(lambda: torch.fft.fft(x))
    print(f"  {n} x {batch} (Bluestein, m = {m}), in turns: " + "; ".join(
        f"{what} {t[0]:.3f} / {t[1]:.3f} ms" for what, t in times.items())
          + f"; torch.fft {ref:.3f} ms; the planner takes K15", flush=True)
    del x, want, cores
    free()

    def dense_ops(n, variant):
        """FP32 operations of one length-n dense_fft row: 4 real products
        (8 n^2), or the Gauss form's 3 and its adds (6 n^2 + 4 n)."""
        return 8 * n * n if variant == "block" else 6 * n * n + 4 * n

    # the dense tier at its paths' shapes: K5's chain form (the primes from
    # 29) against its plain version (within 1e-6), its bound (with the
    # Bluestein stage's operations beside it), torch.fft (the one-call
    # PyTorch time), x @ W and the product kernel it replaced on the path;
    # the product (below 29) against its plain version, its bound, x @ W
    # (the Dft leaf it replaced, the one-call PyTorch time), the other form
    # and torch.fft; each path against torch.fft
    fwd = FftDirection.FORWARD
    for n, batch in {**DENSE, **DENSE_PRODUCT}.items():
        x = signal(batch, n)
        block = dense_card(n, fwd, "block")
        lib = median_ms(lambda: x @ block[0])
        ref = median_ms(lambda: torch.fft.fft(x))
        product = median_ms(lambda: dense.dense_fft(x, block, "block"))
        if n in DENSE:
            name = f"dense_chain_fft/{n}"
            table = torch.from_numpy(dense.chain_table(n, fwd)).to(dev)
            note(name, dense.dense_chain_fft(x, table), dense.dense_chain_fft_plain(x, table),
                 f"{name} batch={batch} (the main path's shape)", K7_TOL)
            free()
            k = median_ms(lambda: dense.dense_chain_fft(x, table))
            plain = median_ms(lambda: dense.dense_chain_fft_plain(x, table))
            m = lanepack.bluestein_stage_m(n)
            print(f"  {name} batch={batch}: chain {k:.3f} ms, the block product {product:.3f} ms, "
                  f"x @ W {lib:.3f} ms, torch.fft {ref:.3f} ms; the Bluestein stage's "
                  f"operations {batch * n * lanepack.bluestein_ops(n, m) / FP32_FLOPS * 1e3:.3f} "
                  "ms at the FP32 peak", flush=True)
            record(name, k, plain, 16 * batch * n + table.numel() * 8, batch * fft_ops(n), ref)
            del table
        else:
            name = f"dense_fft/{n}"
            variant = dense.choose_variant(n)
            tabs = dense_card(n, fwd, variant)
            note(name, dense.dense_fft(x, tabs, variant), dense.dense_fft_plain(x, tabs, variant),
                 f"{name} {variant} batch={batch} (the main path's shape)", PAIR_TOL)
            free()
            k = median_ms(lambda: dense.dense_fft(x, tabs, variant))
            plain = median_ms(lambda: dense.dense_fft_plain(x, tabs, variant))
            other = "gauss" if variant == "block" else "block"
            otabs = dense_card(n, fwd, other)
            check(f"{name} {other} batch={batch} vs torch.fft",
                  rel_err(dense.dense_fft(x, otabs, other), torch.fft.fft(x)))
            k_other = median_ms(lambda: dense.dense_fft(x, otabs, other))
            print(f"  {name} batch={batch}: {variant} {k:.3f} ms, {other} {k_other:.3f} ms; "
                  f"x @ W {lib:.3f} ms; torch.fft {ref:.3f} ms; the {variant} product's "
                  f"operations {batch * dense_ops(n, variant) / FP32_FLOPS * 1e3:.3f} ms at the "
                  "FP32 peak", flush=True)
            record(name, k, plain, 16 * batch * n + table_bytes([t for t in tabs if t is not None]),
                   batch * fft_ops(n), lib)
            del tabs, otabs
        plan = planner.plan_fft_forward(n)
        path = median_ms(lambda: plan.process(x))
        print(f"  dense path n={n} batch={batch}: {path:.3f} ms ({gflops(n, batch, path):.0f} GF/s); "
              f"x @ W {lib:.3f} ms; torch.fft {ref:.3f} ms ({gflops(n, batch, ref):.0f} GF/s)",
              flush=True)
        del x, block
        free()

    # the dense crossover: dense_fft in both forms against the route each
    # size takes (lanepack at 256, the convolution cores at 1009 and 1234)
    for n, batch in ((256, 262144), (1009, 8192), (1234, 8192)):
        x = signal(batch, n)
        plan = planner.plan_fft_forward(n)
        path = median_ms(lambda: plan.process(x))
        times = {}
        for variant in dense.VARIANTS:
            tabs = dense_card(n, fwd, variant)
            check(f"dense_fft n={n} {variant} batch={batch} vs torch.fft",
                  rel_err(dense.dense_fft(x, tabs, variant), torch.fft.fft(x)))
            times[variant] = median_ms(lambda: dense.dense_fft(x, tabs, variant))
        print(f"  dense crossover n={n} x {batch}: the planner's path "
              f"({route(n, np.complex64) or type(plan.recipe).__name__}) {path:.3f} ms; "
              f"dense_fft block {times['block']:.3f} ms, gauss {times['gauss']:.3f} ms", flush=True)
        del x, tabs
        free()

    # large_pad at its paths' shapes: each stage against its plain version,
    # its bound and large's stage on the same split (one-column tiles, two
    # buffers, a direct sum for every radix without a register stage); each
    # path against the large route it replaced and torch.fft
    for n, batch in PAD.items():
        x = signal(batch, n)
        p, q, col, row = pad_card(n, fwd)
        _, _, lcol, lrow = pad_card(n, fwd, large)
        rp, rq = large.stage_radices(p), large.stage_radices(q)
        what = f"n={n} P={p} Q={q} batch={batch} (the main path's shape)"
        name = f"largepad_col_stage/{n}"
        a = largepad.largepad_col_stage(x, p, q, col)
        note(name, a, largepad.largepad_col_stage_plain(x, p, q, col), f"{name} {what}", K7_TOL)
        free()
        k = median_ms(lambda: largepad.largepad_col_stage(x, p, q, col))
        plain = median_ms(lambda: largepad.largepad_col_stage_plain(x, p, q, col))
        old = median_ms(lambda: large.large_col_stage(x, p, q, lcol))
        spent = batch * n * (chain_ops(rp, fused.bluestein_stage_m) + 6)
        print(f"  {name} {rp} Bluestein {fused.bluestein_ms(rp)} tile {largepad.tile(p)}: "
              f"{16 * batch * n / (k * 1e6):.0f} GB/s; the operations its chain spends "
              f"{spent / FP32_FLOPS * 1e3:.3f} ms at the FP32 peak; large_col_stage (tile "
              f"{large.col_tile(p, q)}) {old:.3f} ms", flush=True)
        record(name, k, plain, 16 * batch * n + table_bytes(col[:2]) + 8 * n,
               batch * n * (fft_ops(p) / p + 6))
        free()
        name = f"largepad_row_stage/{n}"
        note(name, largepad.largepad_row_stage(a, q, p, row),
             largepad.largepad_row_stage_plain(a, q, p, row), f"{name} {what}", K7_TOL)
        free()
        k = median_ms(lambda: largepad.largepad_row_stage(a, q, p, row))
        plain = median_ms(lambda: largepad.largepad_row_stage_plain(a, q, p, row))
        old = median_ms(lambda: large.large_row_stage(a, q, p, lrow))
        lib = median_ms(lambda: torch.fft.fft(a, dim=1))
        spent = batch * n * chain_ops(rq, fused.bluestein_stage_m)
        print(f"  {name} {rq} Bluestein {fused.bluestein_ms(rq)} tile {largepad.tile(q)}: "
              f"{16 * batch * n / (k * 1e6):.0f} GB/s; the operations its chain spends "
              f"{spent / FP32_FLOPS * 1e3:.3f} ms at the FP32 peak; large_row_stage (tile "
              f"{large.row_tile(q, p)}) {old:.3f} ms", flush=True)
        record(name, k, plain, 16 * batch * n + table_bytes(row), batch * p * fft_ops(q), lib)
        del a
        free()
        plan = planner.plan_fft_forward(n)
        path = median_ms(lambda: plan.process(x))
        old_fn = large.make_large_fft_fn(n, fwd, np.complex64)
        check(f"n={n} x {batch} via the large route vs torch.fft", rel_err(old_fn(x), torch.fft.fft(x)))
        free()
        old = median_ms(lambda: old_fn(x))
        ref = median_ms(lambda: torch.fft.fft(x))
        print(f"  large_pad path n={n} batch={batch}: {path:.3f} ms ({gflops(n, batch, path):.0f} "
              f"GF/s); the large route {old:.3f} ms ({gflops(n, batch, old):.0f} GF/s); torch.fft "
              f"{ref:.3f} ms ({gflops(n, batch, ref):.0f} GF/s)", flush=True)
        del x
        free()

    # the fused large Bluestein at its path's shape: the tile form's kernel
    # A, B_conv and A2 against their plain versions and bounds; the path
    # against the two-pass core it replaced and torch.fft
    for n, (m, batch) in BLUE.items():
        x = signal(batch, n)
        p, q, col, row, pre, h, chirp = bconv_card(n, m, fwd)
        trow, th, touter = bconv_tile_card(n, m, fwd, col)
        what = f"n={n} m={m} P={p} Q={q} batch={batch} (the main path's shape)"
        name = f"bconv_col_tile/{n}"
        a = convlarge.bconv_col_tile(x, p, q, col, pre)
        note(name, a, convlarge.bconv_col_tile_plain(x, p, q, col, pre), f"{name} {what}",
             K7_TOL)
        free()
        k = median_ms(lambda: convlarge.bconv_col_tile(x, p, q, col, pre))
        plain = median_ms(lambda: convlarge.bconv_col_tile_plain(x, p, q, col, pre))
        record(name, k, plain, 8 * batch * (n + m) + table_bytes(col[:2]) + 16 * m,
               batch * m * (fft_ops(p) / p + 12))
        name = f"bconv_row_tile/{n}"
        b = convlarge.bconv_row_tile(a, q, p, trow, th, touter)
        note(name, b, convlarge.bconv_row_tile_plain(a, q, p, trow, th, touter), f"{name} {what}",
             K7_TOL)
        free()
        k = median_ms(lambda: convlarge.bconv_row_tile(a, q, p, trow, th, touter))
        plain = median_ms(lambda: convlarge.bconv_row_tile_plain(a, q, p, trow, th, touter))
        print(f"  {name}: {16 * batch * m / (k * 1e6):.0f} GB/s", flush=True)
        record(name, k, plain, 16 * batch * m + table_bytes(trow) + 16 * m,
               batch * (2 * p * fft_ops(q) + 12 * m))
        del a
        name = f"bconv_out_tile/{n}"
        out = convlarge.bconv_out_tile(b, p, q, col[:2], chirp, n)
        note(name, out, convlarge.bconv_out_tile_plain(b, p, q, col[:2], chirp, n),
             f"{name} {what}", K7_TOL)
        del out
        free()
        k = median_ms(lambda: convlarge.bconv_out_tile(b, p, q, col[:2], chirp, n))
        plain = median_ms(lambda: convlarge.bconv_out_tile_plain(b, p, q, col[:2], chirp, n))
        record(name, k, plain, 8 * batch * (m + n) + table_bytes(col[:2]) + 8 * n,
               batch * (q * fft_ops(p) + 6 * n))
        del b
        free()
        plan = planner.plan_fft_forward(n)
        path = median_ms(lambda: plan.process(x), reps=5)
        old_fn = conv.make_bluestein_fn(n, m, fwd, np.complex64)
        check(f"n={n} x {batch} via the two-pass core vs torch.fft",
              rel_err(old_fn(x), torch.fft.fft(x)))
        free()
        old = median_ms(lambda: old_fn(x), reps=5)
        ref = median_ms(lambda: torch.fft.fft(x), reps=5)
        print(f"  fused large Bluestein path n={n} batch={batch}: {path:.3f} ms "
              f"({gflops(n, batch, path):.0f} GF/s); the two-pass core {old:.3f} ms "
              f"({gflops(n, batch, old):.0f} GF/s); torch.fft {ref:.3f} ms "
              f"({gflops(n, batch, ref):.0f} GF/s)", flush=True)
        del x
        free()

    # the fused large Bluestein's general form at 24571 x 2048 (Q = 192):
    # kernel A (the two-pass core's column stage with the chirp as pre),
    # B_conv and A2 against their plain versions and bounds
    n, batch = 24571, 2048
    m = planner.plan_fft_forward(n).recipe.inner.length
    x = signal(batch, n)
    p, q, col, row, pre, h, chirp = bconv_card(n, m, fwd)
    what = f"n={n} m={m} P={p} Q={q} batch={batch} (the main path's shape)"
    name = "conv_col_stage/24571"
    a, _ = conv_radix.conv_col_stage(x, p, q, col, pre=pre, general=True)
    note(name, a, conv_radix.conv_col_stage_plain(x, p, q, col, pre, general=True)[0],
         f"{name} {what}")
    free()
    k = median_ms(lambda: conv_radix.conv_col_stage(x, p, q, col, pre=pre, general=True))
    plain = median_ms(lambda: conv_radix.conv_col_stage_plain(x, p, q, col, pre, general=True))
    record(name, k, plain, 8 * batch * (n + m) + table_bytes(col[:2]) + 16 * m,
           batch * m * (fft_ops(p) / p + 12))
    del x
    name = "bconv_row_stage/24571"
    b = convlarge.bconv_row_stage(a, q, p, row, h, col[2])
    note(name, b, convlarge.bconv_row_stage_plain(a, q, p, row, h, col[2]), f"{name} {what}")
    free()
    k = median_ms(lambda: convlarge.bconv_row_stage(a, q, p, row, h, col[2]))
    plain = median_ms(lambda: convlarge.bconv_row_stage_plain(a, q, p, row, h, col[2]))
    record(name, k, plain, 16 * batch * m + table_bytes(row) + 16 * m,
           batch * (2 * p * fft_ops(q) + 12 * m))
    del a
    name = "bconv_out_stage/24571"
    out = convlarge.bconv_out_stage(b, p, q, col[:2], chirp, n)
    note(name, out, convlarge.bconv_out_stage_plain(b, p, q, col[:2], chirp, n), f"{name} {what}")
    del out
    free()
    k = median_ms(lambda: convlarge.bconv_out_stage(b, p, q, col[:2], chirp, n))
    plain = median_ms(lambda: convlarge.bconv_out_stage_plain(b, p, q, col[:2], chirp, n))
    record(name, k, plain, 8 * batch * (m + n) + table_bytes(col[:2]) + 8 * n,
           batch * (q * fft_ops(p) + 6 * n))
    del b
    free()

    # the two-pass core's cluster passes at their paths' shapes (65537 x 512,
    # 7919 x 4096) against their plain versions and bounds
    for n, batch in CLUSTER_PRIMES.items():
        m, r, radix, kw1, kw2, n_in, n_out = cluster_card(n, fwd)
        x = signal(batch, n_in)
        what = f"n={n} m={m} (r = {r}) batch={batch} (the main path's shape)"
        name = f"conv_radix_pass1/{n}"
        z, part = conv_radix.conv_radix_pass1(x, m, radix, **kw1)
        z_p, _ = conv_radix.conv_radix_pass1_plain(x, m, r, radix, kw1["h"], kw1.get("pre"),
                                                   kw1.get("perm"), kw1.get("emit_sum", False))
        note(name, z, z_p, f"{name} {what}", K7_TOL)
        del z_p
        free()
        k = median_ms(lambda: conv_radix.conv_radix_pass1(x, m, radix, **kw1))
        plain = median_ms(lambda: conv_radix.conv_radix_pass1_plain(
            x, m, r, radix, kw1["h"], kw1.get("pre"), kw1.get("perm"), kw1.get("emit_sum", False)))
        # bytes: x read once (gathered or not), z written, h and pre or the
        # gather's index read once; operations: FFT_m and the products
        record(name, k, plain, 8 * batch * (n_in + m) + 8 * m + (8 if n != 65537 else 4) * m
               + 8 * (0 if part is None else part.numel()),
               batch * (fft_ops(m) + 6 * m + (6 * m if n != 65537 else 0)))
        del x
        if part is not None:
            kw2 = dict(kw2, x0=signal(batch, 1).reshape(-1), partials=part)
        name = f"conv_radix_pass2/{n}"
        y = conv_radix.conv_radix_pass2(z, m, radix, n_out, **kw2)
        note(name, y, conv_radix.conv_radix_pass2_plain(z, m, r, radix, n_out, **kw2),
             f"{name} {what}", K7_TOL)
        del y
        free()
        k = median_ms(lambda: conv_radix.conv_radix_pass2(z, m, radix, n_out, **kw2))
        plain = median_ms(lambda: conv_radix.conv_radix_pass2_plain(z, m, r, radix, n_out, **kw2))
        record(name, k, plain, 8 * batch * (m + n_out) + (4 if n == 65537 else 8) * m
               + 8 * (0 if part is None else part.numel() + batch),
               batch * (fft_ops(m) + (2 * m if n == 65537 else 6 * m)))
        del z, part, kw2
        free()

    # 746497 x 64 both ways, each built through executor.build: the
    # reference rule's Rader and the JAX package's third prime rule (a
    # Bluestein whose inner a kernel route serves, routed_bluestein_inner)
    n, batch = 746497, 64
    m = routed_bluestein_inner(n, np.complex64)
    x = signal(batch, n)
    want = torch.fft.fft(x)
    for what, recipe in (
        (f"Raders({n - 1}) on the two-pass core", recipes.Raders(recipes.Dft(n - 1))),
        (f"Bluesteins({n}, {m}) on the fused large Bluestein",
         recipes.Bluesteins(n, recipes.Dft(m))),
    ):
        fn = executor.build(recipe, fwd, np.complex64)
        check(f"{n} x {batch} as {what} vs torch.fft", rel_err(fn(x), want))
        free()
        t = median_ms(lambda: fn(x), reps=5)
        print(f"  {n} x {batch} as {what}: {t:.3f} ms ({gflops(n, batch, t):.0f} GF/s)", flush=True)
    print(f"  the planner takes {planner.plan_fft_forward(n).recipe!r}"[:160], flush=True)
    del x, want
    free()

    pinned_phase(counters, signal, t0)
    name = f"lanepack_chain_fft/{STEP_LOCAL}"
    step_k1 = spectral_phase(counters, signal, card, t0,
                             (main_launches, path_launches.setdefault(STEP_LOCAL, {})))
    max_abs[name] = max(max_abs[name], step_k1.pop("max_abs_err"))
    results[name] = step_k1

    def launches_of(name):
        base, _, where = name.partition("/")
        if not where:
            return main_launches[base]
        if where in TAGGED:
            return path_launches[TAGGED[where]][base]
        if base == "conv_fft":
            return path_launches[f"conv_fft {where}"][base]
        n = {"K6": 1009, "K13": 1234}.get(where)
        n = n or (1 << int(where[2:]) if where.startswith("2^") else int(where))
        return path_launches[n][base]

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches_of(name), "max_abs_err": max_abs[name], **results[name]}
        for name, (src, replaces) in KERNELS.items()
    ]
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
