#!/usr/bin/env python3
"""Split the time of K1's, K2's, K3's, K7's, K9's, K12's, K13's and K15's kernels into phases on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/torch_phase_times.py [N:BATCH ...]

Default shapes: 4096:16384 (K1's pipelined kernel, (16, 16, 16)),
8192:8192 and 2008:32768 (K1's chain kernel: four register stages; a
512-point Bluestein stage), 251:131072 (K5's chain form, one Bluestein
stage on the chain kernel), 24576:2048 (192 x 128, (16, 12) x (16, 8)) on
K7's one-block kernel (any n the route sends to two_stage below 28928 but
16384, which runs K9's body), 49152:2048 (192 x 256, register radices
only, 4 blocks a transform) and 260608:256 (509 x 512, the prime p = 509
as a Bluestein stage, 16 blocks) on K7's cluster kernel, each with the
outer twiddle as its path gives it (fused.outer_transposed), and 531441:64 (243 x 2187, a
radix-27 Bluestein stage on the row stage) and 234617:256 (373 x 629, the
prime P = 373 as a 1024-point Bluestein stage) on K12's two kernels; a
shape goes to K12 where `route` sends it to large_pad, to K1 where it
sends it to lanepack, to K5's chain form where it sends it to dense (a
prime from 29), and 32768:2048 and 262144:256 to K9's radix kernel (r = 2
and 16; any n the route sends to radix goes there), and 1048576:64 to
K2's and K3's persistent tile kernels (any n the route sends to large
whose split is (256, 64, 64)), any n the route sends to large2f (2^22 ..
2^25) to K10's cluster kernel (large2f.K10_PHASES), and 1000003:64 to K15's three tile kernels (any
n whose plan is a Bluestein on the fused large Bluestein's tile form at
convlarge.split's split, every B_conv form of convlarge.COLUMN_FORMS:
1048583:32 at Q = 12288, 2097169:16 on the pair of blocks at Q = 24576,
24571:2048 at Q = 192; kernel A, B_conv and A2, convlarge.COL_TILE_PHASES,
ROW_TILE_PHASES, OUT_TILE_PHASES), and a prime whose plan is a Rader or a Bluestein on the
one-pass convolution core (1009:8192, 1234:8192; m = n - 1 or the inner
length) to that core's kernels: conv_fft (conv.CONV_PHASES: load, chain
1, the H multiply, chain 2, store) and, where conv.chain_radices(m)
holds, conv_chain_fft
(conv.CHAIN_PHASES, summed over a persistent block's units).  For each shape it
runs the stamped form of each kernel (lanepack.lanepack_phase_stamps,
fused.radix_phase_stamps, fused.two_stage_phase_stamps,
fused.two_stage_cluster_phase_stamps,
largepad.largepad_col_phase_stamps and largepad_row_phase_stamps,
large.large_col_phase_stamps and large_row_phase_stamps, which no
route launches: thread 0 of every block reads %globaltimer after a block
barrier at the kernel's start and at the end of each phase: the load,
DFT_p, DFT_q and the store of K7's one-block kernel
(fused.ONE_BLOCK_PHASES); the load, DFT_p, the exchange, DFT_q and the
store of its cluster kernel (fused.PHASES); the load,
the chain and the store of K12's and of K1's chain kernel; the time K1's
pipelined kernel spends waiting for its loads, in stages 0-1 and in stage
2 with the store, summed over a block's transforms; K9's fused.RADIX_PHASES,
summed over the transforms a block runs; K2's large.COL_PHASES and K3's
large.ROW_PHASES, summed over the tiles a block runs), checks its output bit for bit against
the kernel's, and prints:

  - per phase, the mean and median over blocks of its time in a block, in
    microseconds, and its share of a block's span (start to store);
  - the blocks' mean span, the blocks resident at once (the sum of the
    spans over the first-to-last stamp), and the wall time of the stamped
    launch and of the kernel's own (CUDA events, median of 7 after 2
    warm-ups), whose difference is what the stamps cost.

The first line is the card's name and power limit (nvidia-smi).
"""
from __future__ import annotations

import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((4096, 16384), (8192, 8192), (2008, 32768), (251, 131072), (32768, 2048),
          (262144, 256), (24576, 2048), (49152, 2048), (260608, 256), (531441, 64), (234617, 256),
          (1 << 20, 64), (1000003, 64))


def median_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def report(what: str, stamps, phases, stamped: float, plain: float) -> None:
    """Print the phases of (blocks, len(phases) + 1) stamps in ns and the
    wall times of the stamped launch and the kernel's own."""
    s = stamps.double().cpu()
    times = (s[:, 1:] - s[:, :-1]) / 1e3  # (blocks, phases) microseconds
    span = (s[:, -1] - s[:, 0]) / 1e3
    wall = (s[:, -1].max() - s[:, 0].min()).item() / 1e3
    print(f"{what}: {s.shape[0]} blocks", flush=True)
    for i, name in enumerate(phases):
        col = times[:, i]
        print(f"  {name:9s} mean {col.mean().item():9.2f} us  median "
              f"{col.median().item():9.2f} us  {100 * col.mean().item() / span.mean().item():5.1f}% "
              "of a block's span", flush=True)
    print(f"  span: mean {span.mean().item():.2f} us; blocks resident at once "
          f"{span.sum().item() / wall:.1f}; first to last stamp {wall / 1e3:.3f} ms; "
          f"stamped launch {stamped:.3f} ms, kernel {plain:.3f} ms", flush=True)


def largepad_phases(n: int, batch: int, gen) -> None:
    """K12's column and row kernels at n x batch through their stamped
    forms."""
    import torch

    from rustfft_tpu_torch.common import FftDirection
    from rustfft_tpu_torch.ops.kernels import fused, large, largepad

    dev = torch.device("cuda")

    def card(tables):
        return tuple([torch.from_numpy(a).to(dev) for a in t] if isinstance(t, list)
                     else torch.from_numpy(t).to(dev) for t in tables)

    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    col = card(largepad.col_tables(p, q, FftDirection.FORWARD))
    row = card(largepad.row_tables(q, FftDirection.FORWARD))
    x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
    a = largepad.largepad_col_stage(x, p, q, col)
    for stage, stamped_fn, fn, inp, m, other, tabs in (
            ("col", largepad.largepad_col_phase_stamps, largepad.largepad_col_stage, x, p, q,
             col),
            ("row", largepad.largepad_row_phase_stamps, largepad.largepad_row_stage, a, q, p,
             row)):
        stamped_fn(inp, m, other, tabs)  # warm-up (and the stamped library's build)
        y, stamps = stamped_fn(inp, m, other, tabs)
        torch.cuda.synchronize()
        if not torch.equal(y, fn(inp, m, other, tabs)):
            raise SystemExit(f"n={n} {stage}: the stamped kernel differs from the kernel")
        report(f"n={n} ({p} x {q}) batch={batch} largepad_{stage}_stage over "
               f"{large.stage_radices(m)} (Bluestein lengths "
               f"{fused.bluestein_ms(large.stage_radices(m))}), tile {largepad.tile(m)}",
               stamps, largepad.PHASES,
               median_ms(lambda: stamped_fn(inp, m, other, tabs)),
               median_ms(lambda: fn(inp, m, other, tabs)))
    del x, a
    torch.cuda.empty_cache()


def lanepack_phases(n: int, batch: int, gen) -> None:
    """K1's kernel for n (the pipelined kernel at 4096, else the chain
    kernel), or K5's chain form for a prime n of the dense route (the chain
    kernel on one Bluestein stage), at n x batch through its stamped form."""
    import torch

    from rustfft_tpu_torch.common import FftDirection
    from rustfft_tpu_torch.ops.kernels import dense, lanepack

    dev = torch.device("cuda")
    if dense.chain_form(n) and lanepack.choose_radices(n) == (n,):
        radices, host = (n,), ([dense.chain_table(n, FftDirection.FORWARD)], [])
    else:
        radices = lanepack.choose_radices(n)
        host = lanepack.chain_tables(n, radices, FftDirection.FORWARD)
    tables = tuple([torch.from_numpy(a).to(dev) for a in t] for t in host)
    x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
    lanepack.lanepack_phase_stamps(x, radices, tables)  # warm-up (and the stamped library's build)
    y, stamps, phases = lanepack.lanepack_phase_stamps(x, radices, tables)
    torch.cuda.synchronize()
    if not torch.equal(y, lanepack.lanepack_fft(x, radices, tables)):
        raise SystemExit(f"n={n}: the stamped kernel differs from the kernel")
    kernel = ("lanepack_pipe_fft" if radices == lanepack.PIPE_RADICES else
              f"lanepack_chain_fft ({lanepack.chain_width(n)} transforms a block, Bluestein "
              f"lengths {lanepack.bluestein_ms(radices, lanepack.MAX_STAGES)})")
    report(f"n={n} {radices} batch={batch} {kernel}", stamps, phases,
           median_ms(lambda: lanepack.lanepack_phase_stamps(x, radices, tables)),
           median_ms(lambda: lanepack.lanepack_fft(x, radices, tables)))
    del x, y, stamps
    torch.cuda.empty_cache()


def radix_phases(n: int, batch: int, gen) -> None:
    """K9's radix kernel at n x batch through its stamped form."""
    import torch

    from rustfft_tpu_torch.common import FftDirection
    from rustfft_tpu_torch.ops.kernels import fused

    dev = torch.device("cuda")
    r, p, _ = fused.choose_rpq(n)
    tabs = tuple([torch.from_numpy(a).to(dev) for a in t] if isinstance(t, list)
                 else torch.from_numpy(t).to(dev)
                 for t in fused.radix_tables(r, p, p, FftDirection.FORWARD))
    x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
    fused.radix_phase_stamps(x, r, p, tabs)  # warm-up (and the stamped library's build)
    y, stamps = fused.radix_phase_stamps(x, r, p, tabs)
    torch.cuda.synchronize()
    if not torch.equal(y, fused.radix_fft(x, r, p, tabs)):
        raise SystemExit(f"n={n}: the stamped kernel differs from the kernel")
    report(f"n={n} (r = {r}) batch={batch} radix_fft, {stamps.shape[0] // r} clusters of {r}, "
           f"{fused.radix_max_active_clusters(r)} resident", stamps, fused.RADIX_PHASES,
           median_ms(lambda: fused.radix_phase_stamps(x, r, p, tabs)),
           median_ms(lambda: fused.radix_fft(x, r, p, tabs)))
    del x, y, stamps
    torch.cuda.empty_cache()


def large_phases(n: int, batch: int, gen) -> None:
    """K2's and K3's tile kernels (the column stage at P = 16 x 16, the row
    stage at Q = 16 x 16 x 16) at n x batch through their stamped forms."""
    import torch

    from rustfft_tpu_torch.common import FftDirection
    from rustfft_tpu_torch.ops.kernels import large

    dev = torch.device("cuda")
    p, q1, q2 = large.choose_pqq(n)
    q = q1 * q2
    r, t, outer = large.col_tables(p, q, FftDirection.FORWARD)
    col = ([torch.from_numpy(v).to(dev) for v in r], [torch.from_numpy(v).to(dev) for v in t],
           torch.from_numpy(outer).to(dev))
    row = tuple([torch.from_numpy(v).to(dev) for v in tabs]
                for tabs in large.row_tables(q, FftDirection.FORWARD))
    x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
    a = large.large_col_stage(x, p, q, col)
    for stage, stamped_fn, fn, inp, m, other, tabs, phases in (
            ("col", large.large_col_phase_stamps, large.large_col_stage, x, p, q, col,
             large.COL_PHASES),
            ("row", large.large_row_phase_stamps, large.large_row_stage, a, q, p, row,
             large.ROW_PHASES)):
        stamped_fn(inp, m, other, tabs)  # warm-up (and the stamped library's build)
        y, stamps = stamped_fn(inp, m, other, tabs)
        torch.cuda.synchronize()
        if not torch.equal(y, fn(inp, m, other, tabs)):
            raise SystemExit(f"n={n} {stage}: the stamped kernel differs from the kernel")
        report(f"n={n} ({p} x {q}) batch={batch} large_{stage}_stage over "
               f"{large.stage_radices(m)}", stamps, phases,
               median_ms(lambda: stamped_fn(inp, m, other, tabs)),
               median_ms(lambda: fn(inp, m, other, tabs)))
    del x, a
    torch.cuda.empty_cache()


def large2f_phases(n: int, batch: int, gen) -> None:
    """K10's cluster kernel (the fused column stage of the top band) at n x
    batch through its stamped form."""
    import torch

    from rustfft_tpu_torch.common import FftDirection
    from rustfft_tpu_torch.ops.kernels import large, large2f

    dev = torch.device("cuda")
    p1, p2, _, _, q = large2f.choose_split2f(n)
    r, t, wob, wm = large2f.col_tables(p1, p2, q, FftDirection.FORWARD)
    col = ([torch.from_numpy(v).to(dev) for v in r], [torch.from_numpy(v).to(dev) for v in t],
           torch.from_numpy(wob).to(dev), torch.from_numpy(wm).to(dev))
    x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
    stamped = lambda: large2f.large2f_col_phase_stamps(x, p1, p2, q, col)  # noqa: E731
    stamped()  # warm-up (and the stamped library's build)
    y, stamps = stamped()
    torch.cuda.synchronize()
    if not torch.equal(y, large2f.large2f_col_stage(x, p1, p2, q, col)):
        raise SystemExit(f"n={n}: the stamped kernel differs from the kernel")
    report(f"n={n} (P = {p1} x {p2}, {large.stage_radices(p1 * p2)}, Q = {q}) batch={batch} "
           f"large2f_col_stage on clusters of {large2f.cluster_form(p1 * p2, p1, q)}", stamps,
           large2f.K10_PHASES, median_ms(stamped),
           median_ms(lambda: large2f.large2f_col_stage(x, p1, p2, q, col)))
    del x, y
    torch.cuda.empty_cache()


def conv_phases(n: int, m: int, batch: int, gen) -> None:
    """The one-pass convolution core of the prime n (a Rader at m = n - 1, a
    Bluestein at an inner m) at the shape its path gives it, n x batch,
    through the stamped form of its kernel."""
    import torch

    from rustfft_tpu_torch.common import FftDirection
    from rustfft_tpu_torch.ops.bluestein import bluestein_tables
    from rustfft_tpu_torch.ops.kernels import conv, conv_radix, lanepack
    from rustfft_tpu_torch.ops.raders import raders_tables

    dev = torch.device("cuda")
    d = FftDirection.FORWARD
    rader = m == n - 1
    if rader:
        h, pre, post, n_io = raders_tables(n, d)[2], None, None, m
    else:
        chirp, h = bluestein_tables(n, m, d)
        pre = post = chirp
        n_io = n

    def card(t):
        return None if t is None else torch.from_numpy(conv_radix.zero_extended(t, m)).to(dev)

    x = torch.randn((batch, n_io), dtype=torch.complex64, generator=gen, device=dev)
    forms = [("conv_fft", conv.conv_fft, conv.conv_phase_stamps, lanepack.tile_radices(m),
              lambda r: [[torch.from_numpy(a).to(dev) for a in t]
                         for t in lanepack.stage_tables(m, r, d)] + [card(h)])]
    if getattr(conv, "chain_radices", lambda _: None)(m) is not None:  # the chain form
        forms.append(("conv_chain_fft", conv.conv_chain_fft, conv.conv_chain_phase_stamps,
                      conv.chain_radices(m),
                      lambda r: [[torch.from_numpy(a).to(dev) for a in t]
                                 for t in conv.double_chain_tables(m, r, d)]
                      + [card(conv.chain_h_table(conv_radix.zero_extended(h, m), r))]))
    for name, kernel, stamped, radices, make in forms:
        args = (x, radices, (*make(radices), card(pre), card(post)), n_io, not rader)
        stamped(*args)  # warm-up (and the stamped library's build)
        y, stamps, phases = stamped(*args)
        torch.cuda.synchronize()
        if not torch.equal(y, kernel(*args)):
            raise SystemExit(f"n={n}: the stamped {name} differs from the kernel")
        report(f"n={n} ({'Rader' if rader else 'Bluestein'}, m = {m}, {radices}) batch={batch} "
               f"{name}", stamps, phases, median_ms(lambda: stamped(*args)),
               median_ms(lambda: kernel(*args)))
        del y, stamps
    del x
    torch.cuda.empty_cache()


def bluestein_large_phases(n: int, m: int, batch: int, gen) -> None:
    """K15's three tile kernels (the fused large Bluestein of length n at an
    inner m of the tile form) at n x batch through their stamped forms."""
    import torch

    from rustfft_tpu_torch.common import FftDirection
    from rustfft_tpu_torch.ops.kernels import convlarge, large

    dev = torch.device("cuda")

    def card(tables):
        return tuple([torch.from_numpy(a).to(dev) for a in t] if isinstance(t, list)
                     else torch.from_numpy(t).to(dev) for t in tables)

    p, q1, q2 = getattr(convlarge, "split", large.choose_pqq)(m)
    q = q1 * q2
    if not convlarge.tile_form(p, q):
        raise SystemExit(f"n={n}: m={m} = {p} x {q} does not run the tile form")
    host = convlarge.bconv_tables(n, m, p, q, FftDirection.FORWARD)
    col, row = card(host["col"]), card(convlarge.bconv_chain_tables(FftDirection.FORWARD, q))
    pre, chirp = (torch.from_numpy(host[k]).to(dev) for k in ("pre", "chirp"))
    h = torch.from_numpy(convlarge.bconv_h_table(host["h"])).to(dev)
    outer = convlarge.to_columns(col[2])
    x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
    a = convlarge.bconv_col_tile(x, p, q, col, pre)
    b = convlarge.bconv_row_tile(a, q, p, row, h, outer)
    for what, stamped_fn, fn, args, phases in (
            ("kernel A", convlarge.bconv_col_tile_stamps, convlarge.bconv_col_tile,
             (x, p, q, col, pre), convlarge.COL_TILE_PHASES),
            ("B_conv", convlarge.bconv_row_tile_stamps, convlarge.bconv_row_tile,
             (a, q, p, row, h, outer), convlarge.ROW_TILE_PHASES),
            ("A2", convlarge.bconv_out_tile_stamps, convlarge.bconv_out_tile,
             (b, p, q, col[:2], chirp, n), convlarge.OUT_TILE_PHASES)):
        stamped_fn(*args)  # warm-up (and the stamped library's build)
        y, stamps = stamped_fn(*args)
        torch.cuda.synchronize()
        if not torch.equal(y, fn(*args)):
            raise SystemExit(f"n={n} {what}: the stamped kernel differs from the kernel")
        report(f"n={n} (m = {m} = {p} x {q}) batch={batch} {what}", stamps, phases,
               median_ms(lambda: stamped_fn(*args)), median_ms(lambda: fn(*args)))
    del x, a, b
    torch.cuda.empty_cache()


def two_stage_phases(n: int, batch: int, gen) -> None:
    """K7's stamped form at n: the one-block kernel where two_stage_fft
    runs n (not 16384), else the cluster kernel on choose_cluster(n)
    blocks, each with its path's outer twiddle."""
    import numpy as np
    import torch
    from rustfft_tpu_torch.common import FftDirection
    from rustfft_tpu_torch.ops.kernels import fused, large

    dev = torch.device("cuda")
    p, q = fused.choose_pq(n)
    host = fused.two_stage_tables(p, large.stage_radices(q), FftDirection.FORWARD)
    tabs = tuple([torch.from_numpy(a).to(dev) for a in t] if isinstance(t, list)
                 else torch.from_numpy(t).to(dev) for t in host)
    opq = fused.outer_transposed(p, host[2])
    opq = None if opq is None else torch.from_numpy(opq).to(dev)
    x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
    what = (f"n={n} ({p} x {q}, {large.stage_radices(p)} x {large.stage_radices(q)}, "
            f"Bluestein lengths {fused.bluestein_ms(large.stage_radices(p))}) batch={batch}, "
            f"outer twiddle {'(p, q)' if opq is not None else '(q, p)'}")
    if fused.two_stage_supported(n, np.complex64):
        if (p, q) == (fused.RADIX_PQ, fused.RADIX_PQ):
            raise SystemExit(f"n={n} runs K9's body at R = 1, which has no stamped form here")
        stamped = lambda: fused.two_stage_phase_stamps(x, p, q, tabs, opq)  # noqa: E731
        plain = lambda: fused.two_stage_fft(x, p, q, tabs, opq)  # noqa: E731
        what, phases = what + " on one block a transform", fused.ONE_BLOCK_PHASES
    else:
        c = fused.choose_cluster(n)
        stamped = lambda: fused.two_stage_cluster_phase_stamps(x, p, q, c, tabs, opq)  # noqa: E731
        plain = lambda: fused.two_stage_cluster_fft(x, p, q, c, tabs, opq)  # noqa: E731
        what, phases = what + f" on clusters of {c}", fused.PHASES
    stamped()  # warm-up
    y, stamps = stamped()
    torch.cuda.synchronize()
    if not torch.equal(y, plain()):
        raise SystemExit(f"n={n}: the stamped kernel differs from the kernel")
    report(what, stamps, phases, median_ms(stamped), median_ms(plain))
    del x, y, stamps
    torch.cuda.empty_cache()


def main() -> None:
    import numpy as np
    import torch

    from rustfft_tpu_torch import FftPlanner, recipes, route
    from rustfft_tpu_torch.ops.kernels import conv, convlarge

    if not torch.cuda.is_available():
        raise SystemExit("torch_phase_times: needs an NVIDIA GPU")
    shapes = [tuple(int(v) for v in a.split(":")) for a in sys.argv[1:]] or SHAPES
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, batch in shapes:
        if route(n, np.complex64) == "two_stage":
            two_stage_phases(n, batch, gen)
            continue
        recipe = FftPlanner(np.complex64, device="cpu").plan_fft_forward(n).recipe
        if (isinstance(recipe, (recipes.Raders, recipes.Bluesteins))
                and conv.conv_supported(recipe.inner.length, np.complex64)):
            conv_phases(n, recipe.inner.length, batch, gen)
            continue
        if (isinstance(recipe, recipes.Bluesteins)
                and convlarge.bconv_supported(recipe.inner.length, np.complex64)):
            bluestein_large_phases(n, recipe.inner.length, batch, gen)
            continue
        if route(n, np.complex64) in ("lanepack", "dense"):
            lanepack_phases(n, batch, gen)
            continue
        if route(n, np.complex64) == "large_pad":
            largepad_phases(n, batch, gen)
            continue
        if route(n, np.complex64) == "radix":
            radix_phases(n, batch, gen)
            continue
        if route(n, np.complex64) == "large":
            large_phases(n, batch, gen)
            continue
        if route(n, np.complex64) == "large2f":
            large2f_phases(n, batch, gen)
            continue
        raise SystemExit(f"n={n}: no stamped kernel for its route {route(n, np.complex64)}")


if __name__ == "__main__":
    main()
