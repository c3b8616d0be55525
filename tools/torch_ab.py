#!/usr/bin/env python3
"""Time the PyTorch/CUDA port of several checkouts in turns on one GPU.

Run from the repository root, naming each checkout in the order to run it
(for example a parent unpacked with `git archive` into tmp_chip/parent,
then this tree twice, then the parent again):

    python3 tools/torch_ab.py [--only GROUP,...] tmp_chip/parent . . tmp_chip/parent

Each checkout runs in its own process (its own import of rustfft_tpu_torch
and its own kernel build) and times, with CUDA events (median of 7 after 2
warm-ups; of 15 for the paths other than 2^20): K1 (`lanepack_fft` on
the checkout's own chain and tables, at K1 below), K2 and K3 (`large_col_stage`, `large_row_stage`,
64 x 2^20, median of 15; K3 also at K10's and K11's Q passes, 8 x 4096 x
2048 and 2 x 4096 x 16384) with
the paths through them (LARGE_PATHS: 2^20 x 1024, 2^23 x 8, 2^26 x 2,
65537 x 512, and 2^20 x 1 and x 4 as the device's time a call, queued as
below) and, where the checkout has it, the access-pattern probe of K3's
tile (`large.copy_probe`: a copy of the 64 x 2^20 input by K3's grid in
32-byte segments of rows 2 KiB apart, against a copy of the same bytes in
consecutive 128 KiB, and `clone`), and the paths 4096 x 16384, 2^20 x 1024,
1009 x 8192, 1234 x 8192, 7919 x 4096 and 65537 x 512, and the one-block
two-stage paths 14464 x 4096 (p = 113) and 16256 x 4096 (p = 127), and
the cluster paths 28928 x 4096 (226 = 113 x 2) and 260608 x 256 (509 x 512),
whose prime runs a Bluestein stage, and 24576 x 2048, 49152 x 2048 and
98304 x 1024, whose radices are all register stages, and the large_pad
paths (K12) at the odd composites 15625 x 4096, 78125 x 512, 177147 x 256
and 531441 x 64 and at the route's bulk 234617 x 256 (P = 373, a
1024-point Bluestein stage), 775575 x 64 (P = 383; Q = 15 x 15 x 9, direct
sums), 412519 x 128 (P = 131; Q = 67 x 47) and 50666 x 1024 (P = 11 x 7
x 2; Q = 47 x 7), through FftPlanner(np.complex64, device="cuda"), and
K12's two stages alone at each large_pad path (`largepad_col_stage`,
`largepad_row_stage`; a tree whose largepad module has no `col_tables`
takes large's tables, as K12 did before its in-place chain), K1's paths
and kernel at 4096 x 16384, 8192 x 8192, 1024 x 65536, 64 x 1048576,
1000 x 65536, 2008 x 32768 and 12288 x 5120 (a tree whose lanepack module
has no `chain_tables` takes its `stage_tables`, as K1 did before the
in-place chain), and K5's paths 127 x 262144, 251 x 131072 and 29 x
2097152, each of K1's and K5's shapes also through torch.fft, and K9's
mid band: `radix_fft` alone and the planner's path at 32768 x 2048, 65536
x 1024, 131072 x 512 and 262144 x 256, `two_stage_fft` alone and the path
at 16384 x 4096 (the radix body at R = 1), each also through torch.fft,
and the kernels alone at small batches, 16384 x 8, 32768 x 4 and 262144
x 4 (a cluster's single transform, where a launch's latency counts; the
device's time a call, 50 calls queued behind a sleep kernel so that the
host's launch overhead is hidden, median of 7), and K16:
`permute` alone at 8192 x 1008 (the 1009 path's gather) beside
torch.index_select, and K15 (the fused large Bluestein): kernel A, B_conv
and A2 alone at 64 x 1000003 (m = 2^21), the paths 1000003 x 64 and 24571 x 2048 with torch.fft, and K14 (the
two-pass convolution core): the Rader core (gather, sums, scatter,
full_out) and the plain core at 512 x 65536, the gather probe where the
checkout has it (`conv_radix.gather_probe`: 8-byte reads and writes at the
65537 Rader permutation against a streaming copy), the paths 65537 x 512,
7919 x 4096 and 746497 x 64 with torch.fft, and K9's band as in K9; and,
for the paths K15_GENERAL (524309 x 64, 393241 x 64, 294919 x 128) and
K14_FOUR (746497 x 64, 196613 x 256, 88589 x 512), each launch of the
path's core alone on the inputs the path gave it (recorded through the
RECORDED wrappers: K15's kernel A, B_conv and A2 in whichever form the
checkout runs; K14's col1, row1, col2, row2), the path and torch.fft.
`--only` keeps the named groups of these (K1, K2 for K2 and K3, paths for
the planner's paths and K1's and K5's torch.fft, K9, K16, K12, K15,
K14).  It prints one JSON line per run and then a table, each row a
quantity and each column a run.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

PATHS = ((4096, 16384), (1 << 20, 1024), (1009, 8192), (1234, 8192), (7919, 4096), (65537, 512),
         (14464, 4096), (16256, 4096), (24576, 2048), (28928, 4096), (260608, 256), (49152, 2048),
         (98304, 1024))

#: the large_pad paths (K12): the odd composites and the route's bulk
PAD = ((15625, 4096), (78125, 512), (177147, 256), (531441, 64), (234617, 256), (775575, 64),
       (412519, 128), (50666, 1024))

#: K1's shapes (the pipelined kernel at 4096, the chain kernel elsewhere)
#: and K5's (the dense route's primes), about 512 MiB each
K1 = ((4096, 16384), (8192, 8192), (1024, 65536), (64, 1 << 20), (1000, 65536), (2008, 32768),
      (12288, 5120))
K5 = ((127, 262144), (251, 131072), (29, 1 << 21))

#: K9's four sizes (r = 2, 4, 8, 16) and the radix body at R = 1 (K7's
#: 16384), 512 MiB each
K9 = ((1 << 15, 2048), (1 << 16, 1024), (1 << 17, 512), (1 << 18, 256), (16384, 4096))

#: the same kernels at batches of at most one transform a cluster
K9_SMALL = ((16384, 8), (1 << 15, 4), (1 << 18, 4))

#: the paths through K2 and K3 (the 2^20 main path at the flagship batch
#: cut to the card and at batches of one and four transforms) and through
#: K3's body (the top band's Q pass, K14's two-pass core at m = 65536)
LARGE_PATHS = ((1 << 20, 1024), (1 << 23, 8), (1 << 26, 2), (65537, 512), (1 << 20, 1),
               (1 << 20, 4))

#: the paths through K15 (the fused large Bluestein: 1000003 at m = 2^21,
#: 24571 at m = 49152) and K14 (the two-pass core: the Rader 65537 at m =
#: 65536, the Bluestein 7919 at m = 16384, the Rader 746497 at m = 746496)
K15_PATHS = ((1000003, 64), (24571, 2048))
K14_PATHS = ((65537, 512), (7919, 4096), (746497, 64))

#: the paths whose kernels are timed one by one, each launch alone on the
#: inputs the path gave it (recorded): K15 at the general form's most
#: common inner lengths (m = 1572864, 2^20, 786432 at P = 256: Q = 6144,
#: 4096, 3072) and K14's four stages (the Rader 746497 at m = 746496 = 256
#: x 2916, the Bluesteins 196613 at m = 419904 = 243 x 1728 and 88589 at
#: m = 186624 = 256 x 729)
K15_GENERAL = ((524309, 64), (393241, 64), (294919, 128))
K14_FOUR = ((746497, 64), (196613, 256), (88589, 512))

#: the kernel wrappers of the two cores, by module, with the name each
#: launch is timed under (K15's general and tile kernels share a name)
RECORDED = {
    "conv_radix": {"conv_col_stage": "col", "conv_row_stage": "row"},
    "convlarge": {"bconv_col_tile": "kernel A", "bconv_row_stage": "B_conv",
                  "bconv_row_tile": "B_conv", "bconv_out_stage": "A2", "bconv_out_tile": "A2"},
}

GROUPS = ("K1", "K2", "paths", "K9", "K16", "K12", "K15", "K14")


def run_one(root: str, groups=GROUPS) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from rustfft_tpu_torch import FftDirection, FftPlanner
    from rustfft_tpu_torch.ops.kernels import fused, lanepack, large, largepad, permute

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def ms(fn, reps=7, warmup=2):
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

    def queued_ms(fn, calls=50, reps=7):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(50_000_000)  # cycles: longer than the host takes to queue the calls
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / calls)
        return statistics.median(times)

    def on(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    def recorded(fn):
        """[(label, wrapper, args, kwargs)] of the RECORDED wrappers fn()
        called, in order (each call still runs)."""
        import importlib

        calls, saved = [], []
        for mod_name, names in RECORDED.items():
            mod = importlib.import_module(f"rustfft_tpu_torch.ops.kernels.{mod_name}")
            for name, label in names.items():
                orig = getattr(mod, name, None)
                if orig is None:
                    continue

                def wrap(*args, _orig=orig, _label=label, **kw):
                    calls.append((_label, _orig, args, kw))
                    return _orig(*args, **kw)

                wrap.launches = getattr(orig, "launches", 0)  # the wrapper counts through it
                saved.append((mod, name, orig))
                setattr(mod, name, wrap)
        try:
            fn()
        finally:
            for mod, name, orig in saved:
                setattr(mod, name, orig)
        return calls

    def kernels_alone(group, n, batch, first=None):
        """Each launch of the path n x batch alone (K14: col and row of pass 1,
        then pass 2; K15: kernel A, B_conv, A2, where `first` names the
        leading column stage), then the path and torch.fft."""
        torch.cuda.empty_cache()
        x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
        plan = planner.plan_fft_forward(n)
        calls = recorded(lambda: plan.process(x))
        seen = {}
        for label, wrapper, args, kw in calls:
            if first is not None and label == "col":
                label = first
            seen[label] = seen.get(label, 0) + 1
            key = f"{group} {label}{seen[label] if group == 'K14' else ''} {n}x{batch}"
            out[key] = ms(lambda: wrapper(*args, **kw), reps=15)
        del calls
        out[f"path {n}x{batch}"] = ms(lambda: plan.process(x), reps=15)
        out[f"torch.fft {n}x{batch}"] = ms(lambda: torch.fft.fft(x), reps=15)
        del x

    out = {}
    k1_tables = getattr(lanepack, "chain_tables", lanepack.stage_tables)
    for n, batch in K1 if "K1" in groups else ():
        torch.cuda.empty_cache()
        radices = lanepack.choose_radices(n)
        x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
        tables = tuple(on(t) for t in k1_tables(n, radices, FftDirection.FORWARD))
        out[f"K1 lanepack_fft {n}x{batch}"] = ms(lambda: lanepack.lanepack_fft(x, radices, tables),
                                                 reps=15)
        del x
    if "K2" in groups:
        n = 1 << 20
        p, q1, q2 = large.choose_pqq(n)
        q = q1 * q2
        r, t, outer = large.col_tables(p, q, FftDirection.FORWARD)
        col = (on(r), on(t), on([outer])[0])
        row = tuple(on(v) for v in large.row_tables(q, FftDirection.FORWARD))
        x = torch.randn((64, n), dtype=torch.complex64, generator=gen, device=dev)
        a = large.large_col_stage(x, p, q, col)
        out["K2 large_col_stage 64x2^20"] = ms(lambda: large.large_col_stage(x, p, q, col),
                                               reps=15)
        out["K3 large_row_stage 64x2^20"] = ms(lambda: large.large_row_stage(a, q, p, row),
                                               reps=15)
        if hasattr(large, "copy_probe"):
            y = large.copy_probe(x, p, True)
            if not torch.equal(y, x) or not torch.equal(large.copy_probe(x, p, False), x):
                raise SystemExit("copy_probe: the copy differs from its input")
            for strided in (True, False):
                out[f"probe {'K3 pattern' if strided else 'streaming'} 64x2^20"] = ms(
                    lambda: large.copy_probe(x, p, strided), reps=15)
            out["clone 64x2^20"] = ms(lambda: x.clone(), reps=15)
            del y
        del x, a
        # K3 at P = 2048 and 16384 (K10's Q pass at 2^23 x 8, K11's at 2^26 x 2)
        row = tuple(on(v) for v in large.row_tables(q, FftDirection.FORWARD))
        for batch, p in ((8, 2048), (2, 16384)):
            a = torch.randn((batch, q, p), dtype=torch.complex64, generator=gen, device=dev)
            out[f"K3 large_row_stage {batch}x4096x{p}"] = ms(
                lambda: large.large_row_stage(a, q, p, row), reps=15)
            del a
        planner = FftPlanner(np.complex64, device="cuda")
        for n, batch in LARGE_PATHS:
            torch.cuda.empty_cache()
            x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
            plan = planner.plan_fft_forward(n)
            if n * batch <= 1 << 22:
                out[f"path {n}x{batch} (queued)"] = queued_ms(lambda: plan.process(x))
            else:
                out[f"path {n}x{batch}"] = ms(lambda: plan.process(x),
                                              reps=7 if n * batch >= 1 << 30 else 15)
            del x
    planner = FftPlanner(np.complex64, device="cuda")
    # K1[0] is PATHS[0]
    for n, batch in PATHS + PAD + K1[1:] + K5 if "paths" in groups else ():
        torch.cuda.empty_cache()
        x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
        plan = planner.plan_fft_forward(n)
        out[f"path {n}x{batch}"] = ms(lambda: plan.process(x), reps=7 if n == 1 << 20 else 15)
        if (n, batch) in K1 + K5:
            out[f"torch.fft {n}x{batch}"] = ms(lambda: torch.fft.fft(x), reps=15)
        del x
    if "K15" in groups:
        from rustfft_tpu_torch.ops.kernels import conv_radix, convlarge

        n, m, batch = 1000003, 1 << 21, 64
        p, q1, q2 = large.choose_pqq(m)
        q = q1 * q2
        host = convlarge.bconv_tables(n, m, p, q, FftDirection.FORWARD)
        col = (on(host["col"][0]), on(host["col"][1]), on([host["col"][2]])[0])
        row = tuple(on(v) for v in host["row"])
        pre, h, chirp = on([host[k] for k in ("pre", "h", "chirp")])
        x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
        if hasattr(convlarge, "tile_form"):  # the tile form, in column pairs
            h2, outer2 = on([convlarge.bconv_h_table(host["h"])])[0], convlarge.to_columns(col[2])
            row = tuple(on(v) for v in convlarge.bconv_chain_tables(FftDirection.FORWARD))
            kernel_a = lambda: convlarge.bconv_col_tile(x, p, q, col, pre)  # noqa: E731
            a = kernel_a()
            b_conv = lambda: convlarge.bconv_row_tile(a, q, p, row, h2, outer2)  # noqa: E731
            b = b_conv()
            a2 = lambda: convlarge.bconv_out_tile(b, p, q, col[:2], chirp, n)  # noqa: E731
        else:
            kernel_a = lambda: conv_radix.conv_col_stage(x, p, q, col, pre=pre)[0]  # noqa: E731
            a = kernel_a()
            b_conv = lambda: convlarge.bconv_row_stage(a, q, p, row, h, col[2])  # noqa: E731
            b = b_conv()
            a2 = lambda: convlarge.bconv_out_stage(b, p, q, col[:2], chirp, n)  # noqa: E731
        out[f"K15 kernel A {batch}x{n}"] = ms(kernel_a, reps=15)
        out[f"K15 B_conv {batch}x2^21"] = ms(b_conv, reps=15)
        out[f"K15 A2 {batch}x2^21"] = ms(a2, reps=15)
        del x, a, b
        for n, batch in K15_PATHS:
            torch.cuda.empty_cache()
            x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
            plan = planner.plan_fft_forward(n)
            out[f"path {n}x{batch}"] = ms(lambda: plan.process(x), reps=15)
            out[f"torch.fft {n}x{batch}"] = ms(lambda: torch.fft.fft(x), reps=15)
            del x
        for n, batch in K15_GENERAL:
            kernels_alone("K15", n, batch, first="kernel A")
    if "K14" in groups:
        from rustfft_tpu_torch.ops.kernels import conv_radix
        from rustfft_tpu_torch.ops.raders import raders_tables

        torch.cuda.empty_cache()
        m, batch = 65536, 512
        perm_in, inv_gather, b_fft = raders_tables(m + 1, FftDirection.FORWARD)
        rader = conv_radix.make_radix_conv_fn(
            m, FftDirection.FORWARD, np.complex64, h=b_fft, conj_out=True, in_perm=perm_in - 1,
            out_perm=inv_gather, x0_add=True, emit_sum=True, full_out=True)
        blue = conv_radix.make_radix_conv_fn(m, FftDirection.FORWARD, np.complex64, h=b_fft)
        x = torch.randn((batch, m), dtype=torch.complex64, generator=gen, device=dev)
        x0 = torch.randn((batch, 1), dtype=torch.complex64, generator=gen, device=dev)
        out[f"K14 Rader core {batch}x{m}"] = ms(lambda: rader(x, x0), reps=15)
        out[f"K14 plain core {batch}x{m}"] = ms(lambda: blue(x), reps=15)
        if hasattr(conv_radix, "gather_probe"):
            idx = torch.from_numpy((perm_in - 1).astype(np.int32)).to(dev)
            for mode in conv_radix.GATHER_MODES:
                out[f"probe {mode} {batch}x{m}"] = ms(
                    lambda: conv_radix.gather_probe(x, idx, mode), reps=15)
        del x
        for n, batch in K14_PATHS:
            torch.cuda.empty_cache()
            x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
            plan = planner.plan_fft_forward(n)
            out[f"path {n}x{batch}"] = ms(lambda: plan.process(x), reps=15)
            out[f"torch.fft {n}x{batch}"] = ms(lambda: torch.fft.fft(x), reps=15)
            del x
        for n, batch in K14_FOUR:
            kernels_alone("K14", n, batch)
    for n, batch in K9 + K9_SMALL if {"K9", "K14"} & set(groups) else ():
        torch.cuda.empty_cache()
        x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
        r = n // (128 * 128)
        time = (lambda fn: ms(fn, reps=15)) if (n, batch) in K9 else queued_ms
        if r > 1:
            tabs = tuple(on(t) if isinstance(t, list) else on([t])[0]
                         for t in fused.radix_tables(r, 128, 128, FftDirection.FORWARD))
            out[f"K9 radix_fft {n}x{batch}"] = time(lambda: fused.radix_fft(x, r, 128, tabs))
        else:
            tabs = tuple(on(t) if isinstance(t, list) else on([t])[0]
                         for t in fused.two_stage_tables(128, large.stage_radices(128),
                                                         FftDirection.FORWARD))
            out[f"K7 two_stage_fft {n}x{batch}"] = time(
                lambda: fused.two_stage_fft(x, 128, 128, tabs))
        if (n, batch) in K9:
            plan = planner.plan_fft_forward(n)
            out[f"path {n}x{batch}"] = ms(lambda: plan.process(x), reps=15)
            out[f"torch.fft {n}x{batch}"] = ms(lambda: torch.fft.fft(x), reps=15)
        del x
    if "K16" in groups:
        m = 1008
        idx = torch.from_numpy(permute.permutation_index(
            np.random.default_rng(m).permutation(m))).to(dev)
        x = torch.randn((8192, m), dtype=torch.complex64, generator=gen, device=dev)
        out[f"K16 permute 8192x{m}"] = ms(lambda: permute.permute(x, idx), reps=31)
        out[f"index_select 8192x{m}"] = ms(lambda: torch.index_select(x, 1, idx), reps=31)
        del x
    pad_tables = getattr(largepad, "col_tables", None)
    for n, batch in PAD if "K12" in groups else ():
        torch.cuda.empty_cache()
        p, q1, q2 = large.choose_pqq(n)
        q = q1 * q2
        if pad_tables is not None:
            r, t, outer = largepad.col_tables(p, q, FftDirection.FORWARD)
            rows = largepad.row_tables(q, FftDirection.FORWARD)
        else:
            r, t, outer = large.col_tables(p, q, FftDirection.FORWARD)
            rows = large.row_tables(q, FftDirection.FORWARD)
        col = (on(r), on(t), on([outer])[0])
        row = tuple(on(v) for v in rows)
        x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
        a = largepad.largepad_col_stage(x, p, q, col)
        out[f"K12 col {n}x{batch}"] = ms(lambda: largepad.largepad_col_stage(x, p, q, col), reps=15)
        out[f"K12 row {n}x{batch}"] = ms(lambda: largepad.largepad_row_stage(a, q, p, row), reps=15)
        del x, a
    return out


def main() -> None:
    if len(sys.argv) > 3 and sys.argv[1] == "--one":
        print(json.dumps(run_one(sys.argv[2], sys.argv[3].split(","))), flush=True)
        return
    roots, groups = sys.argv[1:], ",".join(GROUPS)
    if roots[:1] == ["--only"]:
        groups, roots = roots[1], roots[2:]
        unknown = set(groups.split(",")) - set(GROUPS)
        if unknown:
            raise SystemExit(f"torch_ab: unknown groups {sorted(unknown)}; known {GROUPS}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, groups],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{root}: exit {proc.returncode}\n{proc.stdout}{proc.stderr}")
        line = proc.stdout.strip().splitlines()[-1]
        print(f"{root}: {line}", flush=True)
        runs.append(json.loads(line))
    print("ms (CUDA events, median); runs: " + ", ".join(roots))
    for key in runs[0]:
        print(f"  {key:32s} " + " ".join(f"{r[key]:9.3f}" for r in runs))


if __name__ == "__main__":
    main()
