#!/usr/bin/env python3
"""Hold K7's kernels against their plain versions on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 tools/torch_k7_check.py

Builds the kernels and prints the card's name and power limit, the
build's seconds, the registers and local memory of the four forms of K7's
kernels (`fused.two_stage_attrs`: the cluster kernel and the one-block
kernel, each with and without the Bluestein stage) and the clusters the
card holds at once at each c.  Then, at 21 sizes of both bands (every
factored radix, the Bluestein forms, the direct sums, ragged shares, odd
p), at batch 1, 3 and 33 and both directions, the kernel the route runs
(`two_stage_fft` or `two_stage_cluster_fft`) with the outer twiddle as
(q, p) and, where the path transposes it (`fused.outer_transposed`), as
(p, q), against its plain version on the same tables (relative mean
error, 1e-6), each at batch 3 printed; and K8 (`three_stage_fft`) at
eight sizes of its cluster form.  The last line is "FAILS <count>"; the
exit code is 1 where any check failed.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rustfft_tpu_torch.common import FftDirection  # noqa: E402
from rustfft_tpu_torch.ops.kernels import _build, fused, large  # noqa: E402

#: the one-block band (24576 = (16, 12); 14976 and 15232 the factored 9 and
#: 7; 14464, 16256 and 28544 a Bluestein stage, p odd) and the cluster band
#: (register radices, Bluestein stages, ragged row shares, direct sums and
#: the factored 10, 15, 14 and 20)
SIZES = (24576, 14464, 16256, 28544, 14976, 15232, 28928, 32896, 49152, 98304, 196608, 245760,
         260608, 261632, 29184, 40832, 132480, 32000, 48000, 89600, 128000)
K8_SIZES = (32768, 49152, 65536, 98304, 131072, 147456, 229376, 262144)
TOL = 1e-6


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_k7_check: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.time()
    _build.load()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    for one_block in (False, True):
        for bluestein in (False, True):
            print(f"{'one-block' if one_block else 'cluster'} kernel, bluestein={bluestein}: "
                  f"(registers, local bytes) {fused.two_stage_attrs(bluestein, one_block)}",
                  flush=True)
    print("resident clusters", {c: fused.two_stage_cluster_max_active_clusters(c)
                                for c in fused.CLUSTER_SIZES}, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def card(host):
        return tuple([torch.from_numpy(a).to(dev) for a in t] if isinstance(t, list)
                     else torch.from_numpy(t).to(dev) for t in host)

    def rel(a, b):
        return ((a - b).abs().double().mean() / b.abs().double().mean()).item()

    fails = 0
    for n in SIZES:
        p, q = fused.choose_pq(n)
        one = fused.two_stage_supported(n, np.complex64)
        c = None if one else fused.choose_cluster(n)
        for batch in (1, 3, 33):
            x = torch.randn((batch, n), dtype=torch.complex64, generator=gen, device=dev)
            for d in (FftDirection.FORWARD, FftDirection.INVERSE):
                host = fused.two_stage_tables(p, large.stage_radices(q), d)
                t = card(host)
                opq = fused.outer_transposed(p, host[2])
                layouts = {"(q, p)": None}
                if opq is not None:
                    layouts["(p, q)"] = torch.from_numpy(opq).to(dev)
                want = fused.two_stage_fft_plain(x, p, q, t)
                for name, o in layouts.items():
                    got = (fused.two_stage_fft(x, p, q, t, o) if one
                           else fused.two_stage_cluster_fft(x, p, q, c, t, o))
                    torch.cuda.synchronize()
                    e = rel(got, want)
                    ok = e <= TOL
                    fails += not ok
                    if not ok or batch == 3:
                        print(f"n={n} {p}x{q} {large.stage_radices(p)}x{large.stage_radices(q)} "
                              f"{'one block' if one else f'c={c}'} outer {name} batch={batch} "
                              f"{d.name}: {e:.3e} {'ok' if ok else 'FAIL'}", flush=True)
            del x
    for n in K8_SIZES:
        p, q1, q2 = fused.choose_pqq_fused(n)
        x = torch.randn((3, n), dtype=torch.complex64, generator=gen, device=dev)
        t = card(fused.three_stage_tables(p, q1, q2, FftDirection.FORWARD))
        e = rel(fused.three_stage_fft(x, p, q1, q2, t), fused.three_stage_fft_plain(x, p, q1, q2, t))
        fails += not e <= TOL
        print(f"K8 {n} {fused.three_stage_form(n)}: {e:.3e} {'ok' if e <= TOL else 'FAIL'}",
              flush=True)
    print("FAILS", fails, flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
