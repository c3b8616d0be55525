"""Plans are immutable and shareable across threads: the PyTorch/CUDA port's
counterpart of examples/concurrency.py (reference examples/concurrency.rs:1-30,
where plans are `Sync + Send`).

    python3 examples/torch_concurrency.py [--device cuda]

At one size on each of three routes (4096 on lanepack, the prime 1009 on
the one-pass convolution core, 2^20 on large), in a process that has
transformed none of them yet, two rounds of four threads released together:

1. each thread makes its own planner and plan and transforms its own tensor:
   the first `process` call of the size happens inside the threads, so the
   cache of built functions that executor.build shares between planners, the
   device tables and (on the card) the kernels' library build are contended.
   Every thread's plan must run the one function the cache holds;
2. one plan, shared by the four threads, each transforming its own tensor.

Each output is held against torch.fft in complex128 (relative mean error
<= 1e-5).  The check raises on a failure; chip_smoke.py runs it in-process.
"""
import argparse
import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rustfft_tpu_torch import FftPlanner  # noqa: E402

SIZES = (4096, 1009, 1 << 20)
THREADS = 4
TOL = 1e-5
#: seconds a round may take before the check fails
TIMEOUT = 600


def in_threads(work):
    """work(i) in THREADS threads started together; their results in
    order.  Raises the first exception a thread raised, or if a thread has
    not finished within TIMEOUT."""
    barrier = threading.Barrier(THREADS)
    results, errors = [None] * THREADS, []

    def run(i):
        try:
            barrier.wait()
            results[i] = work(i)
        except Exception as exc:  # noqa: BLE001 - re-raised in the caller below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"a thread did not finish within {TIMEOUT} s")
    if errors:
        raise errors[0]
    return results


def rel_err(got: torch.Tensor, x: torch.Tensor) -> float:
    want = torch.fft.fft(x.to(torch.complex128))
    return float((got.to(torch.complex128) - want).abs().mean() / want.abs().mean())


def check(device: str = "cuda", batch: int = 2):
    """Both rounds at each of SIZES: [(n, round, thread, relative mean
    error)].  Raises when an error exceeds TOL or round 1's plans run
    different functions."""
    out = []
    for n in SIZES:
        gens = [torch.Generator(device=device).manual_seed(1000 * n + i) for i in range(THREADS)]
        inputs = [torch.randn((batch, n), dtype=torch.complex64, generator=g, device=device)
                  for g in gens]

        def own_plan(i):
            plan = FftPlanner(np.complex64, device=device).plan_fft_forward(n)
            return plan, plan.process(inputs[i])

        firsts = in_threads(own_plan)
        if len({id(plan.raw_fn) for plan, _ in firsts}) != 1:
            raise AssertionError(f"n={n}: the threads' plans run different built functions")
        shared = firsts[0][0]
        seconds = in_threads(lambda i: shared.process(inputs[i]))
        for rnd, outputs in ((1, [y for _, y in firsts]), (2, seconds)):
            for i, y in enumerate(outputs):
                err = rel_err(y, inputs[i])
                if not err <= TOL:
                    raise AssertionError(f"n={n} round {rnd} thread {i}: relative mean error "
                                         f"{err:.3e} > {TOL:.0e}")
                out.append((n, rnd, i, err))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for n, rnd, i, err in check(args.device):
        what = "own plan" if rnd == 1 else "shared plan"
        print(f"n={n} {what}, thread {i}: rel err = {err:.2e}")


if __name__ == "__main__":
    main()
