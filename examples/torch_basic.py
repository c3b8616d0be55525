"""Basic usage of the PyTorch/CUDA port: the counterpart of examples/basic.py
(the reference README example, rustfft README.md:14-27).

    python3 examples/torch_basic.py [--device cuda]

A forward FFT of size 1234 through the planner: an impulse (a flat
spectrum), a batch of 8 (any buffer of k * len elements is k transforms,
lib.rs:200-209) and the round trip (unnormalized: forward then inverse
scales by n, lib.rs:81-86), each printed with its error against numpy.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from rustfft_tpu_torch import FftPlanner  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    planner = FftPlanner(np.complex64, device=args.device)
    fft = planner.plan_fft_forward(1234)

    buffer = np.zeros(1234, dtype=np.complex64)
    buffer[0] = 1.0  # impulse -> flat spectrum
    spectrum = fft.process(buffer)
    print("spectrum[:4] =", spectrum[:4])
    print(f"impulse max err: {np.abs(spectrum - 1.0).max():.2e}")

    # batched: any buffer of k * len elements is processed as k chunks
    rng = np.random.default_rng(0)
    batch = (rng.standard_normal((8, 1234)) + 1j * rng.standard_normal((8, 1234))).astype(
        np.complex64)
    out = fft.process(batch)
    print("batch output shape:", out.shape)
    want = np.fft.fft(batch.astype(np.complex128))
    print(f"batch rel err: {np.abs(out - want).mean() / np.abs(want).mean():.2e}")

    # unnormalized: forward then inverse scales by n
    inverse = planner.plan_fft_inverse(1234)
    roundtrip = inverse.process(fft.process(batch)) / 1234
    print(f"roundtrip max err: {np.abs(roundtrip - batch).max():.2e}")


if __name__ == "__main__":
    main()
