#!/usr/bin/env python3
"""Count the sizes each route of the PyTorch/CUDA port serves.

Run from the repository root; it needs no GPU:

    python3 tools/torch_routes.py [LO HI]

For complex64 and every n in [LO, HI) (default [14464, 2^20), about four
minutes on one CPU core) prints how many sizes `rustfft_tpu_torch.route`
sends to each route, with the first few of each.  It shows how far a route
rule reaches beyond the sizes its tests pin: for example how many of the
sizes with a `large` split go to `large_pad` (largepad.narrowed_by_division).
"""
from __future__ import annotations

import os
import sys
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from rustfft_tpu_torch import route  # noqa: E402


def main() -> None:
    lo, hi = (int(a) for a in sys.argv[1:3]) if len(sys.argv) > 2 else (14464, 1 << 20)
    counts: Counter = Counter()
    first: dict = {}
    for n in range(lo, hi):
        name = route(n, np.complex64)
        counts[name] += 1
        if len(first.setdefault(name, [])) < 5:
            first[name].append(n)
    print(f"routes of complex64 n in [{lo}, {hi}):")
    for name, count in counts.most_common():
        print(f"  {name}: {count} sizes (first {', '.join(map(str, first[name]))})")


if __name__ == "__main__":
    main()
