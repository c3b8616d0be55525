#!/usr/bin/env python3
"""Run the port's multi-device layer across gloo ranks on the CPU.

    python3 tools/torch_dryrun.py [--ranks 4] [--out DIR] [--timeout 300]

Starts `--ranks` processes (spawned, one CPU thread each) that join one
gloo process group through a `file://` rendezvous in a temporary directory
(no ports, no network), build the meshes of rustfft_tpu_torch.parallel and
run every case of `make_cases` on them.  Each rank writes its output shard of each
case, and rank 0 each case's global input, as .npy files (under `--out`, or
a temporary directory), with `cases.json` describing the cases.  The parent
then assembles each case's shards and holds them against the float64 numpy
oracle: relative mean error <= 1e-5 for complex64, 1e-12 for complex128.

The cases are those of the JAX package's multi-chip dryrun
(`__graft_entry__.dryrun_multichip`): the spectral step at n = side^2, at
2^16 with the batch and the fft axis sharded at once, on a deep fft axis
(fft = 4) and in complex128; and beside them the distributed FFT on the
(data, fft) and the deep mesh in both directions and both dtypes, with the
batch replicated, with an explicit split, and the batch-sharded FFT.

The script exits non-zero when a rank raises, a check fails, or the ranks do
not finish within `--timeout` seconds (the parent then terminates them).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: relative mean error bound against the float64 oracle, by dtype
TOLERANCE = {"complex64": 1e-5, "complex128": 1e-12}


def make_cases(world: int):
    """The cases every rank runs, in order: dicts of kind ("step",
    "distributed" or "batch"), mesh (sizes, names), n, dtype, direction,
    batch, batch_axis, split and seed."""
    # imported here, after the caller has put the repository on sys.path
    from rustfft_tpu_torch.parallel.mesh import split_devices_2d

    data, fft = split_devices_2d(world)
    fft_b = 4 if world % 4 == 0 else fft
    data_b = world // fft_b
    side = 16 if 16 % fft == 0 else 16 * fft
    names = ("data", "fft")
    cases = []

    def add(name, kind, mesh, n, dtype="complex64", direction="forward", batch=None,
            batch_axis="data", split=None):
        cases.append(dict(name=name, kind=kind, mesh=[list(mesh[0]), list(mesh[1])], n=n,
                          dtype=dtype, direction=direction,
                          batch=batch if batch is not None else 2 * mesh[0][0],
                          batch_axis=batch_axis, split=split, seed=len(cases)))

    # the JAX dryrun's four cases
    add("step_tiny", "step", ((data, fft), names), side * side)
    add("step_2^16", "step", ((data, fft), names), 1 << 16, batch=8 * data)
    if fft_b > fft:
        add("step_deep", "step", ((data_b, fft_b), names), 1 << 16, batch=8 * data_b)
    add("step_c128", "step", ((data, fft), names), side * side, dtype="complex128")
    # the distributed FFT on both meshes, both directions, both dtypes
    for mesh in dict.fromkeys([(data, fft), (data_b, fft_b)]):
        for dtype in ("complex64", "complex128"):
            for direction in ("forward", "inverse"):
                add(f"fft_{mesh[0]}x{mesh[1]}_{dtype}_{direction}", "distributed",
                    (mesh, names), 2304, dtype=dtype, direction=direction)
    add("fft_replicated", "distributed", ((data, fft), names), 256, batch=3, batch_axis=None)
    # an explicit split, not choose_split's, with non-trivial local recipes
    add("fft_split", "distributed", ((data_b, fft_b), names), 12288, split=[48, 256])
    add("batch_sharded", "batch", (((world,), ("data",))), 128)
    return cases


def case_input(case) -> np.ndarray:
    """The case's global (batch, n) input, from its seed."""
    rng = np.random.default_rng(1000 + case["seed"])
    shape = (case["batch"], case["n"])
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return x.astype(case["dtype"])


def shard_path(out: str, case, coord) -> str:
    return os.path.join(out, f"{case['name']}.{'.'.join(str(c) for c in coord)}.npy")


def _slices(case, coord):
    """(rows, columns) of the global array that the rank at coord holds."""
    sizes, names = case["mesh"]
    at = dict(zip(names, coord))
    size = dict(zip(names, sizes))
    b, n = case["batch"], case["n"]
    rows = slice(None)
    if case["batch_axis"] is not None:
        k = b // size["data"]
        rows = slice(at["data"] * k, (at["data"] + 1) * k)
    cols = slice(None)
    if "fft" in size and case["kind"] != "batch":
        k = n // size["fft"]
        cols = slice(at["fft"] * k, (at["fft"] + 1) * k)
    return rows, cols


def assemble(out: str, case) -> np.ndarray:
    """The case's global output from its shards; ranks that hold the same
    rows (a replicated batch) must hold the same values."""
    import itertools

    sizes, _ = case["mesh"]
    got = np.full((case["batch"], case["n"]), np.nan + 0j, dtype=case["dtype"])
    seen = np.zeros(got.shape, dtype=bool)
    for coord in itertools.product(*(range(s) for s in sizes)):
        shard = np.load(shard_path(out, case, coord))
        rows, cols = _slices(case, coord)
        if seen[rows, cols].any():
            if not np.array_equal(got[rows, cols], shard):
                raise AssertionError(f"{case['name']}: replicated shards at {coord} differ")
        got[rows, cols] = shard
        seen[rows, cols] = True
    if not seen.all():
        raise AssertionError(f"{case['name']}: shards leave part of the output unset")
    return got


def oracle(case, x: np.ndarray) -> np.ndarray:
    """The float64 result the case must reach."""
    x = x.astype(np.complex128)
    if case["kind"] == "step":
        n = case["n"]
        k = np.arange(n)
        filt = np.exp(-((np.minimum(k, n - k) / (n / 4.0)) ** 2))
        return np.fft.ifft(np.fft.fft(x, axis=-1) * filt, axis=-1)
    if case["direction"] == "inverse":
        return np.fft.ifft(x, axis=-1) * case["n"]
    return np.fft.fft(x, axis=-1)


def _rank_main(rank: int, world: int, init_file: str, out: str) -> None:
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from rustfft_tpu_torch import FftDirection, FftPlanner
    from rustfft_tpu_torch.models.flagship import make_spectral_step
    from rustfft_tpu_torch.parallel import (make_batch_sharded_fft, make_distributed_fft,
                                            make_mesh)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        meshes = {}
        for case in make_cases(world):
            key = tuple(map(tuple, case["mesh"]))
            if key not in meshes:
                meshes[key] = make_mesh(key[0], key[1], device_type="cpu")
            mesh = meshes[key]
            direction = FftDirection(case["direction"])
            dtype = np.dtype(case["dtype"])
            if case["kind"] == "step":
                fn = make_spectral_step(mesh, case["n"], dtype)
            elif case["kind"] == "distributed":
                fn = make_distributed_fft(case["n"], direction, dtype, mesh,
                                          batch_axis=case["batch_axis"],
                                          split=None if case["split"] is None
                                          else tuple(case["split"]))
            else:
                plan = FftPlanner(dtype, device="cpu").plan_fft(case["n"], direction)
                fn = make_batch_sharded_fft(plan, mesh)
            x = case_input(case)
            coord = mesh.get_coordinate()
            rows, cols = _slices(case, coord)
            shard = torch.from_numpy(np.ascontiguousarray(x[rows, cols]))
            y = fn(shard)
            if case["kind"] == "batch" and not torch.equal(y, plan.process(shard)):
                raise AssertionError(f"{case['name']}: differs from plan.process")
            if rank == 0:
                np.save(os.path.join(out, f"{case['name']}.input.npy"), x)
            np.save(shard_path(out, case, coord), y.numpy())
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run(ranks: int, out: str, timeout: float) -> None:
    """Spawn the ranks and wait for them; raise when one fails or the time
    runs out (every rank still alive is then terminated)."""
    ctx = multiprocessing.get_context("spawn")
    rendezvous = tempfile.mkdtemp(prefix="torch_dryrun_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, ranks, os.path.join(rendezvous, "init"), out))
             for r in range(ranks)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"a rank exited with code {failed[0]}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks did not finish within {timeout} s")
            time.sleep(0.05)
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(rendezvous, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--out", default=None, help="directory for the .npy shards")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    out = args.out or tempfile.mkdtemp(prefix="torch_dryrun_out_")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    try:
        run(args.ranks, out, args.timeout)
        cases = make_cases(args.ranks)
        with open(os.path.join(out, "cases.json"), "w") as f:
            json.dump({"ranks": args.ranks, "cases": cases}, f, indent=1)
        for case in cases:
            x = np.load(os.path.join(out, f"{case['name']}.input.npy"))
            got = assemble(out, case)
            want = oracle(case, x)
            err = float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))
            if not (np.all(np.isfinite(got)) and err <= TOLERANCE[case["dtype"]]):
                raise AssertionError(f"{case['name']}: relative mean error {err:.3e} "
                                     f"> {TOLERANCE[case['dtype']]:.0e}")
            sizes, names = case["mesh"]
            print(f"torch_dryrun OK: {case['name']} mesh={dict(zip(names, sizes))} "
                  f"batch={case['batch']} n={case['n']} {case['dtype']}: rel err vs "
                  f"numpy {err:.2e}", flush=True)
    finally:
        if args.out is None:
            shutil.rmtree(out, ignore_errors=True)
    print(f"torch_dryrun: {len(cases)} cases on {args.ranks} gloo ranks in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    try:
        main()
    except (AssertionError, RuntimeError, TimeoutError) as exc:
        print(f"torch_dryrun FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
