"""Multi-device FFTs with the PyTorch/CUDA port: batch sharding and the
distributed six-step, the counterpart of examples/distributed.py.

    python3 examples/torch_distributed.py [--device cuda] [--ranks R]

One process a rank, spawned here, joined through a `file://` rendezvous in a
temporary directory (no ports, no network): on the CPU `--ranks` gloo ranks
(default 4), on the card one NCCL rank a card (every card there is).  The
ranks form a (data, fft) DeviceMesh (`parallel.make_mesh`,
`split_devices_2d`: 2 x 2 on four ranks, 1 x 1 on one card) and run

1. `make_batch_sharded_fft`: 16 transforms of 1024, the rows split over
   'data';
2. `make_distributed_fft`: 2 transforms of 256 * 256, each sharded over
   'fft' (its three transposes are all-to-alls across the fft axis, local
   on an axis of one rank), the rows split over 'data'.

Rank 0 gathers the output shards and prints each result's relative mean
error against the numpy float64 FFT.  The script exits non-zero when a rank
fails or the ranks do not finish within --timeout seconds.
"""
import argparse
import multiprocessing
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def global_input(batch: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(
        np.complex64)


def rank_main(rank: int, world: int, device_type: str, init_file: str) -> None:
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from rustfft_tpu_torch import FftDirection, FftPlanner
    from rustfft_tpu_torch.parallel import make_batch_sharded_fft, make_distributed_fft, make_mesh
    from rustfft_tpu_torch.parallel.mesh import split_devices_2d

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"file://{init_file}", rank=rank, world_size=world)
    try:
        data, fft = split_devices_2d(world)
        mesh = make_mesh((data, fft), ("data", "fft"), device_type=device_type)
        at = dict(zip(("data", "fft"), mesh.get_coordinate()))

        # 1. batch sharding: independent FFTs data-parallel over 'data'
        x = global_input(16, 1024, seed=0)
        rows = slice(at["data"] * 16 // data, (at["data"] + 1) * 16 // data)
        plan = FftPlanner(np.complex64, device=device).plan_fft_forward(1024)
        out = make_batch_sharded_fft(plan, mesh)(torch.from_numpy(x[rows]).to(device))
        shards = [None] * world
        dist.all_gather_object(shards, (rows, slice(None), out.cpu().numpy()))
        report("batch-sharded 16 x 1024", x, shards, mesh, rank)

        # 2. one transform sharded over 'fft': the six-step's transposes as
        #    all-to-alls across the fft axis
        n = 256 * 256
        x = global_input(2, n, seed=1)
        rows = slice(at["data"] * 2 // data, (at["data"] + 1) * 2 // data)
        cols = slice(at["fft"] * n // fft, (at["fft"] + 1) * n // fft)
        dist_fft = make_distributed_fft(n, FftDirection.FORWARD, np.complex64, mesh)
        out = dist_fft(torch.from_numpy(np.ascontiguousarray(x[rows, cols])).to(device))
        dist.all_gather_object(shards, (rows, cols, out.cpu().numpy()))
        report(f"distributed 2 x {n}", x, shards, mesh, rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def report(what, x, shards, mesh, rank) -> None:
    """On rank 0: the shards put together, and their error against numpy."""
    if rank != 0:
        return
    got = np.full(x.shape, np.nan + 0j, dtype=np.complex64)
    for rows, cols, part in shards:
        got[rows, cols] = part
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    err = np.abs(got - want).mean() / np.abs(want).mean()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    print(f"{what} on mesh {sizes} ({mesh.device_type}): rel err = {err:.2e}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=4, help="gloo ranks on the cpu")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()

    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch_distributed: no CUDA GPU; pass --device cpu")
        world = torch.cuda.device_count()
    else:
        world = args.ranks
    ctx = multiprocessing.get_context("spawn")
    rendezvous = tempfile.mkdtemp(prefix="torch_distributed_")
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, args.device, os.path.join(rendezvous, "init")))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + args.timeout
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise SystemExit(f"torch_distributed: the ranks did not finish within "
                                 f"{args.timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(rendezvous, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise SystemExit(f"torch_distributed: rank exit codes {codes}")


if __name__ == "__main__":
    main()
