"""The port's multi-device layer, held against the JAX package.

Mirrors tests/test_parallel.py.  The helpers (`split_devices_2d`,
`choose_split`) equal the JAX functions over a range of (n, d).  One run of
`tools/torch_dryrun.py --ranks 4` (four gloo processes on the CPU, a
`file://` rendezvous, about 10 s) drives the distributed FFT on the (2, 2)
and (1, 4) meshes in both directions and both dtypes, a replicated batch, an
explicit split, the batch-sharded FFT and the spectral step; the parent
assembles the shards and holds them against
`rustfft_tpu.parallel.make_distributed_fft`, `make_batch_sharded_fft` and
`rustfft_tpu.models.flagship.make_spectral_step` on meshes of the conftest's
virtual CPU devices, on the same inputs, and against the float64 oracle:
relative mean error <= 1e-5 for complex64, 1e-12 for complex128.  A
one-rank gloo group in this process checks the mesh's errors and the
world-size-1 case.  The shard-local twiddle table and the spectral filter
are held against numpy in float64.
"""
import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import rustfft_tpu
from rustfft_tpu.models import flagship as ref_flagship
from rustfft_tpu.parallel import (choose_split as ref_choose_split,
                                  make_batch_sharded_fft as ref_batch_sharded,
                                  make_distributed_fft as ref_distributed,
                                  make_mesh as ref_make_mesh)
from rustfft_tpu.parallel.mesh import split_devices_2d as ref_split_devices_2d
from rustfft_tpu_torch import FftDirection, FftPlanner
from rustfft_tpu_torch.models.flagship import make_spectral_step, spectral_filter
from rustfft_tpu_torch.parallel import (choose_split, make_batch_sharded_fft,
                                        make_distributed_fft, make_mesh)
from rustfft_tpu_torch.parallel.mesh import split_devices_2d
from rustfft_tpu_torch.parallel import sharded
from rustfft_tpu_torch.parallel.sharded import shard_twiddles
from rustfft_tpu_torch.utils.testing import random_signal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRYRUN = os.path.join(REPO, "tools", "torch_dryrun.py")
RANKS = 4
TOL = {"complex64": 1e-5, "complex128": 1e-12}


def _load_dryrun():
    spec = importlib.util.spec_from_file_location("torch_dryrun", DRYRUN)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


dryrun = _load_dryrun()
CASES = {case["name"]: case for case in dryrun.make_cases(RANKS)}


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    want = np.asarray(want, dtype=np.complex128)
    return float(np.mean(np.abs(got - want)) / np.mean(np.abs(want)))


def _join(pair):
    return np.asarray(pair[0]) + 1j * np.asarray(pair[1])


def _pair(x):
    return np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)


@pytest.mark.parametrize("n_devices", range(1, 17))
def test_split_devices_2d_matches_reference(n_devices):
    assert split_devices_2d(n_devices) == ref_split_devices_2d(n_devices)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_choose_split_matches_reference(d):
    for n in [1, 4, 16, 64, 256, 323, 2304, 4096, 12288, 65536, 1 << 20, 17 * 19 * 64]:
        try:
            want = ref_choose_split(n, d)
        except ValueError:
            with pytest.raises(ValueError):
                choose_split(n, d)
            continue
        assert choose_split(n, d) == want


@pytest.mark.parametrize("direction", [FftDirection.FORWARD, FftDirection.INVERSE])
@pytest.mark.parametrize("n,p,lo,hi", [(256, 16, 0, 8), (256, 16, 8, 16), (2304, 48, 36, 48),
                                       (12288, 48, 192, 256), (1 << 20, 1024, 768, 1024)])
def test_shard_twiddles_against_numpy(n, p, lo, hi, direction):
    got = shard_twiddles(n, p, lo, hi, direction)
    j2 = np.arange(lo, hi)[:, None].astype(np.float64)
    k1 = np.arange(p)[None, :].astype(np.float64)
    sign = -1.0 if direction is FftDirection.FORWARD else 1.0
    want = np.exp(sign * 2j * np.pi * j2 * k1 / n)
    assert got.dtype == np.complex128 and got.shape == (hi - lo, p)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("n", [256, 1 << 16, 1 << 20])
def test_spectral_filter_against_numpy(n):
    k = np.arange(n, dtype=np.float64)
    want = np.exp(-((np.minimum(k, n - k) / (n / 4.0)) ** 2))
    got = spectral_filter(n)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


# ---- one gloo rank in this process ----

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    path = tmp_path_factory.mktemp("rendezvous") / "init"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0, world_size=1)
    try:
        yield make_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_make_mesh_needs_a_process_group():
    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device_type="cpu")


def test_make_mesh_on_one_rank(one_rank):
    assert one_rank.mesh_dim_names == ("data", "fft")
    assert tuple(one_rank.shape) == (1, 1)
    with pytest.raises(ValueError, match="does not match"):
        make_mesh((2, 1), device_type="cpu")
    with pytest.raises(ValueError, match="no axis"):
        make_distributed_fft(64, FftDirection.FORWARD, np.complex64, one_rank, fft_axis="x")


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("direction", [FftDirection.FORWARD, FftDirection.INVERSE])
def test_distributed_on_one_rank_matches_reference(one_rank, direction, dtype):
    n = 2304
    x = random_signal(3 * n, dtype=dtype, seed=5).reshape(3, n)
    got = make_distributed_fft(n, direction, dtype, one_rank)(torch.from_numpy(x)).numpy()
    ref_mesh = ref_make_mesh((1, 1), ("data", "fft"), jax.devices()[:1])
    want = _join(ref_distributed(n, rustfft_tpu.FftDirection(direction.value), dtype,
                                 ref_mesh)(_pair(x)))
    tol = TOL[np.dtype(dtype).name]
    assert got.dtype == dtype
    assert _rel(got, want) <= tol
    oracle = np.fft.fft(x) if direction is FftDirection.FORWARD else np.fft.ifft(x) * n
    assert _rel(got, oracle) <= tol


def test_transpose_on_one_rank_is_local(monkeypatch):
    # an fft axis of one rank runs no all-to-all, and the transpose comes
    # back contiguous (a strided view would push its copy into the next FFT)
    def refuse(*args, **kwargs):
        raise AssertionError("all_to_all_single on an axis of one rank")

    monkeypatch.setattr(dist, "all_to_all_single", refuse)
    x = torch.from_numpy(random_signal(2 * 6 * 10, seed=8).reshape(2, 6, 10))
    got = sharded._a2a_transpose(x, 1, None)
    assert got.is_contiguous()
    assert torch.equal(got, x.transpose(1, 2))


def test_batch_sharded_on_one_rank_equals_plan(one_rank):
    plan = FftPlanner(np.complex64, device="cpu").plan_fft_forward(4096)
    x = torch.from_numpy(random_signal(4 * 4096, seed=6).reshape(4, 4096))
    fn = make_batch_sharded_fft(plan, one_rank)
    assert torch.equal(fn(x), plan.process(x))
    with pytest.raises(ValueError):
        fn(x.reshape(-1))


def test_spectral_step_on_one_rank(one_rank):
    n = 4096
    x = random_signal(2 * n, seed=7).reshape(2, n)
    got = make_spectral_step(one_rank, n, np.complex64)(torch.from_numpy(x)).numpy()
    want = np.fft.ifft(np.fft.fft(x.astype(np.complex128)) * spectral_filter(n))
    assert _rel(got, want) <= 1e-5


# ---- four gloo ranks: tools/torch_dryrun.py ----

@pytest.fixture(scope="module")
def dryrun_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_dryrun")
    proc = subprocess.run(
        [sys.executable, DRYRUN, "--ranks", str(RANKS), "--out", str(out), "--timeout", "150"],
        capture_output=True, text=True, timeout=200, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert proc.stdout.count("torch_dryrun OK") == len(CASES), proc.stdout
    return str(out)


def _reference(case, x):
    """The JAX package's function for the case on a mesh of virtual CPU
    devices, on the global input x."""
    sizes, names = case["mesh"]
    mesh = ref_make_mesh(tuple(sizes), tuple(names), jax.devices()[:int(np.prod(sizes))])
    dtype = np.dtype(case["dtype"])
    direction = rustfft_tpu.FftDirection(case["direction"])
    if case["kind"] == "step":
        fn = ref_flagship.make_spectral_step(mesh, case["n"], dtype)
    elif case["kind"] == "distributed":
        fn = ref_distributed(case["n"], direction, dtype, mesh, batch_axis=case["batch_axis"],
                             split=None if case["split"] is None else tuple(case["split"]))
    else:
        plan = rustfft_tpu.FftPlanner(dtype).plan_fft(case["n"], direction)
        fn = ref_batch_sharded(plan, mesh)
    return _join(fn(_pair(x)))


@pytest.mark.parametrize("name", list(CASES))
def test_dryrun_case_matches_reference(dryrun_out, name):
    case = CASES[name]
    x = np.load(os.path.join(dryrun_out, f"{name}.input.npy"))
    np.testing.assert_array_equal(x, dryrun.case_input(case))
    got = dryrun.assemble(dryrun_out, case)
    assert got.shape == (case["batch"], case["n"]) and got.dtype == np.dtype(case["dtype"])
    assert np.all(np.isfinite(got))
    tol = TOL[case["dtype"]]
    assert _rel(got, _reference(case, x)) <= tol
    assert _rel(got, dryrun.oracle(case, x)) <= tol


def test_dryrun_covers_the_meshes():
    """(2, 2) and (1, 4), both directions, both dtypes, and the other kinds."""
    fft_cases = {(tuple(c["mesh"][0]), c["dtype"], c["direction"])
                 for c in CASES.values() if c["kind"] == "distributed" and c["n"] == 2304}
    assert fft_cases == {(m, t, d) for m in ((2, 2), (1, 4))
                         for t in ("complex64", "complex128") for d in ("forward", "inverse")}
    assert {c["kind"] for c in CASES.values()} == {"step", "distributed", "batch"}
    assert any(c["batch_axis"] is None for c in CASES.values())
    assert any(c["split"] is not None for c in CASES.values())
    assert {tuple(c["mesh"][0]) for c in CASES.values() if c["kind"] == "step"} == \
        {(2, 2), (1, 4)}
