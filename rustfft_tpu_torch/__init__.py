"""rustfft_tpu_torch: the PyTorch and CUDA port of rustfft_tpu.

The public API mirrors the JAX package (and through it ejmahler/RustFFT):
planners with `plan_fft_forward/inverse(n)`, complex64 and complex128,
unnormalized ascending-frequency output, k*n batching, plan caching.  Recipes
lower to torch matmul stages; the sizes `executor.route` names run
hand-written CUDA kernels for Hopper on CUDA tensors (their plain torch
versions on CPU tensors).  The package imports torch and numpy, never jax.

Beside the planners: `algorithm` builds any decomposition by hand (pinned
plans that run their literal recipe), `utils.testing` is the conformance
harness, `parallel` shards batches and single transforms across
torch.distributed ranks on a DeviceMesh (one NCCL rank a card), and
`models.flagship.make_spectral_step` is the sharded spectral step.

Example::

    import numpy as np
    from rustfft_tpu_torch import FftPlanner

    planner = FftPlanner(np.complex64)  # on the card; device="cpu" for the CPU
    fft = planner.plan_fft_forward(4096)
    spectrum = fft.process(np.zeros((8, 4096), dtype=np.complex64))
"""

from .common import FftBufferError, FftDirection, Forward, Inverse  # noqa: F401
from .config import FftConfig, config  # noqa: F401
from .executor import route  # noqa: F401
from .plan import FftPlan  # noqa: F401
from .planner import FftCache, FftPlanner, FftPlannerGpu, FftPlannerScalar  # noqa: F401
from .recipes import from_reference_recipe  # noqa: F401
from . import algorithm, math_utils, recipes, twiddles  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "FftBufferError",
    "FftDirection",
    "Forward",
    "Inverse",
    "FftConfig",
    "config",
    "route",
    "FftPlan",
    "FftCache",
    "FftPlanner",
    "FftPlannerGpu",
    "FftPlannerScalar",
    "from_reference_recipe",
    "algorithm",
    "math_utils",
    "recipes",
    "twiddles",
    "__version__",
]
