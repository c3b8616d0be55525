"""Multi-device FFTs over a torch.distributed DeviceMesh.

Port of rustfft_tpu/parallel.  The reference has no distributed layer at all
(SURVEY.md §2.5: no threads, no NCCL/MPI; parallelism is SIMD lanes plus
implicit batching, lib.rs:200-209), so this is the JAX package's design on
torch.distributed, one rank a device:

* batch sharding - the reference's implicit batching contract, scaled across
  ranks (embarrassingly parallel),
* distributed six-step - the MixedRadix six-step decomposition
  (mixed_radix.rs:128-158) is exactly the decomposition that distributes: its
  three transposes become `all_to_all_single` collectives over the mesh's fft
  axis (NCCL between cards, gloo between CPU processes).
"""
from .sharded import (  # noqa: F401
    make_batch_sharded_fft,
    make_distributed_fft,
    choose_split,
)
from .mesh import make_mesh  # noqa: F401
