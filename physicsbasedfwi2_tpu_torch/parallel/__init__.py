"""Rank-mesh parallelism on ``torch.distributed`` (port of
``physicsbasedfwi2_tpu/parallel``): the replacement for the reference's
Ray per-shot GPU fan-out (Auto_model.py:69-199), DENISE's MPI domain
decomposition (networks.py:7709-7710) and the loss-landscape mpi4py grid
sweep.  One process per rank, the weights replicated; the caller makes
the process group (``torchrun``, :func:`dryrun.spawn`)."""

from physicsbasedfwi2_tpu_torch.parallel.mesh import (
    Mesh, all_gather, all_reduce, broadcast_module, make_mesh, make_mesh2d,
    shot_axis_size,
)
from physicsbasedfwi2_tpu_torch.parallel.shard import (
    pad_shots_for_fused,
    pad_shots_to_multiple,
    sample_shot_sharded_acoustic_gradient,
    shot_sharded_acoustic_gradient,
    shot_sharded_elastic_gradient,
    shot_sharded_fused_acoustic_gradient,
)
from physicsbasedfwi2_tpu_torch.parallel.halo import simulate_acoustic_dd

__all__ = [
    "make_mesh",
    "make_mesh2d",
    "shot_axis_size",
    "shot_sharded_acoustic_gradient",
    "shot_sharded_elastic_gradient",
    "sample_shot_sharded_acoustic_gradient",
    "pad_shots_to_multiple",
    "pad_shots_for_fused",
    "shot_sharded_fused_acoustic_gradient",
    "simulate_acoustic_dd",
    "Mesh",
    "all_gather",
    "all_reduce",
    "broadcast_module",
]
