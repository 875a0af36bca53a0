"""Wave-physics ops of the acoustic and elastic slices.

Kernel modules: :mod:`scalar2` (B1, forward), :mod:`fwi_fused` (B2,
fused loss+gradient) and :mod:`elastic_fused` (B3, fused elastic
loss+gradient, and the ring forward); each holds its CUDA wrapper and
plain version.
"""

from physicsbasedfwi2_tpu_torch.ops.acoustic import (
    AcousticConfig,
    simulate_acoustic,
)
from physicsbasedfwi2_tpu_torch.ops.gradproc import depth_weighting, water_mask
from physicsbasedfwi2_tpu_torch.ops.misfit import l1_misfit, trace_normalize

__all__ = [
    "AcousticConfig",
    "simulate_acoustic",
    "depth_weighting",
    "water_mask",
    "l1_misfit",
    "trace_normalize",
]
