"""Wave-physics ops of the ported slices.

Kernel modules: :mod:`scalar2` (B1 forward, B4a/B4b and
``acoustic_pallas2``), :mod:`fwi_fused` (B2, fused loss+gradient),
:mod:`elastic_fused` (B3, fused elastic loss+gradient, and the ring
forward), :mod:`kernels` (B5, first-order forward) and :mod:`adjoint`
(B6 and ``acoustic_pallas``), :mod:`scalar2b` (B7a/B7b and
``acoustic_pallas2b``) and :mod:`elastic_fwd` (B8,
``elastic_forward_pallas``); each holds its CUDA wrapper and plain
version.  Plain PyTorch under autograd: :mod:`acoustic`, :mod:`elastic`
(split PML) and :mod:`elastic_fast` (5 fields, sponge); :mod:`born`
(linearized modeling, forward-mode AD through those propagators) and
:mod:`ssim`.
"""

import torch

from physicsbasedfwi2_tpu_torch.ops.acoustic import (
    AcousticConfig,
    acoustic_gradient,
    simulate_acoustic,
)
from physicsbasedfwi2_tpu_torch.ops.adjoint import acoustic_pallas
from physicsbasedfwi2_tpu_torch.ops.elastic import (
    ElasticConfig,
    elastic_gradient,
    simulate_elastic,
)
from physicsbasedfwi2_tpu_torch.ops.gradproc import (
    depth_weighting,
    rescale_to_model,
    taper_top,
    water_mask,
)
from physicsbasedfwi2_tpu_torch.ops.misfit import (
    huber_misfit,
    l1_misfit,
    l2_misfit,
    normalized_trace_misfit,
    trace_normalize,
)
from physicsbasedfwi2_tpu_torch.ops.ssim import ssim


def select_acoustic(backend: str = "auto"):
    """Pick the propagator: ``"xla"`` -> :func:`simulate_acoustic`
    (plain PyTorch autograd), ``"pallas"`` -> :func:`acoustic_pallas`
    (on this package the CUDA kernels B5/B6), ``"auto"`` -> the kernels
    when a CUDA card is visible, else :func:`simulate_acoustic`."""
    if backend == "xla":
        return simulate_acoustic
    if backend == "pallas":
        return acoustic_pallas
    return acoustic_pallas if torch.cuda.is_available() else simulate_acoustic


__all__ = [
    "AcousticConfig",
    "simulate_acoustic",
    "acoustic_gradient",
    "acoustic_pallas",
    "select_acoustic",
    "simulate_elastic",
    "elastic_gradient",
    "ElasticConfig",
    "depth_weighting",
    "water_mask",
    "taper_top",
    "rescale_to_model",
    "trace_normalize",
    "l1_misfit",
    "l2_misfit",
    "huber_misfit",
    "normalized_trace_misfit",
    "ssim",
]
