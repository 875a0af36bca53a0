"""Wave-physics ops of the ported slices.

Kernel modules: :mod:`scalar2` (B1 forward, B4a/B4b and
``acoustic_pallas2``), :mod:`fwi_fused` (B2, fused loss+gradient),
:mod:`elastic_fused` (B3, fused elastic loss+gradient, and the ring
forward), :mod:`kernels` (B5, first-order forward) and :mod:`adjoint`
(B6 and ``acoustic_pallas``), :mod:`scalar2b` (B7a/B7b and
``acoustic_pallas2b``) and :mod:`elastic_fwd` (B8,
``elastic_forward_pallas``) and :mod:`kernel_breakdown` (B9,
``build_variant``: B2's forward sweep with its mechanisms switched on at
compile time); each holds its CUDA wrapper and plain version.  Plain PyTorch under autograd: :mod:`acoustic`, :mod:`elastic`
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
from physicsbasedfwi2_tpu_torch.ops.kernel_breakdown import (
    build_variant,
    build_variant_plain,
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


def kernel_wrappers() -> dict:
    """Every kernel wrapper with a launch counter (``launches``,
    ``resident_launches``, ``per_step_launches``), by kernel name."""
    from physicsbasedfwi2_tpu_torch.ops import (
        adjoint, elastic_fused, elastic_fwd, fwi_fused, kernel_breakdown,
        kernels, scalar2, scalar2b)
    return {"forward2": scalar2.forward2,
            "fwi_l1_loss_grad": fwi_fused.fwi_l1_loss_grad,
            "fused_elastic_loss_grad":
                elastic_fused.fused_elastic_loss_grad_meds,
            "simulate_elastic_ring": elastic_fused.simulate_elastic_ring,
            "forward2_ckpt": scalar2.forward2_ckpt,
            "backward2": scalar2.backward2,
            "acoustic_forward_pallas": kernels.acoustic_forward_pallas,
            "acoustic_pallas_backward": adjoint.acoustic_pallas_backward,
            "forward2b": scalar2b.forward2b,
            "backward2b": scalar2b.backward2b,
            "elastic_forward_pallas": elastic_fwd.elastic_forward_pallas,
            "build_variant": kernel_breakdown.build_variant}


__all__ = [
    "AcousticConfig",
    "simulate_acoustic",
    "acoustic_gradient",
    "acoustic_pallas",
    "select_acoustic",
    "kernel_wrappers",
    "build_variant",
    "build_variant_plain",
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
