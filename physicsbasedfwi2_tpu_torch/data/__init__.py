"""Synthetic workloads."""

from physicsbasedfwi2_tpu_torch.data.synthetic import (
    SyntheticAcousticWorkload,
    make_layered_model,
    make_marmousi_like,
    smooth_model,
)

__all__ = [
    "SyntheticAcousticWorkload",
    "make_layered_model",
    "make_marmousi_like",
    "smooth_model",
]
