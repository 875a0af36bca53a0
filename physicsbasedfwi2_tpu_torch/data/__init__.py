"""Synthetic workloads."""

from physicsbasedfwi2_tpu_torch.data.synthetic import (
    SyntheticAcousticWorkload,
    SyntheticElasticWorkload,
    make_elastic_model,
    make_layered_model,
    make_marmousi_like,
    smooth_model,
)

__all__ = [
    "SyntheticAcousticWorkload",
    "SyntheticElasticWorkload",
    "make_elastic_model",
    "make_layered_model",
    "make_marmousi_like",
    "smooth_model",
]
