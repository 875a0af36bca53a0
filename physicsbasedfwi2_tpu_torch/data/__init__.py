"""Data layer (port of ``physicsbasedfwi2_tpu/data``): .npy dataset
loaders with the reference's on-disk contracts, synthetic and from-disk
workloads, and (in submodules) dataset preparation (``prep``), the
canonical grids (``marmousi``) and the native host loaders."""

from physicsbasedfwi2_tpu_torch.data.npy_datasets import (
    NpyDictDataset, create_dataset, register_dataset,
)
from physicsbasedfwi2_tpu_torch.data.synthetic import (
    SyntheticAcousticWorkload,
    SyntheticElasticWorkload,
    acoustic_workload_from_disk,
    elastic_workload_from_disk,
    make_elastic_model,
    make_layered_model,
    make_marmousi_like,
    smooth_model,
)

__all__ = [
    "NpyDictDataset",
    "create_dataset",
    "register_dataset",
    "SyntheticAcousticWorkload",
    "SyntheticElasticWorkload",
    "acoustic_workload_from_disk",
    "elastic_workload_from_disk",
    "make_elastic_model",
    "make_layered_model",
    "make_marmousi_like",
    "smooth_model",
]
