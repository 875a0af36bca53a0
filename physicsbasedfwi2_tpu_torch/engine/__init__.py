"""Engine, config registry and training loop."""

from physicsbasedfwi2_tpu_torch.engine.config import (
    ExperimentConfig, get_workload, list_workloads, register_workload,
)
from physicsbasedfwi2_tpu_torch.engine.engines import (
    AcousticDIPEngine, ElasticDIPEngine, create_engine, default_device,
)

__all__ = [
    "ExperimentConfig",
    "get_workload",
    "list_workloads",
    "register_workload",
    "AcousticDIPEngine",
    "ElasticDIPEngine",
    "create_engine",
    "default_device",
]
