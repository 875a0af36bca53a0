"""Engine, config registry, training loop, seed race and evaluation."""

from physicsbasedfwi2_tpu_torch.engine.config import (
    ExperimentConfig, get_workload, list_workloads, register_workload,
)
from physicsbasedfwi2_tpu_torch.engine.engines import (
    AcousticDIPEngine, ClassicFWIEngine, ElasticDIPEngine,
    ImpedanceDIPEngine, LatentInversionEngine, MultiSampleAcousticDIPEngine,
    SupervisedEngine, create_engine, default_device,
)

__all__ = [
    "ExperimentConfig",
    "get_workload",
    "list_workloads",
    "register_workload",
    "AcousticDIPEngine",
    "ElasticDIPEngine",
    "LatentInversionEngine",
    "ClassicFWIEngine",
    "MultiSampleAcousticDIPEngine",
    "ImpedanceDIPEngine",
    "SupervisedEngine",
    "create_engine",
    "default_device",
    "race",
    "evaluate",
]


def __getattr__(name):
    # race and evaluate load on first use, so that ``python -m`` of their
    # own modules does not find them imported already; the function then
    # takes the place of the submodule ``race`` as this package's name
    if name in ("race", "evaluate"):
        import importlib
        module = importlib.import_module(
            f"{__name__}.{'race' if name == 'race' else 'test'}")
        globals()[name] = getattr(module, name)
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
