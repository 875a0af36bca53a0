"""The port's launchers: ``scripts_torch/*.sh`` against the JAX package's
reference-compatible ``scripts/*.sh``, and the port's console scripts in
``pyproject.toml``.

The round-5 evidence queues (``scripts/r5_queue*.sh``, hard-wired to the
JAX package's ``runs_r5/``) have no counterpart: the on-card tests
(``tests/test_torch_cuda_*.py``) take their role.
"""

import importlib
import os
import subprocess
import tomllib
from pathlib import Path

import pytest

from physicsbasedfwi2_tpu_torch.engine.config import list_workloads

ROOT = Path(__file__).resolve().parents[1]
JAX_SCRIPTS = sorted(p.name for p in (ROOT / "scripts").glob("*.sh")
                     if not p.name.startswith("r5_queue"))


def _commands(path: Path) -> list[str]:
    return [line for line in path.read_text().splitlines()
            if line and not line.startswith("#")]


def test_every_reference_launcher_has_a_port_counterpart():
    assert len(JAX_SCRIPTS) == 20
    assert sorted(p.name for p in (ROOT / "scripts_torch").iterdir()) == \
        JAX_SCRIPTS


@pytest.mark.parametrize("name", JAX_SCRIPTS)
def test_port_launcher_matches_reference(name):
    port = ROOT / "scripts_torch" / name
    assert os.access(port, os.X_OK)
    assert port.read_text().startswith("#!/usr/bin/env bash\n")
    want = [line.replace("physicsbasedfwi2_tpu.engine",
                         "physicsbasedfwi2_tpu_torch.engine")
            for line in _commands(ROOT / "scripts" / name)]
    got = _commands(port)
    assert got == want
    run = got[-1].split()
    assert run[:3] in (["python", "-m", "physicsbasedfwi2_tpu_torch.engine."
                        + cli] for cli in ("train", "test"))
    assert run[-1] == '"$@"'
    assert run[run.index("--workload") + 1] in list_workloads()


def test_port_launcher_starts_the_port():
    proc = subprocess.run(
        ["bash", str(ROOT / "scripts_torch" / "trainVelAuto22ModelPhy.sh"),
         "--help"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    assert "FWI training (PyTorch port)" in proc.stdout


def test_console_scripts_name_the_port():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "project"]["scripts"]
    jax_clis = {k: v for k, v in scripts.items() if not k.endswith("-torch")}
    assert len(jax_clis) == 5
    for name, target in jax_clis.items():
        port = scripts[f"{name}-torch"]
        assert port == target.replace("physicsbasedfwi2_tpu.",
                                      "physicsbasedfwi2_tpu_torch.")
        module, func = port.split(":")
        assert callable(getattr(importlib.import_module(module), func))
