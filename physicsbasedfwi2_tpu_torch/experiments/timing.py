"""What the timing harnesses share: the device a line names, the host's
wait for the card, and the kernels' launch counts over a run.

A CUDA launch returns before the card has done the work, so every clock
around work on a card starts and is read after :func:`wait`.  Each
harness line names its device (:func:`card`) and the route its kernels
took (:func:`route`, from the wrappers' counters), so that a number
taken on the CPU or on a kernel's per-step route cannot pass for one on
the card's resident route.
"""

from __future__ import annotations

import subprocess

import torch

from physicsbasedfwi2_tpu_torch.device import default_device
from physicsbasedfwi2_tpu_torch.ops import kernel_wrappers


def resolve_device(name: str | None) -> torch.device:
    """``--device``'s device; without one the card (raises when none is
    visible)."""
    return torch.device(name) if name else default_device()


def card(device: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them;
    ``"cpu"`` on the CPU."""
    if device.type != "cuda":
        return "cpu"
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)], capture_output=True,
        text=True, check=True, timeout=60).stdout.strip()


def wait(device: torch.device) -> None:
    """Wait on the host until the card has run everything queued on it
    (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts() -> dict[str, tuple[int, int, int]]:
    """Every kernel's counts now: (launches, resident, per-step)."""
    return {k: (f.launches, f.resident_launches, f.per_step_launches)
            for k, f in kernel_wrappers().items()}


def launches_since(before: dict) -> dict[str, list[int]]:
    """The launches since ``before`` (:func:`launch_counts`), by kernel,
    as [launches, resident, per-step], of the kernels that launched."""
    out = {}
    for k, now in launch_counts().items():
        diff = [a - b for a, b in zip(now, before[k])]
        if diff[0]:
            out[k] = diff
    return out


def route(launches: dict) -> str:
    """The route of every launch in ``launches`` (:func:`launches_since`):
    ``"resident"`` or ``"per-step"`` where all took it, ``"mixed"``
    where both ran, ``"plain"`` where none launched (the plain versions
    on the CPU)."""
    resident = sum(c[1] for c in launches.values())
    per_step = sum(c[2] for c in launches.values())
    if not resident and not per_step:
        return "plain"
    if not per_step:
        return "resident"
    return "per-step" if not resident else "mixed"
