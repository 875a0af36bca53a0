"""The device the entry points run on when the caller names none."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The current CUDA card: ``cuda:0`` in a single process, the rank's
    card once ``parallel.make_mesh`` (or the caller) has made it current
    with ``torch.cuda.set_device``.  Raises when no card is visible: the
    entry points run on the card unless the caller asks for the CPU
    (``device="cpu"``, ``--device cpu``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is visible (torch.cuda.is_available() is "
            "False); pass device=\"cpu\" (--device cpu) to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
